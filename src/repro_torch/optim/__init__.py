"""Learning-rate schedules and tree optimizers (``repro.optim``'s
counterpart)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    OPTIMIZERS,
    Optimizer,
    adam,
    get_optimizer,
    momentum,
    sgd,
)
from repro_torch.optim.schedules import (  # noqa: F401
    SCHEDULES,
    constant,
    cosine,
    get_schedule,
    wsd,
)
