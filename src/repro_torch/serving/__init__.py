"""Serving (port of ``repro.serving``): the continuous-batching engine
(``scheduler``) and the decode step it replays (``decode``)."""
from repro_torch.serving.decode import (  # noqa: F401
    DecodeStep,
    gumbel_noise,
    sample,
)
from repro_torch.serving.scheduler import (  # noqa: F401
    Request,
    ServingEngine,
)
