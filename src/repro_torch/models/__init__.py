"""The language-model stack of the port (``repro.models``'s counterpart):
the serving path — batched prefill through the flash-attention and RG-LRU
scan kernels, then decode over the caches."""
from repro_torch.models.model import (  # noqa: F401
    Model,
    backbone,
    decode_step,
    forward,
    init_cache,
    init_params,
    param_count,
)
