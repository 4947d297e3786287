"""The language-model stack of the port (``repro.models``'s counterpart):
the serving path — batched prefill through the flash-attention, RG-LRU and
SSD scan kernels, then decode over the caches — and the per-group loss that
evaluation reads, through the SSD scan and fused cross-entropy kernels."""
from repro_torch.models.model import (  # noqa: F401
    Model,
    backbone,
    chunked_nll,
    decode_step,
    forward,
    init_cache,
    init_params,
    param_count,
    per_group_loss,
)
