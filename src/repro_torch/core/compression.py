"""Error-feedback gossip compression over packed ``(n, D)`` buffers (port of
``repro.core.compression``).

The compressed round replaces the *transmitted* Δ of each variable with its
deterministic quantize-dequantize image and carries the quantization error
as per-client error-feedback state:

    v   = Δ + e                      (delta plus carried residual)
    q   = Q(v)                       (what goes on the wire: bf16 or int8)
    e'  = v − q                      (next round's residual, exact in f32;
                                      see repro_torch.kernels.quantize)

Every downstream use of Δ (the correction update and the parameter mixing)
consumes the same q, so for any doubly stochastic W Σᵢ(q − Wq)ᵢ = 0 and
the Σᵢcᵢ = 0 invariant survives compression.

An inactive client puts nothing on the wire: its transmit value is masked
to zero and its residual kept, and ``kgt_minimax._freeze_inactive`` pins
the EF leaf bit for bit with the rest of its state.  The residuals are
``KGTState.ef_x`` / ``ef_y``, packed (n, D) f32 in ``core.packing``'s
layout, so the engine's chunks, checkpoints and sweep trajectories carry
them like (θ, c).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.quantize import QUANT_METHODS, quantize_dequant

# values of AlgorithmConfig.gossip_compress (None = exact gossip)
COMPRESS_METHODS = QUANT_METHODS


def validate_method(method: Optional[str]) -> Optional[str]:
    """None / "none" / "" -> None; otherwise a known quantizer name."""
    if method in (None, "none", ""):
        return None
    if method not in COMPRESS_METHODS:
        raise ValueError(
            f"unknown gossip_compress {method!r}: {COMPRESS_METHODS}")
    return method


def ef_transmit(delta_buf: torch.Tensor, ef_buf: torch.Tensor, method: str,
                mask: Optional[torch.Tensor] = None, row_max=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Δ, e) -> (q, e') per the protocol above.  All ``(n, D)`` f32.

    ``mask`` (optional ``(n,)``): inactive rows transmit exact zeros and
    keep their residual unchanged (their Δ is already zero; without the
    mask their residual would leak onto the wire).  ``row_max``: the max
    over the ranks that share each row (``quantize_dequant``).
    """
    v = delta_buf.to(torch.float32) + ef_buf.to(torch.float32)
    if mask is not None:
        v = v * mask.to(torch.float32)[:, None]
    q = quantize_dequant(v, method, row_max)
    e_new = v - q
    if mask is not None:
        e_new = torch.where(mask.to(torch.bool)[:, None], e_new, ef_buf)
    return q, e_new


def init_ef(n: int, dim: int, device="cuda") -> torch.Tensor:
    """Zero residual: round 0 transmits Q(Δ) with nothing carried."""
    return torch.zeros((n, dim), dtype=torch.float32, device=device)
