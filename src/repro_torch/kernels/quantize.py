"""Deterministic gossip quantizers (port of ``repro.kernels.quantize``).

The plain PyTorch twin of the quantizer that the whole-round CUDA kernel
(``csrc/fused_round.cu``) applies in its compress branch.  Both keep the
reference's rounding and op order, which is what makes the error-feedback
residual exact in f32:

    fl(v − Q(v)) == v − Q(v)   and   fl(Q(v) + (v − Q(v))) == v

* ``"bf16"`` — round-trip through bfloat16 (round to nearest even).
* ``"int8"`` — per-row scale ``s = max|v| · f32(1/127)``, ``q = round(v /
  safe)`` with round-half-to-even (``torch.round``; ``rintf`` in CUDA),
  clipped to ±127, dequant ``q · safe``; an all-zero row maps to zeros.
"""
from __future__ import annotations

import torch

QUANT_METHODS = ("bf16", "int8")
# the f32 constant 1/127 (0x1.020408p-7), as the reference multiplies by it
INV_127 = 1.0 / 127.0


def quantize_dequant(v: torch.Tensor, method: str,
                     row_max=None) -> torch.Tensor:
    """f32 tensor -> its deterministic quantize-dequantize image (f32).
    ``row_max``: where a row is split over ranks (a client's (fsdp, model)
    block), the max of each rank's max|v| over them, so the scale is the
    whole row's (a max is exact: each piece's q is the whole row's)."""
    if method == "bf16":
        return v.to(torch.bfloat16).to(torch.float32)
    if method == "int8":
        # the f32 constant, filled on the device (no host copy, so the
        # quantizer runs inside a captured CUDA graph)
        inv = v.new_full((), INV_127, dtype=torch.float32)
        big = torch.amax(torch.abs(v), dim=-1, keepdim=True)
        if row_max is not None:
            big = row_max(big)
        s = big * inv
        safe = torch.where(s > 0, s, torch.ones_like(s))
        q = torch.clamp(torch.round(v / safe), -127.0, 127.0)
        return torch.where(s > 0, q * safe, torch.zeros_like(v))
    raise ValueError(f"unknown quantize method {method!r}: {QUANT_METHODS}")


def wire_bits(method: str) -> int:
    """Payload bits per element on the wire: bf16 = 16, int8 = 8 (+ one f32
    scale per row)."""
    if method == "bf16":
        return 16
    if method == "int8":
        return 8
    raise ValueError(f"unknown quantize method {method!r}: {QUANT_METHODS}")
