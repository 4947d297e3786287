"""Core layers: initializers, RMSNorm, RoPE, SwiGLU MLP (port of
``repro.models.layers``).

Initializers draw from an explicit ``torch.Generator`` with the reference's
distributions (``dense_init`` normal·fan_in^−½ along ``in_axis``,
``embed_init`` normal·0.02); the draws themselves differ from JAX's, so
parity runs carry the reference's arrays across (``models.interop``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def param(t: torch.Tensor) -> nn.Parameter:
    """A parameter of the serving slice: no gradient is taken yet."""
    return nn.Parameter(t, requires_grad=False)


def dense_init(gen, shape, in_axis: int = -2, *, device, dtype):
    fan_in = shape[in_axis]
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * (1.0 / math.sqrt(fan_in))).to(dtype)


def embed_init(gen, shape, *, device, dtype):
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * 0.02).to(dtype)


def rms_norm(x, scale, eps: float = 1e-6):
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.to(torch.float32))).to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, D); positions: broadcastable to (..., S).  The
    split-halves form: (x1, x2) → (x1·cos − x2·sin, x2·cos + x1·sin)."""
    d = x.shape[-1]
    inv = rope_frequencies(d, theta, x.device)
    ang = positions[..., None].to(torch.float32) * inv      # (..., S, D/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(gen, d_model: int, d_ff: int, *, device, dtype) -> nn.ParameterDict:
    kw = dict(device=device, dtype=dtype)
    return nn.ParameterDict({
        "gate": param(dense_init(gen, (d_model, d_ff), **kw)),
        "up": param(dense_init(gen, (d_model, d_ff), **kw)),
        "down": param(dense_init(gen, (d_ff, d_model), **kw)),
    })


def mlp(params, x, compute_dtype=torch.bfloat16):
    def w(name):
        return params[name].to(compute_dtype)

    h = F.silu(x @ w("gate")) * (x @ w("up"))
    return h @ w("down")
