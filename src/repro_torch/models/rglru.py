"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427), port
of ``repro.models.rglru``.

    r_t = sigmoid(W_a x_t)          (recurrence gate)
    i_t = sigmoid(W_x x_t)          (input gate)
    log a_t = -c * softplus(Lambda) * r_t          (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The gate products with ``wa``/``wx`` run in f32, as in the reference.  The
recurrence over a sequence is ``repro_torch.kernels.ops.rglru_scan`` (the
hand-written CUDA scan on the card); a carried state h0 is folded into the
first step, u_0 ← u_0 + a_0·h0, as the Pallas kernel folds its carry.

On the serving mesh's model axis (``dist.tensor_parallel``) a rank holds
W/M of the LRU channels: its columns of ``in_x``, ``in_gate``, ``wa`` and
``wx``, its channels of the conv, ``ba``, ``bx`` and ``lam``, its rows of
``out``.  The gates ``r`` and ``i`` of its channels read every channel of
the conv output, so each rank's conv output (B, S, W/M) is gathered in the
compute dtype at the ``lru_gate_in`` point of ``dist.context``; its f32
cast is the reference's ``xf`` exactly, and the products with the rank's
columns of ``wa`` and ``wx`` stay in full f32.  Gathering the input moves
(M − 1)/M·B·S·W compute-dtype values a rank; the other layout, the rows of
``wa`` and ``wx`` on each rank and the two pre-sigmoid (B, S, W) f32 partial
products all-reduced, would move 2·B·S·W f32 values: 4× the bytes in bf16.
The recurrence (B8) then runs on the rank's (B, S, W/M) ``a`` and ``u``,
and ``out``'s partial sums cross at ``mixer_out``
(``models.transformer.block_forward``).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist import context as dist_ctx
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import dense_init, param

RGLRU_C = 8.0


def init_rglru(gen, cfg, d_model: int, *, device, dtype) -> nn.ParameterDict:
    """The reference's parameters over W channels; a rank's shard config
    (``configs.base.RGLRUShard``) gives its channels c, and ``wa`` /
    ``wx`` keep their W rows: (W, c)."""
    r = cfg.rglru
    w, c = r.lru_width or d_model, r.channels(d_model)
    kw = dict(device=device, dtype=dtype)
    p = {
        "in_x": dense_init(gen, (d_model, c), in_axis=0, **kw),
        "in_gate": dense_init(gen, (d_model, c), in_axis=0, **kw),
        "conv_w": dense_init(gen, (r.conv_width, c), in_axis=0, **kw) * 0.1,
        "conv_b": torch.zeros((c,), **kw),
        "wa": dense_init(gen, (w, c), in_axis=0, **kw),
        "ba": torch.zeros((c,), **kw),
        "wx": dense_init(gen, (w, c), in_axis=0, **kw),
        "bx": torch.zeros((c,), **kw),
        # softplus(lambda) ~ 0.2..0.99 decay range init
        "lam": torch.linspace(0.5, 4.0, c, device=device).to(dtype),
        "out": dense_init(gen, (c, d_model), in_axis=0, **kw),
    }
    return nn.ParameterDict({k: param(v) for k, v in p.items()})


def _conv1d(x, w, b, state=None):
    """Causal depthwise conv over S.  x: (B,S,W); w: (k,W); state: the last
    k−1 inputs of the previous call (zeros when None).  Returns
    (y, new_state)."""
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k)) + b
    # a copy, so the state does not hold the whole padded input alive
    return y, (xp[:, -(k - 1):, :].clone() if k > 1 else None)


class GeluTanh(torch.autograd.Function):
    """``jax.nn.gelu`` (its default tanh form) as the reference computes
    it, forward and gradient: x·v, v = 0.5·(1 + tanh(√(2/π)·(x +
    0.044715·x³))), every op in ``x``'s dtype and its constants rounded
    to it; the gradient is JAX's transpose of that chain's JVP, op for op
    in the same dtype (the tanh's (g + g·t)·(1 − t), x³'s g·(3·x²), the
    three terms of x's gradient added in JAX's order).  ``F.gelu
    (approximate="tanh")`` and autograd through the chain round otherwise:
    in bf16 an ulp apart in ~40 % of the values (ROADMAP §C, C1)."""
    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        c, k = _gelu_consts(x.dtype)
        t = torch.tanh(c * (x + k * (x * x * x)))
        return x * (0.5 * (1.0 + t)), t

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output[1])
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, g, _):
        x, t = ctx.saved_tensors
        c, k = _gelu_consts(x.dtype)
        v = 0.5 * (1.0 + t)
        a = (0.5 * (x * g)) * (1.0 - t)
        gs = c * (a + a * t)
        return (g * v + gs) + (k * gs) * (3.0 * (x * x))


@functools.lru_cache(maxsize=None)
def _gelu_consts(dtype):
    """√(2/π) and 0.044715 rounded to ``dtype``, as JAX rounds them."""
    return (torch.tensor(math.sqrt(2.0 / math.pi), dtype=dtype).item(),
            torch.tensor(0.044715, dtype=dtype).item())


def gelu_tanh(x):
    """:class:`GeluTanh`'s value."""
    return GeluTanh.apply(x)[0]


def rglru_forward(params, x, cfg, compute_dtype=torch.bfloat16,
                  conv_state=None, h_state=None, decode: bool = False,
                  kernels: bool = True):
    """RG-LRU block.  x: (B,S,d).  Returns (out, cache).  ``kernels=False``
    runs the scan's plain version (``ref.rglru_ref``) where the kernel
    would run."""
    def w(name):
        return params[name].to(compute_dtype)

    xb = x @ w("in_x")
    gate = gelu_tanh(x @ w("in_gate"))
    # the conv's input over the whole sequence where each rank projected
    # its piece of it
    xb, = dist_ctx.apply("seq_in", (xb,))
    xb, new_conv = _conv1d(xb, w("conv_w"), w("conv_b"), conv_state)

    xf = xb.to(torch.float32)
    # every rank's channels on a shard (the identity in one process)
    xg = dist_ctx.apply("lru_gate_in", xb)
    xa = xf if xg is xb else xg.to(torch.float32)
    r = torch.sigmoid(xa @ params["wa"].to(torch.float32) + params["ba"])
    i = torch.sigmoid(xa @ params["wx"].to(torch.float32) + params["bx"])
    log_a = -RGLRU_C * F.softplus(params["lam"]) * r
    a = torch.exp(log_a)
    u = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) * (
        i * xf)

    if decode:
        h0 = h_state if h_state is not None else torch.zeros(
            (x.shape[0], xb.shape[-1]), dtype=torch.float32, device=x.device)
        h_fin = a[:, 0] * h0 + u[:, 0]
        h = h_fin[:, None]
    else:
        if h_state is not None:
            # out of place, so autograd and vmap see a fresh u
            u = torch.cat([u[:, :1] + a[:, :1] * h_state[:, None], u[:, 1:]],
                          dim=1)
        h = ops.rglru_scan(a, u) if kernels else ref.rglru_ref(a, u)
        h_fin = h[:, -1].clone()

    y = dist_ctx.apply("seq_out", h).to(compute_dtype) * gate
    out = y @ w("out")
    return out.to(x.dtype), {"conv": new_conv, "h": h_fin}
