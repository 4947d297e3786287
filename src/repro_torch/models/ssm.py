"""Mamba2 (SSD — state-space duality) block, port of ``repro.models.ssm``.

The recurrence per head h with state S ∈ R^{P×N}:

    S_t = a_t·S_{t−1} + (dt_t·x_t) ⊗ B_t          a_t = exp(A_h·dt_t)
    y_t = C_t · S_t + D_h·x_t

evaluated chunk-parallel (the SSD algorithm of arXiv:2405.21060).  Over a
sequence the scan is ``repro_torch.kernels.ops.ssd_scan`` (the hand-written
CUDA kernel B7 on the card); its plain version, ``ssd_chunked``, lives in
``kernels.ref`` beside the other plain versions and is re-exported here.
Decode advances the state one token in plain PyTorch, as the reference
does.

On the serving mesh's model axis (``dist.tensor_parallel``) a rank holds
H/M of the heads: its columns ``[z_r, x_r, B, C, dt_r]`` of ``in_proj``
(B and C whole: one group), its ``[x_r, B, C]`` channels of the conv, its
heads of ``A_log``, ``D``, ``dt_bias``, its channels of ``norm`` and its
rows of ``out_proj``.  The block reads its heads from ``A_log``'s shape.
The gated RMSNorm takes the mean of squares over all of d_inner: each
rank's f32 sum of squares over its channels crosses the ranks at the
``ssm_norm`` point of ``dist.context`` (a (B, S, 1) sum), divided by the
whole d_inner; in one process (all the heads) it is ``rms_norm`` itself.
``out_proj``'s partial sums cross at ``mixer_out``
(``models.transformer.block_forward``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist import context as dist_ctx
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_chunked  # noqa: F401  (B7's plain version)
from repro_torch.models.layers import dense_init, param, rms_norm


def init_ssm(gen, cfg, d_model: int, *, device, dtype) -> nn.ParameterDict:
    """The reference's parameters, names and shapes: ``in_proj`` (d,
    2·d_in + 2N + H) projecting to z, x, B, C and dt; the depthwise conv
    over x, B and C; ``A_log``, ``D``, ``dt_bias`` per head; the gated
    RMSNorm's ``norm``; ``out_proj``.  A rank's shard config
    (``configs.base.SSMShard``) gives its heads and their channels."""
    s = cfg.ssm
    nheads = s.heads(d_model)
    d_in = nheads * s.d_head
    conv_ch = d_in + 2 * s.d_state
    kw = dict(device=device, dtype=dtype)
    p = {
        "in_proj": dense_init(gen, (d_model, 2 * d_in + 2 * s.d_state + nheads),
                              in_axis=0, **kw),
        "conv_w": dense_init(gen, (s.d_conv, conv_ch), in_axis=0, **kw) * 0.1,
        "conv_b": torch.zeros((conv_ch,), **kw),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads,
                                          device=device)).to(dtype),
        "D": torch.ones((nheads,), **kw),
        # softplus^-1(0.01)
        "dt_bias": torch.full((nheads,), math.log(math.expm1(0.01)), **kw),
        "norm": torch.zeros((d_in,), **kw),
        "out_proj": dense_init(gen, (d_in, d_model), in_axis=0, **kw),
    }
    return nn.ParameterDict({k: param(v) for k, v in p.items()})


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv, then SiLU.  x: (B, S, C); w: (K, C); state:
    the (B, K−1, C) inputs carried from the previous call (zeros when
    None).  Returns (y, new_state)."""
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k)) + b
    # a copy, so the state does not hold the whole padded input alive
    new_state = xp[:, -(k - 1):, :].clone() if k > 1 else None
    return F.silu(y), new_state


def _split_rms_norm(x, scale, eps: float, width: int):
    """``layers.rms_norm`` of a rank's channels of a last dim ``width``
    wide that the model axis splits: the mean of squares over all
    ``width`` channels, from the f32 sums of squares of every rank's
    (``ssm_norm``)."""
    dtype = x.dtype
    x = x.to(torch.float32)
    sq = dist_ctx.apply("ssm_norm", torch.sum(torch.square(x), dim=-1,
                                              keepdim=True))
    x = x * torch.rsqrt(sq / width + eps)
    return (x * (1.0 + scale.to(torch.float32))).to(dtype)


def ssm_forward(params, x, cfg, compute_dtype=torch.bfloat16, conv_state=None,
                ssd_state=None, decode: bool = False, kernels: bool = True):
    """Mamba2 block.  x: (B, S, d).  Returns (out, {"conv": (B, K−1,
    d_in + 2N), "state": (B, H, P, N) f32}).  ``kernels=False`` runs the
    scan's plain version (``ssd_chunked``) where the kernel would run.
    On a shard the heads are A_log's, the caches the rank's."""
    s = cfg.ssm
    d = x.shape[-1]
    nheads = params["A_log"].shape[0]
    d_in = nheads * s.d_head
    n = s.d_state

    def w(name):
        return params[name].to(compute_dtype)

    proj = x @ w("in_proj")
    z, xb, bm, cm, dt = torch.split(proj, [d_in, d_in, n, n, nheads], dim=-1)
    # the conv's and the scan's inputs over the whole sequence where each
    # rank projected its piece of it
    xb, bm, cm, dt = dist_ctx.apply("seq_in", (xb, bm, cm, dt))
    conv_in = torch.cat([xb, bm, cm], dim=-1)
    conv_out, new_conv = _causal_conv(conv_in, w("conv_w"), w("conv_b"),
                                      conv_state)
    xb, bm, cm = torch.split(conv_out, [d_in, n, n], dim=-1)

    dt = F.softplus(dt.to(torch.float32)
                    + params["dt_bias"].to(torch.float32))      # (B, S, H)
    a = -torch.exp(params["A_log"].to(torch.float32))           # (H,)
    loga = a * dt                                               # (B, S, H)
    xh = xb.reshape(*xb.shape[:-1], nheads, s.d_head)
    xdt = xh.to(torch.float32) * dt[..., None]

    if decode:
        # one step: S ← exp(loga) S + xdt ⊗ B;  y = C · S
        state = ssd_state if ssd_state is not None else torch.zeros(
            (x.shape[0], nheads, s.d_head, n), dtype=torch.float32,
            device=x.device)
        aa = torch.exp(loga[:, 0])                              # (B, H)
        upd = torch.einsum("bhp,bn->bhpn", xdt[:, 0],
                           bm[:, 0].to(torch.float32))
        state = aa[..., None, None] * state + upd
        y = torch.einsum("bn,bhpn->bhp", cm[:, 0].to(torch.float32),
                         state)[:, None]
        new_ssd = state
    elif kernels:
        y, new_ssd = ops.ssd_scan(xdt, loga, bm.to(torch.float32),
                                  cm.to(torch.float32), chunk=s.chunk,
                                  state0=ssd_state)
    else:
        y, new_ssd = ssd_chunked(xdt, loga, bm.to(torch.float32),
                                 cm.to(torch.float32), s.chunk, ssd_state)

    y = y + params["D"].to(torch.float32)[:, None] * xh.to(torch.float32)
    y = dist_ctx.apply("seq_out", y)  # back to the rank's piece
    y = y.reshape(*y.shape[:-2], d_in).to(compute_dtype)
    y = y * F.silu(z)
    if d_in == s.expand * d:
        y = rms_norm(y, params["norm"], cfg.norm_eps)
    else:                       # a shard's heads: the norm over every rank's
        y = _split_rms_norm(y, params["norm"], cfg.norm_eps, s.expand * d)
    out = y @ w("out_proj")
    return out.to(x.dtype), {"conv": new_conv, "state": new_ssd}
