"""Wrapper of the fused gossip epilogue kernel (``csrc/gossip.cu``).

Replaces ``repro/kernels/gossip.py::fused_gossip_nd``: one pass over the
packed (n, D) state of one variable computes

    θ' = Wθ + η_s·WΔ,   c' = c + s·(Δ − WΔ).

Bound on an H100: 5·n·D·4 bytes against 4·n²·D flops — memory-bound at the
client counts of the main path; the kernel reads Δ, θ, c once and writes
θ', c' once.  A row block (``row0``) computes out rows [row0, row0 + n_out)
of the epilogue from W's (n_out, n) rows, c (n_out, D) and the whole Δ, θ
(n, D): a rank's rows on the decentralized mesh, over its gathered Δ and
θ; its bound is 2·n·D·4 + 3·n_out·D·4 bytes against 4·n_out·n·D flops.  Two routes, chosen by :func:`route`: the unrolled route (n a
template parameter, every load of a column issued before its first FMA,
both variables of a round in one launch) for n ≤ 8, and the tiled route
(``csrc/epilogue.cuh``, one launch a variable) past it — design notes in
the sources.  The plain version is
``repro_torch.kernels.ref.fused_gossip_ref``; dispatch between the two is
``repro_torch.kernels.ops.fused_gossip_round`` and ``fused_gossip_pair``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gossip_torch_dtype

ROUTES = ("unrolled", "tiled")
MAX_UNROLLED_N = 8   # csrc/gossip.cu kMaxUnrolledN


def route(n: int) -> str:
    """``"unrolled"`` for n ≤ 8 (the main path's n: a launch costs about
    one memory round trip), ``"tiled"`` past it (the churn path's n = 512,
    whose per-thread row loop the unrolled kernel would not fit in
    registers).  n is the contraction length (W's columns), whatever rows
    a row block computes; D does not enter: both kernels take any D."""
    return "unrolled" if n <= MAX_UNROLLED_N else "tiled"


def pair_args(vars_, outs) -> list:
    """The per-variable arguments of a ``*_pair_launch`` C entry point:
    (Δ, θ, c, θ', c', D, η_s, s) for x, then for y — zeros and null
    pointers (D = 0) where there is no y."""
    args = []
    for k in range(2):
        if k < len(vars_):
            delta, theta, c, eta_s, corr = vars_[k]
            t_new, c_new = outs[k]
            args += [delta.data_ptr(), theta.data_ptr(), c.data_ptr(),
                     t_new.data_ptr(), c_new.data_ptr(), delta.shape[-1],
                     float(eta_s), float(corr)]
        else:
            args += [None] * 5 + [0, 0.0, 0.0]
    return args


def fused_gossip_pair_nd(w, x, y=None, *, gossip_dtype=None,
                         force_route=None, row0: int = 0):
    """The epilogue of one variable, or of two sharing W.

    w: (n_out, n) rows [row0, row0 + n_out) of W; x, y: (delta, theta, c,
    eta_s, corr_scale) with delta/theta (n, D) and c (n_out, D) contiguous
    f32 CUDA tensors on one device (D may differ between x and y); y may
    be None.  Out row r's correction reads Δ[row0 + r].  Returns fresh f32
    (θx', cx') or (θx', cx', θy', cy'), each (n_out, D); n_out = n, row0 = 0
    is the whole epilogue.  The route is :func:`route`'s; ``force_route=
    "tiled"`` takes the first port's kernel whatever n (one launch a
    variable), and forcing ``"unrolled"`` past n = 8 raises.  The unrolled
    route runs both variables in one launch.  Counts launches in
    ``fused_gossip_nd.launches`` and, by route, ``fused_gossip_nd.routes``.
    """
    bf16 = gossip_torch_dtype(gossip_dtype) is not None
    vars_ = [x] if y is None else [x, y]
    n = x[0].shape[0]
    n_out = w.shape[0]
    if not 0 <= row0 <= n - n_out:
        raise ValueError(f"rows [{row0}, {row0 + n_out}) of W lie outside "
                         f"its {n} rows")
    _build.check_operand("w", w, (n_out, n))
    for delta, theta, c, _, _ in vars_:
        d = delta.shape[-1]
        for name, t, rows in (("delta", delta, n), ("theta", theta, n),
                              ("c", c, n_out)):
            _build.check_operand(name, t, (rows, d))
    if len({t.device for v in vars_ for t in v[:3]} | {w.device}) != 1:
        raise ValueError("the operands lie on more than one device")
    which = _build.forced_route(route(n), force_route, universal="tiled")
    lib = _build.library("gossip")
    stream = torch.cuda.current_stream(w.device).cuda_stream
    outs = [(torch.empty_like(v[2]), torch.empty_like(v[2])) for v in vars_]
    if which == "unrolled":
        err = lib.fused_gossip_pair_launch(
            w.data_ptr(), *pair_args(vars_, outs), n, n_out, row0, int(bf16),
            stream)
        _build.check(err, "fused_gossip_pair_launch")
        launched = 1
    else:
        for (delta, theta, c, eta_s, corr), (t_new, c_new) in zip(vars_,
                                                                  outs):
            err = lib.fused_gossip_launch(
                w.data_ptr(), delta.data_ptr(), theta.data_ptr(),
                c.data_ptr(), t_new.data_ptr(), c_new.data_ptr(), n, n_out,
                row0, delta.shape[-1], float(eta_s), float(corr), int(bf16),
                stream)
            _build.check(err, "fused_gossip_launch")
        launched = len(vars_)
    fused_gossip_nd.launches += launched
    fused_gossip_nd.routes[which] += launched
    return tuple(t for pair in outs for t in pair)


def fused_gossip_nd(w, delta, theta, c, eta_s, corr_scale, *,
                    gossip_dtype=None, force_route=None):
    """w: (n, n); delta/theta/c: (n, D) contiguous f32 CUDA tensors on one
    device.  Returns fresh f32 (θ_new, c_new): :func:`fused_gossip_pair_nd`
    of one variable."""
    return fused_gossip_pair_nd(w, (delta, theta, c, eta_s, corr_scale),
                                gossip_dtype=gossip_dtype,
                                force_route=force_route)


fused_gossip_nd.launches = 0
fused_gossip_nd.routes = dict.fromkeys(ROUTES, 0)
