"""Wrapper of the neighbor-gather gossip epilogue kernel
(``csrc/neighbor_gossip.cu``).

Replaces ``repro/kernels/neighbor_gossip.py::sparse_gossip_nd``: the
epilogue of ``gossip.fused_gossip_nd`` with W as padded-CSR neighbor lists,

    WΔ_i = w_ii·Δ_i + Σ_s w_is·Δ_{idx_is},   θ' = Wθ + η_s·WΔ,
    c' = c + s·(Δ − WΔ),

in O(n·m·D) with no (n, n) array.  Bound on an H100: 5·n·D·4 + n·(2m+1)·4
bytes against 4·n·(m+1)·D + 4·n·D flops — memory-bound.  The table's n rows
are the out rows; its indices address n_src ≥ n source rows of Δ and θ,
out row i's self term reading source row i (on the decentralized mesh a
rank's own rows, then the halo rows it received).  Two routes,
chosen by :func:`route`: the stripe route (a block holds a 4-column stripe
of Δ and θ over all n rows in shared memory and serves every gather from
there, the table streaming through in double-buffered chunks; both
variables of a round in one launch) wherever the stripe and the table
buffers fit a block's shared memory, and the row-block route (the first
port: every gather from L2, one launch a variable) past that — design notes
in the source.  The plain version is
``repro_torch.kernels.ref.sparse_gossip_ref``; dispatch between the two is
``repro_torch.kernels.ops.sparse_gossip_round`` and ``sparse_gossip_pair``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gossip import pair_args
from repro_torch.kernels.ref import gossip_torch_dtype

ROUTES = ("stripe", "row_block")
# csrc/neighbor_gossip.cu: kStripeCols, kStripeChunk, kMaxStripeSmem
STRIPE_WIDTH = 4
CHUNK_ROWS = 256
MAX_SMEM = 232448          # the 227 KB a block may opt in to on an H100


def stripe_smem_bytes(n: int, m: int, bf16: bool) -> int:
    """Dynamic shared memory of a stripe block: Δ and θ of STRIPE_WIDTH
    columns over the n source rows it holds (n_src; f32, or bf16 narrowed)
    and two table buffers of CHUNK_ROWS rows (idx, w, w_ii)."""
    stripe = -(-n * STRIPE_WIDTH * (2 if bf16 else 4) // 16) * 16
    return 2 * stripe + 2 * CHUNK_ROWS * (2 * m + 1) * 4


def stripe_width(n: int, m: int, bf16: bool) -> int:
    """The stripe route's columns a block (STRIPE_WIDTH), or 0 where a
    stripe of all n source rows and the table buffers do not fit MAX_SMEM
    (f32:
    n ≤ 4256 at m = 23; bf16: n ≤ 8512)."""
    return STRIPE_WIDTH if stripe_smem_bytes(n, m, bf16) <= MAX_SMEM else 0


def route(n: int, m: int, bf16: bool) -> str:
    """``"stripe"`` where :func:`stripe_width` is not 0, else
    ``"row_block"``; n is the source rows a stripe holds (n_src).  D does
    not enter: a stripe holds a fixed number of columns, and the grid
    covers D."""
    return "stripe" if stripe_width(n, m, bf16) else "row_block"


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x itself if its data is 16-byte aligned (the stripe route copies
    the table 16 bytes at a time), else an aligned copy."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def sparse_gossip_pair_nd(neighbor_idx, neighbor_w, self_w, x, y=None, *,
                          gossip_dtype=None, force_route=None):
    """The neighbor-gather epilogue of one variable, or of two sharing W.

    neighbor_idx: (n, m) contiguous int32; neighbor_w: (n, m), self_w:
    (n,); x, y: (delta, theta, c, eta_s, corr_scale) with delta/theta
    (n_src, D), n_src ≥ n, and c (n, D) contiguous f32 (D may differ
    between x and y); y may be None; all CUDA tensors on one device.  The
    table's indices address the n_src source rows, out row i's self term
    reading source row i.  Returns fresh f32 (θx', cx') or (θx', cx', θy',
    cy'), each (n, D).  A row with a neighbor index outside [0, n_src)
    comes out NaN.  The route is :func:`route`'s at n_src;
    ``force_route="row_block"``
    takes the first port's kernel whatever the shapes (one launch a
    variable), and forcing ``"stripe"`` where it does not fit raises.
    Counts launches in ``sparse_gossip_nd.launches`` and, by route,
    ``sparse_gossip_nd.routes``."""
    bf16 = gossip_torch_dtype(gossip_dtype) is not None
    vars_ = [x] if y is None else [x, y]
    n, m = neighbor_idx.shape
    n_src = x[0].shape[0]
    if n_src < n:
        raise ValueError(f"{n_src} source rows for {n} out rows: the out "
                         "rows' own rows come first among the sources")
    _build.check_operand("neighbor_idx", neighbor_idx, (n, m), torch.int32)
    _build.check_operand("neighbor_w", neighbor_w, (n, m))
    _build.check_operand("self_w", self_w, (n,))
    for delta, theta, c, _, _ in vars_:
        d = delta.shape[-1]
        for name, t, rows in (("delta", delta, n_src), ("theta", theta, n_src),
                              ("c", c, n)):
            _build.check_operand(name, t, (rows, d))
    if len({t.device for v in vars_ for t in v[:3]}
           | {neighbor_idx.device, neighbor_w.device, self_w.device}) != 1:
        raise ValueError("the operands lie on more than one device")
    which = _build.forced_route(route(n_src, m, bf16), force_route,
                                universal="row_block")
    lib = _build.library("neighbor_gossip")
    stream = torch.cuda.current_stream(self_w.device).cuda_stream
    outs = [(torch.empty_like(v[2]), torch.empty_like(v[2])) for v in vars_]
    if which == "stripe":
        tab = [_aligned(t) for t in (neighbor_idx, neighbor_w, self_w)]
        err = lib.sparse_gossip_pair_launch(
            *(t.data_ptr() for t in tab), *pair_args(vars_, outs), n, n_src,
            m, int(bf16), stream)
        _build.check(err, "sparse_gossip_pair_launch")
        launched = 1
    else:
        for (delta, theta, c, eta_s, corr), (t_new, c_new) in zip(vars_,
                                                                  outs):
            err = lib.sparse_gossip_launch(
                neighbor_idx.data_ptr(), neighbor_w.data_ptr(),
                self_w.data_ptr(), delta.data_ptr(), theta.data_ptr(),
                c.data_ptr(), t_new.data_ptr(), c_new.data_ptr(), n, n_src,
                m, delta.shape[-1], float(eta_s), float(corr), int(bf16),
                stream)
            _build.check(err, "sparse_gossip_launch")
        launched = len(vars_)
    sparse_gossip_nd.launches += launched
    sparse_gossip_nd.routes[which] += launched
    return tuple(t for pair in outs for t in pair)


def sparse_gossip_nd(neighbor_idx, neighbor_w, self_w, delta, theta, c,
                     eta_s, corr_scale, *, gossip_dtype=None,
                     force_route=None):
    """neighbor_idx: (n, m) contiguous int32; neighbor_w: (n, m), self_w:
    (n,), delta/theta: (n_src, D), c: (n, D) contiguous f32; all CUDA
    tensors on one device.  Returns fresh f32 (θ_new, c_new):
    :func:`sparse_gossip_pair_nd` of one variable."""
    return sparse_gossip_pair_nd(
        neighbor_idx, neighbor_w, self_w, (delta, theta, c, eta_s,
                                           corr_scale),
        gossip_dtype=gossip_dtype, force_route=force_route)


sparse_gossip_nd.launches = 0
sparse_gossip_nd.routes = dict.fromkeys(ROUTES, 0)
