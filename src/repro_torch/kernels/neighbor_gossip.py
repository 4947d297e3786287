"""Wrapper of the neighbor-gather gossip epilogue kernel
(``csrc/neighbor_gossip.cu``).

Replaces ``repro/kernels/neighbor_gossip.py::sparse_gossip_nd``: the
epilogue of ``gossip.fused_gossip_nd`` with W as padded-CSR neighbor lists,

    WΔ_i = w_ii·Δ_i + Σ_s w_is·Δ_{idx_is},   θ' = Wθ + η_s·WΔ,
    c' = c + s·(Δ − WΔ),

in O(n·m·D) with no (n, n) array.  Bound on an H100: 5·n·D·4 + n·(2m+1)·4
bytes against 4·n·(m+1)·D + 4·n·D flops — memory-bound (design notes in
the source).  The plain version is
``repro_torch.kernels.ref.sparse_gossip_ref``; dispatch between the two is
``repro_torch.kernels.ops.sparse_gossip_round``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gossip_torch_dtype


def sparse_gossip_nd(neighbor_idx, neighbor_w, self_w, delta, theta, c,
                     eta_s, corr_scale, *, gossip_dtype=None):
    """neighbor_idx: (n, m) contiguous int32; neighbor_w: (n, m), self_w:
    (n,), delta/theta/c: (n, D) contiguous f32; all CUDA tensors on one
    device.  Returns fresh f32 (θ_new, c_new).  A row with a neighbor index
    outside [0, n) comes out NaN.  Counts its launches in
    ``sparse_gossip_nd.launches``."""
    bf16 = gossip_torch_dtype(gossip_dtype) is not None
    n, d = delta.shape
    m = neighbor_idx.shape[-1]
    _build.check_operand("neighbor_idx", neighbor_idx, (n, m), torch.int32)
    for name, x, shape in (("neighbor_w", neighbor_w, (n, m)),
                           ("self_w", self_w, (n,)),
                           ("delta", delta, (n, d)), ("theta", theta, (n, d)),
                           ("c", c, (n, d))):
        _build.check_operand(name, x, shape)
    if len({x.device for x in (neighbor_idx, neighbor_w, self_w, delta, theta,
                               c)}) != 1:
        raise ValueError("the operands lie on more than one device")
    lib = _build.library("neighbor_gossip")
    theta_new = torch.empty_like(delta)
    c_new = torch.empty_like(delta)
    stream = torch.cuda.current_stream(delta.device).cuda_stream
    err = lib.sparse_gossip_launch(
        neighbor_idx.data_ptr(), neighbor_w.data_ptr(), self_w.data_ptr(),
        delta.data_ptr(), theta.data_ptr(), c.data_ptr(),
        theta_new.data_ptr(), c_new.data_ptr(), n, m, d, float(eta_s),
        float(corr_scale), int(bf16), stream)
    _build.check(err, "sparse_gossip_launch")
    sparse_gossip_nd.launches += 1
    return theta_new, c_new


sparse_gossip_nd.launches = 0
