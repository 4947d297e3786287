"""Wrapper of the fused gossip epilogue kernel (``csrc/gossip.cu``).

Replaces ``repro/kernels/gossip.py::fused_gossip_nd``: one pass over the
packed (n, D) state of one variable computes

    θ' = Wθ + η_s·WΔ,   c' = c + s·(Δ − WΔ).

Bound on an H100: 5·n·D·4 bytes against 4·n²·D flops — memory-bound at the
client counts of the main path; the kernel reads Δ, θ, c once and writes
θ', c' once (design notes in ``csrc/epilogue.cuh``).  The plain version is
``repro_torch.kernels.ref.fused_gossip_ref``; dispatch between the two is
``repro_torch.kernels.ops.fused_gossip_round``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gossip_torch_dtype


def fused_gossip_nd(w, delta, theta, c, eta_s, corr_scale, *,
                    gossip_dtype=None):
    """w: (n, n); delta/theta/c: (n, D) contiguous f32 CUDA tensors on one
    device.  Returns fresh f32 (θ_new, c_new).  Counts its launches in
    ``fused_gossip_nd.launches``."""
    bf16 = gossip_torch_dtype(gossip_dtype) is not None
    n, d = delta.shape
    for name, x, shape in (("w", w, (n, n)), ("delta", delta, (n, d)),
                           ("theta", theta, (n, d)), ("c", c, (n, d))):
        _build.check_operand(name, x, shape)
    lib = _build.library("gossip")
    theta_new = torch.empty_like(delta)
    c_new = torch.empty_like(delta)
    stream = torch.cuda.current_stream(delta.device).cuda_stream
    err = lib.fused_gossip_launch(
        w.data_ptr(), delta.data_ptr(), theta.data_ptr(), c.data_ptr(),
        theta_new.data_ptr(), c_new.data_ptr(), n, d, float(eta_s),
        float(corr_scale), int(bf16), stream)
    _build.check(err, "fused_gossip_launch")
    fused_gossip_nd.launches += 1
    return theta_new, c_new


fused_gossip_nd.launches = 0
