"""Wrapper of the fused cross-entropy kernel (``csrc/cross_entropy.cu``).

Replaces ``repro/kernels/cross_entropy.py::fused_ce_nd``: per-token NLL of
hidden (N, d) against a head weight addressed as (V, d) through its
strides — the tied embedding as it is, an untied (d, V) head as its
transposed view, neither copied — with f32 logits that are never all
resident.  Bound on an H100: 2·N·V·d operations (compute-bound; design
notes in the source).  The plain version is
``repro_torch.kernels.ref.fused_ce_ref``; dispatch between the two is
``repro_torch.kernels.ops.fused_cross_entropy``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_ce_nd(hidden, weight, labels):
    """hidden (N, d) with a contiguous last dimension; weight (V, d) of the
    same dtype (float32 or bfloat16) with one of its two strides 1; labels
    (N,) integers in [0, V); CUDA tensors on one device.  Returns a fresh
    f32 NLL (N,).  Counts its launches in ``fused_ce_nd.launches``."""
    _build.check_no_grad("fused_cross_entropy", hidden, weight)
    if hidden.dtype not in DTYPES or weight.dtype != hidden.dtype:
        raise ValueError(f"hidden and weight must share float32 or bfloat16,"
                         f" got {hidden.dtype} and {weight.dtype}")
    n, d = hidden.shape
    v = weight.shape[0]
    if tuple(weight.shape) != (v, d) or tuple(labels.shape) != (n,):
        raise ValueError(f"shapes hidden {tuple(hidden.shape)}, weight "
                         f"{tuple(weight.shape)}, labels "
                         f"{tuple(labels.shape)} do not fit (N, d), (V, d), "
                         f"(N,)")
    for name, x in (("hidden", hidden), ("weight", weight),
                    ("labels", labels)):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if len({hidden.device, weight.device, labels.device}) != 1:
        raise ValueError("the operands lie on more than one device")
    if d > 1 and hidden.stride(1) != 1:
        raise ValueError("hidden needs a contiguous last dimension")
    if 1 not in weight.stride() and v > 1 and d > 1:
        raise ValueError("weight needs a stride of 1 along V or along d")
    lib = _build.library("cross_entropy")
    lab = labels.to(torch.int32).contiguous()
    nll = torch.empty((n,), dtype=torch.float32, device=hidden.device)
    stream = torch.cuda.current_stream(hidden.device).cuda_stream
    err = lib.fused_ce_launch(
        hidden.data_ptr(), weight.data_ptr(), lab.data_ptr(), nll.data_ptr(),
        n, v, d, hidden.stride(0), *weight.stride(), DTYPES[hidden.dtype],
        stream)
    _build.check(err, "fused_ce_launch")
    fused_ce_nd.launches += 1
    return nll


fused_ce_nd.launches = 0
