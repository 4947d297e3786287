"""Wrapper of the RG-LRU scan kernel (``csrc/rglru_scan.cu``).

Replaces ``repro/kernels/rglru_scan.py::rglru_scan_b``: the linear
recurrence h_t = a_t·h_{t−1} + u_t over (B, S, W) f32 from h_{−1} = 0.
Bound on an H100: 12·B·S·W bytes — memory-bound (design notes in the
source).  The plain version is ``repro_torch.kernels.ref.rglru_ref``;
dispatch between the two is ``repro_torch.kernels.ops.rglru_scan``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def rglru_scan_bsw(a, u):
    """a, u: (B, S, W) contiguous f32 CUDA tensors on one device.  Returns a
    fresh f32 h (B, S, W).  Counts its launches in
    ``rglru_scan_bsw.launches``."""
    _build.check_no_grad("rglru_scan", a, u)
    b, s, w = a.shape
    _build.check_operand("a", a, (b, s, w))
    _build.check_operand("u", u, (b, s, w))
    if a.device != u.device:
        raise ValueError("the operands lie on more than one device")
    lib = _build.library("rglru_scan")
    h = torch.empty_like(a)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.rglru_scan_launch(a.data_ptr(), u.data_ptr(), h.data_ptr(), b,
                                s, w, stream)
    _build.check(err, "rglru_scan_launch")
    rglru_scan_bsw.launches += 1
    return h


rglru_scan_bsw.launches = 0
