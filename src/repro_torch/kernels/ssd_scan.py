"""Wrapper of the SSD chunked-scan kernel (``csrc/ssd_scan.cu``).

Replaces ``repro/kernels/ssd_scan.py::ssd_scan_bh``: the Mamba2 SSD scan of
``repro_torch.models.ssm.ssd_chunked`` on the model layout, from an
optional initial state, returning y and the final state.  Bound on an H100:
the chunked form's multiply-adds on CUDA cores (compute-bound at the served
shape; design notes in the source).  The plain version is
``repro_torch.kernels.ref.ssd_chunked``; dispatch between the two is
``repro_torch.kernels.ops.ssd_scan``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 64, 64, 128


def ssd_scan_bshp(xdt, loga, bm, cm, state0=None, *, chunk: int = 64):
    """xdt (B, S, H, P), loga (B, S, H), bm and cm (B, S, N): f32 CUDA
    tensors on one device, read through their strides (xdt, bm and cm with
    a contiguous last dimension); state0: None or a contiguous f32
    (B, H, P, N).  chunk ≤ 64, P ≤ 64, N ≤ 128.  Returns fresh f32
    (y (B, S, H, P), final_state (B, H, P, N)).  Counts its launches in
    ``ssd_scan_bshp.launches``."""
    _build.check_no_grad("ssd_scan", xdt, loga, bm, cm, state0)
    b, s, h, p = xdt.shape
    n = bm.shape[-1]
    if not 0 < chunk <= MAX_CHUNK or p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(f"ssd_scan takes chunk ≤ {MAX_CHUNK}, P ≤ "
                         f"{MAX_HEAD_DIM} and N ≤ {MAX_STATE}; got chunk "
                         f"{chunk}, P {p}, N {n}")
    for name, x, shape in (("xdt", xdt, (b, s, h, p)), ("loga", loga, (b, s, h)),
                           ("bm", bm, (b, s, n)), ("cm", cm, (b, s, n))):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be float32 of shape {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if name != "loga" and x.shape[-1] > 1 and x.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last dimension")
    if state0 is not None:
        _build.check_operand("state0", state0, (b, h, p, n))
    if len({x.device for x in (xdt, loga, bm, cm, state0)
            if x is not None}) != 1:
        raise ValueError("the operands lie on more than one device")
    lib = _build.library("ssd_scan")
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=xdt.device)
    fin = torch.empty((b, h, p, n), dtype=torch.float32, device=xdt.device)
    stream = torch.cuda.current_stream(xdt.device).cuda_stream
    err = lib.ssd_scan_launch(
        xdt.data_ptr(), loga.data_ptr(), bm.data_ptr(), cm.data_ptr(),
        state0.data_ptr() if state0 is not None else None, y.data_ptr(),
        fin.data_ptr(), b, s, h, p, n, max(1, min(chunk, s)),
        *xdt.stride()[:3], *loga.stride(), *bm.stride()[:2],
        *cm.stride()[:2], stream)
    _build.check(err, "ssd_scan_launch")
    ssd_scan_bshp.launches += 1
    return y, fin


ssd_scan_bshp.launches = 0
