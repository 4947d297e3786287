"""Wrapper of the RG-LRU scan kernel (``csrc/rglru_scan.cu``).

Replaces ``repro/kernels/rglru_scan.py::rglru_scan_b``: the linear
recurrence h_t = a_t·h_{t−1} + u_t over (B, S, W) f32 from h_{−1} = 0.
Bound on an H100: 12·B·S·W bytes — memory-bound (design notes in the
source).  The plain version is ``repro_torch.kernels.ref.rglru_ref``;
dispatch between the two is ``repro_torch.kernels.ops.rglru_scan``.

The wrapper is differentiable: :class:`RglruScanFn` runs the kernel
forward and takes the plain gradient (``ref.rglru_bwd_ref``: the same
recurrence run backward in time from the saved a and h).  Under
``torch.func.vmap`` its ``vmap`` rule folds the vmapped dim into B and
launches once.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def rglru_scan_bsw(a, u):
    """a, u: (B, S, W) contiguous f32 CUDA tensors on one device.  Returns a
    fresh f32 h (B, S, W), differentiable in a and u
    (:class:`RglruScanFn`).  Counts its launches in
    ``rglru_scan_bsw.launches``."""
    return RglruScanFn.apply(a, u)


def _launch(a, u):
    """One launch of the kernel (the forward of :class:`RglruScanFn`)."""
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


class RglruScanFn(torch.autograd.Function):
    """The kernel forward with the plain version's gradient.  ``launch`` is
    the forward's launch (the CPU tests swap the plain version in)."""

    launch = staticmethod(_launch)

    @staticmethod
    def forward(a, u):
        return RglruScanFn.launch(a, u)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, grad_h):
        a, h = ctx.saved_tensors
        return ref.rglru_bwd_ref(a, h, grad_h)

    @staticmethod
    def vmap(info, in_dims, a, u):
        """The vmapped dim folded into B: one launch for all of it."""
        nb = info.batch_size

        def fold(x, dim):
            x = (x.movedim(dim, 0) if dim is not None
                 else x.expand(nb, *x.shape))
            return x.reshape(nb * x.shape[1], *x.shape[2:]).contiguous()

        h = RglruScanFn.apply(fold(a, in_dims[0]), fold(u, in_dims[1]))
        return h.reshape(nb, -1, *h.shape[1:]), 0
