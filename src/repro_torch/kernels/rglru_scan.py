"""Wrapper of the RG-LRU scan kernels (``csrc/rglru_scan.cu``).

Replaces ``repro/kernels/rglru_scan.py::rglru_scan_b``: the linear
recurrence h_t = a_t·h_{t−1} + u_t over (B, S, W) f32 from h_{−1} = 0.
Bound on an H100: 12·B·S·W bytes — memory-bound (design notes in the
source).  Two routes, chosen by :func:`route`: the chunked route (one pass
over S in parallel, chunks of :data:`CHUNK` steps joined by decoupled
look-back) where S spans at least two chunks, and the walk route (one
thread a channel walks S; the first port, bit for bit the plain version)
for the rest.  The plain version is ``repro_torch.kernels.ref.rglru_ref``
(and ``ref.rglru_chunked`` writes the chunked route's arithmetic out in
plain PyTorch); dispatch between the plain version and the kernels is
``repro_torch.kernels.ops.rglru_scan``.

The wrapper is differentiable: :class:`RglruScanFn` runs a kernel forward
and the backward kernel (the chunked kernel in reverse time, 20·B·S·W
bytes; ``ref.rglru_bwd_scan`` is its arithmetic, ``ref.rglru_bwd_ref`` the
plain backward).  Under ``torch.func.vmap`` its ``vmap`` rules fold the
vmapped dim into B and launch once, forward and backward.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

ROUTES = ("walk", "chunked")
# steps a chunk of the chunked route (8 runs of 16 steps: ``kChunk`` in the
# source)
CHUNK = 128


def route(b: int, s: int, w: int) -> str:
    """The route of a (B, S, W) call: ``"chunked"`` where S spans at least
    two chunks of :data:`CHUNK` steps, ``"walk"`` otherwise (a single chunk
    has no carry to find: the chunked route would add nothing)."""
    return "chunked" if b > 0 and w > 0 and s > CHUNK else "walk"


def work_bytes(b: int, s: int, w: int) -> int:
    """The chunked kernel's workspace (``carve`` in the source) for its
    tiles, one per (chunk, batch row, 32 channels): a 16-byte ticket, a
    flag a tile padded to 16 bytes, three (tiles, 32) f32 arrays."""
    t = -(-s // CHUNK) * b * -(-w // 32)
    return 16 + 16 * -(-t // 4) + 3 * 32 * 4 * t


def rglru_scan_bsw(a, u, *, force_route=None):
    """a, u: (B, S, W) contiguous f32 CUDA tensors on one device.  Returns a
    fresh f32 h (B, S, W), differentiable in a and u
    (:class:`RglruScanFn`).  The route is :func:`route`'s;
    ``force_route="walk"`` takes the walk whatever the shape, and forcing
    ``"chunked"`` on a shape the rule keeps on the walk raises.  Counts its
    launches in ``rglru_scan_bsw.launches``, by route in
    ``rglru_scan_bsw.routes``, and the backward kernel's in
    ``rglru_scan_bsw.backward_launches``."""
    return RglruScanFn.apply(a, u, force_route)


def _check(what, shape, *tensors):
    for name, x in tensors:
        _build.check_operand(name, x, shape)
    if len({x.device for _, x in tensors}) != 1:
        raise ValueError(f"{what}: the operands lie on more than one device")


def _launch(a, u, force_route):
    """One launch of a forward kernel (the forward of :class:`RglruScanFn`)."""
    b, s, w = a.shape
    _check("rglru_scan", (b, s, w), ("a", a), ("u", u))
    which = _build.forced_route(route(b, s, w), force_route, universal="walk")
    lib = _build.library("rglru_scan")
    h = torch.empty_like(a)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if which == "walk":
        err = lib.rglru_scan_launch(a.data_ptr(), u.data_ptr(), h.data_ptr(),
                                    b, s, w, stream)
    else:
        work = torch.empty((work_bytes(b, s, w),), dtype=torch.uint8,
                           device=a.device)
        err = lib.rglru_chunked_launch(a.data_ptr(), u.data_ptr(),
                                       h.data_ptr(), work.data_ptr(), b, s, w,
                                       stream)
    _build.check(err, f"rglru_{which}_launch")
    rglru_scan_bsw.launches += 1
    rglru_scan_bsw.routes[which] += 1
    return h


def _backward_launch(a, h, grad_h):
    """(da, du) of :func:`rglru_scan_bsw` from a, its output h and the
    incoming gradient: the backward kernel on CUDA tensors, the plain
    backward (``ref.rglru_bwd_ref``) on CPU tensors."""
    if not a.is_cuda:
        return ref.rglru_bwd_ref(a, h, grad_h)
    b, s, w = a.shape
    grad_h = grad_h.to(torch.float32).contiguous()
    _check("rglru_scan backward", (b, s, w), ("a", a), ("h", h),
           ("grad_h", grad_h))
    lib = _build.library("rglru_scan")
    da, du = torch.empty_like(a), torch.empty_like(a)
    work = torch.empty((work_bytes(b, s, w),), dtype=torch.uint8,
                       device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.rglru_scan_bwd_launch(a.data_ptr(), h.data_ptr(),
                                    grad_h.data_ptr(), da.data_ptr(),
                                    du.data_ptr(), work.data_ptr(), b, s, w,
                                    stream)
    _build.check(err, "rglru_scan_bwd_launch")
    rglru_scan_bsw.backward_launches += 1
    return da, du


rglru_scan_bsw.launches = 0
rglru_scan_bsw.routes = dict.fromkeys(ROUTES, 0)
rglru_scan_bsw.backward_launches = 0


def _fold(nb, x, dim):
    """``x`` with the vmapped dim ``dim`` (None: broadcast) folded into B."""
    x = x.movedim(dim, 0) if dim is not None else x.expand(nb, *x.shape)
    return x.reshape(nb * x.shape[1], *x.shape[2:]).contiguous()


class RglruScanFn(torch.autograd.Function):
    """A kernel forward and the backward kernel.  ``launch`` is the
    forward's launch and ``backward_launch`` the backward's (the CPU tests
    swap the plain versions in for both)."""

    launch = staticmethod(_launch)
    backward_launch = staticmethod(_backward_launch)

    @staticmethod
    def forward(a, u, force_route):
        return RglruScanFn.launch(a, u, force_route)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, grad_h):
        a, h = ctx.saved_tensors
        return (*_RglruScanBwdFn.apply(a, h, grad_h), None)

    @staticmethod
    def vmap(info, in_dims, a, u, force_route):
        """The vmapped dim folded into B: one launch for all of it."""
        nb = info.batch_size
        h = RglruScanFn.apply(_fold(nb, a, in_dims[0]),
                              _fold(nb, u, in_dims[1]), force_route)
        return h.reshape(nb, -1, *h.shape[1:]), 0


class _RglruScanBwdFn(torch.autograd.Function):
    """The backward launch as a Function of its own, so that under
    ``vmap(grad)`` its ``vmap`` rule folds the clients into B and the
    backward launches once, as the forward does.  Not differentiable
    again."""

    @staticmethod
    def forward(a, h, grad_h):
        return RglruScanFn.backward_launch(a, h, grad_h)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad_da, grad_du):
        raise RuntimeError("the RG-LRU scan's backward is not differentiable")

    @staticmethod
    def vmap(info, in_dims, a, h, grad_h):
        nb = info.batch_size
        da, du = _RglruScanBwdFn.apply(_fold(nb, a, in_dims[0]),
                                       _fold(nb, h, in_dims[1]),
                                       _fold(nb, grad_h, in_dims[2]))
        return ((da.reshape(nb, -1, *da.shape[1:]),
                 du.reshape(nb, -1, *du.shape[1:])), (0, 0))
