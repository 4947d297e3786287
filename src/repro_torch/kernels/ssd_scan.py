"""Wrapper of the SSD chunked-scan kernels (``csrc/ssd_scan.cu``).

Replaces ``repro/kernels/ssd_scan.py::ssd_scan_bh``: the Mamba2 SSD scan of
``repro_torch.models.ssm.ssd_chunked`` on the model layout, from an
optional initial state, returning y and the final state.  Bound on an H100:
the chunked form's operations (design notes in the source).  Two routes,
chosen by :func:`route`: the tensor-core route (C·Bᵀ once per batch row and
chunk, 3xTF32 ``mma.sync`` products, cp.async staging, segments run in
parallel when the batch is small) for operands whose rows cp.async can
stage in 16-byte pieces, and the CUDA-core route for the rest.  The plain
version is ``repro_torch.kernels.ref.ssd_chunked`` (and
``ref.ssd_segmented`` writes the tensor-core route's segment algebra out
in plain PyTorch); dispatch between the plain version and the kernels is
``repro_torch.kernels.ops.ssd_scan``.

The wrapper is differentiable: :class:`SsdScanFn` runs the kernel forward
and takes the plain version's gradient (``ref.ssd_bwd_ref``: the VJP of
``ref.ssd_chunked`` recomputed from the saved f32 inputs).  Under
``torch.func.vmap`` its ``vmap`` rule folds the vmapped dim into B — a
reshape, which keeps the strided views the kernel reads — and launches
once.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 64, 64, 128
ROUTES = {"cuda_core": 0, "tensor_core": 1}
# the blocks the card runs at once: an H100's 132 SMs × 2 blocks of the
# tensor-core kernel (104 KB of shared memory each)
SLOTS = 132 * 2


def route(head_dim: int, state_dim: int, strides, aligned: bool) -> str:
    """The route of a call: ``"tensor_core"`` when cp.async can stage every
    row in 16-byte pieces — ``head_dim`` (P) and ``state_dim`` (N) multiples
    of 4, every stride in ``strides`` (those of xdt, bm and cm) but the
    unit last one a multiple of 4 floats, 16-byte aligned bases
    (``aligned``); ``"cuda_core"`` otherwise."""
    if not aligned or head_dim % 4 or state_dim % 4:
        return "cuda_core"
    for st in strides:
        if st[-1] != 1 or any(x % 4 for x in st[:-1]):
            return "cuda_core"
    return "tensor_core"


def segments(batch: int, heads: int, chunks: int):
    """(T, chunks a segment) of the tensor-core route: one segment when the
    batch's B·H blocks fill the card's SLOTS, else as many as fill it (each
    of whole chunks, none empty) — 4 at batch 1 × 64 heads."""
    want = max(1, min(chunks, SLOTS // max(1, batch * heads)))
    per = -(-max(chunks, 1) // want)
    return -(-max(chunks, 1) // per), per


def ssd_scan_bshp(xdt, loga, bm, cm, state0=None, *, chunk: int = 64,
                  force_route=None):
    """xdt (B, S, H, P), loga (B, S, H), bm and cm (B, S, N): f32 CUDA
    tensors on one device, read through their strides (xdt, bm and cm with
    a contiguous last dimension); state0: None or a contiguous f32
    (B, H, P, N).  chunk ≤ 64, P ≤ 64, N ≤ 128.  Returns fresh f32
    (y (B, S, H, P), final_state (B, H, P, N)).  The route is
    :func:`route`'s; ``force_route="cuda_core"`` takes the CUDA-core kernel
    whatever the operands, and forcing ``"tensor_core"`` on operands it
    cannot take raises.  Differentiable in xdt, loga, bm, cm and state0
    (:class:`SsdScanFn`).  Counts its launches in
    ``ssd_scan_bshp.launches`` and, by route, in
    ``ssd_scan_bshp.routes``."""
    return SsdScanFn.apply(xdt, loga, bm, cm, state0, chunk, force_route)


def _launch(xdt, loga, bm, cm, state0, chunk, force_route):
    """One launch of the kernel (the forward of :class:`SsdScanFn`)."""
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
    which = route(p, n, (xdt.stride(), bm.stride(), cm.stride()),
                  all(x.data_ptr() % 16 == 0
                      for x in (xdt, bm, cm, state0) if x is not None))
    which = _build.forced_route(which, force_route)
    lib = _build.library("ssd_scan")
    dev = xdt.device
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=dev)
    fin = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    length = max(1, min(chunk, s))
    nc = -(-s // length)
    n_seg, per_seg = segments(b, h, nc)
    cb = seg_state = seg_decay = None
    if which == "tensor_core":
        lt = -(-length // 8) * 8
        cb = torch.empty((b, nc, lt, lt), dtype=torch.float32, device=dev)
        if n_seg > 1:
            seg_state = torch.empty((b, n_seg - 1, h, p, n),
                                    dtype=torch.float32, device=dev)
            seg_decay = torch.empty((b, n_seg - 1, h), dtype=torch.float32,
                                    device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ssd_scan_launch(
        xdt.data_ptr(), loga.data_ptr(), bm.data_ptr(), cm.data_ptr(),
        ptr(state0), y.data_ptr(), fin.data_ptr(), ptr(cb), ptr(seg_state),
        ptr(seg_decay), b, s, h, p, n, length, n_seg, per_seg, ROUTES[which],
        *xdt.stride()[:3], *loga.stride(), *bm.stride()[:2],
        *cm.stride()[:2], stream)
    _build.check(err, "ssd_scan_launch")
    ssd_scan_bshp.launches += 1
    ssd_scan_bshp.routes[which] += 1
    return y, fin


ssd_scan_bshp.launches = 0
ssd_scan_bshp.routes = dict.fromkeys(ROUTES, 0)


class SsdScanFn(torch.autograd.Function):
    """The kernel forward with the plain version's gradient.  ``launch`` is
    the forward's launch (the CPU tests swap the plain version in)."""

    launch = staticmethod(_launch)

    @staticmethod
    def forward(xdt, loga, bm, cm, state0, chunk, force_route):
        return SsdScanFn.launch(xdt, loga, bm, cm, state0, chunk,
                                force_route)

    @staticmethod
    def setup_context(ctx, inputs, output):
        xdt, loga, bm, cm, state0, chunk, _ = inputs
        ctx.save_for_backward(xdt, loga, bm, cm, state0)
        ctx.chunk = chunk

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        xdt, loga, bm, cm, state0 = ctx.saved_tensors
        return (*ref.ssd_bwd_ref(xdt, loga, bm, cm, ctx.chunk, state0,
                                 grad_y, grad_state), None, None)

    @staticmethod
    def vmap(info, in_dims, xdt, loga, bm, cm, state0, chunk, force_route):
        """The vmapped dim folded into B: one launch for all of it."""
        nb = info.batch_size

        def fold(x, dim):
            if x is None:
                return None
            x = (x.movedim(dim, 0) if dim is not None
                 else x.expand(nb, *x.shape))
            return x.reshape(nb * x.shape[1], *x.shape[2:])

        y, fin = SsdScanFn.apply(
            fold(xdt, in_dims[0]), fold(loga, in_dims[1]),
            fold(bm, in_dims[2]), fold(cm, in_dims[3]),
            None if state0 is None else fold(state0, in_dims[4]).contiguous(),
            chunk, force_route)
        return ((y.reshape(nb, -1, *y.shape[1:]),
                 fin.reshape(nb, -1, *fin.shape[1:])), (0, 0))
