"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention.py::flash_attention_bhsd``:
causal or sliding-window GQA attention with an f32 online softmax, on the
model layout q (B, Sq, H, D), k and v (B, Sk, KV, D).  Bound on an H100:
4·B·H·(keys seen)·D flops against the bytes of q, k, v and o — compute-bound
at the served shapes (design notes in the source).  Two routes, chosen by
:func:`route`: the tensor-core route (mma.sync on bf16 tiles, cp.async)
for bf16 operands with 16-byte aligned rows, the CUDA-core route for f32
operands and for bf16 rows that are not whole 16-byte chunks.  The plain
version is ``repro_torch.kernels.ref.attention_ref``; dispatch between the
plain version and the kernel is ``repro_torch.kernels.ops.flash_attention``.

The wrapper is differentiable: :class:`FlashAttentionFn` runs the kernel
forward and, as the JAX package's models differentiate through plain ops,
takes the gradient of the plain version (``ref.attention_bwd_ref``, its
closed form, recomputing the f32 probabilities from the saved q, k, v).
Under ``torch.func.vmap`` its ``vmap`` rule folds the vmapped dim into B
and launches once.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"cuda_core": 0, "tensor_core": 1}
MAX_HEAD_DIM = 256


def route(dtype, head_dim: int, strides, aligned: bool) -> str:
    """The route of a call: ``"tensor_core"`` for bf16 operands whose rows
    cp.async and ldmatrix can read — 16-byte aligned bases (``aligned``),
    ``head_dim`` ≤ 256 and a multiple of 8, and every stride in ``strides``
    (those of q, k and v) either the unit last one or whole 16-byte
    chunks; ``"cuda_core"`` otherwise (f32 operands, D = 33 or 36, a
    misaligned base)."""
    chunks = 16 // 2  # bf16 values a 16-byte chunk
    if (dtype != torch.bfloat16 or not aligned or head_dim > MAX_HEAD_DIM
            or head_dim % chunks):
        return "cuda_core"
    for st in strides:
        if st[-1] != 1 or any(x % chunks for x in st[:-1]):
            return "cuda_core"
    return "tensor_core"


def flash_attention_bshd(q, k, v, *, causal: bool = True, window: int = 0,
                         force_route=None):
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D); contiguous CUDA tensors of
    one dtype (float32 or bfloat16) on one device, H % KV == 0, D ≤ 256.
    Returns a fresh (B, Sq, H, D) tensor in q's dtype, differentiable in
    q, k and v (:class:`FlashAttentionFn`).  The route is :func:`route`'s;
    ``force_route="cuda_core"`` takes the CUDA-core kernel whatever the
    operands (to hold both routes against the plain version), and forcing
    ``"tensor_core"`` on operands it cannot take raises.  Counts its
    launches in ``flash_attention_bshd.launches`` and, by route, in
    ``flash_attention_bshd.routes``."""
    return FlashAttentionFn.apply(q, k, v, causal, window, force_route)


def _launch(q, k, v, causal, window, force_route):
    """One launch of the kernel (the forward of :class:`FlashAttentionFn`)."""
    if q.dtype not in DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {MAX_HEAD_DIM}")
    if kv == 0 or h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} KV heads")
    _build.check_operand("q", q, (b, sq, h, d), q.dtype)
    _build.check_operand("k", k, (b, sk, kv, d), q.dtype)
    _build.check_operand("v", v, (b, sk, kv, d), q.dtype)
    if len({x.device for x in (q, k, v)}) != 1:
        raise ValueError("the operands lie on more than one device")
    which = route(q.dtype, d, (q.stride(), k.stride(), v.stride()),
                  all(x.data_ptr() % 16 == 0 for x in (q, k, v)))
    which = _build.forced_route(which, force_route)
    lib = _build.library("flash_attention")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk,
        h, kv, d, int(bool(causal)), int(window), DTYPES[q.dtype],
        ROUTES[which], stream)
    _build.check(err, "flash_attention_launch")
    flash_attention_bshd.launches += 1
    flash_attention_bshd.routes[which] += 1
    return out


flash_attention_bshd.launches = 0
flash_attention_bshd.routes = dict.fromkeys(ROUTES, 0)


class FlashAttentionFn(torch.autograd.Function):
    """The kernel forward with the plain version's gradient.  ``launch`` is
    the forward's launch (the CPU tests swap the plain version in)."""

    launch = staticmethod(_launch)

    @staticmethod
    def forward(q, k, v, causal, window, force_route):
        return FlashAttentionFn.launch(q, k, v, causal, window, force_route)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, _ = inputs
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = ref.attention_bwd_ref(q, k, v, grad_out,
                                           causal=ctx.causal,
                                           window=ctx.window)
        return dq, dk, dv, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, force_route):
        """The vmapped dim folded into B: one launch for all of it."""
        nb = info.batch_size

        def fold(x, dim):
            x = (x.movedim(dim, 0) if dim is not None
                 else x.expand(nb, *x.shape))
            return x.reshape(nb * x.shape[1], *x.shape[2:]).contiguous()

        out = FlashAttentionFn.apply(fold(q, in_dims[0]), fold(k, in_dims[1]),
                                     fold(v, in_dims[2]), causal, window,
                                     force_route)
        return out.reshape(nb, -1, *out.shape[1:]), 0
