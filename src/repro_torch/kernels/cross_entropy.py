"""Wrapper of the fused cross-entropy kernel (``csrc/cross_entropy.cu``).

Replaces ``repro/kernels/cross_entropy.py::fused_ce_nd``: per-token NLL of
hidden (N, d) against a head weight addressed as (V, d) through its
strides — the tied embedding as it is, an untied (d, V) head as its
transposed view, neither copied — with f32 logits that are never all
resident.  Bound on an H100: 2·N·V·d operations (compute-bound; design
notes in the source).  Two routes, chosen by :func:`route`: the
tensor-core route (TMA and wgmma) for bf16 operands whose rows TMA can
read, the CUDA-core route for f32 operands and for bf16 rows that are not
16-byte aligned.  The plain version is
``repro_torch.kernels.ref.fused_ce_ref``; dispatch between the plain
version and the kernel is ``repro_torch.kernels.ops.fused_cross_entropy``.

The wrapper is differentiable: :class:`FusedCrossEntropyFn` runs the
kernel forward and takes the plain version's gradient
(``ref.fused_ce_bwd_ref``: per chunk of 512 tokens, the f32 logits
recomputed from the saved operands, then (softmax − onehot)·W and its
transpose against the hidden states), so the (N, V) logits are never all
resident, as the reference's rematerialized scan does.  Under
``torch.func.vmap`` its ``vmap`` rule launches once per vmapped entry
where the head is vmapped too (a client's own weights), once in all
otherwise.

The vocab-parallel form (:func:`fused_ce_partials_nd`, the same two
kernels writing per-token partials: the running max, the exp-sum and the
label's logit over one rank's piece of the vocabulary) is merged over the
model ranks by :class:`VocabParallelCEFn`, which training on a client's
``(fsdp, model)`` block runs; its plain version is
``ref.ce_partials_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"cuda_core": 0, "tensor_core": 1}


def route(dtype, hidden_strides, weight_strides, aligned: bool) -> str:
    """The route of a call: ``"tensor_core"`` where TMA can read both
    operands in bf16 — 16-byte aligned bases (``aligned``), hidden rows
    contiguous with a row stride of whole 16-byte chunks, and a head whose
    d axis (tied) or V axis (an untied head's transposed view) is
    contiguous with the other stride whole chunks too; ``"cuda_core"``
    otherwise (f32 operands, d = 33, a misaligned base)."""
    if dtype != torch.bfloat16 or not aligned:
        return "cuda_core"
    (shn, shd), (swv, swd) = hidden_strides, weight_strides
    chunks = 16 // 2  # bf16 values a 16-byte chunk
    if shd != 1 or shn % chunks:
        return "cuda_core"
    if (swd == 1 and swv % chunks == 0) or (swv == 1 and swd % chunks == 0):
        return "tensor_core"
    return "cuda_core"


def fused_ce_nd(hidden, weight, labels, *, force_route=None):
    """hidden (N, d) with a contiguous last dimension; weight (V, d) of the
    same dtype (float32 or bfloat16) with one of its two strides 1; labels
    (N,) integers in [0, V); CUDA tensors on one device.  Returns a fresh
    f32 NLL (N,).  The route is :func:`route`'s; ``force_route="cuda_core"``
    takes the CUDA-core kernel whatever the operands (to hold both routes
    against the plain version), and forcing ``"tensor_core"`` on operands
    it cannot take raises.  Differentiable in hidden and weight
    (:class:`FusedCrossEntropyFn`).  Counts its launches in
    ``fused_ce_nd.launches`` and, by route, in ``fused_ce_nd.routes``."""
    return FusedCrossEntropyFn.apply(hidden, weight, labels, force_route)


def _launch(hidden, weight, labels, force_route):
    """One launch of the kernel (the forward of
    :class:`FusedCrossEntropyFn`)."""
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
    which = route(hidden.dtype, hidden.stride(), weight.stride(),
                  hidden.data_ptr() % 16 == 0 and weight.data_ptr() % 16 == 0)
    which = _build.forced_route(which, force_route)
    lib = _build.library("cross_entropy")
    lab = labels.to(torch.int32).contiguous()
    nll = torch.empty((n,), dtype=torch.float32, device=hidden.device)
    stream = torch.cuda.current_stream(hidden.device).cuda_stream
    err = lib.fused_ce_launch(
        hidden.data_ptr(), weight.data_ptr(), lab.data_ptr(), nll.data_ptr(),
        n, v, d, hidden.stride(0), *weight.stride(), DTYPES[hidden.dtype],
        ROUTES[which], stream)
    _build.check(err, "fused_ce_launch")
    fused_ce_nd.launches += 1
    fused_ce_nd.routes[which] += 1
    return nll


fused_ce_nd.launches = 0
fused_ce_nd.routes = dict.fromkeys(ROUTES, 0)


class FusedCrossEntropyFn(torch.autograd.Function):
    """The kernel forward with the plain version's gradient.  ``launch`` is
    the forward's launch (the CPU tests swap the plain version in)."""

    launch = staticmethod(_launch)

    @staticmethod
    def forward(hidden, weight, labels, force_route):
        return FusedCrossEntropyFn.launch(hidden, weight, labels, force_route)

    @staticmethod
    def setup_context(ctx, inputs, output):
        hidden, weight, labels, _ = inputs
        ctx.save_for_backward(hidden, weight, labels)

    @staticmethod
    def backward(ctx, grad_nll):
        hidden, weight, labels = ctx.saved_tensors
        gh, gw = ref.fused_ce_bwd_ref(hidden, weight, labels, grad_nll)
        return gh, gw, None, None

    @staticmethod
    def vmap(info, in_dims, hidden, weight, labels, force_route):
        """A vmapped head (each client's own weights): one launch per
        entry.  A shared head: the tokens of every entry in one launch."""
        nb = info.batch_size

        def front(x, dim):
            return (x.movedim(dim, 0) if dim is not None
                    else x.expand(nb, *x.shape))

        h, lab = front(hidden, in_dims[0]), front(labels, in_dims[2])
        if in_dims[1] is None:
            out = FusedCrossEntropyFn.apply(
                h.reshape(-1, h.shape[-1]).contiguous(), weight,
                lab.reshape(-1), force_route)
            return out.reshape(nb, -1), 0
        w = weight.movedim(in_dims[1], 0)
        return torch.stack([FusedCrossEntropyFn.apply(h[i], w[i], lab[i],
                                                      force_route)
                            for i in range(nb)]), 0


# ---------------------------------------------------------------------------
# the vocab-parallel form: one rank's piece of the vocabulary
# ---------------------------------------------------------------------------

def fused_ce_partials_nd(hidden, weight, labels, *, force_route=None):
    """The partials of one launch of B6 on a vocabulary piece: hidden (N,
    d) and the piece (V_r, d) as for :func:`fused_ce_nd`, labels (N,)
    offset by the piece's first id (a label outside [0, V_r) has no logit
    here).  Returns fresh f32 (m, l, z), each (N,): the running max, the
    exp-sum under it and the label's logit (0 outside the piece), what
    ``ref.ce_partials_ref`` computes.  Not differentiable: the training
    path reaches it through :class:`VocabParallelCEFn`.  Counts its
    launches in ``fused_ce_partials_nd.launches`` and ``.routes``."""
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
    if d > 1 and hidden.stride(1) != 1:
        raise ValueError("hidden needs a contiguous last dimension")
    if 1 not in weight.stride() and v > 1 and d > 1:
        raise ValueError("weight needs a stride of 1 along V or along d")
    which = route(hidden.dtype, hidden.stride(), weight.stride(),
                  hidden.data_ptr() % 16 == 0 and weight.data_ptr() % 16 == 0)
    which = _build.forced_route(which, force_route)
    lib = _build.library("cross_entropy")
    lab = labels.to(torch.int32).contiguous()
    z, m, l = (torch.empty((n,), dtype=torch.float32, device=hidden.device)
               for _ in range(3))
    stream = torch.cuda.current_stream(hidden.device).cuda_stream
    err = lib.fused_ce_partials_launch(
        hidden.data_ptr(), weight.data_ptr(), lab.data_ptr(), z.data_ptr(),
        m.data_ptr(), l.data_ptr(), n, v, d, hidden.stride(0),
        *weight.stride(), DTYPES[hidden.dtype], ROUTES[which], stream)
    _build.check(err, "fused_ce_partials_launch")
    fused_ce_partials_nd.launches += 1
    fused_ce_partials_nd.routes[which] += 1
    return m, l, z


fused_ce_partials_nd.launches = 0
fused_ce_partials_nd.routes = dict.fromkeys(ROUTES, 0)


class VocabParallelCEFn(torch.autograd.Function):
    """The per-token NLL over a vocabulary split across the model ranks,
    from this rank's piece: B6's partials of the piece (``launch``; the
    CPU tests swap the plain version in), merged over the model axis by
    ``merge(m, l, z) -> (M, L, Z)`` (``dist.tensor_parallel.
    merge_partials``), nll = M + log L − Z.  The backward is plain
    (``ref.vocab_ce_bwd_ref``: the piece's f32 logits recomputed, with the
    global log-sum-exp M + log L); its hidden gradient is this piece's
    part, which the model axis sums where the hidden states entered the
    head (``head_in``).  Under ``vmap`` one launch a client, each its own
    head, as :class:`FusedCrossEntropyFn`."""

    launch = staticmethod(fused_ce_partials_nd)

    @staticmethod
    def forward(hidden, weight, labels, merge):
        m, l, z = VocabParallelCEFn.launch(hidden, weight, labels)
        big_m, big_l, big_z = merge(m, l, z)
        return ref.merge_nll(big_m, big_l, big_z), big_m + torch.log(big_l)

    @staticmethod
    def setup_context(ctx, inputs, output):
        hidden, weight, labels, _ = inputs
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(hidden, weight, labels, output[1])

    @staticmethod
    def backward(ctx, grad_nll, _):
        hidden, weight, labels, lse = ctx.saved_tensors
        gh, gw = ref.vocab_ce_bwd_ref(hidden, weight, labels, lse, grad_nll)
        return gh, gw, None, None

    @staticmethod
    def vmap(info, in_dims, hidden, weight, labels, merge):
        nb = info.batch_size

        def front(x, dim):
            return (x.movedim(dim, 0) if dim is not None
                    else x.expand(nb, *x.shape))

        h, lab = front(hidden, in_dims[0]), front(labels, in_dims[2])
        if in_dims[1] is None:
            nll, lse = VocabParallelCEFn.apply(
                h.reshape(-1, h.shape[-1]).contiguous(), weight,
                lab.reshape(-1), merge)
            return (nll.reshape(nb, -1), lse.reshape(nb, -1)), (0, 0)
        w = weight.movedim(in_dims[1], 0)
        outs = [VocabParallelCEFn.apply(h[i], w[i], lab[i], merge)
                for i in range(nb)]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs])), (0, 0)
