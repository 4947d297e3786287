"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention.py::flash_attention_bhsd``:
causal or sliding-window GQA attention with an f32 online softmax, on the
model layout q (B, Sq, H, D), k and v (B, Sk, KV, D).  Bound on an H100:
4·B·H·(keys seen)·D flops against the bytes of q, k, v and o — compute-bound
at the served shapes (design notes in the source).  The plain version is
``repro_torch.kernels.ref.attention_ref``; dispatch between the two is
``repro_torch.kernels.ops.flash_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def flash_attention_bshd(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D); contiguous CUDA tensors of
    one dtype (float32 or bfloat16) on one device, H % KV == 0, D ≤ 256.
    Returns a fresh (B, Sq, H, D) tensor in q's dtype.  Counts its launches
    in ``flash_attention_bshd.launches``."""
    _build.check_no_grad("flash_attention", q, k, v)
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
    lib = _build.library("flash_attention")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk,
        h, kv, d, int(bool(causal)), int(window), DTYPES[q.dtype], stream)
    _build.check(err, "flash_attention_launch")
    flash_attention_bshd.launches += 1
    return out


flash_attention_bshd.launches = 0
