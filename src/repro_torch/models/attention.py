"""GQA attention (port of ``repro.models.attention``): naive (the oracle and
the ``train`` mode), q-chunked (the reference's long prefill, kept as the
memory-bounded form of the naive one), and decode over a cache, with an
optional sliding window.  GQA groups the query heads; k and v are never repeated to
H heads.  The prefill path (``models.transformer``) calls
``repro_torch.kernels.ops.flash_attention`` instead, the hand-written CUDA
kernel of the same function.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers import apply_rope, dense_init, param

NEG_INF = -1e30


def init_attention(gen, cfg, d_model: int, *, device, dtype) -> nn.ParameterDict:
    """cfg: ModelConfig (num_heads / num_kv_heads / head_dim / qkv_bias)."""
    hd = cfg.resolved_head_dim
    kw = dict(device=device, dtype=dtype)
    p = {
        "wq": dense_init(gen, (d_model, cfg.num_heads, hd), in_axis=0, **kw),
        "wk": dense_init(gen, (d_model, cfg.num_kv_heads, hd), in_axis=0,
                         **kw),
        "wv": dense_init(gen, (d_model, cfg.num_kv_heads, hd), in_axis=0,
                         **kw),
        "wo": dense_init(gen, (cfg.num_heads, hd, d_model), in_axis=0, **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.num_heads, hd), **kw)
        p["bk"] = torch.zeros((cfg.num_kv_heads, hd), **kw)
        p["bv"] = torch.zeros((cfg.num_kv_heads, hd), **kw)
    return nn.ParameterDict({k: param(v) for k, v in p.items()})


def _project(x, w):
    """x (..., d) by w (d, heads, hd) -> (..., heads, hd)."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])


def qkv_project(params, x, cfg, positions, compute_dtype=torch.bfloat16):
    def w(name):
        return params[name].to(compute_dtype)

    q, k, v = _project(x, w("wq")), _project(x, w("wk")), _project(x, w("wv"))
    if "bq" in params:
        q = q + w("bq")
        k = k + w("bk")
        v = v + w("bv")
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_project(params, ctx, compute_dtype=torch.bfloat16):
    wo = params["wo"].to(compute_dtype)
    return ctx.reshape(*ctx.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1])


def causal_mask(sq: int, sk: int, q_offset: int = 0, window: int = 0,
                device=None):
    """Boolean (sq, sk) mask, True = attend: query i at absolute position
    q_offset + i sees keys j ≤ i and, if window > 0, i − j < window."""
    qi = q_offset + torch.arange(sq, device=device)[:, None]
    kj = torch.arange(sk, device=device)[None, :]
    m = kj <= qi
    if window > 0:
        m &= kj > qi - window
    return m


def _softmax_attend(qg, k, v, mask, scale, dtype):
    """qg (B,Sq,KV,G,D) against k, v (B,Sk,KV,D) under mask (broadcast to
    (B,KV,G,Sq,Sk)); logits in the compute dtype, softmax in f32, the
    probabilities back in the compute dtype, as the reference does."""
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(torch.float32)
    logits = torch.where(mask, logits * scale, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v)


def naive_attention(q, k, v, *, window: int = 0, q_offset: int = 0):
    """Reference attention.  q: (B,Sq,H,D); k, v: (B,Sk,KV,D)."""
    b, sq, h, d = q.shape
    kv = k.shape[-2]
    mask = causal_mask(sq, k.shape[-3], q_offset, window, q.device)
    ctx = _softmax_attend(q.reshape(b, sq, kv, h // kv, d), k, v, mask,
                          d ** -0.5, q.dtype)
    return ctx.reshape(b, sq, h, d)


def qchunk_attention(q, k, v, *, window: int = 0, q_chunk: int = 512):
    """Memory-bounded naive attention: query blocks of ``q_chunk`` (scores
    materialized per block only)."""
    s = q.shape[1]
    qc = min(q_chunk, s)
    return torch.cat([naive_attention(q[:, i:i + qc], k, v, window=window,
                                      q_offset=i)
                      for i in range(0, s, qc)], dim=1)


def decode_attention(q, k_cache, v_cache, valid):
    """Single-token decode: q (B,1,H,D) against a cache (B,S,KV,D) with a
    boolean validity mask ``valid`` (S,), or (B,S) with a row per
    sequence — False for slots not yet written."""
    b, one, h, d = q.shape
    kv = k_cache.shape[-2]
    if valid.dim() == 2:                  # (B, KV, G, Sq, S)
        valid = valid[:, None, None, None, :]
    ctx = _softmax_attend(q.reshape(b, one, kv, h // kv, d), k_cache,
                          v_cache, valid, d ** -0.5, q.dtype)
    return ctx.reshape(b, one, h, d)
