"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``:
the round kernels of ``:63-165``, ``attention_ref`` of ``:12-31`` and
``rglru_ref`` of ``:196-208``).

They are what the wrappers run on CPU tensors, and what ``chip_smoke.py``
holds the CUDA kernels against on the card.  Dtype rules follow the
reference: the W-contraction operands are narrowed to ``gossip_dtype``, the
products accumulate in f32, and Δ (or q) stays f32 inside the correction;
attention and the RG-LRU recurrence compute in f32.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.quantize import quantize_dequant

NEG_INF = -1e30


def gossip_torch_dtype(gossip_dtype) -> Optional[torch.dtype]:
    """Config string ("float32" / "bfloat16" / None) -> narrowing dtype."""
    if gossip_dtype in (None, "float32", torch.float32):
        return None
    if gossip_dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"unknown gossip_dtype {gossip_dtype!r}")


def narrow(x: torch.Tensor, gd: Optional[torch.dtype]) -> torch.Tensor:
    """x rounded to the gossip dtype, held in f32 (identity for None)."""
    x = x.to(torch.float32)
    return x if gd is None else x.to(gd).to(torch.float32)


def fused_gossip_ref(w, delta, theta, c, eta_s, corr_scale, *,
                     gossip_dtype=None):
    """Packed round epilogue for one variable (Algorithm 1 lines 7–11).

    w: (n, n); delta/theta/c: (n, D).  Returns f32
    (θ_new, c_new) = (Wθ + η_s·WΔ, c + s·(Δ − WΔ)).
    """
    gd = gossip_torch_dtype(gossip_dtype)
    wg = narrow(w, gd)
    d32 = delta.to(torch.float32)
    wd = wg @ narrow(delta, gd)
    wt = wg @ narrow(theta, gd)
    theta_new = wt + float(eta_s) * wd
    c_new = c.to(torch.float32) + float(corr_scale) * (d32 - wd)
    return theta_new, c_new


def sparse_gossip_ref(neighbor_idx, neighbor_w, self_w, delta, theta, c,
                      eta_s, corr_scale, *, gossip_dtype=None):
    """The same epilogue as :func:`fused_gossip_ref` with W in padded-CSR
    form.

    neighbor_idx: (n, m) int (padding = own index); neighbor_w: (n, m) with
    padding weight 0; self_w: (n,) diagonal; delta/theta/c: (n, D).  Raw
    tensors, not a ``SparseTopology``, so the kernels package needs nothing
    of ``core``.  Returns f32
    (θ_new, c_new) = (Wθ + η_s·WΔ, c + s·(Δ − WΔ)).
    """
    gd = gossip_torch_dtype(gossip_dtype)
    idx = neighbor_idx.long()
    nwg = narrow(neighbor_w, gd)
    swg = narrow(self_w, gd)

    def spmv(x):
        xg = narrow(x, gd)
        return swg[:, None] * xg + torch.einsum("nm,nmd->nd", nwg, xg[idx])

    d32 = delta.to(torch.float32)
    wd = spmv(delta)
    theta_new = spmv(theta) + float(eta_s) * wd
    c_new = c.to(torch.float32) + float(corr_scale) * (d32 - wd)
    return theta_new, c_new


def local_steps_ref(z0, c, ef, g, h_steps, step, mask, *, compress=None):
    """The local half of the whole round: K affine SGDA steps, then the
    transmitted value.  Returns (q, ef_new, delta)."""
    z0 = z0.to(torch.float32)
    c32 = c.to(torch.float32)
    z = z0
    for k in range(h_steps.shape[0]):
        grad = torch.bmm(g, z.unsqueeze(-1)).squeeze(-1)
        z = z - step * (grad + h_steps[k] + c32)
    delta = z - z0
    ef32 = ef.to(torch.float32)
    if compress is None:
        return delta, ef32, delta
    v = mask * (delta + ef32)
    q = quantize_dequant(v, compress)
    return q, torch.where(mask > 0, v - q, ef32), delta


def fused_round_ref(w, z0, c, ef, g, h_steps, step, etas, corr, mask, *,
                    compress=None, gossip_dtype=None):
    """Whole Algorithm-1 round over the packed z = (x; y).

    w: (n, n); z0/c/ef/step/etas/corr/mask: (n, dz) f32; g: (n, dz, dz);
    h_steps: (K, n, dz).  Returns (z_new, c_new, ef_new):

        repeat K:  z ← z − step ⊙ (G z + h_k + c)
        Δ = z_K − z₀;  q = Δ, or v = mask ⊙ (Δ + e), q = Q(v), e' = v − q
        z' = W z₀ + η_s ⊙ W q;   c' = c + corr ⊙ (q − W q)
    """
    q, e_new, _ = local_steps_ref(z0, c, ef, g, h_steps, step, mask,
                                  compress=compress)
    gd = gossip_torch_dtype(gossip_dtype)
    wg = narrow(w, gd)
    wq = wg @ narrow(q, gd)
    wz = wg @ narrow(z0, gd)
    return wz + etas * wq, c.to(torch.float32) + corr * (q - wq), e_new


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  q_block: int = 1024):
    """Causal / sliding-window GQA attention, f32 softmax.

    q: (B, Sq, H, D); k, v: (B, Sk, KV, D) — the model layout, where the
    reference's ``attention_ref`` takes (B·H, S, D).  Query i sees key j iff
    ``j < Sk`` and (not causal or ``j <= i``) and (window ≤ 0 or
    ``i - j < window``); query head h reads KV head h // (H // KV), grouped
    without repeating k and v.  A row that sees no key is 0 (the kernels'
    rule).  Queries go ``q_block`` at a time against only the keys their
    masks can reach, so the scores never exceed (B, H, q_block, keys).
    Returns (B, Sq, H, D) in q's dtype.
    """
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = d ** -0.5
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    out = torch.zeros_like(q)
    for q0 in range(0, sq, q_block):
        q1 = min(q0 + q_block, sq)
        lo = max(0, q0 - window + 1) if window > 0 else 0
        hi = min(sk, q1) if causal else sk
        if hi <= lo:
            continue
        qi = torch.arange(q0, q1, device=q.device)[:, None]
        kj = torch.arange(lo, hi, device=q.device)[None, :]
        mask = torch.ones((q1 - q0, hi - lo), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kj <= qi
        if window > 0:
            mask &= kj > qi - window
        qg = q[:, q0:q1].to(torch.float32).reshape(b, q1 - q0, kv, g, d)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf[:, lo:hi]) * scale
        s = s.masked_fill(~mask, NEG_INF)
        p = torch.softmax(s, dim=-1) * mask
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf[:, lo:hi])
        out[:, q0:q1] = o.reshape(b, q1 - q0, h, d).to(q.dtype)
    return out


def rglru_ref(a, u, h0=None):
    """Step-by-step h_t = a_t·h_{t−1} + u_t over (B, S, W), in f32.

    ``h0`` (B, W) is the state before step 0 (zeros when None).  Each step
    rounds the product and the sum separately, the order the CUDA kernel
    keeps.  Returns h (B, S, W) f32.
    """
    b, s, w = a.shape
    a32, u32 = a.to(torch.float32), u.to(torch.float32)
    h = (torch.zeros((b, w), dtype=torch.float32, device=a.device)
         if h0 is None else h0.to(torch.float32))
    out = torch.empty((b, s, w), dtype=torch.float32, device=a.device)
    for t in range(s):
        torch.add(a32[:, t] * h, u32[:, t], out=out[:, t])
        h = out[:, t]
    return out
