"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``:
the round kernels of ``:63-165``, ``attention_ref`` of ``:12-31``,
``ssd_ref`` of ``:33``, ``fused_ce_ref`` of ``:56`` and ``rglru_ref`` of
``:196-208``), and ``ssd_chunked``, the chunked SSD scan of
``repro.models.ssm`` (:50) that kernel B7 computes; and the gradients of
the four model kernels in plain ops (``attention_bwd_ref``,
``fused_ce_bwd_ref``, ``ssd_bwd_ref``, ``rglru_bwd_ref``), the backward
passes of kernels B5, B6, B7 and B8 (B8's also a kernel, whose algebra
``rglru_bwd_scan`` writes out, as ``rglru_chunked`` writes out B8's
chunked route's and ``ssd_segmented`` B7's segments').

They are what the wrappers run on CPU tensors, and what ``chip_smoke.py``
holds the CUDA kernels against on the card.  Dtype rules follow the
reference: the W-contraction operands are narrowed to ``gossip_dtype``, the
products accumulate in f32, and Δ (or q) stays f32 inside the correction;
attention, the scans and the cross-entropy compute in f32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

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
                     gossip_dtype=None, row0: int = 0):
    """Packed round epilogue for one variable (Algorithm 1 lines 7–11).

    w: (n_out, n), rows [row0, row0 + n_out) of W; delta/theta: (n, D);
    c: (n_out, D).  Returns f32 (θ_new, c_new) = (Wθ + η_s·WΔ,
    c + s·(Δ_own − WΔ)), each (n_out, D), Δ_own = Δ[row0 : row0 + n_out];
    n_out = n, row0 = 0 is the epilogue of all of W.
    """
    gd = gossip_torch_dtype(gossip_dtype)
    wg = narrow(w, gd)
    d32 = delta[row0:row0 + w.shape[0]].to(torch.float32)
    wd = wg @ narrow(delta, gd)
    wt = wg @ narrow(theta, gd)
    theta_new = wt + float(eta_s) * wd
    c_new = c.to(torch.float32) + float(corr_scale) * (d32 - wd)
    return theta_new, c_new


def sparse_gossip_ref(neighbor_idx, neighbor_w, self_w, delta, theta, c,
                      eta_s, corr_scale, *, gossip_dtype=None):
    """The same epilogue as :func:`fused_gossip_ref` with W in padded-CSR
    form.

    neighbor_idx: (n, m) int (padding = own index) into the n_src ≥ n
    source rows of delta/theta (n_src, D), out row i's self term reading
    source row i; neighbor_w: (n, m) with padding weight 0; self_w: (n,)
    diagonal; c: (n, D).  Raw tensors, not a ``SparseTopology``, so the
    kernels package needs nothing of ``core``.  Returns f32
    (θ_new, c_new) = (Wθ + η_s·WΔ, c + s·(Δ − WΔ)), each (n, D).
    """
    gd = gossip_torch_dtype(gossip_dtype)
    idx = neighbor_idx.long()
    n = idx.shape[0]
    nwg = narrow(neighbor_w, gd)
    swg = narrow(self_w, gd)

    def spmv(x):
        xg = narrow(x, gd)
        return (swg[:, None] * xg[:n]
                + torch.einsum("nm,nmd->nd", nwg, xg[idx]))

    d32 = delta[:n].to(torch.float32)
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


def robust_agg_ref(vals, valid, *, rule, trim: int = 1):
    """Robust-aggregation oracle (coordinate median / b-trimmed mean over
    each row's valid slots), the ground truth ``mixing.robust_mix_dense``
    and ``robust_mix_sparse`` are tested against (port of
    ``repro.kernels.ref.robust_agg_ref``).

    vals: (n, m, D); valid: (n, m) bool with ≥ 1 valid slot per row.
    Non-finite values are invalid per coordinate.  Deliberately another
    float path than the implementations: the median goes through
    ``torch.nanmedian`` (which takes the lower middle value, so the two
    middle values are averaged here), and the trimmed mean sorts
    descending, so the surviving values sum in the reverse order.
    """
    v32 = vals.to(torch.float32)
    ok = valid.to(torch.bool)[:, :, None] & torch.isfinite(v32)
    k = ok.sum(1, dtype=torch.int64)                          # (n, D)
    if rule == "coord_median":
        lo = torch.nanmedian(torch.where(ok, v32, float("nan")),
                             dim=1).values
        # the upper middle value, from the descending sort (lo when k is
        # odd)
        desc = torch.sort(torch.where(ok, v32, -torch.inf), dim=1,
                          descending=True).values
        hi = torch.take_along_dim(desc, ((k - 1) // 2)[:, None, :],
                                  dim=1)[:, 0, :]
        return 0.5 * (lo + hi)
    if rule != "trimmed_mean":
        raise ValueError(f"unknown robust rule {rule!r}")
    m = vals.shape[1]
    b = torch.clamp((k - 1) // 2, max=int(trim))
    # invalid -> -inf, descending: valid values first, largest first
    desc = torch.sort(torch.where(ok, v32, -torch.inf), dim=1,
                      descending=True).values
    rank = torch.arange(m, device=v32.device)[None, :, None]
    keep = (rank >= b[:, None, :]) & (rank < (k - b)[:, None, :])
    total = torch.sum(torch.where(keep, desc, 0.0), dim=1)
    return total / (k - 2 * b).to(torch.float32)


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


def _attention_mask(sq: int, sk: int, causal: bool, window: int, device):
    qi = torch.arange(sq, device=device)[:, None]
    kj = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kj <= qi)
    if window > 0:
        mask = mask & (kj > qi - window)
    return mask


def attention_bwd_ref(q, k, v, grad_out, *, causal: bool = True,
                      window: int = 0):
    """The gradient of :func:`attention_ref` in closed form, in plain ops
    (the backward of kernel B5, ``FlashAttentionFn``; every op has a vmap
    rule): the f32 probabilities P recomputed from q, k, v, then
    dV = Pᵀ·dO, dP = dO·Vᵀ, dS = P ⊙ (dP − rowsum(P ⊙ dP)),
    dQ = dS·K·scale, dK = dSᵀ·Q·scale, the query heads of a group summed
    into their KV head.  Returns (dq, dk, dv) in the operands' dtypes."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = d ** -0.5
    mask = _attention_mask(sq, sk, causal, window, q.device)
    qf = q.to(torch.float32).reshape(b, sq, kv, g, d)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1) * mask
    do = grad_out.to(torch.float32).reshape(b, sq, kv, g, d)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do, vf)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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
    hs = []
    for t in range(s):
        h = a32[:, t] * h + u32[:, t]
        hs.append(h)
    return (torch.stack(hs, dim=1) if hs
            else torch.zeros((b, 0, w), dtype=torch.float32, device=a.device))


def rglru_bwd_ref(a, h, grad_h):
    """The gradient of :func:`rglru_ref` (from h_{−1} = 0) in plain ops, the
    backward of kernel B8 (``RglruScanFn``; every op has a vmap rule): the
    same recurrence run backward in time, g_t = dh_t + a_{t+1}·g_{t+1},
    then du_t = g_t and da_t = g_t·h_{t−1} (h_{−1} = 0), in f32.  ``h`` is
    the forward's output.  Returns (da, du) f32 (B, S, W)."""
    b, s, w = a.shape
    a32, h32 = a.to(torch.float32), h.to(torch.float32)
    dh = grad_h.to(torch.float32)
    if s == 0:
        empty = torch.zeros((b, 0, w), dtype=torch.float32, device=a.device)
        return empty, empty
    gs = [dh[:, s - 1]]
    for t in range(s - 2, -1, -1):
        gs.append(dh[:, t] + a32[:, t + 1] * gs[-1])
    du = torch.stack(gs[::-1], dim=1)
    h_prev = torch.cat([torch.zeros_like(h32[:, :1]), h32[:, :-1]], dim=1)
    return du * h_prev, du


def rglru_chunked(a, u, chunk: int, *, runs: int = 8):
    """The arithmetic of B8's chunked route, in plain PyTorch (held against
    ``rglru_ref`` and the reference by the tests; no path runs it).

    S is cut into chunks of ``chunk`` steps (the last one ragged), each
    chunk into ``runs`` runs of ``chunk // runs`` steps (a block's warps).
    Each run is scanned from zero, keeping the prefix products P_t; the
    runs' maps (Π a, h_end) compose into each run's carry-in map (ea, eh)
    and the chunk's aggregate (A_c, H_c); the carry into chunk c is the
    inclusive state of chunk c − 1, H_{c−1} + A_{c−1}·carry_{c−1} (the
    kernel's look-back composes the same maps, maybe in another order);
    then h_t = h_local_t + P_t·(eh + ea·carry).  Returns f32 h (B, S, W)."""
    b, s, w = a.shape
    if chunk % runs:
        raise ValueError(f"chunk {chunk} is not {runs} runs of whole steps")
    if s == 0:
        return torch.zeros((b, 0, w), dtype=torch.float32, device=a.device)
    k = chunk // runs
    nc = -(-s // chunk)
    pad = nc * chunk - s
    a32 = F.pad(a.to(torch.float32), (0, 0, 0, pad), value=1.0)
    u32 = F.pad(u.to(torch.float32), (0, 0, 0, pad))
    a5 = a32.reshape(b, nc, runs, k, w)
    u5 = u32.reshape(b, nc, runs, k, w)
    hl, p = [], []
    hv = torch.zeros_like(a5[:, :, :, 0])
    pv = torch.ones_like(hv)
    for i in range(k):
        hv = a5[:, :, :, i] * hv + u5[:, :, :, i]
        pv = pv * a5[:, :, :, i]
        hl.append(hv)
        p.append(pv)
    hl, p = torch.stack(hl, dim=3), torch.stack(p, dim=3)
    ta, th = torch.ones_like(hv[:, :, 0]), torch.zeros_like(hv[:, :, 0])
    ea, eh = [], []
    for r in range(runs):
        ea.append(ta)
        eh.append(th)
        th = pv[:, :, r] * th + hv[:, :, r]
        ta = ta * pv[:, :, r]
    ea, eh = torch.stack(ea, dim=2), torch.stack(eh, dim=2)
    carry = torch.zeros_like(th[:, 0])
    carries = []
    for c in range(nc):
        carries.append(carry)
        carry = th[:, c] + ta[:, c] * carry
    carries = torch.stack(carries, dim=1)[:, :, None]      # (B, nc, 1, W)
    cin = eh + ea * carries
    h = hl + p * cin[:, :, :, None]
    return h.reshape(b, nc * chunk, w)[:, :s]


def rglru_bwd_scan(a, h, grad_h, chunk: int = 64):
    """The gradient of :func:`rglru_ref` as B8's backward kernel computes
    it: the chunked scan (:func:`rglru_chunked`) in reverse time — logical
    step t' is step S − 1 − t', with a read one step ahead (a_{t+1}, the
    identity past the end) — gives g_t = dh_t + a_{t+1}·g_{t+1}; then
    du_t = g_t and da_t = g_t·h_{t−1} (h_{−1} = 0).  Returns (da, du) f32
    (B, S, W)."""
    a32, h32 = a.to(torch.float32), h.to(torch.float32)
    a_next = torch.cat([a32[:, 1:], torch.ones_like(a32[:, :1])], dim=1)
    du = rglru_chunked(a_next.flip(1), grad_h.to(torch.float32).flip(1),
                       chunk).flip(1)
    h_prev = torch.cat([torch.zeros_like(h32[:, :1]), h32[:, :-1]], dim=1)
    return du * h_prev, du


def ssd_ref(xdt, loga, bm, cm, state0=None):
    """Token-by-token SSD recurrence, the oracle of the chunked scan:

        S_t = exp(loga_t)·S_{t−1} + xdt_t ⊗ B_t,    y_t = S_t · C_t

    on the model layout — xdt (B, S, H, P), loga (B, S, H), bm and cm
    (B, S, N), one group shared by the heads — where the reference's
    ``ssd_ref`` takes (B·H, S, P).  ``state0`` (B, H, P, N) is the state
    before step 0 (zeros when None).  Returns f32 (y, final_state)."""
    b, s, h, p = xdt.shape
    n = bm.shape[-1]
    x32, la32 = xdt.to(torch.float32), loga.to(torch.float32)
    b32, c32 = bm.to(torch.float32), cm.to(torch.float32)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=xdt.device)
             if state0 is None else state0.to(torch.float32))
    ys = []
    for t in range(s):
        state = (torch.exp(la32[:, t])[..., None, None] * state
                 + torch.einsum("bhp,bn->bhpn", x32[:, t], b32[:, t]))
        ys.append(torch.einsum("bn,bhpn->bhp", c32[:, t], state))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((b, 0, h, p), dtype=torch.float32, device=xdt.device))
    return y, state


def ssd_chunked(xdt, loga, bm, cm, chunk: int, state0=None):
    """Chunk-parallel SSD scan (``repro.models.ssm.ssd_chunked``): the
    plain version of kernel B7.

    xdt (B, S, H, P) inputs pre-multiplied by dt; loga (B, S, H) log decay
    per token and head; bm, cm (B, S, N) input / output projections (one
    group); state0 (B, H, P, N) or None.  A ragged S is padded to whole
    chunks with zeros, as the reference does.  The decay of the upper
    triangle (u > t) is masked before the exp, where the reference takes
    exp(+large) and drops it with ``where``: the same values, and no inf to
    meet a gradient.  Returns f32 (y (B, S, H, P), final_state
    (B, H, P, N)).
    """
    b, s, h, p = xdt.shape
    n = bm.shape[-1]
    l = max(1, min(chunk, s))
    nc = -(-s // l)
    pad = nc * l - s
    x32, la32 = xdt.to(torch.float32), loga.to(torch.float32)
    b32, c32 = bm.to(torch.float32), cm.to(torch.float32)
    if pad:
        x32 = F.pad(x32, (0, 0, 0, 0, 0, pad))
        la32 = F.pad(la32, (0, 0, 0, pad))
        b32 = F.pad(b32, (0, 0, 0, pad))
        c32 = F.pad(c32, (0, 0, 0, pad))
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=xdt.device)
             if state0 is None else state0.to(torch.float32))
    upper = ~torch.tril(torch.ones((l, l), dtype=torch.bool,
                                   device=xdt.device))[None, :, :, None]
    ys = []
    for c in range(nc):
        sl = slice(c * l, (c + 1) * l)
        xc, lac, bc, cc = x32[:, sl], la32[:, sl], b32[:, sl], c32[:, sl]
        cum = torch.cumsum(lac, dim=1)                       # (B, l, H)
        rel = cum[:, :, None, :] - cum[:, None, :, :]        # (B, t, u, H)
        decay = torch.exp(rel.masked_fill(upper, float("-inf")))
        cb = torch.einsum("btn,bun->btu", cc, bc)
        y_intra = torch.einsum("btuh,buhp->bthp", decay * cb[..., None], xc)
        y_inter = (torch.einsum("btn,bhpn->bthp", cc, state)
                   * torch.exp(cum)[..., None])
        last = cum[:, -1]                                    # (B, H)
        dec_end = torch.exp(last[:, None, :] - cum)          # (B, l, H)
        s_chunk = torch.einsum("blhp,bln->bhpn", xc * dec_end[..., None], bc)
        state = torch.exp(last)[..., None, None] * state + s_chunk
        ys.append(y_intra + y_inter)
    y = (torch.cat(ys, dim=1)[:, :s] if ys
         else torch.zeros((b, 0, h, p), dtype=torch.float32, device=xdt.device))
    return y, state


def ssd_bwd_ref(xdt, loga, bm, cm, chunk: int, state0, grad_y, grad_state):
    """The gradient of :func:`ssd_chunked` (the backward of kernel B7,
    ``SsdScanFn``): ``torch.func.vjp`` of the plain chunked scan recomputed
    from the f32 inputs, so it composes with the ``grad`` and ``vmap``
    transforms the backward runs under.  Returns (dxdt, dloga, dbm, dcm,
    dstate0 — None when ``state0`` is None)."""
    if state0 is None:
        _, vjp = torch.func.vjp(lambda *ops: ssd_chunked(*ops, chunk),
                                xdt, loga, bm, cm)
        return (*vjp((grad_y, grad_state)), None)
    _, vjp = torch.func.vjp(
        lambda *ops: ssd_chunked(*ops[:4], chunk, ops[4]),
        xdt, loga, bm, cm, state0)
    return vjp((grad_y, grad_state))


def ssd_segment_bounds(s: int, chunk: int, segments: int):
    """[(first, end) token of each run]: ⌈chunks/segments⌉ whole chunks a
    run (the last one ragged), none empty."""
    length = max(1, min(chunk, s))
    nc = -(-s // length)
    per = -(-max(nc, 1) // max(1, min(nc, segments)))
    return [(a, min(a + per * length, s))
            for a in range(0, max(s, 1), per * length)]


def ssd_segmented(xdt, loga, bm, cm, chunk: int, state0=None, *,
                  segments: int = 1):
    """The segment algebra of B7's tensor-core route, in plain PyTorch
    (held against ``ssd_chunked`` by the tests; no path runs it).

    The chunks are cut into ``segments`` runs of whole chunks
    (:func:`ssd_segment_bounds`, the cut of ``ssd_scan.segments``).
    Pass 1: each run but the last from a zero state — its end state S_end
    and its summed log decay D.  Pass 2: run k from S_in = state0 folded
    through the earlier runs, S_in ← exp(D_j)·S_in + S_end_j.  Each run is
    ``ssd_chunked`` of its tokens (C·Bᵀ once per batch row and chunk, as
    there).  Returns f32 (y (B, S, H, P), final_state (B, H, P, N))."""
    b, s, h, p = xdt.shape
    n = bm.shape[-1]
    bounds = ssd_segment_bounds(s, chunk, segments)
    s_in = (torch.zeros((b, h, p, n), dtype=torch.float32, device=xdt.device)
            if state0 is None else state0.to(torch.float32))
    ys = []
    for k, (a, e) in enumerate(bounds):
        part = (xdt[:, a:e], loga[:, a:e], bm[:, a:e], cm[:, a:e])
        y, fin = ssd_chunked(*part, chunk, s_in)
        ys.append(y)
        if k + 1 < len(bounds):
            _, s_end = ssd_chunked(*part, chunk)
            decay = loga[:, a:e].to(torch.float32).sum(1)         # (B, H)
            s_in = torch.exp(decay)[..., None, None] * s_in + s_end
        else:
            s_in = fin
    return torch.cat(ys, dim=1), s_in


def fused_ce_ref(hidden, weight, labels, *, chunk: int = 1024):
    """Per-token NLL of hidden (N, d) against a head weight addressed as
    (V, d) — the tied embedding, or an untied (d, V) head's transposed
    view: f32 logits = hidden·weightᵀ from the operands cast to f32, then
    −log_softmax at the label.  Tokens go ``chunk`` at a time, so the
    (N, V) logits are never all resident.  Returns f32 (N,)."""
    w32 = weight.to(torch.float32)
    out = [-torch.log_softmax(hidden[i:i + chunk].to(torch.float32) @ w32.T,
                              dim=-1)
           .gather(1, labels[i:i + chunk, None].long())[:, 0]
           for i in range(0, hidden.shape[0], chunk)]
    return (torch.cat(out) if out
            else torch.zeros((0,), dtype=torch.float32, device=hidden.device))


def fused_ce_bwd_ref(hidden, weight, labels, grad_nll, *, chunk: int = 512):
    """The gradient of :func:`fused_ce_ref` in plain ops (the backward of
    kernel B6, ``FusedCrossEntropyFn``; every op has a vmap rule): per
    chunk of ``chunk`` tokens, the f32 logits recomputed from the operands
    cast to f32, dL = (softmax − onehot(label))·grad_nll, then
    g_hidden = dL·W and g_W += dLᵀ·hidden, so the (N, V) logits are never
    all resident.  Returns (g_hidden, g_weight) in the operands' dtypes."""
    w32 = weight.to(torch.float32)
    gw = torch.zeros_like(w32)
    ghs = []
    for i in range(0, hidden.shape[0], chunk):
        h32 = hidden[i:i + chunk].to(torch.float32)
        p = torch.softmax(h32 @ w32.T, dim=-1)
        lab = labels[i:i + chunk, None].long()
        dl = p.scatter_add(1, lab, -torch.ones_like(lab, dtype=p.dtype))
        dl = dl * grad_nll[i:i + chunk, None].to(torch.float32)
        ghs.append(dl @ w32)
        gw = gw + dl.T @ h32
    gh = (torch.cat(ghs) if ghs
          else torch.zeros_like(hidden, dtype=torch.float32))
    return gh.to(hidden.dtype), gw.to(weight.dtype)


def ce_partials_logits(logits, labels):
    """The vocab-parallel partials of f32 ``logits`` (N, V_r) of one
    vocabulary piece, labels (N,) offset by the piece's first id: (m, l,
    z) per token, m the max logit (taken without a gradient), l = Σ_v
    e^(logit_v − m), z the label's logit, 0 where the label falls outside
    [0, V_r).  The NLL over the pieces r is M + log Σ_r l_r e^(m_r − M) −
    Σ_r z_r, M = max_r m_r."""
    v = logits.shape[-1]
    m = logits.detach().amax(-1)
    l = torch.exp(logits - m[..., None]).sum(-1)
    lab = labels.long()
    inside = (lab >= 0) & (lab < v)
    z = logits.gather(-1, torch.clamp(lab, 0, v - 1)[..., None])[..., 0]
    return m, l, torch.where(inside, z, torch.zeros_like(z))


def ce_partials_ref(hidden, weight, labels, *, chunk: int = 1024):
    """The plain version of kernel B6's vocab-parallel form: hidden (N, d)
    against one rank's piece of the head, addressed as (V_r, d), labels
    (N,) offset by the piece's first id; f32 logits from the operands
    cast to f32, ``chunk`` tokens at a time, then
    :func:`ce_partials_logits`.  Returns f32 (m, l, z), each (N,)."""
    w32 = weight.to(torch.float32)
    parts = [ce_partials_logits(hidden[i:i + chunk].to(torch.float32)
                                @ w32.T, labels[i:i + chunk])
             for i in range(0, hidden.shape[0], chunk)]
    if not parts:
        empty = torch.zeros((0,), dtype=torch.float32, device=hidden.device)
        return empty, empty, empty
    return tuple(torch.cat(p) for p in zip(*parts))


def merge_nll(big_m, big_l, big_z):
    """The NLL of the merged partials: M + log L − Z."""
    return big_m + torch.log(big_l) - big_z


def vocab_ce_bwd_ref(hidden, weight, labels, lse, grad_nll, *,
                     chunk: int = 512):
    """The gradient of the vocab-parallel NLL on one rank's piece (the
    backward of ``VocabParallelCEFn``; every op has a vmap rule): per
    chunk of ``chunk`` tokens, the piece's f32 logits recomputed from the
    operands cast to f32, dL = (e^(logit − lse) − onehot(label))·grad_nll
    with the global log-sum-exp ``lse`` (N,) and the onehot only where the
    label falls in the piece, then g_hidden = dL·W (this piece's part of
    it: the model axis sums the parts) and g_W = dLᵀ·hidden.  Returns
    (g_hidden, g_weight) in the operands' dtypes."""
    w32 = weight.to(torch.float32)
    v = w32.shape[0]
    gw = torch.zeros_like(w32)
    ghs = []
    for i in range(0, hidden.shape[0], chunk):
        h32 = hidden[i:i + chunk].to(torch.float32)
        p = torch.exp(h32 @ w32.T - lse[i:i + chunk, None])
        lab = labels[i:i + chunk, None].long()
        inside = ((lab >= 0) & (lab < v)).to(p.dtype)
        dl = p.scatter_add(1, torch.clamp(lab, 0, v - 1), -inside)
        dl = dl * grad_nll[i:i + chunk, None].to(torch.float32)
        ghs.append(dl @ w32)
        gw = gw + dl.T @ h32
    gh = (torch.cat(ghs) if ghs
          else torch.zeros_like(hidden, dtype=torch.float32))
    return gh.to(hidden.dtype), gw.to(weight.dtype)
