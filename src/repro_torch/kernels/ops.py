"""Dispatch between the CUDA kernels and their plain PyTorch versions.

Counterparts of ``repro.kernels.ops.fused_gossip_round`` (:171),
``fused_round`` (:202), ``sparse_gossip_round`` (:253), ``flash_attention``
(:37), ``ssd_scan`` (:60), ``fused_cross_entropy`` (:78) and
``rglru_scan`` (:302): the packed gossip epilogue (``csrc/gossip.cu``), the
whole round (``csrc/fused_round.cu``), the neighbor-gather epilogue
(``csrc/neighbor_gossip.cu``), causal / windowed GQA attention
(``csrc/flash_attention.cu``), the Mamba2 SSD scan (``csrc/ssd_scan.cu``),
the fused cross-entropy (``csrc/cross_entropy.cu``; its vocab-parallel
form ``vocab_parallel_cross_entropy``) and the RG-LRU
recurrence (``csrc/rglru_scan.cu``); ``fused_gossip_pair`` and
``sparse_gossip_pair`` run the two epilogues of a round (x and y) in one
launch.  ``backend``:

* ``"auto"`` — the CUDA kernel for CUDA tensors, the plain version for CPU
  tensors;
* ``"kernel"`` — the CUDA kernel (a CPU tensor raises);
* ``"torch"`` — the plain version (a CUDA tensor raises: on the card the
  kernel runs, and ``chip_smoke.py`` calls the plain version directly).

There is no fallback between the two: a kernel that fails to build or
launch raises.  No padding either: the kernels mask their ragged edges.
The four model kernels (attention, the two scans, the cross-entropy) are
differentiable on the kernel route: autograd Functions whose backward is
the plain version's gradient (the RG-LRU scan's: a backward kernel), with
``torch.func.vmap`` rules.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import cross_entropy as ce_lib
from repro_torch.kernels import flash_attention as fa_lib
from repro_torch.kernels import fused_round as fround_lib
from repro_torch.kernels import gossip as gossip_lib
from repro_torch.kernels import neighbor_gossip as ngossip_lib
from repro_torch.kernels import ref as ref_lib
from repro_torch.kernels import rglru_scan as rg_lib
from repro_torch.kernels import ssd_scan as ssd_lib

GOSSIP_BACKENDS = ("auto", "kernel", "torch")

# each kernel's wrapper, whose ``launches`` attribute counts its launches
KERNELS = {
    "fused_gossip": gossip_lib.fused_gossip_nd,
    "fused_round": fround_lib.fused_round_nd,
    "sparse_gossip": ngossip_lib.sparse_gossip_nd,
    "flash_attention": fa_lib.flash_attention_bshd,
    "rglru_scan": rg_lib.rglru_scan_bsw,
    "ssd_scan": ssd_lib.ssd_scan_bshp,
    "fused_cross_entropy": ce_lib.fused_ce_nd,
    "ce_partials": ce_lib.fused_ce_partials_nd,
}


# the wrappers with two routes, whose ``routes`` attribute counts their
# launches by route, each with the route its rule gives every shape the
# main paths run (the other is the first port's kernel)
ROUTED = {"flash_attention": "tensor_core",
          "fused_cross_entropy": "tensor_core",
          "ce_partials": "tensor_core",
          "ssd_scan": "tensor_core",
          "rglru_scan": "chunked",
          "fused_round": "cluster",
          "fused_gossip": "unrolled",
          "sparse_gossip": "stripe"}

# the wrappers whose backward is a kernel too, counted in their
# ``backward_launches`` attribute (B8: the chunked kernel in reverse time)
BACKWARD = ("rglru_scan",)


# a wrapper's counts by route: ``routes`` (every launch), ``compressed``
# (B2's launches with compress)
_BY_ROUTE = ("routes", "compressed")


def launch_counts() -> dict:
    """Launches of each CUDA kernel so far in this process."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def route_counts() -> dict:
    """Launches of each two-route kernel so far, by route."""
    return {name: dict(KERNELS[name].routes) for name in ROUTED}


def backward_launch_counts() -> dict:
    """Launches of each backward kernel so far in this process."""
    return {name: KERNELS[name].backward_launches for name in BACKWARD}


def compressed_route_counts() -> dict:
    """Launches of the whole-round kernel (B2) with ``compress`` (its EF
    quantizer, B3, inside), by route."""
    return {"fused_round": dict(KERNELS["fused_round"].compressed)}


def zero_launch_counts() -> None:
    """Sets every launch count, every count by route and every backward
    launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0
        for attr in _BY_ROUTE:
            if hasattr(fn, attr):
                setattr(fn, attr, dict.fromkeys(getattr(fn, attr), 0))
    for name in BACKWARD:
        KERNELS[name].backward_launches = 0


def add_launch_counts(delta: dict) -> None:
    """Adds ``delta`` (as :func:`uncounted` yields it) to the counts: what
    a CUDA graph replay launches, the launches its capture recorded."""
    for name, (launches, *rest) in delta.items():
        fn = KERNELS[name]
        fn.launches += launches
        for attr, counts in zip(_BY_ROUTE, rest):
            for route, k in counts.items():
                getattr(fn, attr)[route] += k
        if name in BACKWARD:
            fn.backward_launches += rest[len(_BY_ROUTE)]


def _count_snapshot() -> dict:
    """Each wrapper's (launches, *counts by route[, backward launches])."""
    return {name: (fn.launches, *(dict(getattr(fn, attr, {}))
                                  for attr in _BY_ROUTE),
                   *((fn.backward_launches,) if name in BACKWARD else ()))
            for name, fn in KERNELS.items()}


@contextlib.contextmanager
def uncounted():
    """Launches inside the block do not count: on exit every count is what
    it was on entry.  Yields a dict that then holds what they would have
    added, ``{kernel: (launches, {route: launches}, {route: compressed
    launches}[, backward launches])}`` (the last for the kernels of
    :data:`BACKWARD`), for :func:`add_launch_counts` (a CUDA graph's
    warm-up and capture run the wrappers, but only a replay launches)."""
    before = _count_snapshot()
    delta: dict = {}
    try:
        yield delta
    finally:
        after = _count_snapshot()
        nr = len(_BY_ROUTE)
        for name, (launches, *rest) in after.items():
            b_launches, *b_rest = before[name]
            by_route, b_by_route = rest[:nr], b_rest[:nr]
            if launches != b_launches or rest[nr:] != b_rest[nr:]:
                delta[name] = (launches - b_launches, *(
                    {r: k - b.get(r, 0) for r, k in counts.items()}
                    for counts, b in zip(by_route, b_by_route)), *(
                        k - b for k, b in zip(rest[nr:], b_rest[nr:])))
            fn = KERNELS[name]
            fn.launches = b_launches
            for attr, b in zip(_BY_ROUTE, b_by_route):
                if hasattr(fn, attr):
                    setattr(fn, attr, dict(b))
            if name in BACKWARD:
                fn.backward_launches = b_rest[nr]


def use_kernel(backend: str, x: torch.Tensor) -> bool:
    """Whether ``backend`` runs the CUDA kernel on tensors like ``x``."""
    if backend not in GOSSIP_BACKENDS:
        raise ValueError(
            f"unknown gossip_backend {backend!r}: {GOSSIP_BACKENDS}")
    if backend == "kernel" and not x.is_cuda:
        raise ValueError("gossip_backend='kernel' needs CUDA tensors; "
                         f"got a tensor on {x.device}")
    if backend == "torch" and x.is_cuda:
        raise ValueError("gossip_backend='torch' is the plain version for "
                         "CPU tensors; on CUDA tensors the kernel runs")
    return x.is_cuda


def _f32c(x):
    return x.to(torch.float32).contiguous()


def _f32(x):
    """f32, keeping the strides where the last dimension is contiguous."""
    x = x.to(torch.float32)
    return x if x.stride(-1) == 1 or x.shape[-1] == 1 else x.contiguous()


def fused_gossip_round(w, delta, theta, c, eta_s, corr_scale, *,
                       backend: str = "auto", gossip_dtype=None):
    """Fused round epilogue over packed client state.

    w: (n, n); delta/theta/c: (n, D).  Returns f32
    (θ_new, c_new) = (Wθ + η_s·WΔ, c + corr_scale·(Δ − WΔ)).
    """
    if use_kernel(backend, delta):
        return gossip_lib.fused_gossip_nd(
            _f32c(w), _f32c(delta), _f32c(theta), _f32c(c), eta_s,
            corr_scale, gossip_dtype=gossip_dtype)
    return ref_lib.fused_gossip_ref(w, delta, theta, c, eta_s, corr_scale,
                                    gossip_dtype=gossip_dtype)


def fused_gossip_pair(w, x, y, *, backend: str = "auto", gossip_dtype=None,
                      row0: int = 0):
    """:func:`fused_gossip_round` of both variables of a round, sharing W.

    x, y: (delta, theta, c, eta_s, corr_scale) with delta/theta/c (n, Dx)
    and (n, Dy).  Returns f32 (θx', cx', θy', cy').  On the card one kernel
    launch (the unrolled route; the tiled route launches once a variable);
    on the CPU the plain version twice, exactly as two single calls.  A row
    block: w (n_out, n) rows [row0, row0 + n_out) of W, c (n_out, D), the
    outputs (n_out, D) (``ref.fused_gossip_ref``'s ``row0``).
    """
    if use_kernel(backend, x[0]):
        return gossip_lib.fused_gossip_pair_nd(
            _f32c(w), _f32c_var(x), _f32c_var(y), gossip_dtype=gossip_dtype,
            row0=row0)
    return (*ref_lib.fused_gossip_ref(w, *x, gossip_dtype=gossip_dtype,
                                      row0=row0),
            *ref_lib.fused_gossip_ref(w, *y, gossip_dtype=gossip_dtype,
                                      row0=row0))


def _f32c_var(v):
    """(delta, theta, c, eta_s, corr) with the tensors contiguous f32."""
    return (*(_f32c(t) for t in v[:3]), *v[3:])


def fused_round(w, z0, c, ef, g_mat, h_steps, step, etas, corr, mask, *,
                backend: str = "auto", compress=None, gossip_dtype=None):
    """Whole Algorithm-1 round (K affine local SGDA steps + gossip epilogue)
    over the packed z = (x; y) state.

    w: (n, n); z0/c/ef: (n, dz); g_mat: (n, dz, dz); h_steps: (K, n, dz);
    step/etas/corr/mask: (n, dz) per-column vectors.  Returns f32
    (z_new, c_new, ef_new).  The kernel takes dz ≤ 1024 (ValueError
    beyond, as in the JAX package).
    """
    if use_kernel(backend, z0):
        return fround_lib.fused_round_nd(
            _f32c(w), _f32c(z0), _f32c(c), _f32c(ef), _f32c(g_mat),
            _f32c(h_steps), _f32c(step), _f32c(etas), _f32c(corr),
            _f32c(mask), compress=compress, gossip_dtype=gossip_dtype)
    return ref_lib.fused_round_ref(w, z0, c, ef, g_mat, h_steps, step, etas,
                                   corr, mask, compress=compress,
                                   gossip_dtype=gossip_dtype)


def sparse_gossip_round(neighbor_idx, neighbor_w, self_w, delta, theta, c,
                        eta_s, corr_scale, *, backend: str = "auto",
                        gossip_dtype=None):
    """Fused round epilogue over packed client state, sparse W.

    neighbor_idx: (n, m) padded-CSR neighbor lists (padding = own index);
    neighbor_w: (n, m) with padding weight 0; self_w: (n,) diagonal;
    delta/theta/c: (n, D).  Returns f32
    (θ_new, c_new) = (Wθ + η_s·WΔ, c + corr_scale·(Δ − WΔ)), the contract
    of :func:`fused_gossip_round` in O(n·m·D).  Raw tensors, not a
    ``SparseTopology``, so the kernels package needs nothing of ``core``.
    """
    if use_kernel(backend, delta):
        return ngossip_lib.sparse_gossip_nd(
            neighbor_idx.to(torch.int32).contiguous(), _f32c(neighbor_w),
            _f32c(self_w), _f32c(delta), _f32c(theta), _f32c(c), eta_s,
            corr_scale, gossip_dtype=gossip_dtype)
    return ref_lib.sparse_gossip_ref(neighbor_idx, neighbor_w, self_w, delta,
                                     theta, c, eta_s, corr_scale,
                                     gossip_dtype=gossip_dtype)


def sparse_gossip_pair(neighbor_idx, neighbor_w, self_w, x, y, *,
                       backend: str = "auto", gossip_dtype=None):
    """:func:`sparse_gossip_round` of both variables of a round, sharing
    the neighbor lists.

    x, y: (delta, theta, c, eta_s, corr_scale) with delta/theta/c (n, Dx)
    and (n, Dy).  Returns f32 (θx', cx', θy', cy').  On the card one kernel
    launch (the stripe route; the row-block route launches once a
    variable); on the CPU the plain version twice, exactly as two single
    calls.  Δ and θ may hold n_src ≥ n source rows that the (n, m) table
    indexes, the out rows' own first (``ref.sparse_gossip_ref``).
    """
    tab = (neighbor_idx, neighbor_w, self_w)
    if use_kernel(backend, x[0]):
        return ngossip_lib.sparse_gossip_pair_nd(
            neighbor_idx.to(torch.int32).contiguous(), _f32c(neighbor_w),
            _f32c(self_w), _f32c_var(x), _f32c_var(y),
            gossip_dtype=gossip_dtype)
    return (*ref_lib.sparse_gossip_ref(*tab, *x, gossip_dtype=gossip_dtype),
            *ref_lib.sparse_gossip_ref(*tab, *y, gossip_dtype=gossip_dtype))


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    backend: str = "auto"):
    """Causal / sliding-window GQA attention on the model layout.

    q: (B, Sq, H, D); k, v: (B, Sk, KV, D) in one dtype (float32 or
    bfloat16 for the kernel).  Returns (B, Sq, H, D) in q's dtype; the
    softmax is f32.  The kernel masks the true key length (the JAX package's
    non-causal path attends to its padding: ROADMAP §C).
    """
    if use_kernel(backend, q):
        return fa_lib.flash_attention_bshd(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=window)
    return ref_lib.attention_ref(q, k, v, causal=causal, window=window)


def rglru_scan(a, u, *, backend: str = "auto"):
    """h_t = a_t·h_{t−1} + u_t over (B, S, W) from h_{−1} = 0; returns f32
    h (B, S, W).  A carried state h0 is folded in by the caller as
    u_0 ← u_0 + a_0·h0.  The kernel takes the route of
    ``rglru_scan.route`` (chunked where S spans two chunks, else the walk)
    and differentiates through the backward kernel."""
    if use_kernel(backend, a):
        return rg_lib.rglru_scan_bsw(_f32c(a), _f32c(u))
    return ref_lib.rglru_ref(a, u)


def ssd_scan(xdt, loga, bm, cm, *, chunk: int, state0=None,
             backend: str = "auto"):
    """The Mamba2 SSD scan (``models.ssm.ssd_chunked``) on the model layout:
    xdt (B, S, H, P), loga (B, S, H), bm and cm (B, S, N), state0
    (B, H, P, N) or None.  Returns f32 (y (B, S, H, P), final_state
    (B, H, P, N)).  The kernel reads the operands through their strides
    and masks a ragged last chunk."""
    if use_kernel(backend, xdt):
        return ssd_lib.ssd_scan_bshp(
            _f32(xdt), _f32(loga), _f32(bm), _f32(cm),
            None if state0 is None else _f32c(state0), chunk=chunk)
    return ref_lib.ssd_chunked(xdt, loga, bm, cm, chunk, state0)


def fused_cross_entropy(hidden, weight, labels, *, backend: str = "auto"):
    """Per-token NLL of hidden (N, d) against the head weight addressed as
    (V, d) (the tied embedding, or an untied (d, V) head's transposed view),
    with f32 logits that are never all resident.  hidden and weight share
    one dtype (float32 or bfloat16 for the kernel).  Returns f32 (N,)."""
    if use_kernel(backend, hidden):
        return ce_lib.fused_ce_nd(hidden, weight, labels)
    return ref_lib.fused_ce_ref(hidden, weight, labels)


def vocab_parallel_cross_entropy(hidden, weight, labels, merge, *,
                                 backend: str = "auto"):
    """Per-token NLL (N,) f32 over a vocabulary split across the model
    ranks, from this rank's piece: hidden (N, d), the piece addressed as
    (V_r, d), labels (N,) offset by the piece's first id, ``merge(m, l,
    z) -> (M, L, Z)`` the merge over the model axis.  On the card kernel
    B6's partials (``cross_entropy.VocabParallelCEFn``), on the CPU
    ``ref.ce_partials_ref`` under autograd, each merged into M + log L −
    Z."""
    if use_kernel(backend, hidden):
        return ce_lib.VocabParallelCEFn.apply(hidden, weight, labels,
                                              merge)[0]
    return ref_lib.merge_nll(*merge(*ref_lib.ce_partials_ref(
        hidden, weight, labels)))
