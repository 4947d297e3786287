"""Sparse communication topologies: padded-CSR neighbor lists, never (n, n).

Port of ``repro.core.sparse_topology``.  :class:`SparseTopology` holds
per-client neighbor lists in padded CSR form:

* ``neighbor_idx (n, max_deg) int32`` — neighbor ids, ascending per row;
  padding slots repeat the client's own index;
* ``neighbor_w (n, max_deg) f32`` — the off-diagonal weights w_ij; padding
  slots carry weight 0.0, so every consumer can reduce over all slots;
* ``self_w (n,) f32`` — the diagonal w_ii;
* ``degree (n,) int32`` — valid slots per row.

The constructors (``sparse_ring`` / ``torus`` / ``exp`` / ``full`` /
``star`` / ``hierarchical``) are host numpy, as in the reference, and
return CPU tensors; :meth:`SparseTopology.to` places them.  Metropolis–
Hastings weights on these graphs coincide with the dense constructors'
(``repro_torch.core.topology``).  :func:`from_dense` / :func:`densify`
bridge to the dense world bit-exactly.

:func:`make_sparse_w_sampler` draws per-round Erdős–Rényi percolation of
the support, randomized pairwise gossip on a support edge, or per-client
dropout, on the device and as edge lists, on the generator discipline of
``stochastic_topology``.  Every draw is symmetric doubly stochastic.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import stochastic_topology as stoch_lib
from repro_torch.kernels.ref import gossip_torch_dtype, narrow


@dataclasses.dataclass
class SparseTopology:
    """Padded-CSR neighbor-list mixing matrix (see module docstring)."""
    neighbor_idx: torch.Tensor   # (n, max_deg) int32, padding = own index
    neighbor_w: torch.Tensor     # (n, max_deg) f32,   padding = 0.0
    self_w: torch.Tensor         # (n,) f32 diagonal
    degree: torch.Tensor         # (n,) int32 valid slots per row

    @property
    def n(self) -> int:
        return self.neighbor_idx.shape[0]

    @property
    def max_degree(self) -> int:
        return self.neighbor_idx.shape[1]

    def to(self, device) -> "SparseTopology":
        return SparseTopology(*(t.to(device) for t in (
            self.neighbor_idx, self.neighbor_w, self.self_w, self.degree)))


def _topology(nidx, nw, sw, deg) -> SparseTopology:
    return SparseTopology(
        neighbor_idx=torch.as_tensor(nidx, dtype=torch.int32),
        neighbor_w=torch.as_tensor(nw, dtype=torch.float32),
        self_w=torch.as_tensor(sw, dtype=torch.float32),
        degree=torch.as_tensor(deg, dtype=torch.int32))


# ---------------------------------------------------------------------------
# dense bridge
# ---------------------------------------------------------------------------

def from_dense(w, tol: float = 0.0) -> SparseTopology:
    """Neighbor lists of a dense (n, n) mixing matrix: off-diagonal entries
    with ``|w_ij| > tol`` in ascending column order, the diagonal as
    ``self_w``, all f32 — ``densify(from_dense(w))`` is ``w`` in f32 bit
    for bit.  The O(n²) bridge for matrices that already exist."""
    w = np.asarray(w.cpu() if isinstance(w, torch.Tensor) else w)
    n = w.shape[0]
    if w.shape != (n, n):
        raise ValueError(f"from_dense needs a square matrix, got {w.shape}")
    off = (np.abs(w) > tol) & ~np.eye(n, dtype=bool)
    deg = off.sum(1).astype(np.int32)
    max_deg = max(1, int(deg.max()) if n else 1)
    nidx = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, max_deg))
    nw = np.zeros((n, max_deg), np.float32)
    for i in range(n):
        cols = np.nonzero(off[i])[0]
        nidx[i, :len(cols)] = cols
        nw[i, :len(cols)] = w[i, cols].astype(np.float32)
    return _topology(nidx, nw, np.diag(w).astype(np.float32), deg)


def densify(sp: SparseTopology) -> torch.Tensor:
    """(n, n) f32 mixing matrix of ``sp``, on its device.  Padding slots add
    an exact 0.0 to the diagonal, so ``densify(from_dense(w))`` is ``w`` in
    f32 bit for bit."""
    n = sp.n
    dev = sp.neighbor_idx.device
    rows = torch.arange(n, device=dev)[:, None].expand(sp.neighbor_idx.shape)
    w = torch.zeros((n, n), dtype=torch.float32, device=dev)
    w.index_put_((rows, sp.neighbor_idx.long()),
                 sp.neighbor_w.to(torch.float32), accumulate=True)
    diag = torch.arange(n, device=dev)
    w.index_put_((diag, diag), sp.self_w.to(torch.float32), accumulate=True)
    return w


# ---------------------------------------------------------------------------
# direct constructors (O(edges), host numpy)
# ---------------------------------------------------------------------------

def _from_adjacency(adj) -> SparseTopology:
    """Metropolis–Hastings weights on symmetric adjacency lists:
    w_ij = 1/(1 + max(d_i, d_j)), each diagonal takes its row's leftover."""
    n = len(adj)
    deg = np.array([len(a) for a in adj], np.int32)
    max_deg = max(1, int(deg.max()) if n else 1)
    nidx = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, max_deg))
    nw = np.zeros((n, max_deg), np.float32)
    sw = np.zeros((n,), np.float32)
    for i in range(n):
        nbrs = sorted(adj[i])
        if nbrs:
            row = np.array([1.0 / (1 + max(int(deg[i]), int(deg[j])))
                            for j in nbrs], np.float64)
            nidx[i, :len(nbrs)] = np.asarray(nbrs, np.int32)
            nw[i, :len(nbrs)] = row.astype(np.float32)
            sw[i] = np.float32(1.0 - row.sum())
        else:
            sw[i] = np.float32(1.0)
    return _topology(nidx, nw, sw, deg)


def sparse_ring(n: int) -> SparseTopology:
    adj = [set() for _ in range(n)]
    if n > 1:
        for i in range(n):
            adj[i].update({(i + 1) % n, (i - 1) % n})
    return _from_adjacency(adj)


def sparse_torus(n: int) -> SparseTopology:
    s = int(round(np.sqrt(n)))
    if s * s != n:
        raise ValueError(f"torus needs a square n, got {n}")
    if s <= 2:
        return sparse_ring(n)
    adj = [set() for _ in range(n)]
    for r in range(s):
        for c in range(s):
            i = r * s + c
            for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                adj[i].add(((r + dr) % s) * s + (c + dc) % s)
    return _from_adjacency(adj)


def sparse_exp(n: int) -> SparseTopology:
    """Exponential graph (i ↔ i ± 2^k): degree O(log n), spectral gap
    independent of n at ~2 log₂ n edges a client."""
    adj = [set() for _ in range(n)]
    k = 1
    while k < n:
        for i in range(n):
            adj[i].update({(i + k) % n, (i - k) % n})
        k *= 2
    for i in range(n):
        adj[i].discard(i)
    return _from_adjacency(adj)


def sparse_full(n: int) -> SparseTopology:
    stoch_lib.check_dense_materialization(n, "sparse_full (complete graph)")
    return _from_adjacency([set(range(n)) - {i} for i in range(n)])


def sparse_star(n: int) -> SparseTopology:
    stoch_lib.check_dense_materialization(n, "sparse_star (hub degree n-1)")
    adj = [set() for _ in range(n)]
    for i in range(1, n):
        adj[0].add(i)
        adj[i].add(0)
    return _from_adjacency(adj)


def sparse_hierarchical(n: int, cluster_size: int) -> SparseTopology:
    """Cluster-of-clusters graph: each cluster of ``cluster_size`` clients
    is fully connected; cluster leaders (the first member) form a ring
    across clusters.  Max degree is cluster_size + 1 regardless of n."""
    if cluster_size < 1 or n % cluster_size != 0:
        raise ValueError(
            f"cluster_size must divide n, got n={n}, cluster_size={cluster_size}")
    q = n // cluster_size
    adj = [set() for _ in range(n)]
    for g in range(q):
        base = g * cluster_size
        for a in range(base, base + cluster_size):
            for b in range(base, base + cluster_size):
                if a != b:
                    adj[a].add(b)
    if q == 2:
        adj[0].add(cluster_size)
        adj[cluster_size].add(0)
    elif q > 2:
        for g in range(q):
            lead, nxt = g * cluster_size, ((g + 1) % q) * cluster_size
            adj[lead].add(nxt)
            adj[nxt].add(lead)
    return _from_adjacency(adj)


SPARSE_TOPOLOGIES = {
    "ring": sparse_ring,
    "torus": sparse_torus,
    "exp": sparse_exp,
    "full": sparse_full,
    "star": sparse_star,
}


def sparse_mixing_matrix(name: str, n: int) -> SparseTopology:
    """Sparse counterpart of ``topology.mixing_matrix(name, n)``."""
    try:
        return SPARSE_TOPOLOGIES[name](n)
    except KeyError:
        raise KeyError(
            f"unknown topology {name!r}: {sorted(SPARSE_TOPOLOGIES)}") from None


# ---------------------------------------------------------------------------
# per-round operators
# ---------------------------------------------------------------------------

def sparse_masked_w(sp: SparseTopology, mask: torch.Tensor) -> SparseTopology:
    """Self-loop fallback on the neighbor lists (the sparse
    ``stochastic_topology.masked_w``): w′_ij = w_ij·m_i·m_j on edges, each
    diagonal absorbs its row's lost mass; a masked-out client's row
    collapses to e_i exactly."""
    m = mask.to(torch.float32)
    nw = (sp.neighbor_w.to(torch.float32) * m[:, None]
          * m[sp.neighbor_idx.long()])
    return dataclasses.replace(sp, neighbor_w=nw, self_w=1.0 - nw.sum(1))


def sparse_mix(sp: SparseTopology, buf: torch.Tensor,
               gossip_dtype=None, halo=None) -> torch.Tensor:
    """``W @ buf`` for a packed (n, D) buffer by neighbor-row gather,
    O(n·max_deg·D).  ``mixing.mix_dense``'s dtype rules: the weights and
    the communicated values narrow to ``gossip_dtype``, the sum is f32.
    ``halo``: rows after ``buf``'s that the lists also index (a rank's
    received neighbour rows on the decentralized mesh, ``sp`` its remapped
    table)."""
    gd = gossip_torch_dtype(gossip_dtype)
    bg = narrow(buf, gd)
    src = bg if halo is None else torch.cat([bg, narrow(halo, gd)])
    gathered = src[sp.neighbor_idx.long()]                 # (n, max_deg, D)
    mixed = (narrow(sp.self_w, gd)[:, None] * bg
             + torch.einsum("nm,nmd->nd", narrow(sp.neighbor_w, gd),
                            gathered))
    return mixed.to(buf.dtype)


# ---------------------------------------------------------------------------
# per-round samplers (edge lists, never an (n, n) array)
# ---------------------------------------------------------------------------

def _pair_slots(nidx: np.ndarray, deg: np.ndarray) -> np.ndarray:
    """pair_slot[i, s] = the slot of i in neighbor j's list, where
    j = nidx[i, s]: the inverse map that lets a per-edge draw be read
    from both endpoints.  Padding slots point at themselves."""
    n, m = nidx.shape
    ps = np.tile(np.arange(m, dtype=np.int32), (n, 1))
    slot_of = [{int(j): s for s, j in enumerate(nidx[i, :int(deg[i])])}
               for i in range(n)]
    for i in range(n):
        for s in range(int(deg[i])):
            j = int(nidx[i, s])
            if i not in slot_of[j]:
                raise ValueError(
                    f"support graph is not symmetric: edge {i}->{j} has no "
                    f"reverse slot")
            ps[i, s] = slot_of[j][i]
    return ps


def make_sparse_w_sampler(
    family: str,
    support: SparseTopology,
    seed: int,
    *,
    edge_prob: float = 0.5,
    client_drop_prob: float = 0.3,
    device="cuda",
) -> Callable[[int], SparseTopology]:
    """``w_fn(round_idx) -> SparseTopology`` on ``device``: this round's
    sparse mixing matrix, drawn on the support graph.

    * ``static`` — the support itself every round;
    * ``erdos_renyi`` — each support edge kept with probability
      ``edge_prob`` (one canonical uniform per undirected edge, owned by
      the lower endpoint), MH weights on the realized degrees;
    * ``pairwise`` — randomized gossip on one uniformly random support edge;
    * ``dropout`` — per-client Bernoulli dropout of the support weights
      with self-loop fallback.
    """
    if family not in stoch_lib.TOPOLOGY_FAMILIES:
        raise ValueError(f"unknown topology family {family!r}: "
                         f"{stoch_lib.TOPOLOGY_FAMILIES}")
    sup = support.to(device)
    if family == "static":
        return lambda round_idx: sup
    gen = torch.Generator(device=device)

    def draw(r):
        return stoch_lib.round_generator(gen, seed, r, stoch_lib.W_STREAM)

    nidx = support.neighbor_idx.cpu().numpy()
    deg = support.degree.cpu().numpy()
    n, m = nidx.shape
    if family == "dropout":
        return lambda r: sparse_masked_w(
            sup, stoch_lib.bernoulli_mask(draw(r), n, 1.0 - client_drop_prob))

    pair_slot = torch.as_tensor(_pair_slots(nidx, deg), dtype=torch.long,
                                device=device)
    valid = torch.as_tensor(nidx != np.arange(n, dtype=np.int32)[:, None],
                            device=device)
    nidx_l = sup.neighbor_idx.long()

    if family == "erdos_renyi":
        own = torch.arange(n, device=device)[:, None]

        def sample_er(r):
            u = torch.rand((n, m), generator=draw(r), device=device)
            # the higher endpoint reads the lower endpoint's draw through
            # the pair_slot inverse map, so keep is symmetric
            u_canon = torch.where(nidx_l < own, u[nidx_l, pair_slot], u)
            keep = valid & (u_canon < edge_prob)
            d = keep.sum(1)
            denom = 1.0 + torch.maximum(d[:, None], d[nidx_l]).to(
                torch.float32)
            nw = keep.to(torch.float32) / denom
            return SparseTopology(neighbor_idx=sup.neighbor_idx,
                                  neighbor_w=nw, self_w=1.0 - nw.sum(1),
                                  degree=sup.degree)

        return sample_er

    # pairwise: the directed i<j support edges, listed once on the host
    ei, es = np.nonzero((nidx > np.arange(n)[:, None])
                        & (np.arange(m)[None, :] < deg[:, None]))
    num_edges = len(ei)
    if num_edges == 0:
        identity = SparseTopology(
            neighbor_idx=sup.neighbor_idx,
            neighbor_w=torch.zeros((n, m), device=device),
            self_w=torch.ones((n,), device=device), degree=sup.degree)
        return lambda round_idx: identity
    edges_i = torch.as_tensor(ei, dtype=torch.long, device=device)
    edges_s = torch.as_tensor(es, dtype=torch.long, device=device)
    half = torch.full((1,), 0.5, device=device)

    def sample_pairwise(r):
        t = torch.randint(0, num_edges, (1,), generator=draw(r),
                          device=device)
        i, s = edges_i[t], edges_s[t]
        j, s2 = nidx_l[i, s], pair_slot[i, s]
        nw = torch.zeros((n, m), device=device)
        nw.index_put_((i, s), half)
        nw.index_put_((j, s2), half)
        sw = torch.ones((n,), device=device)
        sw.index_put_((i,), half)
        sw.index_put_((j,), half)
        return SparseTopology(neighbor_idx=sup.neighbor_idx, neighbor_w=nw,
                              self_w=sw, degree=sup.degree)

    return sample_pairwise
