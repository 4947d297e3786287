"""Time-varying random topologies and partial client participation.

Port of ``repro.core.stochastic_topology``.  Per-round samplers draw this
round's mixing matrix W and/or participation mask on the device, as pure
functions of the round index, so a run resumed at round r replays the
identical W/mask sequence.

Topology families (:data:`TOPOLOGY_FAMILIES`):

* ``static`` — the configured matrix every round;
* ``erdos_renyi`` — G(n, p): each undirected edge present independently
  with probability ``edge_prob``, Metropolis–Hastings weights on the drawn
  graph (:func:`metropolis_weights`);
* ``pairwise`` — randomized gossip: one uniformly random pair averages,
  everyone else holds (W = I − ½(e_i−e_j)(e_i−e_j)ᵀ);
* ``dropout`` — per-client Bernoulli dropout of the base topology with
  self-loop fallback (:func:`masked_w`).

Every sampled W is symmetric doubly stochastic by construction, so the
Σ_i c_i = 0 invariant of the tracking variants holds under any draw.
:func:`masked_w` is also the participation primitive: an inactive client's
row and column collapse to e_i.

The reference derives each draw's key with ``jax.random.fold_in``, which a
``torch.Generator`` cannot reproduce.  Here a sampler owns one generator on
its device and re-seeds it before every draw (:func:`round_generator`) as
a pure function of (topology seed, round, stream); the draws differ from
the JAX package's, and parity tests replay the reference's arrays instead
(``repro_torch.core.interop.make_replay_sampler``).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

TOPOLOGY_FAMILIES = ("static", "erdos_renyi", "pairwise", "dropout")

# Above this client count an (n, n) mixing matrix is an O(n²) scaling bug:
# the sparse neighbor-list path grows with the edge count instead.  The
# dense samplers raise rather than quietly allocate.
DENSE_MATERIALIZATION_LIMIT = 512

# stream ids separating the W draw from the participation-mask draw
W_STREAM = 1717
MASK_STREAM = 2929


def check_dense_materialization(n: int, what: str) -> None:
    """Raise if ``what`` would materialize an (n, n) array past the limit."""
    if n > DENSE_MATERIALIZATION_LIMIT:
        raise ValueError(
            f"{what} would materialize a dense ({n}, {n}) mixing matrix "
            f"(limit {DENSE_MATERIALIZATION_LIMIT}); use "
            f"repro_torch.core.sparse_topology / mixing_impl='sparse_packed' "
            f"for large client counts")


def round_generator(gen: torch.Generator, seed: int, round_idx: int,
                    stream: int) -> torch.Generator:
    """``gen`` re-seeded for the (seed, round, stream) draw: distinct for
    every (seed, round < 10⁶, stream) triple."""
    gen.manual_seed(((int(seed) * 1_000_003 + int(round_idx)) * 8191
                     + int(stream)) % (1 << 63))
    return gen


def metropolis_weights(adj: torch.Tensor) -> torch.Tensor:
    """Metropolis–Hastings weights for a symmetric (n, n) adjacency:
    w_ij = 1/(1 + max(d_i, d_j)) on edges, the diagonal takes the leftover
    mass (isolated nodes get w_ii = 1)."""
    adj = adj.to(torch.float32)
    n = adj.shape[0]
    adj = adj * (1.0 - torch.eye(n, dtype=torch.float32, device=adj.device))
    deg = adj.sum(1)
    w = adj / (1.0 + torch.maximum(deg[:, None], deg[None, :]))
    return w + torch.diag(1.0 - w.sum(1))


def erdos_renyi_w(gen: torch.Generator, n: int, edge_prob) -> torch.Tensor:
    """One G(n, edge_prob) draw -> MH-weighted mixing matrix.

    One uniform per undirected edge, on the reference's convention: an
    (n, n−1) uniform where slot j−1 of row i is the draw of edge {i, j},
    j > i.
    """
    check_dense_materialization(n, "erdos_renyi_w")
    dev = gen.device
    if n < 2:
        return torch.eye(max(n, 1), dtype=torch.float32, device=dev)
    u = torch.rand((n, n - 1), generator=gen, device=dev)
    pad = torch.cat([torch.zeros((n, 1), device=dev), u], dim=1)
    upper = torch.triu(pad < edge_prob, diagonal=1)
    return metropolis_weights(upper | upper.T)


def pairwise_w(gen: torch.Generator, n: int) -> torch.Tensor:
    """Randomized pairwise gossip: W = I − ½(e_i−e_j)(e_i−e_j)ᵀ for one
    uniformly random pair i ≠ j; I for n < 2."""
    dev = gen.device
    if n < 2:
        return torch.eye(max(n, 1), dtype=torch.float32, device=dev)
    i = torch.randint(0, n, (1,), generator=gen, device=dev)
    j = torch.randint(0, n - 1, (1,), generator=gen, device=dev)
    j = j + (j >= i).to(j.dtype)
    ar = torch.arange(n, device=dev)
    d = (ar == i).to(torch.float32) - (ar == j).to(torch.float32)
    return (torch.eye(n, dtype=torch.float32, device=dev)
            - 0.5 * torch.outer(d, d))


def masked_w(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Self-loop fallback: W′_ij = W_ij·m_i·m_j off the diagonal, each
    diagonal absorbs its row's lost mass (W′_ii = 1 − Σ_{j≠i} W′_ij).
    Symmetric doubly stochastic for any 0/1 mask; a masked-out client's
    row and column collapse to e_i."""
    w = w.to(torch.float32)
    n = w.shape[0]
    check_dense_materialization(n, "masked_w")
    m = mask.to(torch.float32)
    eye = torch.eye(n, dtype=torch.float32, device=w.device)
    off = w * (1.0 - eye) * m[:, None] * m[None, :]
    return off + torch.diag(1.0 - off.sum(1))


def bernoulli_mask(gen: torch.Generator, n: int, rate) -> torch.Tensor:
    """(n,) bool mask, P[active] = rate (rate ≥ 1 → all active)."""
    return torch.rand((n,), generator=gen, device=gen.device) < rate


def make_w_sampler(
    family: str,
    n: int,
    seed: int,
    *,
    base_w: Optional[np.ndarray] = None,
    edge_prob: float = 0.5,
    client_drop_prob: float = 0.3,
    device="cuda",
) -> Callable[[int], torch.Tensor]:
    """``w_fn(round_idx) -> (n, n) f32 W`` on ``device``: this round's
    mixing matrix.  ``base_w`` is required for ``static`` and ``dropout``
    (the matrix churn is applied to); ``seed`` is ``cfg.topology_seed``."""
    if family not in TOPOLOGY_FAMILIES:
        raise ValueError(
            f"unknown topology family {family!r}: {TOPOLOGY_FAMILIES}")
    if family in ("static", "dropout"):
        if base_w is None:
            raise ValueError(f"topology family {family!r} needs base_w")
        w0 = torch.as_tensor(np.asarray(base_w), dtype=torch.float32,
                             device=device)
    if family == "static":
        return lambda round_idx: w0
    gen = torch.Generator(device=device)

    def draw(r):
        return round_generator(gen, seed, r, W_STREAM)

    if family == "erdos_renyi":
        return lambda r: erdos_renyi_w(draw(r), n, edge_prob)
    if family == "pairwise":
        return lambda r: pairwise_w(draw(r), n)
    return lambda r: masked_w(
        w0, bernoulli_mask(draw(r), n, 1.0 - client_drop_prob))


def make_participation_sampler(n: int, seed: int, rate, *,
                               device="cuda") -> Callable[[int], torch.Tensor]:
    """``mask_fn(round_idx) -> (n,) bool`` per-round participation mask,
    drawn on the MASK_STREAM, independent of the same round's W draw."""
    gen = torch.Generator(device=device)
    return lambda r: bernoulli_mask(
        round_generator(gen, seed, r, MASK_STREAM), n, rate)
