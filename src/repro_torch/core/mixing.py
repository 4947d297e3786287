"""Gossip mixing operators over pytrees with a leading clients dim.

Port of ``repro.core.mixing:45-121, 223-311``:

* ``mix_dense`` — contraction with the full (n, n) mixing matrix W.
* ``mix_ring`` — neighbor-only exchange as ``torch.roll`` (ring topology).
* ``mix_packed`` — one contraction over the whole state packed to (n, D).
* ``mix_sparse`` — the packed state mixed by neighbor-row gather over a
  :class:`~repro_torch.core.sparse_topology.SparseTopology`, never (n, n).
* ``robust_mix_dense`` / ``robust_mix_sparse`` / ``robust_mix_packed`` —
  Byzantine-tolerant aggregation (coordinate median, trimmed mean) over the
  support of W, for the ``ROBUST_IMPLS`` (reference ``:120-225``).

``gossip_dtype`` narrows only the communicated operands (W and the mixed
values); the products and their sum stay f32.  A product of two bf16 values
is exact in f32, so rounding the operands to bf16 and contracting in f32 is
the JAX package's ``preferred_element_type=float32`` contraction.

The robust rules are plain PyTorch (``torch.sort``, ``take_along_dim``), as
the reference computes them in plain ``jnp``; they make no host sync, so
they run inside captured engine chunks.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core import sparse_topology as sparse_lib
from repro_torch.core import tree as tree_lib
from repro_torch.dist import collectives
from repro_torch.kernels.ref import gossip_torch_dtype, narrow

ROBUST_RULES = ("coord_median", "trimmed_mean")
# first-class mixing_impl names: dense form + sparse neighbor-gather form
ROBUST_IMPLS = ("coord_median", "trimmed_mean",
                "sparse_coord_median", "sparse_trimmed_mean")
MIXING_IMPLS = ("dense", "ring", "fused_dense", "fused_ring", "pallas_packed",
                "sparse_packed", "fused_round") + ROBUST_IMPLS


def check_impl(impl: str) -> None:
    if impl not in MIXING_IMPLS:
        raise ValueError(f"unknown mixing_impl {impl!r}: {MIXING_IMPLS}")


def mix_dense(tree: Any, w: torch.Tensor, gossip_dtype=None) -> Any:
    """tree leaves: (n, ...) -> W @ leaves."""
    gd = gossip_torch_dtype(gossip_dtype)
    wg = narrow(w, gd)

    def one(x):
        n = x.shape[0]
        mixed = wg @ narrow(x, gd).reshape(n, -1)
        return mixed.reshape(x.shape).to(x.dtype)

    return tree_lib.tree_map(one, tree)


def mix_ring(tree: Any, w_self: float, w_nbr: float, gossip_dtype=None) -> Any:
    """Ring mixing: w_self * x_i + w_nbr * (x_{i-1} + x_{i+1})."""
    gd = gossip_torch_dtype(gossip_dtype)

    def one(x):
        n = x.shape[0]
        if n == 1:
            return x
        xc = narrow(x, gd)
        if n == 2:
            mixed = w_self * xc + w_nbr * torch.roll(xc, 1, dims=0)
        else:
            up = torch.roll(xc, 1, dims=0)
            dn = torch.roll(xc, -1, dims=0)
            mixed = w_self * xc + w_nbr * (up + dn)
        return mixed.to(x.dtype)

    return tree_lib.tree_map(one, tree)


def mix_packed(tree: Any, w: torch.Tensor, gossip_dtype=None) -> Any:
    """One gossip for the whole pytree: ravel to (n, D), mix, unravel."""
    spec = packing.pack_spec(tree)
    mixed = mix_dense(packing.pack(tree, spec), w, gossip_dtype=gossip_dtype)
    return packing.unpack(mixed, spec)


def mix_sparse(tree: Any, sp, gossip_dtype=None) -> Any:
    """One neighbor-gather gossip for the whole pytree: ravel to (n, D),
    ``sparse_topology.sparse_mix``, unravel."""
    spec = packing.pack_spec(tree)
    mixed = sparse_lib.sparse_mix(sp, packing.pack(tree, spec),
                                  gossip_dtype=gossip_dtype)
    return packing.unpack(mixed, spec)


# ---------------------------------------------------------------------------
# robust (Byzantine-tolerant) aggregation
# ---------------------------------------------------------------------------

def robust_rule(impl: str) -> str:
    """The aggregation rule of a robust mixing_impl name."""
    rule = impl[len("sparse_"):] if impl.startswith("sparse_") else impl
    if rule not in ROBUST_RULES:
        raise ValueError(f"not a robust mixing_impl: {impl!r} ({ROBUST_IMPLS})")
    return rule


def _robust_reduce(vals: torch.Tensor, valid: torch.Tensor, rule: str,
                   trim: int) -> torch.Tensor:
    """Per-coordinate order statistic over the valid slots of each row.

    vals: (n, m, D) candidate values per client; valid: (n, m) bool.
    Invalid slots (padding, masked links, absent edges) are ignored, and so
    are non-finite values per coordinate, so a diverged attacker never
    holds a trim slot.  Every row keeps ≥ 1 finite valid slot per
    coordinate (the aggregating client itself).

    * ``coord_median`` — midpoint of the two middle order statistics of the
      k valid values;
    * ``trimmed_mean`` — mean after dropping the b smallest and b largest
      values per coordinate, b = min(trim, (k−1)//2).

    k (hence b) is per (row, coordinate).
    """
    if rule not in ROBUST_RULES:
        raise ValueError(f"unknown robust rule {rule!r}: {ROBUST_RULES}")
    vals = vals.to(torch.float32)
    m = vals.shape[1]
    ok = valid.to(torch.bool)[:, :, None] & torch.isfinite(vals)
    k = ok.sum(1, dtype=torch.int32)                          # (n, D) ≥ 1
    filled = torch.where(ok, vals, float("inf"))
    srt = torch.sort(filled, dim=1).values   # valid ascending, inf last
    if rule == "coord_median":
        lo = torch.take_along_dim(srt, ((k - 1) // 2)[:, None, :].long(),
                                  dim=1)
        hi = torch.take_along_dim(srt, (k // 2)[:, None, :].long(), dim=1)
        return (0.5 * (lo + hi))[:, 0, :]
    b = torch.clamp((k - 1) // 2, max=int(trim))                # (n, D)
    rank = torch.arange(m, dtype=torch.int32, device=vals.device)[None, :,
                                                                  None]
    keep = (rank >= b[:, None, :]) & (rank < (k - b)[:, None, :])
    # where-then-sum (not multiply) so the inf padding never meets a 0
    total = torch.sum(torch.where(keep, srt, 0.0), dim=1)
    return total / (k - 2 * b).to(torch.float32)


# the candidate values an order statistic holds at once (n·m·columns): a
# language model's packed D is ~1e8 columns a client, whose (n, m, D)
# candidates, sort values and int64 sort indices would not fit beside the
# state, so past this many candidates the rules reduce column blocks in
# turn (each coordinate's reduction is its own); the quadratic's rounds,
# n = 4096 on the exp graph included, stay one block
ROBUST_CHUNK = 1 << 28


def _reduce_columns(vals_of, valid: torch.Tensor, rule: str, trim: int,
                    d: int) -> torch.Tensor:
    """:func:`_robust_reduce` over columns [0, d) in blocks of at most
    ROBUST_CHUNK candidates; ``vals_of(a, b)`` gives the (n, m, b − a)
    candidates of columns [a, b)."""
    n, m = valid.shape
    if n * m * d <= ROBUST_CHUNK:
        return _robust_reduce(vals_of(0, d), valid, rule, trim)
    out = torch.empty((n, d), dtype=torch.float32, device=valid.device)
    step = max(1, ROBUST_CHUNK // max(1, n * m))
    for a in range(0, d, step):
        b = min(a + step, d)
        out[:, a:b] = _robust_reduce(vals_of(a, b), valid, rule, trim)
    return out


def robust_mix_dense(buf: torch.Tensor, w: torch.Tensor, *, rule: str,
                     trim: int = 1, gossip_dtype=None, halo=None,
                     cols=None, row0: int = 0) -> torch.Tensor:
    """Robust aggregation of a packed (n, D) buffer over the support of a
    dense (n, n) W: client i reduces over ``{j : w_ij > 0} ∪ {i}``.  The
    communicated values narrow to ``gossip_dtype``; the reduction is f32.

    On the decentralized mesh ``w`` is the rank's (n/R, n) rows of W from
    row ``row0``, ``buf`` its rows, ``halo`` the rows it received
    (``dist.collectives.halo_rows``) and ``cols`` the global row of each
    of [buf; halo]: each row reduces over the same support, among the rows
    the rank holds."""
    gd = gossip_torch_dtype(gossip_dtype)
    n = w.shape[0]
    bg = narrow(buf, gd)
    if halo is None:
        src = bg
        valid = (w.to(torch.float32) > 0.0) | torch.eye(n, dtype=torch.bool,
                                                        device=w.device)
    else:
        src = torch.cat([bg, narrow(halo, gd)])
        own = row0 + torch.arange(n, device=w.device)
        valid = ((w.to(torch.float32)[:, cols] > 0.0)
                 | (cols[None, :] == own[:, None]))
    return _reduce_columns(
        lambda a, b: src[None, :, a:b].expand(n, src.shape[0], b - a),
        valid, rule, trim, bg.shape[1]).to(buf.dtype)


def robust_mix_sparse(buf: torch.Tensor, sp, *, rule: str, trim: int = 1,
                      gossip_dtype=None, halo=None) -> torch.Tensor:
    """Neighbor-gather form of :func:`robust_mix_dense`: the candidates are
    gathered through the padded-CSR lists, O(n·max_deg·D), no (n, n)
    array.  Validity is ``neighbor_w > 0`` (padding and masked links drop
    out) and the self slot is always in.  ``halo``: rows after ``buf``'s
    that the lists also index (``sparse_topology.sparse_mix``'s)."""
    gd = gossip_torch_dtype(gossip_dtype)
    bg = narrow(buf, gd)
    n = sp.neighbor_idx.shape[0]
    src = bg if halo is None else torch.cat([bg, narrow(halo, gd)])
    idx = sp.neighbor_idx.long()
    valid = torch.cat([torch.ones((n, 1), dtype=torch.bool,
                                  device=bg.device), sp.neighbor_w > 0.0],
                      dim=1)
    return _reduce_columns(
        lambda a, b: torch.cat([bg[:, None, a:b], src[:, a:b][idx]], dim=1),
        valid, rule, trim, bg.shape[1]).to(buf.dtype)


def robust_mix_packed(tree: Any, w, *, rule: str, trim: int = 1,
                      gossip_dtype=None) -> Any:
    """Tree-level robust aggregation: ravel to (n, D), reduce, unravel.
    A ``SparseTopology`` ``w`` takes the neighbor-gather form, a dense
    matrix the dense one."""
    spec = packing.pack_spec(tree)
    red = (robust_mix_sparse if isinstance(w, sparse_lib.SparseTopology)
           else robust_mix_dense)
    mixed = red(packing.pack(tree, spec), w, rule=rule, trim=trim,
                gossip_dtype=gossip_dtype)
    return packing.unpack(mixed, spec)


def ring_weights(topology: str, impl: str, w) -> tuple:
    """(w_self, w_nbr) of a ring's W for the neighbor-only ring impls,
    which no other topology may take."""
    if topology != "ring":
        raise ValueError(
            f"mixing_impl={impl!r} is a neighbor-only exchange, valid "
            f"only for topology='ring' (got {topology!r}); use 'dense', "
            f"'fused_dense', or 'pallas_packed' for arbitrary W")
    wn = np.asarray(w.cpu() if isinstance(w, torch.Tensor) else w)
    n = wn.shape[0]
    return float(wn[0, 0]), (float(wn[0, 1 % n]) if n > 1 else 0.0)


def make_mixer(topology: str, impl: str, w, gossip_dtype: str = "float32",
               *, trim: int = 1):
    """Returns mix(tree) -> tree for the configured implementation.

    ``w`` is the (n, n) mixing matrix as a tensor on the state's device, or
    for ``sparse_packed`` and the ``sparse_*`` robust impls a
    ``SparseTopology`` (a dense matrix is bridged with ``from_dense``).
    """
    check_impl(impl)
    if impl in ROBUST_IMPLS:
        rule = robust_rule(impl)
        if impl.startswith("sparse_") and not isinstance(
                w, sparse_lib.SparseTopology):
            w = sparse_lib.from_dense(w)
        return lambda tree: robust_mix_packed(tree, w, rule=rule, trim=trim,
                                              gossip_dtype=gossip_dtype)
    if impl.endswith("ring"):
        w_self, w_nbr = ring_weights(topology, impl, w)
        return lambda tree: mix_ring(tree, w_self, w_nbr, gossip_dtype)
    if impl == "sparse_packed":
        sp = (w if isinstance(w, sparse_lib.SparseTopology)
              else sparse_lib.from_dense(w))
        return lambda tree: mix_sparse(tree, sp, gossip_dtype)
    if impl == "pallas_packed":
        return lambda tree: mix_packed(tree, w, gossip_dtype)
    if impl == "fused_round":
        raise ValueError(
            "mixing_impl='fused_round' has no standalone mixer; it is "
            "routed whole-round by kgt_minimax.make_round_step")
    return lambda tree: mix_dense(tree, w, gossip_dtype)


def make_traced_mixer(impl: str, gossip_dtype: str = "float32", *,
                      trim: int = 1):
    """Per-round-W analogue of :func:`make_mixer`: ``mix(tree, w)`` with W
    an argument — a sampled or participation-masked matrix, a
    ``SparseTopology`` for ``sparse_packed`` and the ``sparse_*`` robust
    impls.  The ring impls hard-code their exchange and cannot realize an
    arbitrary W, so they raise."""
    check_impl(impl)
    if impl.endswith("ring"):
        raise ValueError(
            f"mixing_impl={impl!r} is a neighbor-only exchange and cannot "
            "realize a traced (per-round random or participation-masked) W; "
            "use 'dense', 'fused_dense', or 'pallas_packed'")
    if impl in ROBUST_IMPLS:
        # W as support: a SparseTopology for the sparse_* forms, an (n, n)
        # tensor otherwise; robust_mix_packed dispatches on it
        rule = robust_rule(impl)
        return lambda tree, w: robust_mix_packed(tree, w, rule=rule,
                                                 trim=trim,
                                                 gossip_dtype=gossip_dtype)
    if impl == "sparse_packed":
        return lambda tree, sp: mix_sparse(tree, sp, gossip_dtype)
    if impl == "pallas_packed":
        return lambda tree, w: mix_packed(tree, w, gossip_dtype)
    if impl == "fused_round":
        raise ValueError(
            "mixing_impl='fused_round' has no standalone mixer; it is "
            "routed whole-round by kgt_minimax.make_round_step")
    return lambda tree, w: mix_dense(tree, w, gossip_dtype)


def consensus_error(tree: Any, axis=None, means=None,
                    block=None) -> torch.Tensor:
    """(1/n) Σ_i ||T_i - mean_j T_j||² summed over leaves (client variance Ξ).

    On the decentralized mesh (``axis``, a ``dist.collectives.ClientsAxis``:
    the leaves hold this rank's clients) the means and the sum of squares
    are all-reduced over the clients axis, so Ξ is the global one.
    ``means``: the leaves' means over the clients, where the caller has
    them.  ``block``: where the leaves are pieces of a client split over
    a block of ranks, its ``dist.collectives.BlockSum``, over which the
    sum of squares is taken too."""
    leaves = tree_lib.leaves(tree)
    if means is None:
        means = [collectives.clients_mean(x, axis) for x in leaves]
    else:
        means = tree_lib.leaves(means)

    def squares(x, m):
        return torch.square((x - m.unsqueeze(0)).to(torch.float32))

    def one(x, m):
        return torch.sum(squares(x, m))

    if (axis is None or axis.size == 1) and block is None:
        return sum(one(x, m) / x.shape[0] for x, m in zip(leaves, means))
    if block is None:
        total = sum(one(x, m) for x, m in zip(leaves, means))
    else:
        total = block([squares(x, m) for x, m in zip(leaves, means)])
    if axis is None or axis.size == 1:
        return total / leaves[0].shape[0]
    return collectives.all_reduce_sum(total, axis) / axis.n
