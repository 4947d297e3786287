"""Gossip mixing operators over pytrees with a leading clients dim.

Port of ``repro.core.mixing:45-121, 223-311``:

* ``mix_dense`` — contraction with the full (n, n) mixing matrix W.
* ``mix_ring`` — neighbor-only exchange as ``torch.roll`` (ring topology).
* ``mix_packed`` — one contraction over the whole state packed to (n, D).
* ``mix_sparse`` — the packed state mixed by neighbor-row gather over a
  :class:`~repro_torch.core.sparse_topology.SparseTopology`, never (n, n).

``gossip_dtype`` narrows only the communicated operands (W and the mixed
values); the products and their sum stay f32.  A product of two bf16 values
is exact in f32, so rounding the operands to bf16 and contracting in f32 is
the JAX package's ``preferred_element_type=float32`` contraction.

The robust (Byzantine-tolerant) impls are not ported yet (ROADMAP A9).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core import sparse_topology as sparse_lib
from repro_torch.core import tree as tree_lib
from repro_torch.kernels.ref import gossip_torch_dtype, narrow

MIXING_IMPLS = ("dense", "ring", "fused_dense", "fused_ring", "pallas_packed",
                "sparse_packed", "fused_round")
# JAX impls that this port refuses, with the ROADMAP item that ports them
UNPORTED_IMPLS = {
    "coord_median": "A9",
    "trimmed_mean": "A9",
    "sparse_coord_median": "A9",
    "sparse_trimmed_mean": "A9",
}


def check_impl(impl: str) -> None:
    if impl in UNPORTED_IMPLS:
        raise NotImplementedError(
            f"mixing_impl={impl!r} is not ported yet "
            f"(ROADMAP {UNPORTED_IMPLS[impl]})")
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


def make_mixer(topology: str, impl: str, w, gossip_dtype: str = "float32"):
    """Returns mix(tree) -> tree for the configured implementation.

    ``w`` is the (n, n) mixing matrix as a tensor on the state's device, or
    for ``sparse_packed`` a ``SparseTopology`` (a dense matrix is bridged
    with ``from_dense``).
    """
    check_impl(impl)
    if impl.endswith("ring"):
        if topology != "ring":
            raise ValueError(
                f"mixing_impl={impl!r} is a neighbor-only exchange, valid "
                f"only for topology='ring' (got {topology!r}); use 'dense', "
                f"'fused_dense', or 'pallas_packed' for arbitrary W")
        wn = np.asarray(w.cpu() if isinstance(w, torch.Tensor) else w)
        n = wn.shape[0]
        w_self = float(wn[0, 0])
        w_nbr = float(wn[0, 1 % n]) if n > 1 else 0.0
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


def make_traced_mixer(impl: str, gossip_dtype: str = "float32"):
    """Per-round-W analogue of :func:`make_mixer`: ``mix(tree, w)`` with W
    an argument — a sampled or participation-masked matrix, a
    ``SparseTopology`` for ``sparse_packed``.  The ring impls hard-code
    their exchange and cannot realize an arbitrary W, so they raise."""
    check_impl(impl)
    if impl.endswith("ring"):
        raise ValueError(
            f"mixing_impl={impl!r} is a neighbor-only exchange and cannot "
            "realize a traced (per-round random or participation-masked) W; "
            "use 'dense', 'fused_dense', or 'pallas_packed'")
    if impl == "sparse_packed":
        return lambda tree, sp: mix_sparse(tree, sp, gossip_dtype)
    if impl == "pallas_packed":
        return lambda tree, w: mix_packed(tree, w, gossip_dtype)
    if impl == "fused_round":
        raise ValueError(
            "mixing_impl='fused_round' has no standalone mixer; it is "
            "routed whole-round by kgt_minimax.make_round_step")
    return lambda tree, w: mix_dense(tree, w, gossip_dtype)


def consensus_error(tree: Any) -> torch.Tensor:
    """(1/n) Σ_i ||T_i - mean_j T_j||² summed over leaves (client variance Ξ)."""
    def one(x):
        m = x.mean(0, keepdim=True)
        return torch.sum(torch.square((x - m).to(torch.float32))) / x.shape[0]
    return sum(one(x) for x in tree_lib.leaves(tree))
