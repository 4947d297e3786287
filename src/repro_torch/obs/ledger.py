"""The communication ledger: analytic bytes-on-the-wire per round (port of
``repro.obs.ledger``).

K-GT-Minimax's headline claim is *communication efficiency* — convergence
per communication round, per byte moved.  This module computes, from the
configured lowering alone (no tracing, no device work), what one round of
Algorithm 1 puts on the wire, so every train/sweep run can report the
paper's efficiency metric as a first-class quantity.

The model
---------

One round gossips, per variable v ∈ {x, y} with packed payload ``D_v``
elements per client:

* with gradient tracking (``kgt_minimax``/``gt_gda``) on a packed or robust
  lowering — **two quantities**: the round delta Δ (lines 7–8) and the
  parameters θ (lines 10–11);
* the per-leaf lowerings (``dense``/``ring``/``fused_*``) always move both
  (the fused_* variants halve the collective *launches*, not the bytes);
* without tracking on a packed lowering — **one quantity**: the pre-stepped
  ``θ + η_s·Δ``.

How many values cross the wire per gossip is the *links* count ``L``
(receives summed over clients):

* dense-family lowerings (``dense``/``fused_dense``/``pallas_packed``/
  ``fused_round``/dense robust) all-gather the full client axis:
  ``L = n·(n−1)``;
* ``ring``/``fused_ring`` exchange with the two ring neighbors:
  ``L = 2n`` (``n`` for n=2, 0 for n=1);
* ``sparse_*`` lowerings gather neighbor rows through the padded-CSR
  support: ``L = Σ_i deg_i`` (the directed edge count of the topology).

Bytes per transmitted element come from ``gossip_dtype`` (f32 = 4,
bf16 = 2); with ``gossip_compress`` the Δ-gossip narrows to the quantizer's
wire width (``kernels.quantize.wire_bits``: bf16 = 2 bytes, int8 = 1 byte
**plus one f32 scale per row per link** — the per-client scale travels with
the codes).  The θ-gossip stays at ``gossip_dtype``; compression applies to
the transmitted delta only (``core.compression``, the compressed round of
``pallas_packed`` and ``fused_round``).

For per-round *random* topologies (churn families) the ledger accounts the
static support graph — an exact figure for ``static``/``dropout`` upper
bounds and the support-level cost for ER/pairwise draws.

Everything is exact integer arithmetic on host ints; a
:class:`CommLedger` accumulates rounds into totals and renders ledger
events for the telemetry stream.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

LEDGER_VERSION = 1

# lowerings whose gossip collective touches the full client axis
_DENSE_FAMILY = ("dense", "fused_dense", "pallas_packed", "fused_round",
                 "coord_median", "trimmed_mean")
_RING_FAMILY = ("ring", "fused_ring")
_SPARSE_FAMILY = ("sparse_packed", "sparse_coord_median",
                  "sparse_trimmed_mean")
_PER_LEAF = ("dense", "ring", "fused_dense", "fused_ring")
_TRACKING_ALGOS = ("kgt_minimax", "gt_gda")


def _dtype_bytes(gossip_dtype: Optional[str]) -> int:
    return int(np.dtype(gossip_dtype or "float32").itemsize)


def _compress_bytes(method: Optional[str]) -> Tuple[Optional[int], int]:
    """(payload bytes per element, extra bytes per row) for the compressed
    Δ-gossip; (None, 0) when compression is off."""
    if method in (None, "none", ""):
        return None, 0
    from repro_torch.kernels.quantize import QUANT_METHODS, wire_bits

    if method not in QUANT_METHODS:
        raise ValueError(f"unknown gossip_compress {method!r}: {QUANT_METHODS}")
    # int8 ships one f32 scale per (client-)row alongside the codes
    return wire_bits(method) // 8, 4 if method == "int8" else 0


def links_per_gossip(mixing_impl: str, n: int, *, topology: str = "ring",
                     edges: Optional[int] = None) -> int:
    """Values received per gossip, summed over clients, for the lowering."""
    if mixing_impl in _DENSE_FAMILY:
        return n * (n - 1)
    if mixing_impl in _RING_FAMILY:
        if n <= 1:
            return 0
        return n if n == 2 else 2 * n
    if mixing_impl in _SPARSE_FAMILY:
        if edges is None:
            from repro_torch.core import sparse_topology as sparse_lib

            edges = int(sparse_lib.sparse_mixing_matrix(topology, n)
                        .degree.sum())
        return int(edges)
    raise ValueError(f"unknown mixing_impl {mixing_impl!r} for the ledger")


def _quantities(mixing_impl: str, track: bool) -> int:
    """Gossiped quantities per variable per round (see module docstring)."""
    if mixing_impl in _PER_LEAF:
        return 2  # the generic path mixes Δ and θ regardless of tracking
    return 2 if track else 1


def _collectives(mixing_impl: str, track: bool,
                 leaves: Sequence[int]) -> int:
    """Collective launches per round.

    Per-leaf lowerings launch one collective per leaf per gossiped quantity
    (``fused_*`` pack Δ and θ into one launch); the packed lowerings fuse
    the whole per-variable epilogue into one launch each; ``fused_round``
    runs the entire round — both variables — as a single kernel pass.
    """
    num_vars = len(leaves)
    if mixing_impl in ("dense", "ring"):
        return 2 * sum(leaves)
    if mixing_impl in ("fused_dense", "fused_ring"):
        return sum(leaves)
    if mixing_impl == "fused_round":
        return 1
    if mixing_impl in ("pallas_packed", "sparse_packed"):
        return num_vars
    if mixing_impl in ("coord_median", "trimmed_mean",
                       "sparse_coord_median", "sparse_trimmed_mean"):
        # the robust epilogue aggregates θ+η_s·Δ and (tracking) Δ per var
        return (2 if track else 1) * num_vars
    raise ValueError(f"unknown mixing_impl {mixing_impl!r} for the ledger")


@dataclasses.dataclass(frozen=True)
class RoundComm:
    """What one round moves, analytically, for a configured lowering."""
    mixing_impl: str
    n: int
    dims: Tuple[int, ...]          # packed payload per variable (D_x, D_y)
    links: int                     # values received per gossip, all clients
    quantities: int                # gossiped quantities per variable
    elems_per_round: int           # payload elements on the wire per round
    bytes_per_round: int
    collectives_per_round: int
    gossip_dtype: str = "float32"
    gossip_compress: Optional[str] = None

    def describe(self) -> dict:
        """JSON-able summary for meta events / provenance stamps."""
        return {
            "ledger_version": LEDGER_VERSION,
            "mixing_impl": self.mixing_impl,
            "n": self.n,
            "dims": list(self.dims),
            "links": self.links,
            "quantities": self.quantities,
            "elems_per_round": self.elems_per_round,
            "bytes_per_round": self.bytes_per_round,
            "collectives_per_round": self.collectives_per_round,
            "gossip_dtype": self.gossip_dtype,
            "gossip_compress": self.gossip_compress,
        }


def round_comm(
    *,
    mixing_impl: str,
    n: int,
    dims: Sequence[int],
    leaves: Optional[Sequence[int]] = None,
    topology: str = "ring",
    edges: Optional[int] = None,
    track: bool = True,
    gossip_dtype: Optional[str] = "float32",
    gossip_compress: Optional[str] = None,
) -> RoundComm:
    """Build the per-round communication model for one configuration.

    ``dims`` — packed payload elements per client per variable (``(D_x,
    D_y)`` for the minimax state); ``leaves`` — leaf counts per variable
    (defaults to one leaf each, the packed view); ``edges`` — directed edge
    count for sparse lowerings (derived from ``topology`` when omitted);
    ``track`` — whether the algorithm carries gradient-tracking corrections.
    """
    dims = tuple(int(d) for d in dims)
    leaves = tuple(int(l) for l in (leaves if leaves is not None
                                    else (1,) * len(dims)))
    if len(leaves) != len(dims):
        raise ValueError(f"dims {dims} and leaves {leaves} must be parallel")
    links = links_per_gossip(mixing_impl, n, topology=topology, edges=edges)
    quantities = _quantities(mixing_impl, track)
    theta_b = _dtype_bytes(gossip_dtype)
    comp_b, comp_row_b = _compress_bytes(gossip_compress)
    total_d = sum(dims)
    elems = links * total_d * quantities
    if quantities == 2:
        theta_bytes = links * total_d * theta_b
        if comp_b is not None:
            delta_bytes = links * (total_d * comp_b
                                   + comp_row_b * len(dims))
        else:
            delta_bytes = links * total_d * theta_b
        total_bytes = theta_bytes + delta_bytes
    else:
        # single pre-stepped gossip θ + η_s·Δ at the gossip dtype
        total_bytes = links * total_d * theta_b
    return RoundComm(
        mixing_impl=mixing_impl, n=n, dims=dims, links=links,
        quantities=quantities, elems_per_round=elems,
        bytes_per_round=int(total_bytes),
        collectives_per_round=_collectives(mixing_impl, track, leaves),
        gossip_dtype=str(gossip_dtype or "float32"),
        gossip_compress=(None if gossip_compress in (None, "none", "")
                         else gossip_compress))


def ledger_for_state(cfg, state) -> "CommLedger":
    """A :class:`CommLedger` for an ``AlgorithmConfig`` + ``KGTState`` pair —
    payload dims from the packed specs, leaf counts from the trees."""
    from repro_torch.core import packing
    from repro_torch.core import tree as tree_lib

    dims = (packing.pack_spec(state.x).dim, packing.pack_spec(state.y).dim)
    leaves = (len(tree_lib.leaves(state.x)), len(tree_lib.leaves(state.y)))
    return CommLedger(round_comm(
        mixing_impl=cfg.mixing_impl, n=cfg.num_clients, dims=dims,
        leaves=leaves, topology=cfg.topology,
        track=cfg.algorithm in _TRACKING_ALGOS,
        gossip_dtype=cfg.gossip_dtype,
        gossip_compress=getattr(cfg, "gossip_compress", None)))


class CommLedger:
    """Accumulates :class:`RoundComm` over executed rounds."""

    def __init__(self, comm: RoundComm) -> None:
        self.comm = comm
        self.rounds = 0

    @property
    def bytes_per_round(self) -> int:
        return self.comm.bytes_per_round

    @property
    def total_bytes(self) -> int:
        return self.rounds * self.comm.bytes_per_round

    @property
    def total_collectives(self) -> int:
        return self.rounds * self.comm.collectives_per_round

    def add_rounds(self, k: int) -> None:
        self.rounds += int(k)

    def describe(self) -> dict:
        return self.comm.describe()

    def event(self, *, rounds: Optional[int] = None, **attrs) -> dict:
        """A ``ledger`` telemetry event: the increment (``rounds``/``bytes``)
        plus the running totals."""
        out = {
            "type": "ledger",
            "ledger_version": LEDGER_VERSION,
            "mixing_impl": self.comm.mixing_impl,
            "bytes_per_round": self.comm.bytes_per_round,
            "collectives_per_round": self.comm.collectives_per_round,
            "rounds_total": self.rounds,
            "bytes_total": self.total_bytes,
            "collectives_total": self.total_collectives,
        }
        if rounds is not None:
            out["rounds"] = int(rounds)
            out["bytes"] = int(rounds) * self.comm.bytes_per_round
        out.update(attrs)
        return out
