"""Grid specification and static-cell partitioning for the sweeps (a copy
of ``repro.sweep.grid``, which is pure Python).

A sweep is a cartesian grid of experiment points.  Not every axis costs the
same: some change the *traced program* (client count changes array shapes,
local steps K changes the inner scan length, the algorithm/topology/mixing
implementation change the graph) while others are just array or scalar
leaves of an otherwise identical program (the PRNG seed, the heterogeneity
level — it only shapes the data arrays — the noise scale, the stepsizes).

``GridSpec`` makes that distinction explicit: each :class:`Axis` is declared
**static** or **batchable**, and :meth:`GridSpec.cells` partitions the grid
into *static cells* — groups of points that share one compiled program and
differ only in batchable leaves.  ``repro_torch.sweep.batched`` then runs
each cell's trajectories in one captured chunk.

A batchable axis may still carry a ``cell_key``: a function of the value
whose *result* is a static program property even though the value itself is
a leaf.  The canonical case is sigma — the noise *scale* is a scalar leaf,
but whether noise ops exist in the graph at all (``sigma > 0``) is static,
so a sigma axis spanning zero declares ``cell_key=lambda s: s > 0`` and the
grid splits the noisy from the noise-free cells.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

KIND_STATIC = "static"
KIND_BATCH = "batch"


@dataclasses.dataclass(frozen=True)
class Axis:
    name: str
    values: Tuple[Any, ...]
    kind: str = KIND_BATCH
    # For batchable axes whose values imply a static program property
    # (see module docstring); the returned key joins the cell signature.
    cell_key: Optional[Callable[[Any], Any]] = None

    def __post_init__(self):
        if self.kind not in (KIND_STATIC, KIND_BATCH):
            raise ValueError(f"axis {self.name!r}: unknown kind {self.kind!r}")
        if not self.values:
            raise ValueError(f"axis {self.name!r}: empty values")


def static_axis(name: str, *values) -> Axis:
    return Axis(name=name, values=tuple(values), kind=KIND_STATIC)


def batch_axis(name: str, *values, cell_key=None) -> Axis:
    return Axis(name=name, values=tuple(values), kind=KIND_BATCH,
                cell_key=cell_key)


@dataclasses.dataclass(frozen=True)
class Cell:
    """One static cell: ``points`` share a compiled program; ``static`` is
    the axis assignment that identifies it (cell_key results included)."""
    key: str
    static: Dict[str, Any]
    points: Tuple[Dict[str, Any], ...]


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """A named sweep: ``base`` point parameters overlaid by the axes'
    cartesian product, optionally post-processed by ``derive`` (a function
    of the point returning parameter updates — e.g. the theory-prescribed
    ``eta ∝ 1/K`` coupling, or a topology-dependent eta_s).

    ``dedup=True`` drops points whose post-``derive`` parameters coincide
    (first occurrence wins) — for grids where an axis only applies to some
    values of another axis and ``derive`` pins it elsewhere (e.g. the churn
    grid's ``edge_prob``, read only by the erdos_renyi family): without
    dedup those cells would run bit-identical trajectories twice and count
    them as replicates.
    """
    name: str
    axes: Tuple[Axis, ...]
    base: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    derive: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None
    dedup: bool = False

    def __post_init__(self):
        names = [a.name for a in self.axes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate axis names in {self.name!r}: {names}")

    def points(self) -> List[Dict[str, Any]]:
        """All grid points in deterministic (row-major over axes) order."""
        pts = []
        for combo in itertools.product(*(a.values for a in self.axes)):
            p = dict(self.base)
            p.update({a.name: v for a, v in zip(self.axes, combo)})
            if self.derive is not None:
                p.update(self.derive(p))
            pts.append(p)
        if self.dedup:
            seen = set()
            unique = []
            for p in pts:
                k = point_key(p)
                if k not in seen:
                    seen.add(k)
                    unique.append(p)
            pts = unique
        return pts

    def cells(self) -> List[Cell]:
        """Partition :meth:`points` into static cells, order-preserving."""
        def signature(p):
            sig = []
            for a in self.axes:
                if a.kind == KIND_STATIC:
                    sig.append((a.name, p[a.name]))
                elif a.cell_key is not None:
                    sig.append((a.name, a.cell_key(p[a.name])))
            return tuple(sig)

        groups: Dict[tuple, List[dict]] = {}
        for p in self.points():
            groups.setdefault(signature(p), []).append(p)
        cells = []
        for sig, pts in groups.items():
            static = dict(sig)
            key = ",".join(f"{k}={v}" for k, v in sig) or "all"
            cells.append(Cell(key=key, static=static, points=tuple(pts)))
        return cells

    def to_json(self) -> dict:
        """Provenance-grade description (callables reduced to names)."""
        return {
            "name": self.name,
            "base": dict(self.base),
            "axes": [
                {"name": a.name, "kind": a.kind, "values": list(a.values),
                 **({"cell_key": getattr(a.cell_key, "__name__", "lambda")}
                    if a.cell_key is not None else {})}
                for a in self.axes
            ],
            **({"derive": getattr(self.derive, "__name__", "lambda")}
               if self.derive is not None else {}),
        }


def point_key(point: Mapping[str, Any]) -> str:
    """Deterministic ``k=v`` identity of a point — the store's merge key."""
    return ",".join(f"{k}={point[k]}" for k in sorted(point))


def config_hash(obj: Any) -> str:
    """Short stable hash of a JSON-serializable object (provenance)."""
    blob = json.dumps(obj, sort_keys=True, default=str).encode()
    return hashlib.sha1(blob).hexdigest()[:12]
