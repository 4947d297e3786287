"""Ravel a client-stacked pytree into one contiguous ``(n, D)`` f32 buffer.

Port of ``repro.core.packing``: each leaf is reshaped to ``(n, -1)`` and
concatenated along the feature axis in leaf order; ``PackSpec`` remembers
the layout so ``unpack`` restores shapes and dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.core import tree as tree_lib

PACK_DTYPE = torch.float32


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Layout of a packed buffer: where each leaf lives and what it was."""
    treedef: Any
    shapes: Tuple[Tuple[int, ...], ...]   # per-leaf trailing shape (no n)
    dtypes: Tuple[torch.dtype, ...]       # per-leaf original dtype
    offsets: Tuple[int, ...]              # per-leaf start column
    sizes: Tuple[int, ...]                # per-leaf column count
    n: int                                # leading clients dim
    dim: int                              # total packed width D


def pack_spec(tree: Any) -> PackSpec:
    leaves, treedef = tree_lib.flatten(tree)
    if not leaves:
        raise ValueError("cannot pack an empty pytree")
    n = leaves[0].shape[0]
    shapes, dtypes, offsets, sizes = [], [], [], []
    off = 0
    for leaf in leaves:
        if leaf.ndim < 1 or leaf.shape[0] != n:
            raise ValueError(
                f"every leaf needs the same leading clients dim {n}, "
                f"got shape {tuple(leaf.shape)}")
        size = 1
        for s in leaf.shape[1:]:
            size *= s
        shapes.append(tuple(leaf.shape[1:]))
        dtypes.append(leaf.dtype)
        offsets.append(off)
        sizes.append(size)
        off += size
    return PackSpec(treedef=treedef, shapes=tuple(shapes), dtypes=tuple(dtypes),
                    offsets=tuple(offsets), sizes=tuple(sizes), n=n, dim=off)


def pack(tree: Any, spec: PackSpec | None = None) -> torch.Tensor:
    """Ravel ``tree`` into an ``(n, D)`` f32 buffer (leaf order = tree order)."""
    spec = spec or pack_spec(tree)
    cols = [leaf.reshape(spec.n, -1).to(PACK_DTYPE)
            for leaf in tree_lib.leaves(tree)]
    return cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)


def unpack(buf: torch.Tensor, spec: PackSpec) -> Any:
    """Inverse of ``pack``: restore leaf shapes and original dtypes."""
    if tuple(buf.shape) != (spec.n, spec.dim):
        raise ValueError(f"buffer {tuple(buf.shape)} does not match spec "
                         f"({spec.n}, {spec.dim})")
    leaves = [
        buf[:, off:off + size].reshape(spec.n, *shape).to(dtype)
        for off, size, shape, dtype
        in zip(spec.offsets, spec.sizes, spec.shapes, spec.dtypes)
    ]
    return tree_lib.unflatten(spec.treedef, leaves)
