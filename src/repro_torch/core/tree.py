"""Minimal pytree helpers with the JAX package's leaf order.

State variables are tensors or nested dicts/lists/tuples of tensors with a
leading clients dim.  Leaves are ordered as ``jax.tree.leaves`` orders them
(dict keys sorted, sequences in order, dataclass fields in declaration
order, as ``jax.tree_util.register_dataclass`` does), so packed layouts and
checkpoints match the reference leaf for leaf.  Anything else is a leaf:
a tensor, or a host value such as ``KGTState.round``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import torch


def _walk(node, leaves: List[torch.Tensor]):
    if node is None:
        return None
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", keys, [_walk(node[k], leaves) for k in keys])
    if isinstance(node, (list, tuple)):
        return (type(node).__name__, None, [_walk(v, leaves) for v in node])
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        names = tuple(f.name for f in dataclasses.fields(node))
        return (type(node), names,
                [_walk(getattr(node, k), leaves) for k in names])
    leaves.append(node)
    return "leaf"


def flatten(tree: Any) -> Tuple[List[torch.Tensor], Any]:
    """tree -> (leaves, treedef); ``None`` is an empty node.  (Module-level
    recursion: a nested function that calls itself is a reference cycle,
    which would keep the leaves alive until the cyclic collector runs.)"""
    leaves: List[torch.Tensor] = []
    return leaves, _walk(tree, leaves)


def _build(d, it):
    if d is None:
        return None
    if d == "leaf":
        return next(it)
    kind, keys, children = d
    built = [_build(c, it) for c in children]
    if kind == "dict":
        return dict(zip(keys, built))
    if isinstance(kind, type):
        return kind(**dict(zip(keys, built)))
    return tuple(built) if kind == "tuple" else list(built)


def unflatten(treedef: Any, leaves) -> Any:
    return _build(treedef, iter(leaves))


def leaves(tree: Any) -> List[torch.Tensor]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    flat, treedef = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])
