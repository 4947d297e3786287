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


def flatten(tree: Any) -> Tuple[List[torch.Tensor], Any]:
    """tree -> (leaves, treedef); ``None`` is an empty node."""
    leaves: List[torch.Tensor] = []

    def walk(node):
        if node is None:
            return None
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", keys, [walk(node[k]) for k in keys])
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, None, [walk(v) for v in node])
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            names = tuple(f.name for f in dataclasses.fields(node))
            return (type(node), names,
                    [walk(getattr(node, k)) for k in names])
        leaves.append(node)
        return "leaf"

    return leaves, walk(tree)


def unflatten(treedef: Any, leaves) -> Any:
    it = iter(leaves)

    def build(d):
        if d is None:
            return None
        if d == "leaf":
            return next(it)
        kind, keys, children = d
        built = [build(c) for c in children]
        if kind == "dict":
            return dict(zip(keys, built))
        if isinstance(kind, type):
            return kind(**dict(zip(keys, built)))
        return tuple(built) if kind == "tuple" else list(built)

    return build(treedef)


def leaves(tree: Any) -> List[torch.Tensor]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    flat, treedef = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])
