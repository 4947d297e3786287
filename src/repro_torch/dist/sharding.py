"""Parameter placement specs for the decentralized and production meshes
(port of ``repro.dist.sharding``).

Axis vocabulary (``repro_torch.launch.mesh``):

* the decentralized training mesh ``(clients, fsdp, model)``: one
  K-GT-Minimax client a contiguous ``fsdp × model`` block.  Every state
  leaf carries a leading clients dim n; that dim on the ``clients`` axis
  confines each client's K local steps to its own ranks, so the two
  gossips of a round are the only traffic between clients;
* the production serving mesh ``(data, model)`` or ``(pod, data, model)``:
  weights sharded over ``model``, replicated over the batch axes.

A spec is a tuple of ``torch.distributed.tensor`` placements for one leaf,
one a mesh dim in the mesh's order: ``Shard(d)`` where leaf dim d lies on
that axis, ``Replicate()`` elsewhere.  The rules are the reference's (the
largest divisible dim, ties to the later one; the experts dim of a MoE
expert leaf on ``model`` with ``expert_parallel``), so the same dims land
on the same axes as in its ``PartitionSpec``.  A tree is a nested dict /
list / tuple; a leaf's path is its keys, a dotted string key (the port's
parameter names, ``layers.3.moe.gate``) counting as its parts.

These are specs.  The executed training layout of a client's weights is
``dist.tensor_parallel.ClientShard`` under ``param_mode="fsdp2d"``: over
``model`` the serving mesh's Megatron plan (heads, d_ff, the vocabulary;
the dims GSPMD shards for ``fsdp2d`` where the largest dim is one of
those), over ``fsdp`` dim 0 of each model piece in ZeRO-3 pieces; and
``dist.tensor_parallel.ReplicatedShard`` under ``"replicated"``: every
weight whole on each rank of the block (these specs' ``Replicate()``
over fsdp and model, the experts too), the batch rows over fsdp and,
under ``residual_mode="batch_seq"``, the sequence over model, each
weight's gradient summed over the ranks that hold the client's tokens.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

from torch.distributed.tensor import Replicate, Shard

from repro_torch.dist import compat

# canonical axis names of the decentralized logical mesh
CLIENTS = "clients"
FSDP = "fsdp"
MODEL = "model"

# MoE expert-weight leaves: (..., experts, d_in, d_out); the experts dim
# sits at ndim-3 whatever leading dims the tree carries
_EXPERT_LEAF_KEYS = frozenset({"gate", "up", "down"})


def _map_with_path(fn: Callable, node, path: Tuple = ()):
    if isinstance(node, dict):
        return {k: _map_with_path(fn, v, path + tuple(str(k).split(".")))
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(node))
    return fn(path, node)


def tree_map_with_path(fn: Callable, tree) -> Any:
    """``fn(path, leaf)`` over a nested dict / list / tuple; ``path`` is the
    tuple of keys and indices from the root."""
    return _map_with_path(fn, tree)


def _best_dim(shape: Tuple[int, ...], used, axis_size: int) -> Optional[int]:
    """Largest dim divisible by ``axis_size`` (ties -> the later dim), or
    None if nothing is shardable."""
    cands = [(sz, i) for i, sz in enumerate(shape)
             if i not in used and sz > 1 and sz >= axis_size
             and sz % axis_size == 0]
    return max(cands)[1] if cands else None


def _is_expert_leaf(path) -> bool:
    """MoE expert weights: stacked ``(…, e, d, f)`` leaves under a ``moe``
    key, the ones ``expert_parallel`` puts on the ``model`` axis."""
    keys = [str(k) for k in path]
    return "moe" in keys and bool(keys) and keys[-1] in _EXPERT_LEAF_KEYS


def placements(parts: Sequence, mesh) -> tuple:
    """The placements of a leaf whose dim d lies on axis ``parts[d]`` (None:
    on no axis; a tuple of names: on all of them, as the serving mesh's
    batch dim on ``("pod", "data")``), one a mesh dim."""
    def dim_of(a):
        for d, p in enumerate(parts):
            if p == a or (isinstance(p, tuple) and a in p):
                return d
        return None

    out = []
    for a in compat.axis_names(mesh):
        d = dim_of(a)
        out.append(Replicate() if d is None else Shard(d))
    return tuple(out)


def params_shardings(params, mesh, *, leading_clients: bool = True,
                     param_mode: str = "fsdp2d",
                     expert_parallel: bool = False):
    """A tree of placements congruent with ``params`` on the
    ``(clients, fsdp, model)`` mesh (reference :63).

    ``leading_clients``: leaf dim 0 is the clients dim, pinned to the
    ``clients`` axis.  ``param_mode``: ``"fsdp2d"`` shards the largest
    remaining dim over ``model`` and the next over ``fsdp`` within a
    client; ``"replicated"`` keeps weights whole within a client.
    ``expert_parallel`` also pins the experts dim of MoE expert weights to
    ``model``.  A dim is sharded only where its size divides the axis
    size.  Leaves may be tensors on any device (``meta`` included) or
    anything with a ``shape``.
    """
    sizes = compat.axis_sizes(mesh)

    def spec_for(path, leaf):
        shape = tuple(leaf.shape)
        parts = [None] * len(shape)
        used = set()
        if leading_clients and shape:
            parts[0] = CLIENTS
            used.add(0)
        if param_mode != "replicated":
            if expert_parallel and _is_expert_leaf(path) and len(shape) >= 3:
                e_dim = len(shape) - 3
                if (e_dim not in used and shape[e_dim] % sizes[MODEL] == 0
                        and shape[e_dim] >= sizes[MODEL]):
                    parts[e_dim] = MODEL
                    used.add(e_dim)
            for axis in (MODEL, FSDP):
                if axis in parts:
                    continue
                d = _best_dim(shape, used, sizes[axis])
                if d is not None:
                    parts[d] = axis
                    used.add(d)
        return placements(parts, mesh)

    return tree_map_with_path(spec_for, params)


def serve_params_shardings(params, mesh, *, expert_parallel: bool = False):
    """Tensor-parallel inference placements on the production mesh
    (reference :122): each weight's largest divisible dim over ``model``,
    replicated over the batch axes (``data`` / ``pod``)."""
    sizes = compat.axis_sizes(mesh)
    n_model = sizes.get(MODEL, 1)

    def spec_for(path, leaf):
        shape = tuple(leaf.shape)
        parts = [None] * len(shape)
        used = set()
        if expert_parallel and _is_expert_leaf(path) and len(shape) >= 3:
            e_dim = len(shape) - 3
            if shape[e_dim] % n_model == 0 and shape[e_dim] >= n_model:
                parts[e_dim] = MODEL
                used.add(e_dim)
        if MODEL not in parts:
            d = _best_dim(shape, used, n_model)
            if d is not None:
                parts[d] = MODEL
        return placements(parts, mesh)

    return tree_map_with_path(spec_for, params)


# ---------------------------------------------------------------------------
# activation (residual-stream) constraints
# ---------------------------------------------------------------------------

def residual_axes(residual_mode: str) -> Tuple[str, ...]:
    """Mesh axes of the residual stream's leading dims per ``MeshConfig.
    residual_mode`` (reference :157): ``"batch_seq"`` batch over ``fsdp``
    and sequence over ``model``; ``"batch"`` batch over ``fsdp`` only."""
    if residual_mode == "batch":
        return (FSDP,)
    if residual_mode == "batch_seq":
        return (FSDP, MODEL)
    raise ValueError(f"unknown residual_mode: {residual_mode!r}")


def leading_dims_constraint(mesh, axes: Sequence[Optional[str]]):
    """Constraint fn placing the first ``len(axes)`` dims of a ``DTensor``
    on ``axes`` (reference :174), the ``residual`` slot step builders
    install in ``repro_torch.dist.context``.  A ``DTensor`` is
    redistributed; a plain tensor (what a rank of the clients mesh holds:
    its own clients' values) and a tensor of fewer dims than ``axes`` pass
    through unchanged."""
    from torch.distributed.tensor import DTensor

    axes = tuple(axes)

    def fn(x):
        if not isinstance(x, DTensor) or x.dim() < len(axes):
            return x
        return x.redistribute(mesh, placements(list(axes), mesh))

    return fn
