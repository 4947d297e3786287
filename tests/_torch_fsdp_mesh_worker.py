"""What the ranks of ``tests/test_torch_fsdp_mesh.py`` run: one world of 8
gloo ranks as the decentralized mesh ``(clients 2, fsdp 2, model 2)``
(``launch.mesh.fake_mesh``), each rank holding its ``(fsdp, model)``
pieces of one client.  ``dist.launch.run_world`` imports this module in
each spawned rank, so it imports torch and the port only, never JAX.

``run`` runs both of these on every rank of the world:

* ``cases``: each case (a lowering, an algorithm, a compute dtype, int8
  compression or none, the residual's layout over model, and the
  weights' layout over the block and activation checkpointing:
  ``MeshConfig.param_mode`` and ``remat``) runs ``ROUNDS``
  rounds of ``launch.steps.build_train_round`` from the saved whole
  initial state (each rank cut to its pieces by its ``ClientShard``, or
  whole under ``"replicated"``),
  returning the rank's pieces of the final state and the collectives by
  phase;
* ``checks``: the gradients of the pieces on one batch (the replicated
  leaves' to be held equal across the model ranks), the state's bytes a
  rank, int8's quantizer on the pieces of a client row against the
  whole row, and the DRO metrics row (``engine.diagnostics.
  dro_metrics_fn`` on the pieces, its sums over the block), and the
  gradients, state bytes and metrics row under ``param_mode=
  "replicated"``;
* ``heads``: one round of ``dense`` on a ``(clients 1, fsdp 1, model
  2)`` mesh over ranks 0 and 1 with ``MeshConfig.attn_heads_sharding``
  off and on (the other ranks only make the groups with them).
"""
import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import (AlgorithmConfig, InputShape,
                                      MeshConfig, MinimaxConfig)
from repro_torch.core import compression, packing
from repro_torch.core import kgt_minimax as kgt
from repro_torch.core import tree as tree_lib
from repro_torch.dist import collectives, compat
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps

ARCH = "qwen2-0.5b"
MESH = (2, 2, 2)


def _cfg():
    return registry.reduced(registry.get_model_config(ARCH))


def _round(inp, impl, algo, dtype, kernels, compress,
           residual="batch_seq", mesh=None, shape=MESH, heads=False,
           **mesh_kw):
    """This rank's round step of a case, and its axes and shard
    (``mesh_kw``: more ``MeshConfig`` fields, ``param_mode`` and
    ``remat``)."""
    n, k, b, s = (inp[f] for f in ("n", "k", "b", "s"))
    mesh = mesh or mesh_lib.fake_mesh(*shape)
    acfg = AlgorithmConfig(**inp["algo"], algorithm=algo, num_clients=n,
                           local_steps=k, mixing_impl=impl,
                           gossip_compress=compress)
    step, axis = steps.build_train_round(
        _cfg(), InputShape("fsdp_mesh", s, b * n, "train"), mesh,
        MeshConfig(num_clients=n, fsdp=shape[1], model=shape[2],
                   residual_mode=residual, attn_heads_sharding=heads,
                   **mesh_kw),
        algo=acfg, minimax=MinimaxConfig(num_groups=inp["g"],
                                         mu=inp["mu"]),
        device="cpu", compute_dtype=getattr(torch, dtype), kernels=kernels)
    return step, axis, acfg


def _pieces(shard, whole, rows):
    """The rank's pieces of the clients ``rows`` of a stacked (n, …)
    parameter dict."""
    per = [shard.take({k: v[i] for k, v in whole.items()})
           for i in range(rows.start, rows.stop)]
    return {k: torch.stack([p[k] for p in per]) for k in per[0]}


def _state(inp, step, axis, compress):
    shard, rows = step.shard, slice(axis.lo, axis.hi)
    st = inp["state"]
    x = _pieces(shard, st["x"], rows)
    ef = [None, None]
    if compress:
        ef = [compression.init_ef(axis.n_local, packing.pack_spec(v).dim,
                                  "cpu") for v in (x, st["y"][rows])]
    return kgt.KGTState(x=x, y=st["y"][rows].clone(),
                        cx=_pieces(shard, st["cx"], rows),
                        cy=st["cy"][rows].clone(), round=0, ef_x=ef[0],
                        ef_y=ef[1])


def run(rank, world, inputs_path, q_path, runs):
    return {"cases": cases(rank, world, inputs_path, runs),
            "checks": checks(rank, world, inputs_path, q_path),
            "heads": heads(rank, world, inputs_path)}


def cases(rank, world, inputs_path, runs):
    inp = torch.load(inputs_path, weights_only=False)
    out = {}
    for name, impl, algo, dtype, kernels, compress, residual, mesh_kw in runs:
        step, axis, _ = _round(inp, impl, algo, dtype, kernels, compress,
                               residual, **mesh_kw)
        state = _state(inp, step, axis, compress)
        rows = slice(axis.lo, axis.hi)
        collectives.zero_collective_counts()
        for batches in inp["batches"]:
            state = step(state, {k: v[:, rows] for k, v in batches.items()},
                         torch.zeros((inp["k"], axis.n_local, 0)))
        out[name] = {"x": state.x, "cx": state.cx, "y": state.y,
                     "cy": state.cy, "clients": [axis.lo, axis.hi],
                     "counts": collectives.collective_counts(),
                     "block": (step.axes.fsdp.rank, step.axes.model.rank)}
    return out


def checks(rank, world, inputs_path, q_path):
    """The gradients of the pieces of the rank's clients on the first
    round's k = 0 batch (f32), the bytes of the rank's state (x, cx, y,
    cy), int8's ``ef_transmit`` on the rank's pieces of a whole client's
    row (``q_path``: a stacked (n, …) dict) with the row max over the
    block, and the metrics row of the initial state on the first round's
    batches (held out: client 0's k = 1 batch)."""
    from repro_torch.engine import diagnostics

    inp = torch.load(inputs_path, weights_only=False)
    step, axis, _ = _round(inp, "dense", "kgt_minimax", "float32", True,
                           None)
    state = _state(inp, step, axis, None)
    rows = slice(axis.lo, axis.hi)
    batch = {k: v[0, rows] for k, v in inp["batches"][0].items()}
    gx, gy = kgt._vgrads(step.problem, state.x, state.y, batch,
                         torch.zeros((axis.n_local, 0)))
    state_bytes = sum(t.numel() * t.element_size() for t in
                      tree_lib.leaves((state.x, state.cx, state.y,
                                       state.cy)))
    v = _pieces(step.shard, torch.load(q_path, weights_only=False), rows)
    spec = packing.pack_spec(v)
    row_max = (lambda t: collectives.all_reduce_max(t, step.axes.block))
    q, e = compression.ef_transmit(packing.pack(v, spec),
                                   torch.zeros((axis.n_local, spec.dim)),
                                   "int8", row_max=row_max)
    metrics = diagnostics.dro_metrics_fn(
        step.problem, _cfg(), num_groups=inp["g"],
        eval_batch={k: v[1, 0] for k, v in inp["batches"][0].items()},
        compute_dtype=torch.float32, axis=axis, shard=step.shard)
    row = metrics(state, {k: v[:, rows] for k, v in
                          inp["batches"][0].items()})
    return {"gx": gx, "gy": gy, "state_bytes": state_bytes, "row": row,
            "q": packing.unpack(q, spec), "e": packing.unpack(e, spec),
            "clients": [axis.lo, axis.hi],
            "block": (step.axes.fsdp.rank, step.axes.model.rank),
            "plan": {k: s is None for k, s in step.shard.plan.items()},
            "replicated": replicated_checks(inp)}


def replicated_checks(inp):
    """Under ``param_mode="replicated"`` (the sequence split over model):
    the gradients of the rank's whole clients on the first round's k = 0
    batch (f32), the bytes of its state and the metrics row of the
    initial state, as :func:`checks` takes them."""
    from repro_torch.engine import diagnostics

    step, axis, _ = _round(inp, "dense", "kgt_minimax", "float32", True,
                           None, param_mode="replicated")
    state = _state(inp, step, axis, None)
    rows = slice(axis.lo, axis.hi)
    batch = {k: v[0, rows] for k, v in inp["batches"][0].items()}
    gx, gy = kgt._vgrads(step.problem, state.x, state.y, batch,
                         torch.zeros((axis.n_local, 0)))
    row = diagnostics.dro_metrics_fn(
        step.problem, _cfg(), num_groups=inp["g"],
        eval_batch={k: v[1, 0] for k, v in inp["batches"][0].items()},
        compute_dtype=torch.float32, axis=axis, shard=step.shard)(
        state, {k: v[:, rows] for k, v in inp["batches"][0].items()})
    return {"gx": gx, "gy": gy, "row": row, "clients": [axis.lo, axis.hi],
            "state_bytes": sum(t.numel() * t.element_size() for t in
                               tree_lib.leaves((state.x, state.cx, state.y,
                                                state.cy)))}


HEADS_MESH = (1, 1, 2)


def heads(rank, world, inputs_path):
    """Ranks 0 and 1: x, cx, y, cy of one round of ``dense`` on the
    (1, 1, 2) mesh over them, with ``attn_heads_sharding`` off and on
    (each a ``{field: tensors}``); None on the other ranks, which make the
    meshes' groups with them."""
    inp = torch.load(inputs_path, weights_only=False)
    out = []
    for flag in (False, True):
        mesh = compat.mesh_of(np.arange(2).reshape(HEADS_MESH),
                              (mesh_lib.CLIENTS, mesh_lib.FSDP,
                               mesh_lib.MODEL), device_type="cpu")
        if rank >= 2:   # the block's group, which train_axes makes
            collectives.sub_axes([[0, 1]], streams=False)
            continue
        step, axis, _ = _round(inp, "dense", "kgt_minimax", "float32", True,
                               None, mesh=mesh, shape=HEADS_MESH, heads=flag)
        state = _state(inp, step, axis, None)
        state = step(state, inp["batches"][0],
                     torch.zeros((inp["k"], axis.n_local, 0)))
        out.append({"x": state.x, "cx": state.cx, "y": state.y,
                    "cy": state.cy})
    return out or None
