"""What the ranks of ``tests/test_torch_fsdp_blocks.py`` run: one world of
8 gloo ranks as a decentralized mesh ``(clients, fsdp, model)`` of each
model's own (``launch.mesh.fake_mesh``; ``(2, 2, 2)`` or ``(1, 2, 4)``),
each rank holding its ``(fsdp, model)`` pieces of its clients of a
reduced model.
``dist.launch.run_world`` imports this module in each spawned rank, so it
imports torch and the port only, never JAX.

``run`` runs both of these on every rank of the world, for each model
(an arch, whether its experts split over model, and its mesh):

* ``cases``: each case (a compute dtype, whether the kernels' plain
  versions run, the residual's layout over model, and for some cases
  ``MeshConfig.remat`` off or ``param_mode="replicated"``) runs the
  inputs' rounds of ``pallas_packed`` through
  ``launch.steps.build_train_round`` from the saved whole initial state
  (each rank cut to its pieces by its ``ClientShard``, or whole under
  ``"replicated"``), returning the
  rank's pieces of the final state and the collectives by phase;
* ``checks``: the gradients of the pieces on one batch (f32), the aux
  loss and per-group losses of client 0's pieces on its fsdp rank's rows
  of that batch (the MoE aux of the whole batch: ``batch_sum``), and the
  DRO metrics row of the initial state (``engine.diagnostics.
  dro_metrics_fn`` on the pieces, its sums over the block counting each
  range that several model ranks hold once).
"""
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import (AlgorithmConfig, InputShape,
                                      MeshConfig, MinimaxConfig)
from repro_torch.core import kgt_minimax as kgt
from repro_torch.dist import collectives
from repro_torch.dist import context as dist_ctx
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import model as model_lib

def cfg_of(arch):
    return registry.reduced(registry.get_model_config(arch))


def _round(inp, arch, ep, shape, dtype, kernels, residual="batch_seq",
           **mesh_kw):
    """This rank's round step of a case on the mesh ``shape``, and its
    axis (``mesh_kw``: more ``MeshConfig`` fields, ``param_mode`` and
    ``remat``)."""
    n, k, b, s = (inp[f] for f in ("n", "k", "b", "s"))
    mesh = mesh_lib.fake_mesh(*shape)
    acfg = AlgorithmConfig(**inp["algo"], num_clients=n, local_steps=k,
                           mixing_impl="pallas_packed")
    return steps.build_train_round(
        cfg_of(arch), InputShape("fsdp_blocks", s, b * n, "train"), mesh,
        MeshConfig(num_clients=n, fsdp=shape[1], model=shape[2],
                   moe_expert_parallel=ep, residual_mode=residual,
                   **mesh_kw),
        algo=acfg, minimax=MinimaxConfig(num_groups=inp["g"], mu=inp["mu"]),
        device="cpu", compute_dtype=getattr(torch, dtype), kernels=kernels)


def _pieces(shard, whole, rows):
    """The rank's pieces of the clients ``rows`` of a stacked (n, …)
    parameter dict."""
    per = [shard.take({k: v[i] for k, v in whole.items()})
           for i in range(rows.start, rows.stop)]
    return {k: torch.stack([p[k] for p in per]) for k in per[0]}


def _state(inp, step, axis):
    shard, rows = step.shard, slice(axis.lo, axis.hi)
    st = inp["state"]
    return kgt.KGTState(x=_pieces(shard, st["x"], rows),
                        y=st["y"][rows].clone(),
                        cx=_pieces(shard, st["cx"], rows),
                        cy=st["cy"][rows].clone(), round=0)


def run(rank, world, models, cases, extra):
    """``models``: (key, arch, expert_parallel, mesh shape, inputs path)
    each; ``cases``: (name, dtype, kernels, residual_mode) each, run for
    every model; ``extra``: {key: [(name, dtype, kernels, residual_mode,
    {MeshConfig field: value}), …]}, more cases of a model."""
    out = {}
    for key, arch, ep, shape, path in models:
        inp = torch.load(path, weights_only=False)
        runs = [c + ({},) for c in cases] + list(extra.get(key, ()))
        out[key] = {"cases": {name: one_case(inp, arch, ep, shape, dtype,
                                             kernels, residual, mesh_kw)
                              for name, dtype, kernels, residual, mesh_kw
                              in runs},
                    "checks": checks(inp, arch, ep, shape)}
    return out


def one_case(inp, arch, ep, shape, dtype, kernels, residual, mesh_kw):
    step, axis = _round(inp, arch, ep, shape, dtype, kernels, residual,
                        **mesh_kw)
    state = _state(inp, step, axis)
    rows = slice(axis.lo, axis.hi)
    collectives.zero_collective_counts()
    for batches in inp["batches"]:
        state = step(state, {k: v[:, rows] for k, v in batches.items()},
                     torch.zeros((inp["k"], axis.n_local, 0)))
    return {"x": state.x, "cx": state.cx, "y": state.y, "cy": state.cy,
            "clients": [axis.lo, axis.hi],
            "counts": collectives.collective_counts(),
            "block": (step.axes.fsdp.rank, step.axes.model.rank)}


def checks(inp, arch, ep, shape):
    """The f32 gradients of the pieces of the rank's clients on the first
    round's k = 0 batch, the (G,) losses and the aux of the rank's first
    client's pieces on its fsdp rank's rows of that batch, and the
    metrics row of the initial state on the first round's batches (held
    out: client 0's k = 1 batch)."""
    from repro_torch.engine import diagnostics

    step, axis = _round(inp, arch, ep, shape, "float32", True)
    state = _state(inp, step, axis)
    rows = slice(axis.lo, axis.hi)
    batch = {k: v[0, rows] for k, v in inp["batches"][0].items()}
    gx, gy = kgt._vgrads(step.problem, state.x, state.y, batch,
                         torch.zeros((axis.n_local, 0)))
    shard = step.shard
    with torch.no_grad(), dist_ctx.residual_constraint(**shard.slots()):
        losses, aux = model_lib.per_group_loss(
            shard.model_of({k: v[0] for k, v in state.x.items()}),
            shard.batch({k: v[0] for k, v in batch.items()}),
            num_groups=inp["g"], compute_dtype=torch.float32)
    row = diagnostics.dro_metrics_fn(
        step.problem, cfg_of(arch), num_groups=inp["g"],
        eval_batch={k: v[1, 0] for k, v in inp["batches"][0].items()},
        compute_dtype=torch.float32, axis=axis, shard=shard)(
        state, {k: v[:, rows] for k, v in inp["batches"][0].items()})
    return {"gx": gx, "gy": gy, "losses": losses, "aux": aux, "row": row,
            "clients": [axis.lo, axis.hi],
            "block": (step.axes.fsdp.rank, step.axes.model.rank),
            "shared": sorted(shard.shared)}
