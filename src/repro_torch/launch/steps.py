"""Step functions of the decentralized training mesh and of the serving
mesh (port of ``repro.launch.steps``).

``build_train_round`` builds one K-GT-Minimax round (K local DRO-minimax
steps, correction, gossip) of this rank's clients on the decentralized
mesh.  The engine's chunks of such rounds (the reference's
``build_train_chunk``, :165) are ``launch.train``'s ``Trainer.build_chunk``
over this round step and the sampler cut to the rank's clients; they run
eagerly (``capture=False``): a gloo collective
cannot be captured in a CUDA graph, and capturing chunks over NCCL is
later work.

The reference jits these programs with the state's clients dim sharded on
the ``clients`` axis and lets GSPMD insert the gossip collectives.  Here
each rank runs its own clients' rows (``dist.collectives.ClientsAxis``)
and the round step issues the collectives itself: none in the K local
steps, the gossips after them (``core.kgt_minimax.make_round_step(axis=)``).
Where the reference swaps the Pallas gossip epilogues for its XLA oracle on
the mesh (:52-59: GSPMD does not split a ``pallas_call`` over the
clients), the port runs its kernels over a rank's rows: ``pallas_packed``
all-gathers (Δ, θ) and runs B1 on the rank's row block of W
(``dist.collectives.gossip_pair``), ``sparse_packed`` exchanges the halo
of neighbour rows its lists read and runs B4 on the remapped table
(``dist.collectives.sparse_gossip_pair``); ``gossip_backend`` follows
``kernels.ops.use_kernel`` as off the mesh.

Where the mesh's ``fsdp`` and ``model`` axes are larger than one, a
client's weights lie over its block of ``fsdp × model`` ranks as the
reference's ``params_shardings`` (``param_mode="fsdp2d"``) lays them out:
over ``model`` by the serving mesh's tensor-parallel plan, in autograd
(Megatron's copy and sum pairs, B6 over the rank's vocabulary piece with
its partial log-sum-exps merged; every block kind, and with
``MeshConfig.moe_expert_parallel`` the MoE experts split over ``model``),
over ``fsdp`` in ZeRO-3 pieces of each model piece, gathered where the
forward reads them, their gradient reduce-scattered; the client's batch
rows split over ``fsdp`` (``dist.tensor_parallel.ClientShard``).  Under
``MeshConfig.residual_mode="batch_seq"`` (the default, as the
reference's) the residual's sequence is split over ``model`` between the
column- and row-parallel pieces (Megatron's sequence parallelism,
``tensor_parallel.SeqSplit``: gathered where it enters a column-parallel
piece, reduce-scattered where a row-parallel output returns); under
``"batch"`` it is whole on every model rank.  The state's x and cx hold
the rank's pieces; every lowering gossips them over the clients axis, the
ranks that hold the same piece of every client.  Under
``param_mode="replicated"`` (``dist.tensor_parallel.ReplicatedShard``)
the weights are whole on every rank of the block, which is data-parallel
over the client's batch rows (and under ``"batch_seq"`` its positions):
each weight's gradient is summed over those ranks, and each rank gossips
the whole client.  ``MeshConfig.remat`` (the default, as the
reference's) runs each unit of the block pattern under activation
checkpointing (``models.transformer.UnitRemat``).

``build_prefill_step`` and ``build_decode_step`` (reference :253, :310)
build one rank's serving steps on a ``launch.mesh.ServeMesh``: the batch
rows split over ``pod × data`` (replicated where that axis does not divide
them, as the reference's ``_maybe`` leaves a batch of 1), the weights over
``model`` as tensor parallelism (``dist.tensor_parallel``).  A prefill's
residual is batch over ``data`` and sequence over ``model``, as the
reference's (:268-270, which GSPMD gathers around attention): each model
rank holds ⌈S/M⌉ positions between the blocks' column- and row-parallel
pieces (``tensor_parallel.SeqSplit``; the last pieces shorter, or empty
where S < M).  A decode step's residual is whole on every model rank, as
the reference's constraint is batch only (:321-322).  A step runs
eagerly: a gloo collective cannot be captured in a CUDA graph.  The
reference's specs of those programs are ported as pure functions
(``_cache_shardings``, ``params_sds``, ``cache_sds``), which
``launch.serve.serve_production`` counts bytes from.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import (AlgorithmConfig, InputShape, MeshConfig,
                                      MinimaxConfig, ModelConfig)
from repro_torch.core import kgt_minimax as kgt
from repro_torch.core import objectives
from repro_torch.core import tree as tree_lib
from repro_torch.dist import collectives, compat
from repro_torch.dist import context as dist_ctx
from repro_torch.dist import sharding as sh
from repro_torch.dist import tensor_parallel as tp
from repro_torch.models import model as model_lib
from repro_torch.models import transformer as tf


def build_train_round(model_cfg: ModelConfig, shape: InputShape, mesh,
                      mcfg: MeshConfig,
                      algo: Optional[AlgorithmConfig] = None,
                      minimax: Optional[MinimaxConfig] = None,
                      lr_scale=None, *, problem=None, device="cuda",
                      compute_dtype=torch.bfloat16, kernels: bool = True,
                      traced_etas: bool = False):
    """``(round_step, axis)``: ``round_step(state, batches, noise) ->
    state`` (with ``traced_etas``, ``round_step(state, batches, noise,
    etas)``: ``core.kgt_minimax.point_etas``' bundle) on this rank's
    (n/R, …) state and (K, n/R, B, S…) batches,
    under the mesh's residual constraint (reference :38-137), ``axis`` the
    rank's clients.  ``problem`` defaults to the DRO problem of
    ``minimax`` in ``compute_dtype`` (``kernels`` as ``dro_problem``'s:
    False runs the plain versions); at ``fsdp × model > 1`` (where no
    other problem is taken) it is that problem on the rank's
    pieces (``dro_problem(shard=)``, x's leaves the rank's pieces of its
    clients), and ``round_step.problem``, ``round_step.axes`` (the
    rank's ``launch.mesh.TrainAxes``) and ``round_step.shard`` (its
    ``ClientShard``; None at one rank a client) give what the state and
    the metrics are built from.  ``mcfg.residual_mode`` splits the
    residual's sequence over ``model`` (``"batch_seq"``) or keeps it whole
    (``"batch"``); ``mcfg.attn_heads_sharding`` runs the same program
    either way (``configs.base.MeshConfig``).  ``mcfg.param_mode``
    ``"fsdp2d"`` lays a client's weights over its block
    (``tp.ClientShard``), ``"replicated"`` keeps them whole on each rank
    of it (``tp.ReplicatedShard``).  ``mcfg.remat`` runs each unit of the
    block pattern under activation checkpointing in the DRO problem the
    round builds (``dro_problem(remat=)``, ``models.transformer.
    UnitRemat``); a ``problem`` passed in carries its own."""
    from repro_torch.launch import mesh as mesh_lib

    algo = algo or AlgorithmConfig(num_clients=mcfg.num_clients)
    algo = dataclasses.replace(algo, num_clients=mcfg.num_clients)
    minimax = minimax or MinimaxConfig()
    n = algo.num_clients
    if shape.global_batch % n:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"over {n} clients")
    axes = mesh_lib.train_axes(mesh, n)
    if problem is not None and axes.block.size > 1:
        raise ValueError(
            "a client split over fsdp × model runs the DRO problem on the "
            "rank's pieces, which the round builds: pass problem=None")
    res_axes = sh.residual_axes(mcfg.residual_mode)
    seq = sh.MODEL in res_axes
    tp.check_train(model_cfg, axes.fsdp.size, axes.model.size,
                   param_mode=mcfg.param_mode,
                   expert_parallel=mcfg.moe_expert_parallel, seq=seq)
    replicated = mcfg.param_mode == "replicated"
    if axes.block.size == 1:
        shard = None
    elif replicated:
        shard = tp.ReplicatedShard(model_cfg, axes.fsdp, axes.model,
                                   axes.block, seq=seq)
    else:
        shard = tp.ClientShard(model_cfg, axes.fsdp, axes.model, axes.block,
                               expert_parallel=mcfg.moe_expert_parallel,
                               seq=seq)
    if problem is None:
        problem = objectives.dro_problem(
            model_cfg, num_groups=minimax.num_groups, mu=minimax.mu,
            compute_dtype=compute_dtype, kernels=kernels, shard=shard,
            remat=mcfg.remat)
    axis = axes.clients
    # int8's per-row max over the pieces of a split client row; a whole
    # client needs none
    round_fn = kgt.make_round_step(problem, algo, lr_scale=lr_scale,
                                   device=device, axis=axis,
                                   block=None if replicated else axes.block,
                                   traced_etas=traced_etas)
    constraint = sh.leading_dims_constraint(mesh, res_axes)

    def round_step(state, batches, noise, *extras):
        with dist_ctx.residual_constraint(constraint):
            return round_fn(state, batches, noise, *extras)

    round_step.uses_round = round_fn.uses_round
    round_step.problem, round_step.axes = problem, axes
    round_step.shard = shard
    return round_step, axis


# ---------------------------------------------------------------------------
# serving (reference :227-353)
# ---------------------------------------------------------------------------

def _serve_batch_axes(mesh):
    return (("pod", "data") if "pod" in compat.axis_names(mesh)
            else "data",)


def _axis_size(mesh, axis) -> int:
    sizes = compat.axis_sizes(mesh)
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= sizes.get(a, 1)
        return n
    return sizes.get(axis, 1)


def _maybe(axis, size: int, mesh):
    """``axis`` if its mesh extent divides ``size``, else None (e.g. batch
    1: replicated)."""
    return axis if size % _axis_size(mesh, axis) == 0 else None


def _bf16_params(tree):
    """Serving parameters are bf16 (inference): every floating leaf."""
    return tree_lib.tree_map(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t, tree)


def batch_rows(mesh, b: int) -> slice:
    """This rank's rows of a batch of ``b``: its piece of the batch axis,
    or every row where the axis does not divide ``b``."""
    axis = _serve_batch_axes(mesh)[0]
    if _maybe(axis, b, mesh) is None:
        return slice(0, b)
    n = b // _axis_size(mesh, axis)
    r = mesh.batch_axis.rank
    return slice(r * n, (r + 1) * n)


@dataclasses.dataclass
class ServeStep:
    """One rank's serving step ``fn`` with what it runs on: the rank's
    shard config, the model axis' plan and the rank's rows of the
    batch."""
    fn: Callable
    cfg: ModelConfig
    plan: Dict[str, Optional[tp.Split]]
    rows: slice

    def __call__(self, *args):
        return self.fn(*args)


def _step(fn, model_cfg: ModelConfig, mesh, b: int) -> ServeStep:
    m, r = mesh.model_axis.size, mesh.model_axis.rank
    return ServeStep(fn, tp.shard_config(model_cfg, m, r),
                     tp.plan(model_cfg, m), batch_rows(mesh, b))


def build_prefill_step(model_cfg: ModelConfig, shape: InputShape, mesh, *,
                       compute_dtype=torch.bfloat16,
                       seq_parallel: bool = True) -> ServeStep:
    """``prefill(params_shard, batch_rows, caches) -> (logits_last,
    caches)`` on this rank (reference :253): ``forward(mode="prefill",
    last_only=True)`` of the rank's shard (``tp.shard_params`` of the
    bf16 parameters) on its rows, the logits of every vocabulary column
    (gathered over ``model``) and the caches of the rank's rows and KV
    heads (``init_cache`` of the step's ``cfg`` at ``shape.seq_len``).
    The residual's sequence is split over ``model`` (the reference's
    layout); ``seq_parallel=False`` keeps it whole on every model rank
    (decode's layout).  The collectives count under the ``prefill``
    phase."""
    skel = tp.shard_skeleton(model_cfg, mesh.model_axis.size,
                             mesh.model_axis.rank)

    def prefill(params_shard, batch, caches):
        with torch.no_grad(), collectives.phase("prefill"), \
                tp.model_parallel(mesh.model_axis, model_cfg,
                                  seq=seq_parallel):
            logits, new_caches, _ = model_lib.call(
                skel, params_shard, model_lib.forward, batch,
                mode="prefill", compute_dtype=compute_dtype, caches=caches,
                last_only=True)
        return logits, new_caches

    return _step(prefill, model_cfg, mesh, shape.global_batch)


def build_decode_step(model_cfg: ModelConfig, shape: InputShape, mesh, *,
                      compute_dtype=torch.bfloat16) -> ServeStep:
    """``decode(params_shard, caches, tokens, pos) -> (logits, caches)`` on
    this rank (reference :310): one ``decode_step`` of the rank's rows
    against caches of ``shape.seq_len``, ``pos`` an int or a (rows,)
    tensor, the residual whole on every model rank.  The collectives
    count under the ``decode`` phase."""
    skel = tp.shard_skeleton(model_cfg, mesh.model_axis.size,
                             mesh.model_axis.rank)

    def decode(params_shard, caches, tokens, pos):
        with torch.no_grad(), collectives.phase("decode"), \
                tp.model_parallel(mesh.model_axis, model_cfg):
            return model_lib.call(skel, params_shard, model_lib.decode_step,
                                  caches, tokens, pos,
                                  compute_dtype=compute_dtype)

    return _step(decode, model_cfg, mesh, shape.global_batch)


def params_sds(model_cfg: ModelConfig):
    """The model's f32 parameters as meta tensors in the reference's tree
    (``init_params``: ``embed``, ``stack`` — per segment, per unit slot,
    each leaf stacked over the segment's repeats —, ``final_norm``,
    ``head``)."""
    skel = model_lib.skeleton(model_cfg)

    def meta(*shape):
        return torch.empty(shape, device="meta")

    out = {"embed": meta(*skel.embed.shape),
           "final_norm": meta(*skel.final_norm.shape)}
    if skel.head is not None:
        out["head"] = meta(*skel.head.shape)
    slots = tf.layer_slots(model_cfg)
    stack = []
    for si, (unit, reps) in enumerate(tf.segments(model_cfg)):
        blocks = []
        for bi in range(len(unit)):
            first = next(layer for layer, (s_, _, b_, _) in
                         zip(skel.layers, slots) if (s_, b_) == (si, bi))
            block: dict = {}
            for name, p in first.named_parameters():
                head, _, leaf = name.partition(".")
                t = meta(reps, *p.shape)
                if leaf:
                    block.setdefault(head, {})[leaf] = t
                else:
                    block[head] = t
            blocks.append(block)
        stack.append(tuple(blocks))
    out["stack"] = tuple(stack)
    return out


def cache_sds(model_cfg: ModelConfig, b: int, s: int, dtype=torch.bfloat16):
    """``init_cache(b, s)`` as meta tensors in the reference's tree: per
    segment, per unit slot, each leaf stacked over the repeats."""
    out = []
    for unit, reps in tf.segments(model_cfg):
        unit_caches = []
        for kind in unit:
            one = model_lib._block_cache(kind, model_cfg, b, s, dtype, "meta")
            unit_caches.append({k: torch.empty((reps, *t.shape),
                                               dtype=t.dtype, device="meta")
                                for k, t in one.items()})
        out.append(tuple(unit_caches))
    return tuple(out)


def _cache_shardings(cache_sds_tree, mesh, batch_axis):
    """Placements of the (reps, B, …) cache leaves (reference :291): the
    batch dim over the batch axes where they divide it; the largest
    trailing dim that the model axis divides over ``model``."""
    n_model = _axis_size(mesh, sh.MODEL)

    def spec(t):
        shp = tuple(t.shape)
        parts = [None] * len(shp)
        if len(shp) >= 2:
            parts[1] = _maybe(batch_axis, shp[1], mesh)
        cands = [(sz, i) for i, sz in enumerate(shp[2:], start=2)
                 if sz % n_model == 0 and sz >= n_model]
        if cands:
            parts[max(cands)[1]] = sh.MODEL
        return sh.placements(parts, mesh)

    return tree_lib.tree_map(spec, cache_sds_tree)


def long_context_variant(model_cfg: ModelConfig) -> ModelConfig:
    """The sub-quadratic variant for long_500k (reference :347): SSM and
    hybrid archs are native; full-attention archs get a 4096-token sliding
    window."""
    if model_cfg.arch_type in ("ssm", "hybrid"):
        return model_cfg
    return dataclasses.replace(model_cfg, long_context_window=4096)
