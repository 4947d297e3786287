"""What the ranks of the port's mesh tests run (``dist.launch.run_world``
imports this module in each rank, so it imports torch and the port only,
never JAX).

* ``collective_cases``: on a world of 4, over sub-groups of 1, 2 and 4
  ranks, the dense, ring and packed gossips of ``dist.collectives`` on the
  inputs of an ``.npz``; each rank returns its output rows and the
  collectives' counts;
* ``train_cases``: ``launch.train --mesh decentralized`` runs fed the
  reference's draws (a ``torch.save`` file; none: each rank draws its
  own from the run's seed), each returning the history, the gathered
  state on rank 0, Σ_i c_i over the ranks and the counts;
* ``round_cases``: ``make_round_step(axis=)`` on the quadratic, each
  lowering on the rank's rows of saved inputs (on a static W or a
  ``topology_cycle``, with static or traced stepsizes), returning the
  rank's rows and the gossip's counts;
* ``world_info``: a rank's place, an all-reduced sum, and whether the
  port's training modules were imported before it ran (by the fork
  server it forked from).
"""
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import tree as tree_lib
from repro_torch.dist import collectives
from repro_torch.dist import sharding as sh

GOSSIP_DTYPES = ("float32", "bfloat16")


def collective_cases(rank, world, npz_path):
    from repro_torch.launch import mesh as mesh_lib

    data = dict(np.load(npz_path))
    out = []
    # the meshes of launch.mesh over this world, and a rank's clients on
    # their clients axis
    local = mesh_lib.local_mesh(device_type="cpu")
    fake = mesh_lib.fake_mesh(2, 2, 1)
    axis = collectives.clients_axis(local, 8)
    # the residual constraint redistributes a DTensor on the fake mesh:
    # batch over fsdp, sequence over model, the values unchanged
    from torch.distributed.tensor import DTensor, Replicate

    x = torch.arange(4 * 6 * 3, dtype=torch.float32).reshape(4, 6, 3)
    dx = DTensor.from_local(x, fake, [Replicate()] * 3)
    pinned = sh.leading_dims_constraint(
        fake, sh.residual_axes("batch_seq"))(dx)
    out.append({"kind": "meshes", "rank": rank,
                "local": (tuple(local.mesh_dim_names),
                          tuple(local.mesh.shape)),
                "fake": (tuple(fake.mesh_dim_names), tuple(fake.mesh.shape),
                         fake.get_local_rank("clients")),
                "axis": (axis.rank, axis.size, axis.lo, axis.hi),
                "placements": [("shard", p.dim) if p.is_shard()
                               else ("replicate",) for p in pinned.placements],
                "values_kept": bool(torch.equal(pinned.full_tensor(), x))})
    # every transfer in pieces over the stream groups, however small
    collectives.STREAM_BYTES = 16
    for size in (1, 2, 4):
        group = dist.new_group(list(range(size)))
        streams = tuple(dist.new_group(list(range(size)))
                        for _ in range(collectives.GLOO_STREAMS - 1))
        if rank >= size:
            continue
        for n in (4, 8):
            axis = collectives.axis_of_group(group, n, streams)
            rows = slice(axis.lo, axis.hi)
            tree = {"a": torch.from_numpy(data[f"a{n}"][rows]),
                    "b": [torch.from_numpy(data[f"b{n}"][rows])]}
            w = torch.from_numpy(data[f"w{n}"])
            ring = torch.from_numpy(data[f"ring{n}"])
            w_self, w_nbr = float(ring[0, 0]), float(ring[0, 1])
            pk = {k: torch.from_numpy(data[f"{k}{n}"][rows])
                  for k in ("dx", "tx", "cx", "dy", "ty", "cy")}
            for gd in GOSSIP_DTYPES:
                for kind in ("dense", "ring", "packed"):
                    collectives.zero_collective_counts()
                    if kind == "dense":
                        got = collectives.mix_dense(
                            tree, w[rows].contiguous(), axis, gd)
                    elif kind == "ring":
                        got = collectives.mix_ring(tree, w_self, w_nbr,
                                                   axis, gd)
                    else:
                        got = collectives.gossip_pair(
                            w[rows].contiguous(),
                            (pk["dx"], pk["tx"], pk["cx"], 0.7, 2.5),
                            (pk["dy"], pk["ty"], pk["cy"], 0.7, -0.5),
                            axis, gd)
                    out.append({"size": size, "n": n, "gd": gd,
                                "kind": kind, "rank": rank,
                                "rows": [axis.lo, axis.hi],
                                "leaves": [t.clone() for t in
                                           tree_lib.leaves(got)],
                                "counts": collectives.collective_counts()})
    return out


def _port_kw(draws, axis_n):
    """``launch.train.build``'s replacements from the saved draws."""
    batches = draws["batches"]

    def sampler(t):
        b = batches[t]
        k = next(iter(b.values())).shape[0]
        return b, torch.zeros((k, axis_n, 0))

    return dict(init_params=draws["init_params"],
                init_batch=draws["init_batch"], sampler=sampler,
                eval_batch=draws["eval_batch"])


def restore_checkpoint(path, trainer):
    """A checkpoint of the whole state (from the host path or the mesh) as
    this rank's rows: restored whole, then sharded to the rank."""
    from repro_torch.checkpoint import checkpoint as ckpt_lib

    axis = trainer.axis
    whole = tree_lib.tree_map(
        lambda x: torch.empty((axis.n, *x.shape[1:]), dtype=x.dtype,
                              device=x.device)
        if isinstance(x, torch.Tensor) else x, trainer.state)
    return collectives.shard_tree(ckpt_lib.restore(path, whole), axis)


def train_cases(rank, world, draws_path, runs):
    """Each run of ``runs``: (name, {train flag: value}, restore).
    ``restore`` None runs ``launch.train.train``; a checkpoint path goes on
    from it to ``rounds`` through ``engine.run``."""
    from repro_torch import engine as engine_lib
    from repro_torch.dist import context as dist_ctx
    from repro_torch.launch import train as train_lib

    draws = (None if draws_path is None
             else torch.load(draws_path, weights_only=False))
    group = dist.group.WORLD
    out = {}
    for name, over, restore in runs:
        args = train_lib.parser().parse_args(["--arch", over["arch"]])
        for k, v in over.items():
            setattr(args, k, v)
        axis = collectives.axis_of_group(group, args.clients)
        kw = {} if draws is None else _port_kw(draws, args.clients)
        collectives.zero_collective_counts()
        # every residual constraint the model applies inside the round
        calls = {"residual": 0}
        real = sh.leading_dims_constraint

        def counting(mesh, axes):
            fn = real(mesh, axes)

            def count(x):
                calls["residual"] += 1
                return fn(x)

            return count

        sh.leading_dims_constraint = counting
        try:
            if restore is None:
                res = train_lib.train(args, **kw)
                state, history = res["state"], res["history"]
            else:
                trainer = train_lib.build(args, **kw)
                state = restore_checkpoint(restore, trainer)
                trainer.state = None
                state, history = engine_lib.run(
                    state, trainer.build_chunk(args),
                    total_rounds=args.rounds, chunk_rounds=args.rounds)
        finally:
            sh.leading_dims_constraint = real
        counts = collectives.collective_counts()
        with collectives.phase("check"):
            sums = {f: [collectives.all_reduce_sum(
                c.double().sum(0), axis) for c in tree_lib.leaves(
                    getattr(state, f))] for f in ("cx", "cy")}
            whole = collectives.gather_tree(state, axis)
        out[name] = {"history": history, "counts": counts,
                     "clients": [axis.lo, axis.hi],
                     "residual_calls": calls["residual"],
                     "outside_slots": dict(dist_ctx.current_slots()),
                     "c_sums": sums if rank == 0 else None,
                     "state": whole if rank == 0 else None}
    return out


def round_cases(rank, world, inputs_path, cases):
    """The round level of ``tests/test_torch_mesh_lowerings.py``: each case
    (impl, compress, algorithm, gossip dtype, topology, n[, cycle,
    traced]) runs its ``make_round_step(axis=)`` on this rank's rows of
    the saved inputs (quadratic data, initial state and noise of each n),
    the inputs' rounds — or, with a ``topology_cycle`` ``cycle``, twice
    its length in rounds, the noise taken in turn; ``traced``: the
    stepsizes passed as ``point_etas``' bundle (``traced_etas=True``).
    Returns the rank's rows of the final state, Σ_i c_i of its rows and
    the gossip's collectives by kind."""
    from repro_torch.configs import AlgorithmConfig
    from repro_torch.core import kgt_minimax as kgt
    from repro_torch.core.objectives import quadratic_problem

    inputs = torch.load(inputs_path, weights_only=False)
    out = []
    for case in cases:
        impl, compress, algo, gd, topology, n, *opt = case
        cycle, traced = opt or ((), False)
        inp = inputs[n]
        axis = collectives.axis_of_group(dist.group.WORLD, n)
        rows = slice(axis.lo, axis.hi)
        prob = quadratic_problem(inp["data"], sigma=inp["sigma"])
        cfg = AlgorithmConfig(**inp["cfg"], algorithm=algo, num_clients=n,
                              topology=topology, mixing_impl=impl,
                              gossip_dtype=gd, gossip_compress=compress,
                              topology_cycle=cycle)
        step = kgt.make_round_step(prob, cfg, device="cpu", axis=axis,
                                   traced_etas=traced)
        etas = (kgt.point_etas(cfg),) if traced else ()
        state = collectives.shard_tree(inp["state"][(algo, compress)], axis)
        batches = {k: v[:, rows] for k, v in inp["batches"].items()}
        noises = inp["noise"]
        collectives.zero_collective_counts()
        for t in range(2 * len(cycle) if cycle else len(noises)):
            state = step(state, batches, noises[t % len(noises)][:, rows],
                         *etas)
        counts = collectives.collective_counts()
        out.append({
            "case": tuple(case),
            "rows": [axis.lo, axis.hi],
            "state": {f: getattr(state, f) for f in ("x", "y", "cx", "cy",
                                                     "ef_x", "ef_y")},
            "c_sums": {f: getattr(state, f).double().sum(0)
                       for f in ("cx", "cy")},
            "gossip": {k: (v["calls"], v["bytes"])
                       for k, v in counts.get("gossip", {}).items()},
            "local_steps": counts.get("local_steps", {})})
    return out


def world_info(rank, world):
    preloaded = "repro_torch.launch.train" in sys.modules
    x = torch.tensor([float(rank + 1)])
    dist.all_reduce(x)
    return {"rank": rank, "world": world, "sum": x.item(),
            "preloaded": preloaded}
