"""Smoke run of the decentralized training mesh and of the serving mesh on
CPU worlds (port of the train and serving legs of ``repro.launch.smoke``).

For each reduced architecture:

* train legs, on a gloo world of 2 ranks (the clients axis of a
  ``(clients=2, 1, 1)`` mesh, one client a rank): one decentralized
  K-GT-Minimax round through ``launch.train`` on ``dense`` and on
  ``pallas_packed``, printing ``train round ran`` and ``packed-gossip
  train round ran``;
* the reference's train legs (reference :47-98), on a gloo world of 8
  ranks as ``(clients=2, fsdp=2, model=2)``: one round through
  ``launch.steps.build_train_round`` on ``dense``, ``pallas_packed`` and
  ``sparse_packed``, each client's weights over its ``(fsdp, model)``
  block, each unit of the stack under activation checkpointing
  (``MeshConfig``'s default ``remat=True``, as the reference's smoke
  builds it), the reference's train shape (4 rows of 64 tokens),
  printing the
  reference's ``train round``, ``packed-gossip train round`` and
  ``sparse-gossip train round``, each ``ran on (clients 2, fsdp 2, model
  2)``, for every arch (a MoE arch with ``moe_expert_parallel``, as the
  reference sets it, :47-48);
* the serving leg, on a gloo world of 4 ranks at ``(data 2, model 2)``
  for every arch, as the reference runs every arch at ``(4, 2)``
  (reference :164-180): one prefill step and one decode step through
  ``launch.steps`` on the reference's smoke shape (8 rows of 64 tokens),
  printing ``prefill+decode ran on (data 2, model 2)``.

Exit code 0 iff every leg ran.  The sweep-cell leg waits for a later slice
of the mesh (ROADMAP A6).

  PYTHONPATH=src python -m repro_torch.launch.smoke [--archs qwen2-0.5b ...]
      [--legs train fsdp serve]
  PYTHONPATH=src python -m repro_torch.launch.smoke --legs serve \\
      --archs mamba2-1.3b recurrentgemma-9b
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time
import traceback

from repro_torch.configs import registry

WORLD = 2
LEGS = (("dense", "train round"), ("pallas_packed", "packed-gossip train "
                                   "round"))
# the reference's train legs: a world of FSDP_WORLD ranks as FSDP_MESH
# (clients, fsdp, model), its train shape (reference :36: 4 rows of 64
# tokens, 2 clients) and its three lowerings
FSDP_WORLD, FSDP_MESH, FSDP_BATCH, FSDP_SEQ = 8, (2, 2, 2), 4, 64
FSDP_LEGS = (("dense", "train round"),
             ("pallas_packed", "packed-gossip train round"),
             ("sparse_packed", "sparse-gossip train round"))
# the serving leg: a world of SERVE_WORLD ranks as a SERVE_MESH (data,
# model) mesh, the reference's smoke serving shape (8 rows of 64 tokens;
# its decode step at position 64)
SERVE_WORLD, SERVE_MESH, SERVE_BATCH, SERVE_SEQ = 4, (2, 2), 8, 64


def _leg(arch: str, impl: str) -> None:
    from repro_torch.launch import train as train_lib

    args = train_lib.parser().parse_args([
        "--arch", arch, "--reduced", "--device", "cpu",
        "--mesh", "decentralized", "--clients", str(WORLD),
        "--local-steps", "2", "--batch", "2", "--seq-len", "64",
        "--groups", "4", "--rounds", "1", "--log-every", "1",
        "--engine", "host", "--mixing-impl", impl])
    rec = train_lib.train(args)["history"][-1]
    if not all(float(rec[k]) == float(rec[k]) for k in ("f_bar",
                                                         "mean_loss")):
        raise FloatingPointError(f"non-finite row {rec}")


def _legs(rank: int, world: int, archs) -> list:
    """Every leg on this rank; rank 0 prints each line."""
    results = []
    for arch in archs:
        for impl, what in LEGS:
            t0 = time.perf_counter()
            try:
                _leg(arch, impl)
                ok, line = True, f"{what} ran ({time.perf_counter() - t0:.1f}s)"
            except Exception as e:  # a leg's failure is reported, not fatal
                ok, line = False, (f"{what} FAILED: {type(e).__name__}: {e}"
                                   f"\n{traceback.format_exc()}")
            if rank == 0:
                print(f"[smoke] {arch}: {line}", flush=True)
            results.append(ok)
    return results


def _fsdp_leg(arch: str, impl: str, mesh) -> None:
    """One round of ``impl`` on the ``(clients, fsdp, model)`` mesh from
    ``init_state``, on random tokens; its state must be finite."""
    import torch

    from repro_torch.configs.base import (AlgorithmConfig, InputShape,
                                          MeshConfig, MinimaxConfig)
    from repro_torch.core import kgt_minimax as kgt
    from repro_torch.core import tree as tree_lib
    from repro_torch.launch import steps

    cfg = registry.reduced(registry.get_model_config(arch))
    c, f, m = FSDP_MESH
    k, g = 2, 4
    algo = AlgorithmConfig(num_clients=c, local_steps=k, mixing_impl=impl)
    step, axis = steps.build_train_round(
        cfg, InputShape("smoke_train", FSDP_SEQ, FSDP_BATCH, "train"), mesh,
        MeshConfig(num_clients=c, fsdp=f, model=m,
                   moe_expert_parallel=bool(cfg.moe.num_experts)),
        algo=algo, minimax=MinimaxConfig(num_groups=g), device="cpu")
    gen = torch.Generator().manual_seed(0)
    shape = (k, c, FSDP_BATCH // c, FSDP_SEQ)
    batches = {"tokens": torch.randint(0, cfg.vocab_size, shape,
                                       generator=gen),
               "labels": torch.randint(0, cfg.vocab_size, shape,
                                       generator=gen),
               "groups": torch.randint(0, g, shape, generator=gen)}
    state = kgt.init_state(step.problem, algo, gen,
                           init_batch={n: b[0] for n, b in batches.items()},
                           axis=axis)
    rows = slice(axis.lo, axis.hi)
    state = step(state, {n: b[:, rows] for n, b in batches.items()},
                 torch.zeros((k, axis.n_local, 0)))
    if not all(bool(t.isfinite().all()) for t in tree_lib.leaves(
            (state.x, state.y, state.cx, state.cy))):
        raise FloatingPointError("a state leaf is not finite")


def _fsdp_legs(rank: int, world: int, archs) -> list:
    """The reference's train legs of every arch on this rank; rank 0
    prints each line."""
    from repro_torch.launch import mesh as mesh_lib

    mesh = mesh_lib.fake_mesh(*FSDP_MESH)
    where = "(clients {}, fsdp {}, model {})".format(*FSDP_MESH)
    results = []
    for arch in archs:
        for impl, what in FSDP_LEGS:
            t0 = time.perf_counter()
            try:
                _fsdp_leg(arch, impl, mesh)
                ok, line = True, (f"{what} ran on {where} "
                                  f"({time.perf_counter() - t0:.1f}s)")
            except Exception as e:  # a leg's failure is reported, not fatal
                ok, line = False, (f"{what} FAILED on {where}: "
                                   f"{type(e).__name__}: {e}"
                                   f"\n{traceback.format_exc()}")
            if rank == 0:
                print(f"[smoke] {arch}: {line}", flush=True)
            results.append(ok)
    return results


def _serve_leg(arch: str, mesh) -> None:
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.dist import tensor_parallel as tp
    from repro_torch.launch import steps
    from repro_torch.models import model as model_lib

    cfg = registry.reduced(registry.get_model_config(arch))
    gen = torch.Generator().manual_seed(0)
    full = model_lib.param_dict(model_lib.init_params(
        cfg, generator=gen, device="cpu", dtype=torch.bfloat16))
    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_SEQ, *cb),
                           generator=gen)
    pre = steps.build_prefill_step(
        cfg, InputShape("smoke_serve", SERVE_SEQ, SERVE_BATCH, "prefill"),
        mesh)
    dec = steps.build_decode_step(
        cfg, InputShape("smoke_serve", SERVE_SEQ + 1, SERVE_BATCH, "decode"),
        mesh)
    shard = tp.shard_params(full, pre.plan, mesh.model_axis.rank)
    batch = {"tokens": tokens[pre.rows]}
    if cfg.num_prefix_tokens:
        batch["prefix"] = torch.randn(
            (SERVE_BATCH, cfg.num_prefix_tokens, cfg.d_model),
            generator=gen)[pre.rows]
    caches = model_lib.init_cache(pre.cfg, pre.rows.stop - pre.rows.start,
                                  SERVE_SEQ, device="cpu")
    logits, caches = pre(shard, batch, caches)
    caches = model_lib.grow_caches(pre.cfg, caches, SERVE_SEQ + 1)
    logits, caches = dec(shard, caches, logits[:, -1:].argmax(-1),
                         SERVE_SEQ)
    if not bool(logits.float().isfinite().all()):
        raise FloatingPointError("non-finite decode logits")


def _serve_legs(rank: int, world: int, archs) -> list:
    """The serving leg of every arch on this rank, each as ``(ok,
    line)``; rank 0 prints the lines."""
    from repro_torch.launch import mesh as mesh_lib

    mesh = mesh_lib.fake_serve_mesh(*SERVE_MESH)
    where = f"(data {SERVE_MESH[0]}, model {SERVE_MESH[1]})"
    results = []
    for arch in archs:
        t0 = time.perf_counter()
        try:
            _serve_leg(arch, mesh)
            ok, line = True, (f"prefill+decode ran on {where} "
                              f"({time.perf_counter() - t0:.1f}s)")
        except Exception as e:  # a leg's failure is reported, not fatal
            ok, line = False, (f"serve FAILED: {type(e).__name__}: {e}"
                               f"\n{traceback.format_exc()}")
        if rank == 0:
            print(f"[smoke] {arch}: {line}", flush=True)
        results.append((ok, line))
    return results


def main(argv=None) -> int:
    from repro_torch.dist import launch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--archs", nargs="*", default=["qwen2-0.5b"],
                    choices=sorted(registry.ARCHS))
    ap.add_argument("--legs", nargs="*", default=["train", "fsdp", "serve"],
                    choices=["train", "fsdp", "serve"])
    args = ap.parse_args(argv)
    results = []
    with tempfile.TemporaryDirectory() as store:
        if "train" in args.legs:
            print(f"[smoke] a gloo world of {WORLD} ranks on the CPU",
                  flush=True)
            results += launch.run_world(WORLD, _legs, args.archs,
                                        backend="gloo", store_dir=store)
        if "fsdp" in args.legs:
            print(f"[smoke] a gloo world of {FSDP_WORLD} ranks on the CPU",
                  flush=True)
            results += launch.run_world(FSDP_WORLD, _fsdp_legs, args.archs,
                                        backend="gloo", store_dir=store)
        if "serve" in args.legs:
            print(f"[smoke] a gloo world of {SERVE_WORLD} ranks on the CPU",
                  flush=True)
            results += [[ok for ok, _ in legs] for legs in launch.run_world(
                SERVE_WORLD, _serve_legs, args.archs, backend="gloo",
                store_dir=store)]
    return 0 if all(all(r) for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
