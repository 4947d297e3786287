"""Decentralized K-GT-Minimax training entry point (port of
``repro.launch.train``).

Federated DRO training of a language model over heterogeneous synthetic
clients: ``core.objectives.dro_problem`` over the selected architecture,
data from ``data.synthetic`` drawn per round by ``engine.make_dro_sampler``,
round-indexed lr schedules, checkpoints and streaming diagnostics
(``engine.dro_metrics_fn``).  The training state holds one parameter dict
per client stacked along a leading clients dim; each local step's
per-client gradients are ``vmap(grad)`` of the DRO value, and on the card
every forward runs the flash-attention (B5) and fused cross-entropy (B6)
kernels, differentiated through their autograd Functions.

``--engine scan`` (the default) runs ``engine.run`` over chunks of
``--chunk`` rounds, each captured as one CUDA graph on the card and
replayed; ``--engine host`` is the per-round loop (same sampler, same
metrics, eager), the A/B reference.  It runs on the card unless given
``--device cpu``.  The captured chunks take the state over (the engine's
``donate``): it lives on the card once, in the graphs' static buffers,
beside their memory pool.  On the card the run ends by printing its peak
device memory.  The persistent compile cache (``--compile-cache``) is not
ported (ROADMAP A8) and raises.

``--mesh decentralized`` spreads the n clients over the R ranks of a
``torch.distributed`` world (``launch.steps``): each rank holds n/R
clients, runs their K local steps (B5 and B6 on its card), and the round's
gossips are the only collectives (``dist.collectives``): every
``--mixing-impl`` on a static W, ``sparse_packed`` and the robust rules
over a halo exchange of neighbour rows, ``pallas_packed`` (also with
``--gossip-compress``) over an all-gather, B1 and B4 on a rank's rows on
the card.  Every rank draws
the host path's data and initial state and keeps its rows, computes the
same metrics row from all-reduced means, and rank 0 prints the rows and
writes ``--out`` and the checkpoints, gathered to the host path's file
format (a mesh checkpoint resumes on the host path and the reverse), and
``--telemetry-out``'s stream, whose health gauges every rank sums over
the clients axis (``obs.health_gauges(axis=)``).
Chunks run eagerly on the mesh (``capture=off (mesh)``).  Rank r runs on
``cuda:(LOCAL_RANK mod device_count)`` over ``--dist-backend`` (``nccl``
on the card, ``gloo`` on the CPU; two ranks on one card need gloo).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --rounds 48 --chunk 16 --log-every 16
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --engine host
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --reduced --device cpu --clients 2 --local-steps 2 --batch 2 \\
      --seq-len 32 --groups 4 --rounds 6
  PYTHONPATH=src torchrun --standalone --nproc-per-node=2 \\
      -m repro_torch.launch.train --mesh decentralized --arch qwen2-0.5b \\
      --reduced --device cpu --clients 4 --local-steps 2 --batch 2 \\
      --seq-len 32 --groups 4 --rounds 2 --log-every 1
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import engine as engine_lib
from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.configs import registry
from repro_torch.configs.base import (AlgorithmConfig, InputShape, MeshConfig,
                                      MinimaxConfig, ModelConfig)
from repro_torch.core import adversary as adversary_lib
from repro_torch.core import kgt_minimax as kgt
from repro_torch.core import mixing as mixing_lib
from repro_torch.core import objectives, topology
from repro_torch.core import sparse_topology as sparse_lib
from repro_torch.core import stochastic_topology as stoch_lib
from repro_torch.core import tree as tree_lib
from repro_torch.core.compression import COMPRESS_METHODS
from repro_torch.data import synthetic as data_lib
from repro_torch.dist import collectives
from repro_torch.dist import launch as dist_launch
from repro_torch.kernels.ops import GOSSIP_BACKENDS
from repro_torch.optim import schedules

# the generator streams of one seed (engine.stream_seed(seed, stream)): the
# reference splits its key into the data model's, the initial state's and
# the sampler's, and folds 1 and 2 into the data key for the initial and
# held-out batches
DATA_STREAM, INIT_STREAM, SAMPLER_STREAM = 0, 1, 2
INIT_BATCH_STREAM, EVAL_BATCH_STREAM = 3, 4

# (key, format) pairs rendered when present (reference :47)
_RECORD_FORMATS = (
    ("f_bar", "f(x̄,ȳ)={:.4f}"),
    ("phi_grad_norm", "‖∇Φ‖={:.4f}"),
    ("mean_loss", "ℓ̄={:.4f}"),
    ("eval_loss", "ℓ_eval={:.4f}"),
    ("consensus_x", "Ξx={:.3e}"),
    ("y_bar_norm", "|ȳ|={:.3f}"),
)


def _format_record(rec: dict) -> str:
    parts = []
    if "round" in rec:
        parts.append(f"round {int(rec['round']):4d}")
    for key, fmt in _RECORD_FORMATS:
        if key in rec:
            parts.append(fmt.format(rec[key]))
    parts.append(f"({round(rec.get('wall_s', 0), 3)}s)")
    return "[train] " + "  ".join(parts)


def _stderr_event_format(event: dict):
    """The console view of the telemetry stream: metric rows as the
    reference prints them; everything else stays JSONL-only."""
    if event.get("type") != "metrics":
        return None
    return _format_record(
        {k: v for k, v in event.items() if k not in ("v", "type", "t")})


def _build_telemetry(args, algo, cfg, state):
    """(telemetry, ledger, profiler) from the flags: the stderr sink always
    (the console rows); the JSONL sink, the communication ledger and the
    health gauges with ``--telemetry-out``; the profiler with
    ``--profile-dir``."""
    from repro_torch import obs

    tel_path = getattr(args, "telemetry_out", None)
    sinks = [obs.StderrSink(_stderr_event_format)]
    ledger = None
    if tel_path:
        sinks.append(obs.JsonlSink(tel_path))
        ledger = obs.ledger_for_state(algo, state)
    telemetry = obs.Telemetry(sinks)
    profile_dir = getattr(args, "profile_dir", None)
    profiler = (obs.Profiler(profile_dir,
                             num_rounds=getattr(args, "profile_rounds", 0))
                if profile_dir else None)
    if tel_path:
        telemetry.meta(
            "train", arch=cfg.name, algorithm=algo.algorithm,
            n=algo.num_clients, local_steps=algo.local_steps,
            topology=algo.topology, mixing_impl=algo.mixing_impl,
            gossip_dtype=algo.gossip_dtype,
            gossip_compress=algo.gossip_compress,
            num_byzantine=algo.num_byzantine, attack=algo.attack,
            participation=algo.participation_rate,
            rounds=args.rounds, seed=args.seed,
            ledger=ledger.describe())
    return telemetry, ledger, profiler


def algorithm_config(args) -> AlgorithmConfig:
    """The ``AlgorithmConfig`` of the flags (reference :186).  A
    programmatic caller may set ``args.topology_cycle`` (no flag, as the
    reference's CLI has none)."""
    seed = getattr(args, "topology_seed", None)
    return AlgorithmConfig(
        algorithm=args.algorithm,
        num_clients=args.clients,
        local_steps=args.local_steps,
        eta_cx=args.eta_cx,
        eta_cy=args.eta_cy,
        eta_sx=args.eta_s,
        eta_sy=args.eta_s,
        topology=args.topology,
        mixing_impl=args.mixing_impl,
        gossip_dtype=args.gossip_dtype,
        # getattr: programmatic callers (tests) build a bare Namespace
        gossip_backend=getattr(args, "gossip_backend", "auto"),
        gossip_compress=(None if getattr(args, "gossip_compress", None)
                         in (None, "none") else args.gossip_compress),
        topology_family=getattr(args, "topology_family", "static"),
        edge_prob=getattr(args, "edge_prob", 0.5),
        client_drop_prob=getattr(args, "client_drop_prob", 0.3),
        participation_rate=getattr(args, "participation", 1.0),
        topology_seed=seed if seed is not None else args.seed,
        num_byzantine=getattr(args, "num_byzantine", 0),
        attack=getattr(args, "attack", "sign_flip"),
        attack_scale=getattr(args, "attack_scale", 1.0),
        robust_trim=getattr(args, "robust_trim", 1),
        topology_cycle=tuple(getattr(args, "topology_cycle", ()) or ()),
    )


def _check_unported(args) -> None:
    if getattr(args, "compile_cache", None) is not None:
        raise NotImplementedError(
            "--compile-cache: the persistent compile cache "
            "(repro.sweep.cache) is not ported yet (ROADMAP A8)")


def _check_mesh(args, algo: AlgorithmConfig, problem) -> None:
    """The reference's refusals on the mesh (:254-258) and of the
    lowering on the problem (``fused_round`` needs an ``affine_coeffs``
    oracle, which the DRO problem has not), then a world to run on."""
    if (algo.topology_family != "static" or algo.participation_rate < 1.0
            or algo.num_byzantine > 0):
        raise ValueError(
            "--topology-family/--participation/--num-byzantine are not "
            "supported with --mesh decentralized yet (the sharded chunk "
            "builder bakes a static W); run on the host mesh")
    kgt.check_impl_options(problem, algo)
    if not dist.is_initialized():
        raise RuntimeError(
            "--mesh decentralized runs on a torch.distributed world: start "
            "it under torchrun (python -m repro_torch.launch.train does "
            "that for itself), or call train() in the ranks of "
            "repro_torch.dist.launch.run_world")


def lr_schedule(args) -> Optional[Callable[[int], float]]:
    """The round step's ``lr_scale``: None where the schedule is 1 every
    round (constant, no warmup), so the step does not read the round and
    one captured chunk serves every start."""
    if args.schedule == "constant" and not args.warmup:
        return None
    return schedules.get_schedule(args.schedule, args.rounds, args.warmup)


@dataclasses.dataclass
class Trainer:
    """What ``train`` runs: the built pieces, for callers that drive the
    engine themselves (eager against captured chunks, resumes)."""
    cfg: ModelConfig
    algo: AlgorithmConfig
    data: data_lib.DataModel
    problem: Any
    state: kgt.KGTState
    round_step: Callable
    sampler: Callable
    eval_batch: Dict[str, torch.Tensor]
    metrics_fn: Callable
    device: str
    # this rank's clients on the decentralized mesh (None: the host path)
    axis: Optional[collectives.ClientsAxis] = None

    def build_chunk(self, args, *, capture: Optional[bool] = None):
        """The scan engine's chunks; captured ones take over the state
        they are given (``donate``).  On the mesh (the reference's
        ``steps.build_train_chunk``) chunks run eagerly."""
        if self.axis is not None:
            if capture:
                raise NotImplementedError(
                    "captured chunks on the decentralized mesh are not "
                    "ported yet (ROADMAP A5)")
            capture = False
        return engine_lib.make_chunk_builder(
            self.round_step, self.sampler, self.metrics_fn,
            log_every=args.log_every, capture=capture, donate=True)


def build(args, *, init_params: Optional[Dict[str, torch.Tensor]] = None,
          init_batch: Optional[Dict[str, torch.Tensor]] = None,
          sampler: Optional[Callable] = None,
          eval_batch: Optional[Dict[str, torch.Tensor]] = None) -> Trainer:
    """The model, data, problem, initial state, round step, sampler and
    metrics of a run (reference :183-291).  The keyword arguments replace
    a draw: the shared initial parameters (one client's parameter dict),
    the (n, B, S) batch the corrections start from, the per-round sampler
    and the held-out batch (the parity tests feed the reference's arrays
    through them)."""
    _check_unported(args)
    device = getattr(args, "device", "cuda")
    cfg = registry.get_model_config(args.arch)
    if args.reduced:
        cfg = registry.reduced(cfg)
    algo = algorithm_config(args)
    random_w = algo.topology_family != "static"
    part = algo.participation_rate < 1.0
    byz = algo.num_byzantine > 0
    n = algo.num_clients
    on_mesh = getattr(args, "mesh", "host") == "decentralized"
    problem = objectives.dro_problem(cfg, num_groups=args.groups, mu=args.mu)
    if on_mesh:
        _check_mesh(args, algo, problem)

    def gen_of(stream: int) -> torch.Generator:
        g = torch.Generator(device=device)
        g.manual_seed(engine_lib.stream_seed(args.seed, stream))
        return g

    dm = data_lib.make_data_model(
        vocab_size=cfg.vocab_size, num_groups=args.groups, num_clients=n,
        alpha=args.alpha, seed=engine_lib.stream_seed(args.seed, DATA_STREAM),
        device=device)
    if init_params is not None:
        problem = dataclasses.replace(problem, init_x=lambda gen: init_params)
    axis = None
    if on_mesh:
        round_step, axis = mesh_round(args, cfg, algo, problem, device)
    if init_batch is None:
        init_batch = {k: v[0] for k, v in data_lib.round_batches(
            dm, gen_of(INIT_BATCH_STREAM), local_steps=1, num_clients=n,
            per_client_batch=args.batch, seq_len=args.seq_len,
            cfg=cfg).items()}
    state = kgt.init_state(problem, algo, gen_of(INIT_STREAM),
                           init_batch=init_batch, axis=axis)
    del init_batch

    # the per-round sampler (a pure function of the round index) and one
    # fixed held-out eval batch: logged train metrics use the round's own
    # data, eval metrics data the optimizer never sees
    if sampler is None:
        sampler = engine_lib.make_dro_sampler(
            dm, engine_lib.stream_seed(args.seed, SAMPLER_STREAM),
            local_steps=algo.local_steps, num_clients=n,
            per_client_batch=args.batch, seq_len=args.seq_len, cfg=cfg)
    if random_w or part or byz:
        # churn and adversary axes ride the sampler slot: per-round W,
        # participation mask and attack drawn from the round index
        w_fn = mask_fn = attack_fn = None
        if random_w:
            if algo.mixing_impl.startswith("sparse_"):
                support = sparse_lib.sparse_mixing_matrix(algo.topology, n)
                w_fn = sparse_lib.make_sparse_w_sampler(
                    algo.topology_family, support, algo.topology_seed,
                    edge_prob=algo.edge_prob,
                    client_drop_prob=algo.client_drop_prob, device=device)
            else:
                base_w = (topology.mixing_matrix(algo.topology, n)
                          if algo.topology_family == "dropout" else None)
                w_fn = stoch_lib.make_w_sampler(
                    algo.topology_family, n, algo.topology_seed,
                    base_w=base_w, edge_prob=algo.edge_prob,
                    client_drop_prob=algo.client_drop_prob, device=device)
        if part:
            mask_fn = stoch_lib.make_participation_sampler(
                n, algo.topology_seed, algo.participation_rate,
                device=device)
        if byz:
            attack_fn = adversary_lib.make_attack_sampler(
                n, algo.topology_seed, num_byzantine=algo.num_byzantine,
                attack=algo.attack, scale=algo.attack_scale,
                like=(state.x, state.y), device=device)
        sampler = engine_lib.with_topology(
            sampler, w_fn=w_fn, mask_fn=mask_fn, attack_fn=attack_fn)
    if eval_batch is None:
        eval_batch = engine_lib.held_out_eval_batch(
            dm, gen_of(EVAL_BATCH_STREAM), num_clients=n,
            per_client_batch=args.batch, seq_len=args.seq_len, cfg=cfg)
    metrics_fn = engine_lib.dro_metrics_fn(
        problem, cfg, num_groups=args.groups, eval_batch=eval_batch,
        axis=axis)
    if axis is not None:
        # every rank draws the whole round and keeps its clients' rows
        sampler = engine_lib.slice_clients(sampler, axis.lo, axis.hi)
    else:
        round_step = kgt.make_round_step(
            problem, algo, lr_scale=lr_schedule(args), traced_w=random_w,
            participation=part, byzantine=byz, device=device)
    return Trainer(cfg=cfg, algo=algo, data=dm, problem=problem, state=state,
                   round_step=round_step, sampler=sampler,
                   eval_batch=eval_batch, metrics_fn=metrics_fn,
                   device=device, axis=axis)


def mesh_round(args, cfg: ModelConfig, algo: AlgorithmConfig, problem,
               device, *, traced_etas: bool = False):
    """``(round_step, axis)`` of this rank on the ``(clients, 1, 1)`` mesh
    over the world, weights whole within a client (reference
    :149-180); ``traced_etas`` as ``launch.steps.build_train_round``'s
    (the stepsizes as ``core.kgt_minimax.point_etas``' bundle, an operand
    of the round)."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as steps_lib

    n = algo.num_clients
    mesh = mesh_lib.local_mesh(device_type=torch.device(device).type)
    mcfg = MeshConfig(num_clients=n, fsdp=1, model=1,
                      param_mode="replicated", remat=False)
    shape = InputShape(name="train_cli", seq_len=args.seq_len,
                       global_batch=args.batch * n, kind="train")
    return steps_lib.build_train_round(
        cfg, shape, mesh, mcfg, algo=algo,
        minimax=MinimaxConfig(num_groups=args.groups, mu=args.mu),
        lr_scale=None if traced_etas else lr_schedule(args),
        problem=problem, device=device, traced_etas=traced_etas)


def save_checkpoint(path: str, state: kgt.KGTState, metadata: dict,
                    axis: Optional[collectives.ClientsAxis] = None) -> None:
    """``checkpoint.save`` of the whole state: on the mesh every rank's
    rows are gathered (each rank takes part) and rank 0 writes, in the host
    path's format."""
    if axis is not None:
        with collectives.phase("checkpoint"):
            state = collectives.gather_tree(state, axis)
        if axis.rank != 0:
            return
    ckpt_lib.save(path, state, metadata=metadata)


def _topology_part(algo: AlgorithmConfig) -> str:
    if algo.topology_family != "static":
        # W is redrawn every round: report the family, not a spectral gap
        part = (f"family={algo.topology_family}"
                + (f" (edge_prob={algo.edge_prob})"
                   if algo.topology_family == "erdos_renyi" else "")
                + (f" (drop={algo.client_drop_prob})"
                   if algo.topology_family == "dropout" else ""))
    elif (algo.mixing_impl.startswith("sparse_")
          and algo.num_clients > stoch_lib.DENSE_MATERIALIZATION_LIMIT):
        support = sparse_lib.sparse_mixing_matrix(algo.topology,
                                                  algo.num_clients)
        part = f"{algo.topology} (sparse, max_deg={support.max_degree})"
    else:
        w = topology.mixing_matrix(algo.topology, algo.num_clients)
        part = f"p={topology.spectral_gap(w):.3f}"
    if algo.participation_rate < 1.0:
        part += f", participation={algo.participation_rate}"
    if algo.num_byzantine > 0:
        part += (f", byzantine={algo.num_byzantine} "
                 f"({algo.attack} x{algo.attack_scale})")
    return part


def train(args, *, capture: Optional[bool] = None, **replace) -> dict:
    """A training run (reference :183): ``build``, then ``--rounds`` rounds
    through the scan engine (``engine.run``, captured chunks on the card)
    or the host loop.  ``capture``: the scan engine's chunks as CUDA
    graphs (None: on the card, off the mesh; False: eager, the chunks the
    graphs are held to; :meth:`Trainer.build_chunk`).  ``replace`` goes
    to :func:`build`.  Returns
    {"history", "final_consensus", "state"}; on the mesh "state" holds this
    rank's clients, rows ``"clients"`` = [lo, hi) of the whole state, and
    only rank 0 prints."""
    trainer = build(args, **replace)
    algo, cfg, state = trainer.algo, trainer.cfg, trainer.state
    axis = trainer.axis
    lead = axis is None or axis.rank == 0
    # the run owns the state from here: handed over by popping it from a
    # list, so that this frame holds no reference to the initial state
    # (GBs for a language model) while the rounds advance it
    owner, trainer.state = [state], None
    engine_mode = getattr(args, "engine", "scan")
    chunk_rounds = max(1, min(int(getattr(args, "chunk", 16)),
                              max(args.rounds, 1)))
    n_params = sum(x.numel() for x in tree_lib.leaves(state.x))
    mesh_part = ""
    if axis is not None:
        n_params *= axis.size
        mesh_part = (f", mesh=(clients={axis.size}, fsdp=1, model=1) over "
                     f"{axis.backend}, {axis.n_local} clients a rank, "
                     "capture=off (mesh)")
    if lead:
        print(f"[train] {cfg.name}: {n_params / 1e6:.2f}M client-stacked "
              f"params, n={algo.num_clients}, K={algo.local_steps}, "
              f"{_topology_part(algo)}, algo={algo.algorithm}, "
              f"engine={engine_mode}"
              + (f" (chunk={chunk_rounds})" if engine_mode == "scan" else "")
              + mesh_part, flush=True)

    from repro_torch import obs

    if lead:
        telemetry, ledger, profiler = _build_telemetry(args, algo, cfg,
                                                       state)
    else:
        # the other ranks compute the same rows; rank 0 reports them
        telemetry, ledger, profiler = obs.Telemetry([]), None, None
    # with --telemetry-out every rank takes part in the health gauges'
    # sums over the clients axis; rank 0 writes them
    health_fn = (functools.partial(obs.health_gauges, axis=axis)
                 if getattr(args, "telemetry_out", None) else None)
    del state
    try:
        if engine_mode == "scan":
            hooks = [engine_lib.telemetry_hook(
                telemetry, ledger=ledger, health_fn=health_fn)]
            if args.checkpoint_every:
                hooks.append(engine_lib.checkpoint_hook(
                    args.checkpoint_dir, args.checkpoint_every,
                    metadata={"arch": cfg.name}, verbose=lead,
                    save=functools.partial(save_checkpoint, axis=axis)))
            if profiler is not None:
                profiler.start()
                hooks.append(profiler.hook)
            state, history = engine_lib.run(
                owner.pop(), trainer.build_chunk(args, capture=capture),
                total_rounds=args.rounds,
                chunk_rounds=chunk_rounds, hooks=hooks,
                # chunk boundaries on every checkpoint multiple
                boundary_every=args.checkpoint_every or None,
                telemetry=telemetry if ledger is not None else None)
        else:
            state, history = _host_loop(args, owner.pop(), trainer, cfg,
                                        telemetry=telemetry, ledger=ledger)
    finally:
        if profiler is not None:
            profiler.stop()
        telemetry.close()
    if torch.device(trainer.device).type == "cuda" and lead:
        print(f"[train] peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
              + (" (rank 0)" if axis is not None else ""), flush=True)
    out = {
        "history": history,
        "final_consensus": history[-1]["consensus_x"] if history else None,
        "state": state,
    }
    if axis is not None:
        out["clients"] = [axis.lo, axis.hi]
    return out


def _host_loop(args, state, trainer: Trainer, cfg, telemetry=None,
               ledger=None):
    """The per-round loop (``--engine host``, reference :391): eager round
    steps with the scan engine's sampler and metrics, so the trajectory and
    the logged rows are those of eager chunks.  Returns (state, history)."""
    history = []
    t0 = time.perf_counter()
    prev_logged = 0
    for t in range(state.round, args.rounds):
        batches, noise, extras = engine_lib.split_sampled(trainer.sampler(t))
        state = trainer.round_step(state, batches, noise, *extras)
        if t % args.log_every == 0 or t == args.rounds - 1:
            row = trainer.metrics_fn(state, batches)
            rec = engine_lib.row_to_record(
                {k: v.detach().cpu().numpy() for k, v in row.items()}, t)
            rec["wall_s"] = time.perf_counter() - t0
            history.append(rec)
            if telemetry is not None:
                telemetry.metrics(rec)
            else:
                print(_format_record(rec), flush=True)
            if ledger is not None:
                ledger.add_rounds(t + 1 - prev_logged)
                telemetry.emit(ledger.event(rounds=t + 1 - prev_logged,
                                            round=t + 1))
                prev_logged = t + 1
        if args.checkpoint_every and (t + 1) % args.checkpoint_every == 0:
            path = os.path.join(args.checkpoint_dir, f"round_{t + 1:06d}.npz")
            save_checkpoint(path, state, {"round": t + 1, "arch": cfg.name},
                            trainer.axis)
            if trainer.axis is None or trainer.axis.rank == 0:
                print(f"[train] checkpoint -> {path}", flush=True)
    return state, history


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="paper-toy",
                    choices=sorted(registry.ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced CPU-test variant")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--algorithm", default="kgt_minimax",
                    choices=list(kgt.ALGORITHMS))
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4, help="per-client batch")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--mu", type=float, default=1.0)
    ap.add_argument("--alpha", type=float, default=0.3,
                    help="Dirichlet heterogeneity")
    ap.add_argument("--eta-cx", type=float, default=0.05)
    ap.add_argument("--eta-cy", type=float, default=0.5)
    ap.add_argument("--eta-s", type=float, default=0.7)
    ap.add_argument("--engine", default="scan", choices=["scan", "host"],
                    help="scan: engine.run over chunks (CUDA graphs on the "
                         "card); host: the per-round eager loop")
    ap.add_argument("--chunk", type=int, default=16,
                    help="rounds per engine chunk (--engine scan)")
    ap.add_argument("--mesh", default="host",
                    choices=["host", "decentralized"],
                    help="decentralized: the clients spread over the ranks "
                         "of a torch.distributed world (run under torchrun; "
                         "alone, a world of one rank)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="--mesh decentralized: the process group's backend "
                         "(default nccl on cuda, gloo on cpu)")
    ap.add_argument("--topology", default="ring")
    ap.add_argument("--topology-family", default="static",
                    choices=list(stoch_lib.TOPOLOGY_FAMILIES))
    ap.add_argument("--edge-prob", type=float, default=0.5)
    ap.add_argument("--client-drop-prob", type=float, default=0.3)
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument("--topology-seed", type=int, default=None)
    ap.add_argument("--num-byzantine", type=int, default=0)
    ap.add_argument("--attack", default="sign_flip",
                    choices=list(adversary_lib.ATTACKS))
    ap.add_argument("--attack-scale", type=float, default=1.0)
    ap.add_argument("--robust-trim", type=int, default=1)
    ap.add_argument("--mixing-impl", default="dense",
                    choices=list(mixing_lib.MIXING_IMPLS))
    ap.add_argument("--gossip-dtype", default="float32")
    ap.add_argument("--gossip-compress", default="none",
                    choices=["none", *COMPRESS_METHODS])
    ap.add_argument("--gossip-backend", default="auto",
                    choices=list(GOSSIP_BACKENDS))
    ap.add_argument("--schedule", default="constant",
                    choices=list(schedules.SCHEDULES))
    ap.add_argument("--warmup", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default="checkpoints/train")
    ap.add_argument("--telemetry-out", default=None,
                    help="the structured telemetry stream as JSONL")
    ap.add_argument("--profile-dir", default=None,
                    help="a torch.profiler trace into this directory")
    ap.add_argument("--profile-rounds", type=int, default=0)
    ap.add_argument("--compile-cache", default=None,
                    help="not ported yet (ROADMAP A8)")
    ap.add_argument("--out", default=None)
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    if args.mesh != "decentralized":
        result = train(args)
    else:
        backend = args.dist_backend or dist_launch.default_backend(
            args.device)
        args.device = dist_launch.init_from_env(backend, args.device)
        try:
            result = train(args)
            lead = dist.get_rank() == 0
        finally:
            dist.destroy_process_group()
        if not lead:
            return
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({k: result[k] for k in ("history", "final_consensus")},
                      f, indent=1)


if __name__ == "__main__":
    main()
