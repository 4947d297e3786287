"""Trajectory execution: a whole static cell in one captured chunk (port of
``repro.sweep.batched``).

The execution unit is a :class:`Trajectories`: the algorithm state plus
everything that varies *within* a static cell — the per-client quadratic
coefficients (``batches``), the stepsize bundle (``etas``, host floats from
``repro_torch.core.point_etas``), the sampler ``seed``, the early-stop
``active`` flag and the churn bundle (``topo``).

``make_trajectory_chunk_builder`` runs one trajectory's chunk through
``engine.ChunkRunner`` (a CUDA graph on the card): the sequential reference,
``run_point``.  ``make_batched_chunk_builder`` runs a cell — a list of B
trajectories — as one chunk whose every round runs each trajectory's round
step: the same kernel launches, on the same inputs, as ``run_point``
makes, so the cell is bit for bit its points (the reference's vmap of the
trajectory program), and on the card the whole cell is one graph, one
replay per chunk.  The kernels have no trajectory axis yet (ROADMAP).

The early stop keeps the cell in one graph: a finished trajectory still
runs in the chunk (the graph does not depend on which trajectories
finished), and the host keeps its state, ``round`` included, frozen at the
boundary where the sequential ``stop_fn`` would have stopped — the
reference's ``where(active, new, old)``.

Etas, seeds and churn and adversary scalars are host values, baked into a
trajectory's graph; they are fixed for a trajectory's life, so one capture
serves all its chunks.  There is no mesh (ROADMAP A6).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import engine as engine_lib
from repro_torch.core import adversary as adversary_lib
from repro_torch.core import sparse_topology as sparse_lib
from repro_torch.core import stochastic_topology as stoch_lib
from repro_torch.core import tree as tree_lib
from repro_torch.core.kgt_minimax import KGTState

# (round_idx, traj) -> (batches, noise[, extras]): the trajectory-aware
# analogue of the engine's Sampler protocol.
TrajSampler = Callable[[int, "Trajectories"], Any]


@dataclasses.dataclass
class Trajectories:
    """One trajectory; :func:`tree_stack` stacks B of them."""
    state: Any              # KGTState, (n, …) leaves
    batches: Any            # fixed per-round batch pytree, (K, n, …) leaves
    etas: Dict[str, Any]    # stepsize bundle (core.point_etas), host floats
    seed: int               # noise sampler seed
    active: bool = True     # False freezes the trajectory
    # churn and adversary bundle (None on fixed-topology honest cells):
    # host scalars of the per-round W / mask / adversary draws — {"seed",
    # "edge_prob", "drop_prob", "rate", "num_byzantine", "attack_id",
    # "attack_scale"}
    topo: Optional[dict] = None


def tree_stack(trees):
    """Stack a list of pytrees of one structure along a new leading axis:
    tensors with ``torch.stack``, host values into numpy arrays."""
    flat = [tree_lib.flatten(t) for t in trees]
    treedef = flat[0][1]
    if any(d != treedef for _, d in flat):
        raise ValueError("tree_stack needs trees of one structure")
    leaves = [torch.stack(xs) if isinstance(xs[0], torch.Tensor)
              else np.asarray(xs) for xs in zip(*(f for f, _ in flat))]
    return tree_lib.unflatten(treedef, leaves)


def tree_index(tree, i: int):
    """Member ``i`` of a :func:`tree_stack` result."""
    leaves, treedef = tree_lib.flatten(tree)
    return tree_lib.unflatten(treedef, [
        x[i] if isinstance(x, torch.Tensor) else x[i].item()
        for x in leaves])


def _sampler_of(traj_sampler: TrajSampler, traj: Trajectories):
    """The engine sampler of one trajectory: its draws, with its eta
    bundle first among the extras (``make_round_step(traced_etas=True)``'s
    order)."""
    def sample(round_idx: int):
        batches, noise, extras = engine_lib.split_sampled(
            traj_sampler(round_idx, traj))
        return batches, noise, (traj.etas, *extras)

    return sample


def _trajectory_chunk(runner, traj_sampler: TrajSampler, length: int):
    def chunk(traj: Trajectories, final_round: int):
        if not traj.active:
            return traj, None
        state, _ = runner(traj.state, final_round,
                          sampler=_sampler_of(traj_sampler, traj),
                          length=length)
        return dataclasses.replace(traj, state=state), None

    return chunk


def trajectory_chunk_program(round_step, traj_sampler: TrajSampler, *,
                             length: int):
    """The eager ``chunk(traj, final_round) -> (traj, None)`` of ONE
    trajectory: ``length`` rounds of a ``make_round_step(traced_etas=
    True)`` step, or none while ``traj.active`` is False (the freeze)."""
    return _trajectory_chunk(
        engine_lib.ChunkRunner(round_step, capture=False), traj_sampler,
        length)


def make_trajectory_chunk_builder(round_step, traj_sampler: TrajSampler):
    """``build(length) ->`` :func:`trajectory_chunk_program`'s chunk, run
    by one ``engine.ChunkRunner`` (CUDA graphs on the card): the
    sequential reference, ``run_point``.  ``build.stats`` is the runner's."""
    runner = engine_lib.ChunkRunner(round_step)

    def build(length: int):
        return _trajectory_chunk(runner, traj_sampler, length)

    build.stats = runner.stats
    return build


_STATE_FIELDS = ("x", "y", "cx", "cy", "ef_x", "ef_y")


def _fields(state: KGTState) -> tuple:
    """A state's tensors (the EF residuals None without compression)."""
    return tuple(getattr(state, f) for f in _STATE_FIELDS)


def _state(fields: tuple, round_idx: int) -> KGTState:
    return KGTState(round=round_idx, **dict(zip(_STATE_FIELDS, fields)))


@dataclasses.dataclass
class _Cell:
    """A cell as the engine's chunk state: every trajectory's (x, y, cx,
    cy, ef_x, ef_y) and eta bundle, and the round the active trajectories
    are at."""
    states: List[tuple]
    etas: List[Dict[str, Any]]
    round: int


def make_batched_chunk_builder(round_step, traj_sampler: TrajSampler):
    """``build(length) -> chunk(trajs, final_round) -> (trajs, None)``
    over a cell (a list of B trajectories in lockstep): each round runs
    every trajectory's round step, and on the card the chunk is one CUDA
    graph.  A trajectory whose ``active`` is False keeps its state and
    round.  ``build.stats`` is the engine runner's."""

    def cell_step(cell: _Cell, batches, noise, extras) -> _Cell:
        out = []
        for st, etas, b, nz, ex in zip(cell.states, cell.etas, batches,
                                       noise, extras):
            s = round_step(_state(st, cell.round), b, nz, etas, *ex)
            out.append(_fields(s))
        return _Cell(states=out, etas=cell.etas, round=cell.round + 1)

    cell_step.uses_round = getattr(round_step, "uses_round", True)
    runner = engine_lib.ChunkRunner(cell_step)

    def build(length: int):
        def chunk(trajs: List[Trajectories], final_round: int):
            live = [t.state.round for t in trajs if t.active]
            if not live:
                return trajs, None
            cell = _Cell(states=[_fields(t.state) for t in trajs],
                         etas=[t.etas for t in trajs], round=live[0])

            def sample(round_idx: int):
                draws = [engine_lib.split_sampled(traj_sampler(round_idx, t))
                         for t in trajs]
                return ([d[0] for d in draws], [d[1] for d in draws],
                        ([d[2] for d in draws],))

            cell, _ = runner(cell, final_round, sampler=sample,
                             length=length)
            return [dataclasses.replace(t, state=_state(st, cell.round))
                    if t.active else t
                    for t, st in zip(trajs, cell.states)], None

        return chunk

    build.stats = runner.stats
    return build


def make_quadratic_traj_sampler(*, local_steps: int, num_clients: int,
                                noise_dim: int, noise: bool = True,
                                device="cuda"):
    """The quadratic's sampler as a :data:`TrajSampler`: the trajectory's
    fixed batch, and oracle noise from a generator seeded ``seed·7919 + t``
    (``engine.make_fixed_batch_sampler``'s schedule, with the seed the
    trajectory's).  A noise-free cell's problem never reads the noise, so
    it gets one zero tensor every round: nothing is drawn."""
    shape = (local_steps, num_clients, noise_dim)
    if not noise:
        zeros = torch.zeros(shape, device=device)
        return lambda round_idx, traj: (traj.batches, zeros)
    gen = torch.Generator(device=device)

    def sample(round_idx: int, traj: Trajectories):
        gen.manual_seed(traj.seed * 7919 + int(round_idx))
        return traj.batches, torch.randn(shape, generator=gen, device=device)

    return sample


def make_churn_traj_sampler(*, local_steps: int, num_clients: int,
                            noise_dim: int, family: str, base_w=None,
                            participation: bool = False,
                            sparse_support=None, byzantine: bool = False,
                            noise: bool = True, device="cuda"):
    """:func:`make_quadratic_traj_sampler` plus the churn and adversary
    draws: each round also draws the mixing matrix (``family`` ≠
    "static"), the participation mask and/or the Byzantine adversary, from
    the trajectory's ``topo`` bundle (topology seed, edge probability, drop
    probability, participation rate, attacker count, attack id and scale).

    The family, the participation flag and the byzantine flag are static
    cell properties; the bundle's scalars vary within a cell.  The draws
    are ``core.stochastic_topology``'s samplers (``core.sparse_topology``'s
    on ``sparse_support``, whose W is a ``SparseTopology``) and
    ``core.adversary.make_attack_sampler`` (seeded by the topology seed,
    its noise shaped as the trajectory's variables), pure functions of the
    round, so a cell is bit for bit its points and a checkpoint resumes
    exactly.  ``base_w`` is the matrix of ``static`` and ``dropout``.
    """
    if family not in stoch_lib.TOPOLOGY_FAMILIES:
        raise ValueError(f"unknown topology family {family!r}: "
                         f"{stoch_lib.TOPOLOGY_FAMILIES}")
    # churn cells draw the same noise stream as non-churn cells of a seed
    base_sample = make_quadratic_traj_sampler(
        local_steps=local_steps, num_clients=num_clients,
        noise_dim=noise_dim, noise=noise, device=device)
    w_fns: Dict[tuple, Any] = {}
    mask_fns: Dict[tuple, Any] = {}
    attack_fns: Dict[tuple, Any] = {}

    def w_fn(topo):
        key = (topo["seed"], topo["edge_prob"], topo["drop_prob"])
        if key not in w_fns:
            kw = dict(edge_prob=topo["edge_prob"],
                      client_drop_prob=topo["drop_prob"], device=device)
            w_fns[key] = (
                sparse_lib.make_sparse_w_sampler(family, sparse_support,
                                                 topo["seed"], **kw)
                if sparse_support is not None else
                stoch_lib.make_w_sampler(family, num_clients, topo["seed"],
                                         base_w=base_w, **kw))
        return w_fns[key]

    def mask_fn(topo):
        key = (topo["seed"], topo["rate"])
        if key not in mask_fns:
            mask_fns[key] = stoch_lib.make_participation_sampler(
                num_clients, topo["seed"], topo["rate"], device=device)
        return mask_fns[key]

    def attack_fn(traj):
        topo = traj.topo
        key = (topo["seed"], topo["num_byzantine"], topo["attack_id"],
               topo["attack_scale"])
        if key not in attack_fns:
            attack_fns[key] = adversary_lib.make_attack_sampler(
                num_clients, topo["seed"],
                num_byzantine=topo["num_byzantine"],
                attack=adversary_lib.ATTACKS[topo["attack_id"]],
                scale=topo["attack_scale"],
                like=(traj.state.x, traj.state.y), device=device)
        return attack_fns[key]

    def sample(round_idx: int, traj: Trajectories):
        batches, nz = base_sample(round_idx, traj)
        extras = []
        if family != "static":
            extras.append(w_fn(traj.topo)(round_idx))
        if participation:
            extras.append(mask_fn(traj.topo)(round_idx))
        if byzantine:
            extras.append(attack_fn(traj)(round_idx))
        return batches, nz, tuple(extras)

    return sample
