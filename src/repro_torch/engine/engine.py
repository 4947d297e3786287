"""Chunked execution engine (port of ``repro.engine.engine:43-336``).

A chunk runs R rounds back to back: for each round the sampler draws the
round's batch and noise, ``round_step`` advances the state, and on log
rounds the metrics are computed into a preallocated device buffer of R
rows.  The buffer is read back once per chunk, so the host waits on the
device once per chunk, not once per round.  ``state.round`` (a host int) is
the single source of truth: the sampler, the lr schedule and the log grid
are functions of it, so a run resumed from a saved state continues the
identical trajectory.

The reference compiles a chunk into one XLA program (``lax.scan`` with a
``lax.cond`` on log rounds); here a chunk is a Python loop that enqueues
the rounds' kernels, and whether a round logs is a host decision.
Capturing the chunk as a CUDA graph is later work (ROADMAP A4).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build

# (round_idx) -> (batches, noise) or (batches, noise, extras): a sampler may
# return a third element, a tuple of per-round operands (a sampled mixing
# matrix W, a participation mask; see sampler.with_topology) that the chunk
# splats into round_step(state, batches, noise, *extras).
Sampler = Callable[[int], Tuple[Any, ...]]
MetricsFn = Callable[[Any, Any], Dict[str, torch.Tensor]]
Hook = Callable[[Any, List[dict], int], None]  # (state, records, prev_round)


def split_sampled(sampled) -> Tuple[Any, Any, Tuple[Any, ...]]:
    """One sampler return -> ``(batches, noise, extras)`` per the Sampler
    protocol above."""
    batches, noise = sampled[0], sampled[1]
    extras = tuple(sampled[2]) if len(sampled) > 2 else ()
    return batches, noise, extras


def chunk_program(round_step, sampler: Sampler,
                  metrics_fn: Optional[MetricsFn] = None, *,
                  log_every: int = 1, length: int):
    """Builds ``chunk_step(state, final_round) -> (state, buffer)``.

    ``buffer`` is None without ``metrics_fn``, else ``(names, rounds,
    rows)``: the logged round indices (host ints) and an on-device
    ``(len(rounds), len(names))`` f32 tensor of scalar metrics.  A round
    logs when it hits the ``log_every`` grid or equals ``final_round``.
    """
    log_every = max(int(log_every), 1)

    def chunk_step(state, final_round: int):
        names: List[str] = []
        rounds: List[int] = []
        rows = None
        for _ in range(length):
            r = state.round
            batches, noise, extras = split_sampled(sampler(r))
            state = round_step(state, batches, noise, *extras)
            if metrics_fn is None or not (r % log_every == 0
                                          or r == final_round):
                continue
            row = metrics_fn(state, batches)
            if rows is None:
                names = list(row)
                dev = next(iter(row.values())).device
                rows = torch.zeros((length, len(names)), dtype=torch.float32,
                                   device=dev)
            rows[len(rounds)] = torch.stack(
                [row[k].to(torch.float32) for k in names])
            rounds.append(r)
        if metrics_fn is None:
            return state, None
        return state, (names, rounds, rows)

    return chunk_step


def make_chunk_builder(round_step, sampler: Sampler,
                       metrics_fn: Optional[MetricsFn] = None, *,
                       log_every: int = 1):
    """Returns ``build(length) -> chunk_step``, cached per length."""
    cache: Dict[int, Any] = {}

    def build(length: int):
        if length not in cache:
            cache[length] = chunk_program(round_step, sampler, metrics_fn,
                                          log_every=log_every, length=length)
        return cache[length]

    return build


def records_from_buffer(buf) -> List[dict]:
    """Metrics buffer -> plain-python history records, one device-to-host
    transfer per chunk."""
    if buf is None:
        return []
    names, rounds, rows = buf
    if not rounds:
        return []
    host = rows[:len(rounds)].cpu().tolist()
    return [{"round": int(r), **dict(zip(names, vals))}
            for r, vals in zip(rounds, host)]


def run(state, build_chunk: Callable[[int], Any], *, total_rounds: int,
        chunk_rounds: int, hooks: Sequence[Hook] = (),
        stop_fn: Optional[Callable[[List[dict]], bool]] = None,
        wall_clock: bool = True):
    """Drives chunks from ``state.round`` up to ``total_rounds``.

    Hooks run at every chunk boundary as ``hook(state, records,
    prev_round)``; ``stop_fn(records) -> bool`` ends the run early at a
    boundary.  Returns ``(state, history)``.  Unless disabled, each record
    carries ``wall_s`` (elapsed), ``build_s`` (kernel builds incurred by
    this run so far) and ``run_s = wall_s − build_s``.
    """
    chunk_rounds = max(int(chunk_rounds), 1)
    history: List[dict] = []
    final_round = total_rounds - 1
    t0 = time.perf_counter()
    build_before = _build.stats["build_s"]
    r = state.round
    while r < total_rounds:
        length = min(chunk_rounds, total_rounds - r)
        state, buf = build_chunk(length)(state, final_round)
        records = records_from_buffer(buf)
        if wall_clock:
            wall = time.perf_counter() - t0
            built = _build.stats["build_s"] - build_before
            for rec in records:
                rec["wall_s"] = wall
                rec["build_s"] = built
                rec["run_s"] = wall - built
        history.extend(records)
        for hook in hooks:
            hook(state, records, r)
        r += length
        if stop_fn is not None and stop_fn(records):
            break
    return state, history
