"""Sweep runner + CLI: drive whole hyperparameter grids cell by cell (port
of ``repro.sweep.run``).

A *point* is one experiment configuration: the synthetic NC-SC quadratic
with the exact ∇Φ oracle, run to ε on an ``eval_every`` grid.
:func:`run_point` runs one point sequentially; :func:`run_cell` runs a
whole static cell as one batched chunk per ``eval_every`` interval
(``repro_torch.sweep.batched``; one CUDA graph replay on the card), with a
converged trajectory frozen at exactly the boundary where the sequential
loop would have stopped.  Both paths run the same launches on the same
inputs, so their trajectories are bit for bit the same (held by
``tests/test_torch_sweep.py`` on the CPU and ``chip_smoke.py`` on the card).

The data, x₀ and draws come from the port's generators seeded by the
point's seed, so a point's trajectory is the port's own, not the
reference's: compare the two statistically, over seeds.

  PYTHONPATH=src python -m repro_torch.sweep.run smoke         # tiny, the card
  PYTHONPATH=src python -m repro_torch.sweep.run convergence --device cpu
  PYTHONPATH=src python -m repro_torch.sweep.run --list
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import AlgorithmConfig
from repro_torch.core import (
    init_state,
    make_quadratic_data,
    make_round_step,
    mixing_matrix,
    point_etas,
    quadratic_cell_problem,
    sparse_mixing_matrix,
)
from repro_torch.core import adversary as adversary_lib
from repro_torch.kernels import _build
from repro_torch.sweep import batched as batched_lib
from repro_torch.sweep import grid as grid_lib
from repro_torch.sweep import store as store_lib

DX, DY = 10, 5  # the benchmarks' quadratic geometry (benchmarks.common)

# One-configuration defaults (the reference's run_to_epsilon defaults).
# topology_family/edge_prob/client_drop_prob/participation are the churn
# axes: family "static" + participation 1.0 is the fixed-W
# full-participation point.
DEFAULT_POINT: Dict[str, Any] = dict(
    n=8, K=4, sigma=0.1, heterogeneity=1.0, topology="ring",
    algorithm="kgt_minimax", eta_cx=0.01, eta_cy=0.1, eta_s=0.5,
    eps=0.3, max_rounds=2000, seed=0, mixing_impl="dense", eval_every=10,
    topology_family="static", edge_prob=0.5, client_drop_prob=0.3,
    participation=1.0,
    num_byzantine=0, attack="honest", attack_scale=1.0, robust_trim=1,
    gossip_compress=None,
)

# Point parameters that change the program: same-valued across every point
# of a cell, enforced at cell build time.  (sigma > 0 toggles the noise
# draws, participation < 1 the mask draws and num_byzantine > 0 the
# adversary: grid axes spanning those thresholds declare a cell_key.)
STATIC_KEYS = ("algorithm", "n", "K", "topology", "mixing_impl",
               "eps", "max_rounds", "eval_every", "topology_family",
               "robust_trim", "gossip_compress")


def _churn(p: Dict[str, Any]):
    """(samples W per round, applies a participation mask): both static
    program properties of a cell."""
    return p["topology_family"] != "static", p["participation"] < 1.0


def _byz(p: Dict[str, Any]) -> bool:
    """Whether the cell carries the Byzantine adversary (a static
    property)."""
    return p["num_byzantine"] > 0


def _full_point(p: Dict[str, Any]) -> Dict[str, Any]:
    full = dict(DEFAULT_POINT)
    unknown = set(p) - set(full)
    if unknown:
        raise ValueError(f"unknown point parameters {sorted(unknown)}")
    full.update(p)
    return full


def _cfg(p: Dict[str, Any]) -> AlgorithmConfig:
    return AlgorithmConfig(
        algorithm=p["algorithm"], num_clients=p["n"], local_steps=p["K"],
        eta_cx=p["eta_cx"], eta_cy=p["eta_cy"], eta_sx=p["eta_s"],
        eta_sy=p["eta_s"], topology=p["topology"],
        mixing_impl=p["mixing_impl"], robust_trim=p["robust_trim"],
        gossip_compress=p["gossip_compress"])


def prepare_trajectory(p: Dict[str, Any], *, device="cuda"):
    """One point -> (Trajectories, ∇Φ-oracle constants).

    Data and problem from a generator seeded by the point's seed, shared
    x0/y0, tracking corrections from the initial batch — the same recipe
    for the sequential and batched paths, so their starts are identical.
    The constants are the client means the exact ∇Φ oracle needs.
    """
    p = _full_point(p)
    noise = p["sigma"] > 0.0
    gen = torch.Generator(device=device)
    gen.manual_seed(int(p["seed"]))
    data = make_quadratic_data(gen, p["n"], dx=DX, dy=DY,
                               heterogeneity=p["heterogeneity"])
    cb = {k: v for k, v in data.items() if k != "mu"}
    if noise:
        cb["sigma"] = torch.full((p["n"],), p["sigma"], dtype=torch.float32,
                                 device=device)
    problem = quadratic_cell_problem(DX, DY, mu=1.0, noise=noise,
                                     device=device)
    st = init_state(problem, _cfg(p), gen, init_batch=cb)
    consts = {"a_bar": data["A"].mean(0), "b_bar": data["B"].mean(0),
              "bv_bar": data["b"].mean(0), "q_bar": data["q"].mean(0)}
    kb = {k: v.unsqueeze(0).expand(p["K"], *v.shape) for k, v in cb.items()}
    random_w, part = _churn(p)
    topo = None
    if random_w or part or _byz(p):
        topo = {"seed": int(p["seed"]), "edge_prob": float(p["edge_prob"]),
                "drop_prob": float(p["client_drop_prob"]),
                "rate": float(p["participation"]),
                "num_byzantine": int(p["num_byzantine"]),
                "attack_id": adversary_lib.ATTACK_IDS[p["attack"]],
                "attack_scale": float(p["attack_scale"])}
    traj = batched_lib.Trajectories(
        state=st, batches=kb, etas=point_etas(_cfg(p)), seed=int(p["seed"]),
        active=True, topo=topo)
    return traj, consts


def _phi_grad_norm(consts, x_clients, mu: float):
    """Exact ‖∇Φ(x̄)‖ from the client-mean constants — the expression of
    ``quadratic_problem``'s ``phi_grad`` + ``phi_grad_norm``."""
    x = x_clients.mean(0)
    ystar = (consts["b_bar"] @ x + consts["bv_bar"]) / mu
    g = consts["a_bar"] @ x + consts["q_bar"] + consts["b_bar"].T @ ystar
    return torch.sqrt(torch.sum(torch.square(g)))


def _cell_programs(p: Dict[str, Any], *, batched: bool, device="cuda"):
    """The chunk builder of a cell whose static parameters are ``p``'s:
    ``batched`` selects the cell (a list of trajectories) or the
    sequential single-trajectory program — the only difference between
    the two paths."""
    noise = p["sigma"] > 0.0
    problem = quadratic_cell_problem(DX, DY, mu=1.0, noise=noise,
                                     device=device)
    random_w, part = _churn(p)
    byz = _byz(p)
    round_step = make_round_step(problem, _cfg(p), traced_etas=True,
                                 traced_w=random_w, participation=part,
                                 byzantine=byz, device=device)
    common = dict(local_steps=p["K"], num_clients=p["n"],
                  noise_dim=problem.noise_dim, noise=noise, byzantine=byz,
                  device=device)
    if random_w or part or byz:
        if p["mixing_impl"].startswith("sparse_"):
            # the W slot carries a SparseTopology: the draw runs on the
            # neighbor lists of the support graph, never an (n, n) array
            sampler = batched_lib.make_churn_traj_sampler(
                family=p["topology_family"], participation=part,
                sparse_support=sparse_mixing_matrix(p["topology"], p["n"]),
                **common)
        else:
            base_w = (mixing_matrix(p["topology"], p["n"])
                      if p["topology_family"] in ("static", "dropout")
                      else None)
            sampler = batched_lib.make_churn_traj_sampler(
                family=p["topology_family"], base_w=base_w,
                participation=part, **common)
    else:
        common.pop("byzantine")
        sampler = batched_lib.make_quadratic_traj_sampler(**common)
    if batched:
        return batched_lib.make_batched_chunk_builder(round_step, sampler)
    return batched_lib.make_trajectory_chunk_builder(round_step, sampler)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timing_split(wall: float, build_s: float, capture_s: float,
                  setup_s: float) -> dict:
    """``{wall_s, build_s, capture_s, setup_s, run_s}``: kernel builds and
    CUDA graph captures split from steady-state execution; ``run_s``
    clamps at 0 (four separately measured intervals)."""
    return {"wall_s": wall, "build_s": build_s, "capture_s": capture_s,
            "setup_s": setup_s,
            "run_s": max(0.0, wall - build_s - capture_s - setup_s)}


def run_point(p: Dict[str, Any], *, device="cuda"):
    """Sequential reference: one point, one engine chunk per
    ``eval_every`` interval, ∇Φ checked at chunk boundaries with immediate
    stop.

    Returns ``(rounds_to_eps or None, final ‖∇Φ‖, timing, history)``:
    ``timing`` as :func:`_timing_split`, ``history`` the ``[(round,
    grad), …]`` of the evaluation grid.
    """
    p = _full_point(p)
    t0 = time.perf_counter()
    built0 = _build.stats["build_s"]
    traj, consts = prepare_trajectory(p, device=device)
    _sync(device)
    setup_s = time.perf_counter() - t0
    build = _cell_programs(p, batched=False, device=device)
    hist: List[tuple] = []
    hit = None
    final_round = p["max_rounds"] - 1
    r = 0
    while r < p["max_rounds"]:
        length = min(p["eval_every"], p["max_rounds"] - r)
        traj, _ = build(length)(traj, final_round)
        r += length
        g = float(_phi_grad_norm(consts, traj.state.x, 1.0))
        hist.append((r, g))
        if g < p["eps"]:
            hit = r
            break
    final = hist[-1][1] if hist else float("nan")
    timing = _timing_split(time.perf_counter() - t0,
                           _build.stats["build_s"] - built0,
                           build.stats["capture_s"], setup_s)
    return hit, final, timing, hist


def run_cell(cell: grid_lib.Cell, *, device="cuda",
             return_trajs: bool = False):
    """One static cell as a batched program: returns ``(per-point result
    dicts, timing)`` — with ``return_trajs``, ``((results, timing),
    trajectories)``, the final trajectories stacked by
    ``batched.tree_stack`` (frozen where converged).

    Drives the evaluation grid of :func:`run_point`: after each
    ``eval_every`` chunk the ∇Φ oracle runs for every live trajectory
    (one read-back), newly converged ones record their hit round and drop
    out of the ``active`` set (their state freezes at this boundary), and
    the loop exits once every trajectory has converged.  The timing
    carries ``trajectory_rounds``, the rounds the live trajectories ran.
    """
    points = [_full_point(p) for p in cell.points]
    p0 = points[0]
    for p in points[1:]:
        bad = [k for k in STATIC_KEYS if p[k] != p0[k]]
        if (p["sigma"] > 0.0) != (p0["sigma"] > 0.0):
            bad.append("sigma>0")
        if _churn(p) != _churn(p0):
            bad.append("participation<1")
        if _byz(p) != _byz(p0):
            bad.append("num_byzantine>0")
        if bad:
            raise ValueError(
                f"cell {cell.key!r} mixes static program parameters {bad}; "
                "declare them as static axes (or give the sigma axis "
                "cell_key=lambda s: s > 0, a participation axis spanning "
                "1.0 cell_key=lambda r: r < 1)")
    t0 = time.perf_counter()
    built0 = _build.stats["build_s"]
    prepared = [prepare_trajectory(p, device=device) for p in points]
    trajs = [tr for tr, _ in prepared]
    consts = [c for _, c in prepared]
    _sync(device)
    setup_s = time.perf_counter() - t0
    build = _cell_programs(p0, batched=True, device=device)

    b = len(points)
    active = [True] * b
    hit: List[Optional[int]] = [None] * b
    hist: List[List[tuple]] = [[] for _ in range(b)]
    final_round = p0["max_rounds"] - 1
    traj_rounds = 0
    r = 0
    while r < p0["max_rounds"]:
        length = min(p0["eval_every"], p0["max_rounds"] - r)
        trajs, _ = build(length)(trajs, final_round)
        r += length
        live = [i for i in range(b) if active[i]]
        traj_rounds += length * len(live)
        g = torch.stack([_phi_grad_norm(consts[i], trajs[i].state.x, 1.0)
                         for i in live]).cpu().tolist()
        for i, gi in zip(live, g):
            hist[i].append((r, gi))
            if gi < points[i]["eps"]:
                hit[i] = r
                active[i] = False
        if not any(active):
            break
        trajs = [dataclasses.replace(t, active=a)
                 for t, a in zip(trajs, active)]

    timing = _timing_split(time.perf_counter() - t0,
                           _build.stats["build_s"] - built0,
                           build.stats["capture_s"], setup_s)
    timing["trajectory_rounds"] = traj_rounds
    results = [
        {"rounds_to_eps": hit[i],
         "final_grad": hist[i][-1][1] if hist[i] else float("nan"),
         "history": hist[i]}
        for i in range(b)
    ]
    if return_trajs:
        return (results, timing), batched_lib.tree_stack(trajs)
    return results, timing


def cell_comm(p0: Dict[str, Any]):
    """The analytic per-round communication of a cell's static lowering
    (``repro_torch.obs.ledger``): the quadratic's packed dims are the
    problem geometry (DX, DY)."""
    p0 = _full_point(p0)
    return obs.round_comm(
        mixing_impl=p0["mixing_impl"], n=p0["n"], dims=(DX, DY),
        topology=p0["topology"],
        track=p0["algorithm"] in ("kgt_minimax", "gt_gda"),
        gossip_compress=p0["gossip_compress"])


def run_sweep(spec: grid_lib.GridSpec, *, device="cuda", store: bool = True,
              store_dir: Optional[str] = None, csv=None,
              telemetry=None) -> dict:
    """Run every static cell of ``spec`` batched; persist and return
    ``{"points": {point_key: {...}}, "cells": {cell_key: {...}}}``.

    Each cell record carries the timing split and a ``comm`` block: the
    ledger's analytic bytes a round for the cell's lowering and the total
    bytes its trajectories moved.  ``telemetry`` (a
    ``repro_torch.obs.Telemetry``) gets a span and a ledger event a cell.
    """
    tel = telemetry if telemetry is not None else obs.NULL
    out: dict = {"name": spec.name, "points": {}, "cells": {}}
    for cell in spec.cells():
        with tel.span("cell", sweep=spec.name, cell=cell.key,
                      points=len(cell.points)):
            results, timing = run_cell(cell, device=device)
        ledger = obs.CommLedger(cell_comm(cell.points[0]))
        # rounds actually executed: each trajectory ran to its last
        # evaluation boundary (hit or max_rounds)
        cell_rounds = sum(res["history"][-1][0] if res["history"] else 0
                          for res in results)
        ledger.add_rounds(cell_rounds)
        tel.emit(ledger.event(rounds=cell_rounds, sweep=spec.name,
                              cell=cell.key))
        out["cells"][cell.key] = {
            "static": cell.static, "num_trajectories": len(cell.points),
            **timing,
            "comm": {**ledger.describe(), "rounds": cell_rounds,
                     "bytes_total": ledger.total_bytes}}
        if csv is not None:
            csv(f"sweep,{spec.name},cell={cell.key},B={len(cell.points)},"
                f"capture_s={timing['capture_s']},run_s={timing['run_s']},"
                f"comm_bytes_per_round={ledger.bytes_per_round}")
        for p, res in zip(cell.points, results):
            out["points"][grid_lib.point_key(p)] = {
                "params": dict(p), "cell": cell.key, **res}
    if store:
        out["store_path"] = store_lib.save(spec.name, out, spec,
                                           directory=store_dir,
                                           device=device)
    return out


def points_where(result: dict, **params) -> List[dict]:
    """Stored/returned points whose params match ``params`` (sweep order)."""
    return [rec for rec in result["points"].values()
            if all(rec["params"].get(k) == v for k, v in params.items())]


def summarize(points: List[dict]) -> dict:
    """mean±std over a replicate group (seeds): final grad + rounds-to-ε
    over the converged subset, plus the hit rate."""
    finals = [p["final_grad"] for p in points]
    hits = [p["rounds_to_eps"] for p in points
            if p["rounds_to_eps"] is not None]
    out = {
        "num": len(points),
        "final_grad_mean": float(np.mean(finals)) if finals else None,
        "final_grad_std": float(np.std(finals)) if finals else None,
        "hit_rate": len(hits) / len(points) if points else None,
    }
    if hits:
        out["rounds_to_eps_mean"] = float(np.mean(hits))
        out["rounds_to_eps_std"] = float(np.std(hits))
    else:
        out["rounds_to_eps_mean"] = None
        out["rounds_to_eps_std"] = None
    return out


def main(argv=None) -> None:
    import argparse

    from repro_torch.sweep import defs

    ap = argparse.ArgumentParser(
        description="Run named experiment sweeps, a cell at a time")
    ap.add_argument("names", nargs="*", help="sweep names (see --list)")
    ap.add_argument("--list", action="store_true", help="list known sweeps")
    ap.add_argument("--out", default=None, help="store directory "
                    "(default: <repo>/results/sweeps_torch)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.list or not args.names:
        for name, spec in sorted(defs.SWEEPS.items()):
            cells = spec.cells()
            npts = sum(len(c.points) for c in cells)
            print(f"{name}: {npts} points in {len(cells)} cells")
        return
    for name in args.names:
        t0 = time.perf_counter()
        res = run_sweep(defs.SWEEPS[name], device=args.device,
                        store_dir=args.out, csv=print)
        print(f"sweep,{name},points={len(res['points'])},"
              f"cells={len(res['cells'])},"
              f"wall_s={time.perf_counter() - t0},"
              f"store={res.get('store_path')}")


if __name__ == "__main__":
    main()
