"""The port's sweep driver (``repro_torch.sweep``) on the CPU.

* Every sweep of ``defs.SWEEPS`` partitions into the reference's cells and
  point keys.
* ``run_cell`` is ``run_point`` bit for bit (rounds-to-ε, every ‖∇Φ‖ of the
  history, the final state) on small grids of every kernel lowering, with
  churn and without; early stop freezes a trajectory at its sequential
  stop round.
* Parity with ``repro.sweep.run``: noise-free points started from the
  reference's prepared trajectory (carried across as numpy) follow the
  reference's (round, ‖∇Φ‖) history within PARITY_RTOL·(1 + ‖∇Φ‖); f32 sums
  taken in another order drift by ulps a round.  Rounds-to-ε are equal
  wherever no boundary's ‖∇Φ‖ lies within that tolerance of ε.
* The refusals are the reference's; compressed and Byzantine cells name
  ROADMAP A7 and A9; the store round-trips.
"""
import _torch_threads  # noqa: F401
import dataclasses

import numpy as np
import pytest
import torch

from repro.sweep import defs as jax_defs
from repro.sweep import grid as jax_grid
from repro.sweep import run as jax_run
from repro_torch.core import from_reference
from repro_torch.sweep import batched as batched_lib
from repro_torch.sweep import defs, grid, store
from repro_torch.sweep import run as sweep_run

DEV = "cpu"
PARITY_RTOL = 1e-5


@pytest.mark.parametrize("name", sorted(jax_defs.SWEEPS))
def test_sweep_cells_and_point_keys_match_the_reference(name):
    ours, ref = defs.SWEEPS[name], jax_defs.SWEEPS[name]
    assert ours.to_json() == ref.to_json()
    assert ([(c.key, c.static, [grid.point_key(p) for p in c.points])
             for c in ours.cells()]
            == [(c.key, c.static, [jax_grid.point_key(p) for p in c.points])
                for c in ref.cells()])


def _small_spec(impl: str, churn: bool) -> grid.GridSpec:
    base = dict(n=4, K=2, eps=0.0, eta_cx=0.02, eta_cy=0.2, eta_s=0.5,
                max_rounds=12, eval_every=4, mixing_impl=impl,
                heterogeneity=1.0)
    axes = [grid.batch_axis("seed", 0, 1)]
    if churn:
        base.update(topology="full", topology_family="erdos_renyi",
                    participation=0.7, sigma=0.3)
        axes.append(grid.batch_axis("edge_prob", 0.3, 0.8))
    else:
        axes.append(grid.batch_axis("sigma", 0.0, 0.5,
                                    cell_key=lambda s: s > 0))
    return grid.GridSpec(name="t", base=base, axes=tuple(axes))


@pytest.mark.parametrize("churn", [False, True])
@pytest.mark.parametrize("impl", ["dense", "pallas_packed", "fused_round"])
def test_run_cell_is_run_point_bit_for_bit(impl, churn):
    for cell in _small_spec(impl, churn).cells():
        (results, timing), trajs = sweep_run.run_cell(cell, device=DEV,
                                                      return_trajs=True)
        assert timing["trajectory_rounds"] == 12 * len(cell.points)
        for i, (p, rec) in enumerate(zip(cell.points, results)):
            hit, final, _, hist = sweep_run.run_point(p, device=DEV)
            assert (hit, final) == (rec["rounds_to_eps"], rec["final_grad"])
            assert hist == rec["history"]
            assert batched_lib.tree_index(trajs, i).state.round == 12


def test_sparse_churn_cell_is_run_point_bit_for_bit():
    spec = _small_spec("sparse_packed", churn=True)
    spec = dataclasses.replace(spec, base={**spec.base, "topology": "ring",
                                           "topology_family": "pairwise"})
    [cell] = spec.cells()
    results, _ = sweep_run.run_cell(cell, device=DEV)
    for p, rec in zip(cell.points, results):
        hit, final, _, hist = sweep_run.run_point(p, device=DEV)
        assert (hit, final, hist) == (rec["rounds_to_eps"],
                                      rec["final_grad"], rec["history"])


def _state_at(p, rounds):
    """The sequential trajectory's state after ``rounds`` rounds."""
    p = sweep_run._full_point(p)
    traj, _ = sweep_run.prepare_trajectory(p, device=DEV)
    build = sweep_run._cell_programs(p, batched=False, device=DEV)
    for _ in range(rounds // p["eval_every"]):
        traj, _ = build(p["eval_every"])(traj, p["max_rounds"] - 1)
    return traj.state


def test_early_stop_freezes_at_sequential_round():
    """Trajectories converge at different boundaries and one never does:
    each converged one keeps its state, round included, from its stop
    boundary while the cell runs on (tests/test_sweep.py:230)."""
    base = dict(n=4, K=4, sigma=0.0, eta_cx=0.02, eta_cy=0.2, eta_s=0.7,
                max_rounds=50, eval_every=10, topology="full", eps=0.31)
    spec = grid.GridSpec(
        name="t_stop", base=base,
        axes=(grid.batch_axis("heterogeneity", 0.0, 1.0, 3.0),))
    [cell] = spec.cells()
    (results, _), trajs = sweep_run.run_cell(cell, device=DEV,
                                             return_trajs=True)
    hits = [r["rounds_to_eps"] for r in results]
    assert len(set(hits)) == 3 and None in hits, (
        f"tune eps: the trajectories should stop apart ({hits})")
    for i, (p, rec) in enumerate(zip(cell.points, results)):
        stop = rec["rounds_to_eps"] or base["max_rounds"]
        seq = _state_at(p, stop)
        frozen = batched_lib.tree_index(trajs, i).state
        assert frozen.round == stop
        for name in ("x", "y", "cx", "cy"):
            assert torch.equal(getattr(frozen, name), getattr(seq, name))


def _port_trajectory_from_reference(p):
    """The reference's prepared trajectory of ``p``, as the port's."""
    jtraj, jconsts = jax_run.prepare_trajectory(p, cache=None)
    st = jtraj.state
    _, state = from_reference(None, {
        "x": np.asarray(st.x), "y": np.asarray(st.y),
        "cx": np.asarray(st.cx), "cy": np.asarray(st.cy), "round": 0},
        device=DEV)
    batches = {k: torch.tensor(np.asarray(v)) for k, v in
               jtraj.batches.items()}
    consts = {k: torch.tensor(np.asarray(v)) for k, v in jconsts.items()}
    p = sweep_run._full_point(p)
    ours, _ = sweep_run.prepare_trajectory(p, device=DEV)
    traj = dataclasses.replace(ours, state=state, batches=batches)
    return traj, consts


@pytest.mark.parametrize("algo,impl", [("kgt_minimax", "dense"),
                                       ("local_sgda", "dense"),
                                       ("kgt_minimax", "fused_round")])
def test_history_matches_the_reference_from_its_start(algo, impl):
    p = dict(n=4, K=3, sigma=0.0, heterogeneity=1.5, topology="ring",
             algorithm=algo, eta_cx=0.02, eta_cy=0.2,
             eta_s=0.5 if algo == "kgt_minimax" else 1.0, eps=1.2,
             max_rounds=60, eval_every=10, mixing_impl=impl, seed=3)
    ref_hit, _, _, ref_hist = jax_run.run_point(p, cache=None)
    traj, consts = _port_trajectory_from_reference(p)
    full = sweep_run._full_point(p)
    build = sweep_run._cell_programs(full, batched=False, device=DEV)
    hist, hit, r = [], None, 0
    while r < full["max_rounds"]:
        traj, _ = build(full["eval_every"])(traj, full["max_rounds"] - 1)
        r += full["eval_every"]
        g = float(sweep_run._phi_grad_norm(consts, traj.state.x, 1.0))
        hist.append((r, g))
        if g < full["eps"]:
            hit = r
            break
    near_eps = any(abs(g - full["eps"]) <= PARITY_RTOL * (1 + g)
                   for _, g in ref_hist)
    if not near_eps:
        assert hit == ref_hit
    for (r0, g0), (r1, g1) in zip(hist, ref_hist):
        assert r0 == r1
        assert abs(g0 - g1) <= PARITY_RTOL * (1 + abs(g1)), (r0, g0, g1)


def _bad_cell():
    return grid.Cell(key="bad", static={}, points=(
        dict(n=4, K=2, max_rounds=4), dict(n=4, K=3, sigma=0.0,
                                           max_rounds=4)))


def test_refusals_match_the_reference():
    with pytest.raises(ValueError) as ours:
        sweep_run.run_cell(_bad_cell(), device=DEV)
    with pytest.raises(ValueError) as ref:
        jax_run.run_cell(jax_grid.Cell(key="bad", static={},
                                       points=_bad_cell().points),
                         cache=None)
    assert str(ours.value) == str(ref.value)
    assert "['K', 'sigma>0']" in str(ours.value)
    with pytest.raises(ValueError, match="unknown point parameters"):
        sweep_run.run_point(dict(nope=1), device=DEV)


@pytest.mark.parametrize("point,item", [
    (dict(gossip_compress="int8"), "pallas_packed"),
    (dict(num_byzantine=1, attack="sign_flip"), "fused_round"),
    (dict(mixing_impl="coord_median"), "dense"),
])
def test_unported_points_raise_naming_the_roadmap_item(point, item):
    """Compressed, Byzantine and robust points run (run_point and run_cell
    agree), and a point on a lowering the reference refuses for the option
    raises the reference's ValueError."""
    p = dict(n=4, K=2, max_rounds=4, eval_every=2, **point)
    if "gossip_compress" in point:
        p["mixing_impl"] = item                   # taken on pallas_packed
    hit, final, _, _ = sweep_run.run_point(p, device=DEV)
    (res,), _ = sweep_run.run_cell(grid.Cell(key="c", static={},
                                             points=(p,)), device=DEV)
    assert (res["rounds_to_eps"], res["final_grad"]) == (hit, final)
    assert np.isfinite(final)
    bad = dict(p, mixing_impl="dense" if "gossip_compress" in point
               else item)
    if "mixing_impl" in point:
        bad = dict(p, topology_family="erdos_renyi", mixing_impl=item,
                   gossip_compress="bf16")
    with pytest.raises(ValueError) as ours:
        sweep_run.run_point(bad, device=DEV)
    with pytest.raises(ValueError) as ref:
        jax_run.run_point(bad, cache=None)
    assert str(ours.value) == str(ref.value)


def test_store_round_trips(tmp_path):
    spec = defs.SWEEPS["smoke"]
    spec = dataclasses.replace(spec, base={**spec.base, "max_rounds": 10})
    res = sweep_run.run_sweep(spec, device=DEV, store_dir=str(tmp_path))
    assert res["store_path"] == str(tmp_path / "smoke.json")
    loaded = store.load("smoke", directory=str(tmp_path))
    assert set(loaded["points"]) == set(res["points"])
    for key, rec in res["points"].items():
        got = loaded["points"][key]
        assert got["rounds_to_eps"] == rec["rounds_to_eps"]
        assert got["final_grad"] == rec["final_grad"]
        assert [tuple(h) for h in got["history"]] == rec["history"]
    [cell] = loaded["cells"].values()
    assert cell["comm"]["bytes_per_round"] == \
        sweep_run.cell_comm(spec.cells()[0].points[0]).bytes_per_round
    assert loaded["provenance"]["device"] == "cpu"
    assert loaded["provenance"]["config_hash"] == grid.config_hash(
        spec.to_json())
    # merge, don't clobber
    store.save("smoke", {"points": {"extra": {"final_grad": 1.0}},
                         "cells": {}}, directory=str(tmp_path))
    merged = store.load("smoke", directory=str(tmp_path))
    assert set(merged["points"]) == set(res["points"]) | {"extra"}
    assert store.default_dir().endswith("results/sweeps_torch")


def test_summarize_points_where_and_cell_comm_match_the_reference():
    result = {"points": {
        "a": {"params": {"algorithm": "x", "seed": 0},
              "rounds_to_eps": 30, "final_grad": 0.1},
        "b": {"params": {"algorithm": "x", "seed": 1},
              "rounds_to_eps": None, "final_grad": 0.5},
        "c": {"params": {"algorithm": "y", "seed": 0},
              "rounds_to_eps": 10, "final_grad": 0.2}}}
    for algo in ("x", "y", "z"):
        ours = sweep_run.points_where(result, algorithm=algo)
        assert ours == jax_run.points_where(result, algorithm=algo)
        if ours:
            assert sweep_run.summarize(ours) == jax_run.summarize(ours)
    for impl in ("dense", "pallas_packed", "sparse_packed", "fused_round"):
        p = dict(mixing_impl=impl, topology="exp", n=16)
        assert (sweep_run.cell_comm(p).describe()
                == jax_run.cell_comm(p).describe())


def test_tree_stack_and_index_round_trip():
    traj, _ = sweep_run.prepare_trajectory(
        dict(n=4, K=2, topology_family="dropout", participation=0.5),
        device=DEV)
    other = dataclasses.replace(traj, seed=5, active=False)
    stacked = batched_lib.tree_stack([traj, other])
    assert stacked.state.x.shape == (2, *traj.state.x.shape)
    back = batched_lib.tree_index(stacked, 1)
    assert (back.seed, back.active, back.topo) == (5, False, traj.topo)
    assert back.state.round == 0
    assert torch.equal(back.state.x, traj.state.x)
    assert back.etas == pytest.approx(traj.etas)


def test_trajectory_chunk_program_is_the_builder_eagerly_and_freezes():
    p = sweep_run._full_point(dict(n=4, K=2, sigma=0.3, max_rounds=8))
    traj, _ = sweep_run.prepare_trajectory(p, device=DEV)
    build = sweep_run._cell_programs(p, batched=False, device=DEV)
    sampler = batched_lib.make_quadratic_traj_sampler(
        local_steps=2, num_clients=4, noise_dim=15, device=DEV)
    from repro_torch.core import make_round_step, quadratic_cell_problem

    step = make_round_step(
        quadratic_cell_problem(sweep_run.DX, sweep_run.DY, noise=True,
                               device=DEV),
        sweep_run._cfg(p), traced_etas=True, device=DEV)
    eager, _ = batched_lib.trajectory_chunk_program(
        step, sampler, length=4)(traj, 7)
    built, _ = build(4)(traj, 7)
    assert eager.state.round == built.state.round == 4
    for name in ("x", "y", "cx", "cy"):
        assert torch.equal(getattr(eager.state, name),
                           getattr(built.state, name))
    frozen = dataclasses.replace(traj, active=False)
    assert batched_lib.trajectory_chunk_program(
        step, sampler, length=4)(frozen, 7)[0] is frozen


def test_cli_lists_every_sweep(capsys):
    sweep_run.main(["--list"])
    lines = capsys.readouterr().out.splitlines()
    assert lines == [
        f"{name}: {sum(len(c.points) for c in spec.cells())} points in "
        f"{len(spec.cells())} cells"
        for name, spec in sorted(jax_defs.SWEEPS.items())]
