"""Training on the port's decentralized mesh (``launch.train --mesh
decentralized``: ``launch.steps``, ``dist.collectives``) against the JAX
reference's mesh run and the port's host path, on the reduced qwen2-0.5b
at n = 4 clients (so that a ring's W is not the full average and Ξx is not
0 whatever the code does), K = 2, batch 2 × 32 tokens, 4 groups.

The reference's ``train(--mesh decentralized)`` runs once; what it draws
is caught on the way (as ``tests/test_torch_train.py`` does) and handed to
the ranks as a file.  One world of 2 gloo ranks (2 clients a rank) and one
world of 1 are spawned for the file (``dist.launch.run_world``), each
running every case of its world (``_torch_mesh_worker.train_cases``).

Tolerances, max |got − want| ≤ tol·(1 + max|want|):
* the history rows against the reference: the train tests'
  TOL_BF16_ROWS (bf16 compute);
* the state on a world of 2 against the port's host path on the same
  draws: TOL_MESH_STATE = 1e-4, stated before the first reading — a
  rank's vmapped local steps batch 2 clients where the host path batches
  4, and the packed epilogue contracts W's row block, so GEMMs may round
  otherwise;
* Σ_i c_i over the ranks: TOL_SIGMA_C = 1e-5 (chip_smoke.py's);
* ``--telemetry-out``'s rows and health gauges on a world of 2 against
  the host path's: TOL_TELEMETRY = 1e-5, stated before the first
  reading;
* a world of 1: the host path bit for bit.
"""
import _torch_threads  # noqa: F401
import argparse
import functools
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import train as jax_train
from repro_torch import engine as engine_lib
from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.configs import registry
from repro_torch.core import tree as tree_lib
from repro_torch.dist import launch as dist_launch
from repro_torch.launch import train as t_train
from repro_torch.models import interop
from repro_torch.models import model as t_model

import _torch_mesh_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_BF16_ROWS = 2e-2
TOL_MESH_STATE = 1e-4
TOL_SIGMA_C = 1e-5
TOL_TELEMETRY = 1e-5
ARCH = "qwen2-0.5b"
N, K, B, S, G, ROUNDS, WORLD = 4, 2, 2, 32, 4, 2, 2
ARGS = dict(arch=ARCH, reduced=True, algorithm="kgt_minimax", rounds=ROUNDS,
            clients=N, local_steps=K, batch=B, seq_len=S, groups=G, mu=1.0,
            alpha=0.3, eta_cx=0.02, eta_cy=0.2, eta_s=0.7, topology="ring",
            mixing_impl="dense", gossip_dtype="float32", schedule="constant",
            warmup=0, seed=0, log_every=1, checkpoint_every=0,
            checkpoint_dir="checkpoints/test", out=None, engine="scan",
            chunk=ROUNDS, mesh="decentralized")
ROW_KEYS = ("f_bar", "mean_loss", "eval_loss", "eval_group_loss",
            "consensus_x", "consensus_y", "corr_x_norm", "corr_y_norm",
            "y_bar_norm")
STAMPS = ("wall_s", "build_s", "capture_s", "run_s")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(b):
    return {k: torch.tensor(np.asarray(v)).long() for k, v in b.items()}


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * (1 + np.abs(want).max()), (what, err)


def _strip(history):
    return [{k: v for k, v in r.items() if k not in STAMPS} for r in history]


@functools.lru_cache(maxsize=None)
def _reference_run():
    """The reference's ``train(--mesh decentralized)`` on ``ARGS``: its
    history, and its draws caught by wrapping the functions it calls."""
    caught = {}

    def spy(module, name):
        orig = getattr(module, name)

        def call(*args, **kw):
            out = orig(*args, **kw)
            caught.setdefault(name, _np(out) if name == "init_state"
                              else out)
            return out

        return mock.patch.object(module, name, call)

    with spy(jax_train.data_lib, "round_batches"), \
            spy(jax_train.kgt, "init_state"), \
            spy(jax_train.engine_lib, "make_dro_sampler"), \
            spy(jax_train.engine_lib, "held_out_eval_batch"):
        hist = jax_train.train(argparse.Namespace(**ARGS))["history"]
    sample = jax.jit(caught["make_dro_sampler"])
    return dict(x0=jax.tree.map(lambda a: a[0], caught["init_state"].x),
                init_b=_np(jax.tree.map(lambda x: x[0],
                                        caught["round_batches"])),
                batches=[_np(sample(jnp.int32(t))[0])
                         for t in range(ROUNDS)],
                eval_b=_np(caught["held_out_eval_batch"]), history=hist)


def _draws():
    ref = _reference_run()
    tcfg = registry.reduced(registry.get_model_config(ARCH))
    return dict(init_params=t_model.param_dict(interop.params_from_reference(
                    ref["x0"], tcfg, device="cpu")),
                init_batch=_batch(ref["init_b"]),
                batches=[_batch(b) for b in ref["batches"]],
                eval_batch=_batch(ref["eval_b"]))


def _port_args(**over):
    args = t_train.parser().parse_args(["--arch", ARCH])
    for k, v in {**ARGS, "device": "cpu", **over}.items():
        setattr(args, k, v)
    return args


def _host_kw(draws):
    return dict(init_params=draws["init_params"],
                init_batch=draws["init_batch"],
                sampler=lambda t: (draws["batches"][t],
                                   torch.zeros((K, N, 0))),
                eval_batch=draws["eval_batch"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's host path (dense, pallas_packed, fused_ring) here, then
    the mesh cases in a world of 2 and a world of 1, all on the
    reference's draws."""
    d = tmp_path_factory.mktemp("mesh_train")
    draws = _draws()
    draws_path = str(d / "draws.pt")
    torch.save(draws, draws_path)
    host = {}
    for name, over in (
            ("dense", dict(mesh="host", checkpoint_every=1,
                           checkpoint_dir=str(d / "host_ckpt"),
                           telemetry_out=str(d / "host_tel.jsonl"))),
            ("packed", dict(mesh="host", mixing_impl="pallas_packed")),
            ("ring", dict(mesh="host", mixing_impl="fused_ring"))):
        host[name] = t_train.train(_port_args(**over), **_host_kw(draws))
    mesh_over = dict(ARGS, device="cpu")
    two = dist_launch.run_world(WORLD, worker.train_cases, draws_path, [
        ("dense", dict(mesh_over, checkpoint_every=1,
                       checkpoint_dir=str(d / "mesh_ckpt"),
                       telemetry_out=str(d / "mesh_tel.jsonl")), None),
        ("resumed", mesh_over,
         str(d / "host_ckpt" / "round_000001.npz")),
        ("packed", dict(mesh_over, mixing_impl="pallas_packed",
                        engine="host"), None),
        ("ring", dict(mesh_over, mixing_impl="fused_ring"), None),
        ("host_loop", dict(mesh_over, engine="host"), None)],
        backend="gloo", store_dir=str(d))
    (one,) = dist_launch.run_world(1, worker.train_cases, draws_path, [
        ("dense", mesh_over, None)], backend="gloo", store_dir=str(d))
    # the mesh's checkpoint resumed on the host path
    args = _port_args(mesh="host")
    trainer = t_train.build(args, **_host_kw(draws))
    restored = ckpt_lib.restore(str(d / "mesh_ckpt" / "round_000001.npz"),
                                trainer.state)
    trainer.state = None
    resumed_on_host, _ = engine_lib.run(restored, trainer.build_chunk(args),
                                        total_rounds=ROUNDS,
                                        chunk_rounds=ROUNDS)
    return dict(host=host, two=two, one=one, dir=d,
                resumed_on_host=resumed_on_host)


def _close_states(got, want, tol, what):
    for f in ("x", "y", "cx", "cy"):
        for a, b in zip(tree_lib.leaves(getattr(got, f)),
                        tree_lib.leaves(getattr(want, f))):
            _close(a.float().numpy(), b.float().numpy(), tol, (what, f))
    assert got.round == want.round


def test_mesh_rows_match_the_reference_mesh_run(runs):
    want = _reference_run()["history"]
    for rank in runs["two"]:
        got = rank["dense"]["history"]
        assert [r["round"] for r in got] == [r["round"] for r in want] == [
            0, 1]
        for g, w in zip(got, want):
            for key in ROW_KEYS:
                _close(g[key], w[key], TOL_BF16_ROWS, (g["round"], key))
        assert got[-1]["consensus_x"] > 0


def test_every_rank_logs_the_same_rows(runs):
    a, b = (_strip(r["dense"]["history"]) for r in runs["two"])
    assert a == b


@pytest.mark.parametrize("case", ["dense", "packed", "ring"])
def test_mesh_state_matches_the_host_path(runs, case):
    rank0 = runs["two"][0][case]
    assert rank0["clients"] == [0, N // WORLD]
    _close_states(rank0["state"], runs["host"][case]["state"],
                  TOL_MESH_STATE, case)
    for got, want in zip(_strip(rank0["history"]),
                         _strip(runs["host"][case]["history"])):
        for key in ROW_KEYS:
            _close(got[key], want[key], TOL_MESH_STATE, (case, key))


@pytest.mark.parametrize("case", ["dense", "packed", "ring"])
def test_sigma_c_is_zero_across_ranks(runs, case):
    rank0 = runs["two"][0][case]
    for f in ("cx", "cy"):
        for s, c in zip(rank0["c_sums"][f],
                        tree_lib.leaves(getattr(rank0["state"], f))):
            sigma = float(s.abs().max()) / N
            assert sigma <= TOL_SIGMA_C * (1 + float(c.abs().max())), f


@pytest.mark.parametrize("case", ["dense", "packed", "ring"])
def test_the_local_steps_make_no_collective(runs, case):
    for rank in runs["two"]:
        counts = rank[case]["counts"]
        assert "local_steps" not in counts
        assert counts["gossip"]


def test_gossip_collectives_and_bytes_a_round_are_the_formula(runs):
    """dense: two all-gathers a leaf of x and y (Δ and θ), each receiving
    (R − 1)·(n/R) client rows; fused_ring: one exchange a leaf (Δ and θ
    stacked), two rows received; pallas_packed: one all-gather a variable
    of the stacked (Δ, θ) buffer.  All f32."""
    cfg = registry.reduced(registry.get_model_config(ARCH))
    leaves = tree_lib.leaves(t_model.param_dict(t_model.skeleton(cfg)))
    lx, dx = len(leaves), sum(t.numel() for t in leaves)
    ly, dy = 1, G
    nl = N // WORLD
    want = {
        "dense": {"all_gather": (2 * (lx + ly), (WORLD - 1) * nl * 2
                                 * (dx + dy) * 4)},
        "packed": {"all_gather": (2, (WORLD - 1) * nl * 2 * (dx + dy) * 4)},
        "ring": {"exchange": (lx + ly, 2 * 2 * (dx + dy) * 4)}}
    for rank in runs["two"]:
        for case, per_round in want.items():
            got = {k: (v["calls"], v["bytes"])
                   for k, v in rank[case]["counts"]["gossip"].items()}
            assert got == {k: (c * ROUNDS, b * ROUNDS)
                           for k, (c, b) in per_round.items()}, case
            assert rank[case]["counts"]["staged_bytes"] == 0


def test_the_round_runs_under_the_residual_constraint(runs):
    """``launch.steps`` installs the mesh's residual constraint around the
    round (the model applies it once a unit, 2 here, a forward), and
    nothing is left installed after it."""
    for rank in runs["two"]:
        assert rank["dense"]["residual_calls"] > 0
        assert rank["dense"]["outside_slots"] == {}


def test_mesh_chunks_are_the_host_loop_bit_for_bit(runs):
    """The scan engine's eager chunks on the mesh (``Trainer.build_chunk``
    over ``launch.steps.build_train_round``) run the per-round loop's
    (``--engine host``) rounds and rows."""
    for rank in runs["two"]:
        assert _strip(rank["host_loop"]["history"]) == _strip(
            rank["dense"]["history"])
    a = runs["two"][0]["host_loop"]["state"]
    b = runs["two"][0]["dense"]["state"]
    for x, y in zip(tree_lib.leaves(a), tree_lib.leaves(b)):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y


def test_a_world_of_one_is_the_host_path_bit_for_bit(runs):
    one = runs["one"]["dense"]
    host = runs["host"]["dense"]
    assert _strip(one["history"]) == _strip(host["history"])
    for a, b in zip(tree_lib.leaves(one["state"]),
                    tree_lib.leaves(host["state"])):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    assert set(one["counts"]) == {"staged_bytes"}


def test_checkpoints_cross_between_the_mesh_and_the_host_path(runs):
    """The mesh's checkpoint (gathered, written by rank 0) resumes on the
    host path, and the host path's on the mesh, each to the other's final
    state."""
    mesh = runs["two"][0]
    host_final = runs["host"]["dense"]["state"]
    assert os.path.exists(runs["dir"] / "mesh_ckpt" / "round_000002.npz")
    _close_states(runs["resumed_on_host"], mesh["dense"]["state"],
                  TOL_MESH_STATE, "mesh checkpoint on the host path")
    _close_states(mesh["resumed"]["state"], host_final, TOL_MESH_STATE,
                  "host checkpoint on the mesh")


def _events(path):
    import json

    with open(path) as f:
        return [json.loads(line) for line in f]


def test_mesh_telemetry_is_the_host_paths(runs):
    """``--telemetry-out`` on the mesh: rank 0 writes the stream (the
    other rank none), its meta record is the host path's, and its metric
    rows, ledger events and health gauges (Σc drift, consensus, summed
    over the clients axis) are the host path's at 1e-5·(1 + max)."""
    d = runs["dir"]
    host, mesh = (_events(d / f"{w}_tel.jsonl") for w in ("host", "mesh"))
    assert not [p for p in os.listdir(d) if p.endswith(".jsonl")
                and p not in ("host_tel.jsonl", "mesh_tel.jsonl")]

    def of(events, kind):
        return [{k: v for k, v in e.items() if k not in ("v", "t", *STAMPS)}
                for e in events if e["type"] == kind]

    assert of(mesh, "meta") == of(host, "meta")
    assert of(mesh, "ledger") == of(host, "ledger")
    rows_h, rows_m = of(host, "metrics"), of(mesh, "metrics")
    assert [r["round"] for r in rows_m] == [r["round"] for r in rows_h] == [
        0, 1]
    for g, w in zip(rows_m, rows_h):
        for key in ROW_KEYS:
            _close(g[key], w[key], TOL_TELEMETRY, ("metrics", key))
    gauges_h, gauges_m = of(host, "gauge"), of(mesh, "gauge")
    assert [(e["name"], e["round"]) for e in gauges_m] == [
        (e["name"], e["round"]) for e in gauges_h]
    assert {e["name"] for e in gauges_m} == {
        "corr_x_drift", "corr_y_drift", "consensus_x", "consensus_y"}
    for g, w in zip(gauges_m, gauges_h):
        _close(g["value"], w["value"], TOL_TELEMETRY, g["name"])
    assert any(e["value"] > 0 for e in gauges_m
               if e["name"] == "consensus_x")


@pytest.mark.parametrize("over,error,match", [
    (dict(topology_family="erdos_renyi"), ValueError, "not supported"),
    (dict(participation=0.5), ValueError, "not supported"),
    (dict(num_byzantine=1), ValueError, "not supported"),
    (dict(mixing_impl="fused_round"), ValueError, "affine_coeffs"),
    (dict(), RuntimeError, "torch.distributed world")],
    ids=["topology_family", "participation", "byzantine", "fused_round",
         "no_process_group"])
def test_refusals(over, error, match):
    """The reference's refusals on the mesh (its words; ``fused_round``
    on the DRO problem: the reference's own error, it has no
    ``affine_coeffs`` oracle), then a world to run on."""
    with pytest.raises(error, match=match):
        t_train.build(_port_args(**over))


CYCLE = ("ring", "exp")


@pytest.mark.parametrize("cfg_over,step_kw,error,match", [
    ({}, dict(traced_w=True), ValueError, "not supported"),
    ({}, dict(participation=True), ValueError, "not supported"),
    ({}, dict(byzantine=True), ValueError, "not supported"),
    (dict(topology_cycle=CYCLE, mixing_impl="fused_ring"), {}, ValueError,
     "mixing_impl='fused_ring' is not supported with topology_cycle; use "
     "'dense', 'fused_dense', or 'pallas_packed'"),
    (dict(topology_cycle=CYCLE, mixing_impl="sparse_packed"), {},
     ValueError, "mixing_impl='sparse_packed' is not supported with "
     "topology_cycle; use traced_w with a per-round sampler instead"),
    (dict(topology_cycle=CYCLE, mixing_impl="trimmed_mean"), {},
     ValueError, "mixing_impl='trimmed_mean' is not supported with "
     "topology_cycle; use traced_w"),
    (dict(topology_cycle=CYCLE, mixing_impl="sparse_coord_median"), {},
     ValueError, "mixing_impl='sparse_coord_median' is not supported with "
     "topology_cycle")],
    ids=["traced_w", "participation", "byzantine", "cycle_ring",
         "cycle_sparse_packed", "cycle_trimmed_mean",
         "cycle_sparse_coord_median"])
def test_round_step_refusals_on_the_mesh(cfg_over, step_kw, error, match):
    """``make_round_step(axis=)`` runs every lowering on a static W or a
    ``topology_cycle``, with static or traced stepsizes; it refuses a
    per-round W, participation and the adversary (as the reference's
    mesh does), and a cycle with the ring lowerings, ``sparse_packed`` and
    the robust rules, in the reference's words
    (``repro/core/kgt_minimax.py:250-258``, ``:285-291``)."""
    from repro_torch.configs import AlgorithmConfig
    from repro_torch.core import kgt_minimax as kgt
    from repro_torch.core import make_quadratic_data, quadratic_problem
    from repro_torch.dist import collectives

    data = make_quadratic_data(torch.Generator().manual_seed(0), 4, dx=3,
                               dy=2)
    cfg = AlgorithmConfig(num_clients=4, **cfg_over)
    with pytest.raises(error, match=match):
        kgt.make_round_step(quadratic_problem(data), cfg, device="cpu",
                            axis=collectives.ClientsAxis(n=4, rank=0, size=2),
                            **step_kw)


def test_cli_on_a_world_of_one(tmp_path):
    """``python -m repro_torch.launch.train --mesh decentralized`` outside
    torchrun runs a world of one rank and writes its history."""
    out = tmp_path / "hist.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(key, None)
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--mesh",
         "decentralized", "--arch", ARCH, "--reduced", "--device", "cpu",
         "--clients", "2", "--local-steps", "1", "--batch", "2",
         "--seq-len", "16", "--groups", "4", "--rounds", "2",
         "--log-every", "1", "--out", str(out)], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "capture=off (mesh)" in res.stdout
    import json

    assert [r["round"] for r in json.loads(out.read_text())["history"]] == [
        0, 1]
