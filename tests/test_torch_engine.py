"""The port's engine beyond the chunk (``repro_torch.engine.engine``), its
checkpoints (``repro_torch.checkpoint``) and telemetry (``repro_torch.obs``),
on the CPU.

* Checkpoints cross between the packages in both directions: the same
  ``leaf_%05d`` arrays (round an int32 scalar) and metadata.
* A run restored mid-way continues bit for bit (quadratic; per-round W and
  mask), ``checkpoint_hook`` fires on boundary crossings and
  ``boundary_every`` lands checkpoints on exact multiples, ``stop_fn``
  exits at a boundary, telemetry spans and hooks, as the reference's
  ``tests/test_engine.py`` and ``tests/test_obs.py`` hold them.
* The CUDA graph path with a fake graph (``FakeGraph``: capture runs the
  body once, a replay runs it again with the launch counts held): the chunk
  over pre-drawn static buffers is bit for bit ``chunk_program``, replayed
  launches count once a replay, a returned state aliases no buffer, and a
  graph is captured again exactly when a baked-in host value changes.

Exact comparisons are ``torch.equal``; the ledger's integers are equal to
the reference's.
"""
import _torch_threads  # noqa: F401
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jax_obs
from repro.checkpoint import checkpoint as jax_ckpt
from repro.core import KGTState as JaxKGTState
from repro_torch import engine as engine_lib
from repro_torch import obs
from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.configs import AlgorithmConfig
from repro_torch.core import (
    KGTState,
    init_state,
    make_quadratic_data,
    make_round_step,
    quadratic_problem,
)
from repro_torch.core import sparse_topology as sp_lib
from repro_torch.core import stochastic_topology as st_lib
from repro_torch.core import tree as tree_lib
from repro_torch.kernels import gossip, ops

DEV = "cpu"
N, K, DX, DY = 4, 3, 6, 3


class FakeGraph:
    """A CUDA graph's protocol on the CPU: the warm-up and the capture run
    the body (the capture's launch counts are recorded by the engine), a
    replay runs it again without counting, as a real replay runs no
    Python.  As a real capture, which runs no work on the device, the
    capture stores nothing into the output buffers: the replays do."""

    replays = 0
    capturing = False

    def warm_up(self, fn):
        return fn()

    def capture(self, fn):
        self.fn = fn
        self.capturing = True
        try:
            fn()
        finally:
            self.capturing = False

    def replay(self):
        FakeGraph.replays += 1
        with ops.uncounted():
            self.fn()

    def write(self, dst, src):
        if not self.capturing:
            dst.copy_(src)


@pytest.fixture
def fake_graph(monkeypatch):
    monkeypatch.setattr(engine_lib.ChunkRunner, "graph_type", FakeGraph)
    FakeGraph.replays = 0


def _setup(impl="dense", algo="kgt_minimax", sigma=0.4, churn=None, rate=0.6,
           lr_scale=None, topology_cycle=()):
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    data = make_quadratic_data(gen, N, dx=DX, dy=DY, heterogeneity=1.5)
    prob = quadratic_problem(data, sigma=sigma)
    cfg = AlgorithmConfig(
        algorithm=algo, num_clients=N, local_steps=K, eta_cx=0.01,
        eta_cy=0.1, eta_sx=0.5, eta_sy=0.5, topology="ring",
        mixing_impl=impl, topology_cycle=topology_cycle)
    cb = {k: v for k, v in data.items() if k != "mu"}
    batches = {k: v.unsqueeze(0).expand(K, *v.shape) for k, v in cb.items()}
    st = init_state(prob, cfg, gen, init_batch=cb)
    sampler = engine_lib.make_fixed_batch_sampler(
        batches, local_steps=K, num_clients=N, noise_dim=prob.noise_dim,
        seed=0, device=DEV)
    kw = {}
    if churn is not None:
        if impl == "sparse_packed":
            w_fn = sp_lib.make_sparse_w_sampler(
                churn, sp_lib.sparse_mixing_matrix("ring", N), 7, device=DEV)
        else:
            w_fn = st_lib.make_w_sampler(churn, N, 7, device=DEV)
        mask_fn = st_lib.make_participation_sampler(N, 7, rate, device=DEV)
        sampler = engine_lib.with_topology(sampler, w_fn=w_fn,
                                           mask_fn=mask_fn)
        kw = dict(traced_w=True, participation=True)
    step = make_round_step(prob, cfg, lr_scale=lr_scale, device=DEV, **kw)
    return prob, st, step, sampler


def _assert_states_equal(a, b, what=""):
    assert a.round == b.round, what
    for name in ("x", "y", "cx", "cy"):
        assert torch.equal(getattr(a, name), getattr(b, name)), (what, name)


def _zeros_like(state):
    return tree_lib.tree_map(
        lambda x: torch.zeros_like(x) if isinstance(x, torch.Tensor) else 0,
        state)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _numpy_state(rng, x_dict: bool):
    x = ({"a": rng.standard_normal((N, 2, 3)).astype(np.float32),
          "b": rng.standard_normal((N, 4)).astype(np.float32)}
         if x_dict else rng.standard_normal((N, DX)).astype(np.float32))
    leaves = {name: rng.standard_normal((N, DY)).astype(np.float32)
              for name in ("y", "cy")}
    cx = jax.tree.map(lambda a: (a * 0.5).astype(np.float32), x)
    return x, leaves["y"], cx, leaves["cy"]


@pytest.mark.parametrize("x_dict", [False, True])
def test_checkpoint_from_the_reference_restores_in_the_port(tmp_path,
                                                            x_dict):
    x, y, cx, cy = _numpy_state(np.random.default_rng(1), x_dict)
    ref = JaxKGTState(x=jax.tree.map(jnp.asarray, x), y=jnp.asarray(y),
                      cx=jax.tree.map(jnp.asarray, cx), cy=jnp.asarray(cy),
                      round=jnp.int32(17))
    path = str(tmp_path / "round_000017.npz")
    jax_ckpt.save(path, ref, metadata={"round": 17, "note": "ref"})
    template = KGTState(
        x=tree_lib.tree_map(torch.zeros_like,
                            tree_lib.tree_map(torch.as_tensor, x)),
        y=torch.zeros(N, DY), cx=tree_lib.tree_map(
            torch.zeros_like, tree_lib.tree_map(torch.as_tensor, cx)),
        cy=torch.zeros(N, DY), round=0)
    got = ckpt_lib.restore(path, template)
    assert got.round == 17 and isinstance(got.round, int)
    for name, want in (("x", x), ("y", y), ("cx", cx), ("cy", cy)):
        for a, b in zip(tree_lib.leaves(getattr(got, name)),
                        jax.tree.leaves(want)):
            np.testing.assert_array_equal(a.numpy(), b)
    assert ckpt_lib.load_metadata(path) == {"round": 17, "note": "ref"}
    assert ckpt_lib.latest(str(tmp_path)) == path


@pytest.mark.parametrize("x_dict", [False, True])
def test_checkpoint_from_the_port_restores_in_the_reference(tmp_path,
                                                            x_dict):
    x, y, cx, cy = _numpy_state(np.random.default_rng(2), x_dict)
    state = KGTState(x=tree_lib.tree_map(torch.as_tensor, x),
                     y=torch.as_tensor(y),
                     cx=tree_lib.tree_map(torch.as_tensor, cx),
                     cy=torch.as_tensor(cy), round=9)
    path = str(tmp_path / "round_000009.npz")
    ckpt_lib.save(path, state, metadata={"round": 9})
    with np.load(path) as z:
        assert z[f"leaf_{len(z.files) - 1:05d}"].dtype == np.int32
    template = JaxKGTState(
        x=jax.tree.map(jnp.zeros_like, x), y=jnp.zeros((N, DY)),
        cx=jax.tree.map(jnp.zeros_like, cx), cy=jnp.zeros((N, DY)),
        round=jnp.int32(0))
    got = jax_ckpt.restore(path, template)
    assert int(got.round) == 9 and got.round.dtype == jnp.int32
    for name, want in (("x", x), ("y", y), ("cx", cx), ("cy", cy)):
        for a, b in zip(jax.tree.leaves(getattr(got, name)),
                        jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), b)
    assert jax_ckpt.load_metadata(path) == {"round": 9}


def test_checkpoint_restore_refuses_a_shape_mismatch(tmp_path):
    _, st, _, _ = _setup()
    path = str(tmp_path / "c.npz")
    ckpt_lib.save(path, st)
    bad = KGTState(x=torch.zeros(N, DX + 1), y=st.y, cx=st.cx, cy=st.cy,
                   round=0)
    with pytest.raises(ValueError, match="leaf 0"):
        ckpt_lib.restore(path, bad)


@pytest.mark.parametrize("churn", [None, "erdos_renyi"])
def test_checkpoint_restore_resumes_identical_trajectory(tmp_path, churn):
    """Restoring round 4 replays rounds 4..8 bit for bit, in chunks that do
    not align with the first leg's (tests/test_engine.py:187, :246)."""
    _, st, step, sampler = _setup(churn=churn)
    build = engine_lib.make_chunk_builder(step, sampler)
    hook = engine_lib.checkpoint_hook(str(tmp_path), every=4)
    full, _ = engine_lib.run(st, build, total_rounds=9, chunk_rounds=2,
                             hooks=[hook])
    path = str(tmp_path / "round_000004.npz")
    assert ckpt_lib.load_metadata(path)["round"] == 4
    resumed = ckpt_lib.restore(path, _zeros_like(st))
    assert resumed.round == 4
    resumed, _ = engine_lib.run(resumed, build, total_rounds=9,
                                chunk_rounds=3)
    _assert_states_equal(resumed, full, "resume")


def test_checkpoint_hook_fires_on_boundary_crossings(tmp_path):
    _, st, step, sampler = _setup()
    build = engine_lib.make_chunk_builder(step, sampler)
    hook = engine_lib.checkpoint_hook(str(tmp_path), every=5)
    engine_lib.run(st, build, total_rounds=12, chunk_rounds=4, hooks=[hook])
    names = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert names == ["round_000008.npz", "round_000012.npz"]


def test_boundary_every_aligns_checkpoints_to_exact_multiples(tmp_path):
    _, st, step, sampler = _setup()
    build = engine_lib.make_chunk_builder(step, sampler)
    hook = engine_lib.checkpoint_hook(str(tmp_path), every=5,
                                      metadata={"run": "t"})
    engine_lib.run(st, build, total_rounds=12, chunk_rounds=4, hooks=[hook],
                   boundary_every=5)
    names = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert names == ["round_000005.npz", "round_000010.npz"]
    with open(tmp_path / "round_000010.npz.meta.json") as f:
        assert json.load(f) == {"run": "t", "round": 10}


# ---------------------------------------------------------------------------
# engine.run: stop_fn, records, telemetry
# ---------------------------------------------------------------------------

def test_stop_fn_exits_at_chunk_boundary():
    prob, st, step, sampler = _setup()
    build = engine_lib.make_chunk_builder(
        step, sampler, engine_lib.quadratic_metrics_fn(prob), log_every=2)
    seen = []

    def stop(records):
        seen.append([r["round"] for r in records])
        return any(r["round"] >= 4 for r in records)

    final, hist = engine_lib.run(st, build, total_rounds=20, chunk_rounds=3,
                                 stop_fn=stop)
    assert final.round == 6
    assert [h["round"] for h in hist] == [0, 2, 4]
    assert seen == [[0, 2], [4]]
    for rec in hist:
        assert rec["run_s"] == max(
            rec["wall_s"] - rec["build_s"] - rec["capture_s"], 0.0)


def test_row_to_record_and_buffer():
    rec = engine_lib.row_to_record(
        {"a": np.float32(1.5), "v": np.arange(3.0)}, np.int32(7))
    assert rec == {"round": 7, "a": 1.5, "v": [0.0, 1.0, 2.0]}
    buf = (["a", "b"], [3, 5], torch.tensor([[1.0, 2.0], [3.0, 4.0]]),
           [(), ()])
    assert engine_lib.records_from_buffer(buf) == [
        {"round": 3, "a": 1.0, "b": 2.0}, {"round": 5, "a": 3.0, "b": 4.0}]
    assert engine_lib.records_from_buffer((["a"], [], None, [()])) == []


@pytest.mark.parametrize("capture", [False, True])
def test_vector_metric_rows(monkeypatch, capture):
    """A vector metric beside the scalars (as the DRO metrics' (G,)
    ``eval_group_loss``), in eager and captured chunks: the buffer row holds
    the metrics flattened in order with their shapes, ``records_from_buffer``
    gives the vector as a list, and the scalars are those of a run without
    it."""
    if capture:
        monkeypatch.setattr(engine_lib.ChunkRunner, "graph_type", FakeGraph)
    prob, st, step, sampler = _setup()
    base = engine_lib.quadratic_metrics_fn(prob)

    def metrics(state, batches):
        return {**base(state, batches), "x_bar": state.x.mean(0)}

    _, buf = engine_lib.make_chunk_builder(step, sampler, metrics,
                                           log_every=2, capture=capture)(3)(
        st, 4)
    names, rounds, rows, shapes = buf
    assert rounds == [0, 2] and names[-1] == "x_bar"
    assert shapes == [()] * (len(names) - 1) + [(DX,)]
    assert rows.shape == (2, len(names) - 1 + DX)
    final, hist = engine_lib.run(
        st, engine_lib.make_chunk_builder(step, sampler, metrics,
                                          log_every=2, capture=capture),
        total_rounds=5, chunk_rounds=3, wall_clock=False)
    _, plain = engine_lib.run(
        st, engine_lib.make_chunk_builder(step, sampler, base, log_every=2,
                                          capture=False),
        total_rounds=5, chunk_rounds=3, wall_clock=False)
    assert [{k: v for k, v in r.items() if k != "x_bar"} for r in hist] == \
        plain
    assert all(isinstance(r["x_bar"], list) and len(r["x_bar"]) == DX
               for r in hist)
    assert hist[-1]["x_bar"] == final.x.mean(0).tolist()


def test_engine_bit_identical_with_telemetry_on(fake_graph):
    """A full telemetry stack (spans, metrics/ledger/health hook) leaves
    the state and history bit for bit those of a plain run; the stream
    holds dispatch, readback and capture spans (tests/test_obs.py:113)."""
    prob, st, step, sampler = _setup()
    cfg = AlgorithmConfig(algorithm="kgt_minimax", num_clients=N,
                          local_steps=K, topology="ring")
    metrics = engine_lib.quadratic_metrics_fn(prob)
    st_plain, hist_plain = engine_lib.run(
        st, engine_lib.make_chunk_builder(step, sampler, metrics,
                                          log_every=2, capture=True),
        total_rounds=10, chunk_rounds=4, wall_clock=False)
    sink = obs.MemorySink()
    tel = obs.Telemetry([sink])
    ledger = obs.ledger_for_state(cfg, st)
    hook = engine_lib.telemetry_hook(
        tel, ledger=ledger,
        health_fn=lambda s: {"corr_x_norm": float(
            (s.cx.mean(0) ** 2).sum().sqrt())})
    st_tel, hist_tel = engine_lib.run(
        st, engine_lib.make_chunk_builder(step, sampler, metrics,
                                          log_every=2, capture=True),
        total_rounds=10, chunk_rounds=4, wall_clock=False, hooks=[hook],
        telemetry=tel)
    _assert_states_equal(st_plain, st_tel, "telemetry on/off")
    assert hist_plain == hist_tel
    spans = [e for e in sink.events if e["type"] == "span"]
    names = [e["name"] for e in spans]
    assert names.count("dispatch") == 3 and names.count("readback") == 3
    # chunks at rounds 0, 4 (log patterns (T,F,T,F), (T,F,T,F)) and 8
    # (final round 9 logs too): two captures
    captures = [e for e in spans if e["name"] == "capture"]
    assert [e["round"] for e in captures] == [0, 8]
    assert all(e["dur_s"] > 0 for e in captures)
    assert {"span", "metrics", "ledger", "gauge"} <= {
        e["type"] for e in sink.events}
    assert ledger.rounds == 10


def test_telemetry_hook_emits_per_boundary():
    """tests/test_obs.py:141 on the port."""
    sink = obs.MemorySink()
    tel = obs.Telemetry([sink])
    comm = obs.round_comm(mixing_impl="dense", n=4, dims=(6, 3))
    ledger = obs.CommLedger(comm)
    calls = []

    def health(state):
        calls.append(state.round)
        return {"corr_x_drift": 0.0}

    hook = engine_lib.telemetry_hook(tel, ledger=ledger, health_fn=health,
                                     health_every=2)

    class S:
        def __init__(self, r):
            self.round = r

    hook(S(4), [{"round": 1}, {"round": 3}], 0)
    hook(S(8), [{"round": 5}], 4)
    hook(S(12), [], 8)
    metrics = [e for e in sink.events if e["type"] == "metrics"]
    ledgers = [e for e in sink.events if e["type"] == "ledger"]
    gauges = [e for e in sink.events if e["type"] == "gauge"]
    assert [m["round"] for m in metrics] == [1, 3, 5]
    assert [e["rounds"] for e in ledgers] == [4, 4, 4]
    assert ledgers[-1]["rounds_total"] == 12
    assert ledgers[-1]["bytes_total"] == 12 * comm.bytes_per_round
    assert calls == [4, 12]
    assert all(g["name"] == "corr_x_drift" for g in gauges)


@pytest.mark.parametrize("impl", ["dense", "ring", "fused_dense",
                                  "pallas_packed", "sparse_packed",
                                  "fused_round"])
@pytest.mark.parametrize("algo", ["kgt_minimax", "local_sgda"])
def test_round_comm_matches_the_reference(impl, algo):
    kw = dict(mixing_impl=impl, n=8, dims=(10, 5), topology="ring",
              track=algo == "kgt_minimax", gossip_dtype="bfloat16")
    got, want = obs.round_comm(**kw), jax_obs.round_comm(**kw)
    assert got.describe() == want.describe()


# ---------------------------------------------------------------------------
# the CUDA graph path, with a fake graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("churn", [None, "erdos_renyi"])
@pytest.mark.parametrize("impl", ["dense", "pallas_packed", "sparse_packed",
                                  "fused_round"])
def test_captured_chunks_are_bit_for_bit_chunk_program(fake_graph, impl,
                                                       churn):
    """The chunk over pre-drawn static buffers (state in, draws copied in,
    state and rows out) against the eager ``chunk_program``, over chunks
    that replay a graph, capture a new log pattern and end off the grid."""
    prob, st, step, sampler = _setup(impl=impl, churn=churn)
    metrics = engine_lib.quadratic_metrics_fn(prob)
    runs = {}
    for capture in (False, True):
        build = engine_lib.make_chunk_builder(step, sampler, metrics,
                                              log_every=2, capture=capture)
        runs[capture] = engine_lib.run(st, build, total_rounds=10,
                                       chunk_rounds=3, wall_clock=False)
        runs[capture] += (build.stats,)
    (s0, h0, _), (s1, h1, stats) = runs[False], runs[True]
    _assert_states_equal(s0, s1, f"{impl} {churn}")
    assert h0 == h1
    assert stats["replays"] == 4 == FakeGraph.replays
    # log patterns (T,F,T) at 0 and 6, (F,T,F) at 3, (T,) at 9: three
    # graphs, one more where the state's layout changed (fused_round's x,
    # y come out as views of one packed buffer)
    assert 3 <= stats["captures"] <= 4


def test_chunk_program_is_the_eager_runner():
    prob, st, step, sampler = _setup()
    metrics = engine_lib.quadratic_metrics_fn(prob)
    a, buf_a = engine_lib.chunk_program(step, sampler, metrics,
                                        log_every=2, length=5)(st, 4)
    b, buf_b = engine_lib.make_chunk_builder(
        step, sampler, metrics, log_every=2, capture=False)(5)(st, 4)
    _assert_states_equal(a, b)
    assert buf_a[:2] == buf_b[:2] == (list(buf_a[0]), [0, 2, 4])
    assert torch.equal(buf_a[2], buf_b[2])


def test_fixed_draws_are_baked_and_per_round_draws_copied(fake_graph):
    """Only the noise is copied in a round; the batch (the same tensor every
    round) is read where it lies.  One-round chunks probe a round outside
    the chunk, so their noise is not mistaken for a fixed tensor."""
    _, st, step, sampler = _setup()
    runner = engine_lib.ChunkRunner(step, capture=True)
    state = st
    for _ in range(5):
        state, _ = runner(state, 9, sampler=sampler, length=1)
    assert runner.stats["captures"] == 1 and runner.stats["replays"] == 5
    graph = next(iter(runner._graphs.values()))
    batches, noise = sampler(0)
    fixed = [t for t in graph.fixed if t is not None]
    assert {id(t) for t in fixed} == {id(v) for v in batches.values()}
    assert len(graph.tensor_pos) == 1 and len(graph.draw_bufs) == 1
    eager = st
    for r in range(5):
        eager, _ = engine_lib.chunk_program(step, sampler, length=1)(eager, 9)
    _assert_states_equal(state, eager)


def test_replayed_launch_counts_scale_with_replays(fake_graph):
    """A round that launches one gossip pair: the warm-up and the capture
    leave the counts alone, each replay adds the launches the capture
    recorded, by route."""
    _, st, step, sampler = _setup()

    def counting_step(state, batches, noise, *extras):
        gossip.fused_gossip_nd.launches += 1
        gossip.fused_gossip_nd.routes["unrolled"] += 1
        return step(state, batches, noise, *extras)

    counting_step.uses_round = False
    ops.zero_launch_counts()
    build = engine_lib.make_chunk_builder(counting_step, sampler,
                                          capture=True)
    engine_lib.run(st, build, total_rounds=12, chunk_rounds=4)
    assert build.stats["captures"] == 1 and build.stats["replays"] == 3
    assert ops.launch_counts()["fused_gossip"] == 12
    assert ops.route_counts()["fused_gossip"] == {"unrolled": 12, "tiled": 0}
    engine_lib.run(st, build, total_rounds=8, chunk_rounds=4)
    assert build.stats["captures"] == 1
    assert ops.launch_counts()["fused_gossip"] == 20
    ops.zero_launch_counts()


def test_returned_state_aliases_no_buffer_of_the_builder(fake_graph):
    _, st, step, sampler = _setup()
    runner = engine_lib.ChunkRunner(step, capture=True)
    s1, _ = runner(st, 99, sampler=sampler, length=3)
    kept = {k: getattr(s1, k).clone() for k in ("x", "y", "cx", "cy")}
    s2, _ = runner(s1, 99, sampler=sampler, length=3)
    s3, _ = runner(s2, 99, sampler=sampler, length=3)
    assert runner.stats["replays"] == 3
    graph = next(iter(runner._graphs.values()))
    buffers = [b for b, _ in graph.st_bufs + graph.out_bufs]
    buffers += [b for bufs in graph.draw_bufs for b, _ in bufs]
    owned = {b.untyped_storage().data_ptr() for b in buffers}
    for s in (s1, s2, s3):
        for k in ("x", "y", "cx", "cy"):
            assert getattr(s, k).untyped_storage().data_ptr() not in owned
    for k, v in kept.items():
        assert torch.equal(getattr(s1, k), v)
    assert not torch.equal(s3.x, s1.x)


@pytest.mark.parametrize("shared", [False, True])
def test_donated_state_becomes_the_runners_buffers(fake_graph, shared):
    """``donate=True``: the state handed in becomes the static input
    buffers, each chunk stores the new state back into them and returns
    views of them, bit for bit the eager run.  Two leaves on one memory
    (``shared``: y and cy one tensor) are not both taken over: the second
    gets a buffer of its own."""
    prob, st, step, sampler = _setup()
    if shared:
        st = dataclasses.replace(st, cy=st.y)
    metrics = engine_lib.quadratic_metrics_fn(prob)
    eager, h0 = engine_lib.run(
        st, engine_lib.make_chunk_builder(step, sampler, metrics,
                                          log_every=2, capture=False),
        total_rounds=10, chunk_rounds=3, wall_clock=False)
    given = tree_lib.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, st)
    if shared:
        given = dataclasses.replace(given, cy=given.y)
    build = engine_lib.make_chunk_builder(step, sampler, metrics,
                                          log_every=2, capture=True,
                                          donate=True)
    final, h1 = engine_lib.run(given, build, total_rounds=10,
                               chunk_rounds=3, wall_clock=False)
    _assert_states_equal(eager, final)
    assert h0 == h1 and build.stats["replays"] == 4
    owned = ("x", "y", "cx") if shared else ("x", "y", "cx", "cy")
    for k in owned:
        assert getattr(final, k).data_ptr() == getattr(given, k).data_ptr()
        assert torch.equal(getattr(given, k), getattr(final, k))
    if shared:
        assert final.cy.data_ptr() != given.cy.data_ptr()
        assert torch.equal(given.y, final.y)


@pytest.mark.parametrize("kind", ["lr_scale", "topology_cycle"])
def test_round_dependent_steps_capture_per_chunk_start(fake_graph, kind):
    """A step that reads the round (an lr schedule, a topology cycle) bakes
    it in: one capture per chunk start, bit for bit the eager run."""
    kw = (dict(lr_scale=lambda r: 1.0 / (1 + 0.1 * r)) if kind == "lr_scale"
          else dict(topology_cycle=("ring", "full")))
    _, st, step, sampler = _setup(**kw)
    assert step.uses_round
    runs = {}
    for capture in (False, True):
        build = engine_lib.make_chunk_builder(step, sampler, capture=capture)
        runs[capture] = engine_lib.run(st, build, total_rounds=9,
                                       chunk_rounds=3)[0], build.stats
    _assert_states_equal(runs[False][0], runs[True][0], kind)
    assert runs[True][1]["captures"] == 3


def test_plain_steps_do_not_read_the_round():
    _, _, step, _ = _setup()
    assert step.uses_round is False


def test_capture_without_a_graph_raises():
    """No silent fallback: on the CPU there is no CUDA graph to capture."""
    _, st, step, sampler = _setup()
    build = engine_lib.make_chunk_builder(step, sampler, capture=True)
    with pytest.raises((RuntimeError, AssertionError, AttributeError)):
        engine_lib.run(st, build, total_rounds=2, chunk_rounds=2)


def test_tree_flattens_dataclasses_in_field_order():
    sp = sp_lib.sparse_mixing_matrix("ring", 5)
    leaves, treedef = tree_lib.flatten(sp)
    assert [t is getattr(sp, f) for t, f in zip(
        leaves, ("neighbor_idx", "neighbor_w", "self_w", "degree"))] == [
        True] * 4
    rebuilt = tree_lib.unflatten(treedef, leaves)
    assert isinstance(rebuilt, sp_lib.SparseTopology)
    st = KGTState(x={"b": torch.ones(2), "a": torch.zeros(2)},
                  y=torch.ones(1), cx=None, cy=torch.ones(1), round=3)
    leaves, _ = tree_lib.flatten(st)
    assert leaves[-1] == 3 and torch.equal(leaves[0], torch.zeros(2))
