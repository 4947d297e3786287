"""The rest of ``obs`` against the JAX package: ``health_gauges`` on the
same states (the EF norms only under compression), ``report`` on the same
JSONL (``summarize``, ``render``, ``main``), and the ``Profiler`` window on
the CPU.  ``report`` is a copy of pure Python, so it must agree exactly on
a stream with the reference's stamps; the gauges are f32 reductions in
another order, 1e-6 relative.
"""
import _torch_threads  # noqa: F401
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_round as tr
from repro.configs.base import AlgorithmConfig as JaxConfig
from repro.core import init_state as jax_init_state
from repro.core import quadratic_problem as jax_quadratic_problem
from repro.obs import profiler as jax_profiler
from repro.obs import report as jax_report
from repro_torch import engine as engine_lib
from repro_torch import obs
from repro_torch.configs import AlgorithmConfig
from repro_torch.core import (
    from_reference,
    init_state,
    make_quadratic_data,
    make_round_step,
    quadratic_problem,
)
from repro_torch.obs import report

N, K = tr.N, 4


def _jax_state(method):
    key, data = tr._reference_data()
    prob = jax_quadratic_problem(data, sigma=0.1)
    cfg = JaxConfig(**tr._cfg_kwargs("kgt_minimax", K),
                    mixing_impl="pallas_packed", gossip_compress=method)
    cb = {n: v for n, v in data.items() if n != "mu"}
    st = jax_init_state(prob, cfg, key, init_batch=cb,
                        init_keys=jax.random.split(key, N))
    if method:
        rng = np.random.default_rng(2)
        st = dataclasses.replace(
            st, ef_x=jnp.asarray(rng.standard_normal(st.ef_x.shape),
                                 jnp.float32),
            ef_y=jnp.asarray(rng.standard_normal(st.ef_y.shape),
                             jnp.float32))
    return st


@pytest.mark.parametrize("method", [None, "int8"])
def test_health_gauges_match_the_reference(method):
    jst = _jax_state(method)
    _, st = from_reference(None, tr._state_np(jst), device="cpu")
    if method:
        st.ef_x = torch.as_tensor(np.array(jst.ef_x))
        st.ef_y = torch.as_tensor(np.array(jst.ef_y))
    got = obs.health_gauges(st)
    want = jax_profiler.health_gauges(jst)
    assert set(got) == set(want)
    assert ("ef_x_norm" in got) == bool(method)
    for name, v in want.items():
        assert got[name] == pytest.approx(v, rel=1e-6, abs=1e-7), name


def _stream(path):
    """A telemetry JSONL of a short engine run with the port's telemetry
    stack: spans, metrics, the ledger, health gauges and a meta event."""
    gen = torch.Generator().manual_seed(0)
    data = make_quadratic_data(gen, N, dx=tr.DX, dy=tr.DY)
    prob = quadratic_problem(data, sigma=0.1)
    cfg = AlgorithmConfig(**tr._cfg_kwargs("kgt_minimax", K),
                          mixing_impl="pallas_packed", gossip_compress="bf16")
    cb = {n: v for n, v in data.items() if n != "mu"}
    st = init_state(prob, cfg, gen, init_batch=cb)
    batches = {n: v.unsqueeze(0).expand(K, *v.shape) for n, v in cb.items()}
    sampler = engine_lib.make_fixed_batch_sampler(
        batches, local_steps=K, num_clients=N, noise_dim=prob.noise_dim,
        device="cpu")
    step = make_round_step(prob, cfg, device="cpu")
    tel = obs.Telemetry([obs.JsonlSink(str(path))])
    tel.meta("run", arch="quadratic", mixing_impl=cfg.mixing_impl)
    hook = engine_lib.telemetry_hook(tel, ledger=obs.ledger_for_state(cfg, st),
                                     health_fn=obs.health_gauges)
    st, hist = engine_lib.run(
        st, engine_lib.make_chunk_builder(
            step, sampler, engine_lib.quadratic_metrics_fn(prob),
            log_every=2),
        total_rounds=8, chunk_rounds=4, hooks=[hook], telemetry=tel)
    tel.counter("compile_cache.hits", 2)
    tel.close()
    return st, hist


def test_report_matches_the_reference_on_the_same_jsonl(tmp_path, capsys):
    path = tmp_path / "run.jsonl"
    _, hist = _stream(path)
    # the port's stamps: build_s and capture_s beside wall_s and run_s
    assert {"build_s", "capture_s", "run_s"} <= set(hist[-1])
    events = report.load(str(path))
    assert events == jax_report.load(str(path))
    got = report.summarize(events)
    assert got["rounds"] == 8 and got["ledger"]["rounds"] == 8
    assert "ef_x_norm" in got["gauges"] and "capture_s" in got
    assert "capture_s" not in got["tail"] and "build_s" not in got["tail"]
    assert got["compile_cache"] == {"hits": 2}
    # on the reference's stamps (no build_s / capture_s) the two agree
    # exactly, summary and rendering
    ref_path = tmp_path / "ref.jsonl"
    with open(ref_path, "w") as f:
        for ev in events:
            ev = {k: v for k, v in ev.items()
                  if k not in ("build_s", "capture_s")}
            if ev["type"] == "metrics":
                ev["compile_s"] = 0.5
            f.write(json.dumps(ev) + "\n")
    ref_events = report.load(str(ref_path))
    ours, theirs = report.summarize(ref_events), jax_report.summarize(
        ref_events)
    assert ours == theirs
    assert report.render(ours) == jax_report.render(theirs)
    assert report.main([str(ref_path)]) == 0
    out_ours = capsys.readouterr().out
    assert jax_report.main([str(ref_path)]) == 0
    assert out_ours == capsys.readouterr().out
    assert report.main([str(ref_path), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["rounds"] == 8


@pytest.mark.parametrize("content", ["", "{not json\n", '[1, 2]\n'])
def test_report_refuses_a_malformed_artifact(tmp_path, capsys, content):
    path = tmp_path / "bad.jsonl"
    path.write_text(content)
    assert report.main([str(path)]) == 1
    assert jax_report.main([str(path)]) == 1
    err = capsys.readouterr().err
    assert "repro_torch.obs.report:" in err
    assert report.main([str(tmp_path / "missing.jsonl")]) == 1


def test_profiler_window_closes_after_its_rounds(tmp_path):
    gen = torch.Generator().manual_seed(1)
    data = make_quadratic_data(gen, N, dx=tr.DX, dy=tr.DY)
    prob = quadratic_problem(data, sigma=0.1)
    cfg = AlgorithmConfig(**tr._cfg_kwargs("kgt_minimax", K),
                          mixing_impl="pallas_packed")
    cb = {n: v for n, v in data.items() if n != "mu"}
    st = init_state(prob, cfg, gen, init_batch=cb)
    batches = {n: v.unsqueeze(0).expand(K, *v.shape) for n, v in cb.items()}
    sampler = engine_lib.make_fixed_batch_sampler(
        batches, local_steps=K, num_clients=N, noise_dim=prob.noise_dim,
        device="cpu")
    build = engine_lib.make_chunk_builder(make_round_step(prob, cfg,
                                                          device="cpu"),
                                          sampler)
    prof = obs.Profiler(str(tmp_path / "trace"), num_rounds=4)
    closed_at = []

    def watch(state, records, prev_round):
        if not prof.active and not closed_at:
            closed_at.append(int(state.round))

    prof.start()
    assert prof.active
    engine_lib.run(st, build, total_rounds=10, chunk_rounds=2,
                   hooks=[prof.hook, watch])
    assert closed_at == [4] and not prof.active
    assert len(prof.paths) == 1
    trace = json.loads(open(prof.paths[0]).read())
    assert trace["traceEvents"]                       # a non-empty trace
    prof.stop()                                       # idempotent
    assert len(prof.paths) == 1
    with obs.Profiler(str(tmp_path / "whole")) as whole:
        engine_lib.run(st, build, total_rounds=2, chunk_rounds=2,
                       hooks=[whole.hook])
        assert whole.active                           # 0 = the whole run
    assert not whole.active and len(whole.paths) == 1
