#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, from the repository root

Phases, each printing one JSON line:

1. card — ``nvidia-smi`` name and power limit;
2. build — nvcc builds every kernel of ``src/repro_torch/kernels/csrc``;
3. kernels — each CUDA kernel against its plain PyTorch version on the
   card, at the stated tolerances;
4. main — K-GT-Minimax and its three baselines through ``engine.run`` at
   the full round geometry (n = 8, K = 8, dx = 384, dy = 128, ring,
   σ = 0.1), 50 rounds per (algorithm, mixing_impl); the packed and
   whole-round lowerings must match ``dense``, and the kernels' launch
   counts must be what the path implies;
5. quickstart — at the quickstart geometry (fused_round) K-GT-Minimax
   must end below local SGDA, with one whole-round launch a round;
6. times — CUDA-event medians of each kernel and its plain version, the
   bounds, the epilogue at D ≈ 1e8, and rounds/s per mixing_impl.

``--phases card,build,profile`` adds a torch.profiler pass over a few
engine rounds per lowering (device busy share, top kernels).

Then the ``nvidia-smi`` line, one ``{"kernels": [...]}`` line, and the
last line ``{"ok": true, "device": {...}}``.  Any failed check raises, so
the script exits non-zero and prints no ok-line; without CUDA it exits
non-zero at once.  ``--phases`` runs a subset (for debugging).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

PHASES = ("card", "build", "kernels", "main", "quickstart", "times")
# not part of the default run: torch.profiler over a few engine rounds
EXTRA_PHASES = ("profile",)
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 (non-tensor) flop/s
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12

# main-path geometry (the round rows of benchmarks/bench_gossip.py, ring)
N, K, DX, DY, SIGMA, ROUNDS = 8, 8, 384, 128, 0.1, 50
ALGOS = ("kgt_minimax", "gt_gda", "dsgda", "local_sgda")
TRACKING = ("kgt_minimax", "gt_gda")

# tolerances (max |kernel − plain|); see PERF.md for the reasons
TOL_GOSSIP = 1e-5        # θ' for O(1) operands; c' gets |s|× this
TOL_ROUND = 1e-6         # Δ, z' (the JAX package's own kernel tolerance)
TOL_ROUND_C = 4e-6       # c' (4× as in tests/test_fused_round.py)
TOL_STATE = 1e-4         # 50-round states vs dense, × (1 + max|dense|)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise AssertionError(msg)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def max_err(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def graph_ms(fn, *, reps: int = 21, inner: int = 100) -> float:
    """Device time per call: ``inner`` calls captured in one CUDA graph,
    replayed ``reps`` times, median of CUDA-event times (no host launch
    gaps between the calls)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return cuda_ms(graph.replay, reps=reps) / inner


def cuda_ms(fn, *, reps: int = 21, inner: int = 1) -> float:
    """Median over ``reps`` of the per-call time of ``inner`` back-to-back
    calls, from CUDA events, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def gossip_bound_ms(n: int, d: int):
    byts = 4 * (n * n + 5 * n * d)
    flops = 4 * n * n * d + 6 * n * d
    return _bound(byts, flops)


def round_bound_ms(n: int, dz: int, k: int):
    byts = 4 * (n * n + n * dz * dz + k * n * dz + 7 * n * dz + 3 * n * dz)
    flops = k * (2 * n * dz * dz + 4 * n * dz) + 4 * n * n * dz + 6 * n * dz
    return _bound(byts, flops)


def _bound(byts, flops):
    t_b, t_f = byts / HBM_BYTES_S * 1e3, flops / F32_FLOP_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def gossip_operands(n, d, gen, dev):
    import torch

    w = torch.rand((n, n), generator=gen, device=dev)
    w = w / w.sum(1, keepdim=True)
    delta, theta, c = (torch.randn((n, d), generator=gen, device=dev)
                       for _ in range(3))
    return w, delta, theta, c


def check_gossip(gen, dev) -> float:
    from repro_torch.kernels import gossip, ref

    worst = 0.0
    shapes = [(n, d) for n in (1, 6, 8, 64, 512) for d in (1, 300, 4097)]
    shapes += [(N, DX), (N, DY)]
    eta_s, corr = 0.5, 12.5
    for n, d in shapes:
        args = gossip_operands(n, d, gen, dev)
        for gd in (None, "bfloat16"):
            kt, kc = gossip.fused_gossip_nd(*args, eta_s, corr,
                                            gossip_dtype=gd)
            pt, pc = ref.fused_gossip_ref(*args, eta_s, corr,
                                          gossip_dtype=gd)
            et, ec = max_err(kt, pt), max_err(kc, pc)
            if et > TOL_GOSSIP or ec > TOL_GOSSIP * corr:
                fail(f"fused_gossip n={n} D={d} {gd}: θ err {et}, c err {ec}")
            worst = max(worst, et, ec / corr)
    emit({"phase": "kernels", "kernel": "fused_gossip", "cases":
          len(shapes) * 2, "max_abs_err_theta_or_c_over_s": worst,
          "tol": TOL_GOSSIP})
    return worst


def round_operands(n, dz, k, gen, dev, *, corr_zero=False, mask_rows=None):
    """The JAX package's kernel-test operands (tests/test_fused_round.py)."""
    import torch

    from repro_torch.core.topology import mixing_matrix

    def rn(*shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    w = torch.as_tensor(mixing_matrix("ring", n), dtype=torch.float32,
                        device=dev)
    z0, c, ef = rn(n, dz, scale=0.3), rn(n, dz, scale=0.1), rn(n, dz,
                                                               scale=0.01)
    g = rn(n, dz, dz, scale=0.1 / dz)
    h = rn(k, n, dz, scale=0.05)
    mask = torch.ones((n, dz), device=dev)
    if mask_rows is not None:
        mask[mask_rows] = 0.0
    step = 0.05 * mask
    etas = torch.full((n, dz), 0.5, device=dev)
    corr = (torch.zeros((n, dz), device=dev) if corr_zero
            else rn(dz, scale=0.3).expand(n, dz).contiguous())
    return w, z0, c, ef, g, h, step, etas, corr, mask


def check_round(gen, dev) -> float:
    import torch

    from repro_torch.core.mixing import gossip_torch_dtype, narrow
    from repro_torch.kernels import fused_round, quantize, ref

    worst = full_q = 0.0
    cases = 0
    # (6, 150, 3): the JAX package's kernel-test shape; then the main
    # path's and the quickstart's round geometries
    for (n, dz, k) in ((6, 150, 3), (N, DX + DY, K), (N, 10 + 5, K)):
        variants = [dict(), dict(corr_zero=True), dict(mask_rows=[1, 3])]
        for var in variants:
            args = round_operands(n, dz, k, gen, dev, **var)
            w, z0, c, ef, g, h, step, etas, corr, mask = args
            act = mask > 0
            for compress in (None, "bf16", "int8"):
                for gd in (None, "bfloat16"):
                    kz, kc, ke, kq = fused_round.fused_round_wire(
                        *args, compress=compress, gossip_dtype=gd)
                    # local steps against the plain K steps: q is Δ without
                    # compression, and q + e' is v = mask ⊙ (Δ + e) with it
                    _, _, pd = ref.local_steps_ref(z0, c, ef, g, h, step,
                                                   mask, compress=compress)
                    if compress is None:
                        errs = {"delta": max_err(kq, pd)}
                        if not torch.equal(ke, ef):
                            fail(f"fused_round {n},{dz},{k} {var}: e' != e "
                                 f"without compression")
                    else:
                        v = torch.where(act, kq + ke, torch.zeros_like(kq))
                        errs = {"v": max_err(v, mask * (pd + ef))}
                        # the wire, bit for bit: the quantizer applied to
                        # the kernel's v gives its q, e' is v − q exactly,
                        # and inactive rows keep their e
                        pq = quantize.quantize_dequant(v, compress)
                        pe = torch.where(act, v - pq, ef)
                        if not (torch.equal(kq, pq) and torch.equal(ke, pe)):
                            fail(f"fused_round {n},{dz},{k} {var} {compress}:"
                                 f" kernel q/e' differ from the quantizer")
                    # the epilogue on the kernel's q
                    gdt = gossip_torch_dtype(gd)
                    wg = narrow(w, gdt)
                    wq = wg @ narrow(kq, gdt)
                    pz = wg @ narrow(z0, gdt) + etas * wq
                    pc = c + corr * (kq - wq)
                    errs["z"] = max_err(kz, pz)
                    errs["c"] = max_err(kc, pc)
                    # and the whole round against the plain whole round
                    # (informational under compression, where a ulp of Δ
                    # can move a value across a rounding boundary of Q)
                    fz, fc, fe = ref.fused_round_ref(*args, compress=compress,
                                                     gossip_dtype=gd)
                    full = max(max_err(kz, fz), max_err(kc, fc),
                               max_err(ke, fe))
                    if (max(errs.get("delta", 0.0), errs.get("v", 0.0),
                            errs["z"]) > TOL_ROUND or errs["c"] > TOL_ROUND_C
                            or (compress is None and full > TOL_ROUND_C)):
                        fail(f"fused_round {n},{dz},{k} {var} {compress} {gd}:"
                             f" {errs}, whole round {full}")
                    worst = max(worst, *errs.values(),
                                full if compress is None else 0.0)
                    if compress is not None:
                        full_q = max(full_q, full)
                    cases += 1
    emit({"phase": "kernels", "kernel": "fused_round", "cases": cases,
          "max_abs_err": worst, "tol": [TOL_ROUND, TOL_ROUND_C],
          "whole_round_err_compressed": full_q,
          "bitwise": "e' == e (no compression); with v = q + e': "
                     "q == Q(v), e' == v - q"})
    return worst


# ---------------------------------------------------------------------------
# phase 4/5: the main path through the engine
# ---------------------------------------------------------------------------

def main_setup(dev, *, dx=DX, dy=DY, n=N, k=K, sigma=SIGMA, seed=0):
    import torch

    from repro_torch.core import make_quadratic_data, quadratic_problem

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    data = make_quadratic_data(gen, n, dx=dx, dy=dy, heterogeneity=1.0)
    problem = quadratic_problem(data, sigma=sigma)
    client_batch = {key: v for key, v in data.items() if key != "mu"}
    batches = {key: v.unsqueeze(0).expand(k, *v.shape)
               for key, v in client_batch.items()}
    return problem, client_batch, batches


def main_cfg(algo, impl, n=N, k=K):
    from repro_torch.configs import AlgorithmConfig

    return AlgorithmConfig(
        algorithm=algo, num_clients=n, local_steps=k, eta_cx=0.01,
        eta_cy=0.05, eta_sx=0.5 if algo == "kgt_minimax" else 1.0,
        eta_sy=0.5 if algo == "kgt_minimax" else 1.0, topology="ring",
        mixing_impl=impl)


def prepare(problem, client_batch, batches, algo, impl, dev, *,
            log_every=10, n=N, k=K):
    """init_state and the engine's chunk builder: (state, build)."""
    import torch

    from repro_torch import engine as engine_lib
    from repro_torch.core import init_state, make_round_step

    cfg = main_cfg(algo, impl, n, k)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    state = init_state(problem, cfg, gen, init_batch=client_batch)
    sampler = engine_lib.make_fixed_batch_sampler(
        batches, local_steps=k, num_clients=n, noise_dim=problem.noise_dim,
        seed=0, device=dev)
    build = engine_lib.make_chunk_builder(
        make_round_step(problem, cfg, device=dev), sampler,
        engine_lib.quadratic_metrics_fn(problem), log_every=log_every)
    return state, build


def drive(problem, client_batch, batches, algo, impl, dev, rounds,
          *, log_every=10, n=N, k=K):
    """init_state → engine.run; returns (state, history)."""
    from repro_torch import engine as engine_lib

    state, build = prepare(problem, client_batch, batches, algo, impl, dev,
                           log_every=log_every, n=n, k=k)
    return engine_lib.run(state, build, total_rounds=rounds,
                          chunk_rounds=rounds)


def phase_main(dev) -> dict:
    from repro_torch.kernels import fused_round, gossip

    problem, client_batch, batches = main_setup(dev)
    # the launch counts of the main path: set to 0 just before, read after
    gossip.fused_gossip_nd.launches = 0
    fused_round.fused_round_nd.launches = 0
    finals = {}
    for algo in ALGOS:
        for impl in ("dense", "pallas_packed", "fused_round"):
            state, hist = drive(problem, client_batch, batches, algo, impl,
                                dev, ROUNDS)
            finals[algo, impl] = (state, hist)
    launches = {"fused_gossip": gossip.fused_gossip_nd.launches,
                "fused_round": fused_round.fused_round_nd.launches}
    expect = {"fused_gossip": 2 * ROUNDS * len(TRACKING),
              "fused_round": ROUNDS * len(ALGOS)}
    if launches != expect:
        fail(f"main path launches {launches}, expected {expect}")
    worst = {}
    for algo in ALGOS:
        ref_state, ref_hist = finals[algo, "dense"]
        for impl in ("pallas_packed", "fused_round"):
            state, hist = finals[algo, impl]
            for name in ("x", "y", "cx", "cy"):
                a, b = getattr(state, name), getattr(ref_state, name)
                if not bool(a.isfinite().all()):
                    fail(f"{algo}/{impl}: {name} not finite")
                err = max_err(a, b)
                tol = TOL_STATE * (1.0 + float(b.abs().max()))
                if err > tol:
                    fail(f"{algo}/{impl}: {name} differs from dense by {err}"
                         f" > {tol}")
                worst[f"{algo}/{impl}/{name}"] = err
        first, last = ref_hist[0]["phi_grad_norm"], ref_hist[-1][
            "phi_grad_norm"]
        emit({"phase": "main", "algorithm": algo, "rounds": ROUNDS,
              "phi_grad_norm_first": first, "phi_grad_norm_last": last,
              "phi_grad_norm_last_by_impl": {
                  impl: finals[algo, impl][1][-1]["phi_grad_norm"]
                  for impl in ("dense", "pallas_packed", "fused_round")},
              "max_state_err_vs_dense": max(
                  v for key, v in worst.items() if key.startswith(algo))})
    emit({"phase": "main", "launches": launches, "expected": expect,
          "tol_state": TOL_STATE})
    return launches


def phase_quickstart(dev) -> dict:
    from repro_torch.kernels import fused_round, gossip
    from repro_torch.launch import quickstart

    algos = ("kgt_minimax", "local_sgda")
    g = {}
    # this path's launch counts: set to 0 just before, read just after
    gossip.fused_gossip_nd.launches = 0
    fused_round.fused_round_nd.launches = 0
    for algo in algos:
        _, hist = quickstart.run(algo, mixing_impl="fused_round",
                                 device=dev, verbose=False)
        g[algo] = hist[-1]["phi_grad_norm"]
    launches = {"fused_gossip": gossip.fused_gossip_nd.launches,
                "fused_round": fused_round.fused_round_nd.launches}
    expect = {"fused_gossip": 0,
              "fused_round": quickstart.ROUNDS * len(algos)}
    emit({"phase": "quickstart", "mixing_impl": "fused_round",
          "phi_grad_norm_final": g, "launches": launches,
          "expected": expect})
    if launches != expect:
        fail(f"quickstart launches {launches}, expected {expect}")
    if not g["kgt_minimax"] < g["local_sgda"]:
        fail(f"quickstart: kgt_minimax {g['kgt_minimax']} is not below "
             f"local_sgda {g['local_sgda']}")
    return launches


# ---------------------------------------------------------------------------
# phase 6: times
# ---------------------------------------------------------------------------

def phase_times(dev, gen) -> dict:
    import torch

    from repro_torch.core import MIXING_IMPLS
    from repro_torch.kernels import fused_round, gossip, ref

    # At the main path's shapes a call is a few µs of device work behind
    # tens of µs of host work (the wrapper, the allocator, the launch):
    # ``ms`` is the device time (calls back to back in a CUDA graph),
    # ``call_ms`` the eager rate of calls from Python (host-bound).
    out = {}
    # fused gossip at the main path's two shapes (one launch each per round)
    g_ms = g_plain = g_bound = 0.0
    for d in (DX, DY):
        args = gossip_operands(N, d, gen, dev)
        kern = lambda: gossip.fused_gossip_nd(*args, 0.5, 12.5)  # noqa: E731
        plain = lambda: ref.fused_gossip_ref(*args, 0.5, 12.5)   # noqa: E731
        ms, pms = graph_ms(kern), graph_ms(plain)
        b, _ = gossip_bound_ms(N, d)
        emit({"phase": "times", "kernel": "fused_gossip", "n": N, "D": d,
              "ms": ms, "plain_ms": pms, "bound_ms": b,
              "call_ms": cuda_ms(kern, inner=100),
              "plain_call_ms": cuda_ms(plain, inner=100)})
        g_ms, g_plain, g_bound = g_ms + ms, g_plain + pms, g_bound + b
    out["fused_gossip"] = dict(ms=g_ms, plain_ms=g_plain, bound_ms=g_bound,
                               bound_by="bytes")
    # whole round at the main-path shape
    args = round_operands(N, DX + DY, K, gen, dev)
    kern = lambda: fused_round.fused_round_nd(*args)  # noqa: E731
    plain = lambda: ref.fused_round_ref(*args)        # noqa: E731
    ms, pms = graph_ms(kern, inner=20), graph_ms(plain, inner=20)
    b, by = round_bound_ms(N, DX + DY, K)
    emit({"phase": "times", "kernel": "fused_round", "n": N, "dz": DX + DY,
          "K": K, "ms": ms, "plain_ms": pms, "bound_ms": b, "bound_by": by,
          "call_ms": cuda_ms(kern, inner=20),
          "plain_call_ms": cuda_ms(plain, inner=20)})
    out["fused_round"] = dict(ms=ms, plain_ms=pms, bound_ms=b, bound_by=by)
    del args

    # the epilogue at a paper-toy-sized packed state
    d_big = 100_000_000
    args = gossip_operands(N, d_big, gen, dev)
    kt, kc = gossip.fused_gossip_nd(*args, 0.5, 12.5)
    pt, pc = ref.fused_gossip_ref(*args, 0.5, 12.5)
    err = max(max_err(kt, pt), max_err(kc, pc) / 12.5)
    del kt, kc, pt, pc
    torch.cuda.empty_cache()
    if err > TOL_GOSSIP:
        fail(f"fused_gossip at D={d_big}: err {err}")
    ms = cuda_ms(lambda: gossip.fused_gossip_nd(*args, 0.5, 12.5), reps=21)
    pms = cuda_ms(lambda: ref.fused_gossip_ref(*args, 0.5, 12.5), reps=21)
    b, _ = gossip_bound_ms(N, d_big)
    emit({"phase": "times", "kernel": "fused_gossip", "n": N, "D": d_big,
          "ms": ms, "plain_ms": pms, "bound_ms": b, "max_abs_err": err,
          "GB_per_s": 4 * 5 * N * d_big / ms / 1e6})
    del args
    torch.cuda.empty_cache()

    # rounds/s per mixing_impl at the main-path shape (kgt_minimax)
    from repro_torch import engine as engine_lib

    problem, client_batch, batches = main_setup(dev)
    rps = {}
    for impl in MIXING_IMPLS:
        drive(problem, client_batch, batches, "kgt_minimax", impl, dev, 5)
        state, build = prepare(problem, client_batch, batches, "kgt_minimax",
                               impl, dev, log_every=ROUNDS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine_lib.run(state, build, total_rounds=ROUNDS,
                       chunk_rounds=ROUNDS)
        torch.cuda.synchronize()
        rps[impl] = ROUNDS / (time.perf_counter() - t0)
    emit({"phase": "times", "rounds_per_s": rps, "algorithm": "kgt_minimax",
          "rounds": ROUNDS, "note": "host clock around engine.run, "
          "one chunk, metrics on rounds 0 and 49"})
    return out


def phase_profile(dev) -> None:
    """torch.profiler over 10 engine rounds per lowering: device busy time
    against the wall clock, and the kernels that take it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import engine as engine_lib

    problem, client_batch, batches = main_setup(dev)
    rounds = 10
    for impl in ("dense", "pallas_packed", "fused_round"):
        drive(problem, client_batch, batches, "kgt_minimax", impl, dev, 3)
        state, build = prepare(problem, client_batch, batches, "kgt_minimax",
                               impl, dev, log_every=rounds)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine_lib.run(state, build, total_rounds=rounds,
                           chunk_rounds=rounds)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # kernels are the device-side events; the CPU ops that launched
        # them carry the same device time again
        avgs = prof.key_averages()
        events = [e for e in avgs if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        busy_us = sum(e.self_device_time_total for e in events)
        op_us = sum(e.self_device_time_total for e in avgs
                    if e.device_type == DeviceType.CPU)
        top = sorted(events, key=lambda e: e.self_device_time_total,
                     reverse=True)[:6]
        emit({"phase": "profile", "mixing_impl": impl, "rounds": rounds,
              "wall_us_per_round": wall_us / rounds,
              "device_busy_us_per_round": busy_us / rounds,
              "op_device_us_per_round": op_us / rounds,
              "device_busy_share": busy_us / wall_us,
              "kernels_per_round": sum(e.count for e in events) / rounds,
              "top": [[e.key[:60], e.self_device_time_total / rounds,
                       e.count / rounds] for e in top]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Drive the port on one card.")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES + EXTRA_PHASES}")
    phases = set(ap.parse_args(argv).phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    smi = nvidia_smi()
    emit({"phase": "card", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    t0 = time.perf_counter()
    _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {name: [ln for ln in log.splitlines() if "registers" in ln
                           or "spill" in ln]
                    for name, log in _build.stats["log"].items()}})
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    errs = {"fused_gossip": None, "fused_round": None}
    if "kernels" in phases:
        errs = {"fused_gossip": check_gossip(gen, dev),
                "fused_round": check_round(gen, dev)}
        torch.cuda.synchronize()
    launches = {"fused_gossip": None, "fused_round": None}
    if "main" in phases:
        launches = phase_main(dev)
    qs_launches = {"fused_gossip": None, "fused_round": None}
    if "quickstart" in phases:
        qs_launches = phase_quickstart(dev)
    times = {"fused_gossip": {}, "fused_round": {}}
    if "times" in phases:
        times = phase_times(dev, gen)
    if "profile" in phases:
        phase_profile(dev)
    torch.cuda.synchronize()
    kernels = [
        {"name": "fused_gossip", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gossip.cu",
         "replaces": "src/repro/kernels/gossip.py:59"},
        {"name": "fused_round", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_round.cu",
         "replaces": "src/repro/kernels/fused_round.py:99"},
    ]
    for k in kernels:
        t = times[k["name"]]
        k.update(launches=launches[k["name"]],
                 launches_quickstart=qs_launches[k["name"]],
                 max_abs_err=errs[k["name"]],
                 ms=t.get("ms"), plain_ms=t.get("plain_ms"),
                 bound_ms=t.get("bound_ms"), bound_by=t.get("bound_by"),
                 library_ms=None)
    print(smi, flush=True)
    emit({"kernels": kernels,
          "library_ms_note": "no single PyTorch call computes either "
                             "kernel's function"})
    if set(PHASES) - phases:
        print(f"chip_smoke: only ran {sorted(phases)}", file=sys.stderr)
        return 2
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
