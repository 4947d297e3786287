"""Round-step and engine parity: the port against the JAX package.

Both sides start from the reference's data, x₀ and corrections (carried
across with ``repro_torch.core.from_reference``), and the port is fed the
reference's noise: for every (local step, client) key the JAX oracle
splits ``kx, ky`` and draws ``normal(kx, (dx,))``, ``normal(ky, (dy,))``;
the port receives that row as its ``[nx; ny]`` noise tensor.

Tolerances: 5 rounds — 1e-5 absolute on x, y and 4e-5 on the corrections.
The JAX package holds its own lowerings to each other at 5e-6 / 2e-5 over 5
rounds on this geometry (tests/test_fused_round.py:124-138); across
frameworks the autodiff of ``value`` is a different f32 expression graph
(torch.func vs jax.grad), so the bound is doubled.  The engine history
(120 rounds) is compared relatively, at 1e-4: the trajectory contracts, so
f32 op-order differences stay at that level rather than growing.
"""
import _torch_threads  # noqa: F401
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jax_engine
from repro.configs.base import AlgorithmConfig as JaxConfig
from repro.core import init_state as jax_init_state
from repro.core import make_quadratic_data as jax_make_data
from repro.core import make_round_step as jax_make_round_step
from repro.core import quadratic_problem as jax_quadratic_problem
from repro_torch import engine as t_engine
from repro_torch.configs import AlgorithmConfig
from repro_torch.core import (
    correction_mean_norm,
    from_reference,
    make_round_step,
    quadratic_problem,
)

ALGOS = ("kgt_minimax", "gt_gda", "dsgda", "local_sgda")
IMPLS = ("dense", "fused_dense", "ring", "pallas_packed", "fused_round")
N, DX, DY = 8, 10, 5
ATOL, ATOL_C = 1e-5, 4e-5


def _cfg_kwargs(algo, k):
    return dict(algorithm=algo, num_clients=N, local_steps=k, eta_cx=0.01,
                eta_cy=0.1, eta_sx=0.5, eta_sy=0.5, topology="ring")


@functools.lru_cache(maxsize=None)
def _reference_data():
    key = jax.random.PRNGKey(0)
    data = jax_make_data(key, N, dx=DX, dy=DY, heterogeneity=2.0)
    return key, data


def _jax_noise(keys):
    """(…, 2) oracle keys -> (…, dx+dy) noise rows, as the JAX quadratic
    oracle draws them (objectives.py:92-94)."""
    def row(k):
        kx, ky = jax.random.split(k)
        return jnp.concatenate([jax.random.normal(kx, (DX,)),
                                jax.random.normal(ky, (DY,))])

    flat = keys.reshape(-1, 2)
    return np.array(jax.vmap(row)(flat)).reshape(keys.shape[:-1] + (-1,))


def _round_keys(t, k):
    return jax.random.split(jax.random.PRNGKey(t), k * N).reshape(k, N, 2)


@functools.lru_cache(maxsize=None)
def _round_noise(t, k):
    return torch.as_tensor(_jax_noise(_round_keys(t, k)))


def _state_np(st):
    return {name: np.asarray(getattr(st, name))
            for name in ("x", "y", "cx", "cy")} | {"round": int(st.round)}


@functools.lru_cache(maxsize=None)
def _jax_run(algo, sigma, rounds=5, k=4):
    """The JAX dense round, ``rounds`` times: (initial state, final state)
    as numpy."""
    key, data = _reference_data()
    prob = jax_quadratic_problem(data, sigma=sigma)
    cfg = JaxConfig(**_cfg_kwargs(algo, k), mixing_impl="dense")
    cb = {name: v for name, v in data.items() if name != "mu"}
    kb = jax.tree.map(lambda v: jnp.broadcast_to(v[None], (k, *v.shape)), cb)
    st = jax_init_state(prob, cfg, key, init_batch=cb,
                        init_keys=jax.random.split(key, N))
    init = _state_np(st)
    step = jax.jit(jax_make_round_step(prob, cfg))
    for t in range(rounds):
        st = step(st, kb, _round_keys(t, k))
    return init, _state_np(st)


def _port_run(algo, impl, sigma, rounds=5, k=4):
    _, data = _reference_data()
    init, _ = _jax_run(algo, sigma, rounds, k)
    tdata, st = from_reference({n: np.asarray(v) for n, v in data.items()},
                               init, device="cpu")
    prob = quadratic_problem(tdata, sigma=sigma)
    cfg = AlgorithmConfig(**_cfg_kwargs(algo, k), mixing_impl=impl)
    batches = {n: v.unsqueeze(0).expand(k, *v.shape)
               for n, v in tdata.items() if n != "mu"}
    step = make_round_step(prob, cfg, device="cpu")
    for t in range(rounds):
        st = step(st, batches, _round_noise(t, k))
    return st


@pytest.mark.parametrize("sigma", [0.0, 0.1])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("algo", ALGOS)
def test_round_step_matches_jax(algo, impl, sigma):
    _, ref = _jax_run(algo, sigma)
    st = _port_run(algo, impl, sigma)
    assert st.round == ref["round"] == 5
    for name in ("x", "y", "cx", "cy"):
        tol = ATOL_C if name in ("cx", "cy") else ATOL
        np.testing.assert_allclose(getattr(st, name).numpy(), ref[name],
                                   rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("algo", ["kgt_minimax", "gt_gda"])
def test_corrections_sum_to_zero(algo, impl):
    """Lemma 8: Σ_i c_i = 0 is preserved by every lowering (f32 floor)."""
    st = _port_run(algo, impl, 0.1)
    assert float(correction_mean_norm(st.cx)) < 1e-5
    assert float(correction_mean_norm(st.cy)) < 1e-5


@pytest.mark.parametrize("algo", ["kgt_minimax", "local_sgda"])
def test_engine_history_matches_jax(algo):
    """engine.run at the quickstart geometry (n=8, K=8, ring, σ=0.1):
    the logged ‖∇Φ(x̄)‖ and consensus errors follow the JAX engine's."""
    k, rounds, log_every, sigma = 8, 120, 30, 0.1
    key, data = _reference_data()
    prob = jax_quadratic_problem(data, sigma=sigma)
    kw = _cfg_kwargs(algo, k)
    if algo != "kgt_minimax":
        kw.update(eta_sx=1.0, eta_sy=1.0)
    cfg = JaxConfig(**kw)
    cb = {name: v for name, v in data.items() if name != "mu"}
    kb = jax.tree.map(lambda v: jnp.broadcast_to(v[None], (k, *v.shape)), cb)
    st = jax_init_state(prob, cfg, key, init_batch=cb,
                        init_keys=jax.random.split(key, N))
    init = _state_np(st)
    build = jax_engine.make_chunk_builder(
        jax_make_round_step(prob, cfg),
        jax_engine.make_fixed_batch_sampler(kb, local_steps=k, num_clients=N,
                                            seed=0),
        jax_engine.quadratic_metrics_fn(prob), log_every=log_every)
    _, jhist = jax_engine.run(st, build, total_rounds=rounds,
                              chunk_rounds=log_every, wall_clock=False)

    # the port, fed the reference's per-round noise (seed*7919 + t keys)
    tdata, tst = from_reference({n: np.asarray(v) for n, v in data.items()},
                                init, device="cpu")
    tprob = quadratic_problem(tdata, sigma=sigma)
    batches = {n: v.unsqueeze(0).expand(k, *v.shape)
               for n, v in tdata.items() if n != "mu"}
    noise = _jax_noise(jnp.stack([_round_keys(t, k) for t in range(rounds)]))

    def sampler(r):
        return batches, torch.as_tensor(noise[r])

    tbuild = t_engine.make_chunk_builder(
        make_round_step(tprob, AlgorithmConfig(**kw), device="cpu"), sampler,
        t_engine.quadratic_metrics_fn(tprob), log_every=log_every)
    tst, thist = t_engine.run(tst, tbuild, total_rounds=rounds,
                              chunk_rounds=log_every, wall_clock=False)
    assert tst.round == rounds
    assert [r["round"] for r in thist] == [r["round"] for r in jhist]
    for name in ("phi_grad_norm", "consensus_x", "consensus_y",
                 "corr_x_norm", "y_bar_norm"):
        np.testing.assert_allclose([r[name] for r in thist],
                                   [r[name] for r in jhist], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_engine_logs_grid_and_final_round():
    """Rows land on the log grid and on the final round, chunked or not."""
    st, hist = _quickstart_run(rounds=7, log_every=3, chunk=4)
    assert st.round == 7
    assert [r["round"] for r in hist] == [0, 3, 6]
    st, hist = _quickstart_run(rounds=8, log_every=3, chunk=5)
    assert [r["round"] for r in hist] == [0, 3, 6, 7]
    assert all(np.isfinite(r["phi_grad_norm"]) for r in hist)


def _quickstart_run(rounds, log_every, chunk):
    from repro_torch.core import init_state, make_quadratic_data

    gen = torch.Generator().manual_seed(0)
    data = make_quadratic_data(gen, 4, dx=6, dy=3)
    prob = quadratic_problem(data, sigma=0.1)
    cfg = AlgorithmConfig(algorithm="kgt_minimax", num_clients=4,
                          local_steps=2, eta_cx=0.01, eta_cy=0.1)
    cb = {n: v for n, v in data.items() if n != "mu"}
    st = init_state(prob, cfg, gen, init_batch=cb)
    batches = {n: v.unsqueeze(0).expand(2, *v.shape) for n, v in cb.items()}
    sampler = t_engine.make_fixed_batch_sampler(
        batches, local_steps=2, num_clients=4, noise_dim=prob.noise_dim,
        device="cpu")
    build = t_engine.make_chunk_builder(
        make_round_step(prob, cfg, device="cpu"), sampler,
        t_engine.quadratic_metrics_fn(prob), log_every=log_every)
    return t_engine.run(st, build, total_rounds=rounds, chunk_rounds=chunk)
