"""Churn in the port against the JAX package: per-round W, partial
participation and ``topology_cycle`` on the dense lowerings.

The port's W and mask samplers draw from a ``torch.Generator``, which
cannot reproduce JAX's draws, so the round steps are fed the reference's
own per-round W and mask arrays (``make_replay_sampler``) and compared at
the tolerances of tests/test_torch_round.py: 1e-5 on x, y and 4e-5 on the
corrections after a few rounds, every port lowering against the JAX
``dense`` lowering.  The deterministic building blocks (Metropolis
weights, the masked W) are compared on the same inputs at 1e-7; the port's
own samplers are held to the invariants and to each other.
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
from repro.core import stochastic_topology as jstoch
from repro.core import topology as jtopology
from repro_torch import engine as t_engine
from repro_torch.configs import AlgorithmConfig
from repro_torch.core import (
    from_reference,
    make_replay_sampler,
    make_round_step,
    quadratic_problem,
)
from repro_torch.core import sparse_topology as tsparse
from repro_torch.core import stochastic_topology as tstoch

N, DX, DY, K = 8, 10, 5, 4
ROUNDS = 4
ATOL, ATOL_C = 1e-5, 4e-5
IMPLS = ("dense", "pallas_packed", "fused_round")


def _cfg_kwargs(algo, **kw):
    return dict(algorithm=algo, num_clients=N, local_steps=K, eta_cx=0.01,
                eta_cy=0.1, eta_sx=0.5, eta_sy=0.5, topology="ring") | kw


@functools.lru_cache(maxsize=None)
def _reference_data():
    key = jax.random.PRNGKey(0)
    # one compiled program instead of op-by-op dispatch (seconds on the CPU)
    make = jax.jit(functools.partial(jax_make_data, dx=DX, dy=DY,
                                     heterogeneity=2.0), static_argnums=1)
    return key, make(key, N)


def _round_keys(t):
    return jax.random.split(jax.random.PRNGKey(t), K * N).reshape(K, N, 2)


@jax.jit
@jax.vmap
def _noise_rows(k):
    kx, ky = jax.random.split(k)
    return jnp.concatenate([jax.random.normal(kx, (DX,)),
                            jax.random.normal(ky, (DY,))])


def _jax_noise(keys):
    flat = keys.reshape(-1, 2)
    return np.array(_noise_rows(flat)).reshape(keys.shape[:-1] + (-1,))


@functools.lru_cache(maxsize=None)
def _noise(t):
    return torch.as_tensor(_jax_noise(_round_keys(t)))


def _state_np(st):
    return {name: np.asarray(getattr(st, name))
            for name in ("x", "y", "cx", "cy")} | {"round": int(st.round)}


def _jax_setup(cfg):
    key, data = _reference_data()
    prob = jax_quadratic_problem(data, sigma=0.1)
    cb = {n: v for n, v in data.items() if n != "mu"}
    kb = jax.tree.map(lambda v: jnp.broadcast_to(v[None], (K, *v.shape)), cb)
    st = jax_init_state(prob, cfg, key, init_batch=cb,
                        init_keys=jax.random.split(key, N))
    return prob, kb, st


def _port_setup(init):
    _, data = _reference_data()
    tdata, st = from_reference({n: np.asarray(v) for n, v in data.items()},
                               init, device="cpu")
    prob = quadratic_problem(tdata, sigma=0.1)
    batches = {n: v.unsqueeze(0).expand(K, *v.shape)
               for n, v in tdata.items() if n != "mu"}
    return prob, batches, st


def _assert_state(st, ref):
    assert st.round == ref["round"]
    for name in ("x", "y", "cx", "cy"):
        tol = ATOL_C if name in ("cx", "cy") else ATOL
        np.testing.assert_allclose(getattr(st, name).numpy(), ref[name],
                                   rtol=0, atol=tol, err_msg=name)


# (algorithm, W family or None for the static W, participation)
CHURN_CASES = {
    "kgt_minimax-erdos_renyi": ("kgt_minimax", "erdos_renyi", True),
    "kgt_minimax-pairwise": ("kgt_minimax", "pairwise", True),
    "gt_gda-dropout": ("gt_gda", "dropout", True),
    "local_sgda-participation": ("local_sgda", None, True),
    "dsgda-erdos_renyi": ("dsgda", "erdos_renyi", False),
}


@functools.lru_cache(maxsize=None)
def _jax_churn_run(case):
    """The JAX dense round under churn: (init, final, Ws, masks)."""
    algo, family, part = CHURN_CASES[case]
    cfg = JaxConfig(**_cfg_kwargs(algo), mixing_impl="dense")
    prob, kb, st = _jax_setup(cfg)
    init = _state_np(st)
    tkey = jax.random.PRNGKey(11)
    w_fn = (None if family is None else jstoch.make_w_sampler(
        family, N, tkey, base_w=jtopology.mixing_matrix("ring", N),
        edge_prob=0.5, client_drop_prob=0.3))
    m_fn = jstoch.make_participation_sampler(N, tkey, 0.6) if part else None
    step = jax.jit(jax_make_round_step(prob, cfg, traced_w=w_fn is not None,
                                       participation=part))
    ws, masks = [], []
    for t in range(ROUNDS):
        extras = []
        if w_fn is not None:
            extras.append(w_fn(jnp.int32(t)))
            ws.append(np.asarray(extras[-1]))
        if part:
            extras.append(m_fn(jnp.int32(t)))
            masks.append(np.asarray(extras[-1]))
        st = step(st, kb, _round_keys(t), *extras)
    return init, _state_np(st), ws, masks


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", sorted(CHURN_CASES))
def test_churn_round_step_matches_jax(case, impl):
    algo, family, part = CHURN_CASES[case]
    init, ref, ws, masks = _jax_churn_run(case)
    prob, batches, st = _port_setup(init)
    cfg = AlgorithmConfig(**_cfg_kwargs(algo), mixing_impl=impl)
    sampler = make_replay_sampler(
        lambda r: (batches, _noise(r)), ws=ws or None, masks=masks or None,
        device="cpu")
    step = make_round_step(prob, cfg, traced_w=family is not None,
                           participation=part, device="cpu")
    for t in range(ROUNDS):
        b, noise, extras = t_engine.split_sampled(sampler(t))
        st = step(st, b, noise, *extras)
    _assert_state(st, ref)
    if part:
        assert any(not m.all() for m in masks)


@functools.lru_cache(maxsize=None)
def _jax_cycle_run():
    cfg = JaxConfig(**_cfg_kwargs("kgt_minimax"), mixing_impl="dense",
                    topology_cycle=("ring", "full", "exp"))
    prob, kb, st = _jax_setup(cfg)
    init = _state_np(st)
    step = jax.jit(jax_make_round_step(prob, cfg))
    for t in range(ROUNDS):
        st = step(st, kb, _round_keys(t))
    return init, _state_np(st)


@pytest.mark.parametrize("impl", ["dense", "fused_dense"] + list(IMPLS[1:]))
def test_topology_cycle_matches_jax(impl):
    init, ref = _jax_cycle_run()
    prob, batches, st = _port_setup(init)
    cfg = AlgorithmConfig(**_cfg_kwargs("kgt_minimax"), mixing_impl=impl,
                          topology_cycle=("ring", "full", "exp"))
    step = make_round_step(prob, cfg, device="cpu")
    for t in range(ROUNDS):
        st = step(st, batches, _noise(t))
    _assert_state(st, ref)


def test_with_topology_through_engine_matches_jax():
    """engine.run with a (W, mask) sampler: the extras reach round_step in
    the order make_round_step(traced_w=..., participation=...) takes, and
    the logged metrics follow the JAX engine's."""
    rounds, log_every = 6, 2
    cfg = JaxConfig(**_cfg_kwargs("kgt_minimax"), mixing_impl="dense")
    prob, kb, st = _jax_setup(cfg)
    init = _state_np(st)
    tkey = jax.random.PRNGKey(3)
    w_fn = jstoch.make_w_sampler("erdos_renyi", N, tkey, edge_prob=0.6)
    m_fn = jstoch.make_participation_sampler(N, tkey, 0.6)
    build = jax_engine.make_chunk_builder(
        jax_make_round_step(prob, cfg, traced_w=True, participation=True),
        jax_engine.with_topology(
            jax_engine.make_fixed_batch_sampler(kb, local_steps=K,
                                                num_clients=N, seed=0),
            w_fn=w_fn, mask_fn=m_fn),
        jax_engine.quadratic_metrics_fn(prob), log_every=log_every)
    jst, jhist = jax_engine.run(st, build, total_rounds=rounds,
                                chunk_rounds=log_every, wall_clock=False)

    tprob, batches, tst = _port_setup(init)
    ws = [np.asarray(w_fn(jnp.int32(t))) for t in range(rounds)]
    masks = [np.asarray(m_fn(jnp.int32(t))) for t in range(rounds)]
    noise = _jax_noise(jnp.stack([_round_keys(t) for t in range(rounds)]))
    sampler = make_replay_sampler(
        lambda r: (batches, torch.as_tensor(noise[r])), ws=ws, masks=masks,
        device="cpu")
    tbuild = t_engine.make_chunk_builder(
        make_round_step(tprob, AlgorithmConfig(**_cfg_kwargs("kgt_minimax")),
                        traced_w=True, participation=True, device="cpu"),
        sampler, t_engine.quadratic_metrics_fn(tprob), log_every=log_every)
    tst, thist = t_engine.run(tst, tbuild, total_rounds=rounds,
                              chunk_rounds=log_every, wall_clock=False)
    _assert_state(tst, _state_np(jst))
    assert [r["round"] for r in thist] == [r["round"] for r in jhist]
    for name in ("phi_grad_norm", "consensus_x", "corr_x_norm"):
        np.testing.assert_allclose([r[name] for r in thist],
                                   [r[name] for r in jhist], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# validation: the reference's refusals
# ---------------------------------------------------------------------------

def _problem():
    gen = torch.Generator().manual_seed(0)
    from repro_torch.core import make_quadratic_data

    return quadratic_problem(make_quadratic_data(gen, 4, dx=6, dy=3),
                             sigma=0.1)


@pytest.mark.parametrize("cfg_kw,step_kw,match", [
    ({"mixing_impl": "ring", "topology_cycle": ("ring", "full")}, {},
     "topology_cycle"),
    ({"topology_cycle": ("ring", "full")}, {"traced_w": True},
     "traced_w supplies W"),
    ({"mixing_impl": "sparse_packed", "topology_cycle": ("ring", "exp")}, {},
     "topology_cycle"),
    ({"mixing_impl": "ring"}, {"traced_w": True}, "neighbor-only"),
    ({"mixing_impl": "fused_ring"}, {"participation": True}, "neighbor-only"),
])
def test_reference_validation_errors(cfg_kw, step_kw, match):
    cfg = AlgorithmConfig(num_clients=4, **cfg_kw)
    with pytest.raises(ValueError, match=match):
        make_round_step(_problem(), cfg, device="cpu", **step_kw)


def test_extras_count_is_checked():
    prob = _problem()
    cfg = AlgorithmConfig(num_clients=4, local_steps=1)
    step = make_round_step(prob, cfg, participation=True, device="cpu")
    with pytest.raises(TypeError, match=r"1 extra operand\(s\) \[mask\]"):
        step(None, None, None)
    with pytest.raises(ValueError, match="needs w_fn"):
        t_engine.with_topology(lambda r: (None, None))
    nested = t_engine.with_topology(lambda r: (None, None),
                                    mask_fn=lambda r: r)
    with pytest.raises(ValueError, match="already returns extras"):
        t_engine.with_topology(nested, mask_fn=lambda r: r)(0)


def test_dense_materialization_guard():
    with pytest.raises(ValueError, match="limit 512"):
        tstoch.make_w_sampler("erdos_renyi", 513, 0, device="cpu")(0)
    with pytest.raises(ValueError, match="limit 512"):
        tstoch.masked_w(torch.eye(513), torch.ones(513, dtype=torch.bool))


# ---------------------------------------------------------------------------
# building blocks on the same inputs, and the port's own samplers
# ---------------------------------------------------------------------------

def test_metropolis_and_masked_w_match_jax():
    rng = np.random.default_rng(4)
    upper = np.triu(rng.random((12, 12)) < 0.4, 1)
    adj = upper | upper.T
    np.testing.assert_allclose(
        tstoch.metropolis_weights(torch.as_tensor(adj)).numpy(),
        np.asarray(jstoch.metropolis_weights(jnp.asarray(adj))),
        rtol=0, atol=1e-7)
    w = jtopology.mixing_matrix("exp", 12).astype(np.float32)
    mask = rng.random(12) < 0.5
    got = tstoch.masked_w(torch.as_tensor(w), torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jstoch.masked_w(w, jnp.asarray(mask))), rtol=0,
        atol=1e-7)
    np.testing.assert_array_equal(np.diag(got)[~mask], 1.0)


@pytest.mark.parametrize("family",
                         ["static", "erdos_renyi", "pairwise", "dropout"])
def test_port_dense_sampler_invariants(family):
    base = jtopology.mixing_matrix("exp", 16)
    fn = tstoch.make_w_sampler(family, 16, 5, base_w=base, edge_prob=0.4,
                               device="cpu")
    draws = []
    for r in range(4):
        w = fn(r).numpy()
        np.testing.assert_allclose(w, w.T, rtol=0, atol=1e-7)
        np.testing.assert_allclose(w.sum(1), 1.0, rtol=0, atol=1e-6)
        assert (w >= 0).all()
        np.testing.assert_array_equal(fn(r).numpy(), w)
        draws.append(w)
    if family != "static":
        assert any(not np.array_equal(draws[0], d) for d in draws[1:])
    if family == "dropout":
        assert not ((draws[0] != 0) & (base == 0)).any()
    masks = tstoch.make_participation_sampler(16, 5, 0.5, device="cpu")
    assert torch.equal(masks(2), masks(2))
    assert masks(2).dtype == torch.bool


@pytest.mark.parametrize("family", ["erdos_renyi", "dropout"])
def test_sparse_and_dense_samplers_draw_the_same_w(family):
    """On the full-graph support (for erdos_renyi) or the base topology
    (for dropout), the sparse and dense samplers of one seed realize the
    same W: the edge draws follow one convention."""
    n = 10
    base = jtopology.mixing_matrix("exp", n)
    support = (tsparse.sparse_full(n) if family == "erdos_renyi"
               else tsparse.from_dense(base))
    dense = tstoch.make_w_sampler(family, n, 9, base_w=base, edge_prob=0.5,
                                  device="cpu")
    sparse = tsparse.make_sparse_w_sampler(family, support, 9,
                                           edge_prob=0.5, device="cpu")
    for r in range(3):
        np.testing.assert_allclose(tsparse.densify(sparse(r)).numpy(),
                                   dense(r).numpy(), rtol=0, atol=1e-7)
