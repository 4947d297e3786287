"""The DRO problem of the training slice against the JAX package, in f32
compute, on the reduced qwen2-0.5b at the reference's own train-test sizes
(``tests/test_system.py::_args``: n = 2, K = 2, batch 2 × 32 tokens, 4
groups): the DRO value and its per-client gradients
(``core.kgt_minimax._vgrads``), one round of each algorithm on ``dense``,
the initial corrections of ``init_state``, ``lm_loss``, the adversarial
problem and ``evaluate_clients``, on the reference's parameters
(``models.interop``, stacked per client) and batches.  The port runs both
its routes: the kernels' plain versions (``kernels=True`` on CPU tensors)
and ``kernels=False``.

Tolerance: max |port − JAX| ≤ 1e-4·(1 + max|JAX|) (measured ≤ 1e-6: sum
orders).  ``tests/test_torch_train.py`` holds the train entry point.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from repro.configs import registry as jax_registry
from repro.configs.base import AlgorithmConfig as JaxAlgorithmConfig
from repro.core import kgt_minimax as jax_kgt
from repro.core import objectives as jax_objectives
from repro.data import synthetic as jax_data
from repro.evaluation import metrics as jax_metrics
from repro.models import model as jax_model
from repro_torch.configs import AlgorithmConfig, registry
from repro_torch.core import KGTState, kgt_minimax as t_kgt
from repro_torch.core import objectives as t_objectives
from repro_torch.data import synthetic as t_data
from repro_torch.evaluation import metrics as t_metrics
from repro_torch.models import interop
from repro_torch.models import model as t_model

TOL = 1e-4
ARCH = "qwen2-0.5b"
N, K, B, S, G = 2, 2, 2, 32, 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(b):
    """A reference batch (numpy / jax arrays) -> the port's (int64)."""
    return {k: torch.tensor(np.asarray(v)).long() for k, v in b.items()}


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * (1 + np.abs(want).max()), (what, err)


def _close_trees(got_x, want_x, tol, what=""):
    """The port's parameter dict against the reference's stacked pytree
    (one client at a time, through the interop's naming)."""
    tcfg = _cfgs()[1]
    for g, w in zip(interop.stacked_params_to_numpy(got_x, tcfg),
                    [jax.tree.map(lambda a: a[i], want_x)
                     for i in range(N)]):
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(_np(w))):
            _close(a, b, tol, what)


@functools.lru_cache(maxsize=None)
def _cfgs():
    return (jax_registry.reduced(jax_registry.get_model_config(ARCH)),
            registry.reduced(registry.get_model_config(ARCH)))


def _port_data_model(dm):
    return t_data.DataModel(
        domain_logits=torch.tensor(np.asarray(dm.domain_logits)),
        domain_shift=torch.tensor(np.asarray(dm.domain_shift)).long(),
        mixtures=torch.tensor(np.asarray(dm.mixtures)),
        vocab_size=dm.vocab_size, num_groups=dm.num_groups)


@functools.lru_cache(maxsize=None)
def _reference_inputs():
    """The reference's data model, initial parameters, an initial (n, B, S)
    batch and one round of (K, n, B, S) batches, each drawn under one
    ``jax.jit``."""
    jcfg = _cfgs()[0]
    kd, kx, kb = jax.random.split(jax.random.PRNGKey(0), 3)
    dm = jax.jit(functools.partial(
        jax_data.make_data_model, vocab_size=jcfg.vocab_size, num_groups=G,
        num_clients=N, alpha=0.3))(kd)
    x0 = jax.jit(functools.partial(jax_model.init_params, jcfg))(kx)

    def draw(local_steps, key):
        return _np(jax.jit(functools.partial(
            jax_data.round_batches, local_steps=local_steps, num_clients=N,
            per_client_batch=B, seq_len=S))(dm, key))

    return dict(dm=dm, x0=_np(x0),
                init_b=jax.tree.map(lambda a: a[0], draw(1, kb)),
                batches=[draw(K, jax.random.fold_in(kb, 1))])


@functools.lru_cache(maxsize=None)
def _f32_setup():
    """Reference and port DRO problems in f32 compute, a state whose
    clients differ (x0 plus a per-client perturbation, y > 0, small
    corrections), and the reference's first round of batches."""
    jcfg, tcfg = _cfgs()
    ref_run = _reference_inputs()
    rng = np.random.default_rng(0)
    xs = [jax.tree.map(
        lambda a: (a + 0.01 * rng.standard_normal(a.shape)).astype(
            np.float32), ref_run["x0"]) for _ in range(N)]
    x = jax.tree.map(lambda *a: np.stack(a), *xs)
    cx = jax.tree.map(lambda a: (1e-3 * rng.standard_normal(a.shape)).astype(
        np.float32), x)
    y = rng.uniform(0.1, 1.0, (N, G)).astype(np.float32)
    cy = (1e-2 * rng.standard_normal((N, G))).astype(np.float32)
    jprob = jax_objectives.dro_problem(jcfg, num_groups=G, mu=1.0,
                                       compute_dtype=jnp.float32)
    tx = interop.stacked_params_from_reference(xs, tcfg, device="cpu")
    tcx = interop.stacked_params_from_reference(
        [jax.tree.map(lambda a: a[i], cx) for i in range(N)], tcfg,
        device="cpu")
    return dict(jprob=jprob, x=x, y=y, cx=cx, cy=cy, tx=tx, tcx=tcx,
                batches=ref_run["batches"][0])


def _port_problem(kernels=True, dtype=torch.float32):
    return t_objectives.dro_problem(_cfgs()[1], num_groups=G, mu=1.0,
                                    compute_dtype=dtype, kernels=kernels)


def test_stacked_params_cross_both_ways():
    st = _f32_setup()
    back = interop.stacked_params_to_numpy(st["tx"], _cfgs()[1])
    for i in range(N):
        for a, b in zip(jax.tree.leaves(back[i]),
                        jax.tree.leaves(jax.tree.map(lambda v: v[i],
                                                     st["x"]))):
            np.testing.assert_array_equal(a, b)
    assert set(st["tx"]) == set(t_model.param_dict(
        t_model.init_params(_cfgs()[1], device="cpu")))


# ---------------------------------------------------------------------------
# the DRO value, gradients and rounds (f32 compute)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernels", [True, False])
def test_dro_value_and_per_client_gradients_match_jax(kernels):
    st = _f32_setup()
    batch = jax.tree.map(lambda a: a[0], st["batches"])       # k = 0
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    jprob = st["jprob"]
    want_v = jax.vmap(jprob.value)(st["x"], st["y"], batch, keys)
    want_gx, want_gy = jax.jit(jax.vmap(jprob.grads))(st["x"], st["y"],
                                                      batch, keys)
    prob = _port_problem(kernels)
    tb, ty = _batch(batch), torch.tensor(st["y"])
    got_v = vmap(prob.value)(st["tx"], ty, tb, torch.zeros((N, 0)))
    _close(got_v.numpy(), want_v, TOL, "value")
    got_gx, got_gy = t_kgt._vgrads(prob, st["tx"], ty, tb,
                                   torch.zeros((N, 0)))
    _close(got_gy.numpy(), want_gy, TOL, "grad y")
    _close_trees(got_gx, want_gx, TOL, "grad x")


@pytest.mark.parametrize("algorithm", ["kgt_minimax", "gt_gda", "dsgda",
                                       "local_sgda"])
def test_one_round_of_each_algorithm_matches_jax(algorithm):
    """One round on ``dense`` from a state whose clients differ, on the
    reference's first round of batches."""
    st = _f32_setup()
    kw = dict(algorithm=algorithm, num_clients=N, local_steps=K,
              eta_cx=0.02, eta_cy=0.2, eta_sx=0.7, eta_sy=0.7,
              topology="ring", mixing_impl="dense")
    jstate = jax_kgt.KGTState(x=st["x"], y=st["y"], cx=st["cx"],
                              cy=st["cy"], round=jnp.int32(0))
    keys = jax.random.split(jax.random.PRNGKey(1), K * N).reshape(K, N, 2)
    want = jax.jit(jax_kgt.make_round_step(
        st["jprob"], JaxAlgorithmConfig(**kw)))(jstate, st["batches"], keys)
    tstate = KGTState(x=st["tx"], y=torch.tensor(st["y"]), cx=st["tcx"],
                      cy=torch.tensor(st["cy"]), round=0)
    got = t_kgt.make_round_step(_port_problem(), AlgorithmConfig(**kw),
                                device="cpu")(
        tstate, _batch(st["batches"]), torch.zeros((K, N, 0)))
    assert got.round == 1
    for name in ("y", "cy"):
        _close(getattr(got, name).numpy(), getattr(want, name), TOL, name)
    _close_trees(got.x, want.x, TOL, "x")
    _close_trees(got.cx, want.cx, TOL, "cx")


def test_initial_corrections_match_jax():
    """``init_state`` on the LM: the replicated x0 and the corrections from
    the initial batch's gradients (Σ_i c_i = 0)."""
    jcfg, tcfg = _cfgs()
    ref_run = _reference_inputs()
    algo = dict(algorithm="kgt_minimax", num_clients=N, local_steps=K)
    jprob = jax_objectives.dro_problem(jcfg, num_groups=G,
                                       compute_dtype=jnp.float32)
    jax_prob = jax_objectives.MinimaxProblem(
        init_x=lambda k: jax.tree.map(jnp.asarray, ref_run["x0"]),
        init_y=jprob.init_y, value=jprob.value, mu=jprob.mu)
    want = jax.jit(lambda ib: jax_kgt.init_state(
        jax_prob, JaxAlgorithmConfig(**algo), jax.random.PRNGKey(0),
        init_batch=ib))(ref_run["init_b"])
    x0 = t_model.param_dict(interop.params_from_reference(
        ref_run["x0"], tcfg, device="cpu"))
    prob = t_objectives.dro_problem(tcfg, num_groups=G,
                                    compute_dtype=torch.float32)
    prob = t_objectives.MinimaxProblem(
        init_x=lambda gen: x0, init_y=prob.init_y, value=prob.value,
        noise_dim=0, mu=prob.mu)
    got = t_kgt.init_state(prob, AlgorithmConfig(**algo),
                           torch.Generator(), init_batch=_batch(
                               ref_run["init_b"]))
    _close(got.cy.numpy(), want.cy, TOL, "cy")
    _close_trees(got.cx, want.cx, TOL, "cx")
    _close_trees(got.x, want.x, 0.0, "x")


def test_lm_loss_and_adversarial_problem_match_jax():
    jcfg, tcfg = _cfgs()
    ref_run = _reference_inputs()
    params = jax.tree.map(jnp.asarray, ref_run["x0"])
    model = interop.params_from_reference(ref_run["x0"], tcfg, device="cpu")
    batch = jax.tree.map(lambda a: a[0, 0], ref_run["batches"][0])
    want, _ = jax_model.lm_loss(params, batch, jcfg,
                                compute_dtype=jnp.float32)
    for kernels in (True, False):
        got, _ = t_model.lm_loss(model, _batch(batch),
                                 compute_dtype=torch.float32,
                                 kernels=kernels)
        _close(got.detach().numpy(), want, TOL, "lm_loss")
    y = np.random.default_rng(2).standard_normal(jcfg.d_model).astype(
        np.float32)
    jprob = jax_objectives.adversarial_problem(jcfg,
                                               compute_dtype=jnp.float32)
    want_v = jprob.value(params, jnp.asarray(y), batch, None)
    want_gx, want_gy = jax.jit(jprob.grads)(params, jnp.asarray(y), batch,
                                            jax.random.PRNGKey(0))
    prob = t_objectives.adversarial_problem(tcfg,
                                            compute_dtype=torch.float32)
    x = t_model.param_dict(model)
    got_gx, got_gy = prob.grads(x, torch.tensor(y), _batch(batch),
                                torch.zeros((0,)))
    _close(prob.value(x, torch.tensor(y), _batch(batch), None).numpy(),
           want_v, TOL, "adversarial value")
    _close(got_gy.numpy(), want_gy, TOL, "adversarial grad y")
    _close_trees({k: v[None].expand(N, *v.shape) for k, v in got_gx.items()},
                 jax.tree.map(lambda a: jnp.stack([a] * N), want_gx), TOL,
                 "adversarial grad x")


def test_evaluate_clients_matches_jax():
    jcfg, tcfg = _cfgs()
    st = _f32_setup()
    dm = _reference_inputs()["dm"]
    key = jax.random.PRNGKey(9)
    want = jax_metrics.evaluate_clients(
        jax.tree.map(jnp.asarray, st["x"]), dm, jcfg, key, num_groups=G,
        per_client_batch=B, seq_len=S, compute_dtype=jnp.float32)
    batches = [_batch(jax_data.sample_client_batch(
        dm, jax.random.fold_in(key, i), i, B, S)) for i in range(N)]
    got = t_metrics.evaluate_clients(
        st["tx"], _port_data_model(dm), tcfg, num_groups=G,
        compute_dtype=torch.float32, batches=batches)
    for name in ("client_mean_loss", "worst_client_loss"):
        _close(got[name], want[name], TOL, name)


