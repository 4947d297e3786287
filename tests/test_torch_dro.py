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
orders).  The reference's inputs and the checks of the value, gradients,
rounds and initial corrections are ``tests/_torch_dro.py``'s, shared with
``tests/test_torch_dro_blocks.py`` (the other block kinds).
``tests/test_torch_train.py`` holds the train entry point.
"""
import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dro as h
from repro.core import objectives as jax_objectives
from repro.data import synthetic as jax_data
from repro.evaluation import metrics as jax_metrics
from repro.models import model as jax_model
from repro_torch.core import objectives as t_objectives
from repro_torch.evaluation import metrics as t_metrics
from repro_torch.models import interop
from repro_torch.models import model as t_model

TOL = h.TOL
ARCH = "qwen2-0.5b"
N, B, S, G = h.N, h.B, h.S, h.G
_batch, _close = h.batch_of, h.close


def _cfgs():
    return h.cfgs(ARCH)


def _f32_setup():
    return h.f32_setup(ARCH)


def _reference_inputs():
    return h.reference_inputs(ARCH)


def _close_trees(got_x, want_x, tol, what=""):
    h.close_trees(ARCH, got_x, want_x, tol, what)


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
    h.check_value_and_grads(ARCH, "plain" if kernels else "kernels_false")


@pytest.mark.parametrize("algorithm", ["kgt_minimax", "gt_gda", "dsgda",
                                       "local_sgda"])
def test_one_round_of_each_algorithm_matches_jax(algorithm):
    """One round on ``dense`` from a state whose clients differ, on the
    reference's first round of batches."""
    h.check_one_round(ARCH, algorithm)


def test_initial_corrections_match_jax():
    """``init_state`` on the LM: the replicated x0 and the corrections from
    the initial batch's gradients (Σ_i c_i = 0)."""
    h.check_initial_corrections(ARCH)


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
        st["tx"], h.port_data_model(dm), tcfg, num_groups=G,
        compute_dtype=torch.float32, batches=batches)
    for name in ("client_mean_loss", "worst_client_loss"):
        _close(got[name], want[name], TOL, name)


