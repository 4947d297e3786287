"""The DRO problem on the MoE block and the modality frontends against the
JAX package, with ``tests/_torch_dro.py``'s harness: the reduced
granite-moe-1b-a400m (2 ``moe`` layers: 4 experts, top 2, tied head),
musicgen-medium (4 codebooks, untied (C, d, V) head) and internvl2-76b (4
prefix embeddings a sequence), in f32 compute: the DRO value and
per-client gradients, one ``dense`` kgt_minimax round and the initial
corrections of ``init_state``, on the reference's parameters and batches
(its codebook streams and prefix embeddings among them).

Each check runs on two routes: the kernels' autograd Functions with their
plain forward swapped in for the launch (``"functions"``: B5 once a layer
with the clients folded, B6 once a client and codebook) and
``kernels=False``.  Then the adversarial problem's full-logit NLL over
codebooks, ``evaluate_clients`` with codebooks, and the reduced
granite-moe-1b-a400m through the train CLI.

Tolerance: max |port − JAX| ≤ 1e-4·(1 + max|JAX|).
"""
import _torch_threads  # noqa: F401
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dro as h
from repro.core import objectives as jax_objectives
from repro.data import synthetic as jax_data
from repro.evaluation import metrics as jax_metrics
from repro_torch.core import objectives as t_objectives
from repro_torch.evaluation import metrics as t_metrics
from repro_torch.launch import train as t_train
from repro_torch.models import interop
from repro_torch.models import model as t_model

ARCHS = ("granite-moe-1b-a400m", "musicgen-medium", "internvl2-76b")
ROUTES = ("functions", "kernels_false")


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("arch", ARCHS)
def test_dro_value_and_per_client_gradients_match_jax(arch, route):
    h.check_value_and_grads(arch, route)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("arch", ARCHS)
def test_one_kgt_minimax_round_matches_jax(arch, route):
    h.check_one_round(arch, "kgt_minimax", route)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("arch", ARCHS)
def test_initial_corrections_match_jax(arch, route):
    h.check_initial_corrections(arch, route)


def test_the_reference_batches_carry_the_frontends():
    """The harness's batches are the reference's own: (K, n, B, S, C)
    codebook streams, and (K, n, B, P, d) f32 prefix embeddings."""
    for arch, key, shape in (
            ("musicgen-medium", "labels", (h.K, h.N, h.B, h.S, 4)),
            ("internvl2-76b", "prefix", (h.K, h.N, h.B, 4, 256))):
        b = h.batch_of(h.reference_inputs(arch)["batches"][0])
        assert tuple(b[key].shape) == shape
        assert b[key].dtype == (torch.float32 if key == "prefix"
                                else torch.int64)


def test_adversarial_problem_over_codebooks_matches_jax():
    """The adversarial problem's NLL of the full (B, S, C, V) logits, the
    mean over codebooks, and its gradients."""
    arch = "musicgen-medium"
    jcfg, tcfg = h.cfgs(arch)
    ref_run = h.reference_inputs(arch)
    params = jax.tree.map(jnp.asarray, ref_run["x0"])
    batch = jax.tree.map(lambda a: a[0, 0], ref_run["batches"][0])
    y = np.random.default_rng(2).standard_normal(jcfg.d_model).astype(
        np.float32)
    jprob = jax_objectives.adversarial_problem(jcfg,
                                               compute_dtype=jnp.float32)
    want_v = jprob.value(params, jnp.asarray(y), batch, None)
    _, want_gy = jax.jit(jprob.grads)(params, jnp.asarray(y), batch,
                                      jax.random.PRNGKey(0))
    prob = t_objectives.adversarial_problem(tcfg,
                                            compute_dtype=torch.float32)
    x = t_model.param_dict(interop.params_from_reference(
        ref_run["x0"], tcfg, device="cpu"))
    tb = h.batch_of(batch)
    h.close(prob.value(x, torch.tensor(y), tb, None).numpy(), want_v, h.TOL,
            "adversarial value")
    _, got_gy = prob.grads(x, torch.tensor(y), tb, torch.zeros((0,)))
    h.close(got_gy.numpy(), want_gy, h.TOL, "adversarial grad y")


def test_evaluate_clients_with_codebooks_matches_jax():
    arch = "musicgen-medium"
    jcfg, tcfg = h.cfgs(arch)
    st = h.f32_setup(arch)
    dm = h.reference_inputs(arch)["dm"]
    key = jax.random.PRNGKey(9)
    want = jax_metrics.evaluate_clients(
        jax.tree.map(jnp.asarray, st["x"]), dm, jcfg, key, num_groups=h.G,
        per_client_batch=h.B, seq_len=h.S, compute_dtype=jnp.float32)
    batches = [h.batch_of(jax_data.sample_client_batch(
        dm, jax.random.fold_in(key, i), i, h.B, h.S, jcfg.num_codebooks))
        for i in range(h.N)]
    got = t_metrics.evaluate_clients(
        st["tx"], h.port_data_model(dm), tcfg, num_groups=h.G,
        compute_dtype=torch.float32, batches=batches)
    for name in ("client_mean_loss", "worst_client_loss"):
        h.close(got[name], want[name], h.TOL, name)


def test_reduced_granite_moe_trains_through_the_cli(tmp_path, capsys):
    """``launch.train --arch granite-moe-1b-a400m --reduced --device cpu``:
    two rounds, each logged with a finite f(x̄, ȳ) (its aux inside)."""
    out = tmp_path / "hist.json"
    t_train.main(["--arch", "granite-moe-1b-a400m", "--reduced", "--device",
                  "cpu", "--clients", "2", "--local-steps", "2", "--batch",
                  "2", "--seq-len", "32", "--groups", "4", "--rounds", "2",
                  "--chunk", "2", "--log-every", "1", "--out", str(out)])
    hist = json.loads(out.read_text())["history"]
    assert [r["round"] for r in hist] == [0, 1]
    assert all(np.isfinite(r["f_bar"]) and np.isfinite(r["mean_loss"])
               for r in hist)
    assert capsys.readouterr().err.count("f(x̄,ȳ)=") == 2
