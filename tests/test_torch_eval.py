"""The fused cross-entropy's plain version and the evaluation path against
the JAX package.

The same numpy inputs go through ``repro.kernels.ops.fused_cross_entropy``
with ``backend="interpret"`` (the Pallas kernel, as the JAX package's own
tests run it on the CPU) and through ``repro_torch.kernels.ops`` on CPU
tensors, which runs the plain version (``ref.fused_ce_ref``) that kernel B6
is held against on the card.  Then ``chunked_nll``, ``per_group_loss`` and
``group_metrics`` on the reduced mamba2-1.3b (tied head), holding the
reference's parameters (``models.interop``), on a batch of the reference's
sampler, in f32 and bf16, by both routes: the plain route
(``kernels=False``: the reference's form, logits in the compute dtype) and
the kernel route (autograd off: B6's function, f32 logits).

Tolerances, as max |port − JAX| ≤ tol·(1 + max|JAX|):
* f32: 1e-5 (measured ~1e-7: sum orders);
* bf16, plain route of ``chunked_nll``: 1e-5 — the same bf16 logits
  (measured 6.6e-7);
* bf16, kernel route of ``chunked_nll``: 1e-3 — B6 keeps its logits in
  f32 where the reference rounds them to bf16 (ROADMAP §C quirk 4;
  measured 2.4e-4, 1.7e-3 at an NLL of 6.9);
* bf16 group losses, either route: 1e-3 — means over the group's tokens of
  a backbone that the two frameworks round at other places (measured
  9e-5).
"""
import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.data import synthetic as jax_data
from repro.evaluation import metrics as jax_metrics
from repro.kernels import ops as jax_ops
from repro.models import model as jax_model
from repro_torch.configs import registry
from repro_torch.evaluation import metrics as t_metrics
from repro_torch.kernels import cross_entropy as t_ce
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.launch import evaluate as t_evaluate
from repro_torch.models import interop
from repro_torch.models import model as t_model

TOL = 1e-5
TOL_QUIRK = 1e-3
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def _close(got, want, tol, what=""):
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * (1 + np.abs(want).max()), (what, err)


def _ce_inputs(n, d, v, dtype, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((v, d)) * 3.0 / d ** 0.5).astype(np.float32)
    lab = rng.integers(0, v, (n,)).astype(np.int32)
    lab[0], lab[-1] = 0, v - 1
    if dtype == "bfloat16":
        h, w = (np.asarray(jnp.asarray(x, jnp.bfloat16)) for x in (h, w))
    return h, w, lab


# (N, d, V): ragged N and V against the Pallas blocks (128 tokens, 512
# vocabulary entries), V one past a block, one token
CE_CASES = [(130, 64, 700, "float32"), (5, 32, 513, "float32"),
            (300, 16, 1000, "bfloat16"), (1, 8, 3, "float32")]


@pytest.mark.parametrize("n,d,v,dtype", CE_CASES)
def test_fused_ce_plain_matches_pallas_kernel(n, d, v, dtype):
    h, w, lab = _ce_inputs(n, d, v, dtype, seed=n + v)
    want = jax_ops.fused_cross_entropy(jnp.asarray(h), jnp.asarray(w),
                                       jnp.asarray(lab), backend="interpret")
    got = t_ops.fused_cross_entropy(_t(h), _t(w), _t(lab).long())
    assert got.dtype == torch.float32
    _close(got, want, TOL)


def test_fused_ce_untied_layout_and_chunks_change_nothing():
    """An untied (d, V) head, read as its transposed view, gives the tied
    layout's NLL; the token chunk of the plain version changes nothing."""
    h, w, lab = (_t(a) for a in _ce_inputs(70, 24, 300, "float32", seed=2))
    tied = t_ref.fused_ce_ref(h, w, lab.long())
    untied = t_ref.fused_ce_ref(h, w.T.contiguous().T, lab.long())
    torch.testing.assert_close(untied, tied, rtol=0, atol=1e-6)
    for chunk in (1, 7, 64):
        torch.testing.assert_close(
            t_ref.fused_ce_ref(h, w, lab.long(), chunk=chunk), tied,
            rtol=0, atol=1e-6)


_SETUP = {}


def _setup():
    """Reference and port reduced mamba2-1.3b with the same parameters,
    and one client batch of the reference's sampler (4 × 40 tokens)."""
    if not _SETUP:
        jcfg = jax_registry.reduced(jax_registry.get_model_config(
            "mamba2-1.3b"))
        tcfg = registry.reduced(registry.get_model_config("mamba2-1.3b"))
        params = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
        model = interop.params_from_reference(
            jax.tree.map(np.asarray, params), tcfg, device="cpu")
        dm = jax_data.make_data_model(jax.random.PRNGKey(1),
                                      vocab_size=jcfg.vocab_size,
                                      num_groups=8, num_clients=4)
        batch = jax_data.sample_client_batch(dm, jax.random.PRNGKey(2), 1, 4,
                                             40)
        tbatch = {k: torch.tensor(np.asarray(v)).long()
                  for k, v in batch.items()}
        _SETUP.update(jcfg=jcfg, params=params, model=model, batch=batch,
                      tbatch=tbatch)
    return (_SETUP["jcfg"], _SETUP["params"], _SETUP["model"],
            _SETUP["batch"], _SETUP["tbatch"])


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_chunked_nll_matches_jax(dtype, route):
    """On the same hidden states, chunks of 16 over S = 40 (ragged)."""
    jcfg, params, model, batch, tbatch = _setup()
    jdt, tdt = DTYPES[dtype]
    hid = jnp.asarray(np.random.default_rng(0).standard_normal(
        (4, 40, jcfg.d_model)), jdt)
    want = jax_model.chunked_nll(params, hid, batch["labels"], jcfg,
                                 compute_dtype=jdt, chunk=16)
    with torch.no_grad():
        got = t_model.chunked_nll(model, _t(hid), tbatch["labels"],
                                  compute_dtype=tdt, chunk=16,
                                  kernels=(route == "kernel"))
    assert got.dtype == torch.float32
    tol = TOL_QUIRK if (dtype, route) == ("bfloat16", "kernel") else TOL
    _close(got, want, tol)


def test_chunked_nll_under_autograd_takes_the_plain_route():
    """With autograd on, ``kernels=True`` takes the kernel route as with
    autograd off — B6 is differentiable — which on CPU tensors is the
    kernel's plain version (f32 logits, ``ref.fused_ce_ref``), not the
    reference's bf16-logit form of ``kernels=False``; the gradient flows
    and is that of the plain version."""
    _, _, model, _, tbatch = _setup()
    hid = torch.randn((4, 40, model.cfg.d_model), requires_grad=True,
                      generator=torch.Generator().manual_seed(1))
    nll = t_model.chunked_nll(model, hid.to(torch.bfloat16),
                              tbatch["labels"], kernels=True)
    with torch.no_grad():
        no_grad = t_model.chunked_nll(model, hid.to(torch.bfloat16),
                                      tbatch["labels"], kernels=True)
        plain = t_model.chunked_nll(model, hid.to(torch.bfloat16),
                                    tbatch["labels"], kernels=False)
    assert torch.equal(nll.detach(), no_grad)
    assert not torch.equal(nll.detach(), plain)     # the logits' rounding
    nll.mean().backward()
    assert hid.grad is not None and torch.isfinite(hid.grad).all()
    h2 = hid.detach().clone().requires_grad_(True)
    t_ref.fused_ce_ref(
        h2.to(torch.bfloat16).reshape(-1, model.cfg.d_model),
        model.embed.to(torch.bfloat16), tbatch["labels"].reshape(-1)
    ).mean().backward()
    assert torch.equal(hid.grad, h2.grad)


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_per_group_loss_matches_jax(dtype, route):
    jcfg, params, model, batch, tbatch = _setup()
    jdt, tdt = DTYPES[dtype]
    want, _ = jax_model.per_group_loss(params, batch, jcfg, num_groups=8,
                                       compute_dtype=jdt)
    with torch.no_grad():
        got, aux = t_model.per_group_loss(model, tbatch, num_groups=8,
                                          compute_dtype=tdt,
                                          kernels=(route == "kernel"))
    assert float(aux) == 0.0
    _close(got, want, TOL if dtype == "float32" else TOL_QUIRK)


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_group_metrics_matches_jax(dtype, route):
    jcfg, params, model, batch, tbatch = _setup()
    jdt, tdt = DTYPES[dtype]
    want = jax_metrics.group_metrics(params, batch, jcfg, num_groups=8,
                                     compute_dtype=jdt)
    got = t_metrics.group_metrics(model, tbatch, num_groups=8,
                                  compute_dtype=tdt,
                                  kernels=(route == "kernel"))
    tol = TOL if dtype == "float32" else TOL_QUIRK
    for key in ("group_loss", "group_ppl", "mean_loss", "worst_group_loss"):
        _close(got[key], want[key], tol, key)
    assert int(got["groups_present"]) == int(want["groups_present"])
    assert int(got["worst_group"]) == int(want["worst_group"])
    # absent groups: loss 0, perplexity exp(0)
    absent = ~(torch.nn.functional.one_hot(tbatch["groups"], 8).sum((0, 1))
               > 0)
    assert torch.equal(got["group_loss"][absent],
                       torch.zeros(int(absent.sum())))


def test_evaluate_entry_point_on_cpu(capsys):
    """``launch.evaluate`` on the reduced mamba2: one batch a client, the
    metrics finite, no kernel launched on CPU tensors, and the same seed
    the same numbers."""
    res = t_evaluate.evaluate("mamba2-1.3b", clients=3, batch=2, seq_len=24,
                              device="cpu", reduced=True, seed=5)
    assert len(res.metrics) == 3 and len(res.batches) == 3
    for m, b in zip(res.metrics, res.batches):
        assert b["tokens"].shape == (2, 24)
        assert torch.isfinite(m["group_loss"]).all()
        assert 1 <= int(m["groups_present"]) <= 2
    assert all(set(n.values()) == {0} for n in res.launches)
    again = t_evaluate.evaluate("mamba2-1.3b", clients=3, batch=2,
                                seq_len=24, device="cpu", reduced=True,
                                seed=5, verbose=False)
    for a, b in zip(res.metrics, again.metrics):
        assert torch.equal(a["group_loss"], b["group_loss"])
    t_evaluate.main(["--device", "cpu", "--reduced", "--seq-len", "16",
                     "--clients", "2", "--batch", "1"])
    assert "worst client" in capsys.readouterr().out


def test_fused_ce_wrapper_refuses_what_the_kernel_does_not_take():
    h = torch.zeros((4, 8))
    w = torch.zeros((10, 8))
    lab = torch.zeros((4,), dtype=torch.long)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_ce.fused_ce_nd(h, w, lab)
    with pytest.raises(ValueError, match="share float32 or bfloat16"):
        t_ce.fused_ce_nd(h, w.to(torch.bfloat16), lab)
    with pytest.raises(ValueError, match="CUDA"):
        t_ops.fused_cross_entropy(h, w, lab, backend="kernel")
    assert t_ops.launch_counts()["fused_cross_entropy"] == 0
