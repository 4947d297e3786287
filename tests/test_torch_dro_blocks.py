"""The DRO problem on the other block kinds against the JAX package: the
reduced mamba2-1.3b (Mamba2 SSD blocks, kernel B7) and recurrentgemma-9b
(RG-LRU blocks, B8, and local attention, B5), in f32 compute, with
``tests/_torch_dro.py``'s harness: the DRO value and per-client gradients,
one ``dense`` kgt_minimax round and the initial corrections of
``init_state``, on the reference's parameters and batches.

The port runs each check on two routes: the kernels' autograd Functions
with their plain forward swapped in for the launch (``"functions"``: the
forwards, plain backwards and ``vmap`` rules the card runs, each kernel
launched once a layer with the clients folded into its batch and the
cross-entropy once a client), and ``kernels=False``.

Tolerance: max |port − JAX| ≤ 1e-4·(1 + max|JAX|).

In bf16 compute the reduced recurrentgemma-9b's round is held to
``_torch_dro``'s bf16 limits (its corrections at TOL_BF16_RG_CX /
TOL_BF16_RG_CY), and the two ops that C1 of ROADMAP §C traced: the RG-LRU's
tanh GELU, which the port now computes as the reference does, forward and
gradient bit for bit; and the reference's gradient of the conv's bf16
weights, a running sum rounded to bf16 at every one of the B·S rows
(quirk 7), where the port sums in f32 and rounds once.
"""
import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dro as h
from repro.models import rglru as jax_rglru
from repro_torch.models import rglru as t_rglru

ARCHS = ("mamba2-1.3b", "recurrentgemma-9b")
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


def test_one_bf16_round_matches_jax():
    """One bf16 kgt_minimax round of the reduced recurrentgemma-9b in one
    process, ``kernels=False`` (the reference's form), against the
    reference's bf16 round."""
    arch = "recurrentgemma-9b"
    errs = h.bf16_round_errors(arch)
    lim = h.bf16_limits(arch)
    assert all(errs[f] <= lim[f] for f in lim), errs


def _bf16(rng, shape, scale=1.0):
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    return jnp.asarray(a).astype(jnp.bfloat16)


def _t(a):
    return torch.tensor(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)


def test_rglru_gelu_rounds_as_the_reference():
    """``models.rglru.gelu_tanh`` is ``jax.nn.gelu`` in bf16, and its
    gradient is ``jax.vjp``'s, bit for bit."""
    rng = np.random.default_rng(0)
    x, ct = _bf16(rng, (4096,), 3.0), _bf16(rng, (4096,))
    want, vjp = jax.vjp(jax.nn.gelu, x)
    (want_g,) = jax.jit(vjp)(ct)
    tx = _t(x).requires_grad_()
    got = t_rglru.gelu_tanh(tx)
    got.backward(_t(ct))
    assert torch.equal(got.detach(), _t(want))
    assert torch.equal(tx.grad, _t(want_g))


def test_the_reference_sums_the_conv_weight_gradient_in_bf16():
    """Quirk 7: the reference's gradient of the RG-LRU conv's bf16 weight
    and bias (each broadcast over the (B, S) rows) is XLA's reduce in bf16,
    which rounds its running sum at every row, in row-major order; the
    port's autograd sums the same bf16 products in f32 and rounds once.
    The two differ by whole bf16 ulps of the sum."""
    rng = np.random.default_rng(0)
    b, s, w, k = 2, 32, 64, 4
    x, ct = _bf16(rng, (b, s, w)), _bf16(rng, (b, s, w))
    cw, cb = _bf16(rng, (k, w), 0.1), _bf16(rng, (w,), 0.1)
    _, vjp = jax.vjp(lambda cw, cb: jax_rglru._conv1d(x, cw, cb)[0], cw, cb)
    want_w, want_b = (_t(g) for g in jax.jit(vjp)(ct))
    tx, tct = _t(x), _t(ct)
    xp = torch.nn.functional.pad(tx, (0, 0, k - 1, 0))

    def running(terms):
        acc = torch.zeros((w,), dtype=torch.bfloat16)
        for row in terms.reshape(b * s, w):
            acc = acc + row
        return acc

    assert torch.equal(want_b, running(tct))
    for i in range(k):
        assert torch.equal(want_w[i], running(xp[:, i:i + s] * tct))
    tw, tb = _t(cw).requires_grad_(), _t(cb).requires_grad_()
    t_rglru._conv1d(tx, tw, tb)[0].backward(tct)
    assert torch.equal(tb.grad, tct.float().sum((0, 1)).to(torch.bfloat16))
    assert not torch.equal(tw.grad, want_w)
    assert float((tw.grad.float() - want_w.float()).abs().max()) > 0
