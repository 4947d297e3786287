"""The port's MoE MLP (``repro_torch.models.moe``) and ``moe`` block against
the JAX package's, on the reduced granite-moe-1b-a400m (d_model 256, 4
experts, top 2, expert d_ff 64).

Both sides take the reference's ``init_moe`` arrays and the same numpy
inputs.  The routing is held exactly: the reference's expert choices (its
``lax.top_k``) and its combine tensor (the operand of its last einsum)
are read through spies, and the port's choices and in-capacity masks
must be identical, its combine equal to 1e-6 (the gates are f32 sums of
other orders).  A capacity factor of 0.5 makes tokens overflow.

Tolerances, as max |port − JAX| ≤ tol·(1 + max|JAX|): f32 compute 1e-5,
bf16 compute 3e-2 (as ``tests/test_torch_models.py``); gradients under
``vmap(grad)`` 1e-5 in f32.
"""
import _torch_threads  # noqa: F401
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.configs import registry as jax_registry
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro_torch.configs import registry
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tf

ARCH = "granite-moe-1b-a400m"
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
FACTORS = (1.25, 0.5)       # the default capacity, and one that drops
B, S = 2, 24


@functools.lru_cache(maxsize=None)
def _cfgs(factor=1.25, dispatch="dense"):
    jcfg = jax_registry.reduced(jax_registry.get_model_config(ARCH))
    tcfg = registry.reduced(registry.get_model_config(ARCH))
    return tuple(dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=factor, dispatch=dispatch))
        for c in (jcfg, tcfg))


@functools.lru_cache(maxsize=None)
def _params(seed=0):
    jcfg = _cfgs()[0]
    return jax.tree.map(np.asarray, jax_moe.init_moe(
        jax.random.PRNGKey(seed), jcfg, jcfg.d_model))


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def _tparams(p):
    return {k: torch.tensor(v) for k, v in p.items()}


def _x(jdt, seed=1, shape=(B, S)):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal((*shape, _cfgs()[0].d_model)),
                       jdt)


def _close(got, want, tol, what=""):
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * (1 + np.abs(want).max()), (what, err)


def _reference_routing(params, x, jcfg, jdt):
    """The reference's dense dispatch, run eagerly with spies on its
    ``lax.top_k`` (the expert choices) and its last einsum (the combine
    tensor, cast to the compute dtype).  Returns (out, aux, gate_idx,
    combine)."""
    seen = {}
    real_top_k, real_einsum = jax.lax.top_k, jnp.einsum

    def top_k(p, k):
        vals, idx = real_top_k(p, k)
        seen["gate_idx"] = np.asarray(idx)
        return vals, idx

    def einsum(spec, *ops, **kw):
        if spec == "bsec,becd->bsd":
            seen["combine"] = np.asarray(ops[0].astype(jnp.float32))
        return real_einsum(spec, *ops, **kw)

    with mock.patch.object(jax.lax, "top_k", top_k), \
            mock.patch.object(jnp, "einsum", einsum):
        out, aux = jax_moe.moe_mlp(params, jnp.asarray(x), jcfg,
                                   compute_dtype=jdt)
    return out, aux, seen["gate_idx"], seen["combine"]


@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_routing_is_the_reference_routing(dtype, factor):
    """Expert choices and in-capacity masks identical, the combine tensor
    within 1e-6; at factor 0.5 some choices overflow."""
    jdt, tdt, _ = DTYPES[dtype]
    jcfg, tcfg = _cfgs(factor)
    x = _x(jdt)
    _, _, want_idx, want_combine = _reference_routing(_params(), x, jcfg, jdt)
    routing = t_moe.route(_tparams(_params()), _t(x), tcfg)
    np.testing.assert_array_equal(routing.gate_idx.numpy(), want_idx)
    m = tcfg.moe
    cap = t_moe.capacity(S, m.num_experts, m.top_k, m.capacity_factor)
    _, in_cap = t_moe.capacity_slots(routing.gate_idx, m.num_experts, cap)
    # the reference's mask: a choice is kept iff its expert's row of the
    # combine tensor holds a weight
    want_in_cap = np.take_along_axis(
        (want_combine != 0).any(-1), want_idx, axis=-1)
    np.testing.assert_array_equal(in_cap.numpy(), want_in_cap)
    got_combine = t_moe.combine_weights(routing, m.num_experts, cap)
    if dtype == "bfloat16":  # the reference's operand was cast to bf16
        got_combine = got_combine.to(torch.bfloat16)
    np.testing.assert_array_equal(got_combine.float().numpy() != 0,
                                  want_combine != 0)
    _close(got_combine, want_combine, 1e-6, "combine")
    if factor < 1.0:
        assert int((~in_cap).sum()) > 0


@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_moe_mlp_matches_jax(dtype, factor):
    jdt, tdt, tol = DTYPES[dtype]
    jcfg, tcfg = _cfgs(factor)
    x = _x(jdt, seed=2)
    want, want_aux = jax_moe.moe_mlp(_params(), x, jcfg, compute_dtype=jdt)
    got, got_aux = t_moe.moe_mlp(_tparams(_params()), _t(x), tcfg, tdt)
    assert got.dtype == tdt
    _close(got, want, tol, "out")
    _close(got_aux, want_aux, 1e-6, "aux")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_moe_mlp_sorted_matches_jax(dtype):
    """The dropless dispatch, and the dense one where no token overflows
    (capacity factor 8, as the reference's own test holds them)."""
    jdt, tdt, tol = DTYPES[dtype]
    jcfg, tcfg = _cfgs(8.0, "sorted")
    x = _x(jdt, seed=3)
    want, want_aux = jax_moe.moe_mlp_sorted(_params(), x, jcfg,
                                            compute_dtype=jdt)
    got, got_aux = t_moe.moe_mlp_sorted(_tparams(_params()), _t(x), tcfg,
                                        tdt)
    _close(got, want, tol, "sorted out")
    _close(got_aux, want_aux, 1e-6, "aux")
    dense, _ = t_moe.moe_mlp(_tparams(_params()), _t(x), tcfg, tdt)
    _close(dense, want, tol, "dense without drops")


def test_vmap_grad_matches_jax():
    """Per-client gradients (two clients, each its own experts and batch)
    of Σ out·w + aux: ``vmap(grad)`` against ``jax.vmap(jax.grad)``, with
    tokens overflowing, in f32."""
    jcfg, tcfg = _cfgs(0.5)
    ps = [_params(0), _params(1)]
    stacked = {k: np.stack([p[k] for p in ps]) for k in ps[0]}
    xs = np.stack([np.asarray(_x(jnp.float32, seed=s)) for s in (4, 5)])
    wts = np.random.default_rng(6).standard_normal(xs.shape).astype(
        np.float32)

    def jloss(p, x):
        out, aux = jax_moe.moe_mlp(p, x, jcfg, compute_dtype=jnp.float32)
        return jnp.sum(out * wts[0]) + aux

    def tloss(p, x):
        out, aux = t_moe.moe_mlp(p, x, tcfg, torch.float32)
        return torch.sum(out * torch.tensor(wts[0])) + aux

    want = jax.jit(jax.vmap(jax.grad(jloss)))(stacked, xs)
    got = vmap(grad(tloss))(_tparams(stacked), torch.tensor(xs))
    for name in stacked:
        _close(got[name], want[name], 1e-5, name)


@pytest.mark.parametrize("transform", ["vmap", "grad"])
def test_sorted_dispatch_refuses_transforms(transform):
    _, tcfg = _cfgs(1.25, "sorted")
    p = _tparams(_params())
    x = _t(_x(jnp.float32))

    def out(p, x):
        return t_moe.moe_mlp_sorted(p, x, tcfg, torch.float32)[0].sum()

    with pytest.raises(RuntimeError, match="A7"):
        if transform == "vmap":
            vmap(out, in_dims=(None, 0))(p, x[None])
        else:
            grad(out)(p, x)


@pytest.mark.parametrize("dispatch", ["dense", "sorted"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_moe_block_matches_jax(mode, dtype, dispatch):
    """One ``moe`` block (attention, then the MoE MLP, the dispatch the
    config names) against ``repro.models.transformer.block_forward``: its
    output, its aux and, in prefill and decode, its KV cache."""
    from repro.models import model as jax_model
    from repro_torch.models import interop

    jdt, tdt, tol = DTYPES[dtype]
    jcfg, tcfg = _cfgs(1.25, dispatch)
    jparams = jax.tree.map(np.asarray, jax_tf.init_block(
        jax.random.PRNGKey(7), "moe", jcfg))
    block = t_tf.Block("moe", tcfg, None, device="meta",
                       dtype=torch.float32).to_empty(device="cpu")
    for name, p in block.named_parameters():
        head, _, leaf = name.partition(".")
        interop._assign(p, jparams[head][leaf] if leaf else jparams[head],
                        name)
    s = 1 if mode == "decode" else S
    pos = S + 3
    x = _x(jdt, seed=8, shape=(B, s))
    positions = (np.full((B, 1), pos, np.int32) if mode == "decode"
                 else np.tile(np.arange(s, dtype=np.int32), (B, 1)))
    cache = None
    if mode != "train":
        rng = np.random.default_rng(9)
        one = jax_model._block_cache_shape("moe", jcfg, B, S + 8, jdt)
        cache = {k: jnp.asarray(rng.standard_normal(v.shape), v.dtype)
                 for k, v in one.items()}
    want, want_cache, want_aux = jax_tf.block_forward(
        "moe", jparams, x, jcfg, mode=mode, positions=jnp.asarray(positions),
        cache=cache, pos=jnp.int32(pos) if mode == "decode" else None,
        compute_dtype=jdt)
    with torch.no_grad():
        got, got_cache, got_aux = t_tf.block_forward(
            "moe", block, _t(x), tcfg, mode=mode,
            positions=torch.tensor(positions),
            cache=(None if cache is None
                   else {k: _t(v) for k, v in cache.items()}),
            pos=pos if mode == "decode" else None, compute_dtype=tdt)
    _close(got, want, tol, "out")
    # in bf16 the router sees the attention's bf16 output, rounded at
    # other places by the two frameworks
    _close(got_aux, want_aux, tol, "aux")
    if mode != "train":
        for name in want_cache:
            _close(got_cache[name], want_cache[name], tol, name)
