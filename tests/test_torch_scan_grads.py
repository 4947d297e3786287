"""The gradients of the two scans, B7 (the SSD chunked scan) and B8 (the
RG-LRU recurrence), against the JAX package.

* ``ref.rglru_ref`` differentiates (its steps are stacked, not written
  with ``out=``), and its gradient in a and u, from zero and from a
  carried state, is ``jax.vjp`` of ``repro.models.rglru.rglru_scan``'s.
* ``SsdScanFn`` and ``RglruScanFn`` with the plain forward swapped in for
  the launch: ``grad`` and ``vmap(grad)`` over 3 clients through them equal
  the same transforms through the plain versions (``ref.ssd_chunked``,
  ``ref.rglru_ref``) and ``jax.vmap(jax.grad)`` of the reference's
  ``ssd_chunked`` / ``rglru_scan`` on the same numpy inputs; the ``vmap``
  rules fold the clients into B, so each call launches the forward once.
  ``RglruScanFn``'s backward launch swapped too (for the backward kernel's
  algebra, ``ref.rglru_bwd_scan``): one backward launch a call.
* The RG-LRU block with a carried state differentiates, and the reduced
  recurrentgemma-9b trains through the CLI on the CPU.

Tolerances, f32, max |got − want| ≤ tol·(1 + max|want|): 1e-5 against
the reference's gradients (its associative scan and chunked einsums sum
in other orders; measured ≤ 1e-6), 1e-6 between the Functions' closed-form
backwards and autograd through the plain versions.
"""
import _torch_threads  # noqa: F401
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.models import rglru as jax_rglru
from repro.models import ssm as jax_ssm
from repro_torch.configs import registry
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as t_rg
from repro_torch.kernels import ssd_scan as t_ssd
from repro_torch.launch import train as t_train
from repro_torch.models import model as t_model
from repro_torch.models import rglru as t_rglru_block

TOL_JAX = 1e-5
TOL_PLAIN = 1e-6
CLIENTS = 3
CHUNK = 8


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * (1 + np.abs(want).max()), (what, err)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture
def plain_launches(monkeypatch):
    """Each scan Function's launch swapped for the plain version,
    counting."""
    counts = {"ssd_scan": 0, "rglru_scan": 0}

    def ssd(xdt, loga, bm, cm, state0, chunk, force_route):
        counts["ssd_scan"] += 1
        return ref.ssd_chunked(xdt, loga, bm, cm, chunk, state0)

    def rg(a, u, force_route):
        counts["rglru_scan"] += 1
        return ref.rglru_ref(a, u)

    monkeypatch.setattr(t_ssd.SsdScanFn, "launch", staticmethod(ssd))
    monkeypatch.setattr(t_rg.RglruScanFn, "launch", staticmethod(rg))
    return counts


# ---------------------------------------------------------------------------
# the RG-LRU recurrence (B8)
# ---------------------------------------------------------------------------

def _rglru_inputs(b, s, w, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (b, s, w)).astype(np.float32)
    u = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    wts = rng.standard_normal((b, s, w)).astype(np.float32)
    return a, u, h0, wts


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,w", [(2, 300, 8), (1, 17, 5)])
def test_rglru_ref_gradient_matches_jax_vjp(b, s, w, with_h0):
    """The plain recurrence differentiates (the fault of ROADMAP C1): its
    VJP in a, u (and h0) is the reference model scan's."""
    a, u, h0, wts = _rglru_inputs(b, s, w, seed=s + w)
    if with_h0:
        want_h, vjp = jax.vjp(
            lambda a, u, h0: jax_rglru.rglru_scan(a, u, h0)[0],
            jnp.asarray(a), jnp.asarray(u), jnp.asarray(h0))
    else:
        want_h, vjp = jax.vjp(lambda a, u: jax_rglru.rglru_scan(a, u)[0],
                              jnp.asarray(a), jnp.asarray(u))
    want = vjp(jnp.asarray(wts))
    ops = [_t(x).requires_grad_(True) for x in (a, u, h0)[:2 + with_h0]]
    h = ref.rglru_ref(*ops)
    got = torch.autograd.grad(h, ops, _t(wts))
    _close(h.detach(), want_h, TOL_JAX, "h")
    for name, g, wnt in zip(("da", "du", "dh0"), got, want):
        _close(g, wnt, TOL_JAX, name)


def test_rglru_bwd_ref_is_the_plain_versions_autograd():
    a, u, _, wts = _rglru_inputs(3, 40, 6, seed=1)
    ta, tu = _t(a).requires_grad_(True), _t(u).requires_grad_(True)
    h = ref.rglru_ref(ta, tu)
    want = torch.autograd.grad(h, (ta, tu), _t(wts))
    got = ref.rglru_bwd_ref(_t(a), h.detach(), _t(wts))
    for g, w in zip(got, want):
        _close(g, w, TOL_PLAIN)


@pytest.mark.parametrize("transform", ["grad", "vmap_grad"])
def test_rglru_scan_fn_gradient(plain_launches, transform):
    """``RglruScanFn`` under ``grad`` and ``vmap(grad)`` over 3 clients: the
    plain version's autograd and the reference's ``jax.grad``; one forward
    launch a call."""
    a, u, _, wts = _rglru_inputs(CLIENTS * 2, 33, 7, seed=5)
    a, u = a.reshape(CLIENTS, 2, 33, 7), u.reshape(CLIENTS, 2, 33, 7)
    w = wts[:2]

    def loss(fn):
        return lambda a, u: (fn(a, u) * _t(w)).sum()

    def jloss(a, u):
        return (jax_rglru.rglru_scan(a, u)[0] * jnp.asarray(w)).sum()

    jgrad = jax.grad(jloss, argnums=(0, 1))
    if transform == "grad":
        args = (_t(a[0]), _t(u[0]))
        got = grad(loss(t_rg.rglru_scan_bsw), argnums=(0, 1))(*args)
        plain = grad(loss(ref.rglru_ref), argnums=(0, 1))(*args)
        want = jgrad(jnp.asarray(a[0]), jnp.asarray(u[0]))
    else:
        args = (_t(a), _t(u))
        got = vmap(grad(loss(t_rg.rglru_scan_bsw), argnums=(0, 1)))(*args)
        plain = vmap(grad(loss(ref.rglru_ref), argnums=(0, 1)))(*args)
        want = jax.vmap(jgrad)(jnp.asarray(a), jnp.asarray(u))
    assert plain_launches["rglru_scan"] == 1
    for g, p, wnt in zip(got, plain, want):
        _close(g, p, TOL_PLAIN)
        _close(g, wnt, TOL_JAX)


@pytest.mark.parametrize("transform", ["grad", "vmap_grad"])
def test_rglru_scan_fn_backward_launch(plain_launches, monkeypatch,
                                       transform):
    """``RglruScanFn`` with its backward launch swapped too — for the
    backward kernel's algebra, ``ref.rglru_bwd_scan`` at the kernel's
    chunk, counting —: one forward and one backward launch a call, the
    backward on plain tensors (the ``vmap`` rule folds the clients into B),
    and the gradients the plain version's autograd and ``jax.grad``'s."""
    seen = []

    def bwd(a, h, grad_h):
        seen.append(tuple(a.shape))
        for x in (a, h, grad_h):
            assert not torch._C._functorch.is_batchedtensor(x)
        return ref.rglru_bwd_scan(a, h, grad_h, t_rg.CHUNK)

    monkeypatch.setattr(t_rg.RglruScanFn, "backward_launch",
                        staticmethod(bwd))
    s, w = 2 * t_rg.CHUNK + 5, 7
    a, u, _, wts = _rglru_inputs(CLIENTS * 2, s, w, seed=11)
    a, u = a.reshape(CLIENTS, 2, s, w), u.reshape(CLIENTS, 2, s, w)
    wt = _t(wts[:2])

    def loss(fn):
        return lambda a, u: (fn(a, u) * wt).sum()

    def jloss(a, u):
        return (jax_rglru.rglru_scan(a, u)[0] * jnp.asarray(wts[:2])).sum()

    jgrad = jax.grad(jloss, argnums=(0, 1))
    if transform == "grad":
        args = (_t(a[0]), _t(u[0]))
        got = grad(loss(t_rg.rglru_scan_bsw), argnums=(0, 1))(*args)
        plain = grad(loss(ref.rglru_ref), argnums=(0, 1))(*args)
        want = jgrad(jnp.asarray(a[0]), jnp.asarray(u[0]))
        assert seen == [(2, s, w)]
    else:
        args = (_t(a), _t(u))
        got = vmap(grad(loss(t_rg.rglru_scan_bsw), argnums=(0, 1)))(*args)
        plain = vmap(grad(loss(ref.rglru_ref), argnums=(0, 1)))(*args)
        want = jax.vmap(jgrad)(jnp.asarray(a), jnp.asarray(u))
        assert seen == [(CLIENTS * 2, s, w)]
    assert plain_launches["rglru_scan"] == 1
    for g, p, wnt in zip(got, plain, want):
        _close(g, p, TOL_PLAIN)
        _close(g, wnt, TOL_JAX)


def test_rglru_backward_launch_is_the_plain_backward_on_the_cpu():
    """On CPU tensors the backward launch is ``ref.rglru_bwd_ref`` and
    counts no kernel launch."""
    a, u, _, wts = _rglru_inputs(2, 40, 5, seed=2)
    h = ref.rglru_ref(_t(a), _t(u))
    before = t_rg.rglru_scan_bsw.backward_launches
    got = t_rg.RglruScanFn.backward_launch(_t(a), h, _t(wts))
    want = ref.rglru_bwd_ref(_t(a), h, _t(wts))
    for g, wnt in zip(got, want):
        torch.testing.assert_close(g, wnt, rtol=0, atol=0)
    assert t_rg.rglru_scan_bsw.backward_launches == before


def test_rglru_block_with_a_carried_state_differentiates():
    """The block folds a carried h into the first step out of place, so a
    gradient reaches the state and the parameters, and equals the
    kernels=False route's."""
    cfg = registry.reduced(registry.get_model_config("recurrentgemma-9b"))
    model = t_model.init_params(cfg, generator=torch.Generator()
                                .manual_seed(0), device="cpu")
    params = dict(model.layers[0].rglru)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 9, cfg.d_model), generator=gen)
    h0 = torch.randn((2, cfg.rglru.lru_width), generator=gen)

    def loss(kernels):
        def f(p, h):
            out, cache = t_rglru_block.rglru_forward(
                p, x, cfg, torch.float32, h_state=h, kernels=kernels)
            return out.square().sum() + cache["h"].sum()
        return f

    got = grad(loss(True), argnums=(0, 1))(params, h0)
    want = grad(loss(False), argnums=(0, 1))(params, h0)
    assert float(got[1].abs().max()) > 0
    for name in params:
        torch.testing.assert_close(got[0][name], want[0][name], rtol=0,
                                   atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the SSD chunked scan (B7)
# ---------------------------------------------------------------------------

def _ssd_inputs(lead, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((*lead, s, h, p)).astype(np.float32)
    loga = -rng.uniform(0.01, 0.5, (*lead, s, h)).astype(np.float32)
    bm = rng.standard_normal((*lead, s, n)).astype(np.float32)
    cm = rng.standard_normal((*lead, s, n)).astype(np.float32)
    state0 = rng.standard_normal((*lead, h, p, n)).astype(np.float32)
    return xdt, loga, bm, cm, state0


@pytest.mark.parametrize("with_state0", [False, True])
@pytest.mark.parametrize("transform", ["grad", "vmap_grad"])
@pytest.mark.parametrize("s", [24, 21])
def test_ssd_scan_fn_gradient(plain_launches, transform, with_state0, s):
    """``SsdScanFn`` under ``grad`` and ``vmap(grad)`` over 3 clients, a
    whole and a ragged last chunk, from zero and from a state: the plain
    chunked scan's autograd and ``jax.grad`` of the reference's
    ``ssd_chunked``, in every operand, through y and the final state; one
    forward launch a call."""
    h, p, n, b = 3, 4, 5, 2
    ins = _ssd_inputs((CLIENTS, b), s, h, p, n, seed=s)
    rng = np.random.default_rng(7)
    wy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    wf = rng.standard_normal((b, h, p, n)).astype(np.float32)
    nargs = 5 if with_state0 else 4
    argnums = tuple(range(nargs))

    def loss(fn):
        def f(*ops):
            y, fin = fn(*ops[:4], ops[4] if with_state0 else None)
            return (y * _t(wy)).sum() + (fin * _t(wf)).sum()
        return f

    def jloss(*ops):
        y, fin = jax_ssm.ssd_chunked(*ops[:4], CHUNK,
                                     ops[4] if with_state0 else None)
        return (y * jnp.asarray(wy)).sum() + (fin * jnp.asarray(wf)).sum()

    kernel = loss(lambda *o: t_ssd.ssd_scan_bshp(*o[:4], o[4], chunk=CHUNK))
    plain = loss(lambda *o: ref.ssd_chunked(*o[:4], CHUNK, o[4]))
    jgrad = jax.grad(jloss, argnums=argnums)
    if transform == "grad":
        args = [x[0] for x in ins[:nargs]]
        got = grad(kernel, argnums=argnums)(*map(_t, args))
        want_plain = grad(plain, argnums=argnums)(*map(_t, args))
        want = jgrad(*map(jnp.asarray, args))
    else:
        args = ins[:nargs]
        got = vmap(grad(kernel, argnums=argnums))(*map(_t, args))
        want_plain = vmap(grad(plain, argnums=argnums))(*map(_t, args))
        want = jax.vmap(jgrad)(*map(jnp.asarray, args))
    assert plain_launches["ssd_scan"] == 1
    for name, g, pl, wnt in zip(("dxdt", "dloga", "dbm", "dcm", "dstate0"),
                                got, want_plain, want):
        _close(g, pl, TOL_PLAIN, name)
        _close(g, wnt, TOL_JAX, name)


def test_ssd_vmap_rule_folds_the_clients_without_a_copy(plain_launches,
                                                        monkeypatch):
    """The rule reshapes the clients into B: strided views of one buffer
    (B and C as the model's split of the conv output) reach the launch as
    views, not copies, with their row strides kept."""
    seen = []

    def spy(xdt, loga, bm, cm, state0, chunk, force_route):
        seen.append((bm.stride(), cm.stride()))
        return ref.ssd_chunked(xdt, loga, bm, cm, chunk, state0)

    monkeypatch.setattr(t_ssd.SsdScanFn, "launch", staticmethod(spy))
    xdt, loga, _, _, _ = _ssd_inputs((CLIENTS, 2), 16, 3, 4, 5, seed=2)
    conv = _t(np.random.default_rng(3).standard_normal(
        (CLIENTS, 2, 16, 12)).astype(np.float32))
    bm, cm = conv[..., 2:7], conv[..., 7:12]
    vmap(lambda x, la, b_, c_: t_ssd.ssd_scan_bshp(x, la, b_, c_,
                                                   chunk=CHUNK)[0])(
        _t(xdt), _t(loga), bm, cm)
    assert seen == [((16 * 12, 12, 1), (16 * 12, 12, 1))]


# ---------------------------------------------------------------------------
# training recurrentgemma on the CPU
# ---------------------------------------------------------------------------

def test_reduced_recurrentgemma_trains_through_the_cli(tmp_path, capsys):
    """``launch.train --arch recurrentgemma-9b --reduced --device cpu`` with
    the flags of ROADMAP C1: two rounds, each logged with a finite
    f(x̄, ȳ)."""
    out = tmp_path / "hist.json"
    t_train.main(["--arch", "recurrentgemma-9b", "--reduced", "--device",
                  "cpu", "--clients", "2", "--local-steps", "2", "--batch",
                  "2", "--seq-len", "32", "--groups", "4", "--rounds", "2",
                  "--chunk", "2", "--log-every", "1", "--out", str(out)])
    hist = json.loads(out.read_text())["history"]
    assert [r["round"] for r in hist] == [0, 1]
    assert all(np.isfinite(r["f_bar"]) and np.isfinite(r["mean_loss"])
               for r in hist)
    assert capsys.readouterr().err.count("f(x̄,ȳ)=") == 2
