"""Compressed gossip (error feedback, ``gossip_compress``) against the JAX
package: ``ef_transmit``, one compressed round on ``pallas_packed`` and on
``fused_round``, the Σc = 0 invariant, the inactive-client freeze, and
checkpoints of a compressed state in both directions.

``ef_transmit`` is a copy of the reference's f32 arithmetic and the
quantizer is bitwise to the reference's, so it must agree bit for bit.  A
whole round is compared at 1e-6·(1 + max) (the JAX package's own kernel
tolerance): the two frameworks' local steps differ by a few ulps of Δ, and
an int8 or bf16 rounding can flip on such a difference.  So the round is
compared at the entries that mix no transmitted entry whose reference
value v = Δ + e lies within max(1 ulp, |v_port − v_ref|) of a rounding
boundary, and q + e' == v is held bitwise everywhere, on the port's own v.
"""
import _torch_threads  # noqa: F401
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_round as tr
from repro.checkpoint import checkpoint as jax_ckpt
from repro.configs.base import AlgorithmConfig as JaxConfig
from repro.core import compression as jax_compression
from repro.core import init_state as jax_init_state
from repro.core import make_round_step as jax_make_round_step
from repro.core import quadratic_problem as jax_quadratic_problem
from repro.kernels import ops as jax_ops
from repro_torch.checkpoint import checkpoint as t_ckpt
from repro_torch.configs import AlgorithmConfig
from repro_torch.core import (
    compression,
    correction_mean_norm,
    from_reference,
    init_state,
    make_quadratic_data,
    make_round_step,
    mixing_matrix,
    quadratic_problem,
)
from repro_torch.core import tree as tree_lib
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref

N, DX, DY, K = tr.N, tr.DX, tr.DY, 4
METHODS = ("bf16", "int8")
IMPLS = ("pallas_packed", "fused_round")
TOL = 1e-6


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (1.0 + np.max(np.abs(b))))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("method", METHODS)
def test_ef_transmit_bitwise(method, masked):
    rng = np.random.default_rng(7)
    delta = rng.standard_normal((9, 37)).astype(np.float32)
    ef = (1e-3 * rng.standard_normal((9, 37))).astype(np.float32)
    delta[3] = 0.0                                   # an all-zero row
    mask = (rng.random(9) < 0.6) if masked else None
    q_j, e_j = jax_compression.ef_transmit(
        jnp.asarray(delta), jnp.asarray(ef), method,
        None if mask is None else jnp.asarray(mask))
    q_t, e_t = compression.ef_transmit(
        torch.from_numpy(delta), torch.from_numpy(ef), method,
        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    v = (delta + ef) * (1.0 if mask is None else mask[:, None])
    np.testing.assert_array_equal((q_t + e_t).numpy()[mask if masked
                                                      else slice(None)],
                                  v[mask if masked else slice(None)])
    if masked:
        assert not q_t.numpy()[~mask].any()          # nothing on the wire
        np.testing.assert_array_equal(e_t.numpy()[~mask], ef[~mask])


def test_validate_and_init_match_the_reference():
    for m in (None, "none", "", "bf16", "int8"):
        assert compression.validate_method(m) == \
            jax_compression.validate_method(m)
    with pytest.raises(ValueError) as ours:
        compression.validate_method("fp4")
    with pytest.raises(ValueError) as ref:
        jax_compression.validate_method("fp4")
    assert str(ours.value) == str(ref.value)
    assert compression.COMPRESS_METHODS == jax_compression.COMPRESS_METHODS
    np.testing.assert_array_equal(compression.init_ef(3, 5, "cpu").numpy(),
                                  np.asarray(jax_compression.init_ef(3, 5)))


# ---------------------------------------------------------------------------
# one compressed round against the reference's round step
# ---------------------------------------------------------------------------

def _cfg_kw(algo, impl, method):
    return dict(tr._cfg_kwargs(algo, K), mixing_impl=impl,
                gossip_compress=method)


def _quantum_flips(v, nudge, method):
    """Entries of v (n, D) whose quantized value changes when v moves by
    ±nudge (elementwise), at v's own int8 row scale."""
    v = v.astype(np.float32)
    if method == "bf16":
        def q(a):
            return torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    else:
        s = np.abs(v).max(1, keepdims=True) * np.float32(1.0 / 127.0)
        safe = np.where(s > 0, s, np.float32(1.0))

        def q(a):
            return np.round(a / safe)
    base = q(v)
    return (q((v + nudge).astype(np.float32)) != base) | \
        (q((v - nudge).astype(np.float32)) != base)


def _reference_fused_v(args):
    """The transmitted v = mask·(Δ + e) of the reference's whole round, by
    the expression of ``repro.kernels.ref.fused_round_ref``."""
    w, z0, c, ef, g, h_steps, step, etas, corr, mask = (
        jnp.asarray(a) for a in args)
    z = z0
    for k in range(h_steps.shape[0]):
        grad = jnp.einsum("nij,nj->ni", g, z,
                          preferred_element_type=jnp.float32)
        z = z - step * (grad + h_steps[k] + c)
    return np.asarray(mask * ((z - z0) + ef))


@functools.lru_cache(maxsize=None)
def _jax_round(algo, impl, method, sigma=0.1):
    """(initial state, state after one round, the reference's v per
    variable) as numpy; v is captured at ``ef_transmit`` (pallas_packed)
    or at the whole-round call (fused_round)."""
    key, data = tr._reference_data()
    prob = jax_quadratic_problem(data, sigma=sigma)
    cfg = JaxConfig(**_cfg_kw(algo, impl, method))
    cb = {n: v for n, v in data.items() if n != "mu"}
    kb = jax.tree.map(lambda v: jnp.broadcast_to(v[None], (K, *v.shape)), cb)
    st = jax_init_state(prob, cfg, key, init_batch=cb,
                        init_keys=jax.random.split(key, N))
    seen = []
    mp = pytest.MonkeyPatch()
    if impl == "pallas_packed":
        orig = jax_compression.ef_transmit

        def spy(d, e, m, mask=None):
            seen.append(np.asarray(d, np.float32) + np.asarray(e, np.float32))
            return orig(d, e, m, mask)

        mp.setattr(jax_compression, "ef_transmit", spy)
    else:
        orig = jax_ops.fused_round

        def spy(*args, **kw):
            v = _reference_fused_v(args)
            seen.extend([v[:, :DX], v[:, DX:]])
            return orig(*args, **kw)

        mp.setattr(jax_ops, "fused_round", spy)
    try:
        st1 = jax_make_round_step(prob, cfg)(st, kb, tr._round_keys(0, K))
    finally:
        mp.undo()
    return tr._state_np(st), _full_np(st1), tuple(seen)


def _full_np(st):
    out = tr._state_np(st)
    out["ef_x"], out["ef_y"] = np.asarray(st.ef_x), np.asarray(st.ef_y)
    return out


def _port_round(algo, impl, method, sigma=0.1):
    init, _, _ = _jax_round(algo, impl, method, sigma)
    _, data = tr._reference_data()
    tdata, st = from_reference({n: np.asarray(v) for n, v in data.items()},
                               init, device="cpu")
    st.ef_x = compression.init_ef(N, DX, "cpu")
    st.ef_y = compression.init_ef(N, DY, "cpu")
    prob = quadratic_problem(tdata, sigma=sigma)
    cfg = AlgorithmConfig(**_cfg_kw(algo, impl, method))
    batches = {n: v.unsqueeze(0).expand(K, *v.shape)
               for n, v in tdata.items() if n != "mu"}
    step = make_round_step(prob, cfg, device="cpu")
    return step(st, batches, tr._round_noise(0, K))


def _port_wire(monkeypatch, impl):
    """Spies on the port's transmit: a list that gets (v, q, e') per
    variable."""
    seen = []
    if impl == "pallas_packed":
        orig = compression.ef_transmit

        def spy(d, e, m, mask=None):
            q, e_new = orig(d, e, m, mask)
            seen.append((d.float() + e.float(), q, e_new))
            return q, e_new

        monkeypatch.setattr(compression, "ef_transmit", spy)
    else:
        orig = t_ops.fused_round

        def spy(w, z0, c, ef, g, h, step, etas, corr, mask, **kw):
            q, e_new, delta = t_ref.local_steps_ref(
                z0, c, ef, g, h, step, mask, compress=kw["compress"])
            v = mask * (delta + ef)
            for sl in (slice(0, DX), slice(DX, None)):
                seen.append((v[:, sl], q[:, sl], e_new[:, sl]))
            return orig(w, z0, c, ef, g, h, step, etas, corr, mask, **kw)

        monkeypatch.setattr(t_ops, "fused_round", spy)
    return seen


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("algo", ["kgt_minimax", "gt_gda"])
def test_compressed_round_matches_jax(algo, impl, method, monkeypatch):
    _, ref, v_ref = _jax_round(algo, impl, method)
    wire = _port_wire(monkeypatch, impl)
    st = _port_round(algo, impl, method)
    assert len(wire) == 2 and len(v_ref) == 2
    support = (mixing_matrix("ring", N) > 0).astype(np.float64)
    for var, (v, q, e_new), vr, d in zip(("x", "y"), wire, v_ref, (DX, DY)):
        # the residual identity, bitwise, on the port's own v
        np.testing.assert_array_equal((q + e_new).numpy(), v.numpy())
        vp = v.numpy()
        assert _rel(vp, vr) <= TOL, (var, _rel(vp, vr))
        nudge = np.maximum(np.spacing(np.abs(vr)), np.abs(vp - vr))
        flips = _quantum_flips(vr, nudge, method)
        touched = (support @ flips.astype(np.float64)) > 0
        assert touched.mean() < 0.5, (var, touched.mean())
        keep = ~touched
        for name in (var, "c" + var):
            got = getattr(st, name).numpy()
            assert _rel(got[keep], ref[name][keep]) <= 4 * TOL, (
                name, _rel(got[keep], ref[name][keep]))
        ef = getattr(st, "ef_" + var).numpy()
        assert _rel(ef[~flips], ref["ef_" + var][~flips]) <= TOL


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("impl", IMPLS)
def test_compressed_rounds_keep_sigma_c_zero(impl, method):
    st = _port_round("kgt_minimax", impl, method)
    for c in (st.cx, st.cy):
        assert float(correction_mean_norm(c)) <= 1e-5 * (
            1.0 + float(c.abs().max()))


# ---------------------------------------------------------------------------
# participation: inactive clients keep θ, c and the residual bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("impl", IMPLS)
def test_inactive_clients_freeze_with_their_residual(impl, method):
    _, data = tr._reference_data()
    init, _, _ = _jax_round("kgt_minimax", impl, method)
    tdata, st = from_reference({n: np.asarray(v) for n, v in data.items()},
                               init, device="cpu")
    gen = torch.Generator().manual_seed(3)
    st.ef_x = 1e-3 * torch.randn((N, DX), generator=gen)
    st.ef_y = 1e-3 * torch.randn((N, DY), generator=gen)
    prob = quadratic_problem(tdata, sigma=0.1)
    cfg = AlgorithmConfig(**_cfg_kw("kgt_minimax", impl, method))
    batches = {n: v.unsqueeze(0).expand(K, *v.shape)
               for n, v in tdata.items() if n != "mu"}
    step = make_round_step(prob, cfg, participation=True, device="cpu")
    mask = torch.tensor([1, 0, 1, 1, 0, 1, 1, 0], dtype=torch.bool)
    out = step(st, batches, tr._round_noise(0, K), mask)
    off = ~mask
    for name in ("x", "y", "cx", "cy", "ef_x", "ef_y"):
        np.testing.assert_array_equal(getattr(out, name)[off].numpy(),
                                      getattr(st, name)[off].numpy())
        assert not torch.equal(getattr(out, name)[mask],
                               getattr(st, name)[mask]), name
    for c in (out.cx, out.cy):
        assert float(correction_mean_norm(c)) <= 1e-5 * (
            1.0 + float(c.abs().max()))


# ---------------------------------------------------------------------------
# state layout and checkpoints
# ---------------------------------------------------------------------------

def _jax_state(method):
    key, data = tr._reference_data()
    prob = jax_quadratic_problem(data, sigma=0.1)
    cfg = JaxConfig(**_cfg_kw("kgt_minimax", "pallas_packed", method))
    cb = {n: v for n, v in data.items() if n != "mu"}
    return jax_init_state(prob, cfg, key, init_batch=cb,
                          init_keys=jax.random.split(key, N))


def _port_state(method):
    gen = torch.Generator().manual_seed(0)
    data = make_quadratic_data(gen, N, dx=DX, dy=DY)
    prob = quadratic_problem(data, sigma=0.1)
    cfg = AlgorithmConfig(**_cfg_kw("kgt_minimax", "pallas_packed", method))
    cb = {n: v for n, v in data.items() if n != "mu"}
    return init_state(prob, cfg, gen, init_batch=cb)


def test_uncompressed_state_keeps_its_leaves():
    st = _port_state(None)
    assert st.ef_x is None and st.ef_y is None
    leaves = tree_lib.leaves(st)
    assert len(leaves) == len(jax.tree.leaves(_jax_state(None))) == 5
    comp = _port_state("int8")
    assert len(tree_lib.leaves(comp)) == len(
        jax.tree.leaves(_jax_state("int8"))) == 7
    assert comp.ef_x.shape == (N, DX) and not comp.ef_x.any()
    assert comp.ef_y.shape == (N, DY) and not comp.ef_y.any()


@pytest.mark.parametrize("method", [None, "int8"])
def test_checkpoint_crosses_both_ways(tmp_path, method):
    jst = _jax_state(method)
    if method:
        jst = dataclasses.replace(jst, ef_x=jst.ef_x + 0.25,
                                  ef_y=jst.ef_y - 0.5)
    jpath = str(tmp_path / "ref.npz")
    jax_ckpt.save(jpath, jst)
    tmpl = _port_state(method)
    got = t_ckpt.restore(jpath, tmpl)
    for name in ("x", "y", "cx", "cy") + (("ef_x", "ef_y") if method
                                          else ()):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(jst, name)))
    assert got.round == int(jst.round)
    if not method:
        assert got.ef_x is None and got.ef_y is None
    # and back: the port's save restores into the reference's template
    got = dataclasses.replace(got, round=7)
    tpath = str(tmp_path / "port.npz")
    t_ckpt.save(tpath, got)
    back = jax_ckpt.restore(tpath, jst)
    for name in ("x", "y", "cx", "cy") + (("ef_x", "ef_y") if method
                                          else ()):
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      getattr(got, name).numpy())
    assert int(back.round) == 7
    with np.load(tpath) as z:
        names = sorted(z.files)
    assert len(names) == (7 if method else 5)
    if method:   # the residuals follow round, in the reference's order
        with np.load(tpath) as z:
            assert z["leaf_00004"].shape == ()
            np.testing.assert_array_equal(z["leaf_00005"],
                                          got.ef_x.numpy())


def test_compressed_launches_are_counted_by_route():
    """B2's launches with compression count by route beside its routes,
    and ride a CUDA graph's capture and replay like the other counts."""
    from repro_torch.kernels import fused_round as t_fr

    t_ops.zero_launch_counts()
    with t_ops.uncounted() as delta:
        t_fr.fused_round_nd.launches += 3
        t_fr.fused_round_nd.routes["cluster"] += 3
        t_fr.fused_round_nd.compressed["cluster"] += 2
    assert t_ops.launch_counts()["fused_round"] == 0
    assert t_ops.compressed_route_counts() == {
        "fused_round": {"cluster": 0, "block": 0}}
    assert delta["fused_round"] == (3, {"cluster": 3, "block": 0},
                                    {"cluster": 2, "block": 0})
    t_ops.add_launch_counts(delta)
    t_ops.add_launch_counts(delta)
    assert t_ops.route_counts()["fused_round"] == {"cluster": 6, "block": 0}
    assert t_ops.compressed_route_counts() == {
        "fused_round": {"cluster": 4, "block": 0}}
    t_ops.zero_launch_counts()
    assert t_ops.compressed_route_counts() == {
        "fused_round": {"cluster": 0, "block": 0}}
