"""The adversary axis against the JAX package: attacker ids, ``apply_attack``
per row, the robust aggregations (``_robust_reduce``, ``robust_mix_dense``
/ ``robust_mix_sparse``) against the reference and against the oracle
``robust_agg_ref``, one Byzantine round per lowering, the ``attack_fn``
slot of ``with_topology``, and an ``adversary`` sweep cell against its
points.

The reference draws the ``random_noise`` attack inside its round step from
a key; the port's sampler draws its own.  So the parity tests compute the
reference's draws (``normal(fold_in(fold_in(key, stream), leaf))``) and
hand them to the port as the ``Adversary``'s noise, never reproducing
them.  Tolerances: ``apply_attack`` is elementwise with the reference's
expressions, so bitwise; a robust aggregation sums the same values in
another order, 1e-6·(1 + max); one round, 1e-5·(1 + max) (the round tests'
bound, ``tests/test_torch_round.py``).
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
from repro.configs.base import AlgorithmConfig as JaxConfig
from repro.core import adversary as jax_adv
from repro.core import init_state as jax_init_state
from repro.core import make_round_step as jax_make_round_step
from repro.core import mixing as jax_mixing
from repro.core import quadratic_problem as jax_quadratic_problem
from repro.core import sparse_topology as jax_sparse
from repro.kernels import ref as jax_ref
from repro_torch.configs import AlgorithmConfig
from repro_torch.core import (
    adversary,
    correction_mean_norm,
    from_reference,
    make_round_step,
    mixing,
    quadratic_problem,
    sparse_from_reference,
    sparse_masked_w,
)
from repro_torch.engine import sampler as sampler_lib
from repro_torch.kernels import ref as t_ref
from repro_torch.sweep import defs, grid
from repro_torch.sweep import run as sweep_run

N, DX, DY, K = tr.N, tr.DX, tr.DY, 4
ATTACKS = ("honest", "sign_flip", "large_norm", "random_noise")
RULES = ("coord_median", "trimmed_mean")
TOL_AGG, TOL_ROUND = 1e-6, 1e-5


def _rel(a, b) -> float:
    """max |a − b| / (1 + max |b|) over the finite entries of b; a must
    be non-finite exactly where b is (a row whose only candidate is NaN
    stays NaN, in the reference as here)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    fin = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), fin)
    return float(np.max(np.abs(a[fin] - b[fin])) / (1.0 + np.max(
        np.abs(b[fin]))))


def test_constants_match_the_reference():
    assert adversary.ATTACKS == jax_adv.ATTACKS
    assert adversary.ATTACK_IDS == jax_adv.ATTACK_IDS
    assert adversary.ATTACK_STREAM == jax_adv.ATTACK_STREAM
    assert adversary.LARGE_NORM == jax_adv.LARGE_NORM
    assert mixing.ROBUST_IMPLS == jax_mixing.ROBUST_IMPLS
    assert mixing.ROBUST_RULES == jax_mixing.ROBUST_RULES
    assert mixing.MIXING_IMPLS == jax_mixing.MIXING_IMPLS
    for impl in mixing.ROBUST_IMPLS:
        assert mixing.robust_rule(impl) == jax_mixing.robust_rule(impl)
    with pytest.raises(ValueError) as ours:
        mixing.robust_rule("dense")
    with pytest.raises(ValueError) as ref:
        jax_mixing.robust_rule("dense")
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("n,num_byz,attack_id",
                         [(8, 0, 1), (8, 2, 3), (5, 5, 2), (1, 1, 1),
                          (7, 9, 3)])
def test_attack_ids(n, num_byz, attack_id):
    np.testing.assert_array_equal(
        adversary.attack_ids(n, num_byz, attack_id, device="cpu").numpy(),
        np.asarray(jax_adv.attack_ids(n, num_byz, attack_id)))


def _reference_noise(key, stream, leaves):
    """The reference's random_noise draws for ``leaves`` (unscaled)."""
    k = jax.random.fold_in(key, stream)
    return tuple(np.asarray(jax.random.normal(jax.random.fold_in(k, i),
                                              x.shape, jnp.float32))
                 for i, x in enumerate(leaves))


def _port_adversary(ref_adv, like, device="cpu"):
    """The reference's Adversary as the port's, its noise drawn by the
    reference for ``like = (x leaves, y leaves)``."""
    return adversary.Adversary(
        ids=torch.as_tensor(np.array(ref_adv.ids)).to(device),
        scale=torch.as_tensor(np.array(ref_adv.scale)).to(device),
        noise=tuple(tuple(torch.as_tensor(a).to(device) for a in
                          _reference_noise(ref_adv.key, s, leaves))
                    for s, leaves in enumerate(like)))


@pytest.mark.parametrize("stream", [0, 1])
@pytest.mark.parametrize("attack", ATTACKS[1:])
def test_apply_attack_per_row(attack, stream):
    rng = np.random.default_rng(11)
    tree = {"a": rng.standard_normal((6, 4)).astype(np.float32),
            "b": rng.standard_normal((6, 2, 3)).astype(np.float32)}
    ref_adv = jax_adv.make_attack_sampler(
        6, jax.random.PRNGKey(5), num_byzantine=3, attack=attack,
        scale=2.5)(4)
    want = jax_adv.apply_attack(ref_adv, jax.tree.map(jnp.asarray, tree),
                                stream=stream)
    leaves = jax.tree.leaves(tree)
    adv = _port_adversary(ref_adv, (leaves, leaves))
    got = adversary.apply_attack(
        adv, {k: torch.from_numpy(v) for k, v in tree.items()},
        stream=stream)
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        # honest rows untouched, bit for bit
        np.testing.assert_array_equal(got[k][3:].numpy(), tree[k][3:])


def test_attack_sampler_draws_are_pure_in_the_round():
    like = (torch.zeros(4, 3), {"u": torch.zeros(4, 2), "v": torch.zeros(4)})
    fn = adversary.make_attack_sampler(4, 9, num_byzantine=1,
                                       attack="random_noise", scale=2.0,
                                       like=like, device="cpu")
    a, b, c = fn(3), fn(4), fn(3)
    flat = [t for var in a.noise for t in var]
    assert [tuple(t.shape) for t in flat] == [(4, 3), (4, 2), (4,)]
    for x, y in zip(flat, [t for var in c.noise for t in var]):
        assert torch.equal(x, y)                     # same round, same draw
    assert not torch.equal(a.noise[0][0], b.noise[0][0])
    # every (variable, leaf) its own stream
    assert not torch.equal(a.noise[1][0][:, 0], a.noise[1][1])
    assert not torch.equal(a.noise[0][0][:, :2], a.noise[1][0])
    assert a.ids.tolist() == [3, 0, 0, 0] and float(a.scale) == 2.0
    plain = adversary.make_attack_sampler(4, 9, num_byzantine=1,
                                          attack="sign_flip", device="cpu")
    assert plain(0).noise is None and plain(0) is plain(5)
    with pytest.raises(ValueError, match="unknown attack"):
        adversary.make_attack_sampler(4, 0, num_byzantine=1, attack="nope")
    with pytest.raises(ValueError, match="like"):
        adversary.make_attack_sampler(4, 0, num_byzantine=1,
                                      attack="random_noise", device="cpu")


# ---------------------------------------------------------------------------
# robust aggregation
# ---------------------------------------------------------------------------

def _vals(seed, n=7, m=6, d=9, nonfinite=True):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((n, m, d)).astype(np.float32)
    valid = rng.random((n, m)) < 0.7
    valid[:, 0] = True                                # the self slot
    if nonfinite:
        vals[1, 2, :4] = np.inf
        vals[2, 3, 2] = -np.inf
        vals[3, 1, 5:] = np.nan
    vals[4, 1:3] = 1e4                                # outliers
    return vals, valid


@pytest.mark.parametrize("trim", [1, 2])
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("seed", [0, 1])
def test_robust_reduce_matches_the_reference_and_the_oracle(seed, rule,
                                                            trim):
    vals, valid = _vals(seed)
    want = np.asarray(jax_mixing._robust_reduce(
        jnp.asarray(vals), jnp.asarray(valid), rule, trim))
    got = mixing._robust_reduce(torch.from_numpy(vals),
                                torch.from_numpy(valid), rule, trim).numpy()
    oracle = t_ref.robust_agg_ref(torch.from_numpy(vals),
                                  torch.from_numpy(valid), rule=rule,
                                  trim=trim).numpy()
    jax_oracle = np.asarray(jax_ref.robust_agg_ref(
        jnp.asarray(vals), jnp.asarray(valid), rule=rule, trim=trim))
    assert np.isfinite(got).all()
    assert _rel(got, want) <= TOL_AGG
    assert _rel(got, oracle) <= TOL_AGG
    assert _rel(oracle, jax_oracle) <= TOL_AGG


def _support_w(seed, n=8):
    """A doubly stochastic (n, n) W with some links masked out."""
    rng = np.random.default_rng(seed)
    adj = rng.random((n, n)) < 0.5
    adj = np.triu(adj, 1)
    adj = adj | adj.T
    deg = adj.sum(1)
    w = adj / (1.0 + np.maximum(deg[:, None], deg[None, :]))
    w = w + np.diag(1.0 - w.sum(1))
    return w.astype(np.float32)


@pytest.mark.parametrize("gossip_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("rule", RULES)
def test_robust_mix_dense_and_sparse(rule, gossip_dtype):
    w = _support_w(3)
    rng = np.random.default_rng(4)
    buf = rng.standard_normal((8, 13)).astype(np.float32)
    buf[2, 5] = np.nan                                 # a diverged entry
    buf[6] *= 1e3
    jgd = None if gossip_dtype is None else jnp.bfloat16
    want = np.asarray(jax_mixing.robust_mix_dense(
        jnp.asarray(buf), jnp.asarray(w), rule=rule, trim=1,
        gossip_dtype=jgd))
    got = mixing.robust_mix_dense(torch.from_numpy(buf), torch.from_numpy(w),
                                  rule=rule, trim=1,
                                  gossip_dtype=gossip_dtype).numpy()
    assert _rel(got, want) <= TOL_AGG
    # the neighbor-gather form on the same support, masked links included
    jsp = jax_sparse.from_dense(w)
    sp = sparse_from_reference(*(np.asarray(a) for a in (
        jsp.neighbor_idx, jsp.neighbor_w, jsp.self_w, jsp.degree)),
        device="cpu")
    mask = np.array([1, 1, 0, 1, 1, 0, 1, 1], bool)
    jsp_m = jax_sparse.sparse_masked_w(jsp, jnp.asarray(mask))
    sp_m = sparse_masked_w(sp, torch.from_numpy(mask))
    for j_sp, t_sp in ((jsp, sp), (jsp_m, sp_m)):
        want_s = np.asarray(jax_mixing.robust_mix_sparse(
            jnp.asarray(buf), j_sp, rule=rule, trim=1, gossip_dtype=jgd))
        got_s = mixing.robust_mix_sparse(torch.from_numpy(buf), t_sp,
                                         rule=rule, trim=1,
                                         gossip_dtype=gossip_dtype).numpy()
        assert _rel(got_s, want_s) <= TOL_AGG
    got_s = mixing.robust_mix_sparse(torch.from_numpy(buf), sp, rule=rule,
                                     trim=1, gossip_dtype=gossip_dtype)
    assert _rel(got_s.numpy(), got) <= TOL_AGG     # sparse = dense form
    # against the oracle on the dense form's candidate set
    bg = torch.from_numpy(buf)
    if gossip_dtype is not None:
        bg = bg.to(torch.bfloat16).float()
    valid = torch.from_numpy((w > 0) | np.eye(8, dtype=bool))
    oracle = t_ref.robust_agg_ref(bg[None].expand(8, 8, 13), valid,
                                  rule=rule, trim=1).numpy()
    assert _rel(got, oracle) <= TOL_AGG
    # the tree-level form and both mixers dispatch on W's kind
    tree = {"p": torch.from_numpy(buf[:, :6].copy()),
            "q": torch.from_numpy(buf[:, 6:].copy())}
    for impl, ww in ((rule, torch.from_numpy(w)), ("sparse_" + rule, sp)):
        mixed = mixing.make_mixer("ring", impl, ww, gossip_dtype or
                                  "float32")(tree)
        traced = mixing.make_traced_mixer(impl, gossip_dtype or
                                          "float32")(tree, ww)
        for m in (mixed, traced):
            packed = torch.cat([m["p"], m["q"]], 1).numpy()
            assert _rel(packed, got) <= TOL_AGG


# ---------------------------------------------------------------------------
# one Byzantine round per lowering
# ---------------------------------------------------------------------------

LOWERINGS = ("dense", "fused_dense", "pallas_packed", "sparse_packed",
             "coord_median", "trimmed_mean", "sparse_coord_median",
             "sparse_trimmed_mean")


@functools.lru_cache(maxsize=None)
def _jax_byz_round(algo, impl, attack):
    key, data = tr._reference_data()
    prob = jax_quadratic_problem(data, sigma=0.1)
    cfg = JaxConfig(**tr._cfg_kwargs(algo, K), mixing_impl=impl)
    cb = {n: v for n, v in data.items() if n != "mu"}
    kb = jax.tree.map(lambda v: jnp.broadcast_to(v[None], (K, *v.shape)), cb)
    st = jax_init_state(prob, cfg, key, init_batch=cb,
                        init_keys=jax.random.split(key, N))
    adv = jax_adv.make_attack_sampler(N, jax.random.PRNGKey(17),
                                      num_byzantine=2, attack=attack,
                                      scale=3.0)(0)
    step = jax.jit(jax_make_round_step(prob, cfg, byzantine=True))
    st1 = step(st, kb, tr._round_keys(0, K), adv)
    return tr._state_np(st), tr._state_np(st1), adv


@pytest.mark.parametrize("attack", ["sign_flip", "random_noise"])
@pytest.mark.parametrize("impl", LOWERINGS)
def test_byzantine_round_matches_jax(impl, attack):
    algo = "kgt_minimax"
    init, want, ref_adv = _jax_byz_round(algo, impl, attack)
    _, data = tr._reference_data()
    tdata, st = from_reference({n: np.asarray(v) for n, v in data.items()},
                               init, device="cpu")
    prob = quadratic_problem(tdata, sigma=0.1)
    cfg = AlgorithmConfig(**tr._cfg_kwargs(algo, K), mixing_impl=impl)
    batches = {n: v.unsqueeze(0).expand(K, *v.shape)
               for n, v in tdata.items() if n != "mu"}
    adv = _port_adversary(ref_adv, ((st.x,), (st.y,)))
    step = make_round_step(prob, cfg, byzantine=True, device="cpu")
    got = step(st, batches, tr._round_noise(0, K), adv)
    for name in ("x", "y", "cx", "cy"):
        err = _rel(getattr(got, name).numpy(), want[name])
        assert err <= TOL_ROUND, (name, err)
    if impl in ("dense", "pallas_packed"):
        # the attacked Δ is still a Δ: Σc = 0 under a doubly stochastic W
        for c in (got.cx, got.cy):
            assert float(correction_mean_norm(c)) <= 1e-5 * (
                1.0 + float(c.abs().max()))


def test_honest_adversary_is_the_plain_step_bit_for_bit():
    init, _, _ = _jax_byz_round("kgt_minimax", "trimmed_mean", "sign_flip")
    _, data = tr._reference_data()
    tdata, st = from_reference({n: np.asarray(v) for n, v in data.items()},
                               init, device="cpu")
    prob = quadratic_problem(tdata, sigma=0.1)
    batches = {n: v.unsqueeze(0).expand(K, *v.shape)
               for n, v in tdata.items() if n != "mu"}
    noise = tr._round_noise(0, K)
    for impl in ("dense", "pallas_packed", "trimmed_mean"):
        cfg = AlgorithmConfig(**tr._cfg_kwargs("kgt_minimax", K),
                              mixing_impl=impl)
        plain = make_round_step(prob, cfg, device="cpu")(st, batches, noise)
        honest = adversary.make_attack_sampler(
            N, 0, num_byzantine=0, attack="random_noise",
            like=(st.x, st.y), device="cpu")(0)
        byz = make_round_step(prob, cfg, byzantine=True, device="cpu")(
            st, batches, noise, honest)
        for name in ("x", "y", "cx", "cy"):
            assert torch.equal(getattr(byz, name), getattr(plain, name))


def test_byzantine_refusals_match_the_reference():
    _, data = tr._reference_data()
    tdata, _ = from_reference({n: np.asarray(v) for n, v in data.items()},
                              None, device="cpu")
    tprob = quadratic_problem(tdata, sigma=0.1)
    jprob = jax_quadratic_problem(data, sigma=0.1)
    for cfg_kw, step_kw in (({"mixing_impl": "fused_round"},
                             {"byzantine": True}),
                            ({"mixing_impl": "trimmed_mean",
                              "topology_cycle": ("ring", "full")}, {}),
                            ({"mixing_impl": "coord_median",
                              "gossip_compress": "int8"}, {})):
        kw = dict(tr._cfg_kwargs("kgt_minimax", K), **cfg_kw)
        with pytest.raises(ValueError) as ours:
            make_round_step(tprob, AlgorithmConfig(**kw), device="cpu",
                            **step_kw)
        with pytest.raises(ValueError) as ref:
            jax_make_round_step(jprob, JaxConfig(**kw), **step_kw)
        assert str(ours.value) == str(ref.value)
    step = make_round_step(tprob, AlgorithmConfig(num_clients=N),
                           byzantine=True, device="cpu")
    with pytest.raises(TypeError, match=r"\[adversary\]"):
        step(None, None, None)


# ---------------------------------------------------------------------------
# the sampler slot and the sweep
# ---------------------------------------------------------------------------

def test_with_topology_orders_w_mask_adversary_and_refuses_nesting():
    base = lambda r: ("batch", r)                           # noqa: E731
    wrapped = sampler_lib.with_topology(
        base, attack_fn=lambda r: ("adv", r), w_fn=lambda r: ("w", r),
        mask_fn=lambda r: ("mask", r))
    batches, noise, extras = wrapped(3)
    assert (batches, noise) == ("batch", 3)
    assert extras == (("w", 3), ("mask", 3), ("adv", 3))
    only = sampler_lib.with_topology(base, attack_fn=lambda r: r * 2)
    assert only(5)[2] == (10,)
    with pytest.raises(ValueError, match="attack_fn"):
        sampler_lib.with_topology(base)
    with pytest.raises(ValueError, match="nesting"):
        sampler_lib.with_topology(wrapped, attack_fn=lambda r: r)(0)


def test_adversary_sweep_cell_is_its_points():
    spec = defs.SWEEPS["adversary"]
    spec = dataclasses.replace(spec, base={**spec.base, "max_rounds": 50})
    cells = [c for c in spec.cells()
             if c.static["mixing_impl"] == "trimmed_mean"
             and c.static["num_byzantine"]]
    assert len(cells) == 1 and len(cells[0].points) == 6
    cell = cells[0]
    results, _ = sweep_run.run_cell(cell, device="cpu")
    for p, res in zip(cell.points, results):
        hit, final, _, hist = sweep_run.run_point(p, device="cpu")
        assert res["rounds_to_eps"] == hit
        assert res["final_grad"] == final and res["history"] == hist
        assert np.isfinite(final)
    attacks = {p["attack"] for p in cell.points}
    assert attacks == {"sign_flip", "large_norm", "random_noise"}
    assert sweep_run.cell_comm(cell.points[0]).mixing_impl == "trimmed_mean"


@pytest.mark.parametrize("impl,attack,seed", [
    ("trimmed_mean", "sign_flip", 0), ("coord_median", "large_norm", 1)])
def test_attacked_robust_trajectory_tracks_the_reference(impl, attack, seed):
    """An adversary-sweep point on the reference's own data (its
    ``prepare_trajectory``): 200 attacked rounds of the port's robust
    round step keep ‖∇Φ(x̄)‖ within 1e-4 relative of the reference's, so
    where the port's sweep (its own data) and the committed results part,
    the draws part, not the rounds."""
    from repro.core import quadratic_cell_problem as jax_cell_problem
    from repro.sweep import run as jax_run
    from repro_torch.core import quadratic_cell_problem

    p = jax_run._full_point(dict(
        defs.SWEEPS["adversary"].base, mixing_impl=impl, attack=attack,
        num_byzantine=1, seed=seed))
    traj, consts = jax_run.prepare_trajectory(p, cache=None)
    cfg = jax_run._cfg(p)
    jstep = jax.jit(jax_make_round_step(jax_cell_problem(10, 5, mu=1.0,
                                                         noise=False),
                                        cfg, byzantine=True))
    jadv = jax_adv.Adversary(
        ids=jax_adv.attack_ids(p["n"], 1, jax_adv.ATTACK_IDS[attack]),
        key=jax.random.PRNGKey(0), scale=jnp.float32(p["attack_scale"]))
    k = p["K"]
    keys = jnp.zeros((k, p["n"], 2), jnp.uint32)
    _, st = from_reference(None, {f: np.asarray(getattr(traj.state, f))
                                  for f in ("x", "y", "cx", "cy")},
                           device="cpu")
    batches = {n: torch.as_tensor(np.array(v))
               for n, v in traj.batches.items()}
    prob = quadratic_cell_problem(10, 5, mu=1.0, noise=False, device="cpu")
    step = make_round_step(prob, AlgorithmConfig(**vars(cfg)),
                           byzantine=True, device="cpu")
    adv = adversary.Adversary(
        ids=adversary.attack_ids(p["n"], 1, adversary.ATTACK_IDS[attack],
                                 device="cpu"),
        scale=torch.tensor(p["attack_scale"]))
    noise = torch.zeros((k, p["n"], prob.noise_dim))
    jst = traj.state
    tconsts = {n: torch.as_tensor(np.array(v)) for n, v in consts.items()}
    for r in range(1, 201):
        jst = jstep(jst, traj.batches, keys, jadv)
        st = step(st, batches, noise, adv)
        if r % 100 == 0:
            want = float(jax_run._phi_grad_norm(consts, jst.x, 1.0))
            got = float(sweep_run._phi_grad_norm(tconsts, st.x, 1.0))
            assert got == pytest.approx(want, rel=1e-4), (r, got, want)
