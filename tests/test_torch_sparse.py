"""The port's sparse path against the JAX package.

Constructors, the dense bridge and the participation mask are host or
elementwise code: neighbor ids must match bit for bit and weights within
1e-7 (the JAX package's own constructor tolerance,
tests/test_sparse_gossip.py:56).  The neighbor-gather epilogue's plain
version — what the CUDA kernel is held against on the card — is compared
with the JAX kernel run in interpret mode and with its jnp oracle at
1e-6·(1 + max|ref|): the JAX package's 1e-6 (tests/test_sparse_gossip.py:
236), scaled with the magnitude of the values, because at |θ'| ~ 9 one f32
ulp is ~1e-6 and the reference's own kernel misses a bare 1e-6 there
(test_sparse_kernel_matches_xla[torus-9]).  Round steps on
``mixing_impl="sparse_packed"`` are compared at 2e-5, the reference's own
sparse-vs-dense round tolerance (tests/test_sparse_gossip.py:316,328).

The port's W samplers draw from a ``torch.Generator``, which cannot
reproduce JAX's draws; they are held to the invariants (symmetric, doubly
stochastic, on the support, a pure function of the round), and the round
step is fed the reference's own per-round draws through
``make_replay_sampler``.
"""
import _torch_threads  # noqa: F401
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AlgorithmConfig as JaxConfig
from repro.core import init_state as jax_init_state
from repro.core import make_quadratic_data as jax_make_data
from repro.core import make_round_step as jax_make_round_step
from repro.core import quadratic_problem as jax_quadratic_problem
from repro.core import mixing as jmixing
from repro.core import sparse_topology as jsparse
from repro.core import stochastic_topology as jstoch
from repro.kernels import ops as jops
from repro_torch import engine as t_engine
from repro_torch.configs import AlgorithmConfig
from repro_torch.core import (
    correction_mean_norm,
    from_reference,
    init_state,
    make_quadratic_data,
    make_replay_sampler,
    make_round_step,
    quadratic_problem,
)
from repro_torch.core import mixing as tmixing
from repro_torch.core import sparse_topology as tsparse
from repro_torch.kernels import ops as tops

ATOL_KERNEL = 1e-6     # × (1 + max|ref|)
ATOL_ROUND = 2e-5
ALGOS = ("kgt_minimax", "gt_gda", "dsgda", "local_sgda")


def _jax_hier(n):
    return jsparse.sparse_hierarchical(n, 4 if n % 4 == 0 else 3)


def _port_hier(n):
    return tsparse.sparse_hierarchical(n, 4 if n % 4 == 0 else 3)


def _jax_topology(name, n):
    return (_jax_hier(n) if name == "hierarchical"
            else jsparse.sparse_mixing_matrix(name, n))


def _port_topology(name, n):
    return (_port_hier(n) if name == "hierarchical"
            else tsparse.sparse_mixing_matrix(name, n))


def _arrays(sp):
    """A SparseTopology of either side -> its four numpy arrays."""
    return tuple(np.asarray(t) for t in (sp.neighbor_idx, sp.neighbor_w,
                                         sp.self_w, sp.degree))


CONSTRUCTOR_CASES = [(name, n) for n in (8, 9, 16, 64)
                     for name in ("ring", "torus", "exp", "full", "star",
                                  "hierarchical")
                     if name != "torus" or int(np.sqrt(n)) ** 2 == n]


@pytest.mark.parametrize("name,n", CONSTRUCTOR_CASES)
def test_constructors_match_jax(name, n):
    t_idx, t_w, t_sw, t_deg = _arrays(_port_topology(name, n))
    j_idx, j_w, j_sw, j_deg = _arrays(_jax_topology(name, n))
    assert t_idx.dtype == np.int32 and t_w.dtype == np.float32
    np.testing.assert_array_equal(t_idx, j_idx)
    np.testing.assert_array_equal(t_deg, j_deg)
    np.testing.assert_allclose(t_w, j_w, rtol=0, atol=1e-7)
    np.testing.assert_allclose(t_sw, j_sw, rtol=0, atol=1e-7)


def test_constructors_match_dense_topologies():
    from repro_torch.core.topology import mixing_matrix

    for name in ("ring", "torus", "exp", "full", "star"):
        w = tsparse.densify(tsparse.sparse_mixing_matrix(name, 16)).numpy()
        np.testing.assert_allclose(w, mixing_matrix(name, 16), rtol=0,
                                   atol=1e-7, err_msg=name)


@pytest.mark.parametrize("name", ["exp", "hierarchical", "star"])
def test_from_dense_densify_round_trip(name):
    sp = _port_topology(name, 16)
    w = tsparse.densify(sp)
    # bit for bit both ways, and the same lists as the JAX bridge
    np.testing.assert_array_equal(
        tsparse.densify(tsparse.from_dense(w)).numpy(), w.numpy())
    for a, b in zip(_arrays(tsparse.from_dense(w)), _arrays(sp)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_arrays(tsparse.from_dense(w.numpy())),
                    _arrays(jsparse.from_dense(w.numpy()))):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(jsparse.densify(_jax_topology(name, 16))))


def test_from_dense_random_doubly_stochastic():
    rng = np.random.default_rng(3)
    a = rng.random((12, 12)) * (rng.random((12, 12)) < 0.4)
    a = np.triu(a, 1)
    a = a + a.T
    w = (a / (1.0 + a.sum(1).max())).astype(np.float32)
    np.fill_diagonal(w, 1.0 - w.sum(1))
    np.testing.assert_array_equal(
        tsparse.densify(tsparse.from_dense(w)).numpy(), w)


@pytest.mark.parametrize("name", ["exp", "torus"])
def test_sparse_masked_w_matches_jax(name):
    rng = np.random.default_rng(1)
    mask = rng.random(16) < 0.6
    got = tsparse.sparse_masked_w(_port_topology(name, 16),
                                  torch.as_tensor(mask))
    want = jsparse.sparse_masked_w(_jax_topology(name, 16), jnp.asarray(mask))
    for a, b in zip(_arrays(got), _arrays(want)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)
    # inactive rows collapse to e_i exactly
    np.testing.assert_array_equal(_arrays(got)[2][~mask], 1.0)


def test_sparse_mix_matches_densified_matmul():
    sp = _port_topology("exp", 16)
    buf = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (16, 7)).astype(np.float32))
    torch.testing.assert_close(tsparse.sparse_mix(sp, buf),
                               tsparse.densify(sp) @ buf, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the tree-level mixers (the reference's public mixing API)
# ---------------------------------------------------------------------------

def _mix_trees(n, seed):
    rng = np.random.default_rng(seed)
    tree = {"a": rng.standard_normal((n, 3, 4)).astype(np.float32),
            "b": (3.0 * rng.standard_normal((n, 5))).astype(np.float32)}
    return ({k: torch.as_tensor(v) for k, v in tree.items()},
            {k: jnp.asarray(v) for k, v in tree.items()})


def _assert_trees_close(got, want):
    for k in want:
        w_ = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w_, rtol=0,
                                   atol=ATOL_KERNEL * (1.0 + np.abs(w_).max()),
                                   err_msg=k)


@pytest.mark.parametrize("w_form", ["sparse", "dense"])
@pytest.mark.parametrize("gossip_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["exp", "hierarchical"])
def test_make_mixer_sparse_packed_matches_jax(name, gossip_dtype, w_form):
    """make_mixer's sparse_packed branch (mix_sparse) on a SparseTopology,
    or on a dense W that it bridges with from_dense."""
    t_sp, j_sp = _port_topology(name, 16), _jax_topology(name, 16)
    t_w, j_w = ((t_sp, j_sp) if w_form == "sparse"
                else (tsparse.densify(t_sp), np.asarray(jsparse.densify(j_sp))))
    t_tree, j_tree = _mix_trees(16, 4)
    got = tmixing.make_mixer(name, "sparse_packed", t_w, gossip_dtype)(t_tree)
    want = jmixing.make_mixer(name, "sparse_packed", j_w,
                              gossip_dtype)(j_tree)
    _assert_trees_close(got, want)
    _assert_trees_close(tmixing.mix_sparse(t_tree, t_sp, gossip_dtype), want)


@pytest.mark.parametrize("impl", ["dense", "fused_dense", "pallas_packed",
                                  "sparse_packed"])
def test_make_traced_mixer_matches_jax(impl):
    """mix(tree, w) on a participation-masked W: a SparseTopology for
    sparse_packed, the (n, n) matrix otherwise."""
    mask = np.random.default_rng(6).random(16) < 0.6
    t_sp = tsparse.sparse_masked_w(_port_topology("exp", 16),
                                   torch.as_tensor(mask))
    j_sp = jsparse.sparse_masked_w(_jax_topology("exp", 16),
                                   jnp.asarray(mask))
    t_w, j_w = ((t_sp, j_sp) if impl == "sparse_packed"
                else (tsparse.densify(t_sp), jsparse.densify(j_sp)))
    t_tree, j_tree = _mix_trees(16, 7)
    _assert_trees_close(tmixing.make_traced_mixer(impl)(t_tree, t_w),
                        jmixing.make_traced_mixer(impl)(j_tree, j_w))


@pytest.mark.parametrize("impl,match", [("ring", "neighbor-only"),
                                        ("fused_ring", "neighbor-only"),
                                        ("fused_round", "no standalone mixer")])
def test_make_traced_mixer_refusals_match_jax(impl, match):
    for mixing_lib in (tmixing, jmixing):
        with pytest.raises(ValueError, match=match):
            mixing_lib.make_traced_mixer(impl)


def test_rejections():
    with pytest.raises(ValueError, match="square"):
        tsparse.sparse_torus(8)
    with pytest.raises(KeyError, match="unknown topology"):
        tsparse.sparse_mixing_matrix("nope", 8)
    with pytest.raises(ValueError, match="limit 512"):
        tsparse.sparse_full(513)
    with pytest.raises(ValueError, match="cluster_size"):
        tsparse.sparse_hierarchical(10, 4)
    with pytest.raises(ValueError, match="unknown topology family"):
        tsparse.make_sparse_w_sampler("nope", tsparse.sparse_ring(8), 0,
                                      device="cpu")
    asym = tsparse.SparseTopology(
        neighbor_idx=torch.tensor([[1], [1], [2]], dtype=torch.int32),
        neighbor_w=torch.tensor([[0.5], [0.0], [0.0]]),
        self_w=torch.tensor([0.5, 1.0, 1.0]),
        degree=torch.tensor([1, 0, 0], dtype=torch.int32))
    with pytest.raises(ValueError, match="not symmetric"):
        tsparse.make_sparse_w_sampler("erdos_renyi", asym, 0, device="cpu")


# ---------------------------------------------------------------------------
# the neighbor-gather epilogue: plain version against the JAX kernel
# ---------------------------------------------------------------------------

def _operands(n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            (3.0 * rng.standard_normal((n, d))).astype(np.float32),
            (0.5 * rng.standard_normal((n, d))).astype(np.float32))


def _masked_exp(n):
    mask = np.random.default_rng(n).random(n) < 0.6
    return jsparse.sparse_masked_w(jsparse.sparse_exp(n), jnp.asarray(mask))


def _erdos_renyi_exp(n):
    fn = jsparse.make_sparse_w_sampler("erdos_renyi", jsparse.sparse_exp(n),
                                       jax.random.PRNGKey(5))
    return fn(jnp.int32(3))


GOSSIP_CASES = {
    "ring-8": (lambda: jsparse.sparse_ring(8), 130),
    # the JAX package's own kernel misses a bare 1e-6 on this case
    "torus-9": (lambda: jsparse.sparse_torus(9), 384 + 9),
    "exp-16-d1": (lambda: jsparse.sparse_exp(16), 1),
    "hierarchical-16": (lambda: _jax_hier(16), 300),
    "exp-64": (lambda: jsparse.sparse_exp(64), 129),
    "masked-exp-16": (lambda: _masked_exp(16), 200),
    "erdos_renyi-exp-16": (lambda: _erdos_renyi_exp(16), 200),
}


@pytest.mark.parametrize("gossip_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("case", sorted(GOSSIP_CASES))
def test_sparse_gossip_plain_matches_jax(case, gossip_dtype):
    make, d = GOSSIP_CASES[case]
    sp = make()
    idx, nw, sw, _ = _arrays(sp)
    n = idx.shape[0]
    delta, theta, c = _operands(n, d, seed=n + d)
    eta_s, corr = 0.7, 4.2
    got = tops.sparse_gossip_round(
        *(torch.as_tensor(np.array(a)) for a in (idx, nw, sw, delta, theta, c)),
        eta_s, corr, backend="auto", gossip_dtype=gossip_dtype)
    for backend in ("interpret", "xla"):
        want = jops.sparse_gossip_round(
            sp.neighbor_idx, sp.neighbor_w, sp.self_w, jnp.asarray(delta),
            jnp.asarray(theta), jnp.asarray(c), eta_s, corr,
            backend=backend, gossip_dtype=gossip_dtype)
        for g, w_, name in zip(got, want, ("theta", "c")):
            w_ = np.asarray(w_)
            tol = ATOL_KERNEL * (1.0 + np.abs(w_).max())
            np.testing.assert_allclose(g.numpy(), w_, rtol=0, atol=tol,
                                       err_msg=f"{backend}/{name}")


def test_sparse_gossip_backends():
    sp = tsparse.sparse_ring(4)
    args = (sp.neighbor_idx, sp.neighbor_w, sp.self_w,
            *(torch.zeros((4, 3)) for _ in range(3)), 0.5, 1.0)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.sparse_gossip_round(*args, backend="kernel")
    with pytest.raises(ValueError, match="unknown gossip_backend"):
        tops.sparse_gossip_round(*args, backend="pallas")
    theta, c = tops.sparse_gossip_round(*args, backend="torch")
    assert theta.shape == c.shape == (4, 3)
    # the kernel's wrapper refuses host tensors before it builds anything
    from repro_torch.kernels import neighbor_gossip

    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        neighbor_gossip.sparse_gossip_nd(*args)


# ---------------------------------------------------------------------------
# port samplers: invariants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family",
                         ["static", "erdos_renyi", "pairwise", "dropout"])
def test_port_sparse_sampler_invariants(family):
    support = tsparse.sparse_exp(32)
    sup_dense = tsparse.densify(support).numpy()
    fn = tsparse.make_sparse_w_sampler(family, support, seed=11,
                                       edge_prob=0.4, client_drop_prob=0.3,
                                       device="cpu")
    draws = []
    for r in range(4):
        sp = fn(r)
        torch.testing.assert_close(sp.neighbor_idx, support.neighbor_idx,
                                   rtol=0, atol=0)
        w = tsparse.densify(sp).numpy()
        np.testing.assert_allclose(w, w.T, rtol=0, atol=1e-7)
        np.testing.assert_allclose(w.sum(1), 1.0, rtol=0, atol=1e-6)
        assert (w >= 0).all()
        off = ~np.eye(32, dtype=bool)
        assert not ((w != 0) & off & (sup_dense == 0)).any()
        # a pure function of the round
        np.testing.assert_array_equal(tsparse.densify(fn(r)).numpy(), w)
        draws.append(w)
    if family != "static":
        assert any(not np.array_equal(draws[0], d) for d in draws[1:])
    else:
        np.testing.assert_array_equal(draws[0], sup_dense)
    if family == "pairwise":
        # exactly one pair averages
        assert (np.diag(draws[0]) == 0.5).sum() == 2


# ---------------------------------------------------------------------------
# the sparse_packed round step against the JAX package
# ---------------------------------------------------------------------------

N, DX, DY, K = 8, 10, 5, 4
ROUNDS = 4
# one churn family per algorithm keeps the JAX compiles few
FAMILY_OF = {"kgt_minimax": "erdos_renyi", "gt_gda": "pairwise",
             "dsgda": "dropout", "local_sgda": "erdos_renyi"}


def _cfg_kwargs(algo):
    return dict(algorithm=algo, num_clients=N, local_steps=K, eta_cx=0.01,
                eta_cy=0.1, eta_sx=0.5, eta_sy=0.5, topology="exp",
                mixing_impl="sparse_packed")


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


def _noise(t):
    keys = _round_keys(t).reshape(-1, 2)
    return torch.as_tensor(np.array(_noise_rows(keys)).reshape(K, N, -1))


def _state_np(st):
    return {name: np.asarray(getattr(st, name))
            for name in ("x", "y", "cx", "cy")} | {"round": int(st.round)}


@functools.lru_cache(maxsize=None)
def _jax_run(algo, churn):
    """JAX sparse_packed rounds: (initial state, final state, per-round W
    arrays, per-round masks) as numpy; W and masks only under churn."""
    key, data = _reference_data()
    prob = jax_quadratic_problem(data, sigma=0.1)
    cfg = JaxConfig(**_cfg_kwargs(algo), gossip_backend="xla")
    cb = {n: v for n, v in data.items() if n != "mu"}
    kb = jax.tree.map(lambda v: jnp.broadcast_to(v[None], (K, *v.shape)), cb)
    st = jax_init_state(prob, cfg, key, init_batch=cb,
                        init_keys=jax.random.split(key, N))
    init = _state_np(st)
    ws, masks = [], []
    if churn:
        tkey = jax.random.PRNGKey(7)
        w_fn = jsparse.make_sparse_w_sampler(
            FAMILY_OF[algo], jsparse.sparse_exp(N), tkey, edge_prob=0.5)
        m_fn = jstoch.make_participation_sampler(N, tkey, 0.7)
        step = jax.jit(jax_make_round_step(prob, cfg, traced_w=True,
                                           participation=True))
        for t in range(ROUNDS):
            w, m = w_fn(jnp.int32(t)), m_fn(jnp.int32(t))
            ws.append(_arrays(w))
            masks.append(np.asarray(m))
            st = step(st, kb, _round_keys(t), w, m)
    else:
        step = jax.jit(jax_make_round_step(prob, cfg))
        for t in range(ROUNDS):
            st = step(st, kb, _round_keys(t))
    return init, _state_np(st), ws, masks


@pytest.mark.parametrize("churn", [False, True], ids=["static", "replayed"])
@pytest.mark.parametrize("algo", ALGOS)
def test_sparse_round_step_matches_jax(algo, churn):
    _, data = _reference_data()
    init, ref, ws, masks = _jax_run(algo, churn)
    tdata, st = from_reference({n: np.asarray(v) for n, v in data.items()},
                               init, device="cpu")
    prob = quadratic_problem(tdata, sigma=0.1)
    cfg = AlgorithmConfig(**_cfg_kwargs(algo))
    batches = {n: v.unsqueeze(0).expand(K, *v.shape)
               for n, v in tdata.items() if n != "mu"}
    sampler = lambda r: (batches, _noise(r))  # noqa: E731
    if churn:
        sampler = make_replay_sampler(sampler, ws=ws, masks=masks,
                                      device="cpu")
    step = make_round_step(prob, cfg, traced_w=churn, participation=churn,
                           device="cpu")
    for t in range(ROUNDS):
        batches_t, noise, extras = t_engine.split_sampled(sampler(t))
        st = step(st, batches_t, noise, *extras)
    assert st.round == ref["round"] == ROUNDS
    for name in ("x", "y", "cx", "cy"):
        np.testing.assert_allclose(getattr(st, name).numpy(), ref[name],
                                   rtol=0, atol=ATOL_ROUND, err_msg=name)
    if churn:
        assert any(not m.all() for m in masks)


def test_sparse_round_step_matches_dense_lowering():
    """sparse_packed and dense on the same (densified) W, the port alone."""
    gen = torch.Generator().manual_seed(0)
    data = make_quadratic_data(gen, 16, dx=5, dy=3)
    prob = quadratic_problem(data, sigma=0.1)
    cb = {n: v for n, v in data.items() if n != "mu"}
    batches = {n: v.unsqueeze(0).expand(2, *v.shape) for n, v in cb.items()}
    finals = {}
    for impl in ("dense", "sparse_packed"):
        cfg = AlgorithmConfig(algorithm="kgt_minimax", num_clients=16,
                              local_steps=2, eta_cx=0.01, eta_cy=0.1,
                              eta_sx=0.5, topology="exp", mixing_impl=impl)
        st = init_state(prob, cfg, torch.Generator().manual_seed(1),
                        init_batch=cb)
        step = make_round_step(prob, cfg, device="cpu")
        for t in range(3):
            noise = torch.Generator().manual_seed(t)
            st = step(st, batches, torch.randn((2, 16, prob.noise_dim),
                                               generator=noise))
        finals[impl] = st
    for name in ("x", "y", "cx", "cy"):
        torch.testing.assert_close(getattr(finals["sparse_packed"], name),
                                   getattr(finals["dense"], name), rtol=0,
                                   atol=ATOL_ROUND)


# ---------------------------------------------------------------------------
# invariants at scale: Σc = 0 and the bit-exact freeze, n = 1024
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family",
                         ["static", "erdos_renyi", "pairwise", "dropout"])
def test_churn_invariants_at_1024_clients(family):
    from repro_torch.core import make_participation_sampler
    from repro_torch.core.kgt_minimax import KGTState

    n, k = 1024, 2
    gen = torch.Generator().manual_seed(0)
    data = make_quadratic_data(gen, n, dx=4, dy=2)
    prob = quadratic_problem(data, sigma=0.1)
    cb = {name: v for name, v in data.items() if name != "mu"}
    batches = {name: v.unsqueeze(0).expand(k, *v.shape)
               for name, v in cb.items()}
    cfg = AlgorithmConfig(algorithm="kgt_minimax", num_clients=n,
                          local_steps=k, eta_cx=0.01, eta_cy=0.1,
                          eta_sx=0.5, eta_sy=0.5, topology="exp",
                          mixing_impl="sparse_packed")
    st = init_state(prob, cfg, gen, init_batch=cb)
    w_fn = tsparse.make_sparse_w_sampler(
        family, tsparse.sparse_exp(n), seed=3, device="cpu")
    mask_fn = make_participation_sampler(n, 3, 0.7, device="cpu")
    sampler = t_engine.with_topology(
        t_engine.make_fixed_batch_sampler(
            batches, local_steps=k, num_clients=n,
            noise_dim=prob.noise_dim, device="cpu"),
        w_fn=w_fn, mask_fn=mask_fn)
    prev = {}
    frozen = []

    def hook(state, records, prev_round):
        mask = mask_fn(prev_round)
        old = prev["state"]
        for name in ("x", "y", "cx", "cy"):
            a, b = getattr(state, name), getattr(old, name)
            frozen.append(torch.equal(a[~mask], b[~mask]))
        prev["state"] = KGTState(state.x, state.y, state.cx, state.cy,
                                 state.round)

    prev["state"] = st
    build = t_engine.make_chunk_builder(
        make_round_step(prob, cfg, traced_w=True, participation=True,
                        device="cpu"), sampler)
    st, _ = t_engine.run(st, build, total_rounds=3, chunk_rounds=1,
                         hooks=[hook])
    assert st.round == 3 and len(frozen) == 12 and all(frozen)
    for c in (st.cx, st.cy):
        scale = 1.0 + float(c.abs().max())
        assert float(correction_mean_norm(c)) < 1e-6 * scale
