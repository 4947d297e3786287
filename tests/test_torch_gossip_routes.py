"""The two routes of the gossip epilogues B1 and B4, and their pair calls.

B1 (``csrc/gossip.cu``) has an unrolled kernel for n ≤ 8 and the first
port's tiled kernel past it; B4 (``csrc/neighbor_gossip.cu``) a kernel that
holds a column stripe of all n rows in shared memory and the first port's
row-block kernel where that stripe does not fit.  Which one a call takes is
a pure function of the shapes (``gossip.route``, ``neighbor_gossip.route``
and its stripe-width helper), held here on the CPU, where no kernel runs:
the main path's n = 8 and the scale path's n = 4096 (exponential graph,
m = 23, and its churn draws) must take the new routes.

``ops.fused_gossip_pair`` and ``ops.sparse_gossip_pair`` run both variables
of a round in one launch on the card; on the CPU they are the plain
version twice, so they must equal two single calls bit for bit, and match
the JAX package's ``fused_gossip_round`` / ``sparse_gossip_round`` in
interpret mode at 1e-6·(1 + max|ref|), the port's sparse-epilogue
tolerance (tests/test_torch_sparse.py).  A round through ``_packed_round``
(``pallas_packed``, ``sparse_packed``) is held against the JAX round at the
round tests' 1e-5 (x, y) and 4e-5 (corrections).
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
from repro.core import sparse_topology as jsparse
from repro.kernels import ops as jops
from repro_torch.configs import AlgorithmConfig
from repro_torch.core import from_reference, make_round_step
from repro_torch.core import quadratic_problem
from repro_torch.core import sparse_topology as tsparse
from repro_torch.core import stochastic_topology as tstoch
from repro_torch.kernels import _build
from repro_torch.kernels import gossip as t_gossip
from repro_torch.kernels import neighbor_gossip as t_ng
from repro_torch.kernels import ops as t_ops

ATOL_KERNEL = 1e-6     # × (1 + max|ref|)
ATOL, ATOL_C = 1e-5, 4e-5
GOSSIP_DTYPES = [None, "bfloat16"]


# ---------------------------------------------------------------------------
# B1: the dense epilogue's route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_the_main_paths_n_takes_the_unrolled_route(n):
    """n = 8 is the main path's (bench_gossip.py's ring of 8 clients)."""
    assert t_gossip.route(n) == "unrolled"


@pytest.mark.parametrize("n", [9, 64, 512, 4096])
def test_client_counts_past_eight_take_the_tiled_route(n):
    """n = 512 is the churn path's, at the dense samplers' limit."""
    assert t_gossip.route(n) == "tiled"


def test_the_tiled_route_can_always_be_forced():
    for n in (1, 8, 9, 512):
        chosen = t_gossip.route(n)
        assert _build.forced_route(chosen, None, universal="tiled") == chosen
        assert _build.forced_route(chosen, "tiled", universal="tiled") == (
            "tiled")
    with pytest.raises(ValueError, match="cannot take"):
        _build.forced_route(t_gossip.route(9), "unrolled", universal="tiled")


# ---------------------------------------------------------------------------
# B4: the neighbor-gather epilogue's route and stripe width
# ---------------------------------------------------------------------------

def test_the_scale_shape_takes_the_stripe_route():
    """n = 4096 on the exponential graph (bench_scale.py's largest n): 23
    neighbors a row; the f32 stripe and table buffers take 227,328 bytes."""
    sp = tsparse.sparse_exp(4096)
    assert sp.max_degree == 23
    for bf16 in (False, True):
        assert t_ng.route(4096, sp.max_degree, bf16) == "stripe"
        assert t_ng.stripe_width(4096, sp.max_degree, bf16) == (
            t_ng.STRIPE_WIDTH)
    assert t_ng.stripe_smem_bytes(4096, 23, False) == 227328
    assert t_ng.stripe_smem_bytes(4096, 23, True) == 161792


@pytest.mark.parametrize("family", tstoch.TOPOLOGY_FAMILIES)
def test_the_churn_draws_at_scale_take_the_stripe_route(family):
    """Each churn family redraws W on the exp support, keeping its padded
    width m = 23, so every scale-path launch takes the stripe route."""
    support = tsparse.sparse_exp(4096)
    w_fn = tsparse.make_sparse_w_sampler(family, support, seed=3,
                                         edge_prob=0.5, device="cpu")
    m = w_fn(1).neighbor_idx.shape[1]
    assert m == support.max_degree
    assert t_ng.route(4096, m, False) == "stripe"


@pytest.mark.parametrize("n,m,bf16,want", [
    (4256, 23, False, "stripe"), (4257, 23, False, "row_block"),
    (8512, 23, True, "stripe"), (8513, 23, True, "row_block"),
    (8192, 25, False, "row_block"), (8192, 25, True, "row_block"),
    (8192, 23, True, "stripe"),
    (512, 17, False, "stripe"), (1, 1, False, "stripe"),
    (64, 600, False, "row_block"),    # the table buffers alone overflow
])
def test_the_stripe_route_takes_what_fits_shared_memory(n, m, bf16, want):
    fits = t_ng.stripe_smem_bytes(n, m, bf16) <= t_ng.MAX_SMEM
    assert t_ng.route(n, m, bf16) == want
    assert (want == "stripe") == fits
    assert t_ng.stripe_width(n, m, bf16) == (t_ng.STRIPE_WIDTH if fits
                                             else 0)


@pytest.mark.parametrize("n,m,bf16", [(4096, 23, False), (9, 4, True),
                                      (1, 1, False), (1026, 19, False)])
def test_the_stripe_smem_is_16_byte_pieces(n, m, bf16):
    """The stripe and each table buffer start on 16-byte boundaries (the
    kernel copies them 16 bytes at a time), and the stripe holds all n
    rows."""
    stripe = (t_ng.stripe_smem_bytes(n, m, bf16)
              - 2 * t_ng.CHUNK_ROWS * (2 * m + 1) * 4) // 2
    assert stripe % 16 == 0 and t_ng.CHUNK_ROWS * m * 4 % 16 == 0
    assert n * t_ng.STRIPE_WIDTH * (2 if bf16 else 4) <= stripe
    assert stripe < n * t_ng.STRIPE_WIDTH * (2 if bf16 else 4) + 16


def test_the_row_block_route_can_always_be_forced():
    for n, m in ((4096, 23), (8192, 25), (9, 4)):
        chosen = t_ng.route(n, m, False)
        assert _build.forced_route(chosen, "row_block",
                                   universal="row_block") == "row_block"
    with pytest.raises(ValueError, match="cannot take"):
        _build.forced_route(t_ng.route(8192, 25, False), "stripe",
                            universal="row_block")


def test_the_wrappers_refuse_host_tensors_before_building():
    z = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        t_gossip.fused_gossip_pair_nd(torch.eye(4), (z, z, z, 0.5, 1.0),
                                      (z, z, z, 0.5, 1.0))
    sp = tsparse.sparse_ring(4)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        t_ng.sparse_gossip_pair_nd(sp.neighbor_idx, sp.neighbor_w, sp.self_w,
                                   (z, z, z, 0.5, 1.0), (z, z, z, 0.5, 1.0))


# ---------------------------------------------------------------------------
# the pair calls on the CPU
# ---------------------------------------------------------------------------

def _var(n, d, seed, eta_s, corr):
    rng = np.random.default_rng(seed)
    delta, theta, c = (rng.standard_normal((n, d)).astype(np.float32) * s
                       for s in (1.0, 3.0, 0.5))
    return delta, theta, c, eta_s, corr


def _torch_var(v):
    return (*(torch.as_tensor(a) for a in v[:3]), *v[3:])


def _dense_w(n, seed):
    rng = np.random.default_rng(seed)
    w = rng.random((n, n)).astype(np.float32)
    return w / w.sum(1, keepdims=True)


@pytest.mark.parametrize("gossip_dtype", GOSSIP_DTYPES)
@pytest.mark.parametrize("n,dx,dy", [(8, 384, 128), (5, 33, 7), (12, 20, 9)])
def test_fused_gossip_pair_is_two_single_calls_and_matches_jax(
        n, dx, dy, gossip_dtype):
    w = _dense_w(n, n)
    x, y = _var(n, dx, 1, 0.5, 12.5), _var(n, dy, 2, 1.0, -3.0)
    tw = torch.as_tensor(w)
    got = t_ops.fused_gossip_pair(tw, _torch_var(x), _torch_var(y),
                                  gossip_dtype=gossip_dtype)
    singles = (*t_ops.fused_gossip_round(tw, *_torch_var(x),
                                         gossip_dtype=gossip_dtype),
               *t_ops.fused_gossip_round(tw, *_torch_var(y),
                                         gossip_dtype=gossip_dtype))
    assert len(got) == 4
    for g, s in zip(got, singles):
        assert g.dtype == torch.float32
        assert torch.equal(g, s)
    for v, outs in ((x, got[:2]), (y, got[2:])):
        want = jops.fused_gossip_round(
            jnp.asarray(w), *(jnp.asarray(a) for a in v[:3]), *v[3:],
            backend="interpret", gossip_dtype=gossip_dtype)
        for g, w_ in zip(outs, want):
            w_ = np.asarray(w_)
            np.testing.assert_allclose(
                g.numpy(), w_, rtol=0,
                atol=ATOL_KERNEL * (1.0 + np.abs(w_).max()))


SPARSE_CASES = {
    "exp-64": (lambda: jsparse.sparse_exp(64), 384 + 1, 128 - 3),
    "ring-8": (lambda: jsparse.sparse_ring(8), 130, 1),
    "torus-9": (lambda: jsparse.sparse_torus(9), 40, 12),
}


@pytest.mark.parametrize("gossip_dtype", GOSSIP_DTYPES)
@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
def test_sparse_gossip_pair_is_two_single_calls_and_matches_jax(
        case, gossip_dtype):
    make, dx, dy = SPARSE_CASES[case]
    sp = make()
    tab = tuple(np.array(a) for a in (sp.neighbor_idx, sp.neighbor_w,
                                      sp.self_w))
    n = tab[0].shape[0]
    x, y = _var(n, dx, 3, 0.5, 12.5), _var(n, dy, 4, 1.0, -3.0)
    ttab = tuple(torch.as_tensor(a) for a in tab)
    got = t_ops.sparse_gossip_pair(*ttab, _torch_var(x), _torch_var(y),
                                   gossip_dtype=gossip_dtype)
    singles = (*t_ops.sparse_gossip_round(*ttab, *_torch_var(x),
                                          gossip_dtype=gossip_dtype),
               *t_ops.sparse_gossip_round(*ttab, *_torch_var(y),
                                          gossip_dtype=gossip_dtype))
    assert len(got) == 4
    for g, s in zip(got, singles):
        assert torch.equal(g, s)
    for v, outs in ((x, got[:2]), (y, got[2:])):
        want = jops.sparse_gossip_round(
            sp.neighbor_idx, sp.neighbor_w, sp.self_w,
            *(jnp.asarray(a) for a in v[:3]), *v[3:], backend="interpret",
            gossip_dtype=gossip_dtype)
        for g, w_ in zip(outs, want):
            w_ = np.asarray(w_)
            np.testing.assert_allclose(
                g.numpy(), w_, rtol=0,
                atol=ATOL_KERNEL * (1.0 + np.abs(w_).max()))


def test_cpu_pair_dispatch_counts_no_launch():
    t_ops.zero_launch_counts()
    z = torch.zeros((4, 3))
    v = (z, z, z, 0.5, 1.0)
    t_ops.fused_gossip_pair(torch.eye(4), v, v)
    sp = tsparse.sparse_ring(4)
    t_ops.sparse_gossip_pair(sp.neighbor_idx, sp.neighbor_w, sp.self_w, v, v)
    assert set(t_ops.launch_counts().values()) == {0}
    assert all(c == 0 for by in t_ops.route_counts().values()
               for c in by.values())
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        t_ops.fused_gossip_pair(torch.eye(4), v, v, backend="kernel")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        t_ops.sparse_gossip_pair(sp.neighbor_idx, sp.neighbor_w, sp.self_w,
                                 v, v, backend="kernel")


# ---------------------------------------------------------------------------
# a round through _packed_round against the JAX round
# ---------------------------------------------------------------------------

N, DX, DY, K, ROUNDS = 8, 10, 5, 3, 3


def _cfg_kwargs(algo, impl):
    return dict(algorithm=algo, num_clients=N, local_steps=K, eta_cx=0.01,
                eta_cy=0.1, eta_sx=0.5, eta_sy=0.5,
                topology="exp" if impl == "sparse_packed" else "ring",
                mixing_impl=impl)


@functools.lru_cache(maxsize=None)
def _reference_data():
    key = jax.random.PRNGKey(0)
    return key, jax_make_data(key, N, dx=DX, dy=DY, heterogeneity=2.0)


def _round_keys(t):
    return jax.random.split(jax.random.PRNGKey(t), K * N).reshape(K, N, 2)


def _round_noise(t):
    def row(k):
        kx, ky = jax.random.split(k)
        return jnp.concatenate([jax.random.normal(kx, (DX,)),
                                jax.random.normal(ky, (DY,))])

    keys = _round_keys(t).reshape(-1, 2)
    return torch.as_tensor(np.array(jax.vmap(row)(keys)).reshape(K, N, -1))


def _state_np(st):
    return {name: np.asarray(getattr(st, name))
            for name in ("x", "y", "cx", "cy")}


@pytest.mark.parametrize("impl", ["pallas_packed", "sparse_packed"])
@pytest.mark.parametrize("algo", ["kgt_minimax", "gt_gda"])
def test_packed_round_through_the_pair_matches_jax(algo, impl):
    key, data = _reference_data()
    prob = jax_quadratic_problem(data, sigma=0.1)
    cfg = JaxConfig(**_cfg_kwargs(algo, impl), gossip_backend="xla")
    cb = {name: v for name, v in data.items() if name != "mu"}
    kb = jax.tree.map(lambda v: jnp.broadcast_to(v[None], (K, *v.shape)), cb)
    st = jax_init_state(prob, cfg, key, init_batch=cb,
                        init_keys=jax.random.split(key, N))
    init = _state_np(st) | {"round": int(st.round)}
    step = jax.jit(jax_make_round_step(prob, cfg))
    for t in range(ROUNDS):
        st = step(st, kb, _round_keys(t))
    ref = _state_np(st)

    tdata, tst = from_reference({n: np.asarray(v) for n, v in data.items()},
                                init, device="cpu")
    tprob = quadratic_problem(tdata, sigma=0.1)
    tstep = make_round_step(tprob, AlgorithmConfig(**_cfg_kwargs(algo, impl)),
                            device="cpu")
    batches = {n: v.unsqueeze(0).expand(K, *v.shape)
               for n, v in tdata.items() if n != "mu"}
    t_ops.zero_launch_counts()
    for t in range(ROUNDS):
        tst = tstep(tst, batches, _round_noise(t))
    assert set(t_ops.launch_counts().values()) == {0}
    assert tst.round == ROUNDS
    for name in ("x", "y", "cx", "cy"):
        tol = ATOL_C if name in ("cx", "cy") else ATOL
        np.testing.assert_allclose(getattr(tst, name).numpy(), ref[name],
                                   rtol=0, atol=tol, err_msg=name)
