"""The port's core pieces against the JAX package: topology, packing, and
the options the port refuses.

Topology is a numpy-only copy, so it must agree exactly; packing must give
the reference's column layout bit for bit.
"""
import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jax_packing
from repro.core import topology as jax_topology
from repro_torch.configs import AlgorithmConfig
from repro_torch.core import (
    init_state,
    make_quadratic_data,
    make_round_step,
    mix_dense,
    mix_packed,
    mix_ring,
    packing,
    point_etas,
    quadratic_problem,
)
from repro_torch.core import topology

TOPO_N = [(t, n) for t in ("ring", "full", "exp", "star")
          for n in (1, 2, 5, 8)] + [("torus", 9), ("torus", 16)]


@pytest.mark.parametrize("topo,n", TOPO_N)
def test_topology_matches_jax(topo, n):
    w = topology.mixing_matrix(topo, n)
    np.testing.assert_array_equal(w, jax_topology.mixing_matrix(topo, n))
    assert topology.spectral_gap(w) == jax_topology.spectral_gap(w)


def _tree(n=5, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((n, 3, 2)).astype(np.float32),
            "b": rng.standard_normal((n, 4)).astype(np.float32),
            "a": [rng.standard_normal((n,)).astype(np.float32),
                  rng.standard_normal((n, 2, 2)).astype(np.float32)]}


def test_packing_matches_jax_layout():
    tree = _tree()
    tt = {k: ([torch.as_tensor(x) for x in v] if isinstance(v, list)
              else torch.as_tensor(v)) for k, v in tree.items()}
    jt = {k: ([jnp.asarray(x) for x in v] if isinstance(v, list)
              else jnp.asarray(v)) for k, v in tree.items()}
    spec, jspec = packing.pack_spec(tt), jax_packing.pack_spec(jt)
    assert (spec.offsets, spec.sizes, spec.shapes, spec.n, spec.dim) == (
        jspec.offsets, jspec.sizes, jspec.shapes, jspec.n, jspec.dim)
    buf = packing.pack(tt, spec)
    np.testing.assert_array_equal(buf.numpy(),
                                  np.asarray(jax_packing.pack(jt, jspec)))
    back = packing.unpack(buf, spec)
    np.testing.assert_array_equal(back["w"].numpy(), tree["w"])
    np.testing.assert_array_equal(back["a"][1].numpy(), tree["a"][1])


def test_unpack_restores_dtype_and_checks_shape():
    tt = {"c": torch.ones((3, 4), dtype=torch.bfloat16),
          "d": torch.zeros((3, 2))}
    spec = packing.pack_spec(tt)
    buf = packing.pack(tt, spec)
    assert buf.dtype == torch.float32 and tuple(buf.shape) == (3, 6)
    assert packing.unpack(buf, spec)["c"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="does not match"):
        packing.unpack(buf[:, :5], spec)


@pytest.mark.parametrize("gossip_dtype", ["float32", "bfloat16"])
def test_mixers_agree(gossip_dtype):
    """dense and packed mixing are the same contraction; on a ring the
    roll exchange is too (in f32 — under bf16 the reference's ring keeps
    its two weights in f32 while the dense path narrows W)."""
    n = 6
    w = torch.as_tensor(topology.mixing_matrix("ring", n), dtype=torch.float32)
    tree = {k: (torch.as_tensor(v[0]) if isinstance(v, list)
                else torch.as_tensor(v)) for k, v in _tree(n).items()}
    dense = mix_dense(tree, w, gossip_dtype)
    packed = mix_packed(tree, w, gossip_dtype)
    ring = mix_ring(tree, float(w[0, 0]), float(w[0, 1]), gossip_dtype)
    for k in tree:
        torch.testing.assert_close(packed[k], dense[k], rtol=0, atol=1e-6)
        if gossip_dtype == "float32":
            torch.testing.assert_close(ring[k], dense[k], rtol=0, atol=1e-6)


def _problem(n=4):
    gen = torch.Generator().manual_seed(0)
    data = make_quadratic_data(gen, n, dx=6, dy=3)
    return quadratic_problem(data, sigma=0.1), data


# options the port once refused, each now taken on a lowering that takes
# it (first dict: the config, second: make_round_step's flags) and refused
# with the reference's own ValueError where the reference refuses it (third:
# the config change that makes it refused)
UNPORTED = [
    ({"mixing_impl": "coord_median"}, {},
     {"topology_cycle": ("ring", "full")}),
    ({"mixing_impl": "sparse_trimmed_mean"}, {}, {"topology_cycle": ("ring",)}),
    ({"gossip_compress": "int8", "mixing_impl": "pallas_packed"}, {},
     {"mixing_impl": "dense"}),
    ({"num_byzantine": 1, "mixing_impl": "trimmed_mean"},
     {"byzantine": True}, {"mixing_impl": "fused_round"}),
    ({"attack": "sign_flip", "gossip_compress": "bf16",
      "mixing_impl": "fused_round"}, {}, {"mixing_impl": "sparse_packed"}),
    ({}, {"byzantine": True}, {"mixing_impl": "fused_round"}),
]


@pytest.mark.parametrize("cfg_kw,step_kw,refused_kw", UNPORTED)
def test_unported_options_raise(cfg_kw, step_kw, refused_kw):
    """Formerly refused options are ported: taken where the reference takes
    them, refused with the reference's message where it refuses them."""
    from repro.configs.base import AlgorithmConfig as JaxConfig
    from repro.core import make_quadratic_data as jax_make_data
    from repro.core import make_round_step as jax_make_round_step
    from repro.core import quadratic_problem as jax_quadratic_problem

    prob, _ = _problem()
    make_round_step(prob, AlgorithmConfig(num_clients=4, **cfg_kw),
                    device="cpu", **step_kw)
    bad = {**cfg_kw, **refused_kw}
    with pytest.raises(ValueError) as ours:
        make_round_step(prob, AlgorithmConfig(num_clients=4, **bad),
                        device="cpu", **step_kw)
    jprob = jax_quadratic_problem(
        jax_make_data(jax.random.PRNGKey(0), 4, dx=6, dy=3), sigma=0.1)
    with pytest.raises(ValueError) as ref:
        jax_make_round_step(jprob, JaxConfig(num_clients=4, **bad), **step_kw)
    assert str(ours.value) == str(ref.value)


def test_invalid_options_raise():
    prob, _ = _problem()
    with pytest.raises(ValueError, match="mixing_impl"):
        make_round_step(prob, AlgorithmConfig(mixing_impl="nope"),
                        device="cpu")
    with pytest.raises(ValueError, match="gossip_backend"):
        make_round_step(prob, AlgorithmConfig(num_clients=4,
                                              gossip_backend="pallas"),
                        device="cpu")
    with pytest.raises(ValueError, match="topology='ring'"):
        make_round_step(prob, AlgorithmConfig(num_clients=4, topology="full",
                                              mixing_impl="ring"),
                        device="cpu")
    with pytest.raises(ValueError, match="traced_etas"):
        make_round_step(prob, AlgorithmConfig(num_clients=4),
                        lr_scale=lambda r: 1.0, traced_etas=True,
                        device="cpu")


@pytest.mark.parametrize("impl", ["pallas_packed", "fused_round"])
def test_kernel_backend_on_cpu_state_raises(impl):
    """gossip_backend='kernel' with a CPU state raises inside the round:
    the packed lowerings never fall back to the plain version."""
    prob, data = _problem()
    cfg = AlgorithmConfig(num_clients=4, local_steps=2, mixing_impl=impl,
                          gossip_backend="kernel")
    gen = torch.Generator().manual_seed(1)
    cb = {k: v for k, v in data.items() if k != "mu"}
    st = init_state(prob, cfg, gen, init_batch=cb)
    step = make_round_step(prob, cfg, device="cpu")
    batches = {k: v.unsqueeze(0).expand(2, *v.shape) for k, v in cb.items()}
    with pytest.raises(ValueError, match="CUDA"):
        step(st, batches, torch.zeros((2, 4, prob.noise_dim)))


def test_traced_etas_match_static_path():
    """round_step(..., etas=point_etas(cfg)) is the static round."""
    prob, data = _problem()
    cfg = AlgorithmConfig(num_clients=4, local_steps=2, eta_cx=0.01,
                          eta_cy=0.1, eta_sx=0.5, eta_sy=0.5,
                          mixing_impl="pallas_packed")
    gen = torch.Generator().manual_seed(1)
    cb = {k: v for k, v in data.items() if k != "mu"}
    st = init_state(prob, cfg, gen, init_batch=cb)
    batches = {k: v.unsqueeze(0).expand(2, *v.shape) for k, v in cb.items()}
    noise = torch.randn((2, 4, prob.noise_dim), generator=gen)
    a = make_round_step(prob, cfg, device="cpu")(st, batches, noise)
    b = make_round_step(prob, cfg, traced_etas=True, device="cpu")(
        st, batches, noise, point_etas(cfg))
    for name in ("x", "y", "cx", "cy"):
        torch.testing.assert_close(getattr(a, name), getattr(b, name),
                                   rtol=0, atol=1e-6)
    assert a.round == b.round == 1


@pytest.mark.parametrize("cell", [False, True])
def test_affine_coeffs_match_autodiff(cell):
    """(∇x f, ∇y f) from autodiff of ``value`` equal split(G z + h), with
    the noise row fed to both — the contract fused_round relies on."""
    from repro_torch.core import quadratic_cell_problem

    prob, data = _problem()
    batch = {k: v[1] for k, v in data.items() if k != "mu"}
    if cell:
        prob = quadratic_cell_problem(6, 3, noise=True, device="cpu")
        batch["sigma"] = torch.tensor(0.1)
    gen = torch.Generator().manual_seed(2)
    x, y = torch.randn(6, generator=gen), torch.randn(3, generator=gen)
    noise = torch.randn(9, generator=gen)
    gx, gy = prob.grads(x, y, batch, noise)
    g, h = prob.affine_coeffs(batch, noise)
    z = g @ torch.cat([x, y]) + h
    torch.testing.assert_close(torch.cat([gx, gy]), z, rtol=0, atol=1e-5)
    # noise with a leading step axis: G once, one h per step
    g2, h2 = prob.affine_coeffs(batch, torch.stack([noise, 2 * noise]))
    assert tuple(g2.shape) == (9, 9) and tuple(h2.shape) == (2, 9)
    torch.testing.assert_close(h2[0], h, rtol=0, atol=0)


def test_diagnostics_match_jax():
    """diagnostics() on the same state: ‖∇Φ(x̄)‖, consensus, ‖c̄‖."""
    import jax

    from repro.core import diagnostics as jax_diagnostics
    from repro.core import init_state as jax_init_state
    from repro.core import make_quadratic_data as jax_make_data
    from repro.core import quadratic_problem as jax_problem
    from repro.configs.base import AlgorithmConfig as JaxConfig
    from repro_torch.core import diagnostics, from_reference

    key = jax.random.PRNGKey(0)
    data = jax_make_data(key, 4, dx=6, dy=3)
    jprob = jax_problem(data)
    cb = {k: v for k, v in data.items() if k != "mu"}
    st = jax_init_state(jprob, JaxConfig(num_clients=4), key, init_batch=cb)
    tdata, tst = from_reference(
        {k: np.asarray(v) for k, v in data.items()},
        {k: np.asarray(getattr(st, k)) for k in ("x", "y", "cx", "cy")},
        device="cpu")
    jd = jax_diagnostics(jprob, st)
    td = diagnostics(quadratic_problem(tdata), tst)
    assert set(td) == set(jd)
    for k in jd:
        np.testing.assert_allclose(float(td[k]), float(jd[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
