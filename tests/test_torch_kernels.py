"""The port's plain kernel versions against the JAX package's kernels.

The same numpy inputs (from a seed) go through ``repro.kernels.ops`` with
``backend="interpret"`` (the Pallas kernels, run as the JAX package's own
tests run them on CPU) and through ``repro_torch.kernels.ops`` on CPU
tensors, which runs the plain PyTorch versions the CUDA kernels are held
against on the card (``chip_smoke.py``).

Tolerances: 1e-6 absolute on θ'/z' and Δ-level outputs, 4× that on the
corrections — the JAX package's own kernel tolerances
(tests/test_fused_round.py:70-80, :124-131).  Both sides compute in f32 on
the CPU; only the order of the f32 sums differs.
"""
import _torch_threads  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topology as jax_topology
from repro.kernels import ops as jax_ops
from repro.kernels import quantize as jax_quantize
from repro_torch.kernels import fused_round as t_fused_round
from repro_torch.kernels import gossip as t_gossip
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import quantize as t_quantize

ATOL = 1e-6
ATOL_C = 4e-6


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _gossip_operands(n=6, d=300, seed=0):
    rng = np.random.default_rng(seed)
    w = jax_topology.mixing_matrix("ring", n).astype(np.float32)
    delta = rng.standard_normal((n, d)).astype(np.float32)
    theta = (rng.standard_normal((n, d)) * 3.0).astype(np.float32)
    c = (rng.standard_normal((n, d)) * 0.5).astype(np.float32)
    return w, delta, theta, c


@pytest.mark.parametrize("gossip_dtype", [None, "bfloat16"])
def test_fused_gossip_matches_jax_kernel(gossip_dtype):
    w, delta, theta, c = _gossip_operands()
    eta_s, corr = 0.7, 4.2
    jt, jc = jax_ops.fused_gossip_round(
        w, jnp.asarray(delta), jnp.asarray(theta), jnp.asarray(c), eta_s,
        corr, backend="interpret", gossip_dtype=gossip_dtype)
    tt, tc = t_ops.fused_gossip_round(
        _t(w), _t(delta), _t(theta), _t(c), eta_s, corr,
        gossip_dtype=gossip_dtype)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=ATOL_C)


def _round_operands(n=6, dz=150, k=3, seed=0):
    """tests/test_fused_round.py's operand scales, drawn with numpy."""
    rng = np.random.default_rng(seed)

    def rn(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    w = jax_topology.mixing_matrix("ring", n).astype(np.float32)
    z0, c, ef = rn(n, dz, scale=0.3), rn(n, dz, scale=0.1), rn(n, dz,
                                                               scale=0.01)
    g = rn(n, dz, dz, scale=0.1 / dz)
    h = rn(k, n, dz, scale=0.05)
    step = np.full((n, dz), 0.05, np.float32)
    etas = np.full((n, dz), 0.5, np.float32)
    corr = np.broadcast_to(rn(dz, scale=0.3), (n, dz)).copy()
    mask = np.ones((n, dz), np.float32)
    return w, z0, c, ef, g, h, step, etas, corr, mask


@pytest.mark.parametrize("gossip_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("compress", [None, "bf16", "int8"])
def test_fused_round_matches_jax_kernel(compress, gossip_dtype):
    args = _round_operands()
    jz, jc, je = jax_ops.fused_round(
        *(jnp.asarray(a) for a in args), backend="interpret",
        compress=compress, gossip_dtype=gossip_dtype)
    tz, tc, te = t_ops.fused_round(*(_t(a) for a in args), compress=compress,
                                   gossip_dtype=gossip_dtype)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=ATOL_C)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=ATOL)


@pytest.mark.parametrize("method", ["bf16", "int8"])
def test_quantizer_bitwise_matches_jax_and_residual_is_exact(method):
    """Same v ⇒ the same Q(v) bit for bit as the reference, and
    Q(v) + (v − Q(v)) == v exactly (the error-feedback identity)."""
    rng = np.random.default_rng(3)
    v = (rng.standard_normal((8, 257))
         * np.exp(rng.standard_normal((8, 257)) * 3)).astype(np.float32)
    v[2] = 0.0                                # an all-zero row maps to 0
    q = t_quantize.quantize_dequant(_t(v), method)
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(jax_quantize.quantize_dequant(jnp.asarray(v),
                                                            method)))
    e = _t(v) - q
    np.testing.assert_array_equal((q + e).numpy(), v)
    assert t_quantize.wire_bits(method) == jax_quantize.wire_bits(method)


@pytest.mark.parametrize("compress", ["bf16", "int8"])
def test_fused_round_plain_residual_identity(compress):
    """The plain whole round's wire value: q + e' == v bit for bit."""
    from repro_torch.kernels import ref

    w, z0, c, ef, g, h, step, etas, corr, mask = (
        _t(a) for a in _round_operands(seed=5))
    mask[1] = 0.0
    q, e_new, delta = ref.local_steps_ref(z0, c, ef, g, h, step, mask,
                                          compress=compress)
    v = mask * (delta + ef)
    act = mask > 0
    assert torch.equal((q + e_new)[act], v[act])
    assert torch.equal(e_new[~act], ef[~act])      # inactive residual frozen
    assert torch.equal(q[~act], torch.zeros_like(q[~act]))


@pytest.mark.parametrize("call", ["gossip", "round"])
def test_kernel_backend_on_cpu_raises(call):
    """backend='kernel' on CPU tensors raises: no silent plain path."""
    if call == "gossip":
        w, delta, theta, c = (_t(a) for a in _gossip_operands(n=4, d=8))
        with pytest.raises(ValueError, match="CUDA"):
            t_ops.fused_gossip_round(w, delta, theta, c, 1.0, 1.0,
                                     backend="kernel")
    else:
        args = [_t(a) for a in _round_operands(n=4, dz=8, k=2)]
        with pytest.raises(ValueError, match="CUDA"):
            t_ops.fused_round(*args, backend="kernel")


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers themselves launch or raise; they never compute on CPU."""
    w, delta, theta, c = (_t(a) for a in _gossip_operands(n=4, d=8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_gossip.fused_gossip_nd(w, delta, theta, c, 1.0, 1.0)
    args = [_t(a) for a in _round_operands(n=4, dz=8, k=2)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_fused_round.fused_round_nd(*args)
    assert t_gossip.fused_gossip_nd.launches == 0
    assert t_fused_round.fused_round_nd.launches == 0


def test_fused_round_refuses_oversized_state():
    """dz > 1024 is refused as in the JAX package, naming pallas_packed."""
    with pytest.raises(ValueError, match="pallas_packed"):
        t_fused_round.check_dz(1100)
    t_fused_round.check_dz(1024)


def test_unknown_backend_raises():
    w, delta, theta, c = (_t(a) for a in _gossip_operands(n=4, d=8))
    with pytest.raises(ValueError, match="gossip_backend"):
        t_ops.fused_gossip_round(w, delta, theta, c, 1.0, 1.0,
                                 backend="pallas")
