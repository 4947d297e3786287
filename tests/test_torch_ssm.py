"""The port's Mamba2 SSD scan and block against the JAX package.

The same numpy inputs (from a seed) go through ``repro.models.ssm`` and the
reference's kernels (``repro.kernels.ops.ssd_scan`` with
``backend="interpret"``, the Pallas kernel as the JAX package's own tests
run it on the CPU, and the token-by-token oracle ``ref.ssd_ref``), and
through ``repro_torch``: ``ssd_chunked`` (kernel B7's plain version, which
``ops.ssd_scan`` runs on CPU tensors), ``ssd_ref``, ``_causal_conv`` and
``ssm_forward`` in train, prefill and decode on the reduced mamba2-1.3b
(d 256, 16 heads of 32, d_state 16, chunk 16).

Tolerances, as max |port − JAX| ≤ tol·(1 + max|JAX|):
* the scan, f32: 1e-5 — the same f32 math in other sum orders (the chunked
  form against the recurrence: ~1e-6 relative on the CPU);
* the block, f32 compute: 1e-5; bf16 compute: 3e-2 — the frameworks round
  bf16 at other places (as ``tests/test_torch_models.py`` states).
The final SSD state is small (≈ 3e-3 at dt ≈ 0.01), so it is also held to
1e-5 of its own magnitude in f32.
"""
import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import model as jax_model
from repro.models import ssm as jax_ssm
from repro_torch.configs import registry
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import ssd_scan as t_ssd
from repro_torch.models import interop
from repro_torch.models import ssm as t_ssm
from repro_torch.models import transformer as t_tf

TOL = 1e-5
TOL_BF16 = 3e-2
DTYPES = {"float32": (jnp.float32, torch.float32, TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, TOL_BF16)}


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


def _ssd_inputs(b, s, h, p, n, seed):
    """xdt, loga (< 0, as −exp(A_log)·dt), B, C, state0 as f32 numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, s, h, p)).astype(f) * f(0.5),
            -rng.uniform(0.0, 1.0, (b, s, h)).astype(f),
            rng.standard_normal((b, s, n)).astype(f),
            rng.standard_normal((b, s, n)).astype(f),
            rng.standard_normal((b, h, p, n)).astype(f))


# (B, S, H, P, N, chunk): ragged S, S < chunk, S one whole chunk, S = 1
SCAN_CASES = [(2, 37, 3, 8, 5, 16), (2, 10, 2, 8, 4, 16),
              (1, 64, 2, 16, 8, 64), (1, 1, 1, 4, 3, 16),
              (2, 100, 4, 32, 16, 16)]


@pytest.mark.parametrize("with_state0", [False, True])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SCAN_CASES)
def test_ssd_chunked_matches_jax_model_scan(b, s, h, p, n, chunk,
                                            with_state0):
    x, la, bm, cm, s0 = _ssd_inputs(b, s, h, p, n, seed=s + h)
    state0 = s0 if with_state0 else None
    want_y, want_fin = jax_ssm.ssd_chunked(
        jnp.asarray(x), jnp.asarray(la), jnp.asarray(bm), jnp.asarray(cm),
        chunk, None if state0 is None else jnp.asarray(state0))
    got_y, got_fin = t_ops.ssd_scan(
        _t(x), _t(la), _t(bm), _t(cm), chunk=chunk,
        state0=None if state0 is None else _t(state0))
    _close(got_y, want_y, TOL, "y")
    _close(got_fin, want_fin, TOL, "final state")
    # the plain version is what ops.ssd_scan runs on CPU tensors
    y2, fin2 = t_ref.ssd_chunked(_t(x), _t(la), _t(bm), _t(cm), chunk,
                                 None if state0 is None else _t(state0))
    assert torch.equal(y2, got_y) and torch.equal(fin2, got_fin)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SCAN_CASES[:3])
def test_ssd_chunked_matches_pallas_kernel(b, s, h, p, n, chunk):
    """The Pallas kernel pads S to whole chunks and returns no state."""
    x, la, bm, cm, _ = _ssd_inputs(b, s, h, p, n, seed=7 + s)
    want = jax_ops.ssd_scan(jnp.asarray(x), jnp.asarray(la), jnp.asarray(bm),
                            jnp.asarray(cm), chunk=chunk, backend="interpret")
    got, _ = t_ref.ssd_chunked(_t(x), _t(la), _t(bm), _t(cm), chunk)
    _close(got, want, TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SCAN_CASES[:2])
def test_ssd_ref_matches_jax_ref_and_the_chunked_form(b, s, h, p, n, chunk):
    """The token-by-token oracle on the model layout against the
    reference's on (B·H, S, P); then the chunked form against it, from a
    carried state too."""
    x, la, bm, cm, s0 = _ssd_inputs(b, s, h, p, n, seed=11)
    fold = lambda a: a.transpose(0, 2, 1, 3).reshape(b * h, s, p)  # noqa: E731
    want = jax_ref.ssd_ref(jnp.asarray(fold(x)),
                           jnp.asarray(la.transpose(0, 2, 1).reshape(b * h, s)),
                           jnp.asarray(bm), jnp.asarray(cm))
    want = np.asarray(want).reshape(b, h, s, p).transpose(0, 2, 1, 3)
    y, _ = t_ref.ssd_ref(_t(x), _t(la), _t(bm), _t(cm))
    _close(y, want, TOL)
    ry, rfin = t_ref.ssd_ref(_t(x), _t(la), _t(bm), _t(cm), _t(s0))
    cy, cfin = t_ref.ssd_chunked(_t(x), _t(la), _t(bm), _t(cm), chunk, _t(s0))
    torch.testing.assert_close(cy, ry, rtol=0, atol=TOL * (1 + ry.abs().max()))
    torch.testing.assert_close(cfin, rfin, rtol=0,
                               atol=TOL * (1 + rfin.abs().max()))


def test_ssd_chunked_never_forms_the_upper_triangle():
    """A decay large enough that exp(cum_t − cum_u) for u > t overflows:
    the plain version masks before the exp, so y stays finite and its
    gradient has no NaN."""
    x, la, bm, cm, _ = _ssd_inputs(1, 32, 2, 4, 3, seed=3)
    la = la * 200.0                              # cum down to about −6400
    xt = _t(x).requires_grad_(True)
    y, fin = t_ref.ssd_chunked(xt, _t(la), _t(bm), _t(cm), 16)
    assert torch.isfinite(y).all() and torch.isfinite(fin).all()
    (y.sum() + fin.sum()).backward()
    assert torch.isfinite(xt.grad).all()


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    bias = rng.standard_normal((6,)).astype(np.float32)
    state = rng.standard_normal((2, 3, 6)).astype(np.float32) if with_state \
        else None
    want, want_state = jax_ssm._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
        None if state is None else jnp.asarray(state))
    got, got_state = t_ssm._causal_conv(_t(x), _t(w), _t(bias),
                                        None if state is None else _t(state))
    _close(got, want, TOL)
    _close(got_state, want_state, TOL)
    # the carried state continues the sequence: two calls equal one
    whole, _ = t_ssm._causal_conv(_t(x), _t(w), _t(bias))
    first, carry = t_ssm._causal_conv(_t(x[:, :5]), _t(w), _t(bias))
    second, _ = t_ssm._causal_conv(_t(x[:, 5:]), _t(w), _t(bias), carry)
    torch.testing.assert_close(torch.cat([first, second], 1), whole)


_MODEL = {}


def _mamba():
    """(reference cfg, reference params, port cfg, port model) of the
    reduced mamba2-1.3b; the port holds the reference's f32 arrays."""
    if not _MODEL:
        jcfg = jax_registry.reduced(jax_registry.get_model_config(
            "mamba2-1.3b"))
        tcfg = registry.reduced(registry.get_model_config("mamba2-1.3b"))
        params = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
        model = interop.params_from_reference(
            jax.tree.map(np.asarray, params), tcfg, device="cpu")
        _MODEL.update(jcfg=jcfg, params=params, tcfg=tcfg, model=model)
    return _MODEL["jcfg"], _MODEL["params"], _MODEL["tcfg"], _MODEL["model"]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_ssm_forward_matches_jax(mode, dtype):
    """The first layer's block, from a noisy carried cache in prefill and
    decode (conv state and SSD state), S = 40 (a ragged chunk of 16)."""
    jcfg, params, tcfg, model = _mamba()
    jdt, tdt, tol = DTYPES[dtype]
    jp = jax.tree.map(lambda a: a[0], params["stack"][0][0]["ssm"])
    s = 1 if mode == "decode" else 40
    rng = np.random.default_rng(hash((mode, dtype)) % 2**32)
    x = jnp.asarray(rng.standard_normal((2, s, jcfg.d_model)), jdt)
    conv = state = None
    if mode != "train":
        one = jax_model._block_cache_shape("ssm", jcfg, 2, 48, jdt)
        conv = jnp.asarray(rng.standard_normal(one["conv"].shape), jdt)
        state = jnp.asarray(rng.standard_normal(one["state"].shape) * 0.01,
                            jnp.float32)
    want, want_cache = jax_ssm.ssm_forward(jp, x, jcfg, jdt, conv, state,
                                           decode=(mode == "decode"))
    with torch.no_grad():
        got, got_cache = t_ssm.ssm_forward(
            model.layers[0].ssm, _t(x), tcfg, tdt,
            None if conv is None else _t(conv),
            None if state is None else _t(state),
            decode=(mode == "decode"))
    assert got.dtype == tdt
    _close(got, want, tol, "out")
    _close(got_cache["conv"], want_cache["conv"], tol, "conv")
    _close(got_cache["state"], want_cache["state"], tol, "state")
    if dtype == "float32":
        ref_state = np.asarray(want_cache["state"])
        err = np.abs(got_cache["state"].numpy() - ref_state).max()
        assert err <= TOL * np.abs(ref_state).max(), err


def test_ssm_forward_kernel_route_equals_plain_on_cpu():
    """On CPU tensors ``ops.ssd_scan`` is the plain version: the kernel
    route and ``kernels=False`` give the same block, bit for bit."""
    _, _, tcfg, model = _mamba()
    x = torch.randn((2, 40, tcfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    with torch.no_grad():
        a, ca = t_ssm.ssm_forward(model.layers[1].ssm, x, tcfg,
                                  torch.float32, kernels=True)
        b, cb = t_ssm.ssm_forward(model.layers[1].ssm, x, tcfg,
                                  torch.float32, kernels=False)
    assert torch.equal(a, b) and torch.equal(ca["state"], cb["state"])


def test_kernel_route():
    assert t_tf.kernel_route("prefill", True)
    assert not t_tf.kernel_route("decode", True)
    assert not t_tf.kernel_route("prefill", False)
    # autograd is on here: every model kernel has a gradient (autograd
    # Functions), so training runs the kernels
    assert t_tf.kernel_route("train", True)
    with torch.no_grad():
        assert t_tf.kernel_route("train", True)
        assert not t_tf.kernel_route("train", False)


def test_ssd_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((1, 4, 2, 8))
    la = torch.zeros((1, 4, 2))
    bm = torch.zeros((1, 4, 3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_ssd.ssd_scan_bshp(x, la, bm, bm, chunk=16)
    with pytest.raises(ValueError, match="chunk"):
        t_ssd.ssd_scan_bshp(x, la, bm, bm, chunk=128)
    with pytest.raises(ValueError, match="N ≤ 128"):
        t_ssd.ssd_scan_bshp(x, la, torch.zeros((1, 4, 129)),
                            torch.zeros((1, 4, 129)), chunk=16)
    with pytest.raises(ValueError, match="CUDA"):
        t_ops.ssd_scan(x, la, bm, bm, chunk=16, backend="kernel")
    assert t_ops.launch_counts()["ssd_scan"] == 0


def _grad_cases():
    """Each model kernel's wrapper with operands of its shapes."""
    q = torch.zeros((1, 4, 2, 8))
    x, la, bm = torch.zeros((1, 4, 2, 8)), torch.zeros((1, 4, 2)), \
        torch.zeros((1, 4, 3))
    return {
        "flash_attention": (t_ops.KERNELS["flash_attention"],
                            (q, q[:, :, :1].contiguous(),
                             q[:, :, :1].contiguous()), {}),
        "rglru_scan": (t_ops.KERNELS["rglru_scan"],
                       (torch.zeros((1, 4, 3)), torch.zeros((1, 4, 3))), {}),
        "ssd_scan": (t_ops.KERNELS["ssd_scan"], (x, la, bm, bm),
                     {"chunk": 16}),
        "fused_cross_entropy": (t_ops.KERNELS["fused_cross_entropy"],
                                (torch.zeros((4, 8)), torch.zeros((10, 8)),
                                 torch.zeros((4,), dtype=torch.long)), {}),
    }


@pytest.mark.parametrize("name", ["flash_attention", "rglru_scan",
                                  "ssd_scan", "fused_cross_entropy"])
def test_model_kernels_refuse_an_operand_that_requires_grad(name):
    """Every model kernel (B5–B8) is differentiable (autograd Functions):
    an operand that requires grad is not refused for that, and goes on to
    the device check, which refuses a CPU tensor; so does every call under
    no_grad.  Nothing launches."""
    fn, args, kw = _grad_cases()[name]
    grad_args = (args[0].clone().requires_grad_(True),) + args[1:]
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn(*grad_args, **kw)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensor"):
        fn(*grad_args, **kw)
    assert t_ops.launch_counts()[name] == 0
