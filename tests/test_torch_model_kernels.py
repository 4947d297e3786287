"""The plain versions of the two model kernels against the JAX package.

Same numpy inputs (from a seed) go through ``repro.kernels.ops`` with
``backend="interpret"`` (the Pallas kernels, as the JAX package's own tests
run them on the CPU) and through ``repro_torch.kernels.ops`` on CPU tensors,
which runs the plain versions the CUDA kernels are held against on the card
(``chip_smoke.py``): ``ref.attention_ref`` (B5) and ``ref.rglru_ref`` (B8).

Tolerances, as max |port − JAX| ≤ tol·(1 + max|JAX|):
* attention, f32: 1e-5 — both softmaxes are f32, only the sum order differs;
* attention, bf16: 1e-2 — both round an f32 result to bf16 once, so an
  element may land one bf16 ulp (2^−8 relative) apart;
* RG-LRU scan: 1e-5 — f32 throughout; the Pallas kernel's doubling scan and
  the step-by-step loop order the products differently.
Non-causal attention is held against JAX ``ref.attention_ref``: the Pallas
path attends to its own padding when ``causal=False`` (ROADMAP §C).
"""
import _torch_threads  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import rglru as jax_rglru
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import rglru_scan as t_rg

TOL_F32 = 1e-5
TOL_BF16 = 1e-2


def _qkv(b, s, h, kv, d, dtype, seed, sk=None):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    if dtype == "bfloat16":
        q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16)) for x in (q, k, v))
    return q, k, v


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def _close(got, want, tol):
    got = got.to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err <= tol * (1 + np.abs(want).max()), err


# (S, H, KV, D, window, dtype): ragged S (one and two 128-row Pallas
# blocks), GQA 4/1 and 14/2, MHA 4/4, head_dim 64 and 256
CAUSAL_CASES = [
    (100, 4, 1, 64, 0, "float32"),
    (100, 4, 1, 64, 16, "bfloat16"),
    (37, 14, 2, 64, 16, "float32"),
    (37, 14, 2, 64, 0, "bfloat16"),
    (70, 4, 4, 256, 16, "float32"),
    (70, 4, 4, 256, 0, "bfloat16"),
    (130, 4, 1, 256, 16, "bfloat16"),
    (130, 14, 2, 256, 0, "float32"),
]


@pytest.mark.parametrize("s,h,kv,d,window,dtype", CAUSAL_CASES)
def test_attention_ref_matches_jax_kernel(s, h, kv, d, window, dtype):
    q, k, v = _qkv(2, s, h, kv, d, dtype, seed=s + h + d + window)
    want = jax_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True, window=window,
                                   backend="interpret")
    got = t_ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                                window=window)
    assert got.dtype == _t(q).dtype
    _close(got, want, TOL_F32 if dtype == "float32" else TOL_BF16)


@pytest.mark.parametrize("s,sk,h,kv,window", [
    (100, 100, 4, 1, 0), (37, 70, 14, 2, 16), (70, 37, 4, 4, 0)])
def test_attention_ref_noncausal_matches_jax_ref(s, sk, h, kv, window):
    """Non-causal, also with Sq ≠ Sk: against the reference's plain
    attention on its (B·H, S, D) layout."""
    b, d = 2, 64
    q, k, v = _qkv(b, s, h, kv, d, "float32", seed=s + sk, sk=sk)
    fold = lambda x: x.transpose(0, 2, 1, 3).reshape(-1, *x.shape[1::2])  # noqa: E731
    want = jax_ref.attention_ref(fold(q), fold(k), fold(v), causal=False,
                                 window=window)
    want = np.asarray(want).reshape(b, h, s, d).transpose(0, 2, 1, 3)
    got = t_ops.flash_attention(_t(q), _t(k), _t(v), causal=False,
                                window=window)
    _close(got, want, TOL_F32)


def test_attention_ref_query_blocks_do_not_change_the_result():
    q, k, v = (_t(x) for x in _qkv(1, 90, 4, 2, 64, "float32", seed=3))
    whole = t_ref.attention_ref(q, k, v, window=20, q_block=1024)
    for q_block in (1, 7, 64):
        part = t_ref.attention_ref(q, k, v, window=20, q_block=q_block)
        torch.testing.assert_close(part, whole, rtol=0, atol=1e-6)


def _au(b, s, w, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (b, s, w)).astype(np.float32)
    u = rng.standard_normal((b, s, w)).astype(np.float32)
    return a, u


@pytest.mark.parametrize("b,s,w", [(2, 300, 40), (1, 256, 128), (3, 17, 5)])
def test_rglru_ref_matches_jax_kernel(b, s, w):
    a, u = _au(b, s, w, seed=s)
    want = jax_ops.rglru_scan(jnp.asarray(a), jnp.asarray(u),
                              backend="interpret")
    got = t_ops.rglru_scan(_t(a), _t(u))
    _close(got, want, TOL_F32)


def test_rglru_h0_fold_matches_jax_model_scan():
    """The model folds a carried state into the first step before the
    kernel (u_0 += a_0·h0); the reference model's ``rglru_scan`` takes h0
    as an operand."""
    b, s, w = 2, 300, 40
    a, u = _au(b, s, w, seed=7)
    h0 = np.random.default_rng(8).standard_normal((b, w)).astype(np.float32)
    want, want_fin = jax_rglru.rglru_scan(jnp.asarray(a), jnp.asarray(u),
                                          jnp.asarray(h0))
    ta, tu, th0 = _t(a), _t(u), _t(h0)
    folded = tu.clone()
    folded[:, 0] = folded[:, 0] + ta[:, 0] * th0
    got = t_ops.rglru_scan(ta, folded)
    _close(got, want, TOL_F32)
    _close(got[:, -1], want_fin, TOL_F32)
    # the plain version with h0 is the same function, bit for bit
    torch.testing.assert_close(t_ref.rglru_ref(ta, tu, th0), got, rtol=0,
                               atol=0)


def test_dispatch_rules_on_cpu():
    q = torch.zeros((1, 4, 2, 8))
    a = torch.zeros((1, 4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        t_ops.flash_attention(q, q[:, :, :1], q[:, :, :1], backend="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        t_ops.rglru_scan(a, a, backend="kernel")
    # the wrappers launch only on CUDA tensors
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_fa.flash_attention_bshd(q, q[:, :, :1].contiguous(),
                                  q[:, :, :1].contiguous())
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_rg.rglru_scan_bsw(a, a)
    with pytest.raises(ValueError, match="head_dim"):
        t_fa.flash_attention_bshd(torch.zeros((1, 2, 1, 257)),
                                  torch.zeros((1, 2, 1, 257)),
                                  torch.zeros((1, 2, 1, 257)))
    assert t_ops.launch_counts()["flash_attention"] == 0
