"""The algebra of kernel B8's chunked route and of its backward, on the CPU.

``repro_torch.kernels.ref.rglru_chunked`` writes out in plain PyTorch what
the chunked route of ``csrc/rglru_scan.cu`` computes: S cut into chunks,
each chunk into 8 runs scanned from zero with their prefix products, the
runs' maps composed into each run's carry-in and the chunk's aggregate, the
carry between chunks, and the fix-up h_t = h_local_t + P_t·carry.
``ref.rglru_bwd_scan`` is the backward kernel's: the same scan in reverse
time with a read one step ahead, then du = g and da = g·h_{t−1}.

They are held against the step-by-step recurrence (``ref.rglru_ref``, B8's
plain version, and ``ref.rglru_bwd_ref``, the plain backward), against the
JAX package's Pallas kernel (``repro.kernels.rglru_scan.rglru_scan_b`` in
interpret mode, where the chunk divides S), against the reference model's
scan (``repro.models.rglru.rglru_scan``, at ragged S and W, with and
without a carried h0 folded into u_0) and against ``jax.vjp`` of that
scan, on the same numpy inputs; at the chunk the kernel runs (128), at 64
and 256, and at small chunks, so that short sequences span many chunks.

Tolerances, max |got − want| ≤ tol·(1 + max|want|), a ∈ [0.5, 1]: the
forward at 1e-6 (the kernel check's TOL_SCAN: the carry reaches a step
through P_t, not step by step), the backward at 1e-5 (the kernel check's
TOL_SCAN_BWD; the reference's associative scans sum in other orders).
"""
import _torch_threads  # noqa: F401
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as jax_rglru
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import rglru_scan as t_rg

# the module (``repro.kernels`` exports a function of the same name)
jax_kernel = importlib.import_module("repro.kernels.rglru_scan")

TOL_FWD = 1e-6
TOL_BWD = 1e-5


def _inputs(b, s, w, seed):
    """a ∈ [0.5, 1], u, h0 and an incoming gradient as f32 numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.uniform(0.5, 1.0, (b, s, w)).astype(f),
            rng.standard_normal((b, s, w)).astype(f),
            rng.standard_normal((b, w)).astype(f),
            rng.standard_normal((b, s, w)).astype(f))


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * (1 + np.abs(want).max()), (what, err)


def _t(x):
    return torch.tensor(np.asarray(x))


def _fold_h0(a, u, h0):
    """u with a carried state folded into its first step, as the model
    folds it (u_0 ← u_0 + a_0·h0)."""
    u = u.copy()
    u[:, 0] += a[:, 0] * h0
    return u


# (B, S, W, chunk): ragged S and W, S one chunk and under a chunk, many
# chunks; the kernel's chunk (t_rg.CHUNK) and others
CASES = [(2, 300, 7, t_rg.CHUNK), (1, 1000, 33, t_rg.CHUNK),
         (3, 129, 5, t_rg.CHUNK), (2, 128, 3, t_rg.CHUNK),
         (1, 17, 4, t_rg.CHUNK), (2, 257, 9, 64), (2, 100, 6, 8),
         (1, 37, 3, 16), (1, 1, 1, 8)]


@pytest.mark.parametrize("b,s,w,chunk", CASES)
def test_chunked_matches_the_step_by_step_scan(b, s, w, chunk):
    a, u, _, _ = _inputs(b, s, w, seed=s + w)
    want = t_ref.rglru_ref(_t(a), _t(u))
    _close(t_ref.rglru_chunked(_t(a), _t(u), chunk), want, TOL_FWD)


@pytest.mark.parametrize("b,s,w,chunk", [(2, 256, 8, t_rg.CHUNK),
                                         (1, 512, 16, 64), (2, 64, 5, 8),
                                         (1, 256, 3, 256)])
def test_chunked_matches_the_pallas_kernel(b, s, w, chunk):
    """The JAX package's kernel at the same chunk (its chunks run in order,
    a doubling scan inside each), where the chunk divides S."""
    a, u, _, _ = _inputs(b, s, w, seed=3 * s + w)
    want = jax_kernel.rglru_scan_b(jnp.asarray(a), jnp.asarray(u),
                                   chunk=chunk, interpret=True)
    _close(t_ref.rglru_chunked(_t(a), _t(u), chunk), want, TOL_FWD)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,w,chunk", [(2, 300, 7, t_rg.CHUNK),
                                         (1, 1000, 33, t_rg.CHUNK),
                                         (3, 77, 5, 16), (2, 257, 9, 64)])
def test_chunked_matches_the_reference_models_scan(b, s, w, chunk, with_h0):
    """``repro.models.rglru.rglru_scan`` (an associative scan in chunks of
    256, padded at a ragged S) from zero, and from a carried h0 that the
    port folds into u_0 before the launch."""
    a, u, h0, _ = _inputs(b, s, w, seed=s * w)
    if with_h0:
        want, want_fin = jax_rglru.rglru_scan(jnp.asarray(a), jnp.asarray(u),
                                              jnp.asarray(h0))
        u = _fold_h0(a, u, h0)
    else:
        want, want_fin = jax_rglru.rglru_scan(jnp.asarray(a), jnp.asarray(u))
    got = t_ref.rglru_chunked(_t(a), _t(u), chunk)
    _close(got, want, TOL_FWD, "h")
    _close(got[:, -1], want_fin, TOL_FWD, "final state")


@pytest.mark.parametrize("b,s,w,chunk", CASES)
def test_backward_scan_matches_the_plain_backward(b, s, w, chunk):
    a, u, _, dh = _inputs(b, s, w, seed=s + 2 * w)
    h = t_ref.rglru_ref(_t(a), _t(u))
    want = t_ref.rglru_bwd_ref(_t(a), h, _t(dh))
    got = t_ref.rglru_bwd_scan(_t(a), h, _t(dh), chunk)
    for name, g, wnt in zip(("da", "du"), got, want):
        _close(g, wnt, TOL_BWD, name)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,w,chunk", [(2, 300, 7, t_rg.CHUNK),
                                         (1, 129, 33, t_rg.CHUNK),
                                         (3, 77, 5, 16), (2, 257, 9, 64)])
def test_backward_scan_matches_jax_vjp(b, s, w, chunk, with_h0):
    """``jax.vjp`` of the reference model's scan in a and u.  With a carried
    h0 the port differentiates through the fold u_0 + a_0·h0: da_0 gains
    du_0·h0 and dh0 = a_0·du_0."""
    a, u, h0, dh = _inputs(b, s, w, seed=7 * s + w)
    if with_h0:
        _, vjp = jax.vjp(lambda a, u, h0: jax_rglru.rglru_scan(a, u, h0)[0],
                         jnp.asarray(a), jnp.asarray(u), jnp.asarray(h0))
        want_da, want_du, want_dh0 = vjp(jnp.asarray(dh))
        uf = _fold_h0(a, u, h0)
    else:
        _, vjp = jax.vjp(lambda a, u: jax_rglru.rglru_scan(a, u)[0],
                         jnp.asarray(a), jnp.asarray(u))
        want_da, want_du = vjp(jnp.asarray(dh))
        uf = u
    h = t_ref.rglru_ref(_t(a), _t(uf))
    da, du = t_ref.rglru_bwd_scan(_t(a), h, _t(dh), chunk)
    if with_h0:
        da[:, 0] += du[:, 0] * _t(h0)
        _close(_t(a)[:, 0] * du[:, 0], want_dh0, TOL_BWD, "dh0")
    _close(da, want_da, TOL_BWD, "da")
    _close(du, want_du, TOL_BWD, "du")


@pytest.mark.parametrize("b,s,w", [(4, 4096, 4096), (1, 32768, 4096),
                                   (8, 128, 4096), (1, 4096, 2048),
                                   (3, 300, 130), (1, 1, 1)])
def test_workspace_holds_the_look_back_state(b, s, w):
    """One flag a tile in 16-byte pieces after the 16-byte ticket, then the
    three (tiles, 32) f32 arrays (``carve`` in the source)."""
    t = -(-s // t_rg.CHUNK) * b * -(-w // 32)
    assert t_rg.work_bytes(b, s, w) == 16 + 16 * -(-t // 4) + 384 * t
    assert t_rg.work_bytes(b, s, w) % 16 == 0


def test_chunks_must_be_whole_runs():
    a = torch.ones((1, 10, 2))
    with pytest.raises(ValueError, match="runs"):
        t_ref.rglru_chunked(a, a, 12)
    torch.testing.assert_close(t_ref.rglru_chunked(a, a, 12, runs=4),
                               t_ref.rglru_ref(a, a), rtol=0, atol=0)
