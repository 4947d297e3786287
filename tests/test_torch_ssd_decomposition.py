"""The segment algebra of kernel B7's tensor-core route, on the CPU.

``repro_torch.kernels.ref.ssd_segmented`` writes out in plain PyTorch what
the tensor-core route of ``csrc/ssd_scan.cu`` computes: the chunks cut into
runs of whole chunks, a state-only pass giving each run's end state from a
zero state and its summed log decay, and a full pass that starts run k from
state0 folded through the earlier runs.  It is held against the chunked
form (``ref.ssd_chunked``, B7's plain version), against the token-by-token
recurrence (``ref.ssd_ref``) and against the JAX package's Pallas kernel
(``repro.kernels.ops.ssd_scan`` with ``backend="interpret"``, as
``tests/test_torch_ssm.py`` runs it), on the same numpy inputs: ragged S,
S shorter than a chunk, state0 on and off, 1 to 4 runs, P and N of 8 and
16.  The cut itself is held against the one the kernel's wrapper makes
(``ssd_scan.segments``).

Tolerance: max |got − want| ≤ 1e-5·(1 + max|want|), the kernel check's
TOL_SSD — the same f32 math summed in another order.
"""
import _torch_threads  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import ssd_scan as t_ssd

TOL = 1e-5


def _inputs(b, s, h, p, n, seed):
    """xdt, loga (< 0, as −exp(A_log)·dt), B, C, state0 as f32 numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, s, h, p)).astype(f) * f(0.5),
            -rng.uniform(0.0, 1.0, (b, s, h)).astype(f),
            rng.standard_normal((b, s, n)).astype(f),
            rng.standard_normal((b, s, n)).astype(f),
            rng.standard_normal((b, h, p, n)).astype(f))


def _close(got, want, what=""):
    got = got.to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= TOL * (1 + np.abs(want).max()), (what, err)


# (B, S, H, P, N, chunk): ragged S, S shorter than a chunk, S one chunk,
# many chunks; P and N of 8 and 16
CASES = [(2, 37, 3, 8, 8, 8), (1, 5, 2, 16, 8, 16), (1, 16, 2, 8, 16, 16),
         (2, 100, 2, 16, 16, 8), (1, 70, 1, 8, 16, 16)]


@pytest.mark.parametrize("segments", [1, 2, 3, 4])
@pytest.mark.parametrize("with_state0", [False, True])
@pytest.mark.parametrize("b,s,h,p,n,chunk", CASES)
def test_segmented_matches_the_chunked_form(b, s, h, p, n, chunk, with_state0,
                                            segments):
    x, la, bm, cm, s0 = _inputs(b, s, h, p, n, seed=s + segments)
    state0 = torch.tensor(s0) if with_state0 else None
    args = (torch.tensor(x), torch.tensor(la), torch.tensor(bm),
            torch.tensor(cm), chunk, state0)
    want_y, want_fin = t_ref.ssd_chunked(*args)
    got_y, got_fin = t_ref.ssd_segmented(*args, segments=segments)
    _close(got_y, want_y, "y")
    _close(got_fin, want_fin, "final state")


@pytest.mark.parametrize("segments", [2, 4])
@pytest.mark.parametrize("b,s,h,p,n,chunk", CASES[:3])
def test_segmented_matches_the_recurrence(b, s, h, p, n, chunk, segments):
    x, la, bm, cm, s0 = _inputs(b, s, h, p, n, seed=3)
    args = [torch.tensor(a) for a in (x, la, bm, cm)]
    want_y, want_fin = t_ref.ssd_ref(*args, torch.tensor(s0))
    got_y, got_fin = t_ref.ssd_segmented(*args, chunk, torch.tensor(s0),
                                         segments=segments)
    _close(got_y, want_y.numpy(), "y")
    _close(got_fin, want_fin.numpy(), "final state")


@pytest.mark.parametrize("segments", [1, 3])
@pytest.mark.parametrize("b,s,h,p,n,chunk", CASES[:4])
def test_segmented_matches_the_pallas_kernel(b, s, h, p, n, chunk, segments):
    """The Pallas kernel (interpret mode) starts from a zero state and
    returns y only."""
    x, la, bm, cm, _ = _inputs(b, s, h, p, n, seed=7 + s)
    want = jax_ops.ssd_scan(jnp.asarray(x), jnp.asarray(la), jnp.asarray(bm),
                            jnp.asarray(cm), chunk=chunk, backend="interpret")
    got, _ = t_ref.ssd_segmented(torch.tensor(x), torch.tensor(la),
                                 torch.tensor(bm), torch.tensor(cm), chunk,
                                 segments=segments)
    _close(got, want, "y")


def test_a_decay_that_forgets_everything_between_segments():
    """loga far below zero: each run's incoming state is gone by its first
    token's end (exp(D) underflows to 0), and no NaN comes of it."""
    x, la, bm, cm, s0 = _inputs(1, 48, 2, 8, 8, seed=5)
    args = (torch.tensor(x), torch.tensor(la * 300.0), torch.tensor(bm),
            torch.tensor(cm), 8, torch.tensor(s0))
    want_y, want_fin = t_ref.ssd_chunked(*args)
    got_y, got_fin = t_ref.ssd_segmented(*args, segments=3)
    assert torch.isfinite(got_y).all() and torch.isfinite(got_fin).all()
    _close(got_y, want_y, "y")
    _close(got_fin, want_fin, "final state")


def test_an_empty_sequence_returns_state0():
    s0 = torch.randn((1, 2, 8, 8))
    y, fin = t_ref.ssd_segmented(torch.zeros((1, 0, 2, 8)), torch.zeros((1, 0, 2)),
                                 torch.zeros((1, 0, 8)), torch.zeros((1, 0, 8)),
                                 16, s0, segments=3)
    assert y.shape == (1, 0, 2, 8) and torch.equal(fin, s0)


@pytest.mark.parametrize("chunks", [1, 2, 5, 9, 64, 512, 513])
@pytest.mark.parametrize("batch,heads", [(1, 64), (1, 100), (2, 40), (1, 1),
                                         (8, 64)])
def test_the_kernel_cut_is_the_plain_cut(chunks, batch, heads):
    """``ssd_scan.segments`` (what the wrapper hands the kernel) cuts the
    chunks as ``ssd_segmented`` does for the same number of runs: whole
    chunks, none empty, every chunk in one run."""
    n_seg, per = t_ssd.segments(batch, heads, chunks)
    want = max(1, min(chunks, t_ssd.SLOTS // (batch * heads)))
    chunk = 4
    bounds = t_ref.ssd_segment_bounds(chunks * chunk - 1, chunk, want)
    assert len(bounds) == n_seg
    assert [(e - a) // chunk for a, e in bounds[:-1]] == [per] * (n_seg - 1)
    assert bounds[0][0] == 0 and bounds[-1][1] == chunks * chunk - 1
    assert all(e0 == a1 for (_, e0), (a1, _) in zip(bounds, bounds[1:]))
    assert all(e > a for a, e in bounds)
