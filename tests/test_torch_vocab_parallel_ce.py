"""B6's vocab-parallel form in one process: the vocabulary split into 2 or
3 uneven pieces, each piece's per-token partials (``ref.ce_partials_ref``:
the running max m, the exp-sum l under it, the label's logit z where the
label falls in the piece) merged as the model ranks merge them (M = max m,
L = Σ l·e^(m − M), Z = Σ z, nll = M + log L − Z), against the whole
vocabulary's ``ref.fused_ce_ref`` and the JAX package's ``fused_ce_nd`` in
interpret mode; the merged NLL's gradients (plain autograd, and
``VocabParallelCEFn``'s backward with the plain partials swapped in for
its launch, under ``vmap`` too) against the whole vocabulary's.

Tolerance, stated before the first reading: max |got − want| ≤ 1e-6·(1 +
max|want|) in f32 (TOL).
"""
import _torch_threads  # noqa: F401
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.kernels import cross_entropy as jax_ce
from repro_torch.dist import tensor_parallel as tp
from repro_torch.kernels import cross_entropy as t_ce
from repro_torch.kernels import ops, ref

TOL = 1e-6
N, D, V = 37, 24, 101
SPLITS = {2: (51, 50), 3: (34, 34, 33)}


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= TOL * (1 + np.abs(want).max()), (what, err)


def _operands(seed=0, n=N):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, D)).astype(np.float32)
    w = (0.5 * rng.standard_normal((V, D))).astype(np.float32)
    lab = rng.integers(0, V, n).astype(np.int64)
    return h, w, lab


def _bounds(widths):
    lo = np.cumsum((0,) + widths[:-1])
    return [(int(a), int(a + b)) for a, b in zip(lo, widths)]


def _merge_plain(parts):
    """The model ranks' merge of every piece's (m, l, z), in one
    process."""
    ms = torch.stack([p[0] for p in parts])
    big = ms.max(0).values.detach()
    big_l = sum(p[1] * torch.exp(p[0] - big) for p in parts)
    big_z = sum(p[2] for p in parts)
    return big, big_l, big_z


def _pieces_nll(h, w, lab, widths):
    parts = [ref.ce_partials_ref(h, w[lo:hi], lab - lo)
             for lo, hi in _bounds(widths)]
    return ref.merge_nll(*_merge_plain(parts))


@pytest.mark.parametrize("pieces", sorted(SPLITS))
def test_merged_partials_are_the_whole_vocabularys_nll(pieces):
    h, w, lab = _operands()
    got = _pieces_nll(torch.tensor(h), torch.tensor(w), torch.tensor(lab),
                      SPLITS[pieces])
    _close(got.numpy(), ref.fused_ce_ref(torch.tensor(h), torch.tensor(w),
                                         torch.tensor(lab)).numpy(), "ref")
    want = jax_ce.fused_ce_nd(jnp.asarray(h), jnp.asarray(w),
                              jnp.asarray(lab.astype(np.int32)),
                              interpret=True)
    _close(got.numpy(), np.asarray(want), "jax")


def test_a_label_outside_the_piece_has_no_logit():
    h, w, lab = (torch.tensor(a) for a in _operands())
    lo, hi = 40, 60
    m, l, z = ref.ce_partials_ref(h, w[lo:hi], lab - lo)
    logits = h @ w[lo:hi].T
    inside = (lab >= lo) & (lab < hi)
    assert torch.equal(z[~inside], torch.zeros(int((~inside).sum())))
    _close(z[inside].numpy(),
           logits[inside].gather(1, (lab[inside] - lo)[:, None])[:, 0]
           .numpy(), "z")
    _close(m.numpy(), logits.max(1).values.numpy(), "m")
    _close(l.numpy(), torch.exp(logits - m[:, None]).sum(1).numpy(), "l")


def _jax_grads(h, w, lab):
    def loss(h_, w_):
        logp = jax.nn.log_softmax(h_ @ w_.T, axis=-1)
        nll = -jnp.take_along_axis(logp, jnp.asarray(lab)[:, None], 1)[:, 0]
        return jnp.sum(nll * jnp.linspace(0.5, 1.5, h_.shape[0]))

    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))


@pytest.mark.parametrize("pieces", sorted(SPLITS))
def test_merged_nll_gradients_are_the_whole_vocabularys(pieces):
    """Plain autograd through every piece's partials and the merge (the
    max taken without a gradient) against ``ref.fused_ce_ref``'s autograd
    and ``jax.grad`` of the log-softmax NLL."""
    h, w, lab = _operands()
    weights = torch.linspace(0.5, 1.5, N)
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    (_pieces_nll(th, tw, torch.tensor(lab), SPLITS[pieces])
     * weights).sum().backward()
    wh = torch.tensor(h, requires_grad=True)
    ww = torch.tensor(w, requires_grad=True)
    (ref.fused_ce_ref(wh, ww, torch.tensor(lab)) * weights).sum().backward()
    _close(th.grad.numpy(), wh.grad.numpy(), "g_hidden")
    _close(tw.grad.numpy(), ww.grad.numpy(), "g_weight")
    jh, jw = _jax_grads(h, w, lab)
    _close(th.grad.numpy(), np.asarray(jh), "g_hidden jax")
    _close(tw.grad.numpy(), np.asarray(jw), "g_weight jax")


class _Merge:
    """The merge of one piece's partials with the other pieces',
    precomputed: what ``tensor_parallel.merge_partials`` gives the rank of
    piece ``r`` over the model axis."""

    def __init__(self, others):
        self.others = others

    def __call__(self, m, l, z):
        return _merge_plain([(m, l, z)] + self.others)


def _function_route():
    """``VocabParallelCEFn`` on CPU tensors: its launch the plain
    partials, counted."""
    calls = [0]

    def launch(h, w, lab):
        calls[0] += 1
        return ref.ce_partials_ref(h, w, lab)

    return calls, mock.patch.object(t_ce.VocabParallelCEFn, "launch",
                                    staticmethod(launch))


@pytest.mark.parametrize("pieces", sorted(SPLITS))
def test_the_function_is_the_plain_route(pieces):
    """Each piece's ``VocabParallelCEFn``, the others' partials merged in:
    its NLL and its gradient (the piece's own rows of the head, its part
    of the hidden gradient; the parts summed over the pieces) against the
    whole vocabulary's."""
    h, w, lab = (torch.tensor(a) for a in _operands())
    bounds = _bounds(SPLITS[pieces])
    parts = [ref.ce_partials_ref(h, w[lo:hi], lab - lo) for lo, hi in bounds]
    weights = torch.linspace(0.5, 1.5, N)
    wh = h.clone().requires_grad_(True)
    ww = w.clone().requires_grad_(True)
    want = ref.fused_ce_ref(wh, ww, lab)
    (want * weights).sum().backward()
    calls, patch = _function_route()
    gh = torch.zeros_like(h)
    with patch:
        for r, (lo, hi) in enumerate(bounds):
            th = h.clone().requires_grad_(True)
            tw = w[lo:hi].clone().requires_grad_(True)
            merge = _Merge([p for i, p in enumerate(parts) if i != r])
            nll, _ = t_ce.VocabParallelCEFn.apply(th, tw, lab - lo, merge)
            _close(nll.detach().numpy(), want.detach().numpy(), "nll")
            (nll * weights).sum().backward()
            _close(tw.grad.numpy(), ww.grad[lo:hi].numpy(), "g_weight")
            gh += th.grad
    _close(gh.numpy(), wh.grad.numpy(), "g_hidden")
    assert calls[0] == pieces


def test_the_function_launches_once_a_client_under_vmap():
    """Two clients, each its own head, under ``vmap(grad)`` on a model
    axis of one rank (the piece is the whole vocabulary, the merge the
    identity): one launch a client, and each client's gradient the whole
    vocabulary's."""
    hs, ws, labs = (torch.stack([torch.tensor(_operands(seed, n=9)[i])
                                 for seed in (1, 2)]) for i in range(3))

    def loss(w, h, lab):
        nll, _ = t_ce.VocabParallelCEFn.apply(h, w, lab,
                                              lambda m, l, z: (m, l, z))
        return (nll * torch.linspace(0.5, 1.5, h.shape[0])).sum()

    calls, patch = _function_route()
    with patch:
        got = vmap(grad(loss))(ws, hs, labs)
    assert calls[0] == 2
    for c in range(2):
        w = ws[c].clone().requires_grad_(True)
        (ref.fused_ce_ref(hs[c], w, labs[c])
         * torch.linspace(0.5, 1.5, 9)).sum().backward()
        _close(got[c].numpy(), w.grad.numpy(), f"client {c}")


def test_ops_routes_cpu_tensors_to_the_plain_partials():
    """``ops.vocab_parallel_cross_entropy`` on CPU tensors: the plain
    partials merged, under autograd (no Function, no launch)."""
    h, w, lab = (torch.tensor(a) for a in _operands())
    lo, hi = _bounds(SPLITS[2])[1]
    rest = ref.ce_partials_ref(h, w[:lo], lab)
    calls, patch = _function_route()
    with patch:
        got = ops.vocab_parallel_cross_entropy(h, w[lo:hi], lab - lo,
                                               _Merge([rest]))
    assert calls[0] == 0
    _close(got.numpy(), ref.fused_ce_ref(h, w, lab).numpy(), "nll")


def test_merge_partials_on_one_rank_is_the_pieces_own():
    """``tensor_parallel.merge_partials`` over a model axis of one rank:
    (m, l, z) themselves."""
    from repro_torch.dist import collectives

    h, w, lab = (torch.tensor(a) for a in _operands())
    m, l, z = ref.ce_partials_ref(h, w, lab)
    big, big_l, big_z = tp.merge_partials(m, l, z,
                                          collectives.MeshAxis(0, 1))
    assert torch.equal(big, m) and torch.equal(big_z, z)
    _close(big_l.numpy(), l.numpy())
