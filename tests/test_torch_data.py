"""The port's synthetic federated data (``repro_torch.data.synthetic``)
against the JAX package's.

``torch.Generator`` cannot replay ``jax.random``'s draws, so: the step from
the draws to a batch (``batch_from_draws``, the bigram blend) is fed the
reference's own draws and must give the reference's batch exactly; the
port's sampler is held to shapes, ranges and next-token labels as
``tests/test_data.py`` holds the reference's, and to the client mixtures
statistically (each group's frequency within 5 standard errors, 5·√(p(1−p)/n),
of its mixture weight).
"""
import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as jax_data
from repro_torch.data import synthetic as t_data

KEY = jax.random.PRNGKey(0)


def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_batch_shapes_and_ranges():
    dm = t_data.make_data_model(vocab_size=512, num_groups=8, num_clients=4,
                                alpha=0.3)
    b = t_data.sample_client_batch(dm, _gen(), client=1, batch=3, seq_len=16)
    for key in ("tokens", "labels", "groups"):
        assert b[key].shape == (3, 16) and b[key].dtype == torch.int64
    assert int(b["tokens"].max()) < 512 and int(b["tokens"].min()) >= 0
    assert int(b["groups"].max()) < 8 and int(b["groups"].min()) >= 0
    # one group a sequence
    assert (b["groups"] == b["groups"][:, :1]).all()


def test_labels_are_the_next_tokens():
    dm = t_data.make_data_model(vocab_size=300, num_groups=4, num_clients=2)
    b = t_data.sample_client_batch(dm, _gen(1), 0, batch=4, seq_len=33)
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])


def _reference_draws(dm, key, client, batch, seq_len):
    """The draws of ``repro.data.synthetic.sample_client_batch`` (:84-103),
    with its keys."""
    kg, kt, kb = jax.random.split(key, 3)
    g = jax.random.categorical(kg, jnp.log(dm.mixtures[client] + 1e-9),
                               shape=(batch,))
    first = jax.random.categorical(kt, dm.domain_logits[g],
                                   shape=(seq_len + 1, batch)).T
    use_bigram = jax.random.bernoulli(kb, 0.5, first.shape)
    return g, first, use_bigram


def _port_model(dm):
    return t_data.DataModel(
        domain_logits=torch.tensor(np.asarray(dm.domain_logits)),
        domain_shift=torch.tensor(np.asarray(dm.domain_shift)).long(),
        mixtures=torch.tensor(np.asarray(dm.mixtures)),
        vocab_size=dm.vocab_size, num_groups=dm.num_groups)


@pytest.mark.parametrize("vocab,client,batch,seq_len",
                         [(512, 1, 3, 16), (64, 0, 5, 40), (5000, 3, 2, 9)])
def test_bigram_blend_on_the_reference_draws_is_the_reference_batch(
        vocab, client, batch, seq_len):
    dm = jax_data.make_data_model(KEY, vocab_size=vocab, num_groups=8,
                                  num_clients=4, alpha=0.3)
    key = jax.random.PRNGKey(vocab + client)
    want = jax_data.sample_client_batch(dm, key, client, batch, seq_len)
    g, first, use = (torch.tensor(np.asarray(a))
                     for a in _reference_draws(dm, key, client, batch,
                                               seq_len))
    got = t_data.batch_from_draws(_port_model(dm), g.long(), first.long(),
                                  use)
    for name in ("tokens", "labels", "groups"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)


def test_group_frequencies_follow_the_mixture():
    dm = t_data.make_data_model(vocab_size=64, num_groups=8, num_clients=4,
                                alpha=0.5, seed=3)
    n = 20000
    for client in range(4):
        b = t_data.sample_client_batch(dm, _gen(10 + client), client,
                                       batch=n, seq_len=1)
        freq = torch.bincount(b["groups"][:, 0], minlength=8).double() / n
        p = dm.mixtures[client].double()
        bound = 5 * torch.sqrt(p * (1 - p) / n) + 1e-9
        assert ((freq - p).abs() <= bound).all(), (client, freq, p)


def test_bigram_positions_take_the_shifted_token():
    """About half the positions are the previous unigram token plus the
    domain's shift: where they are, the next token is predictable."""
    dm = t_data.make_data_model(vocab_size=4096, num_groups=4, num_clients=2,
                                seed=1)
    b = t_data.sample_client_batch(dm, _gen(2), 0, batch=64, seq_len=256)
    shift = dm.domain_shift[b["groups"][:, 0]][:, None]
    hit = (b["tokens"][:, 1:] == (b["tokens"][:, :-1] + shift) % 4096)
    assert 0.2 < float(hit.double().mean()) < 0.6


def test_data_model_distributions():
    v, g = 9000, 8
    dm = t_data.make_data_model(vocab_size=v, num_groups=g, num_clients=5,
                                alpha=0.3, seed=4)
    assert dm.domain_logits.shape == (g, v)
    # tiled past 4096 tokens, with one offset per domain
    assert torch.equal(dm.domain_logits[:, :4096],
                       dm.domain_logits[:, 4096:8192])
    assert ((dm.domain_shift >= 1) & (dm.domain_shift < v // 7)).all()
    assert dm.mixtures.shape == (5, g) and (dm.mixtures >= 0).all()
    torch.testing.assert_close(dm.mixtures.sum(1), torch.ones(5))
    again = t_data.make_data_model(vocab_size=v, num_groups=g, num_clients=5,
                                   alpha=0.3, seed=4)
    assert torch.equal(again.mixtures, dm.mixtures)
    b1 = t_data.sample_client_batch(dm, _gen(7), 2, 2, 8)
    b2 = t_data.sample_client_batch(dm, _gen(7), 2, 2, 8)
    assert torch.equal(b1["tokens"], b2["tokens"])


def test_heterogeneity_index_matches_jax_and_falls_with_alpha():
    dm = jax_data.make_data_model(KEY, vocab_size=128, num_groups=8,
                                  num_clients=6, alpha=0.3)
    assert t_data.heterogeneity_index(_port_model(dm)) == pytest.approx(
        jax_data.heterogeneity_index(dm), rel=1e-6)
    his = [t_data.heterogeneity_index(t_data.make_data_model(
        vocab_size=128, num_groups=8, num_clients=8, alpha=a))
        for a in (0.05, 0.5, 50.0)]
    assert his[0] > his[1] > his[2]
