"""Synthetic heterogeneous federated token data (port of
``repro.data.synthetic``).

Each of G *domains* has its own unigram model plus a distinct bigram
shift; each client draws sequences from a client-specific Dirichlet(alpha)
mixture over domains.  ``alpha`` sets inter-client heterogeneity (alpha →
0: disjoint domains per client; alpha → ∞: iid clients).  Group labels (the
domain of each sequence) feed the per-group losses.

Draws come from an explicit ``torch.Generator``, whose numbers differ from
``jax.random``'s for the same seed.  So the step from the draws to a batch
(``batch_from_draws``: the bigram blend of reference :97-106) is a pure
function of the draws (g, first, use_bigram), and the parity test feeds it
the reference's own draws; the sampler itself is held to the mixtures
statistically.  An audio model's C codebook streams have no bigram
blend: C unigram draws a position from the sequence's domain, each label
(token + the domain's shift) mod V of the next position
(``codebook_batch_from_draws``, reference :88-95).  ``round_batches``
stacks a round's batches (K, n, B, S…) from the same sampler
(``stack_round`` alone is what the parity tests feed the reference's
draws through), with a vision-language model's (B, P, d) prefix
embeddings, 0.02·N(0, 1), beside each (reference :124-128).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataModel:
    domain_logits: torch.Tensor    # (G, V) unigram logits per domain
    domain_shift: torch.Tensor     # (G,) bigram shift per domain
    mixtures: torch.Tensor         # (n_clients, G) client domain mixtures
    vocab_size: int
    num_groups: int


def make_data_model(generator: Optional[torch.Generator] = None, *,
                    vocab_size: int, num_groups: int = 8,
                    num_clients: int = 4, alpha: float = 0.3,
                    sharpness: float = 2.0, seed: int = 0,
                    device="cpu") -> DataModel:
    """The reference's distributions (``make_data_model``, :46): logits
    sharpness·N(0, 1) over min(V, 4096) tokens, tiled to V with a 0.01·N(0, 1)
    offset per domain; shifts uniform in [1, max(2, V // 7)); Dirichlet(alpha)
    mixtures.  Drawn from ``generator`` (a CPU one seeded with ``seed`` when
    None) and placed on ``device``."""
    gen = generator
    if gen is None:
        gen = torch.Generator()
        gen.manual_seed(seed)
    kw = dict(generator=gen, device=gen.device)
    logits = sharpness * torch.randn((num_groups, min(vocab_size, 4096)), **kw)
    if vocab_size > 4096:  # tile to the full vocab, cheap + deterministic
        reps = -(-vocab_size // 4096)
        logits = logits.repeat(1, reps)[:, :vocab_size]
        logits = logits + 0.01 * torch.randn((num_groups, 1), **kw)
    shift = torch.randint(1, max(2, vocab_size // 7), (num_groups,), **kw)
    mix = torch._sample_dirichlet(
        torch.full((num_clients, num_groups), float(alpha),
                   device=gen.device), generator=gen)
    return DataModel(domain_logits=logits.to(device),
                     domain_shift=shift.to(device), mixtures=mix.to(device),
                     vocab_size=vocab_size, num_groups=num_groups)


def batch_from_draws(dm: DataModel, g, first, use_bigram) -> Dict[str, torch.Tensor]:
    """One batch from its draws: g (B,) the domain of each sequence; first
    (B, S + 1) unigram tokens; use_bigram (B, S + 1) bool.  Each position
    takes (previous unigram token + the domain's shift) mod V where
    use_bigram holds, else its unigram token (reference :97-106).  Returns
    {"tokens", "labels" (next tokens), "groups"}, each (B, S) int64."""
    shift = dm.domain_shift[g][:, None]
    prev = torch.roll(first, 1, dims=1)
    prev[:, 0] = first[:, 0]
    seq = torch.where(use_bigram, (prev + shift) % dm.vocab_size, first)
    b, s = seq.shape[0], seq.shape[1] - 1
    return {"tokens": seq[:, :-1], "labels": seq[:, 1:],
            "groups": g[:, None].expand(b, s).long()}


def codebook_batch_from_draws(dm: DataModel, g, toks
                              ) -> Dict[str, torch.Tensor]:
    """One multi-codebook batch from its draws: g (B,) the domain of each
    sequence; toks (B, S + 1, C) unigram tokens of each codebook.  Returns
    {"tokens" (B, S, C), "labels" (B, S, C): (next token + the domain's
    shift) mod V, "groups" (B, S)}, int64 (reference :88-95)."""
    shift = dm.domain_shift[g][:, None, None]
    labels_full = (toks + shift) % dm.vocab_size
    b, s = toks.shape[0], toks.shape[1] - 1
    return {"tokens": toks[:, :-1], "labels": labels_full[:, 1:],
            "groups": g[:, None].expand(b, s).long()}


def sample_client_batch(dm: DataModel, generator: torch.Generator,
                        client: int, batch: int, seq_len: int,
                        num_codebooks: int = 0) -> Dict[str, torch.Tensor]:
    """One client's batch, drawn on the generator's device (where ``dm``
    lies): each sequence's domain from the client's mixture, seq_len + 1
    unigram tokens from the domain's logits, and a fair coin per position
    for the bigram blend (``batch_from_draws``); with ``num_codebooks`` C,
    C unigram tokens a position instead, and no blend
    (``codebook_batch_from_draws``)."""
    g = torch.multinomial(dm.mixtures[client] + 1e-9, batch, replacement=True,
                          generator=generator)
    probs = torch.softmax(dm.domain_logits[g], dim=-1)
    if num_codebooks:
        toks = torch.multinomial(probs, num_codebooks * (seq_len + 1),
                                 replacement=True, generator=generator)
        toks = toks.reshape(batch, num_codebooks, seq_len + 1).transpose(
            1, 2)
        return codebook_batch_from_draws(dm, g, toks)
    first = torch.multinomial(probs, seq_len + 1, replacement=True,
                              generator=generator)
    use_bigram = torch.rand(first.shape, generator=generator,
                            device=first.device) < 0.5
    return batch_from_draws(dm, g, first, use_bigram)


def prefix_embeddings(generator: torch.Generator, batch: int,
                      cfg: ModelConfig) -> torch.Tensor:
    """A batch's stub vision embeddings: 0.02·N(0, 1) of shape (B, P, d)
    (reference :124-128), on the generator's device."""
    return 0.02 * torch.randn((batch, cfg.num_prefix_tokens, cfg.d_model),
                              generator=generator, device=generator.device)


def stack_round(batches: List[List[Dict[str, torch.Tensor]]]
                ) -> Dict[str, torch.Tensor]:
    """[[batch of client i at local step k for i] for k] -> one dict of
    (K, n, B, S…) tensors, the layout the round step eats."""
    return {name: torch.stack([torch.stack([b[name] for b in step])
                               for step in batches])
            for name in batches[0][0]}


def round_batches(dm: DataModel, generator: torch.Generator, *,
                  local_steps: int, num_clients: int, per_client_batch: int,
                  seq_len: int, cfg: Optional[ModelConfig] = None
                  ) -> Dict[str, torch.Tensor]:
    """One round's batches (reference :108): for each local step k and
    client i, ``sample_client_batch`` of client i from ``generator`` — its
    codebook streams where ``cfg`` has codebooks — and its
    ``prefix_embeddings`` where ``cfg`` has prefix tokens, stacked
    (K, n, B, S…)."""
    ncb = cfg.num_codebooks if cfg is not None else 0

    def one(i):
        b = sample_client_batch(dm, generator, i, per_client_batch, seq_len,
                                ncb)
        if cfg is not None and cfg.num_prefix_tokens:
            b["prefix"] = prefix_embeddings(generator, per_client_batch, cfg)
        return b

    return stack_round([[one(i) for i in range(num_clients)]
                        for _ in range(local_steps)])


def heterogeneity_index(dm: DataModel) -> float:
    """Mean pairwise TV distance between client mixtures (0 = iid clients)."""
    m = dm.mixtures
    n = m.shape[0]
    tv = 0.5 * (m[:, None, :] - m[None, :, :]).abs().sum(-1)
    return float(tv.sum() / (n * (n - 1) + 1e-9))
