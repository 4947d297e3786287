"""Per-round samplers (port of ``repro.engine.sampler``).

A sampler is ``(round_idx) -> (batches, noise)``, or ``(batches, noise,
extras)`` with :func:`with_topology`: exactly what ``round_step`` eats.
Every draw comes from a ``torch.Generator`` seeded from the round index
(the reference folds it into a key), so any round's draw is reproducible
in isolation and a run resumed from a checkpoint redraws the same data.
The engine makes a round's draws before it replays a captured chunk, into
the graph's static buffers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.data import synthetic as data_lib


def stream_seed(*parts: int) -> int:
    """A 63-bit generator seed from a tuple of ints (seed, stream, round,
    ...): distinct tuples give unrelated streams."""
    words = np.random.SeedSequence([int(p) for p in parts]).generate_state(2)
    return int((int(words[0]) << 31) ^ int(words[1])) & (2**63 - 1)


def make_dro_sampler(dm: data_lib.DataModel, seed: int, *, local_steps: int,
                     num_clients: int, per_client_batch: int, seq_len: int,
                     cfg=None):
    """Sampler over a heterogeneous synthetic ``DataModel`` (reference :26):
    round t's batches for a model of ``cfg`` (its codebook streams and
    prefix embeddings, ``data.synthetic.round_batches``), stacked
    (K, n, B, S…), come from a generator on the data model's device seeded
    ``stream_seed(seed, t)``; the noise is (K, n, 0), since the data batch
    is the only source of randomness of the DRO and adversarial
    problems."""
    dev = dm.domain_logits.device
    gen = torch.Generator(device=dev)

    def sample(round_idx: int):
        gen.manual_seed(stream_seed(seed, int(round_idx)))
        batches = data_lib.round_batches(
            dm, gen, local_steps=local_steps, num_clients=num_clients,
            per_client_batch=per_client_batch, seq_len=seq_len, cfg=cfg)
        return batches, torch.zeros((local_steps, num_clients, 0),
                                    device=dev)

    return sample


def slice_clients(sampler, lo: int, hi: int):
    """A sampler of one rank of the decentralized mesh: ``sampler``'s
    round, (K, n, …) batches and noise, cut to the rank's client rows
    ``[lo, hi)``.  Every rank draws the whole round from the host path's
    generator, which costs n/(hi − lo) times the draws, so that the mesh
    trains on exactly the host path's data."""

    def sample(round_idx: int):
        sampled = sampler(round_idx)
        if len(sampled) > 2:
            raise ValueError("slice_clients: per-round extras (W, mask, "
                             "adversary) do not ride the mesh")
        batches, noise = sampled
        return ({k: v[:, lo:hi].contiguous() for k, v in batches.items()},
                noise[:, lo:hi].contiguous())

    return sample


def held_out_eval_batch(dm: data_lib.DataModel, generator: torch.Generator,
                        *, num_clients: int, per_client_batch: int,
                        seq_len: int, cfg=None):
    """One fixed client-balanced eval batch (reference :108) for a model of
    ``cfg``, drawn once from ``generator`` (never from the training
    stream): one ``per_client_batch`` draw per client distribution,
    flattened to (n·B, S…)."""
    rb = data_lib.round_batches(
        dm, generator, local_steps=1, num_clients=num_clients,
        per_client_batch=per_client_batch, seq_len=seq_len, cfg=cfg)
    return flatten_clients(rb)


def flatten_clients(round_batch):
    """(1, n, B, S…) batches -> (n·B, S…)."""
    return {k: v.reshape((v.shape[1] * v.shape[2],) + tuple(v.shape[3:]))
            for k, v in round_batch.items()}


def make_fixed_batch_sampler(batches, *, local_steps: int, num_clients: int,
                             noise_dim: int, seed: int = 0, device="cuda"):
    """Sampler over a fixed K-stacked batch (the synthetic quadratic: the
    data is the per-client problem slice, stochasticity enters through the
    oracle noise, (K, n, noise_dim) per round)."""
    gen = torch.Generator(device=device)

    def sample(round_idx: int):
        gen.manual_seed(seed * 7919 + int(round_idx))
        noise = torch.randn((local_steps, num_clients, noise_dim),
                            generator=gen, device=device)
        return batches, noise

    return sample


def with_topology(sampler, *, w_fn=None, mask_fn=None, attack_fn=None):
    """Rides the churn and adversary axes on the engine's sampler slot:
    each round also draws that round's mixing matrix, participation mask
    and/or Byzantine adversary (pure functions of the round index, e.g.
    ``core.stochastic_topology``, ``core.sparse_topology`` or
    ``core.adversary`` samplers).

    The wrapped sampler returns ``(batches, noise, extras)``; the engine
    splats ``extras`` into ``round_step(state, batches, noise, *extras)`` in
    the order (W, mask, adversary) — ``make_round_step(traced_w=...,
    participation=..., byzantine=...)``'s order.
    """
    fns = tuple(f for f in (w_fn, mask_fn, attack_fn) if f is not None)
    if not fns:
        raise ValueError(
            "with_topology needs w_fn, mask_fn, and/or attack_fn")

    def sample(round_idx: int):
        sampled = sampler(round_idx)
        if len(sampled) > 2:
            raise ValueError(
                "with_topology: the wrapped sampler already returns extras; "
                "compose all per-round draws into a single wrapper instead "
                "of nesting (the inner draws would be silently dropped)")
        batches, noise = sampled
        return batches, noise, tuple(f(round_idx) for f in fns)

    return sample
