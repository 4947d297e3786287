"""Per-round samplers (port of ``repro.engine.sampler:56-105``).

A sampler is ``(round_idx) -> (batches, noise)``, or ``(batches, noise,
extras)`` with :func:`with_topology`: exactly what ``round_step`` eats.  The noise is drawn on the device from a
``torch.Generator`` seeded ``seed * 7919 + round`` — the reference's key
schedule, on another generator — so any round's draw is reproducible in
isolation.
"""
from __future__ import annotations

import torch


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
