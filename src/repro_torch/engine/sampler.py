"""Per-round samplers (port of ``repro.engine.sampler:56-73``).

A sampler is ``(round_idx) -> (batches, noise)``: exactly what
``round_step`` eats.  The noise is drawn on the device from a
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
