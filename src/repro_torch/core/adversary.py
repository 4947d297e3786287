"""Byzantine clients: per-round attacker models riding the extras protocol
(port of ``repro.core.adversary``).

The adversary is a per-round draw, an :class:`Adversary` carrying the
per-client attacker-id vector, the attack scale and this round's noise,
made by a sampler that is a pure function of the round index (stream
:data:`ATTACK_STREAM`, disjoint from ``W_STREAM`` / ``MASK_STREAM``), so a
checkpoint restored at round r replays the identical attack sequence.

Attack models (:data:`ATTACKS`), applied to the attacker's *outgoing* Δ
(``kgt_minimax.make_round_step(byzantine=True)`` corrupts Δ right after
the local steps, before the correction and the mixing consume it):

* ``honest`` (id 0) — no corruption; honest rows pass through
  :func:`apply_attack` bit for bit whatever other ids are present;
* ``sign_flip`` (id 1) — sends ``−scale·Δ``;
* ``large_norm`` (id 2) — sends the constant ``LARGE_NORM·scale``;
* ``random_noise`` (id 3) — sends ``scale·N(0, I)``.

The reference draws the noise inside the round step from the round's key.
A captured engine chunk cannot re-seed a generator per round, so here the
sampler draws it: one N(0, I) tensor per variable (stream 0 for x, 1 for
y) and leaf, each from a generator seeded as a pure function of (seed,
round, ATTACK_STREAM, stream, leaf), carried in ``Adversary.noise``.
:func:`apply_attack` reads it and never draws.  The draws are the port's
own; parity tests feed the reference's draws in as arrays.

The attacker follows the protocol with its corrupted Δ, so under any
doubly stochastic W Σᵢcᵢ = 0 survives every attack; defending takes a
robust ``mixing_impl`` (``core.mixing.ROBUST_IMPLS``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core import tree as tree_lib

ATTACKS = ("honest", "sign_flip", "large_norm", "random_noise")
ATTACK_IDS = {name: i for i, name in enumerate(ATTACKS)}

# stream id of the per-round attack-noise draw: disjoint from the W / mask
# streams (1717 / 2929)
ATTACK_STREAM = 4242

# the large_norm attack's per-coordinate magnitude (× attack scale)
LARGE_NORM = 100.0


@dataclasses.dataclass
class Adversary:
    """One round's adversary, carried as a round-step extra.  A dataclass,
    so ``core.tree`` flattens it and the engine's draw buffers carry it."""
    ids: torch.Tensor     # (n,) int32 per-client attack id (0 = honest)
    scale: torch.Tensor   # f32 scalar attack magnitude multiplier
    # this round's N(0, I) draws, (x leaves, y leaves) shaped as the
    # variables' leaves; None when no client carries the random_noise id
    noise: Any = None


def attack_ids(n: int, num_byzantine: int, attack_id: int,
               device="cuda") -> torch.Tensor:
    """(n,) int32 attacker-id vector: the first ``num_byzantine`` client
    slots carry ``attack_id``, the rest are honest (0)."""
    idx = torch.arange(n, dtype=torch.int32, device=device)
    return (idx < int(num_byzantine)).to(torch.int32) * int(attack_id)


def _draw_noise(gen: torch.Generator, seed: int, round_idx: int, shapes,
                device):
    """The round's noise: per variable stream s and leaf i of ``shapes``,
    an N(0, I) tensor from ``gen`` re-seeded as a pure function of (seed,
    round, ATTACK_STREAM, s, i) — distinct for every such tuple with
    round < 10⁶, s < 2 and i < 65537."""
    def draw(s, i, shape):
        gen.manual_seed(((((int(seed) * 1_000_003 + int(round_idx)) * 8191
                           + ATTACK_STREAM) * 2 + s) * 65537 + i) % (1 << 63))
        return torch.randn(shape, generator=gen, device=device)

    return tuple(tuple(draw(s, i, shape) for i, shape in enumerate(var))
                 for s, var in enumerate(shapes))


def make_attack_sampler(n: int, seed: int, *, num_byzantine: int,
                        attack: str = "sign_flip", scale=1.0, like=None,
                        device="cuda") -> Callable[[int], Adversary]:
    """``attack_fn(round_idx) -> Adversary`` for the engine's sampler slot
    (``engine.sampler.with_topology(attack_fn=...)``).  The attacker set
    is fixed across rounds (the first ``num_byzantine`` clients), and so
    are the ids and scale tensors; the random_noise attack draws its noise
    per round, shaped as the leaves of ``like = (x, y)`` (a state's
    variables)."""
    if attack not in ATTACK_IDS:
        raise ValueError(f"unknown attack {attack!r}: {ATTACKS}")
    ids = attack_ids(n, num_byzantine, ATTACK_IDS[attack], device=device)
    sc = torch.tensor(float(scale), dtype=torch.float32, device=device)
    if attack != "random_noise" or int(num_byzantine) <= 0:
        adv = Adversary(ids=ids, scale=sc)
        return lambda round_idx: adv
    if like is None:
        raise ValueError("the random_noise attack draws noise shaped as the "
                         "variables: pass like=(x, y)")
    shapes = [[tuple(leaf.shape) for leaf in tree_lib.leaves(v)]
              for v in like]
    gen = torch.Generator(device=device)
    return lambda round_idx: Adversary(
        ids=ids, scale=sc,
        noise=_draw_noise(gen, seed, round_idx, shapes, device))


def _client_broadcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape(v.shape + (1,) * (ndim - 1))


def apply_attack(adv: Adversary, tree, *, stream: int = 0):
    """Corrupt the per-client (n, …) leaves of ``tree`` per ``adv.ids``.

    Honest rows (id 0) pass through bit for bit.  ``stream`` selects the
    variable's noise (0 for Δx, 1 for Δy); leaf i takes the stream's i-th
    noise tensor.  Makes no draw and no host sync.
    """
    leaves, treedef = tree_lib.flatten(tree)
    scale = adv.scale.to(torch.float32)
    noise: Optional[tuple] = None if adv.noise is None else adv.noise[stream]

    def one(i, x):
        m = _client_broadcast(adv.ids, x.dim())
        x32 = x.to(torch.float32)
        out = torch.where(m == 1, -scale * x32, x32)
        out = torch.where(m == 2, (LARGE_NORM * scale).expand(x.shape), out)
        if noise is not None:
            out = torch.where(m == 3, scale * noise[i], out)
        return out.to(x.dtype)

    return tree_lib.unflatten(treedef,
                              [one(i, x) for i, x in enumerate(leaves)])
