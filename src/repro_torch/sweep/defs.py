"""The paper-figure sweeps, encoded as :class:`repro_torch.sweep.grid.GridSpec`\\s
(port of ``repro.sweep.defs``: the same grids, cells and point keys).

Each definition reproduces one of the theory-validation experiments (V2–V5
in DESIGN.md / Theorem 1's scaling terms) as a *grid* rather than a row of
one-off runs: the varied quantity plus a seed-replicate axis, so every
figure point carries error bars.  Axis kinds follow the compilation
boundary — K / topology / n / algorithm change the traced program (static),
seed / heterogeneity / sigma / stepsizes are array leaves (batchable).

``python -m repro_torch.sweep.run <name>`` runs them and persists
``results/sweeps_torch/<name>.json``; every sweep runs, the ``adversary``
grid (attackers against the robust aggregations) included.
"""
from __future__ import annotations

from repro_torch.core import mixing_matrix, spectral_gap
from repro_torch.sweep.grid import GridSpec, batch_axis, static_axis

SEEDS = (0, 1, 2, 3)

SWEEPS = {}


def register(spec: GridSpec) -> GridSpec:
    SWEEPS[spec.name] = spec
    return spec


def _eta_over_k(p):
    """V2's theory-prescribed stepsizes: η_c ∝ 1/K for stability."""
    return {"eta_cx": 0.02 / p["K"], "eta_cy": 0.2 / p["K"]}


def _eta_s_by_algo(p):
    """η_s = 0.5 for the tracking variants, 1.0 (plain averaging) else."""
    return {"eta_s": 0.5 if p["algorithm"] in ("kgt_minimax", "gt_gda") else 1.0}


def _eta_s_by_gap(p):
    """V4's connectivity-matched communication stepsize."""
    gap = spectral_gap(mixing_matrix(p["topology"], p["n"]))
    return {"eta_s": min(0.9, 0.6 + 0.4 * gap)}


# V2: T vs K — local updates amortize gradient noise (σ²/(nK ε⁴) term).
register(GridSpec(
    name="local_steps",
    base=dict(n=8, sigma=2.0, heterogeneity=1.0, eps=0.6, eta_s=0.5,
              max_rounds=400, eval_every=20),
    axes=(static_axis("K", 1, 2, 4, 8, 16),
          batch_axis("seed", *SEEDS)),
    derive=_eta_over_k,
))

# V3: heterogeneity robustness — tracking flat in DH, local SGDA degrades.
register(GridSpec(
    name="heterogeneity",
    base=dict(n=8, K=8, sigma=0.0, eps=0.2, eta_cx=0.01, eta_cy=0.1,
              max_rounds=1200),
    axes=(static_axis("algorithm", "kgt_minimax", "local_sgda"),
          batch_axis("heterogeneity", 0.0, 1.0, 2.0, 4.0),
          batch_axis("seed", *SEEDS)),
    derive=_eta_s_by_algo,
))

# V4: topology dependence — rounds-to-ε vs spectral quantity p.
register(GridSpec(
    name="topology",
    base=dict(n=16, K=4, sigma=0.0, heterogeneity=2.0, eps=0.2,
              eta_cx=0.01, eta_cy=0.1, max_rounds=2500),
    axes=(static_axis("topology", "full", "exp", "torus", "ring"),
          batch_axis("seed", *SEEDS)),
    derive=_eta_s_by_gap,
))

# V5: linear speedup in n on the stochastic term.
register(GridSpec(
    name="speedup",
    base=dict(K=4, sigma=1.0, heterogeneity=0.5, topology="full", eps=0.45,
              eta_cx=0.01, eta_cy=0.1, eta_s=1.0, max_rounds=4000,
              eval_every=20),
    axes=(static_axis("n", 2, 4, 8, 16),
          batch_axis("seed", *SEEDS)),
))

# Table-1 proxy, seed-replicated: mean±std across 8 seeds per algorithm.
register(GridSpec(
    name="convergence",
    base=dict(n=8, K=8, sigma=0.1, heterogeneity=2.0, eps=0.3,
              eta_cx=0.01, eta_cy=0.1, max_rounds=1500),
    axes=(static_axis("algorithm", "kgt_minimax", "gt_gda", "dsgda",
                      "local_sgda"),
          batch_axis("seed", *range(8))),
    derive=_eta_s_by_algo,
))

def _pin_unread_edge_prob(p):
    """edge_prob only parameterizes the erdos_renyi draw; pinning it
    elsewhere + dedup stops the other families running bit-identical
    trajectories twice and counting them as replicates."""
    return {} if p["topology_family"] == "erdos_renyi" else {"edge_prob": 0.5}


# V6 (beyond-paper): robustness to churn — time-varying random topologies
# (repro_torch.core.stochastic_topology families) × partial client participation.
# The family is a static cell split; edge probability and participation
# rate are traced leaves, with the participation axis spanning 1.0 split on
# "are mask ops in the graph" exactly like sigma on noise ops.
register(GridSpec(
    name="churn",
    base=dict(n=8, K=4, sigma=0.0, heterogeneity=2.0, topology="full",
              eps=0.25, eta_cx=0.01, eta_cy=0.1, eta_s=0.5,
              max_rounds=600, eval_every=25),
    axes=(static_axis("topology_family",
                      "static", "erdos_renyi", "pairwise", "dropout"),
          batch_axis("edge_prob", 0.3, 0.7),
          batch_axis("participation", 1.0, 0.7,
                     cell_key=lambda r: r < 1),
          batch_axis("seed", 0, 1)),
    derive=_pin_unread_edge_prob,
    dedup=True,
))

def _pin_honest(p):
    """The attack type/scale only exist when there are attackers; pinning
    them at f=0 + dedup collapses the attack axis to one honest baseline
    per (mixing_impl, seed) instead of three identical replicates."""
    if p["num_byzantine"] > 0:
        return {}
    return {"attack": "honest", "attack_scale": 1.0}


# V7 (beyond-paper): Byzantine robustness — f = ⌈n/8⌉ attackers corrupting
# their outgoing round deltas (the reference's core.adversary) against plain mean
# gossip vs the robust aggregation lowerings (coord_median / trimmed_mean).
# The aggregation rule is a static cell split (a different mixing program);
# attacker count / attack id / attack scale are traced bundle leaves, with
# the num_byzantine axis spanning 0 split on "is the adversary extras slot
# in the graph" exactly like participation on mask ops.
#
# heterogeneity=0 is the classic homogeneous Byzantine setting: the
# coordinate-wise robust rules pay an irreducible bias ∝ client
# heterogeneity (trimming heterogeneous honest deltas biases the fixed
# point — per-client curvature still differs at 0, only the linear terms
# coincide), so the attacked robust floors clear eps only when that bias
# is small.  The headline contrast survives at any heterogeneity (plain
# gossip diverges, robust plateaus); what moves is the plateau.
register(GridSpec(
    name="adversary",
    base=dict(n=8, K=4, sigma=0.0, heterogeneity=0.0, topology="full",
              eps=0.25, eta_cx=0.01, eta_cy=0.1, eta_s=0.5,
              max_rounds=600, eval_every=25,
              attack_scale=3.0, robust_trim=1),
    axes=(static_axis("mixing_impl", "dense", "coord_median",
                      "trimmed_mean"),
          batch_axis("attack", "sign_flip", "large_norm", "random_noise"),
          batch_axis("num_byzantine", 0, 1,
                     cell_key=lambda f: f > 0),
          batch_axis("seed", 0, 1)),
    derive=_pin_honest,
    dedup=True,
))

# CI smoke: 2 seeds × 2 heterogeneity levels, one tiny cell end-to-end
# (batched path + store write).
register(GridSpec(
    name="smoke",
    base=dict(n=4, K=2, sigma=0.5, eps=0.5, eta_cx=0.02, eta_cy=0.2,
              eta_s=0.5, max_rounds=40, eval_every=10),
    axes=(batch_axis("heterogeneity", 0.5, 1.5),
          batch_axis("seed", 0, 1)),
))
