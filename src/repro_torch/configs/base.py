"""Algorithm hyperparameters (Algorithm 1), the port's own copy.

Same fields, defaults and string values as ``repro.configs.base.
AlgorithmConfig`` so a config carries over unchanged; only
``gossip_backend`` takes the port's values.  Churn is ported:
``topology_cycle`` is read by ``make_round_step``, and ``topology_family``,
``edge_prob``, ``client_drop_prob``, ``participation_rate`` and
``topology_seed`` parametrize the per-round samplers of
``repro_torch.core.stochastic_topology`` / ``sparse_topology`` that the
caller rides on the engine's sampler slot (``engine.with_topology``), as in
the reference.  Options this port does not implement yet are accepted here
and refused by ``repro_torch.core.kgt_minimax.make_round_step`` (and
``init_state``): ``gossip_compress`` (ROADMAP A7), ``num_byzantine`` > 0
and ``attack`` other than "honest" (A9); ``attack_scale`` and
``robust_trim`` are read only under those options, and ``inner_opt`` is
read nowhere, in the reference as here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AlgorithmConfig:
    algorithm: str = "kgt_minimax"  # kgt_minimax | dsgda | local_sgda | gt_gda
    num_clients: int = 4
    local_steps: int = 2            # K
    eta_cx: float = 1e-3            # local stepsize for x
    eta_cy: float = 1e-2            # local stepsize for y
    eta_sx: float = 1.0             # communication stepsize for x
    eta_sy: float = 1.0             # communication stepsize for y
    topology: str = "ring"          # ring | torus | full | exp | star
    # Gossip lowering: "dense" (W-contraction per leaf), "ring" (roll),
    # "fused_dense"/"fused_ring" (Δ and θ stacked into one mix per leaf),
    # "pallas_packed" (whole state packed to (n, D), fused epilogue kernel —
    # the name is kept from the JAX package so configs carry over),
    # "sparse_packed" (the packed epilogue with W as neighbor lists, in the
    # neighbor-gather kernel: the path past 512 clients), "fused_round"
    # (whole round in one kernel call).  The robust impls are not ported
    # yet (ROADMAP A9).
    mixing_impl: str = "dense"
    # Backend for the packed kernels: "auto" (the CUDA kernel for CUDA
    # tensors, the plain PyTorch version for CPU tensors), "kernel" (the
    # CUDA kernel; CPU tensors raise), or "torch" (the plain version; CUDA
    # tensors raise).
    gossip_backend: str = "auto"
    gossip_dtype: str = "float32"   # "bfloat16" narrows the gossip operands
    gossip_compress: Optional[str] = None   # not ported yet (ROADMAP A7)
    inner_opt: str = "sgd"
    correction_dtype: str = "float32"
    topology_cycle: Tuple[str, ...] = ()
    topology_family: str = "static"
    edge_prob: float = 0.5
    client_drop_prob: float = 0.3
    participation_rate: float = 1.0
    topology_seed: int = 0
    num_byzantine: int = 0
    attack: str = "honest"
    attack_scale: float = 1.0
    robust_trim: int = 1
