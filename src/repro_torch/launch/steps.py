"""Step builder of the decentralized training mesh (port of the train
parts of ``repro.launch.steps``, :38-162).

``build_train_round`` builds one K-GT-Minimax round (K local DRO-minimax
steps, correction, gossip) of this rank's clients on the decentralized
mesh.  The engine's chunks of such rounds (the reference's
``build_train_chunk``, :165) are ``launch.train``'s ``Trainer.build_chunk``
over this round step and the sampler cut to the rank's clients; they run
eagerly (``capture=False``): a gloo collective
cannot be captured in a CUDA graph, and capturing chunks over NCCL is
later work.

The reference jits these programs with the state's clients dim sharded on
the ``clients`` axis and lets GSPMD insert the gossip collectives.  Here
each rank runs its own clients' rows (``dist.collectives.ClientsAxis``)
and the round step issues the collectives itself: none in the K local
steps, the gossips after them (``core.kgt_minimax.make_round_step(axis=)``).
Where the reference swaps the Pallas gossip epilogue for its XLA oracle on
the mesh (:57-66: "the Pallas kernels themselves are the single-chip
epilogue path"), ``pallas_packed`` here gossips through
``dist.collectives.gossip_pair``; ``sparse_packed`` is not ported to the
mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import (AlgorithmConfig, InputShape, MeshConfig,
                                      MinimaxConfig, ModelConfig)
from repro_torch.core import kgt_minimax as kgt
from repro_torch.core import objectives
from repro_torch.dist import collectives
from repro_torch.dist import context as dist_ctx
from repro_torch.dist import sharding as sh


def build_train_round(model_cfg: ModelConfig, shape: InputShape, mesh,
                      mcfg: MeshConfig,
                      algo: Optional[AlgorithmConfig] = None,
                      minimax: Optional[MinimaxConfig] = None,
                      lr_scale=None, *, problem=None, device="cuda"):
    """``(round_step, axis)``: ``round_step(state, batches, noise) ->
    state`` on this rank's (n/R, …) state and (K, n/R, B, S…) batches,
    under the mesh's residual constraint (reference :38-137), ``axis`` the
    rank's clients.  ``problem`` defaults to the DRO problem of
    ``minimax``."""
    algo = algo or AlgorithmConfig(num_clients=mcfg.num_clients)
    algo = dataclasses.replace(algo, num_clients=mcfg.num_clients)
    minimax = minimax or MinimaxConfig()
    n = algo.num_clients
    if shape.global_batch % n:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"over {n} clients")
    if problem is None:
        problem = objectives.dro_problem(model_cfg,
                                         num_groups=minimax.num_groups,
                                         mu=minimax.mu)
    axis = collectives.clients_axis(mesh, n)
    round_fn = kgt.make_round_step(problem, algo, lr_scale=lr_scale,
                                   device=device, axis=axis)
    constraint = sh.leading_dims_constraint(mesh,
                                            sh.residual_axes(mcfg.residual_mode))

    def round_step(state, batches, noise, *extras):
        with dist_ctx.residual_constraint(constraint):
            return round_fn(state, batches, noise, *extras)

    round_step.uses_round = round_fn.uses_round
    return round_step, axis
