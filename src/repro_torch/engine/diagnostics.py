"""Metric functions for the engine's metrics buffer (port of
``repro.engine.diagnostics``).

A metrics function is ``(state, batches) -> {name: tensor}``, each value of
a fixed shape (scalars, or small vectors such as the per-group losses);
the engine writes the row into its on-device buffer.  ``batches`` is the
round's K-stacked training data, so train-side metrics see what the
optimizer saw.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core import kgt_minimax as kgt
from repro_torch.core import mixing as mixing_lib
from repro_torch.core.minimax import MinimaxProblem
from repro_torch.dist import collectives


def _consensus_block(state, axis=None, xbar=None, ybar=None,
                     block=None) -> Dict[str, torch.Tensor]:
    """Consensus Ξx/Ξy, the Lemma-8 ‖c̄‖ watchdogs and ‖ȳ‖.  On the
    decentralized mesh (``axis``: the state holds this rank's clients)
    every mean over the clients is all-reduced; ``xbar`` / ``ybar`` are the
    means where the caller has them.  ``block``: where x and cx hold this
    rank's pieces of its clients' weights, the ``dist.collectives.
    BlockSum`` of their sums of squares (y and cy are whole on every rank
    of the block)."""
    return {
        "consensus_x": mixing_lib.consensus_error(state.x, axis, xbar,
                                                  block),
        "consensus_y": mixing_lib.consensus_error(state.y, axis, ybar),
        "corr_x_norm": kgt.correction_mean_norm(state.cx, axis, block),
        "corr_y_norm": kgt.correction_mean_norm(state.cy, axis),
        "y_bar_norm": kgt.correction_mean_norm(state.y, axis),
    }


def quadratic_metrics_fn(problem: MinimaxProblem):
    """The exact ‖∇Φ(x̄)‖ of the synthetic quadratic plus the consensus
    block."""

    def metrics(state, batches) -> Dict[str, torch.Tensor]:
        del batches
        return {
            "phi_grad_norm": problem.phi_grad_norm(
                kgt.mean_over_clients(state.x)),
            **_consensus_block(state),
        }

    return metrics


def dro_metrics_fn(problem: MinimaxProblem, model_cfg, *, num_groups: int,
                   eval_batch: Optional[Any] = None,
                   compute_dtype=torch.bfloat16, axis=None, shard=None):
    """Metrics of DRO-LM training (what ``launch.train`` logs; reference
    :39), with autograd off.

    Train side: f(x̄, ȳ) and the mean per-group loss on the round's first
    (k = 0, client 0) batch.  Eval side, with ``eval_batch`` (a fixed
    held-out batch, ``sampler.held_out_eval_batch``): the mean and the (G,)
    per-group losses of the consensus model on data the optimizer never
    trains on.  The model runs through ``models.model.call`` (B5 and B6 on
    the card).

    On the decentralized mesh (``axis``: the state and ``batches`` hold
    this rank's clients) x̄, ȳ and the consensus terms are all-reduced,
    client 0's batch is broadcast from its rank (rank 0), and every rank
    computes the same row on the whole held-out batch (collectives under
    the phase ``metrics``).  Where x holds this rank's pieces of a
    client's weights (``shard``, a ``dist.tensor_parallel.ClientShard``),
    x̄ is the pieces' mean, the losses run on them as the problem's do,
    and x's and cx's sums of squares are taken over the block
    (``ClientShard.block_sum``); where x is whole on every rank of the
    block (a ``tensor_parallel.ReplicatedShard``), the losses run on the
    rank's rows (and positions) with their sums over the block, and the
    sums of squares are the rank's own (``ReplicatedShard.block_sum``).
    """
    from repro_torch.core import objectives

    losses_of = objectives.dro_group_losses(
        model_cfg, num_groups=num_groups, compute_dtype=compute_dtype,
        shard=shard)
    block = None if shard is None else shard.block_sum()

    def group_losses(xbar, batch):
        return losses_of(xbar, batch)[0]

    @torch.no_grad()
    def metrics(state, batches) -> Dict[str, torch.Tensor]:
        with collectives.phase("metrics"):
            return _metrics(state, batches)

    def _metrics(state, batches) -> Dict[str, torch.Tensor]:
        xbar = kgt.mean_over_clients(state.x, axis)
        ybar = collectives.clients_mean(state.y, axis)
        train_b = {k: v[0, 0] for k, v in batches.items()}
        if axis is not None:
            train_b = {k: collectives.broadcast_from(v, 0, axis)
                       for k, v in sorted(train_b.items())}
        out = {
            "f_bar": problem.value(xbar, ybar, train_b, None),
            "mean_loss": group_losses(xbar, train_b).mean(),
            **_consensus_block(state, axis, xbar, ybar, block),
        }
        if eval_batch is not None:
            eval_losses = group_losses(xbar, eval_batch)
            out["eval_loss"] = eval_losses.mean()
            out["eval_group_loss"] = eval_losses    # a (G,) vector row
        return out

    return metrics
