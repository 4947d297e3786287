"""Metric functions for the engine's metrics buffer (port of
``repro.engine.diagnostics:80``).

A metrics function is ``(state, batches) -> {name: 0-d tensor}``; the
engine writes each value into its on-device buffer row.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import kgt_minimax as kgt
from repro_torch.core import mixing as mixing_lib
from repro_torch.core.minimax import MinimaxProblem


def _consensus_block(state) -> Dict[str, torch.Tensor]:
    """Consensus Ξx/Ξy, the Lemma-8 ‖c̄‖ watchdogs and ‖ȳ‖."""
    return {
        "consensus_x": mixing_lib.consensus_error(state.x),
        "consensus_y": mixing_lib.consensus_error(state.y),
        "corr_x_norm": kgt.correction_mean_norm(state.cx),
        "corr_y_norm": kgt.correction_mean_norm(state.cy),
        "y_bar_norm": kgt.correction_mean_norm(state.y),
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
