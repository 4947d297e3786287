"""Evaluation metrics (port of ``repro.evaluation.metrics``).

Worst-group loss is the quantity DRO optimizes implicitly (the y-ascent
soft-maximizes hard groups); per-group perplexity exposes the robustness the
paper's minimax formulation buys over ERM.  ``group_metrics`` runs with
autograd off, so the model goes through kernels B7 (the SSD scan, in every
Mamba2 layer) and B6 (the fused cross-entropy) on the card.
``evaluate_clients`` waits for the training slice's client-stacked
parameters (ROADMAP A11).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models import model as model_lib


@torch.no_grad()
def group_metrics(model: model_lib.Model, batch, *, num_groups: int,
                  compute_dtype=torch.bfloat16,
                  kernels: bool = True) -> Dict[str, torch.Tensor]:
    """Per-group CE / perplexity and worst-group stats on one batch.
    ``kernels=False`` runs the plain versions (the reference's bf16-logit
    cross-entropy and the plain scan) — the check on the card."""
    losses, _ = model_lib.per_group_loss(
        model, batch, num_groups=num_groups, compute_dtype=compute_dtype,
        kernels=kernels)
    present = F.one_hot(batch["groups"].long(), num_groups).sum((0, 1)) > 0
    masked = torch.where(present, losses, float("-inf"))
    return {
        "group_loss": losses,
        "group_ppl": torch.exp(torch.clamp(losses, 0.0, 20.0)),
        "mean_loss": torch.where(present, losses, 0.0).sum()
        / torch.clamp(present.sum(), min=1),
        "worst_group_loss": masked.max(),
        "worst_group": masked.argmax(),
        "groups_present": present.sum(),
    }
