"""Evaluation metrics (port of ``repro.evaluation.metrics``).

Worst-group loss is the quantity DRO optimizes implicitly (the y-ascent
soft-maximizes hard groups); per-group perplexity exposes the robustness the
paper's minimax formulation buys over ERM.  ``group_metrics`` runs with
autograd off, so the model goes through its kernels on the card (B5 in
attention layers, B7 in Mamba2 layers, B6 for the cross-entropy).
``evaluate_clients`` runs it on the consensus of the training state's
client-stacked parameters.
"""
from __future__ import annotations

from typing import Dict, List, Optional

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


def evaluate_clients(state_x, dm, cfg, generator: Optional[torch.Generator]
                     = None, *, num_groups: int, per_client_batch: int = 4,
                     seq_len: int = 128, compute_dtype=torch.bfloat16,
                     batches: Optional[List[Dict[str, torch.Tensor]]] = None
                     ) -> Dict[str, float]:
    """The consensus model x̄ (the client mean of ``state_x``, the training
    state's parameter dict) on every client's distribution (reference
    :37): ``group_metrics`` on one batch of each client, drawn from
    ``generator`` (or ``batches``, one a client, e.g. built from the
    reference's draws).  Returns the clients' mean loss and the worst
    client's."""
    from repro_torch.data import synthetic as data_lib

    xbar = {k: v.mean(0) for k, v in state_x.items()}
    skel = model_lib.skeleton(cfg)
    n = dm.mixtures.shape[0]
    means = []
    for i in range(n):
        b = (batches[i] if batches is not None
             else data_lib.sample_client_batch(dm, generator, i,
                                               per_client_batch, seq_len,
                                               cfg.num_codebooks))
        m = model_lib.call(skel, xbar, group_metrics, b,
                           num_groups=num_groups,
                           compute_dtype=compute_dtype)
        means.append(m["mean_loss"])
    means = torch.stack(means)
    return {"client_mean_loss": float(means.mean()),
            "worst_client_loss": float(means.max())}
