"""Evaluation metrics (``repro.evaluation``'s counterpart)."""
from repro_torch.evaluation.metrics import (  # noqa: F401
    evaluate_clients,
    group_metrics,
)
