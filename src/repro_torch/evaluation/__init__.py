"""Evaluation metrics (``repro.evaluation``'s counterpart);
``evaluate_clients`` needs the client-stacked parameters of the training
slice and comes with it."""
from repro_torch.evaluation.metrics import group_metrics  # noqa: F401
