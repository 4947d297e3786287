"""Synthetic heterogeneous federated token data (``repro.data``'s
counterpart)."""
from repro_torch.data.synthetic import (  # noqa: F401
    DataModel,
    batch_from_draws,
    heterogeneity_index,
    make_data_model,
    round_batches,
    sample_client_batch,
    stack_round,
)
