"""Synthetic heterogeneous federated token data (``repro.data``'s
counterpart); ``round_batches`` comes with the training slice."""
from repro_torch.data.synthetic import (  # noqa: F401
    DataModel,
    batch_from_draws,
    heterogeneity_index,
    make_data_model,
    sample_client_batch,
)
