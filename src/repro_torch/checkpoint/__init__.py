from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    latest,
    load_metadata,
    restore,
    save,
)
