from repro_torch.configs.base import AlgorithmConfig  # noqa: F401
