from repro_torch.configs.base import (  # noqa: F401
    AlgorithmConfig,
    InputShape,
    ModelConfig,
    MoEConfig,
    RGLRUConfig,
    SSMConfig,
)
