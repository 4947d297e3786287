"""paper-toy — a ~100M llama-like config used for the paper-faithful end-to-end
training experiments (the paper itself is architecture-agnostic theory; this is
the repo's default 'small real model' for V1-V6 style runs at model scale).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paper-toy",
    arch_type="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=4,
    d_ff=2048,
    vocab_size=32000,
    tie_embeddings=True,
    source="this repo (paper has no model experiments)",
)
