"""internvl2-76b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256,
InternViT vision frontend (stubbed: input_specs() provides patch embeddings) +
InternLM2/Llama3-70B-like language backbone.  [arXiv:2404.16821]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    arch_type="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    num_prefix_tokens=256,  # vision patch embeddings per image (stub frontend)
    source="arXiv:2404.16821",
)
