"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000, RG-LRU + local attention in a 2:1 pattern (two recurrent blocks per
local-attention block), window 2048.  [arXiv:2402.19427]
"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    rglru=RGLRUConfig(
        lru_width=4096,
        block_pattern=("rglru", "rglru", "attn_local"),
        local_window=2048,
    ),
    source="arXiv:2402.19427",
)
