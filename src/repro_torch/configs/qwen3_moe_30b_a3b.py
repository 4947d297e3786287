"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) per-expert d_ff=768
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=768,
    vocab_size=151936,
    head_dim=128,
    moe=MoEConfig(num_experts=128, top_k=8, expert_d_ff=768),
    source="hf:Qwen/Qwen3-30B-A3B",
)
