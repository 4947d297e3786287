"""musicgen-medium [audio] — 48L d_model=1536 24H (GQA kv=24) d_ff=6144 vocab=2048,
decoder-only transformer over EnCodec tokens (4 codebooks, delay pattern at the
data layer; EnCodec itself stubbed per the brief).  [arXiv:2306.05284]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    arch_type="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    num_codebooks=4,
    source="arXiv:2306.05284",
)
