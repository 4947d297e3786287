"""mamba2-1.3b [ssm] — 48L d_model=2048 attention-free, vocab=50280,
ssm_state=128, SSD (state-space duality).  [arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_head=64, expand=2, chunk=64, d_conv=4),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
