"""Registry of assigned architectures (+ the repo's paper-toy model), a copy
of ``repro.configs.registry``.

``get_model_config(arch_id)`` returns the full assigned config;
``reduced(cfg)`` returns the CPU-smoke-test variant (2 layers, d_model<=512,
<=4 experts) of the same family, per the brief.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    granite_moe_1b_a400m,
    internvl2_76b,
    mamba2_1_3b,
    minicpm_2b,
    musicgen_medium,
    paper_toy,
    qwen1_5_32b,
    qwen1_5_4b,
    qwen2_0_5b,
    qwen3_moe_30b_a3b,
    recurrentgemma_9b,
)
from repro_torch.configs.base import ModelConfig, MoEConfig, RGLRUConfig, SSMConfig

ARCHS = {
    "granite-moe-1b-a400m": granite_moe_1b_a400m.CONFIG,
    "minicpm-2b": minicpm_2b.CONFIG,
    "qwen2-0.5b": qwen2_0_5b.CONFIG,
    "recurrentgemma-9b": recurrentgemma_9b.CONFIG,
    "mamba2-1.3b": mamba2_1_3b.CONFIG,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b.CONFIG,
    "qwen1.5-32b": qwen1_5_32b.CONFIG,
    "internvl2-76b": internvl2_76b.CONFIG,
    "qwen1.5-4b": qwen1_5_4b.CONFIG,
    "musicgen-medium": musicgen_medium.CONFIG,
    "paper-toy": paper_toy.CONFIG,
}

ASSIGNED = tuple(k for k in ARCHS if k != "paper-toy")


def get_model_config(arch_id: str) -> ModelConfig:
    try:
        return ARCHS[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}") from None


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests.

    2 layers (enough to cover the hybrid block pattern we truncate to 3),
    d_model <= 512, <= 4 experts, small vocab.
    """
    d = min(cfg.d_model, 256)
    n_heads = max(2, min(cfg.num_heads, 4)) if cfg.num_heads else 0
    n_kv = max(1, min(cfg.num_kv_heads, n_heads)) if cfg.num_kv_heads else 0
    if n_heads:
        while n_heads % max(n_kv, 1):
            n_kv -= 1
    num_layers = 3 if cfg.arch_type == "hybrid" else 2
    changes = dict(
        num_layers=num_layers,
        d_model=d,
        num_heads=n_heads,
        num_kv_heads=n_kv,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        head_dim=(d // n_heads) if n_heads else 0,
        sliding_window=64,
        num_prefix_tokens=min(cfg.num_prefix_tokens, 4),
    )
    if cfg.arch_type == "moe":
        changes["moe"] = MoEConfig(
            num_experts=4, top_k=2, expert_d_ff=64,
            router_aux_coef=cfg.moe.router_aux_coef,
        )
    if cfg.arch_type == "ssm":
        changes["ssm"] = SSMConfig(d_state=16, d_head=32, expand=2, chunk=16, d_conv=4)
    if cfg.arch_type == "hybrid":
        changes["rglru"] = RGLRUConfig(
            lru_width=d, conv_width=4,
            block_pattern=cfg.rglru.block_pattern, local_window=32,
        )
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **changes)
