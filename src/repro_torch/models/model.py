"""Top-level language model (port of ``repro.models.model``): embeddings ->
decoder stack -> head, cache management and the decode step.

The losses (``token_losses``, ``chunked_nll``, ``per_group_loss``,
``lm_loss``) come with the training slice and kernel B6 (ROADMAP A11);
modality frontends (``num_prefix_tokens``, ``num_codebooks``) are not ported
yet either.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.models.layers import embed_init, param, rms_norm


class Model(nn.Module):
    """Parameters of one language model, under the reference's names:
    ``embed`` (V, d), ``layers`` (one ``transformer.Block`` per layer, in
    layer order), ``final_norm`` (d,) and, unless the embeddings are tied,
    ``head`` (d, V)."""

    def __init__(self, cfg: ModelConfig, gen, *, device, dtype):
        super().__init__()
        if cfg.num_codebooks or cfg.num_prefix_tokens:
            raise NotImplementedError(
                "modality frontends (num_codebooks, num_prefix_tokens) are "
                "not ported yet (ROADMAP A11)")
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed = param(embed_init(gen, (cfg.vocab_size, cfg.d_model),
                                      **kw))
        self.layers = nn.ModuleList(
            tf.Block(kind, cfg, gen, **kw) for kind in cfg.blocks())
        self.final_norm = param(torch.zeros((cfg.d_model,), **kw))
        self.head = None
        if not cfg.tie_embeddings:
            self.head = param(embed_init(gen, (cfg.d_model, cfg.vocab_size),
                                         **kw))


def init_params(cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
                seed: int = 0, device="cuda", dtype=torch.float32) -> Model:
    """A model with fresh weights on ``device`` in ``dtype`` (bf16 for
    serving), drawn from ``generator`` (or one seeded with ``seed``)."""
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
    return Model(cfg, generator, device=device, dtype=dtype)


def param_count(model: Model) -> int:
    return sum(p.numel() for p in model.parameters())


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(model: Model, tokens, compute_dtype):
    return model.embed[tokens].to(compute_dtype)


def lm_head(model: Model, x, compute_dtype):
    if model.head is None:
        return x @ model.embed.to(compute_dtype).T
    return x @ model.head.to(compute_dtype)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def backbone(model: Model, batch: Dict[str, Any], *, mode: str = "train",
             compute_dtype=torch.bfloat16, caches=None, pos=None,
             kernels: bool = True):
    """Everything up to (and incl.) the final norm.  Returns (hidden (B,S,d),
    new_caches, aux)."""
    cfg = model.cfg
    if "prefix" in batch:
        raise NotImplementedError("prefix embeddings are not ported yet "
                                  "(ROADMAP A11)")
    tokens = batch["tokens"]
    x = embed_tokens(model, tokens, compute_dtype)
    if "embed_bias" in batch:  # adversarial objective: universal perturbation
        x = x + batch["embed_bias"].to(compute_dtype)
    b, s = x.shape[0], x.shape[1]
    if mode == "decode":
        positions = torch.full((b, 1), pos, dtype=torch.int32,
                               device=x.device)
    else:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None, :].expand(b, s)
    x, new_caches, aux = tf.stack_forward(
        model.layers, x, cfg, mode=mode, positions=positions, caches=caches,
        pos=pos, compute_dtype=compute_dtype, kernels=kernels)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return x, new_caches, aux


def forward(model: Model, batch: Dict[str, Any], *, mode: str = "train",
            compute_dtype=torch.bfloat16, caches=None, pos=None,
            last_only: bool = False, kernels: bool = True):
    """Returns (logits, new_caches, aux).  ``last_only`` computes the head on
    the final position only (prefill servers).  ``kernels=False`` runs the
    kernels' plain versions in ``prefill``."""
    x, new_caches, aux = backbone(
        model, batch, mode=mode, compute_dtype=compute_dtype, caches=caches,
        pos=pos, kernels=kernels)
    if last_only:
        x = x[:, -1:]
    return lm_head(model, x, compute_dtype), new_caches, aux


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def cache_length(kind: str, cfg: ModelConfig, seq_len: int) -> Optional[int]:
    """The KV-cache length of an attention-family layer (None otherwise)."""
    if kind in ("rglru", "ssm"):
        return None
    window = tf._attn_window(kind, cfg)
    return min(window, seq_len) if window else seq_len


def _block_cache(kind: str, cfg: ModelConfig, batch: int, seq_len: int,
                 dtype, device) -> Dict[str, torch.Tensor]:
    hd = cfg.resolved_head_dim
    if kind == "rglru":
        w = cfg.rglru.lru_width or cfg.d_model
        return {
            "conv": torch.zeros((batch, cfg.rglru.conv_width - 1, w),
                                dtype=dtype, device=device),
            "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        }
    if kind == "ssm":
        raise NotImplementedError("the ssm block is not ported yet "
                                  "(ROADMAP A11)")
    shape = (batch, cache_length(kind, cfg, seq_len), cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device="cuda") -> List[Dict]:
    """One cache dict per layer, in layer order."""
    return [_block_cache(kind, cfg, batch, seq_len, dtype, device)
            for kind in cfg.blocks()]


def decode_step(model: Model, caches, tokens, pos: int, *,
                compute_dtype=torch.bfloat16):
    """One-token decode.  tokens: (B,1); pos: the absolute position.
    Returns (logits (B,1,V), new_caches); the caches passed in are left as
    they were."""
    logits, new_caches, _ = forward(
        model, {"tokens": tokens}, mode="decode", compute_dtype=compute_dtype,
        caches=caches, pos=pos)
    return logits, new_caches
