"""Composable decoder stack (port of ``repro.models.transformer``).

A model is a sequence of blocks (``ModelConfig.blocks()``).  The reference
stacks each repeated unit of the block pattern along a leading repeat dim
and runs it under ``lax.scan``; here the layers are one flat list, and
``layer_slots`` maps each layer to its reference slot: in segment ``si``,
repeat ``r`` and unit slot ``bi`` sits layer ``offset(si) + r·len(unit) +
bi``.

Block kinds ported:
  attn / sliding         GQA attention (+ optional window) + SwiGLU MLP
  attn_local             windowed attention (RecurrentGemma local layer) + MLP
  rglru                  RG-LRU temporal mixer + MLP
  ssm                    Mamba2 SSD mixer, no MLP
  moe                    GQA attention + MoE MLP (``models.moe``)

On the serving mesh's model axis (``dist.tensor_parallel``) a block runs
on its rank's piece: query and KV heads, SSM heads, LRU channels, d_ff or
expert_d_ff.  The partial sums of the mixer's out-projection cross the
ranks at ``attn_proj`` (attention) or ``mixer_out`` (``ssm``, ``rglru``),
those of the MLP or MoE at ``ffn_out``: points of ``dist.context``,
identities without a context.  Training over a client's (fsdp, model)
block adds the conjugate points where the whole residual enters a
column-parallel piece, ``attn_in`` (q/k/v), ``mixer_in`` (the ``ssm``
block's ``in_proj``, the ``rglru`` block's ``in_x`` / ``in_gate``) and
``ffn_in`` (gate/up, and the MoE experts' input: ``models.moe``): an
identity whose gradient the model ranks sum.  On a sequence split over
the model axis (Megatron's sequence parallelism: a prefill, and training
under ``MeshConfig.residual_mode="batch_seq"``; ``tensor_parallel.
SeqSplit``) the residual between those points is the rank's piece of the
positions: the ``*_in`` points gather the whole sequence and the
row-parallel points reduce-scatter it back, so the norms and residual
adds run on 1/M of it while the mixers, their kernels and the cache
writes see the whole sequence, as they do with the residual whole.  A
layer is read through its
``gathered()`` at its entry: the layer itself, or on that block its
weights all-gathered over fsdp (``tensor_parallel.LayerPieces``).  The mixers' own points (the SSM's gated
norm, the RG-LRU's gate input) are in ``models.ssm`` and ``models.rglru``.

Modes: ``prefill`` runs the CUDA kernels (``kernels.ops.flash_attention``,
``rglru_scan``, ``ssd_scan``) and fills the caches; ``train`` runs them
too, under autograd as well (each kernel's gradient is an autograd
Function); ``decode`` advances one token against the caches in plain
PyTorch.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import context as dist_ctx
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import init_mlp, mlp, param, rms_norm

# the block kinds whose mixer is attention (kernel B5 in prefill and train)
ATTN_KINDS = ("attn", "sliding", "attn_local", "moe")
KINDS = ATTN_KINDS + ("rglru", "ssm")


# ---------------------------------------------------------------------------
# Segments
# ---------------------------------------------------------------------------

def segments(cfg: ModelConfig) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
    """((unit_kinds, n_repeats), ...) covering cfg.blocks()."""
    blocks = cfg.blocks()
    pat = cfg.block_pattern or None
    if pat is None:
        if cfg.arch_type == "hybrid":
            pat = cfg.rglru.block_pattern
        elif cfg.arch_type == "moe":
            pat = ("moe",)
        elif cfg.arch_type == "ssm":
            pat = ("ssm",)
        else:
            pat = (blocks[0],)
    n_full = len(blocks) // len(pat)
    rem = blocks[n_full * len(pat):]
    segs = []
    if n_full:
        segs.append((tuple(pat), n_full))
    if rem:
        segs.append((tuple(rem), 1))
    return tuple(segs)


def layer_slots(cfg: ModelConfig) -> List[Tuple[int, int, int, str]]:
    """(segment, repeat, unit slot, kind) of each layer, in layer order."""
    return [(si, r, bi, kind)
            for si, (unit, reps) in enumerate(segments(cfg))
            for r in range(reps) for bi, kind in enumerate(unit)]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _attn_window(kind: str, cfg: ModelConfig) -> int:
    if kind == "sliding":
        return cfg.sliding_window
    if kind == "attn_local":
        return cfg.rglru.local_window
    if cfg.long_context_window:  # long_500k variant for full-attn archs
        return cfg.long_context_window
    return 0


class Block(nn.Module):
    """One decoder layer: its kind and its parameters, under the reference's
    names (``norm1``, ``attn`` or ``rglru``, ``norm2``, ``mlp``; a ``moe``
    layer holds ``moe`` in place of ``mlp``; an ``ssm`` layer holds only
    ``norm1`` and ``ssm``)."""

    def __init__(self, kind: str, cfg: ModelConfig, gen, *, device, dtype):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"unknown block kind {kind!r}: {KINDS}")
        d = cfg.d_model
        kw = dict(device=device, dtype=dtype)
        self.kind = kind
        self.norm1 = param(torch.zeros((d,), **kw))
        if kind == "ssm":
            self.ssm = ssm_lib.init_ssm(gen, cfg, d, **kw)
            return
        if kind == "rglru":
            self.rglru = rglru_lib.init_rglru(gen, cfg, d, **kw)
        else:
            self.attn = attn_lib.init_attention(gen, cfg, d, **kw)
        self.norm2 = param(torch.zeros((d,), **kw))
        if kind == "moe":
            self.moe = moe_lib.init_moe(gen, cfg, d, **kw)
        else:
            self.mlp = init_mlp(gen, d, cfg.d_ff, **kw)

    def gathered(self) -> "Block":
        """The layer as :func:`block_forward` reads it: itself."""
        return self


def kernel_route(mode: str, kernels: bool) -> bool:
    """Whether a kernel runs: in ``prefill`` and in ``train``, with or
    without autograd (every model kernel's gradient is an autograd
    Function); never in ``decode`` (one token, plain PyTorch), nor with
    ``kernels=False`` (the plain check)."""
    return kernels and mode in ("prefill", "train")


def block_forward(
    kind: str,
    params: Block,
    x,
    cfg: ModelConfig,
    *,
    mode: str,            # "train" | "prefill" | "decode"
    positions,            # (B,S) absolute positions
    cache: Optional[Dict] = None,
    pos=None,             # decode position: int, or (B,) tensor
    compute_dtype=torch.bfloat16,
    kernels: bool = True,
):
    """Returns (x_out, new_cache, aux_loss).  ``kernels=False`` runs the
    kernels' plain versions where they would run (the check on the card;
    ``kernel_route``)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, params.norm1, cfg.norm_eps)
    route = kernel_route(mode, kernels)

    if kind == "ssm":
        conv_s = cache["conv"] if cache else None
        ssd_s = cache["state"] if cache else None
        y, new_cache = ssm_lib.ssm_forward(
            params.ssm, dist_ctx.apply("mixer_in", h), cfg, compute_dtype,
            conv_s, ssd_s,
            decode=(mode == "decode"), kernels=route)
        y = dist_ctx.apply("mixer_out", y)  # the head shards' partial sums
        return x + y, new_cache, aux

    if kind == "rglru":
        conv_s = cache["conv"] if cache else None
        h_s = cache["h"] if cache else None
        y, new_cache = rglru_lib.rglru_forward(
            params.rglru, dist_ctx.apply("mixer_in", h), cfg, compute_dtype,
            conv_s, h_s, decode=(mode == "decode"), kernels=route)
        x = x + dist_ctx.apply("mixer_out", y)  # the channel shards' sums
        h2 = dist_ctx.apply("ffn_in", rms_norm(x, params.norm2,
                                               cfg.norm_eps))
        y2 = dist_ctx.apply("ffn_out", mlp(params.mlp, h2, compute_dtype))
        return x + y2, new_cache, aux

    # attention-family blocks -------------------------------------------------
    window = _attn_window(kind, cfg)
    q, k, v = attn_lib.qkv_project(params.attn,
                                   dist_ctx.apply("attn_in", h), cfg,
                                   positions, compute_dtype)
    q = dist_ctx.apply("attn_qkv", q)  # optional head-sharding switch

    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs the caches (model.init_cache)")
        kc, vc = cache["k"], cache["v"]
        c_len = kc.shape[1]
        slots = torch.arange(c_len, device=x.device)
        # a (B,) pos: each row writes and reads at its own position, as
        # (B, c_len) masks, with no host sync
        p = pos[:, None] if isinstance(pos, torch.Tensor) else pos
        # write position: ring for windowed caches, absolute otherwise; the
        # write is a select, so the caches passed in stay as they were
        if window:
            widx = p % c_len
        elif isinstance(p, torch.Tensor):
            widx = torch.clamp(p, max=c_len - 1)
        else:
            widx = min(p, c_len - 1)
        onehot = (slots == widx).reshape(-1, c_len, 1, 1)
        kc = torch.where(onehot, k.to(kc.dtype), kc)
        vc = torch.where(onehot, v.to(vc.dtype), vc)
        # cold-start validity: slots <= pos written so far (ring: all-true
        # once pos >= window, which is exactly when wrapping starts)
        valid = slots <= p
        ctx = attn_lib.decode_attention(q, kc.to(compute_dtype),
                                        vc.to(compute_dtype), valid)
        new_cache = {"k": kc, "v": vc}
    else:
        new_cache = None
        if route:
            ctx = ops.flash_attention(q, k, v, causal=True, window=window)
        elif mode == "prefill":
            ctx = ref.attention_ref(q, k, v, causal=True, window=window)
        else:
            ctx = attn_lib.naive_attention(q, k, v, window=window)
        if cache is not None:  # prefill populating a cache
            c_len = cache["k"].shape[1]
            kw = k[:, -c_len:].to(cache["k"].dtype).clone()
            vw = v[:, -c_len:].to(cache["v"].dtype).clone()
            new_cache = {"k": kw, "v": vw}

    ctx = dist_ctx.apply("attn_out", ctx)  # back to the residual layout
    y = attn_lib.out_project(params.attn, ctx, compute_dtype)
    y = dist_ctx.apply("attn_proj", y)  # the head shards' partial sums
    x = x + y

    h2 = rms_norm(x, params.norm2, cfg.norm_eps)
    if kind == "moe":   # ffn_in on the experts' input, not the router's
        moe_fn = (moe_lib.moe_mlp_sorted if cfg.moe.dispatch == "sorted"
                  else moe_lib.moe_mlp)
        y2, aux = moe_fn(params.moe, h2, cfg, compute_dtype)
    else:
        y2 = mlp(params.mlp, dist_ctx.apply("ffn_in", h2), compute_dtype)
    y2 = dist_ctx.apply("ffn_out", y2)  # the ffn shards' partial sums
    return x + y2, new_cache, aux


def stack_forward(
    layers,
    x,
    cfg: ModelConfig,
    *,
    mode: str,
    positions,
    caches=None,
    pos=None,
    compute_dtype=torch.bfloat16,
    kernels: bool = True,
):
    """Run every layer.  ``caches`` is a list with one entry per layer (or
    None).  Returns (x, new_caches, total_aux): the sum of every layer's
    aux (the reference adds each unit's last block's aux, the same sum
    where a unit is one block, as every ``moe`` unit is: ROADMAP §C quirk
    5)."""
    new_caches = [] if caches is not None else None
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # the last layer of each unit of the block pattern, after which the
    # residual is re-pinned to the installed layout (the reference's
    # scanned unit)
    segs = segments(cfg)
    unit_ends = [bi == len(segs[si][0]) - 1
                 for si, _, bi, _ in layer_slots(cfg)]
    for i, layer in enumerate(layers):
        x, nc, a = block_forward(
            layer.kind, layer.gathered(), x, cfg, mode=mode,
            positions=positions,
            cache=caches[i] if caches is not None else None, pos=pos,
            compute_dtype=compute_dtype, kernels=kernels)
        if unit_ends[i]:
            x = dist_ctx.apply_residual(x)
        total_aux = total_aux + a
        if caches is not None:
            new_caches.append(nc)
    return x, new_caches, total_aux
