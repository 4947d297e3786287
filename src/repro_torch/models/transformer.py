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

With ``remat`` (training only, ``MeshConfig.remat``) each unit of the
block pattern runs through :class:`UnitRemat`, the reference's
``jax.checkpoint`` of its scanned unit: the unit's input saved, the unit
run again in the backward under ``torch.func.vjp``.  With whole weights
over a split sequence (``tensor_parallel.ReplicatedShard``) the mixers'
and the MoE's inputs are gathered at ``attn_in`` / ``mixer_in`` /
``moe_in`` and their outputs cut back to the rank's positions at
``attn_proj`` / ``mixer_out`` / ``moe_out``.

Modes: ``prefill`` runs the CUDA kernels (``kernels.ops.flash_attention``,
``rglru_scan``, ``ssd_scan``) and fills the caches; ``train`` runs them
too, under autograd as well (each kernel's gradient is an autograd
Function); ``decode`` advances one token against the caches in plain
PyTorch.
"""
from __future__ import annotations

import types
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
                                   dist_ctx.apply("seq_pos", positions),
                                   compute_dtype)
    # the whole sequence of q, k and v where each rank projected its piece
    q, k, v = dist_ctx.apply("seq_in", (q, k, v))
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
        # back to the rank's positions where the MoE ran on the whole
        # gathered sequence with whole weights (``moe_in``)
        y2 = dist_ctx.apply("moe_out", y2)
    else:
        y2 = mlp(params.mlp, dist_ctx.apply("ffn_in", h2), compute_dtype)
    y2 = dist_ctx.apply("ffn_out", y2)  # the ffn shards' partial sums
    return x + y2, new_cache, aux


def _unit_layer(kind: str, heads: List[str], leaves: List[str],
                weights) -> types.SimpleNamespace:
    """A layer as :func:`block_forward` reads it, from its weights in the
    order of ``heads`` / ``leaves`` (a sub-dict's leaf, or '' for a whole
    leaf such as a norm)."""
    out: dict = {}
    for head, leaf, w in zip(heads, leaves, weights):
        if leaf:
            out.setdefault(head, {})[leaf] = w
        else:
            out[head] = w
    return types.SimpleNamespace(kind=kind, **out)


def _layer_weights(layer) -> Tuple[List[str], List[str], list]:
    """(heads, leaves, tensors) of a layer as :func:`block_forward` reads
    it: a ``Block``'s parameters (under ``torch.func.functional_call``
    the tensors it was given), or a sharded layer's gathered weights (a
    namespace of tensors and dicts of tensors)."""
    if isinstance(layer, nn.Module):
        named = list(layer.named_parameters())
    else:
        named = []
        for head, v in vars(layer).items():
            if isinstance(v, dict):
                named.extend((f"{head}.{leaf}", w) for leaf, w in v.items())
            elif head != "kind":
                named.append((head, v))
    parts = [name.partition(".") for name, _ in named]
    return ([h for h, _, _ in parts], [leaf for _, _, leaf in parts],
            [w for _, w in named])


class UnitRemat(torch.autograd.Function):
    """One unit of the block pattern under activation checkpointing (the
    reference's ``jax.checkpoint(unit_fn)`` in training,
    ``repro/models/transformer.py:244``): the forward runs the unit
    without a graph and saves only its inputs (the residual, the aux so
    far and the unit's layers' weights, as the forward reads them); the
    backward runs the unit again under ``torch.func.vjp`` and returns
    that vjp of the cotangents of (residual, aux).  ``torch.utils.
    checkpoint`` cannot take its place: its saved-tensor hooks are refused
    under the ``torch.func.vmap(grad)`` that takes the clients'
    gradients.  The vmap rule is generated: forward and backward are
    written in transformable ops.

    ``run(x, aux, positions, *weights) -> (x, aux)`` is the unit's
    forward (every tensor it reads is an input), with the
    ``dist.context`` slots of the forward installed again (the backward
    runs after the forward's context has exited).  On a
    client's (fsdp, model) block the weights are those the layer's
    ``gathered()`` gave, all-gathered over fsdp once, before the unit: the
    recompute gathers nothing again, and the fsdp reduce-scatter of each
    weight's gradient runs once, in the gather's own backward.  Every
    collective inside the unit (the sequence's gathers and reduce-scatters,
    the model axis' copies and sums, the MoE's gather) and every kernel
    runs twice, once a run, and its backward once."""
    generate_vmap_rule = True

    @staticmethod
    def forward(run, x, aux, positions, *weights):
        with torch.no_grad():
            return run(x, aux, positions, *weights)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.run = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, g_x, g_aux):
        x, aux, positions, *weights = ctx.saved_tensors
        g_x = torch.zeros_like(x) if g_x is None else g_x
        g_aux = torch.zeros_like(aux) if g_aux is None else g_aux
        _, vjp = torch.func.vjp(
            lambda xx, a, *ws: ctx.run(xx, a, positions, *ws),
            x, aux, *weights)
        g_x, g_aux, *g_w = vjp((g_x, g_aux))
        return (None, g_x, g_aux, None, *g_w)


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
    remat: bool = False,
):
    """Run every layer.  ``caches`` is a list with one entry per layer (or
    None).  Returns (x, new_caches, total_aux): the sum of every layer's
    aux, added in layer order (the reference adds each unit's last
    block's aux, the same sum where a unit is one block, as every ``moe``
    unit is: ROADMAP §C quirk 5).

    The layers run unit by unit of the block pattern (``segments``), the
    residual re-pinned to the installed layout after each unit (the
    reference's scanned unit).  ``remat`` (training only: prefill, decode
    and evaluation ignore it, as the reference's ``mode == "train"`` test
    does) runs each unit through :class:`UnitRemat`; the values and the
    gradient are those without it, bit for bit, where the unit's ops are
    deterministic."""
    new_caches = [] if caches is not None else None
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    slots = layer_slots(cfg)
    segs = segments(cfg)
    checkpoint = remat and mode == "train"
    # the recompute runs after the forward's context has exited
    installed = dist_ctx.current_slots() if checkpoint else {}
    i = 0
    while i < len(layers):
        si = slots[i][0]
        n_unit = len(segs[si][0])
        unit = [(layers[j].kind, layers[j].gathered())
                for j in range(i, i + n_unit)]
        unit_caches = (caches[i:i + n_unit] if caches is not None
                       else [None] * n_unit)

        def run_unit(xx, aux, views, positions, unit_caches=unit_caches):
            ncs = []
            for (kind, params), c in zip(views, unit_caches):
                xx, nc, a = block_forward(
                    kind, params, xx, cfg, mode=mode, positions=positions,
                    cache=c, pos=pos, compute_dtype=compute_dtype,
                    kernels=kernels)
                aux = aux + a
                ncs.append(nc)
            return dist_ctx.apply_residual(xx), aux, ncs

        if checkpoint:
            names, flat = [], []
            for kind, params in unit:
                heads, leaves, ws = _layer_weights(params)
                names.append((kind, heads, leaves))
                flat += ws

            def run(xx, aux, positions, *weights, names=names,
                    run_unit=run_unit):
                views, at = [], 0
                for kind, heads, leaves in names:
                    views.append((kind, _unit_layer(
                        kind, heads, leaves, weights[at:at + len(heads)])))
                    at += len(heads)
                with dist_ctx.residual_constraint(**installed):
                    xx, aux, _ = run_unit(xx, aux, views, positions)
                return xx, aux

            x, total_aux = UnitRemat.apply(run, x, total_aux, positions,
                                           *flat)
        else:
            x, total_aux, ncs = run_unit(x, total_aux, unit, positions)
            if caches is not None:
                new_caches.extend(ncs)
        i += n_unit
    return x, new_caches, total_aux
