"""Tensor parallelism over the ``model`` axis of the serving mesh and of a
client's ``(fsdp, model)`` block in training: the executed plan beside
``dist.sharding``'s specs.

The reference lets GSPMD place each weight by its largest divisible dim
(``repro/dist/sharding.py:123``) and insert the collectives.  Here the
layout is Megatron's, chosen so that each layer needs one collective a
projection, and the model code calls the collectives at tagged points
(``dist.context.apply``; identities without a context):

==============================  ===================  ====================
leaf                            split over model     collective after it
==============================  ===================  ====================
attn.wq, bq                     query heads          —
attn.wk, wv, bk, bv             KV heads, or one     —
                                KV head on M/KV
                                ranks
attn.wo                         query heads          sum (attn_proj)
mlp.gate, up                    d_ff                 —
mlp.down                        d_ff                 sum (ffn_out)
moe.gate, up, down              expert_d_ff, or      sum (ffn_out)
                                whole experts with
                                expert_parallel
ssm.in_proj                     columns [z_r, x_r,   —
                                B, C, dt_r]
ssm.conv_w, conv_b              [x_r, B, C]          —
ssm.A_log, D, dt_bias           SSM heads            —
ssm.norm                        d_inner channels     sum of squares
                                                     (ssm_norm)
ssm.out_proj                    d_inner rows         sum (mixer_out)
rglru.in_x, in_gate, conv_*     LRU channels         conv output gathered
                                                     (lru_gate_in)
rglru.wa, wx                    LRU columns          —
rglru.ba, bx, lam               LRU channels         —
rglru.out                       LRU rows             sum (mixer_out)
moe.router, block norms         none                 —
embed, head (a codebook each)   vocab                lookup: sum
                                                     (embed_rows);
                                                     logits: all-gather
                                                     (logits)
==============================  ===================  ====================

That is a decode step's layout, the residual whole on every rank.  A
prefill splits the residual's sequence over the model ranks between the
blocks' column- and row-parallel pieces (Megatron's sequence
parallelism, :class:`SeqSplit`; the reference's serving layout, batch
over ``data`` and sequence over ``model``): rank r holds its ⌈S/M⌉
positions (``collectives.fsdp_widths``, the last pieces shorter, or
empty where S < M), each "sum" above is a reduce-scatter of the
sequence in its place (the partials added in f32 in rank order, as the
sum adds them), the residual is gathered where it enters each
column-parallel piece (``attn_in``, ``mixer_in``, ``ffn_in``; the
MoE's input once, ``moe_in``, for its router and experts), the norms
and residual adds run on the rank's piece, and the last position
reaches every rank before the head (``last_row``).  The mixers, their
kernels and the cache writes see the whole sequence of the rank's heads
or channels either way.

In training (:class:`ClientShard`) each tag is an autograd Function of
``dist.collectives`` whose backward is its pair's forward, so that every
rank's gradient of a leaf it holds is the whole one.  With the residual
whole (``MeshConfig.residual_mode="batch"``):

================  ==========================  ===========================
slot              forward                     backward
================  ==========================  ===========================
attn_in,          identity (the whole         sum over model (each rank's
mixer_in,         residual into a column-     columns give a partial)
ffn_in, head_in   parallel piece; ``ffn_in``
                  on the MoE experts' input,
                  not the router's)
expert_gates      identity (the MoE gates     sum over model
                  that combine a rank's
                  partial expert outputs)
attn_proj,        sum over model              identity
mixer_out,
ffn_out,
embed_rows
ssm_norm          sum over model (the sums    sum over model (each rank's
                  of squares)                 channels read the whole sum)
lru_gate_in       all-gather over model       reduce-scatter over model
                  (``model_gather``)
vocab_merge       max, sums over model        (through the sums)
batch_sum         sum over fsdp (per-group    identity
                  loss sums and counts, the
                  MoE aux's sums and counts)
================  ==========================  ===========================

With the sequence split (``"batch_seq"``, the default) these take the
place of the first and third rows:

================  ==========================  ===========================
slot              forward                     backward
================  ==========================  ===========================
attn_in,          all-gather of the           reduce-scatter of the
mixer_in,         sequence's pieces           sequence (each rank's
ffn_in, head_in   (``gather_seq``)            columns give a partial)
moe_in            one all-gather, for the     the router's share: the
                  router and the experts      rank's piece (whole on
                  (``gather_seq_pair``)       every rank); the experts':
                                              reduce-scatter
attn_proj,        reduce-scatter of the       all-gather of the
mixer_out,        sequence (``scatter_seq``)  sequence's pieces
ffn_out,
embed_rows
================  ==========================  ===========================

and the block norms and the final norm, whole on every model rank but
read on the rank's piece of the sequence, pass a copy where they are
read (:meth:`ClientShard.copy_shared`): summed over model, their
gradient covers every position.

Under ``MeshConfig.param_mode="replicated"`` (:class:`ReplicatedShard`)
no weight is split: the block is data-parallel over the client's batch
rows and, under ``"batch_seq"``, its positions, and each weight's
gradient is summed over those ranks.

A range that several model ranks hold (the SSM's B and C, a KV head that
M/KV ranks share) goes through a copy where the forward reads it
(:meth:`ClientShard.copy_shared`): each rank's gradient of it flows only
through its own heads, so the sum over the ranks that hold it is the
whole gradient (over the whole model axis only where every rank holds
it), and those ranks stay equal bit for bit.

A leaf's piece is one contiguous range of a dim (``Split(dim, widths)``)
or, for ``in_proj``, the conv, a replicated KV head and their caches, a
list of ranges a rank (``Split(dim, ranges=...)``), which may be apart and
may be held by several ranks.  :func:`shard_params` cuts them and
:func:`gather_params` / :func:`gather_caches` join them, checking that the
ranks holding a range agree bit for bit.  :func:`init_shard` draws a
model's weights as ``models.model.init_params`` draws them and keeps only
the rank's piece of each part as it comes, so no rank holds the whole
model.

A rank's shard is a ``Model`` of :func:`shard_config` (its heads, widths
and vocabulary; ``configs.base.SSMShard`` and ``RGLRUShard`` for its SSM
heads and LRU channels), so every
function of ``models`` runs on it unchanged.  A rank looks up only the
token ids of its vocabulary
range (``Model.vocab_range``) and zeroes the others' rows, so the sum over
the ranks is each row exactly.

The partial sums are all-reduced in f32 (``collectives.sum_over``) and
rounded once to the compute dtype: the partials of a bf16 GEMM are bf16
already, and a sum of M of them in bf16 would round M − 1 more times.
The f32 wire moves twice the bytes of a bf16 one; a reduce-scatter of the
sequence sends the partials in the compute dtype and adds them in f32 on
arrival, the same sum in half the bytes.  The SSM's sums of
squares are f32 already; the RG-LRU's gate input crosses in the compute
dtype, exactly.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import types
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import (ModelConfig, MoEShard, RGLRUShard,
                                      SSMShard)
from repro_torch.dist import collectives
from repro_torch.dist import context as dist_ctx
from repro_torch.models import model as model_lib
from repro_torch.models import transformer as tf

Ranges = Tuple[Tuple[int, int], ...]


@dataclasses.dataclass(frozen=True)
class Split:
    """A leaf split over the model axis along ``dim``: rank r's piece is
    ``widths[r]`` wide, starting at the sum of the widths before it; or,
    with ``ranges``, rank r's piece is its ``ranges[r]`` — [lo, hi) ranges
    of ``dim``, concatenated in order — which may lie apart and may be
    held by other ranks too."""
    dim: int
    widths: Tuple[int, ...] = ()
    ranges: Tuple[Ranges, ...] = ()

    def spans(self, rank: int) -> Ranges:
        """Rank ``rank``'s [lo, hi) ranges of ``dim``, in order."""
        if self.ranges:
            return self.ranges[rank]
        lo = sum(self.widths[:rank])
        return ((lo, lo + self.widths[rank]),)

    def take(self, t: torch.Tensor, rank: int) -> torch.Tensor:
        """Rank ``rank``'s piece of ``t``, a copy of its own."""
        parts = [t.narrow(self.dim, lo, hi - lo)
                 for lo, hi in self.spans(rank)]
        return (torch.cat(parts, dim=self.dim) if len(parts) > 1
                else parts[0].clone())

    def join(self, pieces: Sequence[torch.Tensor],
             what: str = "") -> torch.Tensor:
        """The whole tensor from every rank's piece (rank order): each
        range written once, and every other rank that holds it checked
        equal to it bit for bit."""
        spans = [self.spans(r) for r in range(len(pieces))]
        n = max(hi for sp in spans for _, hi in sp)
        ref = pieces[0]
        out = ref.new_empty((*ref.shape[:self.dim], n,
                             *ref.shape[self.dim + 1:]))
        seen = [False] * n
        for r, (piece, sp) in enumerate(zip(pieces, spans)):
            at = 0
            for lo, hi in sp:
                part = piece.narrow(self.dim, at, hi - lo)
                at += hi - lo
                dst = out.narrow(self.dim, lo, hi - lo)
                if all(seen[lo:hi]):
                    if not torch.equal(dst, part):
                        raise ValueError(f"{what}: rank {r}'s copy of "
                                         f"[{lo}, {hi}) differs")
                    continue
                if any(seen[lo:hi]):
                    raise ValueError(f"{what}: ranges overlap in part")
                dst.copy_(part)
                seen[lo:hi] = [True] * (hi - lo)
        if not all(seen):
            raise ValueError(f"{what}: the pieces leave a gap")
        return out


def pieces(n: int, m: int, what: str) -> Tuple[int, ...]:
    """Contiguous pieces of ⌈n/m⌉ over m ranks, the last one shorter
    where m does not divide n; refuses an n too small to give every rank
    a piece."""
    step = -(-n // m)
    widths = tuple(min(step, n - r * step) for r in range(m))
    if min(widths) <= 0:
        raise ValueError(f"{what} = {n} does not split over {m} model ranks")
    return widths


def _even(n: int, m: int, dim: int) -> Split:
    return Split(dim, (n // m,) * m)


def check_config(cfg: ModelConfig, m: int, *,
                 expert_parallel: bool = False) -> None:
    """Refuses a model that ``m`` model ranks cannot split, naming the
    field: query heads, SSM heads or LRU channels that ``m`` does not
    divide, KV heads that neither divide nor are divided by ``m``, a
    d_ff, expert_d_ff or vocabulary smaller than ``m``, or with
    ``expert_parallel`` experts that ``m`` does not divide."""
    if m == 1:
        return
    kinds = set(cfg.blocks())

    def need(ok, field, n, how):
        if not ok:
            raise ValueError(f"{cfg.name}: {field} = {n} does not split "
                             f"over {m} model ranks ({how})")

    if kinds & set(tf.ATTN_KINDS):
        h, kv = cfg.num_heads, cfg.num_kv_heads
        need(h % m == 0, "num_heads", h, "each rank takes whole query heads")
        need(kv % m == 0 or m % kv == 0, "num_kv_heads", kv,
             "each rank takes whole KV heads, or one KV head that "
             "model / num_kv_heads ranks share")
    if "ssm" in kinds:
        need(cfg.ssm.heads(cfg.d_model) % m == 0, "the SSM heads",
             cfg.ssm.heads(cfg.d_model), "expand·d_model/d_head of them; "
             "each rank takes whole heads")
    if "rglru" in kinds:
        w = cfg.rglru.channels(cfg.d_model)
        need(w % m == 0, "lru_width", w, "each rank takes W/M channels")
    if kinds - {"ssm", "moe"}:          # the blocks with an MLP
        pieces(cfg.d_ff, m, "d_ff")
    if "moe" in kinds and expert_parallel:
        e = cfg.moe.num_experts
        need(e % m == 0, "num_experts", e, "expert parallelism: each rank "
             "takes E/M whole experts")
    elif "moe" in kinds:
        pieces(cfg.moe.expert_d_ff, m, "expert_d_ff")
    pieces(cfg.vocab_size, m, "vocab_size")


def _kv_split(kv: int, m: int, dim: int) -> Split:
    """KV heads over ``m`` ranks: KV/m a rank, or head ``r // (m/KV)``
    whole on each of its m/KV ranks."""
    if kv % m == 0:
        return _even(kv, m, dim)
    rep = m // kv
    return Split(dim, ranges=tuple(((r // rep, r // rep + 1),)
                                   for r in range(m)))


def _ssm_channels(cfg: ModelConfig, m: int, dim: int) -> Split:
    """``[x_r, B, C]`` of the conv's d_inner + 2N channels (and of the
    conv cache)."""
    s = cfg.ssm
    d_in = s.heads(cfg.d_model) * s.d_head
    c = d_in // m
    return Split(dim, ranges=tuple(
        ((r * c, (r + 1) * c), (d_in, d_in + 2 * s.d_state))
        for r in range(m)))


def _ssm_split(leaf: str, cfg: ModelConfig, m: int) -> Split:
    s = cfg.ssm
    h = s.heads(cfg.d_model)
    d_in, n = h * s.d_head, s.d_state
    if leaf == "in_proj":       # columns [z, x, B, C, dt]
        c, hr = d_in // m, h // m
        return Split(1, ranges=tuple(
            ((r * c, (r + 1) * c), (d_in + r * c, d_in + (r + 1) * c),
             (2 * d_in, 2 * d_in + 2 * n),
             (2 * d_in + 2 * n + r * hr, 2 * d_in + 2 * n + (r + 1) * hr))
            for r in range(m)))
    if leaf in ("conv_w", "conv_b"):
        return _ssm_channels(cfg, m, 1 if leaf == "conv_w" else 0)
    if leaf in ("A_log", "D", "dt_bias"):
        return _even(h, m, 0)
    if leaf in ("norm", "out_proj"):
        return _even(d_in, m, 0)
    raise ValueError(f"ssm.{leaf}: no tensor-parallel layout")


def _rglru_split(leaf: str, cfg: ModelConfig, m: int) -> Split:
    w = cfg.rglru.channels(cfg.d_model)
    if leaf in ("in_x", "in_gate", "conv_w", "wa", "wx"):
        return _even(w, m, 1)
    if leaf in ("conv_b", "ba", "bx", "lam", "out"):
        return _even(w, m, 0)
    raise ValueError(f"rglru.{leaf}: no tensor-parallel layout")


def leaf_split(name: str, shape, cfg: ModelConfig, m: int, *,
               expert_parallel: bool = False) -> Optional[Split]:
    """The plan for one parameter (its ``param_dict`` name and shape):
    how it splits, or None for a leaf every model rank holds whole.
    ``expert_parallel`` splits the MoE experts' dim 0 (E/M whole experts
    a rank) in place of their expert_d_ff."""
    if m == 1:
        return None
    parts = name.split(".")
    top, leaf = parts[0], parts[-1]
    nd = len(shape)
    if top == "embed":                        # (V, d) or (C, V, d)
        return Split(nd - 2, pieces(shape[nd - 2], m, "vocab_size"))
    if top == "head":                         # (d, V) or (C, d, V)
        return Split(nd - 1, pieces(shape[nd - 1], m, "vocab_size"))
    if top != "layers" or parts[2].startswith("norm"):
        return None
    mod = parts[2]
    if mod == "attn":
        dim = 0 if leaf in ("wo", "bq", "bk", "bv") else 1
        if leaf in ("wk", "wv", "bk", "bv"):
            return _kv_split(cfg.num_kv_heads, m, dim)
        return _even(cfg.num_heads, m, dim)
    if mod == "mlp":
        dim = 0 if leaf == "down" else 1
        return Split(dim, pieces(shape[dim], m, "d_ff"))
    if mod == "moe":
        if leaf == "router":
            return None
        if expert_parallel:
            return _even(shape[0], m, 0)
        dim = 1 if leaf == "down" else 2
        return Split(dim, pieces(shape[dim], m, "expert_d_ff"))
    if mod == "ssm":
        return _ssm_split(leaf, cfg, m)
    if mod == "rglru":
        return _rglru_split(leaf, cfg, m)
    raise ValueError(f"{name}: the {mod!r} mixer has no tensor-parallel "
                     "layout")


def plan(cfg: ModelConfig, m: int, *, expert_parallel: bool = False
         ) -> Dict[str, Optional[Split]]:
    """:func:`leaf_split` of every parameter of ``cfg``'s model (on the
    meta device), keyed by ``param_dict`` name."""
    check_config(cfg, m, expert_parallel=expert_parallel)
    skel = model_lib.skeleton(cfg)
    return {name: leaf_split(name, tuple(p.shape), cfg, m,
                             expert_parallel=expert_parallel)
            for name, p in skel.named_parameters()}


def shard_params(full: Dict[str, torch.Tensor], the_plan, rank: int
                 ) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s shard of a full parameter dict (``param_dict``):
    each split leaf's piece, a copy of its own; each whole leaf as it
    is."""
    return {name: t if the_plan[name] is None
            else the_plan[name].take(t, rank)
            for name, t in full.items()}


def gather_params(shards: List[Dict[str, torch.Tensor]], the_plan
                  ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_params`: the full dict from every
    rank's shard, in rank order; a range that several ranks hold (and a
    whole leaf) must be equal on all of them."""
    out = {}
    for name, s in the_plan.items():
        if s is None:
            for sh in shards[1:]:
                if not torch.equal(sh[name], shards[0][name]):
                    raise ValueError(f"{name}: the ranks' copies differ")
            out[name] = shards[0][name]
        else:
            out[name] = s.join([sh[name] for sh in shards], name)
    return out


def init_shard(cfg: ModelConfig, m: int, rank: int, *, generator=None,
               seed: int = 0, device="cuda", dtype=torch.float32,
               expert_parallel: bool = False) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s shard of ``models.model.init_params(cfg,
    generator=...)``: the same draws from the same generator (which ends
    where ``init_params`` leaves it), each part cut to the rank's piece as
    it is drawn, so the rank holds one layer whole at most, never the
    model."""
    the_plan = plan(cfg, m, expert_parallel=expert_parallel)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
    out = {}
    for name, part in model_lib.draw_parts(cfg, generator, device=device,
                                           dtype=dtype):
        named = (part.named_parameters(prefix=name)
                 if isinstance(part, torch.nn.Module) else [(name, part)])
        for n, t in named:
            s = the_plan[n]
            out[n] = t.detach() if s is None else s.take(t.detach(), rank)
        del part, named
    return out


def cache_plan(cfg: ModelConfig, m: int) -> List[Dict[str, Optional[Split]]]:
    """How each layer's cache (``models.model.init_cache``) splits over
    ``m`` model ranks: k/v (B, L, KV, hd) by KV heads as ``wk``; an
    ``ssm`` layer's conv (B, K − 1, d_inner + 2N) as ``[x_r, B, C]`` and
    its state (B, H, P, N) by heads; an ``rglru`` layer's conv (B, K − 1,
    W) and h (B, W) by channels."""
    check_config(cfg, m)
    out = []
    for kind in cfg.blocks():
        if m == 1:
            out.append({})
        elif kind == "ssm":
            out.append({"conv": _ssm_channels(cfg, m, 2),
                        "state": _even(cfg.ssm.heads(cfg.d_model), m, 1)})
        elif kind == "rglru":
            w = cfg.rglru.channels(cfg.d_model)
            out.append({"conv": _even(w, m, 2), "h": _even(w, m, 1)})
        else:
            kv = _kv_split(cfg.num_kv_heads, m, 2)
            out.append({"k": kv, "v": kv})
    return out


def gather_caches(shards: List[List[Dict[str, torch.Tensor]]],
                  cfg: ModelConfig) -> List[Dict[str, torch.Tensor]]:
    """Every layer's whole cache from each model rank's caches (rank
    order; the same rows on every rank): the inverse of the split that
    :func:`cache_plan` gives, a replicated KV head or the SSM's B and C
    channels checked equal across the ranks that hold them."""
    m = len(shards)
    if m == 1:
        return shards[0]
    return [{k: split[k].join([sh[i][k] for sh in shards],
                              f"layer {i} {k}") for k in split}
            for i, split in enumerate(cache_plan(cfg, m))]


def vocab_range(cfg: ModelConfig, m: int, rank: int) -> Tuple[int, int]:
    """[lo, hi): the token ids of rank ``rank``'s vocabulary piece."""
    widths = pieces(cfg.vocab_size, m, "vocab_size")
    lo = sum(widths[:rank])
    return lo, lo + widths[rank]


def shard_config(cfg: ModelConfig, m: int, rank: int, *,
                 expert_parallel: bool = False) -> ModelConfig:
    """The config of rank ``rank``'s shard: its query heads and KV heads
    (one where several ranks share a KV head), d_ff, expert_d_ff (or with
    ``expert_parallel`` its E/M experts: ``moe`` becomes a ``MoEShard``,
    ``num_experts`` kept), LRU channels (``rglru`` becomes an
    ``RGLRUShard``, ``lru_width`` kept), SSM heads (``ssm`` becomes an
    ``SSMShard``, ``expand`` kept) and vocabulary piece, the head dim
    kept; ``cfg`` itself at m = 1.  ``models.ssm`` reads a block's heads
    from its ``A_log``."""
    if m == 1:
        return cfg
    check_config(cfg, m, expert_parallel=expert_parallel)
    kinds = set(cfg.blocks())
    lo, hi = vocab_range(cfg, m, rank)
    kw = dict(vocab_size=hi - lo)
    if cfg.num_heads:
        kw.update(head_dim=cfg.resolved_head_dim,
                  num_heads=cfg.num_heads // m,
                  num_kv_heads=max(cfg.num_kv_heads // m, 1))
    if cfg.d_ff:
        kw["d_ff"] = pieces(cfg.d_ff, m, "d_ff")[rank]
    if cfg.moe.num_experts and expert_parallel:
        e = cfg.moe.num_experts // m
        kw["moe"] = MoEShard(**dataclasses.asdict(cfg.moe),
                             expert_lo=rank * e, rank_experts=e)
    elif cfg.moe.num_experts:
        kw["moe"] = dataclasses.replace(
            cfg.moe, expert_d_ff=pieces(cfg.moe.expert_d_ff, m,
                                        "expert_d_ff")[rank])
    if "rglru" in kinds:
        kw["rglru"] = RGLRUShard(**dataclasses.asdict(cfg.rglru),
                                 rank_channels=cfg.rglru.channels(
                                     cfg.d_model) // m)
    if "ssm" in kinds:
        kw["ssm"] = SSMShard(**dataclasses.asdict(cfg.ssm),
                             rank_heads=cfg.ssm.heads(cfg.d_model) // m)
    return dataclasses.replace(cfg, **kw)


def shard_skeleton(cfg: ModelConfig, m: int, rank: int, *,
                   expert_parallel: bool = False) -> model_lib.Model:
    """A meta-device ``Model`` at rank ``rank``'s shard shapes, its
    vocabulary range set (at m > 1), for ``models.model.call`` with the
    rank's parameter dict."""
    skel = model_lib.skeleton(shard_config(cfg, m, rank,
                                           expert_parallel=expert_parallel))
    if m > 1:
        skel.vocab_range = vocab_range(cfg, m, rank)
    return skel


class SeqSplit:
    """The residual's sequence split over the model axis for one forward
    (Megatron's sequence parallelism): rank r holds positions of its piece
    of ⌈S/M⌉ (``collectives.fsdp_widths``: the last pieces shorter, or
    empty where S < M).  The split is made once, where the embedding rows
    return (:meth:`scatter`, which reads S); every gather of the same
    forward joins S positions.  ``autograd``: in training, each collective
    is a ``dist.collectives`` autograd Function whose backward is its
    pair's forward."""

    def __init__(self, axis: collectives.MeshAxis):
        self.axis, self.n = axis, None

    def scatter(self, x):
        """The embedding rows' partials (B, S, …): this rank's piece of
        their sum, S recorded for the gathers."""
        self.n = x.shape[1]
        return self.reduce(x)

    def reduce(self, x):
        """A row-parallel output's partials over the whole sequence: this
        rank's piece of their sum (f32, rank order, rounded once)."""
        if x.shape[1] != self.n:
            raise ValueError(f"a partial of {x.shape[1]} positions where "
                             f"the split sequence has {self.n}")
        return collectives.scatter_seq(x, self.axis)

    def gather(self, x):
        """The whole sequence where the residual enters a column-parallel
        piece."""
        return collectives.gather_seq(x, self.axis, self.n)

    def gather_pair(self, x):
        """The whole sequence for the MoE: (the router's, the experts')."""
        return collectives.gather_seq_pair(x, self.axis, self.n)

    def last(self, x):
        """The sequence's last position, on every rank."""
        return collectives.last_position(x, self.axis, self.n)

    def take(self, x):
        """This rank's piece of a sequence (B, S, …) that every rank holds
        whole, S recorded for the gathers (the residual of replicated
        weights, :class:`ReplicatedShard`)."""
        self.n = x.shape[1]
        return self.own(x)

    def own(self, x):
        """This rank's piece of a whole sequence (B, S, …) that this rank
        computed itself: a slice, whose gradient is zero elsewhere, so the
        sum of the ranks' gradients counts each position once."""
        widths = collectives.fsdp_widths(self.n, self.axis.size)
        r = self.axis.rank
        return x.narrow(1, sum(widths[:r]), widths[r])


def seq_slots(split: SeqSplit) -> dict:
    """The ``dist.context`` slots of a sequence split: the gathers where
    the residual enters a column-parallel piece (``attn_in``,
    ``mixer_in``, ``ffn_in``, ``head_in``; ``moe_in``, once for the MoE's
    router and experts), the reduce-scatters where a row-parallel output
    returns (``attn_proj``, ``mixer_out``, ``ffn_out``; ``embed_rows``,
    which makes the split) and the last position (``last_row``)."""
    return dict(attn_in=split.gather, mixer_in=split.gather,
                ffn_in=split.gather, head_in=split.gather,
                moe_in=split.gather_pair, attn_proj=split.reduce,
                mixer_out=split.reduce, ffn_out=split.reduce,
                embed_rows=split.scatter, last_row=split.last)


def slots(axis: collectives.MeshAxis, cfg: ModelConfig, *,
          seq: bool = False) -> dict:
    """The ``dist.context`` slots of the serving mesh's model axis: the
    SSM's sums of squares (``ssm_norm``) summed over ``axis``, the RG-LRU's
    gate input and the logits gathered over it; with ``seq`` (a prefill)
    the residual's sequence split over it (:func:`seq_slots`), else the
    residual whole on every rank and the row-parallel sums
    (``attn_proj``, ``mixer_out``, ``ffn_out``) and the vocab-parallel
    embedding rows (``embed_rows``) all-reduced.  None at one rank: no
    slot, so the model runs the single-process path."""
    m = axis.size
    if m == 1:
        return {}
    widths = pieces(cfg.vocab_size, m, "vocab_size")
    lru = (cfg.rglru.channels(cfg.d_model) // m,) * m

    def reduce(t):
        return collectives.sum_over(t, axis)

    out = {"ssm_norm": reduce,
           "lru_gate_in": lambda t: collectives.all_gather_last(t, axis,
                                                                lru),
           "logits": lambda t: collectives.all_gather_last(t, axis, widths)}
    if seq:
        out.update(seq_slots(SeqSplit(axis)))
    else:
        out.update(attn_proj=reduce, mixer_out=reduce, ffn_out=reduce,
                   embed_rows=reduce)
    return out


@contextlib.contextmanager
def model_parallel(axis: collectives.MeshAxis, cfg: ModelConfig, *,
                   seq: bool = False):
    """The model axis' :func:`slots` installed for the block."""
    with dist_ctx.residual_constraint(**slots(axis, cfg, seq=seq)):
        yield


# ---------------------------------------------------------------------------
# training: one client's weights over its (fsdp, model) block
# ---------------------------------------------------------------------------

PARAM_MODES = ("fsdp2d", "replicated")


def check_train(cfg: ModelConfig, fsdp: int, model: int, *,
                param_mode: str = "fsdp2d", expert_parallel: bool = False,
                seq: bool = False) -> None:
    """Refuses by name what training over a client's ``fsdp × model``
    block does not run: an unknown ``param_mode``; under ``"replicated"``
    with the sequence split over model (``seq``) a model with prefix
    tokens (its head drops the prefix positions from the whole sequence);
    then, in either mode, what :func:`check_config` refuses.  Every block
    kind trains, and ``expert_parallel`` splits the MoE experts over
    model under ``"fsdp2d"`` (``"replicated"`` keeps them whole, as the
    reference's ``param_shardings`` skips their pin there).  Nothing at
    ``fsdp = model = 1``."""
    if fsdp * model == 1:
        return
    where = f"in training over fsdp × model = {fsdp} × {model}"
    if param_mode not in PARAM_MODES:
        raise ValueError(f"param_mode={param_mode!r} {where}: one of "
                         f"{PARAM_MODES}")
    if (param_mode == "replicated" and seq and model > 1
            and cfg.num_prefix_tokens):
        raise ValueError(
            f"param_mode='replicated' with the sequence split over model "
            f"{where}: {cfg.name} has {cfg.num_prefix_tokens} prefix "
            "tokens, whose positions the head drops from the whole "
            "sequence; use residual_mode='batch'")
    check_config(cfg, model, expert_parallel=expert_parallel)


def merge_partials(m, l, z, axis: collectives.MeshAxis):
    """The vocabulary pieces' per-token partials over the model axis:
    (M, L, Z) with M = max m, L = Σ l·e^(m − M), Z = Σ z (``nll = M +
    log L − Z``).  M is taken without a gradient (the NLL does not depend
    on it); L and Z are :func:`collectives.axis_sum`, so each rank's
    gradient of its own l and z is the whole one."""
    big = collectives.axis_max(m.detach(), axis)
    return (big, collectives.axis_sum(l * torch.exp(m - big), axis),
            collectives.axis_sum(z, axis))


def fsdp_rows(batch: dict, fsdp: collectives.MeshAxis) -> dict:
    """This fsdp rank's rows of one client's (B, …) batch."""
    f, r = fsdp.size, fsdp.rank
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % f:
            raise ValueError(f"a client's batch of {b} rows does not "
                             f"split over {f} fsdp ranks")
        out[k] = v[r * (b // f):(r + 1) * (b // f)]
    return out


class _Span(NamedTuple):
    """One range [lo, hi) of a rank's piece of a split leaf, of a dim n
    wide: where it starts in the piece, how many model ranks hold it, and
    whether no model rank before this one does."""
    start: int
    lo: int
    hi: int
    n: int
    holders: int
    first: bool


class LayerPieces:
    """One layer of a :class:`ShardedModel`: ``gathered()`` is the layer
    as ``models.transformer.block_forward`` reads it, every weight
    all-gathered over fsdp at that call."""

    def __init__(self, owner: "ShardedModel", kind: str,
                 names: List[Tuple[str, str, str]]):
        self.kind = kind
        self._owner, self._names = owner, names

    def gathered(self):
        out: dict = {}
        for name, head, leaf in self._names:
            w = self._owner.weight(name)
            if leaf:
                out.setdefault(head, {})[leaf] = w
            else:
                out[head] = w
        return types.SimpleNamespace(kind=self.kind, **out)


class ShardedModel:
    """A ``models.model.Model`` read from this rank's pieces of a client's
    weights (``x``, keyed by ``param_dict`` name): each weight
    all-gathered over fsdp where the forward first reads it
    (``collectives.fsdp_gather``, whose backward reduce-scatters its
    gradient), a layer's at the layer's entry, and kept for the rest of
    the forward: a tied embedding, read by the lookup and the head, is
    gathered and reduce-scattered once.  Over ``model`` it is the rank's
    tensor-parallel shard (its ``cfg`` and ``vocab_range``).  One instance
    serves one forward (``ClientShard.model_of``)."""

    def __init__(self, shard: "ClientShard", x: Dict[str, torch.Tensor]):
        self.cfg = shard.skel.cfg
        self.vocab_range = shard.skel.vocab_range
        self._shard, self._x = shard, x
        self._gathered: Dict[str, torch.Tensor] = {}
        per_layer: Dict[int, list] = {}
        for name in x:
            parts = name.split(".")
            if parts[0] == "layers":
                rest = ".".join(parts[2:])
                head, _, leaf = rest.partition(".")
                per_layer.setdefault(int(parts[1]), []).append(
                    (name, head, leaf))
        self.layers = [LayerPieces(self, kind, per_layer[i])
                       for i, kind in enumerate(self.cfg.blocks())]

    def weight(self, name: str) -> torch.Tensor:
        if name not in self._gathered:
            self._gathered[name] = self._shard.copy_shared(
                name, collectives.fsdp_gather(
                    self._x[name], self._shard.fsdp, self._shard.rows[name]))
        return self._gathered[name]

    @property
    def embed(self):
        return self.weight("embed")

    @property
    def final_norm(self):
        return self.weight("final_norm")

    @property
    def head(self):
        return self.weight("head") if "head" in self._x else None


class ClientShard:
    """This rank's piece of one client's weights on the client's ``(fsdp,
    model)`` block of the decentralized mesh.  Over ``model`` a leaf is
    split by the serving mesh's plan (:func:`plan`: heads, SSM heads, LRU
    channels, d_ff or expert_d_ff — with ``expert_parallel`` whole experts
    — and the vocabulary; norms and the router whole); over ``fsdp`` the
    rank's model piece is split once more along its dim 0 in pieces of
    ⌈n/F⌉ (``collectives.fsdp_widths``, the last ones shorter or empty), so
    the block's F·M ranks hold one copy of the client between them (and
    the ranges that several model ranks hold, once each of them).  The
    state's leaves (x, cx) hold these pieces; y stays whole on every rank
    of the block.  The client's batch rows split over fsdp
    (:meth:`batch`).  ``block``: all the client's ranks (sums over the
    pieces, :meth:`block_sum`).  ``seq``: the residual's sequence split
    over ``model`` between the column- and row-parallel pieces
    (``MeshConfig.residual_mode="batch_seq"``, :class:`SeqSplit`), else
    whole on every model rank (``"batch"``)."""

    def __init__(self, cfg: ModelConfig, fsdp: collectives.MeshAxis,
                 model: collectives.MeshAxis,
                 block: collectives.MeshAxis = collectives.MeshAxis(0, 1),
                 *, expert_parallel: bool = False, seq: bool = False):
        self.cfg, self.fsdp, self.model, self.block = cfg, fsdp, model, block
        self.expert_parallel = expert_parallel
        self.seq = seq and model.size > 1
        self.plan = plan(cfg, model.size, expert_parallel=expert_parallel)
        self.skel = shard_skeleton(cfg, model.size, model.rank,
                                   expert_parallel=expert_parallel)
        self.rows = {name: p.shape[0]
                     for name, p in self.skel.named_parameters()}
        self.shared = {name: spans for name, spans in
                       ((n, self._spans(s)) for n, s in self.plan.items())
                       if any(sp.holders > 1 for sp in spans)}
        # the whole leaves that read the rank's piece of a split sequence
        self.on_pieces = ({name for name, s in self.plan.items()
                           if s is None and name.split(".")[-1] in
                           ("norm1", "norm2", "final_norm")}
                          if self.seq else set())

    def _spans(self, s: Optional[Split]) -> List["_Span"]:
        """Each range of this rank's piece of a leaf split by ``s``, along
        ``s.dim``."""
        if s is None:
            return []
        r, out, at = self.model.rank, [], 0
        n = max(hi for q in range(self.model.size) for _, hi in s.spans(q))
        for lo, hi in s.spans(r):
            holders = [q for q in range(self.model.size)
                       if (lo, hi) in s.spans(q)]
            out.append(_Span(at, lo, hi, n, len(holders), holders[0] == r))
            at += hi - lo
        return out

    def copy_shared(self, name: str, w: torch.Tensor) -> torch.Tensor:
        """``name``'s gathered model piece ``w`` with each range that other
        model ranks hold too through a copy whose backward sums its
        gradient over the ranks that hold it: each of them computes only
        its heads' part of such a range's gradient (the SSM's B and C
        columns and channels, a KV head that several ranks share), so
        that sum is the whole gradient, the same on each of them.  A range
        every model rank holds goes through ``collectives.axis_copy``; one
        that only some hold (a KV head on M/KV of the M ranks, 1 < KV < M)
        is placed at its own offset in zeros as wide as the leaf's dim,
        copied so, and cut back out, so that the sum over model adds each
        range's holders only.  A leaf every model rank holds whole that
        reads only the rank's piece of a split sequence (a block norm, the
        final norm: :attr:`on_pieces`) goes through ``axis_copy`` too: its
        gradient covers the rank's positions, and the sum over model is
        the whole one.  ``w`` itself where the rank holds no such
        range."""
        if name in self.on_pieces:
            return collectives.axis_copy(w, self.model)
        spans = self.shared.get(name)
        if not spans:
            return w
        dim = self.plan[name].dim
        m = self.model.size

        def one(sp: _Span):
            part = w.narrow(dim, sp.start, sp.hi - sp.lo)
            if sp.holders == 1:
                return part
            if sp.holders == m:
                return collectives.axis_copy(part, self.model)
            pad = [0, 0] * (part.dim() - 1 - dim) + [sp.lo, sp.n - sp.hi]
            wide = collectives.axis_copy(
                torch.nn.functional.pad(part, pad), self.model)
            return wide.narrow(dim, sp.lo, sp.hi - sp.lo)

        if len(spans) == 1:
            return one(spans[0])
        return torch.cat([one(sp) for sp in spans], dim=dim)

    def piece(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's fsdp piece of ``name``'s model piece ``t``."""
        widths = collectives.fsdp_widths(self.rows[name], self.fsdp.size)
        lo = sum(widths[:self.fsdp.rank])
        return t.narrow(0, lo, widths[self.fsdp.rank]).clone()

    def take(self, full: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        """This rank's pieces of a whole client's parameter dict."""
        return {name: self.piece(name, t) for name, t in
                shard_params(full, self.plan, self.model.rank).items()}

    def init(self, generator, *, device, dtype=torch.float32
             ) -> Dict[str, torch.Tensor]:
        """This rank's pieces of ``models.model.init_params(cfg,
        generator=...)``, the generator left where that leaves it
        (:func:`init_shard`)."""
        mine = init_shard(self.cfg, self.model.size, self.model.rank,
                          generator=generator, device=device, dtype=dtype,
                          expert_parallel=self.expert_parallel)
        return {name: self.piece(name, t) for name, t in mine.items()}

    def batch(self, batch: dict) -> dict:
        """This fsdp rank's rows of one client's (B, …) batch."""
        return fsdp_rows(batch, self.fsdp)

    def model_of(self, x: Dict[str, torch.Tensor]) -> ShardedModel:
        return ShardedModel(self, x)

    def owned(self) -> Dict[str, object]:
        """Which elements of each of its pieces this rank counts in a sum
        over the block: a leaf every model rank holds whole (a norm, the
        router) on model rank 0 only; a range several model ranks hold (a
        replicated KV head, the SSM's B and C) on the first of them —
        True or False for a whole piece, else a 0/1 f32 mask along the
        split dim, cut to the rank's fsdp piece where that dim is 0, that
        broadcasts against the piece (``collectives.BlockSum``)."""
        r = self.model.rank
        out: Dict[str, object] = {}
        for name, s in self.plan.items():
            if s is None:
                out[name] = r == 0
                continue
            flags = [sp.first for sp in self._spans(s)
                     for _ in range(sp.hi - sp.lo)]
            if s.dim == 0:
                widths = collectives.fsdp_widths(self.rows[name],
                                                 self.fsdp.size)
                lo = sum(widths[:self.fsdp.rank])
                flags = flags[lo:lo + widths[self.fsdp.rank]]
            if all(flags) or not any(flags):
                out[name] = bool(flags) and flags[0]
                continue
            nd = self.skel.get_parameter(name).dim()
            shape = [1] * nd
            shape[s.dim] = len(flags)
            out[name] = torch.tensor(flags, dtype=torch.float32).reshape(
                shape)
        return out

    def block_sum(self) -> collectives.BlockSum:
        """The sum over the block of elementwise terms of the pieces, each
        element counted once."""
        return collectives.BlockSum(self.block, self.owned())

    def slots(self) -> dict:
        """The ``dist.context`` slots of training on the block, for one
        forward.  Over ``model``: the copies where the whole residual
        enters a column-parallel piece (``attn_in``, ``mixer_in``,
        ``ffn_in``, ``head_in``) and on the MoE gates that combine a
        rank's partial expert outputs (``expert_gates``); the row-parallel
        sums (``attn_proj``, ``mixer_out``, ``ffn_out``, ``embed_rows``);
        with :attr:`seq`, in place of those copies and sums, the
        sequence's gathers and reduce-scatters (:func:`seq_slots`); the
        SSM's sums of squares, a sum whose gradient is summed too
        (``ssm_norm``: each rank's channels read the whole sum); the
        RG-LRU's gate input gathered, its gradient reduce-scattered
        (``lru_gate_in``); the vocabulary pieces' partial log-sum-exps
        merged (``vocab_merge``).  Over ``fsdp``: the per-group loss sums
        and token counts and the MoE aux's sums and counts
        (``batch_sum``).  None of them at one rank."""
        out = {}
        mod, fs = self.model, self.fsdp
        if mod.size > 1:
            def copy(t):
                return collectives.axis_copy(t, mod)

            def total(t):
                return collectives.axis_sum(t, mod)

            out.update(attn_in=copy, mixer_in=copy, ffn_in=copy,
                       head_in=copy, expert_gates=copy,
                       attn_proj=total, mixer_out=total, ffn_out=total,
                       embed_rows=total,
                       ssm_norm=lambda t: copy(total(t)),
                       lru_gate_in=lambda t: collectives.model_gather(t,
                                                                      mod),
                       vocab_merge=lambda m, l, z: merge_partials(m, l, z,
                                                                  mod))
            if self.seq:
                out.update(seq_slots(SeqSplit(mod)))
        if fs.size > 1:
            out["batch_sum"] = lambda t: collectives.axis_sum(
                t, fs, "batch_sum")
        return out


class ReplicatedShard:
    """A client's weights whole on every rank of its ``(fsdp, model)``
    block (``MeshConfig.param_mode="replicated"``, the reference's
    ``param_shardings`` at ``repro/dist/sharding.py:103``): the block is
    data-parallel over the client's tokens.  The state's leaves (x, cx)
    and y are whole on every rank; the client's batch rows split over
    fsdp (:meth:`batch`).  ``seq``: the residual's sequence split over
    ``model`` too (``MeshConfig.residual_mode="batch_seq"``, the
    reference's residual constraint at ``repro/dist/sharding.py:157-171``),
    else the model ranks hold the same rows (``"batch"``).

    Each weight enters the forward through ``collectives.axis_copy`` over
    the ranks that hold the client's tokens (the block under ``seq``, else
    fsdp; counted as ``grad_sum``): an identity whose backward sums the
    ranks' gradients in f32, in rank order, rounded once, so every rank
    gets the client's whole gradient.  The per-group loss sums and counts
    and the MoE aux's sums and counts are summed over the same ranks
    (``batch_sum``).  The vocabulary is whole, so the head runs the
    whole-vocabulary B6.

    Under ``seq`` (:class:`SeqSplit` of the model axis) the embedding rows
    are taken to the rank's piece of the positions (``embed_out``, and
    RoPE's positions: ``seq_pos``), the norms, the residual adds, the
    mixers' in- and out-projections, the MLPs and the head run on it, and
    the labels and groups are cut to it (:meth:`batch`).  What a mixer
    needs over the whole sequence is gathered after its in-projection, in
    one gather a mixer (``seq_in``: attention's q, k and v; the SSD's
    conv and scan inputs; the RG-LRU's conv input; the gather's backward
    reduce-scatters), so attention and its kernel, the convs, the RG-LRU
    gates and the scans run on the whole sequence on every model rank,
    and their output is cut back to the rank's piece before the gating
    and the out-projection (``attn_out``, ``seq_out``).  Each MoE (whose
    routing and capacity read a batch row's whole sequence) runs on the
    whole sequence, gathered at its input (``moe_in``) and cut back at its
    output (``moe_out``); the MoE aux reads the rank's piece of the
    router's probabilities (``aux_rows``).  Each position's gradient comes
    from the one rank that holds it.

    The gossip is the clients axis' as under ``"fsdp2d"``: the rank at
    the same block position in every client, here on the whole client
    (F·M times ``fsdp2d``'s wire).  The same duck type as
    :class:`ClientShard` for ``core.objectives.dro_problem(shard=)``,
    ``engine.diagnostics.dro_metrics_fn`` and ``launch.steps``."""

    def __init__(self, cfg: ModelConfig, fsdp: collectives.MeshAxis,
                 model: collectives.MeshAxis,
                 block: collectives.MeshAxis = collectives.MeshAxis(0, 1),
                 *, seq: bool = False):
        self.cfg, self.fsdp_axis, self.model, self.block = (cfg, fsdp,
                                                            model, block)
        self.seq = seq and model.size > 1
        self.tokens = block if self.seq else fsdp
        # ShardedModel reads the weights whole: no fsdp gather
        self.fsdp = collectives.MeshAxis(0, 1)
        self.skel = model_lib.skeleton(cfg)
        self.rows = {name: p.shape[0]
                     for name, p in self.skel.named_parameters()}
        self.shared = {}

    def copy_shared(self, name: str, w: torch.Tensor) -> torch.Tensor:
        """``w`` through the copy whose backward sums its gradient over
        the token ranks."""
        return collectives.axis_copy(w, self.tokens, "grad_sum")

    def take(self, full: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        """A whole client's parameter dict, copied (every rank holds it)."""
        return {name: t.clone() for name, t in full.items()}

    def init(self, generator, *, device, dtype=torch.float32
             ) -> Dict[str, torch.Tensor]:
        """``models.model.init_params(cfg, generator=...)``'s dict."""
        return model_lib.param_dict(model_lib.init_params(
            self.cfg, generator=generator, device=device, dtype=dtype))

    def batch(self, batch: dict) -> dict:
        """This fsdp rank's rows of one client's (B, …) batch; under
        :attr:`seq` its labels and groups cut to the rank's piece of the
        positions (the tokens stay whole: the embedding's rows are cut
        after the lookup)."""
        rows = fsdp_rows(batch, self.fsdp_axis)
        if not self.seq:
            return rows
        split = SeqSplit(self.model)
        split.n = rows["tokens"].shape[1]
        return {k: (split.own(v) if k in ("labels", "groups") else v)
                for k, v in rows.items()}

    def model_of(self, x: Dict[str, torch.Tensor]) -> "ShardedModel":
        return ShardedModel(self, x)

    def owned(self) -> Dict[str, bool]:
        """Every leaf whole on this rank: all counted here."""
        return {name: True for name in self.rows}

    def block_sum(self) -> collectives.BlockSum:
        """The rank's own sum: it holds the whole client."""
        return collectives.BlockSum(collectives.MeshAxis(0, 1),
                                    self.owned())

    def slots(self) -> dict:
        """The ``dist.context`` slots of one forward: the loss's and the
        MoE aux's sums and counts over the token ranks (``batch_sum``);
        under :attr:`seq` the sequence's piece taken after the embedding
        (``embed_out``, ``seq_pos``), each mixer's projected inputs
        gathered (``seq_in``) and its output cut back before its
        out-projection (``attn_out``, ``seq_out``), each MoE's input
        gathered and its output cut back, and the MoE aux on the rank's
        positions (``aux_rows``)."""
        out = {}
        if self.tokens.size > 1:
            out["batch_sum"] = lambda t: collectives.axis_sum(
                t, self.tokens, "batch_sum")
        if self.seq:
            split = SeqSplit(self.model)

            def both(t):
                whole = split.gather(t)
                return whole, whole

            def seq_in(ts):
                """(B, s, …) pieces of one dtype joined in one gather."""
                widths = [math.prod(t.shape[2:]) for t in ts]
                whole = split.gather(torch.cat(
                    [t.reshape(*t.shape[:2], w) for t, w in zip(ts, widths)],
                    dim=-1))
                return tuple(
                    p.reshape(*whole.shape[:2], *t.shape[2:])
                    for p, t in zip(torch.split(whole, widths, dim=-1), ts))

            out.update(embed_out=split.take, seq_pos=split.own,
                       seq_in=seq_in, attn_out=split.own,
                       seq_out=split.own, moe_in=both, moe_out=split.own,
                       aux_rows=split.own)
        return out


def gather_client(shards: Sequence[Dict[str, torch.Tensor]],
                  cfg: ModelConfig, fsdp: int, model: int, *,
                  expert_parallel: bool = False
                  ) -> Dict[str, torch.Tensor]:
    """One client's whole parameter dict from the pieces of its block's
    ranks, in block order (fsdp rank f, model rank m at ``f·model + m``):
    the fsdp pieces joined along dim 0, then the model pieces
    (:func:`gather_params`, which checks the replicated ones equal)."""
    pieces_m = [{name: torch.cat([shards[f * model + m][name]
                                  for f in range(fsdp)])
                 for name in shards[m]} for m in range(model)]
    if model == 1:
        return pieces_m[0]
    return gather_params(pieces_m, plan(cfg, model,
                                        expert_parallel=expert_parallel))
