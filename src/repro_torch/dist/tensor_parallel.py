"""Tensor parallelism over the ``model`` axis of the serving mesh: the
executed plan beside ``dist.sharding.serve_params_shardings``' specs.

The reference lets GSPMD place each weight by its largest divisible dim
(``repro/dist/sharding.py:123``) and insert the collectives.  Here the
layout is Megatron's, chosen so that each layer needs one collective, and
the model code calls the collectives at tagged points
(``dist.context.apply``; identities without a context):

==========================================  ====================  =========================
leaf                                        split over ``model``  after the layer
==========================================  ====================  =========================
``attn.wq`` / ``wk`` / ``wv`` (and ``b*``)  heads, KV groups      —
``attn.wo``                                 heads                 sum (``attn_proj``)
``mlp.gate`` / ``up``                       d_ff                  —
``mlp.down``                                d_ff                  sum (``ffn_out``)
``moe.gate`` / ``up`` / ``down``            expert_d_ff           sum (``ffn_out``)
``moe.router``, norms                       none                  —
``embed``, ``head`` (a codebook each)       vocab                 lookup: sum (``embed_rows``);
                                                                  logits: all-gather (``logits``)
==========================================  ====================  =========================

Rank r of M takes KV heads ``[r·KV/M, (r+1)·KV/M)`` and the query heads of
those groups, so GQA stays grouped (M must divide KV).  d_ff, expert_d_ff
and the vocabulary split into contiguous pieces of ⌈n/M⌉, the last one
shorter where M does not divide n (granite-moe-1b-a400m's 49 155 tokens):
an all-gather of uneven pieces pads and trims them
(``collectives.all_gather_last``).  A rank's shard is a ``Model`` of
:func:`shard_config` (its heads, widths and vocabulary), so every function
of ``models`` runs on it unchanged; the residual stream stays whole on
every rank.  A rank looks up only the token ids of its vocabulary range
(``Model.vocab_range``) and zeroes the others' rows, so the sum over the
ranks is each row exactly.

The partial sums are all-reduced in f32 (``collectives.sum_over``) and
rounded once to the compute dtype: the partials of a bf16 GEMM are bf16
already, and a sum of M of them in bf16 would round M − 1 more times.
The f32 wire moves twice the bytes of a bf16 one.  ``ssm`` and ``rglru``
blocks have no tensor-parallel layout yet (ROADMAP A13): a plan over more
than one model rank refuses them by name.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import collectives
from repro_torch.dist import context as dist_ctx
from repro_torch.models import model as model_lib
from repro_torch.models import transformer as tf


@dataclasses.dataclass(frozen=True)
class Split:
    """A leaf split over the model axis along ``dim``: rank r's piece is
    ``widths[r]`` wide, starting at the sum of the widths before it."""
    dim: int
    widths: Tuple[int, ...]

    def start(self, rank: int) -> int:
        return sum(self.widths[:rank])


def pieces(n: int, m: int, what: str) -> Tuple[int, ...]:
    """Contiguous pieces of ⌈n/m⌉ over m ranks, the last one shorter
    where m does not divide n; refuses an n too small to give every rank
    a piece."""
    step = -(-n // m)
    widths = tuple(min(step, n - r * step) for r in range(m))
    if min(widths) <= 0:
        raise ValueError(f"{what} = {n} does not split over {m} model ranks")
    return widths


def check_config(cfg: ModelConfig, m: int) -> None:
    """Refuses a model that ``m`` model ranks cannot split: a block kind
    without a tensor-parallel layout, or KV heads ``m`` does not divide."""
    if m == 1:
        return
    for kind in sorted(set(cfg.blocks())):
        if kind not in tf.ATTN_KINDS:  # the kinds the plan can split
            raise ValueError(
                f"the {kind!r} blocks of {cfg.name} have no tensor-parallel "
                f"layout: serve them at model = 1 (data parallelism only); "
                f"model = {m} is not supported for them yet")
    if cfg.num_kv_heads % m:
        raise ValueError(
            f"{cfg.name}: num_kv_heads = {cfg.num_kv_heads} does not split "
            f"over {m} model ranks (each rank takes whole KV groups)")


def leaf_split(name: str, shape, cfg: ModelConfig,
               m: int) -> Optional[Split]:
    """The plan for one parameter (its ``param_dict`` name and shape):
    the dim it splits along and the pieces, or None for a leaf every
    model rank holds whole."""
    if m == 1:
        return None
    parts = name.split(".")
    top, leaf = parts[0], parts[-1]
    nd = len(shape)
    if top == "embed":                        # (V, d) or (C, V, d)
        return Split(nd - 2, pieces(shape[nd - 2], m, "vocab_size"))
    if top == "head":                         # (d, V) or (C, d, V)
        return Split(nd - 1, pieces(shape[nd - 1], m, "vocab_size"))
    if top != "layers" or leaf.startswith("norm"):
        return None
    mod = parts[2]
    if mod == "attn":
        heads = cfg.num_kv_heads if leaf in ("wk", "wv", "bk", "bv") \
            else cfg.num_heads
        widths = (heads // m,) * m
        return Split(0 if leaf in ("wo", "bq", "bk", "bv") else 1, widths)
    if mod == "mlp":
        dim = 0 if leaf == "down" else 1
        return Split(dim, pieces(shape[dim], m, "d_ff"))
    if mod == "moe":
        if leaf == "router":
            return None
        dim = 1 if leaf == "down" else 2
        return Split(dim, pieces(shape[dim], m, "expert_d_ff"))
    raise ValueError(f"{name}: the {mod!r} mixer has no tensor-parallel "
                     "layout")


def plan(cfg: ModelConfig, m: int) -> Dict[str, Optional[Split]]:
    """:func:`leaf_split` of every parameter of ``cfg``'s model (on the
    meta device), keyed by ``param_dict`` name."""
    check_config(cfg, m)
    skel = model_lib.skeleton(cfg)
    return {name: leaf_split(name, tuple(p.shape), cfg, m)
            for name, p in skel.named_parameters()}


def shard_params(full: Dict[str, torch.Tensor], the_plan, rank: int
                 ) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s shard of a full parameter dict (``param_dict``):
    each split leaf's piece, a copy of its own; each whole leaf as it
    is."""
    out = {}
    for name, t in full.items():
        s = the_plan[name]
        out[name] = t if s is None else t.narrow(
            s.dim, s.start(rank), s.widths[rank]).clone()
    return out


def gather_params(shards: List[Dict[str, torch.Tensor]], the_plan
                  ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_params`: the full dict from every
    rank's shard, in rank order."""
    return {name: (shards[0][name] if s is None else
                   torch.cat([sh[name] for sh in shards], dim=s.dim))
            for name, s in the_plan.items()}


def vocab_range(cfg: ModelConfig, m: int, rank: int) -> Tuple[int, int]:
    """[lo, hi): the token ids of rank ``rank``'s vocabulary piece."""
    widths = pieces(cfg.vocab_size, m, "vocab_size")
    lo = sum(widths[:rank])
    return lo, lo + widths[rank]


def shard_config(cfg: ModelConfig, m: int, rank: int) -> ModelConfig:
    """The config of rank ``rank``'s shard: its heads, d_ff, expert_d_ff
    and vocabulary piece (the head dim kept); ``cfg`` itself at m = 1."""
    if m == 1:
        return cfg
    check_config(cfg, m)
    lo, hi = vocab_range(cfg, m, rank)
    kw = dict(vocab_size=hi - lo, head_dim=cfg.resolved_head_dim,
              num_heads=cfg.num_heads // m,
              num_kv_heads=cfg.num_kv_heads // m)
    if cfg.d_ff:
        kw["d_ff"] = pieces(cfg.d_ff, m, "d_ff")[rank]
    if cfg.moe.num_experts:
        kw["moe"] = dataclasses.replace(
            cfg.moe, expert_d_ff=pieces(cfg.moe.expert_d_ff, m,
                                        "expert_d_ff")[rank])
    return dataclasses.replace(cfg, **kw)


def shard_skeleton(cfg: ModelConfig, m: int, rank: int) -> model_lib.Model:
    """A meta-device ``Model`` at rank ``rank``'s shard shapes, its
    vocabulary range set (at m > 1), for ``models.model.call`` with the
    rank's parameter dict."""
    skel = model_lib.skeleton(shard_config(cfg, m, rank))
    if m > 1:
        skel.vocab_range = vocab_range(cfg, m, rank)
    return skel


def slots(axis: collectives.MeshAxis, cfg: ModelConfig) -> dict:
    """The ``dist.context`` slots of the model axis: the row-parallel
    sums and the vocab-parallel embedding rows over ``axis``, the logits
    gathered over it.  None at one rank: no slot, so the model runs the
    single-process path."""
    if axis.size == 1:
        return {}
    widths = pieces(cfg.vocab_size, axis.size, "vocab_size")

    def reduce(t):
        return collectives.sum_over(t, axis)

    return {"attn_proj": reduce, "ffn_out": reduce, "embed_rows": reduce,
            "logits": lambda t: collectives.all_gather_last(t, axis,
                                                            widths)}


@contextlib.contextmanager
def model_parallel(axis: collectives.MeshAxis, cfg: ModelConfig):
    """The model axis' :func:`slots` installed for the block."""
    with dist_ctx.residual_constraint(**slots(axis, cfg)):
        yield
