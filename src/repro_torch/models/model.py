"""Top-level language model (port of ``repro.models.model``): embeddings ->
decoder stack -> head, the per-group loss of the DRO objective and of
evaluation, ``lm_loss``, cache management and the decode step.

``chunked_nll`` runs kernel B6 (``kernels.ops.fused_cross_entropy``) in
``train`` mode, under autograd too (its gradient is an autograd Function,
``kernels.cross_entropy.FusedCrossEntropyFn``), so training and evaluation
(``evaluation.metrics.group_metrics``) go through it.  Training runs a
model functionally: the parameters are a dict of tensors keyed by
``Model``'s parameter names (``param_dict``), one client's slice of the
client-stacked state, and :func:`call` runs a function of the model
through ``torch.func.functional_call`` on a parameterless skeleton
(:func:`skeleton`).

A rank of the serving mesh runs a ``Model`` of its tensor-parallel shard
(``dist.tensor_parallel``): its heads, widths and a contiguous range of
the vocabulary (``Model.vocab_range``), the collectives at tagged points
of ``dist.context`` (``embed_rows`` after the lookup, ``logits`` after the
head; identities without a context).  In a prefill, and in training under
``MeshConfig.residual_mode="batch_seq"``, the residual's sequence is split
over the model ranks between the blocks' column- and row-parallel pieces
(``tensor_parallel.SeqSplit``): ``embed_rows`` leaves each rank its piece
of the positions, and the final norm runs on it.  A rank of a client's
(fsdp, model) block in training runs the same shard from its pieces
(``tensor_parallel.ShardedModel``): the loss over its vocabulary range is
merged over the model ranks (``vocab_merge``, :func:`chunked_nll`) and
the per-group sums over the fsdp ranks' batch rows (``batch_sum``,
:func:`per_group_loss`).

The modality frontends are the reference's stubs: an audio model
(``num_codebooks`` C) embeds (B, S, C) token streams as the sum of C
per-codebook embeddings and predicts (B, S, C, V) logits, its loss the
mean over codebooks; a vision-language model (``num_prefix_tokens`` P)
takes precomputed (B, P, d) ``prefix`` embeddings in its batch, run
before the tokens and dropped after the final norm.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import context as dist_ctx
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as tf
from repro_torch.models.layers import embed_init, param, rms_norm


class Model(nn.Module):
    """Parameters of one language model, under the reference's names:
    ``embed`` (V, d), or (C, V, d) with C codebooks, ``layers`` (one
    ``transformer.Block`` per layer, in layer order), ``final_norm`` (d,)
    and, unless the embeddings are tied, ``head`` (d, V), or (C, d, V).
    ``vocab_range`` [lo, hi) is set on a tensor-parallel shard, whose V
    columns are the token ids lo … hi − 1 (None: the whole vocabulary)."""

    def __init__(self, cfg: ModelConfig, gen, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        self.vocab_range = None
        self.head = None
        for name, part in draw_parts(cfg, gen, device=device, dtype=dtype):
            if name == "embed":
                self.embed = part
                self.layers = nn.ModuleList()
            elif name.startswith("layers."):
                self.layers.append(part)
            else:
                setattr(self, name, part)

    def forward(self, fn, *args, **kw):
        """``fn(self, *args, **kw)``: what ``torch.func.functional_call``
        runs with the parameters it is given (:func:`call`)."""
        return fn(self, *args, **kw)


def draw_parts(cfg: ModelConfig, gen, *, device, dtype):
    """The parts of a ``Model`` in the order their weights are drawn from
    ``gen``, one at a time: ``("embed", parameter)``, ``("layers.i",
    Block)`` for each layer, ``("final_norm", parameter)`` and, unless the
    embeddings are tied, ``("head", parameter)``.  ``Model`` keeps them
    all; ``dist.tensor_parallel.init_shard`` keeps a rank's piece of each
    as it comes."""
    kw = dict(device=device, dtype=dtype)
    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    yield "embed", param(embed_init(gen, (*cb, cfg.vocab_size, cfg.d_model),
                                    **kw))
    for i, kind in enumerate(cfg.blocks()):
        yield f"layers.{i}", tf.Block(kind, cfg, gen, **kw)
    yield "final_norm", param(torch.zeros((cfg.d_model,), **kw))
    if not cfg.tie_embeddings:
        yield "head", param(embed_init(gen, (*cb, cfg.d_model,
                                             cfg.vocab_size), **kw))


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


def param_dict(model: Model) -> Dict[str, torch.Tensor]:
    """{parameter name: tensor} of ``model``, detached (the training
    state's form of one client's parameters)."""
    return {name: p.detach() for name, p in model.named_parameters()}


def skeleton(cfg: ModelConfig) -> Model:
    """A ``Model`` of ``cfg`` on the meta device: its structure without
    memory, for :func:`call`."""
    return Model(cfg, None, device="meta", dtype=torch.float32)


def call(skel: Model, params: Dict[str, torch.Tensor], fn, *args, **kw):
    """``fn(model, *args, **kw)`` with the model's parameters taken from
    ``params`` (every name of ``param_dict``): ``torch.func.
    functional_call`` on ``skel``, so ``grad`` and ``vmap`` see through
    it."""
    return torch.func.functional_call(skel, params, (fn, *args), kw,
                                      strict=True)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(model: Model, tokens, compute_dtype, *, prefix=None,
                 bias=None):
    """(B, S) tokens -> (B, S, d); with C codebooks (B, S, C) tokens ->
    the sum of the C codebooks' embeddings, added in codebook order in the
    compute dtype (reference :54-60); then ``bias`` (the adversarial
    objective's perturbation) added, and ``prefix`` (B, P, d) embeddings
    put before the tokens: (B, P + S, d).  A shard with a
    ``vocab_range`` looks up :func:`_shard_rows`."""
    if model.vocab_range is not None:
        return _shard_rows(model, tokens, compute_dtype, prefix, bias)
    if not model.cfg.num_codebooks:
        x = model.embed[tokens].to(compute_dtype)
    else:
        x = model.embed[0][tokens[..., 0]].to(compute_dtype)
        for c in range(1, model.cfg.num_codebooks):
            x = x + model.embed[c][tokens[..., c]].to(compute_dtype)
    if bias is not None:
        x = x + bias.to(compute_dtype)
    if prefix is not None:
        x = torch.cat([prefix.to(compute_dtype), x], dim=1)
    return x


def _shard_rows(model: Model, tokens, compute_dtype, prefix=None,
                bias=None):
    """The embedding rows of a vocab-parallel shard: ids in its range
    looked up, the others' rows zero, the C codebooks' rows (B, S, C, d)
    side by side, then summed over the model axis (``embed_rows``: one
    rank holds each row, so the sum is the row; on a split sequence a
    reduce-scatter, which leaves the rank its piece), then added in
    codebook order, as :func:`embed_tokens` adds them.  The first
    vocabulary piece's rank also carries ``bias`` (one more row a
    position) and ``prefix`` (before the tokens, in the first codebook's
    row), the other ranks zeros there, so that they cross in the same sum
    and come out exactly."""
    lo, hi = model.vocab_range
    cb = model.cfg.num_codebooks
    local = tokens - lo
    inside = (local >= 0) & (local < hi - lo)
    local = torch.where(inside, local, 0)
    if cb:
        rows = torch.stack([model.embed[c][local[..., c]]
                            for c in range(cb)], dim=-2)
        inside = inside[..., None]
    else:
        rows = model.embed[local][..., None, :]
        inside = inside[..., None, None]
    rows = torch.where(inside, rows.to(compute_dtype), 0)
    first = lo == 0
    if bias is not None:
        extra = bias.to(compute_dtype).expand(*rows.shape[:2],
                                              rows.shape[-1])
        if not first:
            extra = torch.zeros_like(extra)
        rows = torch.cat([rows, extra[..., None, :]], dim=-2)
    if prefix is not None:
        pre = rows.new_zeros((rows.shape[0], prefix.shape[1],
                              *rows.shape[2:]))
        if first:
            pre[..., 0, :] = prefix.to(compute_dtype)
        rows = torch.cat([pre, rows], dim=1)
    rows = dist_ctx.apply("embed_rows", rows)
    x = rows[..., 0, :]
    for c in range(1, rows.shape[-2]):
        x = x + rows[..., c, :]
    return x


def lm_head(model: Model, x, compute_dtype):
    """(B, S, d) -> logits (B, S, V), or (B, S, C, V) with C codebooks; a
    shard's vocabulary columns gathered over the model axis
    (``logits``)."""
    return dist_ctx.apply("logits", _head(model, x, compute_dtype))


def _head(model: Model, x, compute_dtype):
    if model.cfg.num_codebooks:
        if model.head is None:
            return torch.einsum("bsd,cvd->bscv", x,
                                model.embed.to(compute_dtype))
        return torch.einsum("bsd,cdv->bscv", x, model.head.to(compute_dtype))
    if model.head is None:
        return x @ model.embed.to(compute_dtype).T
    return x @ model.head.to(compute_dtype)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def backbone(model: Model, batch: Dict[str, Any], *, mode: str = "train",
             compute_dtype=torch.bfloat16, caches=None, pos=None,
             kernels: bool = True, last_only: bool = False,
             remat: bool = False):
    """Everything up to (and incl.) the final norm.  Returns (hidden (B,S,d),
    new_caches, aux).  A model with prefix tokens runs ``batch["prefix"]``
    (B, P, d), where the batch has one, before the token embeddings
    outside decode, positions over P + S, and drops the P positions after
    the final norm (reference :92-115); decode ignores it.
    ``last_only``: the hidden state of the last position only, (B, 1, d).
    ``remat``: each unit of the stack under activation checkpointing in
    ``train`` mode (``transformer.stack_forward``; ignored otherwise).

    On a sequence split over the model axis (``dist.tensor_parallel.
    SeqSplit``) the embedding rows' sum leaves each rank its piece of the
    positions, the blocks' norms and residual adds and the final norm run
    on it, and the last position (``last_row``) or the whole sequence
    (``head_in``) reaches every rank before the head."""
    cfg = model.cfg
    tokens = batch["tokens"]
    prefix = None
    if cfg.num_prefix_tokens and "prefix" in batch and mode != "decode":
        prefix = batch["prefix"]
    # adversarial objective: a universal perturbation of the embeddings
    x = embed_tokens(model, tokens, compute_dtype, prefix=prefix,
                     bias=batch.get("embed_bias"))
    # whole weights over a split sequence: the rank's piece of the rows
    # (``tensor_parallel.ReplicatedShard``)
    x = dist_ctx.apply("embed_out", x)
    offset = 0 if prefix is None else prefix.shape[1]
    b, s = tokens.shape[0], offset + tokens.shape[1]
    if mode == "decode" and isinstance(pos, torch.Tensor):
        positions = pos.to(torch.int32)[:, None]     # each row its own
    elif mode == "decode":
        positions = torch.full((b, 1), pos, dtype=torch.int32,
                               device=x.device)
    else:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None, :].expand(b, s)
    x, new_caches, aux = tf.stack_forward(
        model.layers, x, cfg, mode=mode, positions=positions, caches=caches,
        pos=pos, compute_dtype=compute_dtype, kernels=kernels, remat=remat)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    if last_only:
        last = dist_ctx.slot("last_row")
        return (x[:, -1:] if last is None else last(x)), new_caches, aux
    x = dist_ctx.apply("head_in", x)
    if offset:
        x = x[:, offset:]
    return x, new_caches, aux


def forward(model: Model, batch: Dict[str, Any], *, mode: str = "train",
            compute_dtype=torch.bfloat16, caches=None, pos=None,
            last_only: bool = False, kernels: bool = True,
            remat: bool = False):
    """Returns (logits, new_caches, aux).  ``last_only`` computes the head on
    the final position only (prefill servers).  ``kernels=False`` runs the
    kernels' plain versions where they would run
    (``transformer.kernel_route``); ``remat`` as :func:`backbone`'s."""
    x, new_caches, aux = backbone(
        model, batch, mode=mode, compute_dtype=compute_dtype, caches=caches,
        pos=pos, kernels=kernels, last_only=last_only, remat=remat)
    return lm_head(model, x, compute_dtype), new_caches, aux


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def token_losses(logits, labels):
    """Per-token cross-entropy in f32.  logits: (B, S, V) with labels
    (B, S), or (B, S, C, V) with labels (B, S, C), then the mean over the
    C codebooks.  Returns (B, S)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -logp.gather(-1, labels[..., None].long())[..., 0]
    return nll.mean(-1) if nll.dim() == 3 else nll


def head_weight(model: Model, compute_dtype, codebook: Optional[int] = None):
    """The head as a (V, d) operand in ``compute_dtype``: the tied
    embedding, or the untied (d, V) head's transposed view (no copy when
    the dtype already matches); with codebooks, that of ``codebook``."""
    head = model.head
    if head is None:
        embed = model.embed
        return (embed if codebook is None
                else embed[codebook]).to(compute_dtype)
    if codebook is not None:
        head = head[codebook]
    return head.to(compute_dtype).T


def chunked_nll(model: Model, hidden, labels, *, compute_dtype=torch.bfloat16,
                chunk: int = 512, kernels: bool = True):
    """Per-token NLL (B, S) f32 of the final hidden states against the head,
    without resident (B, S, V) logits.

    With ``kernels``, kernel B6 over all B·S tokens, under autograd too:
    its logits are f32 from the compute-dtype operands; with C codebooks,
    one launch a codebook (its head, its labels (B, S) of the (B, S, C)),
    then the mean of the C NLLs.  With ``kernels=False`` the reference's
    form: the head on ``chunk`` positions at a time, logits in the compute
    dtype, then an f32 log-softmax.  In bf16 the two differ by the bf16
    rounding of the logits (ROADMAP §C quirk 4).
    """
    b, s, d = hidden.shape
    merge = dist_ctx.slot("vocab_merge")
    if merge is not None:
        return _vocab_parallel_nll(model, hidden, labels, merge,
                                   compute_dtype, chunk, kernels)
    if tf.kernel_route("train", kernels):
        h = hidden.reshape(b * s, d).to(compute_dtype)
        if not model.cfg.num_codebooks:
            return ops.fused_cross_entropy(
                h, head_weight(model, compute_dtype),
                labels.reshape(b * s)).reshape(b, s)
        nll = torch.stack([
            ops.fused_cross_entropy(h, head_weight(model, compute_dtype, c),
                                    labels[..., c].reshape(b * s))
            for c in range(model.cfg.num_codebooks)], dim=-1)
        return nll.mean(-1).reshape(b, s)
    return torch.cat([
        token_losses(lm_head(model, hidden[:, i:i + chunk], compute_dtype),
                     labels[:, i:i + chunk])
        for i in range(0, s, chunk)], dim=1)


def _vocab_parallel_nll(model, hidden, labels, merge, compute_dtype,
                        chunk: int, kernels: bool):
    """:func:`chunked_nll` on a training shard whose head is a piece [lo,
    hi) of the vocabulary: the hidden states, which entered the head
    through ``head_in`` (:func:`backbone`: the model ranks sum their
    gradient), each token's
    partials over the piece (max logit, exp-sum, the label's logit where
    the label falls in the piece) are merged over the model ranks by
    ``merge`` and nll = M + log L − Z.  With ``kernels``, kernel B6's
    partial form (``ops.vocab_parallel_cross_entropy``); without, the
    reference's form: the piece's logits in the compute dtype ``chunk``
    positions at a time, then f32 partials.  With C codebooks the mean of
    the C NLLs."""
    b, s, d = hidden.shape
    lo, _ = model.vocab_range
    route = tf.kernel_route("train", kernels)
    nlls = []
    for c in range(model.cfg.num_codebooks) or (None,):
        w = head_weight(model, compute_dtype, c)
        lab = (labels if c is None else labels[..., c]) - lo
        if route:
            nll = ops.vocab_parallel_cross_entropy(
                hidden.reshape(b * s, d).to(compute_dtype), w,
                lab.reshape(b * s), merge).reshape(b, s)
        else:
            nll = torch.cat([ref.merge_nll(*merge(*ref.ce_partials_logits(
                (hidden[:, i:i + chunk].to(compute_dtype) @ w.T).to(
                    torch.float32), lab[:, i:i + chunk])))
                for i in range(0, s, chunk)], dim=1)
        nlls.append(nll)
    return nlls[0] if len(nlls) == 1 else torch.stack(nlls, -1).mean(-1)


def per_group_loss(model: Model, batch: Dict[str, Any], *, num_groups: int,
                   compute_dtype=torch.bfloat16, kernels: bool = True,
                   remat: bool = False):
    """Group-resolved LM loss.  batch needs "tokens", "labels" (B, S), or
    (B, S, C) with codebooks, and "groups" (B, S) int in [0, num_groups).  Returns ((G,) mean NLL per
    group — 0 for a group with no token — and aux).  ``remat`` as
    :func:`backbone`'s."""
    hidden, _, aux = backbone(model, batch, mode="train",
                              compute_dtype=compute_dtype, kernels=kernels,
                              remat=remat)
    nll = chunked_nll(model, hidden, batch["labels"],
                      compute_dtype=compute_dtype, kernels=kernels)
    # one_hot by comparison: F.one_hot checks its range on the host, which
    # neither vmap nor a CUDA graph capture can do
    g = batch["groups"].long()
    onehot = (g[..., None] == torch.arange(num_groups, device=g.device)
              ).to(torch.float32)
    # over a client's batch split across fsdp ranks: the sums and counts
    # of every rank's rows (``batch_sum``)
    sums = dist_ctx.apply("batch_sum", torch.einsum("bs,bsg->g", nll,
                                                    onehot))
    counts = torch.clamp(dist_ctx.apply("batch_sum", onehot.sum((0, 1))),
                         min=1.0)
    return sums / counts, aux


def lm_loss(model: Model, batch: Dict[str, Any], *,
            compute_dtype=torch.bfloat16, kernels: bool = True):
    """Mean next-token NLL plus the auxiliary loss (reference :196).
    Returns (loss, aux)."""
    hidden, _, aux = backbone(model, batch, mode="train",
                              compute_dtype=compute_dtype, kernels=kernels)
    nll = chunked_nll(model, hidden, batch["labels"],
                      compute_dtype=compute_dtype, kernels=kernels)
    return nll.mean() + aux, aux


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
        w = cfg.rglru.channels(cfg.d_model)
        return {
            "conv": torch.zeros((batch, cfg.rglru.conv_width - 1, w),
                                dtype=dtype, device=device),
            "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        }
    if kind == "ssm":
        s = cfg.ssm
        nheads = s.heads(cfg.d_model)
        return {
            "conv": torch.zeros((batch, s.d_conv - 1,
                                 nheads * s.d_head + 2 * s.d_state),
                                dtype=dtype, device=device),
            "state": torch.zeros((batch, nheads, s.d_head, s.d_state),
                                 dtype=torch.float32, device=device),
        }
    shape = (batch, cache_length(kind, cfg, seq_len), cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device="cuda") -> List[Dict]:
    """One cache dict per layer, in layer order; a shard config's
    (``dist.tensor_parallel.shard_config``) at the rank's KV heads, SSM
    heads and LRU channels."""
    return [_block_cache(kind, cfg, batch, seq_len, dtype, device)
            for kind in cfg.blocks()]


def grow_caches(cfg: ModelConfig, caches, total: int) -> List[Dict]:
    """Caches that a prefill filled at the prompt's length
    (``init_cache(cfg, B, P)``), each KV cache grown to its length for
    ``total`` tokens by empty slots after the prompt's.  Decode writes
    position p at slot p (a global cache) or p % length (a window), so a
    prefill that fills its cache exactly (``launch.serve.check_prompt``
    at ``total = P``) then serves the decode steps up to ``total``.
    Other caches pass through."""
    out = []
    for kind, cache in zip(cfg.blocks(), caches):
        length = cache_length(kind, cfg, total)
        if length is None or cache["k"].shape[1] == length:
            out.append(cache)
            continue
        out.append({name: torch.cat([t, t.new_zeros(
            (t.shape[0], length - t.shape[1], *t.shape[2:]))], dim=1)
            for name, t in cache.items()})
    return out


def decode_step(model: Model, caches, tokens, pos, *,
                compute_dtype=torch.bfloat16):
    """One-token decode.  tokens: (B,1), or (B,1,C) with codebooks; pos:
    the absolute position, an int for every row or a (B,) integer tensor
    on the model's device, each row at its own (a continuous-batching
    pool's slots; no host sync, so a CUDA graph captures it).  Returns
    (logits (B,1,V) or (B,1,C,V), new_caches); the caches passed in are
    left as they were."""
    logits, new_caches, _ = forward(
        model, {"tokens": tokens}, mode="decode", compute_dtype=compute_dtype,
        caches=caches, pos=pos)
    return logits, new_caches
