"""Mixture-of-Experts MLP with top-k routing (port of ``repro.models.moe``).

Two dispatches, as in the reference:

* :func:`moe_mlp` — the dense one-hot capacity dispatch (Switch/GShard
  style, every config's default ``MoEConfig.dispatch="dense"``): each
  (token, choice) takes a slot of its expert's per-batch-row buffer of
  ``capacity`` slots in token-major, then choice, order; overflow tokens
  are dropped (the residual passes them through).  Shapes never depend on
  the data, so it runs under ``torch.func`` transforms and CUDA graph
  capture.
* :func:`moe_mlp_sorted` — the dropless sort dispatch: the (token, choice)
  rows sorted by expert, one GEMM chain per expert, then unsorted.  Its
  group sizes are read on the host, so it refuses transforms and capture
  (ROADMAP A7: its only caller in the reference is the dry-run tooling).

The expert products are plain ``torch.einsum`` / matmuls, as the
reference's are plain einsums: MoE has no Pallas kernel.

Training over a client's (fsdp, model) block (``dist.tensor_parallel.
ClientShard``) splits the experts' ``expert_d_ff`` over model, or with
expert parallelism the experts themselves (a ``configs.base.MoEShard``:
the rank dispatches and combines only its experts' slots).  Either way a
rank's expert outputs are partials that cross at ``ffn_out``, and the
router stays whole on every rank.  Three points of ``dist.context``,
identities without a context, carry the gradients: ``ffn_in`` on the
experts' input (the router reads the input itself, whose gradient is
whole on every rank), ``expert_gates`` on the gates the partials are
combined with (their gradient is a partial too), and ``batch_sum`` on the
aux loss's sums and counts, which the fsdp ranks' batch rows share.  On a
sequence split over model (``dist.tensor_parallel.SeqSplit``) the MoE's
input is gathered once at its entry, for the router and the experts
(``moe_in``, :func:`moe_inputs`): the capacity is a batch row's over its
whole sequence, so the router must see every token of it.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist import context as dist_ctx
from repro_torch.models.layers import dense_init, param


def init_moe(gen, cfg, d_model: int, *, device, dtype) -> nn.ParameterDict:
    """``router`` (d, E), ``gate`` / ``up`` (E, d, f), ``down`` (E, f, d):
    the reference's names and fan-ins (reference :18); a rank's shard
    config gives its f, or its experts (``MoEShard``)."""
    m = cfg.moe
    lo, hi = m.expert_range()
    e, f = m.num_experts, m.expert_d_ff
    kw = dict(device=device, dtype=dtype)
    return nn.ParameterDict({
        "router": param(dense_init(gen, (d_model, e), in_axis=0, **kw)),
        "gate": param(dense_init(gen, (hi - lo, d_model, f), in_axis=1,
                                 **kw)),
        "up": param(dense_init(gen, (hi - lo, d_model, f), in_axis=1,
                               **kw)),
        "down": param(dense_init(gen, (hi - lo, f, d_model), in_axis=1,
                                 **kw)),
    })


def capacity(num_tokens: int, num_experts: int, top_k: int,
             factor: float = 1.25) -> int:
    return max(4, int(num_tokens * top_k / num_experts * factor))


@dataclasses.dataclass
class Routing:
    """The router's decisions for x (B, S, d)."""
    gate_vals: torch.Tensor   # (B, S, k) f32, renormalized over the k
    gate_idx: torch.Tensor    # (B, S, k) int64 expert of each choice
    aux: torch.Tensor         # () f32 Switch load-balance loss


def router_probs(params, x):
    """The softmax of the f32 router logits: (…, d) -> (…, E) f32."""
    logits = x.to(torch.float32) @ params["router"].to(torch.float32)
    return torch.softmax(logits, dim=-1)


def route(params, x, cfg) -> Routing:
    """f32 router probabilities and their top-k (reference :43-48), then
    :func:`routing`."""
    probs = router_probs(params, x)
    _, gate_idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    return routing(probs, gate_idx, cfg)


def routing(probs, gate_idx, cfg) -> Routing:
    """The routing of the choices ``gate_idx`` under the router
    probabilities ``probs``: their gates renormalized with a 1e-9 floor,
    and the Switch aux loss coef·E·Σ_e me_e·ce_e (reference :48-56).
    Where a ``batch_sum`` point is installed (a client's batch rows split
    over fsdp ranks), me and ce are the sums and counts of every rank's
    rows over the whole batch's tokens: the aux of the client's batch, not
    a mean of its pieces' auxes."""
    m = cfg.moe
    e = m.num_experts
    gate_vals = probs.gather(-1, gate_idx)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    # one-hot by comparison: F.one_hot checks its range on the host, which
    # neither vmap nor a CUDA graph capture can do
    top1 = (gate_idx[..., :1] == torch.arange(e, device=probs.device)).to(
        torch.float32)
    # where every model rank routes the whole sequence, each sums its own
    # positions' probabilities and choices (``aux_rows``)
    mine = dist_ctx.slot("aux_rows")
    if mine is not None:
        probs, top1 = mine(probs), mine(top1)
    dims = tuple(range(probs.dim() - 1))
    total = dist_ctx.slot("batch_sum")
    if total is None:
        me, ce = probs.mean(dim=dims), top1.mean(dim=dims)
    else:
        tokens = total(probs.new_full((), float(probs[..., 0].numel())))
        me = total(probs.sum(dim=dims)) / tokens
        ce = total(top1.sum(dim=dims)) / tokens
    aux = m.router_aux_coef * e * torch.sum(me * ce)
    return Routing(gate_vals=gate_vals, gate_idx=gate_idx, aux=aux)


def capacity_slots(gate_idx, num_experts: int, cap: int):
    """The slot of each (token, choice) in its expert's buffer of one batch
    row: the count of earlier (token, choice) pairs of that row that chose
    the same expert, in token-major, then choice, order (reference
    :58-62), and whether it lies inside the capacity.  gate_idx (B, S, k)
    -> (pos, in_cap), each (B, S, k)."""
    b, s, k = gate_idx.shape
    flat = gate_idx.reshape(b, s * k, 1)
    sel = (flat == torch.arange(num_experts, device=gate_idx.device)).to(
        torch.int32)                                        # (B, S·k, E)
    pos = torch.cumsum(sel, dim=1).gather(-1, flat) - 1     # (B, S·k, 1)
    pos = pos.reshape(b, s, k)
    return pos, pos < cap


def combine_weights(r: Routing, num_experts: int, cap: int):
    """combine (B, S, E, cap) f32: the gate of token (b, s)'s choice of
    expert e at its slot c, 0 where the choice overflowed or was not made.
    Built by one scatter of the gates: top-k picks distinct experts, so a
    (token, expert) pair has one choice at most, and each value is the
    reference's k-axis sum (reference :64-71) bit for bit."""
    pos, in_cap = capacity_slots(r.gate_idx, num_experts, cap)
    b, s, _ = pos.shape
    idx = r.gate_idx * cap + torch.clamp(pos, max=cap - 1).long()
    vals = r.gate_vals * in_cap.to(r.gate_vals.dtype)
    combine = torch.zeros((b, s, num_experts * cap), dtype=vals.dtype,
                          device=vals.device).scatter(-1, idx, vals)
    return combine.reshape(b, s, num_experts, cap)


def moe_inputs(x):
    """(the router's input, the experts' input) of the MoE's input ``x``:
    on a sequence split over model (``moe_in``) both the whole sequence,
    gathered once, so that the router sees every token of a batch row and
    its capacity is the whole row's; else ``x`` and ``ffn_in`` of it."""
    pair = dist_ctx.slot("moe_in")
    return pair(x) if pair is not None else (x, dist_ctx.apply("ffn_in", x))


def moe_mlp(params, x, cfg, compute_dtype=torch.bfloat16):
    """x (B, S, d) -> (out (B, S, d) in x's dtype, aux).  Per-batch-row
    capacity (``capacity(S, …)``) keeps the shapes batch-invariant.  A
    shard holding experts [lo, hi) of E (``MoEShard``) routes over all E
    and dispatches and combines its experts' slots only."""
    m = cfg.moe
    xr, x_in = moe_inputs(x)
    b, s, d = xr.shape
    e = m.num_experts
    lo, hi = m.expert_range()
    cap = capacity(s, e, m.top_k, m.capacity_factor)
    r = route(params, xr, cfg)
    r = dataclasses.replace(r, gate_vals=dist_ctx.apply("expert_gates",
                                                        r.gate_vals))
    combine = combine_weights(r, e, cap)                    # (B, S, E, c)
    if hi - lo < e:
        combine = combine[:, :, lo:hi]
    dispatch = (combine > 0).to(compute_dtype)

    def w(name):
        return params[name].to(compute_dtype)

    xe = torch.einsum("bsec,bsd->becd", dispatch, x_in.to(compute_dtype))
    h = F.silu(torch.einsum("becd,edf->becf", xe, w("gate")))
    h = h * torch.einsum("becd,edf->becf", xe, w("up"))
    ye = torch.einsum("becf,efd->becd", h, w("down"))
    out = torch.einsum("bsec,becd->bsd", combine.to(compute_dtype), ye)
    return out.to(x.dtype), r.aux


def _refuse_transforms(x) -> None:
    if torch._C._functorch.peek_interpreter_stack() is not None or (
            x.is_cuda and torch.cuda.is_current_stream_capturing()):
        raise RuntimeError(
            "moe_mlp_sorted reads its per-expert group sizes on the host, "
            "so it cannot run under torch.func transforms or CUDA graph "
            "capture; use MoEConfig.dispatch='dense' there (the sorted "
            "dispatch serves the mesh tooling, ROADMAP A7)")


def moe_mlp_sorted(params, x, cfg, compute_dtype=torch.bfloat16):
    """Dropless sort dispatch (reference :83): the (token, choice) rows
    stably sorted by expert, each expert's rows through its SwiGLU (the
    reference's ``ragged_dot`` groups, here one GEMM chain a group), the
    gated rows added back to their tokens in f32.  Returns (out, aux)."""
    _refuse_transforms(x)
    m = cfg.moe
    if m.expert_range() != (0, m.num_experts):
        raise ValueError("moe_mlp_sorted runs every expert: a shard of "
                         "experts (expert parallelism) takes the dense "
                         "dispatch")
    x = moe_inputs(x)[0]
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    xt = x.reshape(b * s, d)
    r = route(params, xt, cfg)
    order = torch.argsort(r.gate_idx.reshape(-1), stable=True)
    tok_of = order // k                                     # source token
    xs = xt[tok_of].to(compute_dtype)                       # (n·k, d)
    counts = torch.bincount(r.gate_idx.reshape(-1),
                            minlength=e).tolist()

    def w(name):
        return params[name].to(compute_dtype)

    ys, start = [], 0
    for j, cnt in enumerate(counts):
        rows = xs[start:start + cnt]
        h = F.silu(rows @ w("gate")[j]) * (rows @ w("up")[j])
        ys.append(h @ w("down")[j])
        start += cnt
    ys = torch.cat(ys)
    gates = r.gate_vals.reshape(-1)[order].to(torch.float32)
    contrib = ys.to(torch.float32) * gates[:, None]
    out = torch.zeros((b * s, d), dtype=torch.float32,
                      device=x.device).index_add(0, tok_of, contrib)
    return out.reshape(b, s, d).to(x.dtype), r.aux
