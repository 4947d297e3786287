"""K-GT-Minimax (Algorithm 1) and its baselines, in PyTorch.

Port of ``repro.core.kgt_minimax``.  Every variable carries a leading
clients dim ``n`` (``x: (n, …)``, ``y``, corrections ``cx``, ``cy``); the
per-client gradient oracle is vmapped over it.  One ``round_step`` is one
communication round:

  1. K local steps        x_i -= η_cx (∇x F_i + c_i^x);  y_i += η_cy (∇y F_i + c_i^y)
  2. correction update    c_i^x += (Δx_i − (WΔx)_i)/(K η_cx)   [line 7]
                          c_i^y −= (Δy_i − (WΔy)_i)/(K η_cy)   [line 8]
  3. parameter mixing     x_i ← Σ_j w_ij (x_j + η_sx Δx_j)     [line 10]
                          y_i ← Σ_j w_ij (y_j + η_sy Δy_j)     [line 11]

Baselines: ``dsgda`` (K=1, no tracking), ``local_sgda`` (K steps, no
tracking), ``gt_gda`` (Algorithm 1 with K=1).

Lowerings (``cfg.mixing_impl``): the per-leaf ``dense``/``ring``/
``fused_dense``/``fused_ring``; ``pallas_packed`` (the state packed to
(n, D) per variable, epilogue in the fused gossip kernel);
``sparse_packed`` (the same epilogue with W as neighbor lists, in the
neighbor-gather kernel); ``fused_round`` (the whole round in the
whole-round kernel); the robust impls (``mixing.ROBUST_IMPLS``: an order
statistic over the support of W in place of every W contraction).  Churn —
a per-round W, partial participation and ``topology_cycle`` — rides every
lowering that can realize it; error-feedback compression of the
transmitted Δ (``core.compression``) rides ``pallas_packed`` and
``fused_round``; the Byzantine adversary (``core.adversary``) rides every
lowering but ``fused_round``.

On the decentralized mesh (``axis``, a ``dist.collectives.ClientsAxis``)
every leaf holds this rank's n/R clients; the K local steps are unchanged
and issue no collective, and every lowering gossips through
``dist.collectives``: ``dense`` and ``fused_dense`` the rank's rows of W
over all-gathered rows, ``ring`` and ``fused_ring`` the ring's neighbour
exchange, ``pallas_packed`` (with or without compression) an all-gather
a variable and the B1 epilogue on the rank's row block of W,
``sparse_packed`` and the robust rules a halo exchange of the neighbour
rows the rank's lists read (B4 on the remapped table, or the order
statistic over the rank's candidates), and ``fused_round`` the
whole-round kernel on every rank over the gathered state.  A static W
only: the per-round W, participation and the adversary are refused, as
the reference refuses them on its mesh.  Where a client's weights lie over
its ``(fsdp, model)`` block (``block``; the problem's ``shard``), the
leaves hold this rank's pieces of its clients: the local steps, the
corrections and the gossip run elementwise on the pieces, over the ranks
that hold the same piece of every client (the clients axis), and only
int8 compression's per-row scale crosses the block (its max).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.func import vmap

from repro_torch.configs.base import AlgorithmConfig
from repro_torch.core import adversary as adversary_lib
from repro_torch.core import compression as compression_lib
from repro_torch.core import mixing as mixing_lib
from repro_torch.core import packing
from repro_torch.core import sparse_topology as sparse_lib
from repro_torch.core import stochastic_topology as stoch_lib
from repro_torch.core import topology as topo_lib
from repro_torch.core import tree as tree_lib
from repro_torch.core.minimax import MinimaxProblem
from repro_torch.dist import collectives
from repro_torch.kernels import ops as kernel_ops

ALGORITHMS = ("kgt_minimax", "gt_gda", "dsgda", "local_sgda")


@dataclasses.dataclass
class KGTState:
    x: Any          # (n, …) per-client primal variables
    y: Any          # (n, …) per-client dual variables
    cx: Any         # (n, …) gradient-tracking correction for x
    cy: Any         # (n, …) gradient-tracking correction for y
    round: int = 0  # host int: the single source of truth for the round
    # error-feedback residuals of compressed gossip (cfg.gossip_compress):
    # packed (n, D) f32 in core.packing layout, one per variable; None (an
    # empty node) without compression, so an exact-gossip state keeps its
    # leaves and old checkpoints restore unchanged
    ef_x: Any = None
    ef_y: Any = None


def _tree_axpy(a: float, x_tree, y_tree):
    """a * x + y over pytrees, f32 arithmetic, keeps y's dtype."""
    return tree_lib.tree_map(
        lambda x, y: (a * x.to(torch.float32)
                      + y.to(torch.float32)).to(y.dtype), x_tree, y_tree)


def _tree_sub(x_tree, y_tree):
    return tree_lib.tree_map(lambda x, y: x - y, x_tree, y_tree)


def _replicate(tree, n: int):
    return tree_lib.tree_map(
        lambda x: x.unsqueeze(0).expand(n, *x.shape).contiguous(), tree)


def _step_slice(tree, k: int):
    return tree_lib.tree_map(lambda b: b[k], tree)


def _vgrads(problem: MinimaxProblem, x, y, batch, noise):
    """Per-client gradients, vmapped over the leading clients dim.  An LM
    problem's kernels (attention, the cross-entropy) take the vmap through
    their autograd Functions' ``vmap`` rules."""
    return vmap(problem.grads)(x, y, batch, noise)


def _tree_descend(a: float, grads: list, i: int, c_tree, x_tree):
    """a·(g + c) + x leaf by leaf — ``_tree_axpy(a, _tree_axpy(1.0, c, g),
    x)`` op for op (c None: a·g + x) — for g = ``grads[i]``, which is taken
    out of the list and released leaf by leaf as it is used: a language
    model's per-client gradient tree is GBs, and the iterate, the
    gradient and the stepped iterate need not all be whole at once."""
    g_leaves = tree_lib.leaves(grads[i])
    grads[i] = None
    c_leaves = None if c_tree is None else tree_lib.leaves(c_tree)
    x_leaves, x_def = tree_lib.flatten(x_tree)
    out = []
    for j, x in enumerate(x_leaves):
        g, g_leaves[j] = g_leaves[j], None
        if c_leaves is not None:
            g = (1.0 * c_leaves[j].to(torch.float32)
                 + g.to(torch.float32)).to(g.dtype)
        out.append((a * g.to(torch.float32)
                    + x.to(torch.float32)).to(x.dtype))
    return tree_lib.unflatten(x_def, out)


def init_state(problem: MinimaxProblem, cfg: AlgorithmConfig,
               gen: torch.Generator, init_batch=None,
               init_noise: Optional[torch.Tensor] = None,
               axis: Optional[collectives.ClientsAxis] = None) -> KGTState:
    """Shared x0/y0 across clients; corrections per the paper's
    initialization c_i = −∇F_i(x0,y0;ξ_i) + (1/n)Σ_j ∇F_j(x0,y0;ξ_j)
    (Lemma 8 ⇒ Σ_i c_i = 0).  Without tracking the corrections are zeros.

    ``init_noise`` (n, noise_dim) is the noise row of each client's
    initial gradient; drawn from ``gen`` when omitted.

    ``axis``: this rank's clients of the decentralized mesh.  The same
    draws as the host path (x0, y0, the (n, …) ``init_batch`` and noise)
    are sliced to its rows; the mean over every client's initial gradient
    is taken over their all-gather (once, phase ``init``), so each row is
    the host path's bit for bit where the gradients are: an all-reduced
    mean rounds otherwise, and in bf16 compute a rounding in c moves the
    trajectory by far more than itself.
    """
    _check_cfg(cfg)
    n = cfg.num_clients
    n_rows = n if axis is None else axis.n_local
    x = _replicate(problem.init_x(gen), n_rows)
    y = _replicate(problem.init_y(gen), n_rows)
    track = cfg.algorithm in ("kgt_minimax", "gt_gda")
    if track and init_batch is not None:
        if init_noise is None:
            init_noise = torch.randn((n, problem.noise_dim), generator=gen,
                                     device=gen.device)
        if axis is not None:
            init_batch = collectives.shard_tree(init_batch, axis)
            init_noise = axis.rows(init_noise)
        gx, gy = _vgrads(problem, x, y, init_batch, init_noise)

        def correction(g):
            with collectives.phase("init"):
                every = g if axis is None else collectives.all_gather_rows(
                    g, axis)
            return every.mean(0, keepdim=True) - g

        cx = tree_lib.tree_map(correction, gx)
        cy = tree_lib.tree_map(correction, gy)
    else:
        cx = tree_lib.tree_map(torch.zeros_like, x)
        cy = tree_lib.tree_map(torch.zeros_like, y)
    if cfg.correction_dtype != "float32":
        cd = getattr(torch, cfg.correction_dtype)
        cx = tree_lib.tree_map(lambda c: c.to(cd), cx)
        cy = tree_lib.tree_map(lambda c: c.to(cd), cy)
    ef_x = ef_y = None
    if compression_lib.validate_method(cfg.gossip_compress) is not None:
        # zero residual per variable, packed (n, D): round 0 transmits Q(Δ)
        # with nothing carried
        dev = tree_lib.leaves(x)[0].device
        ef_x = compression_lib.init_ef(n_rows, packing.pack_spec(x).dim,
                                       dev)
        ef_y = compression_lib.init_ef(n_rows, packing.pack_spec(y).dim,
                                       dev)
    return KGTState(x=x, y=y, cx=cx, cy=cy, round=0, ef_x=ef_x, ef_y=ef_y)


def point_etas(cfg: AlgorithmConfig) -> dict:
    """The stepsize bundle for ``make_round_step(traced_etas=True)``.

    ``corr_x``/``corr_y`` are the line-7/8 correction scales ±1/(K·η_c),
    computed on the host in float64 and rounded once to f32, as the
    reference does.
    """
    k = 1 if cfg.algorithm in ("dsgda", "gt_gda") else cfg.local_steps
    return {
        "eta_cx": np.float32(cfg.eta_cx),
        "eta_cy": np.float32(cfg.eta_cy),
        "eta_sx": np.float32(cfg.eta_sx),
        "eta_sy": np.float32(cfg.eta_sy),
        "corr_x": np.float32(1.0 / (k * cfg.eta_cx)),
        "corr_y": np.float32(-1.0 / (k * cfg.eta_cy)),
    }


def _check_cfg(cfg: AlgorithmConfig) -> None:
    """Refuse an unknown mixing_impl, algorithm or gossip_compress."""
    mixing_lib.check_impl(cfg.mixing_impl)
    compression_lib.validate_method(cfg.gossip_compress)
    if cfg.algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {cfg.algorithm!r}: {ALGORITHMS}")


def check_impl_options(problem: MinimaxProblem, cfg: AlgorithmConfig,
                       traced_w: bool = False,
                       byzantine: bool = False) -> None:
    """The reference's refusals of impl/option pairs, in its order
    (``repro.core.kgt_minimax:247-291``)."""
    impl = cfg.mixing_impl
    if cfg.topology_cycle and impl.endswith("ring"):
        # the time-varying path mixes densely per round; a neighbor-only
        # ring exchange cannot realize arbitrary cycle members
        raise ValueError(
            f"mixing_impl={impl!r} is not supported with topology_cycle; "
            "use 'dense', 'fused_dense', or 'pallas_packed'")
    if traced_w and cfg.topology_cycle:
        raise ValueError(
            "traced_w supplies W per round; topology_cycle would fight it — "
            "drop the cycle (sample the W sequence instead) or traced_w")
    if (compression_lib.validate_method(cfg.gossip_compress)
            and impl not in ("pallas_packed", "fused_round")):
        raise ValueError(
            f"gossip_compress={cfg.gossip_compress!r} quantizes the packed "
            f"(n, D) round delta; mixing_impl={impl!r} has no "
            "packed buffer — use 'pallas_packed' or 'fused_round'")
    if impl == "fused_round":
        if problem.affine_coeffs is None:
            raise ValueError(
                "mixing_impl='fused_round' runs the K local steps as affine "
                "updates inside the kernel; this problem has no "
                "affine_coeffs oracle — use 'pallas_packed'")
        if byzantine:
            # the attack corrupts the per-leaf Δ, which never exists on the
            # whole-round path (Δ is born packed inside the kernel)
            raise ValueError(
                "mixing_impl='fused_round' does not support byzantine; "
                "use 'pallas_packed' (the attack applies pre-packing)")
    if cfg.topology_cycle and (impl == "sparse_packed"
                               or impl in mixing_lib.ROBUST_IMPLS):
        # the cycle stacks dense (n, n) members mixed by mix_dense; neither
        # neighbor lists nor the robust order statistic ride it
        raise ValueError(
            f"mixing_impl={impl!r} is not supported with topology_cycle; "
            "use traced_w with a per-round sampler instead")


def check_mesh_options(*, traced_w: bool = False,
                       participation: bool = False,
                       byzantine: bool = False) -> None:
    """The decentralized mesh runs every lowering, compressed gossip and
    every gossip backend on a static W or a ``topology_cycle`` (with the
    lowerings ``check_impl_options`` takes with one), with static or
    traced stepsizes.  It refuses, as the reference's mesh does, a
    per-round W, participation and the adversary."""
    off = [name for name, on in (
        ("traced_w", traced_w), ("participation", participation),
        ("byzantine", byzantine)) if on]
    if off:
        raise ValueError(
            f"{', '.join(off)} is not supported on the decentralized mesh "
            "yet (the sharded round bakes a static W); run on the host "
            "mesh")


def _mesh_mixer(cfg: AlgorithmConfig, impl: str, w: torch.Tensor,
                w_rows: torch.Tensor, gossip_dtype, axis):
    """``mix(tree)`` of the rank's rows for the per-leaf lowerings:
    ``make_mixer``'s dense and ring mixers through ``dist.collectives``."""
    if impl.endswith("ring"):
        w_self, w_nbr = mixing_lib.ring_weights(cfg.topology, impl, w)
        return lambda tree: collectives.mix_ring(tree, w_self, w_nbr, axis,
                                                 gossip_dtype)
    return lambda tree: collectives.mix_dense(tree, w_rows, axis,
                                              gossip_dtype)


def _client_broadcast(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """(n,) mask -> (n, 1, …, 1) against an (n, …) leaf."""
    return mask.reshape(mask.shape + (1,) * (ndim - 1))


def _tree_mask_clients(mask: torch.Tensor, tree):
    """Zero the leaves of inactive clients (mask 0).  ×1.0 in f32 is exact,
    so active clients' values are bit-unchanged."""
    def one(x):
        m = _client_broadcast(mask.to(torch.float32), x.dim())
        return (x.to(torch.float32) * m).to(x.dtype)

    return tree_lib.tree_map(one, tree)


def _freeze_inactive(mask: torch.Tensor, new_state: KGTState,
                     old_state: KGTState) -> KGTState:
    """Per-client select: active clients take the round's result, inactive
    clients keep (θ, c) bit for bit.  The masked Δ and self-loop W already
    make the inactive rows no-ops mathematically; the select pins them
    regardless of the f32 summation order."""
    keep = mask != 0

    def pick(new, old):
        return tree_lib.tree_map(
            lambda a, b: torch.where(_client_broadcast(keep, a.dim()), a, b),
            new, old)

    return KGTState(x=pick(new_state.x, old_state.x),
                    y=pick(new_state.y, old_state.y),
                    cx=pick(new_state.cx, old_state.cx),
                    cy=pick(new_state.cy, old_state.cy),
                    round=new_state.round,
                    # the EF residuals freeze with the rest of the client's
                    # state (a no-op on None without compression)
                    ef_x=pick(new_state.ef_x, old_state.ef_x),
                    ef_y=pick(new_state.ef_y, old_state.ef_y))


def _need_ef(state: KGTState) -> None:
    if state.ef_x is None or state.ef_y is None:
        raise ValueError(
            "gossip_compress is set but the state carries no EF residual — "
            "build it with init_state under the same cfg")


def make_round_step(
    problem: MinimaxProblem,
    cfg: AlgorithmConfig,
    w=None,
    lr_scale: Optional[Callable[[int], float]] = None,
    *,
    traced_etas: bool = False,
    traced_w: bool = False,
    participation: bool = False,
    byzantine: bool = False,
    device="cuda",
    axis: Optional[collectives.ClientsAxis] = None,
    block: Optional[collectives.MeshAxis] = None,
):
    """Builds ``round_step(state, batches, noise[, etas], *extras) -> state``.

    ``batches``: pytree with leading dims (K, n, …), one per (local step,
    client).  ``noise``: (K, n, noise_dim), the oracle noise rows.
    ``w``: the static mixing matrix (default: ``cfg.topology``), placed on
    ``device``; for ``mixing_impl="sparse_packed"`` a ``SparseTopology``
    (a dense matrix is bridged with ``from_dense``; by default the support
    is ``sparse_mixing_matrix(cfg.topology, n)``).  ``lr_scale(round) ->
    float`` multiplies the local stepsizes.
    ``traced_etas=True`` adds the ``etas`` bundle of :func:`point_etas`
    after ``noise``; the stepsizes in ``cfg`` are then ignored.

    Extras, in this order: ``traced_w=True`` takes this round's W — an
    (n, n) tensor, or a ``SparseTopology`` for ``sparse_packed`` — in place
    of the static one; ``participation=True`` takes an (n,) client mask.
    Inactive clients run no effective local update (their Δ is zeroed),
    drop every gossip link (``masked_w`` / ``sparse_masked_w`` on whatever
    W the round uses) and keep (θ, c) bit for bit; the masked W stays
    doubly stochastic, so Σ_i c_i = 0 holds under any mask.
    ``cfg.topology_cycle`` cycles W through the listed topologies, one a
    round.  ``sparse_packed`` runs the round epilogue in the neighbor-gather
    kernel (``kernels.ops.sparse_gossip_pair``, x and y in one call) in
    O(n·max_deg·D) with no (n, n) array; its no-tracking variants mix the
    packed buffer with ``sparse_topology.sparse_mix``.

    ``cfg.gossip_compress`` ("bf16" / "int8", ``pallas_packed`` and
    ``fused_round`` only) transmits q = Q(Δ + e) in place of Δ and carries
    the residual e' = Δ + e − q in ``state.ef_x`` / ``ef_y``
    (``core.compression``): on ``fused_round`` inside the whole-round
    kernel, on ``pallas_packed`` by ``ef_transmit`` before the gossip pair.

    ``byzantine=True`` takes a :class:`repro_torch.core.adversary.Adversary`
    as the last extra: each attacker's outgoing Δ is corrupted right after
    the local steps, before the participation zeroing, and rides every
    downstream use, so Σc = 0 survives under a doubly stochastic W; honest
    rows are bit for bit untouched.  The robust impls (``coord_median``,
    ``trimmed_mean`` and their ``sparse_*`` neighbor-gather forms) replace
    every W contraction with an order statistic R over the support of the
    round's W: θ ← R(θ + η_s Δ) and c += corr·(Δ − R(Δ)), which does not
    keep Σc = 0.

    The returned step's ``uses_round`` says whether it reads
    ``state.round`` beyond advancing it (``lr_scale``, ``topology_cycle``):
    a captured engine chunk bakes that value in and is captured again for
    every chunk start.

    ``axis`` (a ``dist.collectives.ClientsAxis``): the step of one rank of
    the decentralized mesh over its n/R clients' rows (module docstring),
    for every lowering, with or without compression, on a static W or a
    ``topology_cycle`` (each W's rows of the rank stacked, picked by the
    round's index as the host path picks its W), with ``cfg``'s stepsizes
    or ``traced_etas`` (``check_mesh_options`` says what it refuses).
    ``sparse_packed`` and the robust rules build the rank's
    ``dist.collectives.HaloPlan`` once, here.  Its collectives count under the phases ``local_steps``
    (none, but a sharded client's gathers, reduce-scatters and sums, which
    the problem makes) and ``gossip``.  ``block``: the ranks that hold one
    client's weights between them (``launch.mesh.TrainAxes.block``), over
    which int8 compression takes each row's max|v|.
    """
    if traced_etas and lr_scale is not None:
        raise ValueError(
            "traced_etas carries per-trajectory stepsizes; fold the schedule "
            "into the eta values instead of passing lr_scale")
    _check_cfg(cfg)
    check_impl_options(problem, cfg, traced_w, byzantine)
    if axis is not None:
        check_mesh_options(traced_w=traced_w, participation=participation,
                           byzantine=byzantine)
    impl = cfg.mixing_impl
    fused = impl == "fused_round"
    packed = impl == "pallas_packed"
    sparse = impl == "sparse_packed"
    robust = impl in mixing_lib.ROBUST_IMPLS
    rule = mixing_lib.robust_rule(impl) if robust else None
    # W is a SparseTopology everywhere a dense matrix would appear
    sparse_w = sparse or (robust and impl.startswith("sparse_"))
    compress = compression_lib.validate_method(cfg.gossip_compress)
    dynamic_w = traced_w or participation
    if cfg.gossip_backend not in kernel_ops.GOSSIP_BACKENDS:
        raise ValueError(f"unknown gossip_backend {cfg.gossip_backend!r}: "
                         f"{kernel_ops.GOSSIP_BACKENDS}")
    gossip_dtype = cfg.gossip_dtype
    # W is consumed directly, per round, by the packed, sparse, fused,
    # robust and per-round-W paths; the others bake it into a mixer
    direct_w = packed or sparse or fused or robust or dynamic_w
    # the per-leaf impls take a per-round W through a traced mixer (which
    # refuses the ring impls: they cannot realize an arbitrary W)
    traced_mix = (mixing_lib.make_traced_mixer(impl, gossip_dtype)
                  if dynamic_w and not (packed or sparse or fused or robust)
                  else None)

    def dense_tensor(m):
        return torch.as_tensor(
            np.asarray(m) if not isinstance(m, torch.Tensor) else m,
            dtype=torch.float32).to(device)

    w_rows = plan = None
    if cfg.topology_cycle:
        # every W of the cycle stacked on the device, one picked a round by
        # its index (the host path's and, on the mesh, the rank's rows of
        # each)
        cycle = len(cfg.topology_cycle)
        ws = torch.stack([dense_tensor(topo_lib.mixing_matrix(
            t, cfg.num_clients)) for t in cfg.topology_cycle])
        get_w = lambda round_idx: ws[round_idx % cycle]  # noqa: E731
        ws_rows = (None if axis is None else
                   ws[:, axis.lo:axis.hi].contiguous())
        get_rows = lambda round_idx: (  # noqa: E731
            None if ws_rows is None else ws_rows[round_idx % cycle])

        def make_mix(round_idx):
            if axis is not None:
                rows_r = get_rows(round_idx)
                return lambda tree: collectives.mix_dense(
                    tree, rows_r, axis, gossip_dtype)
            w_r = get_w(round_idx)
            return lambda tree: mixing_lib.mix_dense(tree, w_r, gossip_dtype)
    else:
        if w is None and not traced_w:
            w = (sparse_lib.sparse_mixing_matrix(cfg.topology,
                                                 cfg.num_clients) if sparse_w
                 else topo_lib.mixing_matrix(cfg.topology, cfg.num_clients))
        if w is None:
            w_arr = None
        elif sparse_w:
            w_arr = (w if isinstance(w, sparse_lib.SparseTopology)
                     else sparse_lib.from_dense(w)).to(device)
        else:
            w_arr = dense_tensor(w)
        get_w = lambda round_idx: w_arr  # noqa: E731
        if axis is not None and (sparse or robust):
            # the neighbour rows this rank reads, over the support of W
            plan = collectives.halo_plan(
                w_arr if sparse_w else sparse_lib.from_dense(w_arr), axis,
                device)
        if axis is not None and not sparse_w:
            # this rank's rows of W
            w_rows = w_arr[axis.lo:axis.hi].contiguous()
        get_rows = lambda round_idx: w_rows  # noqa: E731
        if direct_w:
            make_mix = None
        elif axis is not None:
            static_mix = _mesh_mixer(cfg, impl, w_arr, w_rows, gossip_dtype,
                                     axis)
            make_mix = lambda round_idx: static_mix  # noqa: E731
        else:
            static_mix = mixing_lib.make_mixer(cfg.topology, impl, w_arr,
                                               gossip_dtype)
            make_mix = lambda round_idx: static_mix  # noqa: E731
    backend = cfg.gossip_backend
    # int8's per-row scale: the max over the pieces of a split client row
    row_max = (None if block is None or block.size == 1 else
               (lambda t: collectives.all_reduce_max(t, block)))
    track = cfg.algorithm in ("kgt_minimax", "gt_gda")
    k_steps = 1 if cfg.algorithm in ("dsgda", "gt_gda") else cfg.local_steps

    def _local_steps(state, batches, noise, eta_cx, eta_cy):
        xx, yy = state.x, state.y
        for k in range(k_steps):
            grads = list(_vgrads(problem, xx, yy, _step_slice(batches, k),
                                 noise[k]))
            # x -= η_cx (g + c);  y += η_cy (g + c)
            xx = _tree_descend(-eta_cx, grads, 0,
                               state.cx if track else None, xx)
            yy = _tree_descend(eta_cy, grads, 1,
                               state.cy if track else None, yy)
        return xx, yy

    def mix_buf(b, w_t, rows):
        """One gossip of a packed (n, D) buffer (on the mesh the rank's
        rows, by its ``rows`` of this round's W)."""
        if axis is None:
            return (sparse_lib.sparse_mix(w_t, b, gossip_dtype) if sparse
                    else mixing_lib.mix_dense(b, w_t, gossip_dtype))
        if sparse:
            return collectives.sparse_mix(b, plan, axis, gossip_dtype)
        return collectives.mix_dense(b, rows, axis, gossip_dtype)

    def _done(new_state, state, mask):
        return (new_state if mask is None
                else _freeze_inactive(mask, new_state, state))

    def _fused_round(state, batches, noise, w_t, mask, eta_cx, eta_cy,
                     eta_sx, eta_sy, corr_x, corr_y):
        """One kernel call runs the K affine local steps and the gossip
        epilogue over the packed z = (x; y).  Like the reference (which
        takes G from step 0), this needs the batch constant across the K
        local steps — the samplers of the quadratic hand every step the
        same batch — so G and h's data terms come from step 0, built once,
        and only the noise varies per step."""
        spec_x = packing.pack_spec(state.x)
        spec_y = packing.pack_spec(state.y)
        n, dzx, dzy = spec_x.n, spec_x.dim, spec_y.dim
        dz = dzx + dzy
        dev = w_t.device
        g_mat, h = vmap(problem.affine_coeffs)(
            _step_slice(batches, 0), noise[:k_steps].transpose(0, 1))
        h_all = (h.transpose(0, 1) if h.dim() == 3
                 else h.unsqueeze(0).expand(k_steps, n, dz))

        z0 = torch.cat([packing.pack(state.x, spec_x),
                        packing.pack(state.y, spec_y)], dim=1)
        if track:
            cb = torch.cat([packing.pack(state.cx), packing.pack(state.cy)],
                           dim=1)
        else:
            cb = torch.zeros((n, dz), device=dev)
        if compress:
            _need_ef(state)
            efb = torch.cat([state.ef_x, state.ef_y], dim=1)
        else:
            efb = torch.zeros((n, dz), device=dev)
        if axis is not None:
            # the whole-round kernel is not split over the clients: every
            # rank runs it on all n rows, gathered, and keeps its own (as
            # GSPMD replicates the reference's pallas_call)
            z0, cb, efb, g_mat = (collectives.all_gather_rows(
                t.contiguous(), axis) for t in (z0, cb, efb, g_mat))
            h_all = collectives.all_gather_rows(h_all.contiguous(), axis,
                                                dim=1)
            n = axis.n
        # per-column vectors: the x block descends, the y block ascends;
        # corr = 0 encodes the no-tracking variants (c' = c exactly)
        def cols(vx, vy):
            row = torch.cat([torch.full((dzx,), vx, device=dev),
                             torch.full((dzy,), vy, device=dev)])
            return row.unsqueeze(0).expand(n, dz)

        mask_col = (torch.ones((n, 1), device=dev) if mask is None
                    else mask.to(torch.float32).reshape(n, 1))
        step = mask_col * cols(eta_cx, -eta_cy)   # inactive ⇒ Δ ≡ 0 exactly
        etas = cols(eta_sx, eta_sy)
        corr = cols(corr_x, corr_y) if track else cols(0.0, 0.0)
        z_new, c_new, ef_new = kernel_ops.fused_round(
            w_t, z0, cb, efb, g_mat, h_all, step, etas, corr,
            mask_col.expand(n, dz), backend=backend, compress=compress,
            gossip_dtype=gossip_dtype)
        if axis is not None:
            z_new, c_new, ef_new = (t[axis.lo:axis.hi]
                                    for t in (z_new, c_new, ef_new))
        if track:
            cx = packing.unpack(c_new[:, :dzx], packing.pack_spec(state.cx))
            cy = packing.unpack(c_new[:, dzx:], packing.pack_spec(state.cy))
        else:
            cx, cy = state.cx, state.cy
        return _done(KGTState(x=packing.unpack(z_new[:, :dzx], spec_x),
                              y=packing.unpack(z_new[:, dzx:], spec_y),
                              cx=cx, cy=cy, round=state.round + 1,
                              ef_x=ef_new[:, :dzx] if compress
                              else state.ef_x,
                              ef_y=ef_new[:, dzx:] if compress
                              else state.ef_y),
                     state, mask)

    def _packed_round(state, dx, dy, w_t, rows, mask, eta_sx, eta_sy,
                      corr_x, corr_y):
        """Each variable packed to one (n, D) buffer; the epilogue
        θ' = Wθ + η_s·WΔ, c' = c + s·(Δ − WΔ) of both is one kernel call:
        the dense gossip kernel (``pallas_packed``) or the neighbor-gather
        kernel (``sparse_packed``)."""
        spec_x = packing.pack_spec(state.x)
        spec_y = packing.pack_spec(state.y)
        dxb = packing.pack(dx, spec_x)
        dyb = packing.pack(dy, spec_y)
        efx, efy = state.ef_x, state.ef_y
        if compress:
            # EF quantization of the transmitted Δ: the same q rides the
            # mixing and the correction, which keeps Σc = 0
            _need_ef(state)
            kw = {} if row_max is None else {"row_max": row_max}
            dxb, efx = compression_lib.ef_transmit(dxb, efx, compress, mask,
                                                   **kw)
            dyb, efy = compression_lib.ef_transmit(dyb, efy, compress, mask,
                                                   **kw)
        if not track:
            # no correction state: the epilogue is one gossip of the
            # stepped parameters, W(θ + η_s·Δ)
            xb = mix_buf(packing.pack(state.x, spec_x) + eta_sx * dxb, w_t,
                         rows)
            yb = mix_buf(packing.pack(state.y, spec_y) + eta_sy * dyb, w_t,
                         rows)
            return _done(KGTState(x=packing.unpack(xb, spec_x),
                                  y=packing.unpack(yb, spec_y),
                                  cx=state.cx, cy=state.cy,
                                  round=state.round + 1, ef_x=efx,
                                  ef_y=efy), state, mask)
        spec_cx = packing.pack_spec(state.cx)
        spec_cy = packing.pack_spec(state.cy)
        xv = (dxb, packing.pack(state.x, spec_x),
              packing.pack(state.cx, spec_cx), eta_sx, corr_x)
        yv = (dyb, packing.pack(state.y, spec_y),
              packing.pack(state.cy, spec_cy), eta_sy, corr_y)
        # both variables' epilogues in one call (one launch on the card)
        if axis is not None and sparse:
            # the mesh: a halo exchange a variable, B4 on the remapped
            # table over the rank's rows and the halo
            xb, cxb, yb, cyb = collectives.sparse_gossip_pair(
                plan, xv, yv, axis, gossip_dtype, backend=backend)
        elif axis is not None:
            # the mesh: an all-gather a variable, B1 on the rank's rows of
            # W
            xb, cxb, yb, cyb = collectives.gossip_pair(
                rows, xv, yv, axis, gossip_dtype, backend=backend)
        elif sparse:
            xb, cxb, yb, cyb = kernel_ops.sparse_gossip_pair(
                w_t.neighbor_idx, w_t.neighbor_w, w_t.self_w, xv, yv,
                backend=backend, gossip_dtype=gossip_dtype)
        else:
            xb, cxb, yb, cyb = kernel_ops.fused_gossip_pair(
                w_t, xv, yv, backend=backend, gossip_dtype=gossip_dtype)
        return _done(KGTState(x=packing.unpack(xb, spec_x),
                              y=packing.unpack(yb, spec_y),
                              cx=packing.unpack(cxb, spec_cx),
                              cy=packing.unpack(cyb, spec_cy),
                              round=state.round + 1, ef_x=efx, ef_y=efy),
                     state, mask)

    def _robust_round(state, dx, dy, w_t, mask, eta_sx, eta_sy, corr_x,
                      corr_y):
        """The robust epilogue: R (an order statistic over the support of
        W) replaces every W contraction.  R is nonlinear, so the parameter
        update is the one pass θ ← R(θ + η_s Δ), and the corrections keep
        line 7/8's shape c += corr·(Δ − R(Δ)) without the Σc = 0
        telescoping.  A masked client's support is {self}, and
        ``_freeze_inactive`` pins it.  On the mesh each R reads the
        rank's rows and the halo (one exchange a call)."""
        def agg(buf):
            kw = dict(rule=rule, trim=cfg.robust_trim,
                      gossip_dtype=gossip_dtype)
            if axis is None:
                red = (mixing_lib.robust_mix_sparse if sparse_w
                       else mixing_lib.robust_mix_dense)
                return red(buf, w_t, **kw)
            halo = collectives.exchange_halo(buf, plan, axis, gossip_dtype)
            if sparse_w:
                return mixing_lib.robust_mix_sparse(buf, plan.table,
                                                    halo=halo, **kw)
            return mixing_lib.robust_mix_dense(buf, w_rows, halo=halo,
                                               cols=plan.cols, row0=axis.lo,
                                               **kw)

        spec_x = packing.pack_spec(state.x)
        spec_y = packing.pack_spec(state.y)
        dxb = packing.pack(dx, spec_x)
        dyb = packing.pack(dy, spec_y)
        xb = agg(packing.pack(state.x, spec_x) + eta_sx * dxb)
        yb = agg(packing.pack(state.y, spec_y) + eta_sy * dyb)
        if track:
            spec_cx = packing.pack_spec(state.cx)
            spec_cy = packing.pack_spec(state.cy)
            cx0 = packing.pack(state.cx, spec_cx)
            cy0 = packing.pack(state.cy, spec_cy)
            cxb = (cx0.to(torch.float32)
                   + corr_x * (dxb - agg(dxb))).to(cx0.dtype)
            cyb = (cy0.to(torch.float32)
                   + corr_y * (dyb - agg(dyb))).to(cy0.dtype)
            cx = packing.unpack(cxb, spec_cx)
            cy = packing.unpack(cyb, spec_cy)
        else:
            cx, cy = state.cx, state.cy
        return _done(KGTState(x=packing.unpack(xb, spec_x),
                              y=packing.unpack(yb, spec_y), cx=cx, cy=cy,
                              round=state.round + 1), state, mask)

    def _round(state, batches, noise, eta_cx, eta_cy, eta_sx, eta_sy,
               corr_x, corr_y, w_t=None, mask=None, adv=None) -> KGTState:
        with collectives.phase("gossip"):
            return _round_body(state, batches, noise, eta_cx, eta_cy,
                               eta_sx, eta_sy, corr_x, corr_y, w_t, mask,
                               adv)

    def _round_body(state, batches, noise, eta_cx, eta_cy, eta_sx, eta_sy,
                    corr_x, corr_y, w_t, mask, adv) -> KGTState:
        if direct_w:
            if w_t is None:
                w_t = get_w(state.round)
            if mask is not None:
                w_t = (sparse_lib.sparse_masked_w(w_t, mask) if sparse_w
                       else stoch_lib.masked_w(w_t, mask))
            mix = (None if traced_mix is None
                   else (lambda tree: traced_mix(tree, w_t)))
        else:
            mix = make_mix(state.round)
        if fused:
            return _fused_round(state, batches, noise, w_t, mask, eta_cx,
                                eta_cy, eta_sx, eta_sy, corr_x, corr_y)
        # Δx = x^{(t)+K} − x^{(t)}; the iterates are not kept
        with collectives.phase("local_steps"):
            stepped = _local_steps(state, batches, noise, eta_cx, eta_cy)
        dx, dy = (_tree_sub(v, v0) for v, v0 in zip(
            stepped, (state.x, state.y)))
        del stepped
        if adv is not None:
            # the attacker's outgoing Δ, corrupted before every use below
            # and before the participation zeroing (an inactive attacker
            # sends nothing, like an inactive honest client)
            dx = adversary_lib.apply_attack(adv, dx, stream=0)
            dy = adversary_lib.apply_attack(adv, dy, stream=1)
        if mask is not None:
            # inactive clients contribute no local update: with Δ_i = 0 and
            # W row/column i = e_i, lines 7-11 are no-ops for them
            dx = _tree_mask_clients(mask, dx)
            dy = _tree_mask_clients(mask, dy)
        if robust:
            return _robust_round(state, dx, dy, w_t, mask, eta_sx, eta_sy,
                                 corr_x, corr_y)
        if packed or sparse:
            return _packed_round(state, dx, dy, w_t, get_rows(state.round),
                                 mask, eta_sx, eta_sy, corr_x, corr_y)
        # Algorithm 1 gossips Δ (lines 7-8) and the parameters (lines
        # 10-11); the fused_* impls stack both into one mix per leaf.  The
        # mixers act leaf by leaf, so the epilogue runs one leaf at a time
        # and holds one leaf's WΔ, Wx and Δ − WΔ at once, not whole trees.
        def mix_pair(delta, base):
            if impl.startswith("fused"):
                p = mix(torch.stack([delta.to(torch.float32),
                                     base.to(torch.float32)], dim=1))
                return p[:, 0], p[:, 1]
            return mix(delta), mix(base)

        def epilogue(delta, base, c, eta_s, corr):
            """(Wθ + η_s·WΔ, c + corr·(Δ − WΔ)) leaf by leaf (c None: no
            correction)."""
            d_leaves, b_leaves = tree_lib.leaves(delta), tree_lib.leaves(base)
            c_leaves = None if c is None else tree_lib.leaves(c)
            new_b, new_c = [], []
            for j, (d, b) in enumerate(zip(d_leaves, b_leaves)):
                md, mb = mix_pair(d, b)
                if c_leaves is not None:
                    new_c.append(_tree_axpy(corr, d - md, c_leaves[j]))
                new_b.append(_tree_axpy(eta_s, md, mb))
            b_def = tree_lib.flatten(base)[1]
            return (tree_lib.unflatten(b_def, new_b),
                    None if c is None else tree_lib.unflatten(
                        tree_lib.flatten(c)[1], new_c))

        # x ← W(x + η_s Δx) = Wx + η_s·WΔx
        x_new, cx = epilogue(dx, state.x, state.cx if track else None,
                             eta_sx, corr_x)
        del dx
        y_new, cy = epilogue(dy, state.y, state.cy if track else None,
                             eta_sy, corr_y)
        if not track:
            cx, cy = state.cx, state.cy
        return _done(KGTState(x=x_new, y=y_new, cx=cx, cy=cy,
                              round=state.round + 1), state, mask)

    n_extras = int(traced_w) + int(participation) + int(byzantine)
    extras_doc = "".join(f"[{name}]" for name, on in (
        ("w", traced_w), ("mask", participation), ("adversary", byzantine))
                         if on)

    def _split_extras(extras):
        if len(extras) != n_extras:
            raise TypeError(
                f"round_step expected {n_extras} extra operand(s) "
                f"{extras_doc or '(none)'} after noise"
                f"{' and etas' if traced_etas else ''}, got {len(extras)}")
        it = iter(extras)
        w_t = next(it) if traced_w else None
        mask = next(it) if participation else None
        adv = next(it) if byzantine else None
        return w_t, mask, adv

    if traced_etas:
        def round_step(state: KGTState, batches, noise, etas,
                       *extras) -> KGTState:
            w_t, mask, adv = _split_extras(extras)
            e = {k: float(v) for k, v in etas.items()}
            # η_s = 1 for the no-tracking baselines (plain averaging)
            return _round(state, batches, noise, e["eta_cx"], e["eta_cy"],
                          e["eta_sx"] if track else 1.0,
                          e["eta_sy"] if track else 1.0,
                          e["corr_x"] if track else None,
                          e["corr_y"] if track else None,
                          w_t=w_t, mask=mask, adv=adv)

        round_step.uses_round = bool(cfg.topology_cycle)
        return round_step

    eta_sx = cfg.eta_sx if track else 1.0
    eta_sy = cfg.eta_sy if track else 1.0

    def round_step(state: KGTState, batches, noise, *extras) -> KGTState:
        w_t, mask, adv = _split_extras(extras)
        scale = lr_scale(state.round) if lr_scale is not None else 1.0
        eta_cx = cfg.eta_cx * scale
        eta_cy = cfg.eta_cy * scale
        # the correction scales are host float64, rounded once to f32
        corr_x = 1.0 / (k_steps * eta_cx) if track else None
        corr_y = -1.0 / (k_steps * eta_cy) if track else None
        return _round(state, batches, noise, eta_cx, eta_cy, eta_sx, eta_sy,
                      corr_x, corr_y, w_t=w_t, mask=mask, adv=adv)

    round_step.uses_round = lr_scale is not None or bool(cfg.topology_cycle)
    return round_step


# ---------------------------------------------------------------------------
# Diagnostics
# ---------------------------------------------------------------------------

def mean_over_clients(tree, axis=None):
    """The mean over every client of each leaf; on the mesh (``axis``) the
    rank's partial sums all-reduced."""
    return tree_lib.tree_map(lambda x: collectives.clients_mean(x, axis),
                             tree)


def correction_mean_norm(tree, axis=None, block=None) -> torch.Tensor:
    """‖c̄‖ = ‖(1/n) Σ_i c_i‖ over all leaves — Lemma 8 says exactly 0 for
    the tracking variants.  On the mesh (``axis``) c̄ is all-reduced; where
    the leaves are pieces of a client split over a block of ranks, the
    sum of squares is taken over it too (``block``, its
    ``dist.collectives.BlockSum``)."""
    squares = [torch.square(collectives.clients_mean(l, axis).to(
        torch.float32)) for l in tree_lib.leaves(tree)]
    if block is not None:
        return torch.sqrt(block(squares))
    return torch.sqrt(sum(torch.sum(t) for t in squares))


def diagnostics(problem: MinimaxProblem, state: KGTState):
    """Exact ‖∇Φ(x̄)‖ (quadratic problems) + consensus errors."""
    out = {
        "consensus_x": mixing_lib.consensus_error(state.x),
        "consensus_y": mixing_lib.consensus_error(state.y),
        "correction_mean_norm": correction_mean_norm(state.cx),
        "correction_mean_norm_y": correction_mean_norm(state.cy),
    }
    if problem.phi_grad is not None:
        out["phi_grad_norm"] = problem.phi_grad_norm(
            mean_over_clients(state.x))
    return out
