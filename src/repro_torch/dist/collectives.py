"""The collectives of the port's meshes: what GSPMD inserts for the
reference, written out.  The only module that calls ``torch.distributed``
on the round path and on the serving path.

An axis of a mesh is a :class:`MeshAxis`: this rank's index on it, its
size and its process group (a sub-group of the world: the ``model`` ranks
of one batch shard, the ``data`` ranks of one model shard, the clients
axis).  A rank of the clients axis holds n/R of the n clients, rows
``[lo, hi)`` of every (n, …) state leaf (:class:`ClientsAxis`).  The K
local steps touch only those rows; a round's gossips are the collectives
here:

* **dense gossip** (``mix_dense``, reference ``core/mixing.py:45-60``): an
  all-gather of the rank's rows in the gossip dtype, then the rank's rows
  of W contracted in f32, as ``core.mixing.mix_dense`` contracts all of W;
* **the ring** (``mix_ring``, :63-88): ``jnp.roll`` on a clients-sharded dim
  lowers to a collective-permute, so here each rank sends its first row to
  the previous rank and its last row to the next and receives theirs (2
  rows a rank, not n), through ``batch_isend_irecv``;
* **the packed epilogue** (``gossip_pair``, ``mix_packed`` :91): one
  all-gather a variable of its stacked (Δ, θ) buffer, then the round
  epilogue θ' = W_r θ + η_s·W_r Δ, c' = c + s·(Δ − W_r Δ) on the rank's
  rows W_r: ``kernels.ops.fused_gossip_pair``'s row block (kernel B1 on
  the card, ``kernels.ref.fused_gossip_ref`` on the CPU);
* **the halo exchange** (``halo_rows`` over a :class:`HaloPlan`): the
  neighbour rows that a rank's neighbour lists read and it does not hold,
  and only those, every send and receive of the rank in one batch —
  what the reference's gather-based sparse oracle gathers.  Over it run
  ``sparse_packed``'s epilogue (``sparse_gossip_pair``: kernel B4 on the
  card over the remapped table), its no-tracking mix (``sparse_mix``) and
  the robust rules (``core.mixing.robust_mix_dense`` /
  ``robust_mix_sparse`` with ``halo``);
* **all-reduced means** (``clients_mean``, ``all_reduce_sum``) and a
  **broadcast** for the metrics.

The serving mesh's tensor parallelism (``dist.tensor_parallel``) adds two
over its ``model`` axis: **a sum of partial products** (``sum_over``: the
mixers' out-projections' and the MLP's row-parallel partials, the SSM's
sums of squares for its gated norm, the vocab-parallel embedding rows),
and **an all-gather along the last dim in pieces** (``all_gather_last``:
each rank's vocab columns of the logits, uneven where M does not divide
V, and each rank's channels of the RG-LRU's gate input).  They count as
``all_reduce`` and ``all_gather``.  A prefill splits the residual's
sequence over ``model`` (Megatron's sequence parallelism,
``tensor_parallel.SeqSplit``): **an all-gather of the sequence's pieces**
where the residual enters a column-parallel piece (``gather_seq``) and
**a reduce-scatter** of the row-parallel partials back to them
(``scatter_seq``: summed in f32 in rank order, as ``sum_over`` sums),
pieces of ⌈S/M⌉ along any dim, the last ones shorter or empty, padded
and trimmed on the wire, counted as ``seq_gather`` and ``seq_scatter``;
the last position reaches every rank by a ``broadcast``
(``last_position``).

Training over a client's ``(fsdp, model)`` block (``dist.tensor_parallel.
ClientShard``) runs them as autograd Functions with ``vmap`` rules, each
backward the other of its pair: **the fsdp gather** of a weight's ZeRO-3
pieces (``fsdp_gather``, kind ``fsdp_gather``; its backward a
**reduce-scatter** of the gradient, pairwise, summed in f32 in rank
order, ``reduce_scatter``; over ``model`` the RG-LRU's gate input,
``model_gather`` / ``model_scatter``, and the residual's sequence,
``gather_seq`` / ``scatter_seq``, with ``SeqGatherPair`` for the MoE's
input, whose router's gradient is whole on every rank), Megatron's
**copy** (identity
forward, its gradient summed over ``model``) and **sum** (``axis_copy`` /
``axis_sum``, kind ``model_sum``; over fsdp the per-group loss sums and
the MoE aux's, ``batch_sum``), and **an all-reduced max** (``axis_max`` /
``all_reduce_max``: the vocabulary pieces' log-sum-exp maxima, int8's row
scale over a split row).

A world of one rank makes no collective: an all-gather of one rank is the
tensor itself and a mean over one rank's clients is the host path's mean,
so a one-rank mesh runs the host path's operations.

Gloo reads a send's or receive's buffer as host memory, so on gloo a CUDA
tensor crosses through pinned host buffers made here (PyTorch's caching
host allocator keeps them for the next call), whatever the op: the rank's
rows go down once, and only what the other ranks sent comes back up, into
place in the output.  The bytes copied (both ways) count as
``staged_bytes``.  One gloo group moves ~0.5 GB/s a direction between two
ranks of one host (one TCP connection, one thread: PERF.md §5), so a large
gloo transfer is split over GLOO_STREAMS groups of the same ranks at once
(``MeshAxis.streams``).  NCCL takes device tensors.

Counters, in the style of ``kernels.ops``' launch counters:
``collective_counts()`` gives, per phase (``local_steps``, ``gossip``,
``metrics``, ``init``, ``checkpoint``, ``prefill``, ``decode``; :func:`phase`
sets it) and kind (``all_gather``, ``exchange``, ``halo``, ``all_reduce``,
``broadcast``), the calls, the bytes this rank received from the others (an
all-gather's (R − 1)/R of its output, an exchange's or a halo's rows, an
all-reduce's or broadcast's payload) and the seconds of the calls: for a
CUDA tensor
between two CUDA events recorded on the current stream around the call
(read when the counts are, so that no call waits for the device), for a
CPU tensor on the host clock.  ``zero_collective_counts()`` resets them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import sparse_topology as sparse_lib
from repro_torch.core import tree as tree_lib
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import gossip_torch_dtype, narrow

# the gloo groups a large transfer is split over, and the least bytes a
# piece of it carries
GLOO_STREAMS = 4
STREAM_BYTES = 8 << 20


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """This rank's place on one axis of a mesh: ``size`` ranks, this one
    its ``rank``-th.  ``group`` is the axis' process group (None: the
    default group), ``backend`` its backend; ``streams`` more gloo groups
    over the same ranks, for a large transfer to share (module
    docstring)."""
    rank: int
    size: int
    group: Any = None
    backend: str = "gloo"
    streams: tuple = ()

    def global_rank(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group,
                                                                 r)


@dataclasses.dataclass(frozen=True, kw_only=True)
class ClientsAxis(MeshAxis):
    """The clients axis: its ``size`` ranks share the ``n`` clients, rank
    ``rank`` of them holding rows ``[lo, hi)``."""
    n: int

    def __post_init__(self):
        if self.n % self.size:
            raise ValueError(
                f"{self.size} ranks cannot share {self.n} clients evenly: "
                "the clients axis must divide the number of clients")

    @property
    def n_local(self) -> int:
        return self.n // self.size

    @property
    def lo(self) -> int:
        return self.rank * self.n_local

    @property
    def hi(self) -> int:
        return self.lo + self.n_local

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of an (n, …) tensor, a copy of its own."""
        return x[self.lo:self.hi].clone()


def gloo_streams(group) -> tuple:
    """GLOO_STREAMS − 1 more gloo groups over ``group``'s ranks where
    ``group`` is a gloo group of more than one rank spanning the world
    (every rank of the world makes them, in the same order), else ()."""
    size = dist.get_world_size(group)
    if (dist.get_backend(group) != "gloo" or size == 1
            or size != dist.get_world_size()):
        return ()
    ranks = dist.get_process_group_ranks(group)
    return tuple(dist.new_group(ranks, backend="gloo")
                 for _ in range(GLOO_STREAMS - 1))


def clients_axis(mesh, n: int) -> ClientsAxis:
    """The :class:`ClientsAxis` of this rank on ``mesh``'s ``clients``
    dim, for ``n`` clients (every rank calls it: it may make groups)."""
    group = mesh.get_group("clients")
    return ClientsAxis(n=n, rank=mesh.get_local_rank("clients"),
                       size=mesh.size(mesh.mesh_dim_names.index("clients")),
                       group=group, backend=dist.get_backend(group),
                       streams=gloo_streams(group))


def axis_of_group(group, n: int, streams: tuple = ()) -> ClientsAxis:
    """The :class:`ClientsAxis` of this rank over a whole process group."""
    return ClientsAxis(n=n, rank=dist.get_rank(group),
                       size=dist.get_world_size(group), group=group,
                       backend=dist.get_backend(group), streams=streams)


def sub_axes(rank_lists: Sequence[Sequence[int]], *,
             streams: bool = True) -> Optional[MeshAxis]:
    """One process group for each list of global ranks in ``rank_lists``
    (every rank of the world calls this, with the same lists, in the same
    order), on the world's backend, with GLOO_STREAMS − 1 stream groups
    beside each gloo group of more than one rank (unless ``streams`` is
    False: an axis that moves only a few bytes); returns this rank's
    :class:`MeshAxis` on the list that holds it (None if none does)."""
    me = dist.get_rank()
    backend = dist.get_backend()
    mine = None
    for ranks in rank_lists:
        ranks = list(ranks)
        group = dist.new_group(ranks, backend=backend)
        extra = ()
        if streams and backend == "gloo" and len(ranks) > 1:
            extra = tuple(dist.new_group(ranks, backend="gloo")
                          for _ in range(GLOO_STREAMS - 1))
        if me in ranks:
            mine = MeshAxis(rank=ranks.index(me), size=len(ranks),
                            group=group, backend=backend, streams=extra)
    return mine


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

_counts: dict = {}          # (phase, kind) -> [calls, bytes, seconds]
_staged = [0]
_phases = ["other"]
_pending: list = []         # (entry, start, end) events not yet read


def _read_events(wait: bool) -> None:
    """Adds the elapsed time of the pending calls' event pairs to their
    entries, in order: all of them (``wait``), else those that ended."""
    while _pending and (wait or _pending[0][2].query()):
        entry, start, end = _pending.pop(0)
        end.synchronize()
        entry[2] += start.elapsed_time(end) / 1e3


def collective_counts() -> dict:
    """``{phase: {kind: {"calls", "bytes", "seconds"}}}`` so far in this
    process, and ``"staged_bytes"``: the bytes copied between the card and
    the host for gloo."""
    _read_events(wait=True)
    out: dict = {}
    for (ph, kind), (calls, nbytes, secs) in _counts.items():
        out.setdefault(ph, {})[kind] = {"calls": calls, "bytes": nbytes,
                                        "seconds": secs}
    out["staged_bytes"] = _staged[0]
    return out


def zero_collective_counts() -> None:
    _counts.clear()
    _pending.clear()
    _staged[0] = 0


@contextlib.contextmanager
def phase(name: str):
    """Collectives inside the block count under ``name``."""
    _phases.append(name)
    try:
        yield
    finally:
        _phases.pop()


@contextlib.contextmanager
def _op(kind: str, device: torch.device):
    entry = _counts.setdefault((_phases[-1], kind), [0, 0, 0.0])
    cuda = device.type == "cuda"
    if cuda:
        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
    t0 = time.perf_counter()
    rec = {"bytes": 0}
    yield rec
    entry[0] += 1
    entry[1] += rec["bytes"]
    if cuda:
        end = torch.cuda.Event(enable_timing=True)
        end.record(stream)
        _pending.append((entry, start, end))
        _read_events(wait=False)
    else:
        entry[2] += time.perf_counter() - t0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _staging(axis: MeshAxis, t: torch.Tensor) -> bool:
    return axis.backend == "gloo" and t.is_cuda


def _pinned_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def _to_wire(axis: MeshAxis, t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend reads it: a pinned host copy for gloo and a
    CUDA tensor, else ``t`` (contiguous)."""
    t = t.contiguous()
    if _staging(axis, t):
        host = _pinned_like(t)
        host.copy_(t)
        _staged[0] += _nbytes(t)
        return host
    return t


def _recv_like(wire: torch.Tensor, staged: bool) -> torch.Tensor:
    return _pinned_like(wire) if staged else torch.empty_like(wire)


def _from_wire(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    if t.device != device:
        _staged[0] += _nbytes(t)
        return t.to(device)
    return t


def _pieces(axis: MeshAxis, flat: torch.Tensor):
    """(group, start, stop) pieces of a flat tensor: one a stream group, no
    piece under STREAM_BYTES, the axis' own group first; none for an
    empty tensor (a weight's empty fsdp piece)."""
    if flat.numel() == 0:
        return []
    groups = (axis.group,) + axis.streams
    k = max(1, min(len(groups), _nbytes(flat) // STREAM_BYTES))
    step = -(-flat.numel() // k)
    return [(g, a, min(a + step, flat.numel()))
            for g, a in zip(groups, range(0, flat.numel(), step))]


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def all_gather_rows(x: torch.Tensor, axis: MeshAxis, dim: int = 0, *,
                    kind: str = "all_gather") -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order: the
    (n, …) tensor of the rank's (n/R, …) rows (``x`` itself on one
    rank).  Over gloo the ranks exchange their pieces pairwise (every
    send and receive in one batch, :func:`_p2p`): gloo's own all-gather
    passes every rank's piece through a fresh flat host buffer and copies
    it out again, which made a 3 GB gather 5× slower than the same bytes
    moved pairwise (PERF.md §6)."""
    if axis.size == 1:
        return x
    with _op(kind, x.device) as rec:
        staged = _staging(axis, x)
        wire = _to_wire(axis, x)
        if axis.backend == "gloo":
            parts = [wire if r == axis.rank else _recv_like(wire, staged)
                     for r in range(axis.size)]
            peers = [r for r in range(axis.size) if r != axis.rank]
            _p2p([(dist.isend, wire, r) for r in peers]
                 + [(dist.irecv, parts[r], r) for r in peers], axis)
        else:
            flat = wire.reshape(-1)
            recv = [_recv_like(flat, staged) for _ in range(axis.size)]
            works = [dist.all_gather([r[a:b] for r in recv], flat[a:b],
                                     group=g, async_op=True)
                     for g, a, b in _pieces(axis, flat)]
            for w in works:
                w.wait()
            parts = [r.view(wire.shape) for r in recv]
        rec["bytes"] = (axis.size - 1) * _nbytes(wire)
        if not staged:
            return torch.cat(parts, dim=dim)
        # the other ranks' rows straight into place on the card; the
        # rank's own rows from where they are
        k = x.shape[dim]
        out = torch.empty((*x.shape[:dim], k * axis.size,
                           *x.shape[dim + 1:]), dtype=x.dtype,
                          device=x.device)
        for r, part in enumerate(parts):
            dst = out.narrow(dim, r * k, k)
            if r == axis.rank:
                dst.copy_(x)
            else:
                dst.copy_(part)
                _staged[0] += _nbytes(part)
    return out


def all_reduce_sum(t: torch.Tensor, axis: MeshAxis, *,
                   kind: str = "all_reduce") -> torch.Tensor:
    """The sum of every rank's ``t`` (``t`` itself on one rank)."""
    if axis.size == 1:
        return t
    with _op(kind, t.device) as rec:
        wire = _to_wire(axis, t)
        if wire is t or wire.data_ptr() == t.data_ptr():
            wire = wire.clone()
        flat = wire.reshape(-1)
        works = [dist.all_reduce(flat[a:b], group=g, async_op=True)
                 for g, a, b in _pieces(axis, flat)]
        for w in works:
            w.wait()
        out = _from_wire(wire, t.device)
        rec["bytes"] = _nbytes(wire)
    return out


def broadcast_from(t: torch.Tensor, src: int,
                   axis: MeshAxis) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank (each rank passes a tensor of the
    same shape and dtype)."""
    if axis.size == 1:
        return t
    with _op("broadcast", t.device) as rec:
        wire = _to_wire(axis, t)
        if wire is t or wire.data_ptr() == t.data_ptr():
            wire = wire.clone()
        dist.broadcast(wire, src=axis.global_rank(src), group=axis.group)
        out = _from_wire(wire, t.device)
        rec["bytes"] = 0 if axis.rank == src else _nbytes(wire)
    return out


def sum_over(t: torch.Tensor, axis: MeshAxis, *,
             kind: str = "all_reduce") -> torch.Tensor:
    """The sum over the axis' ranks of each rank's partial ``t``, in
    ``t``'s dtype: the partials all-reduced in f32, then rounded once to
    ``t``'s dtype (a bf16 sum of M partials would round M − 1 more
    times); ``t`` itself on one rank.  Every rank gets the same values."""
    if axis.size == 1:
        return t
    return all_reduce_sum(t.to(torch.float32), axis, kind=kind).to(t.dtype)


def all_reduce_max(t: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The elementwise max of every rank's ``t`` (``t`` itself on one
    rank), exact in any dtype; counted as ``all_reduce_max``."""
    if axis.size == 1:
        return t
    with _op("all_reduce_max", t.device) as rec:
        wire = _to_wire(axis, t)
        if wire is t or wire.data_ptr() == t.data_ptr():
            wire = wire.clone()
        dist.all_reduce(wire, op=dist.ReduceOp.MAX, group=axis.group)
        out = _from_wire(wire, t.device)
        rec["bytes"] = _nbytes(wire)
    return out


def reduce_scatter_rows(x: torch.Tensor, axis: MeshAxis, *,
                        kind: str = "reduce_scatter") -> torch.Tensor:
    """This rank's block of rows of the sum over the axis' ranks of each
    rank's ``x`` (size·k, …): rank r gets rows [r·k, (r + 1)·k) of the
    sum, its own block and the others' (each rank sends every peer its
    block, all in one batch) added in f32 in rank order and rounded once
    to ``x``'s dtype.  Counted as ``kind`` (bytes: the blocks
    received).  ``x`` itself on one rank."""
    if axis.size == 1:
        return x
    k = x.shape[0] // axis.size
    if k * axis.size != x.shape[0]:
        raise ValueError(f"{x.shape[0]} rows do not split over "
                         f"{axis.size} ranks")
    with _op(kind, x.device) as rec:
        staged = _staging(axis, x)
        pairs, got = [], {}
        for p in range(axis.size):
            if p == axis.rank:
                continue
            block = _to_wire(axis, x[p * k:(p + 1) * k])
            buf = _recv_like(block, staged)
            pairs += [(dist.isend, block, p), (dist.irecv, buf, p)]
            got[p] = buf
        _p2p(pairs, axis)
        acc = None
        for p in range(axis.size):
            part = (x[p * k:(p + 1) * k] if p == axis.rank
                    else _from_wire(got[p], x.device))
            part = part.to(torch.float32)
            acc = part if acc is None else acc + part
        rec["bytes"] = sum(_nbytes(g) for g in got.values())
    return acc.to(x.dtype)


def all_gather_last(x: torch.Tensor, axis: MeshAxis,
                    widths: Sequence[int]) -> torch.Tensor:
    """Every rank's ``x`` concatenated along its last dim in rank order,
    rank r's piece ``widths[r]`` wide (the pieces may differ by one, as a
    vocabulary that the axis does not divide leaves them): each piece
    padded to the widest for one all-gather, then trimmed.  ``x`` itself
    on one rank."""
    if axis.size == 1:
        return x
    if x.shape[-1] != widths[axis.rank]:
        raise ValueError(f"rank {axis.rank}'s piece is {x.shape[-1]} wide, "
                         f"the plan gives it {widths[axis.rank]}")
    wide = max(widths)
    padded = F.pad(x, (0, wide - x.shape[-1])) if x.shape[-1] < wide else x
    g = all_gather_rows(padded.unsqueeze(0), axis)
    return torch.cat([g[r, ..., :w] for r, w in enumerate(widths)], dim=-1)


def _p2p(pairs, axis: MeshAxis) -> None:
    """Each (op, tensor, peer) of ``pairs`` in pieces over the stream
    groups, all in flight at once."""
    by_group: dict = {}
    for op, t, peer in pairs:
        flat = t.reshape(-1)
        for g, a, b in _pieces(axis, flat):
            by_group.setdefault(g, []).append(
                dist.P2POp(op, flat[a:b], axis.global_rank(peer), group=g))
    reqs = [req for ops in by_group.values()
            for req in dist.batch_isend_irecv(ops)]
    for req in reqs:
        req.wait()


def ring_neighbors(x: torch.Tensor, axis: MeshAxis):
    """(the previous rank's last row, the next rank's first row), each
    (1, …): what ``torch.roll(·, ±1)`` over the whole clients dim brings
    across this rank's ends.  Two rows received a rank (one message each
    way with a single peer)."""
    r, size = axis.rank, axis.size
    prev, nxt = (r - 1) % size, (r + 1) % size
    with _op("exchange", x.device) as rec:
        staged = _staging(axis, x)
        if size == 2:
            send = _to_wire(axis, torch.cat([x[:1], x[-1:]]))
            got = _recv_like(send, staged)
            _p2p([(dist.isend, send, nxt), (dist.irecv, got, prev)], axis)
            got = _from_wire(got, x.device)
            up, dn = got[1:2], got[0:1]
            rec["bytes"] = _nbytes(send)
        else:
            first, last = _to_wire(axis, x[:1]), _to_wire(axis, x[-1:])
            up_w, dn_w = _recv_like(last, staged), _recv_like(first, staged)
            _p2p([(dist.isend, first, prev), (dist.isend, last, nxt),
                  (dist.irecv, up_w, prev), (dist.irecv, dn_w, nxt)], axis)
            up, dn = _from_wire(up_w, x.device), _from_wire(dn_w, x.device)
            rec["bytes"] = _nbytes(up_w) + _nbytes(dn_w)
    return up, dn


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """What a rank of the clients axis exchanges to read its neighbour
    lists' rows (:func:`halo_plan`): ``recv[p]``, the rows of rank p that
    this rank's lists reference (global ids, ascending; the halo is their
    concatenation in rank order); ``send[p]``, this rank's local rows that
    rank p's lists reference; ``table``, this rank's (n/R, m) lists
    remapped onto local indices over [own rows; halo rows] (own rows
    first, padding on the row's own local index with weight 0); ``cols``,
    the global row of each of those n/R + n_halo source rows."""
    recv: tuple
    send: tuple
    table: Any
    cols: torch.Tensor

    @property
    def n_halo(self) -> int:
        return sum(len(r) for r in self.recv)

    @property
    def active(self) -> bool:
        """Whether the rank sends or receives anything."""
        return any(self.recv) or any(self.send)


def halo_plan(sp, axis: ClientsAxis, device="cpu") -> HaloPlan:
    """The :class:`HaloPlan` of this rank for the static neighbour lists
    ``sp`` (a ``SparseTopology`` over all n clients; every rank has it, so
    every rank computes the same sends and receives and no message is
    needed to agree on them).  Built once, on the host.  A world of one
    rank has an empty plan: no row crosses, the table is ``sp``'s."""
    idx = sp.neighbor_idx.cpu().numpy()
    k = axis.n_local

    def reads(r):
        """The rows outside rank r's own that its lists reference."""
        rows = np.unique(idx[r * k:(r + 1) * k])
        return rows[(rows < r * k) | (rows >= (r + 1) * k)]

    mine = reads(axis.rank)
    recv = tuple(tuple(int(g) for g in mine if g // k == p)
                 for p in range(axis.size))
    send = tuple(() if p == axis.rank else
                 tuple(int(g) - axis.lo for g in reads(p)
                       if axis.lo <= g < axis.hi)
                 for p in range(axis.size))
    cols = np.concatenate([np.arange(axis.lo, axis.hi),
                           np.asarray([g for r in recv for g in r],
                                      dtype=np.int64)]).astype(np.int64)
    local = np.full(axis.n, -1, dtype=np.int64)
    local[cols] = np.arange(len(cols))
    rows = slice(axis.lo, axis.hi)
    table = sparse_lib.SparseTopology(
        neighbor_idx=torch.as_tensor(local[idx[rows]], dtype=torch.int32),
        neighbor_w=sp.neighbor_w[rows].cpu(), self_w=sp.self_w[rows].cpu(),
        degree=sp.degree[rows].cpu()).to(device)
    return HaloPlan(recv=recv, send=send, table=table,
                    cols=torch.as_tensor(cols, device=device))


def halo_rows(x: torch.Tensor, plan: HaloPlan,
              axis: MeshAxis) -> torch.Tensor:
    """The halo rows of ``plan`` of every rank's (n/R, …) ``x``, (n_halo,
    …) in the plan's order, in ``x``'s dtype: this rank's rows that the
    others read sent to them and theirs received, every send and receive
    in one batch (a rank whose lists reach several peers, as on the
    exponential graph, posts them all before it waits).  Counted as one
    ``halo`` call where the rank takes part (bytes: the rows received);
    no call where it sends and receives nothing (a world of one rank)."""
    if not plan.active:
        return x[:0]
    with _op("halo", x.device) as rec:
        staged = _staging(axis, x)
        pairs, got = [], []
        for p in range(axis.size):
            if plan.send[p]:
                rows = torch.as_tensor(plan.send[p], device=x.device)
                pairs.append((dist.isend,
                              _to_wire(axis, x.index_select(0, rows)), p))
            if plan.recv[p]:
                shape = (len(plan.recv[p]), *x.shape[1:])
                buf = (torch.empty(shape, dtype=x.dtype, pin_memory=True)
                       if staged else torch.empty(shape, dtype=x.dtype,
                                                  device=x.device))
                pairs.append((dist.irecv, buf, p))
                got.append(buf)
        _p2p(pairs, axis)
        out = (torch.cat([_from_wire(g, x.device) for g in got]) if got
               else x[:0])
        rec["bytes"] = sum(_nbytes(g) for g in got)
    return out


# ---------------------------------------------------------------------------
# gossip over a clients-sharded state
# ---------------------------------------------------------------------------

def _wire_dtype(x: torch.Tensor, gd: Optional[torch.dtype]) -> torch.Tensor:
    """``x`` in the dtype it travels in: the gossip dtype, else its own
    (``narrow`` of the gathered value is then the host path's)."""
    return x if gd is None else x.to(gd)


def mix_dense(tree: Any, w_rows: torch.Tensor, axis: ClientsAxis,
              gossip_dtype=None) -> Any:
    """This rank's rows of W @ leaves: each (n/R, …) leaf all-gathered in
    the gossip dtype, contracted with ``w_rows`` (this rank's (n/R, n)
    rows of W) in f32."""
    gd = gossip_torch_dtype(gossip_dtype)
    wg = narrow(w_rows, gd)

    def one(x):
        g = all_gather_rows(_wire_dtype(x, gd), axis).to(torch.float32)
        mixed = wg @ g.reshape(axis.n, -1)
        return mixed.reshape(x.shape).to(x.dtype)

    return tree_lib.tree_map(one, tree)


def mix_ring(tree: Any, w_self: float, w_nbr: float, axis: ClientsAxis,
             gossip_dtype=None) -> Any:
    """Ring mixing w_self·x_i + w_nbr·(x_{i−1} + x_{i+1}) of this rank's
    rows, the rows across its ends brought by :func:`ring_neighbors`;
    elementwise the host path's ``core.mixing.mix_ring``."""
    gd = gossip_torch_dtype(gossip_dtype)

    def one(x):
        if axis.n == 1:
            return x
        xc = narrow(x, gd)
        if axis.size == 1:
            up = torch.roll(xc, 1, dims=0)
            dn = torch.roll(xc, -1, dims=0)
        else:
            up_row, dn_row = ring_neighbors(_wire_dtype(xc, gd), axis)
            up = torch.cat([up_row.to(torch.float32), xc[:-1]])
            dn = torch.cat([xc[1:], dn_row.to(torch.float32)])
        if axis.n == 2:
            mixed = w_self * xc + w_nbr * up
        else:
            mixed = w_self * xc + w_nbr * (up + dn)
        return mixed.to(x.dtype)

    return tree_lib.tree_map(one, tree)


def gossip_pair(w_rows: torch.Tensor, x, y, axis: ClientsAxis,
                gossip_dtype=None, *, backend: str = "auto"):
    """The packed round epilogue of both variables of a round (x, y:
    (delta, theta, c, eta_s, corr_scale)) over a clients-sharded (n/R, D)
    state: one all-gather a variable of its stacked (Δ, θ), then
    (θ', c') = (W_r θ + η_s·W_r Δ, c + s·(Δ − W_r Δ)) in f32, W_r this
    rank's rows of W, by one ``kernels.ops.fused_gossip_pair`` call at
    ``row0 = axis.lo`` — one launch of B1 on the card.  Only the
    contraction's operands travel narrowed: the rank's own Δ rows go back
    in f32 for the correction.  Returns f32 (θx', cx', θy', cy')."""
    gd = gossip_torch_dtype(gossip_dtype)
    vars_ = []
    for delta, theta, c, eta_s, corr in (x, y):
        d32 = delta.to(torch.float32)
        both = _wire_dtype(torch.stack([d32, theta.to(torch.float32)]), gd)
        g = all_gather_rows(both, axis, dim=1).to(torch.float32)
        g[0, axis.lo:axis.hi] = d32
        vars_.append((g[0], g[1], c, eta_s, corr))
    return kernel_ops.fused_gossip_pair(w_rows, *vars_, backend=backend,
                                        gossip_dtype=gossip_dtype,
                                        row0=axis.lo)


def sparse_gossip_pair(plan: HaloPlan, x, y, axis: ClientsAxis,
                       gossip_dtype=None, *, backend: str = "auto"):
    """``sparse_packed``'s epilogue of both variables of a round over a
    clients-sharded state: one halo exchange a variable of its stacked
    (Δ, θ) rows, then one ``kernels.ops.sparse_gossip_pair`` call on the
    plan's remapped table over the sources [own rows (f32); halo rows] —
    one launch of B4 on the card.  Returns f32 (θx', cx', θy', cy')."""
    gd = gossip_torch_dtype(gossip_dtype)
    vars_ = []
    for delta, theta, c, eta_s, corr in (x, y):
        d32, t32 = delta.to(torch.float32), theta.to(torch.float32)
        halo = halo_rows(_wire_dtype(torch.stack([d32, t32], dim=1), gd),
                         plan, axis).to(torch.float32)
        vars_.append((torch.cat([d32, halo[:, 0]]),
                      torch.cat([t32, halo[:, 1]]), c, eta_s, corr))
    tab = plan.table
    return kernel_ops.sparse_gossip_pair(
        tab.neighbor_idx, tab.neighbor_w, tab.self_w, *vars_,
        backend=backend, gossip_dtype=gossip_dtype)


def sparse_mix(buf: torch.Tensor, plan: HaloPlan, axis: ClientsAxis,
               gossip_dtype=None) -> torch.Tensor:
    """This rank's rows of W @ buf for a clients-sharded (n/R, D) buffer
    over the halo: ``sparse_topology.sparse_mix`` on the plan's table with
    the received rows after the rank's own (the no-tracking variants of
    ``sparse_packed``)."""
    return sparse_lib.sparse_mix(plan.table, buf, gossip_dtype,
                                 halo=exchange_halo(buf, plan, axis,
                                                    gossip_dtype))


def exchange_halo(buf: torch.Tensor, plan: HaloPlan, axis: ClientsAxis,
                  gossip_dtype=None) -> torch.Tensor:
    """:func:`halo_rows` of a clients-sharded (n/R, D) buffer, sent in
    the gossip dtype (the values a mix or an order statistic reads)."""
    gd = gossip_torch_dtype(gossip_dtype)
    return halo_rows(_wire_dtype(buf.to(torch.float32), gd), plan, axis)


# ---------------------------------------------------------------------------
# means over every client
# ---------------------------------------------------------------------------

def clients_mean(x: torch.Tensor, axis: Optional[ClientsAxis]):
    """The mean over all n clients of an (n/R, …) leaf: f32 partial sums
    all-reduced, over n; ``x.mean(0)`` (the host path's) without a mesh
    or on one rank."""
    if axis is None or axis.size == 1:
        return x.mean(0)
    s = all_reduce_sum(x.to(torch.float32).sum(0), axis)
    return (s / axis.n).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class BlockSum:
    """A sum over the ranks of a client's ``(fsdp, model)`` block of
    elementwise terms of each rank's pieces, each element of the client
    counted once: ``owned`` (a tree congruent with the pieces',
    ``tensor_parallel.ClientShard.owned``) says which of this rank's
    elements it counts — True or False for a whole piece (a leaf that
    several model ranks hold whole counts on the first of them), or a 0/1
    mask that broadcasts against the piece (the SSM's B and C columns of
    ``in_proj``, which every model rank holds beside its own)."""
    axis: MeshAxis
    owned: Any

    def __call__(self, terms: Sequence[torch.Tensor]) -> torch.Tensor:
        """The block's f32 sum of ``terms``, one elementwise tensor a leaf
        in ``tree.leaves`` order (leading dims, such as the clients',
        broadcast against a mask)."""
        total = terms[0].new_zeros((), dtype=torch.float32)
        for t, own in zip(terms, tree_lib.leaves(self.owned)):
            if torch.is_tensor(own):
                t = t * own.to(t.device)
            elif not own:
                continue
            total = total + torch.sum(t.to(torch.float32))
        return all_reduce_sum(total, self.axis)


def gather_tree(tree: Any, axis: ClientsAxis) -> Any:
    """Every (n/R, …) tensor leaf all-gathered to (n, …) on every rank
    (host values pass through)."""
    return tree_lib.tree_map(
        lambda x: all_gather_rows(x, axis) if isinstance(x, torch.Tensor)
        else x, tree)


def shard_tree(tree: Any, axis: ClientsAxis) -> Any:
    """This rank's rows of every (n, …) tensor leaf (host values pass
    through)."""
    return tree_lib.tree_map(
        lambda x: axis.rows(x) if isinstance(x, torch.Tensor) else x, tree)


# ---------------------------------------------------------------------------
# a client's (fsdp, model) block in training: autograd Functions
# ---------------------------------------------------------------------------
#
# A rank's clients run under ``torch.func.vmap(grad)``, so each Function has
# a ``vmap`` rule: the clients' dim is moved to the front and the
# collective runs once on the batch (the plain tensors below the
# transforms).  Each backward is the other Function of its pair, so it
# too runs as one collective under ``vmap``: the fsdp gather's backward is
# a reduce-scatter of the summed gradient, the model axis' copy (an
# identity forward) sums its gradient, and its sum (the row-parallel
# partials) passes its gradient through unchanged (Megatron's pair).

def _front(x, dim):
    return x.movedim(dim, 0)


def fsdp_widths(rows: int, f: int):
    """Rank r's rows of a dim of ``rows`` split over ``f`` fsdp ranks:
    pieces of ⌈rows/f⌉, the last ones shorter or empty."""
    step = -(-rows // f)
    return tuple(max(0, min(step, rows - r * step)) for r in range(f))


# what a gather of pieces and its reduce-scatter count as: over fsdp a
# weight's ZeRO-3 pieces, over model the RG-LRU's gate input and the
# residual's sequence (Megatron's sequence parallelism)
FSDP_KINDS = ("fsdp_gather", "reduce_scatter")
MODEL_KINDS = ("model_gather", "model_scatter")
SEQ_KINDS = ("seq_gather", "seq_scatter")


def _gather_piece(x, axis: MeshAxis, rows: int, dim: int, kind: str):
    """The whole dim ``dim`` (``rows`` long) from every rank's piece of it
    (:func:`fsdp_widths`): each piece padded to ⌈rows/F⌉, all-gathered,
    trimmed."""
    step = -(-rows // axis.size)
    pad = step - x.shape[dim]
    if pad:
        x = torch.cat([x, x.new_zeros((*x.shape[:dim], pad,
                                       *x.shape[dim + 1:]))], dim=dim)
    return all_gather_rows(x.contiguous(), axis, dim=dim,
                           kind=kind).narrow(dim, 0, rows)


def _scatter_piece(g, axis: MeshAxis, rows: int, dim: int, kind: str):
    """This rank's piece of dim ``dim`` of the sum over the ranks of each
    rank's whole ``g`` (:func:`reduce_scatter_rows`, in f32)."""
    step = -(-rows // axis.size)
    g = g.movedim(dim, 0)
    pad = step * axis.size - rows
    if pad:
        g = torch.cat([g, g.new_zeros((pad, *g.shape[1:]))])
    part = reduce_scatter_rows(g.contiguous(), axis, kind=kind)
    width = fsdp_widths(rows, axis.size)[axis.rank]
    return part[:width].movedim(0, dim)


class FsdpGather(torch.autograd.Function):
    """A weight's rows joined from its fsdp pieces along ``dim``; its
    gradient summed over the fsdp ranks and scattered back to the
    pieces.  ``kinds``: what the gather and the reduce-scatter count as
    (:data:`FSDP_KINDS`; :func:`model_gather` and :func:`gather_seq` run
    the same pair over the model axis)."""

    @staticmethod
    def forward(x, axis, rows, dim, kinds):
        return _gather_piece(x, axis, rows, dim, kinds[0])

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.axis, ctx.rows, ctx.dim, ctx.kinds = inputs

    @staticmethod
    def backward(ctx, g):
        return FsdpScatter.apply(g, ctx.axis, ctx.rows, ctx.dim,
                                 ctx.kinds), None, None, None, None

    @staticmethod
    def vmap(info, in_dims, x, axis, rows, dim, kinds):
        if in_dims[0] is None:
            return FsdpGather.apply(x, axis, rows, dim, kinds), None
        return FsdpGather.apply(_front(x, in_dims[0]), axis, rows,
                                dim + 1, kinds), 0


class FsdpScatter(torch.autograd.Function):
    """The sum over the fsdp ranks of a whole-weight gradient, this rank's
    piece of it (the backward of :class:`FsdpGather`)."""

    @staticmethod
    def forward(g, axis, rows, dim, kinds):
        return _scatter_piece(g, axis, rows, dim, kinds[1])

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.axis, ctx.rows, ctx.dim, ctx.kinds = inputs

    @staticmethod
    def backward(ctx, g):
        return FsdpGather.apply(g, ctx.axis, ctx.rows, ctx.dim,
                                ctx.kinds), None, None, None, None

    @staticmethod
    def vmap(info, in_dims, g, axis, rows, dim, kinds):
        if in_dims[0] is None:
            return FsdpScatter.apply(g, axis, rows, dim, kinds), None
        return FsdpScatter.apply(_front(g, in_dims[0]), axis, rows,
                                 dim + 1, kinds), 0


class AxisCopy(torch.autograd.Function):
    """The identity forward, the gradient summed over the axis' ranks
    (:func:`sum_over`): where the whole residual enters a column-parallel
    piece, each rank's gradient of it is a partial."""

    @staticmethod
    def forward(x, axis, kind):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.axis, ctx.kind = inputs

    @staticmethod
    def backward(ctx, g):
        return AxisSum.apply(g, ctx.axis, ctx.kind), None, None

    @staticmethod
    def vmap(info, in_dims, x, axis, kind):
        if in_dims[0] is None:
            return AxisCopy.apply(x, axis, kind), None
        return AxisCopy.apply(x, axis, kind), in_dims[0]


class AxisSum(torch.autograd.Function):
    """The sum over the axis' ranks of each rank's partial
    (:func:`sum_over`: f32, rounded once), the gradient passed through:
    every rank's partial enters the sum once."""

    @staticmethod
    def forward(x, axis, kind):
        return sum_over(x, axis, kind=kind)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None, None

    @staticmethod
    def vmap(info, in_dims, x, axis, kind):
        if in_dims[0] is None:
            return AxisSum.apply(x, axis, kind), None
        return AxisSum.apply(x, axis, kind), in_dims[0]


def fsdp_gather(x: torch.Tensor, axis: MeshAxis, rows: int,
                dim: int = 0) -> torch.Tensor:
    """The whole dim ``dim`` (``rows`` long) of a weight of which this
    rank holds its :func:`fsdp_widths` piece: :class:`FsdpGather` (``x``
    itself on one rank)."""
    if axis.size == 1:
        return x
    return FsdpGather.apply(x, axis, rows, dim, FSDP_KINDS)


def model_gather(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """Every model rank's equal piece of ``x``'s last dim joined in rank
    order (the RG-LRU's gate input: each rank's gates read every
    channel), its gradient summed over the ranks and scattered back to
    the pieces: :class:`FsdpGather` over ``axis``, counted as
    ``model_gather`` and ``model_scatter`` (``x`` itself on one rank)."""
    if axis.size == 1:
        return x
    dim = x.dim() - 1
    return FsdpGather.apply(x, axis, x.shape[dim] * axis.size, dim,
                            MODEL_KINDS)


def gather_seq(x: torch.Tensor, axis: MeshAxis, n: int,
               dim: int = 1) -> torch.Tensor:
    """The whole sequence (``n`` positions along ``dim``) from every
    model rank's piece of it, pieces of ⌈n/M⌉ (:func:`fsdp_widths`: the
    last ones shorter, or empty where n < M), where the residual enters
    a column-parallel piece; its gradient, a partial on each rank, summed
    over the ranks and scattered back to the pieces: :class:`FsdpGather`
    counted as ``seq_gather`` and ``seq_scatter`` (``x`` itself on one
    rank)."""
    if axis.size == 1:
        return x
    return FsdpGather.apply(x, axis, n, dim, SEQ_KINDS)


def scatter_seq(x: torch.Tensor, axis: MeshAxis,
                dim: int = 1) -> torch.Tensor:
    """This rank's piece of the sequence (``dim``) of the sum of every
    model rank's partial ``x``, where a row-parallel output returns to the
    residual: the partials added in f32 in rank order and rounded once, as
    :func:`sum_over` adds them; its gradient all-gathered
    (:class:`FsdpScatter` counted as ``seq_scatter`` and ``seq_gather``;
    ``x`` itself on one rank)."""
    if axis.size == 1:
        return x
    return FsdpScatter.apply(x, axis, x.shape[dim], dim, SEQ_KINDS)


class SeqGatherPair(torch.autograd.Function):
    """The whole sequence gathered once for two readers (the MoE's input):
    a replicated one, the router, whose gradient is already whole on every
    model rank, so its share of the backward takes the rank's piece and
    sums nothing; and a column-parallel one, the experts, whose gradient
    is a partial, reduce-scattered as :func:`gather_seq`'s."""

    @staticmethod
    def forward(x, axis, n, dim):
        whole = _gather_piece(x, axis, n, dim, SEQ_KINDS[0])
        return whole, whole.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.axis, ctx.n, ctx.dim = inputs

    @staticmethod
    def backward(ctx, g_whole, g_part):
        axis, n, dim = ctx.axis, ctx.n, ctx.dim
        widths = fsdp_widths(n, axis.size)
        mine = g_whole.narrow(dim, sum(widths[:axis.rank]), widths[axis.rank])
        return (FsdpScatter.apply(g_part, axis, n, dim, SEQ_KINDS) + mine,
                None, None, None)

    @staticmethod
    def vmap(info, in_dims, x, axis, n, dim):
        if in_dims[0] is None:
            return SeqGatherPair.apply(x, axis, n, dim), (None, None)
        return SeqGatherPair.apply(_front(x, in_dims[0]), axis, n,
                                   dim + 1), (0, 0)


def gather_seq_pair(x: torch.Tensor, axis: MeshAxis, n: int,
                    dim: int = 1):
    """(whole for a replicated reader, whole for a column-parallel
    reader): :class:`SeqGatherPair` (``(x, x)`` on one rank)."""
    if axis.size == 1:
        return x, x
    return SeqGatherPair.apply(x, axis, n, dim)


def last_position(x: torch.Tensor, axis: MeshAxis, n: int,
                  dim: int = 1) -> torch.Tensor:
    """The sequence's last position (length 1 along ``dim``) on every
    model rank, from the rank whose piece holds it (the last one with a
    non-empty piece of :func:`fsdp_widths`): one broadcast (``x``'s last
    position itself on one rank).  No gradient: the prefill's
    ``last_only`` head."""
    if axis.size == 1:
        return x.narrow(dim, x.shape[dim] - 1, 1)
    widths = fsdp_widths(n, axis.size)
    src = max(r for r, w in enumerate(widths) if w)
    if axis.rank == src:
        row = x.narrow(dim, x.shape[dim] - 1, 1).contiguous()
    else:
        row = x.new_empty((*x.shape[:dim], 1, *x.shape[dim + 1:]))
    return broadcast_from(row, src, axis)


def axis_copy(x: torch.Tensor, axis: MeshAxis,
              kind: str = "model_sum") -> torch.Tensor:
    """:class:`AxisCopy` (``x`` itself on one rank)."""
    return x if axis.size == 1 else AxisCopy.apply(x, axis, kind)


def axis_sum(x: torch.Tensor, axis: MeshAxis,
             kind: str = "model_sum") -> torch.Tensor:
    """:class:`AxisSum` (``x`` itself on one rank)."""
    return x if axis.size == 1 else AxisSum.apply(x, axis, kind)


class AxisMax(torch.autograd.Function):
    """The elementwise max over the axis' ranks (:func:`all_reduce_max`),
    without a gradient."""

    @staticmethod
    def forward(x, axis):
        return all_reduce_max(x, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, g):
        return None, None

    @staticmethod
    def vmap(info, in_dims, x, axis):
        return AxisMax.apply(x, axis), in_dims[0]


def axis_max(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """:class:`AxisMax` (``x`` itself on one rank)."""
    return x if axis.size == 1 else AxisMax.apply(x, axis)
