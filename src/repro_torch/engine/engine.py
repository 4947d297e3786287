"""Chunked execution engine (port of ``repro.engine.engine``).

A chunk runs R rounds back to back: for each round the sampler draws the
round's batch and noise, ``round_step`` advances the state, and on log
rounds the metrics are computed into a device buffer that is read back
once per chunk, so the host waits on the device once per chunk, not once
per round.  ``state.round`` (a host int) is the single source of truth:
the sampler, the lr schedule and the log grid are functions of it, so a
run resumed from a checkpoint continues the identical trajectory.

On a CUDA device a chunk is captured as one CUDA graph and replayed: the
counterpart of the reference's jitted ``lax.scan`` chunk, one dispatch per
chunk in place of the rounds' hundreds of kernel launches.

* The first call at each key warms the chunk up on the static buffers,
  which it only reads (kernels built, cuBLAS handles made; no launch
  count moves) — the runner's first key only —, captures it on a side
  stream and replays it.  The seconds of warm-up
  and capture go to ``stats["capture_s"]``, the counterpart of the
  reference's ``compile_s``.
* A graph bakes in every host value the chunk reads, so its key holds them:
  the chunk length and which of its rounds log, the state's host fields,
  the sampler's host values and the addresses of the tensors it returns
  unchanged every round (the batch, a static W), and the chunk's first
  round where the round step reads it (``round_step.uses_round``: an lr
  schedule, a topology cycle; such chunks are captured once per start).
  A call whose values differ captures again (``stats["captures"]``).
* The draws (noise, a per-round W or mask) re-seed a generator every
  round, which a graph cannot replay.  They are made before each replay,
  from the same seeds, into the graph's static per-round buffers, so the
  captured chunk runs the eager chunk's draws bit for bit; their host
  seconds go to ``stats["draw_s"]``.
* The kernel wrappers count launches when Python calls them, which a
  replay does not: a replay adds the launches its capture recorded
  (``kernels.ops.uncounted`` / ``add_launch_counts``).
* The state goes into static input buffers and comes out of static output
  buffers; the caller gets copies, so a returned state never aliases
  memory that a later replay writes.  A runner's graphs share those
  buffers and one memory pool, since one replays at a time: a chunk of
  another length or log pattern adds no second copy of the state.
* ``donate=True`` (the language model's trainer, whose state is GBs): the
  state handed to the runner becomes its static input buffers, each
  chunk writes the new state back into them as its last step, and the
  caller gets views of them, so the state lives on the card once beside
  the pool.  A donated state is the runner's: a later chunk overwrites
  it.  A leaf whose new value has another layout, or overlaps another
  leaf, keeps an output buffer and a copy of its own.

A capture that fails raises: there is no fallback to eager chunks.  On the
CPU, where no graph exists, chunks run eagerly; ``capture=False`` runs
them eagerly on the card too, the reference the captured chunks are held
to (``chip_smoke.py``'s ``graph`` phase).
"""
from __future__ import annotations

import dataclasses
import gc
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import tree as tree_lib
from repro_torch.kernels import _build
from repro_torch.kernels import ops as kernel_ops

# (round_idx) -> (batches, noise) or (batches, noise, extras): a sampler may
# return a third element, a tuple of per-round operands (a sampled mixing
# matrix W, a participation mask; see sampler.with_topology) that the chunk
# splats into round_step(state, batches, noise, *extras).
Sampler = Callable[[int], Tuple[Any, ...]]
MetricsFn = Callable[[Any, Any], Dict[str, torch.Tensor]]
Hook = Callable[[Any, List[dict], int], None]  # (state, records, prev_round)


def split_sampled(sampled) -> Tuple[Any, Any, Tuple[Any, ...]]:
    """One sampler return -> ``(batches, noise, extras)`` per the Sampler
    protocol above."""
    batches, noise = sampled[0], sampled[1]
    extras = tuple(sampled[2]) if len(sampled) > 2 else ()
    return batches, noise, extras


def _rounds(round_step, metrics_fn, state, draw, logs, length: int):
    """``length`` rounds from ``state``; ``draw(i)`` is round i's sampler
    return and ``logs[i]`` whether it logs.  Returns ``(state, names,
    shapes, rows)``: rows is a (logged rounds, width) f32 tensor, or None,
    each row the metrics in ``names`` order, flattened and concatenated
    (``shapes``: each metric's shape; all scalars give one column a
    metric)."""
    names: List[str] = []
    shapes: List[tuple] = []
    rows = []
    for i in range(length):
        batches, noise, extras = split_sampled(draw(i))
        state = round_step(state, batches, noise, *extras)
        if logs and logs[i]:
            row = metrics_fn(state, batches)
            if not names:
                names = list(row)
                shapes = [tuple(row[k].shape) for k in names]
            rows.append(torch.cat([row[k].to(torch.float32).reshape(-1)
                                   for k in names]))
    return state, names, shapes, torch.stack(rows) if rows else None


def _compact(x: torch.Tensor) -> torch.Tensor:
    """x without its broadcast dims (stride 0 over more than one entry)."""
    return x[tuple(slice(0, 1) if st == 0 and size > 1 else slice(None)
                   for size, st in zip(x.shape, x.stride()))]


def _alloc(x: torch.Tensor) -> torch.Tensor:
    """An uninitialized buffer laid out as ``_compact(x)``; ``buf.expand(
    x.shape)`` then has x's shape and strides."""
    c = _compact(x)
    return torch.empty_strided(c.shape, c.stride(), dtype=c.dtype,
                               device=c.device)


def _meta(x: torch.Tensor) -> tuple:
    return (tuple(x.shape), x.stride(), x.dtype, x.device)


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


class CudaGraph:
    """One CUDA graph: warm-up on a side stream, capture on the side stream
    ``torch.cuda.graph`` sets up, replay on the current stream.  ``pool``:
    the memory pool to capture into, None for a new one; after the capture,
    this graph's, which a later capture may share."""

    def __init__(self) -> None:
        self._graph = torch.cuda.CUDAGraph()
        self.pool = None

    def warm_up(self, fn):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = fn()
        torch.cuda.current_stream().wait_stream(side)
        return out

    def capture(self, fn) -> None:
        # a graph freed while a stream captures invalidates the capture:
        # hold the cyclic collector off until it ends
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self._graph, pool=self.pool):
                fn()
        finally:
            if enabled:
                gc.enable()
        self.pool = self._graph.pool()

    def replay(self) -> None:
        self._graph.replay()

    @staticmethod
    def write(dst: torch.Tensor, src: torch.Tensor) -> None:
        """A chunk's store into its output buffers: recorded by the
        capture, run by each replay."""
        dst.copy_(src)


def _span(x: torch.Tensor) -> Tuple[int, int]:
    """The device bytes [start, end) that x's elements lie in."""
    if x.numel() == 0:
        return (x.data_ptr(), x.data_ptr())
    extent = 1 + sum((size - 1) * st for size, st in zip(x.shape, x.stride()))
    return (x.data_ptr(), x.data_ptr() + extent * x.element_size())


def _overlap(a: Tuple[int, int], b: Tuple[int, int]) -> bool:
    return a[0] < b[1] and b[0] < a[1]


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """a and b are the same elements (same address and layout)."""
    return a.data_ptr() == b.data_ptr() and _meta(a) == _meta(b)


class _ChunkGraph:
    """One captured chunk: its key's host values, its static buffers and
    the launches its capture recorded."""

    def __init__(self, runner, st_def, st_leaves, draw_def, draw_leaves,
                 fixed, r0: int, logs, length: int) -> None:
        # the runner's parts, not the runner, which holds this graph
        self.round_step, self.metrics_fn = runner.round_step, runner.metrics_fn
        self.graph_type = runner.graph_type
        self.logs, self.length = logs, length
        self.r0 = r0
        self.start = r0 if runner.uses_round else None
        self.st_def = st_def
        self.st_host = tuple(None if _is_tensor(x) else x for x in st_leaves)
        self.st_meta = tuple(_meta(x) for x in st_leaves if _is_tensor(x))
        self.draw_def = draw_def
        # per leaf position of a round's draws: the tensor every round
        # returns unchanged (baked in by address), or None (a per-round
        # tensor, copied into a static buffer, or a host value)
        self.fixed = fixed
        self.tensor_pos = [j for j, x in enumerate(draw_leaves[0])
                           if _is_tensor(x) and fixed[j] is None]
        self.draw_host = tuple(
            None if _is_tensor(x) else tuple(r[j] for r in draw_leaves)
            for j, x in enumerate(draw_leaves[0]))
        self.draw_meta = tuple(_meta(draw_leaves[0][j])
                               for j in self.tensor_pos)
        self.donate = runner.donate
        self.st_bufs = [(runner.buffer(("state", i), x, adopt=self.donate),
                         x.shape)
                        for i, x in enumerate(st_leaves) if _is_tensor(x)]
        self.draw_bufs = [[(_alloc(r[j]), r[j].shape)
                           for j in self.tensor_pos] for r in draw_leaves]
        self.graph = None

    def matches(self, st_def, st_leaves, draw_def, draw_leaves,
                r0: int) -> bool:
        if (st_def != self.st_def or draw_def != self.draw_def
                or (self.start is not None and r0 != self.start)
                or tuple(None if _is_tensor(x) else x for x in st_leaves)
                != self.st_host
                or tuple(_meta(x) for x in st_leaves if _is_tensor(x))
                != self.st_meta):
            return False
        for j, host in enumerate(self.draw_host):
            if host is not None and tuple(r[j] for r in draw_leaves) != host:
                return False
        for j, t in enumerate(self.fixed):
            if t is not None and any(
                    not _is_tensor(r[j]) or r[j].data_ptr() != t.data_ptr()
                    or _meta(r[j]) != _meta(t) for r in draw_leaves):
                return False
        return all(tuple(_meta(r[j]) for j in self.tensor_pos)
                   == self.draw_meta for r in draw_leaves)

    def load(self, st_leaves, draw_leaves) -> None:
        """Copies the state and the per-round draws into the buffers."""
        for (buf, _), x in zip(self.st_bufs,
                               (x for x in st_leaves if _is_tensor(x))):
            if not _same(buf, _compact(x)):   # a donated state lies there
                buf.copy_(_compact(x))
        for bufs, r in zip(self.draw_bufs, draw_leaves):
            for (buf, _), j in zip(bufs, self.tensor_pos):
                buf.copy_(_compact(r[j]))

    def _body(self):
        """The chunk over the static buffers: (output tensors, how to
        rebuild the state and the rows from them)."""
        bufs = iter(self.st_bufs)
        leaves = []
        for host in self.st_host:
            if host is None:
                buf, shape = next(bufs)
                leaves.append(buf.expand(shape))
            else:
                leaves.append(host)
        state = dataclasses.replace(
            tree_lib.unflatten(self.st_def, leaves), round=self.r0)

        def draw(i):
            bufs = iter(self.draw_bufs[i])
            out = []
            for j, t in enumerate(self.fixed):
                if t is not None:
                    out.append(t)
                elif self.draw_host[j] is not None:
                    out.append(self.draw_host[j][i])
                else:
                    buf, shape = next(bufs)
                    out.append(buf.expand(shape))
            return tree_lib.unflatten(self.draw_def, out)

        state, names, shapes, rows = _rounds(
            self.round_step, self.metrics_fn, state, draw, self.logs,
            self.length)
        out, out_def = tree_lib.flatten(dataclasses.replace(state, round=0))
        tensors = [x for x in out if _is_tensor(x)]
        if rows is not None:
            tensors.append(rows)
        info = (out_def, tuple(None if _is_tensor(x) else x for x in out),
                tuple(names), tuple(shapes))
        return tensors, info

    def _set_out_bufs(self, outs, info, buffer) -> None:
        """``out_bufs``: per output tensor, (buffer, shape); ``in_place``:
        whether that buffer is the input's.  A donated chunk's state leaf
        goes back into its input buffer where its layout is the input's
        and it overlaps no other input leaf; every other output gets a
        buffer of its own."""
        spans = [_span(b) for b, _ in self.st_bufs]
        same_tree = self.donate and info[0] == self.st_def and \
            info[1] == self.st_host
        bufs = []
        for i, o in enumerate(outs):
            if same_tree and i < len(self.st_bufs):
                buf, shape = self.st_bufs[i]
                c = _compact(o)
                if (shape == o.shape and _meta(c) == _meta(buf)
                        and not any(_overlap(_span(c), sp)
                                    for j, sp in enumerate(spans)
                                    if j != i)):
                    bufs.append((buf, shape, True))
                    continue
            bufs.append((buffer(("out", i), o), o.shape, False))
        self.out_bufs = [(buf, shape) for buf, shape, _ in bufs]
        self.in_place = [own for _, _, own in bufs]

    def capture(self, pool, buffer) -> None:
        """Warm-up, then capture into ``pool``; the buffers hold this
        chunk's inputs; ``buffer(key, like)`` gives the output buffers.
        With ``pool`` None (a runner's first graph) the chunk is warmed up
        first, on a side stream, outside any pool; a later graph of the
        runner captures into the first one's pool without a warm-up (the
        first did the lazy set-up), so that capturing it holds no eager
        working set beside the pool."""
        graph = self.graph_type()
        graph.pool = pool
        self.info = self.out_bufs = None
        if pool is None:
            with kernel_ops.uncounted():
                outs, self.info = graph.warm_up(self._body)
            self._set_out_bufs(outs, self.info, buffer)
            del outs

        def fill():
            outs, info = self._body()
            if self.info is None:
                self.info = info
                self._set_out_bufs(outs, info, buffer)
            if info != self.info:
                raise RuntimeError("the chunk's capture and warm-up built "
                                   "different outputs")
            # the stores into the state's own buffers last: an output kept
            # apart may still read them
            for last in (False, True):
                for (buf, _), own, o in zip(self.out_bufs, self.in_place,
                                            outs):
                    if own == last:
                        graph.write(buf, _compact(o))

        with kernel_ops.uncounted() as self.launched:
            graph.capture(fill)
        self.graph = graph

    def replay(self, r0: int):
        """Replays the graph; returns (state, names, shapes, rows) as
        copies, a donated state's leaves as views of their buffers."""
        self.graph.replay()
        kernel_ops.add_launch_counts(self.launched)
        outs = iter(buf.expand(shape) if own
                    else _alloc(buf).copy_(buf).expand(shape)
                    for (buf, shape), own in zip(self.out_bufs,
                                                 self.in_place))
        out_def, out_host, names, shapes = self.info
        leaves = [next(outs) if host is None else host for host in out_host]
        state = dataclasses.replace(tree_lib.unflatten(out_def, leaves),
                                    round=r0 + self.length)
        return state, list(names), list(shapes), next(outs, None)


class ChunkRunner:
    """Runs chunks of ``round_step``: ``runner(state, final_round,
    sampler=, length=) -> (state, buffer)``, on a CUDA device as CUDA
    graphs (module docstring).

    ``capture`` None captures where the state lies on a CUDA device and
    runs eagerly on the CPU; False always runs eagerly; True always
    captures (on the CPU that raises).  ``donate``: the captured chunks
    take the state over (module docstring).  ``stats``: ``capture_s``
    (warm-up and capture seconds, kernel builds excluded), ``captures``,
    ``replays`` and ``draw_s`` (host seconds of the draws made before the
    replays and of copying them in).  ``state`` is a dataclass with a host
    int ``round``; its other host fields are baked into the graphs.
    """

    graph_type = CudaGraph

    def __init__(self, round_step, metrics_fn: Optional[MetricsFn] = None,
                 *, log_every: int = 1, capture: Optional[bool] = None,
                 donate: bool = False):
        self.round_step = round_step
        self.metrics_fn = metrics_fn
        self.log_every = max(int(log_every), 1)
        self.capture = capture
        self.donate = donate
        self.uses_round = getattr(round_step, "uses_round", True)
        self.stats = {"capture_s": 0.0, "captures": 0, "replays": 0,
                      "draw_s": 0.0}
        self._graphs: Dict[tuple, _ChunkGraph] = {}
        # the runner's graphs share one memory pool and their static state
        # and output buffers (by position and layout): only one graph
        # replays at a time, its inputs are copied in before and its
        # outputs copied out after, so a language model's chunks of other
        # lengths or log patterns cost no second copy of the state
        self._pool = None
        self._buffers: Dict[tuple, torch.Tensor] = {}

    def buffer(self, key, like: torch.Tensor, *,
               adopt: bool = False) -> torch.Tensor:
        """The shared static buffer at ``key`` laid out as ``like``
        (``_alloc``); with ``adopt``, a new one is ``like``'s own memory
        where that overlaps no other buffer."""
        c = _compact(like)
        full = (key, _meta(c))
        buf = self._buffers.get(full)
        if buf is None:
            if adopt and not c.requires_grad and not any(
                    _overlap(_span(c), _span(b))
                    for b in self._buffers.values()):
                buf = c
            else:
                buf = _alloc(like)
            self._buffers[full] = buf
        return buf

    def _logs(self, r0: int, length: int, final_round: int) -> tuple:
        if self.metrics_fn is None:
            return ()
        return tuple(r % self.log_every == 0 or r == final_round
                     for r in range(r0, r0 + length))

    def __call__(self, state, final_round: int, *, sampler: Sampler,
                 length: int):
        r0 = state.round
        logs = self._logs(r0, length, final_round)
        capture = self.capture
        if capture is not False:
            leaves, st_def = tree_lib.flatten(
                dataclasses.replace(state, round=0))
            if capture is None:
                capture = any(_is_tensor(x) and x.is_cuda for x in leaves)
        if capture:
            state, names, shapes, rows = self._replay(
                st_def, leaves, r0, final_round, sampler, length, logs)
        else:
            state, names, shapes, rows = _rounds(
                self.round_step, self.metrics_fn, state,
                lambda i: sampler(r0 + i), logs, length)
        if self.metrics_fn is None:
            return state, None
        return state, (names, [r0 + i for i, on in enumerate(logs) if on],
                       rows, shapes)

    def _replay(self, st_def, st_leaves, r0, final_round, sampler, length,
                logs):
        t0 = time.perf_counter()
        drawn = [tree_lib.flatten(sampler(r0 + i)) for i in range(length)]
        draw_def = drawn[0][1]
        if any(d != draw_def for _, d in drawn):
            raise ValueError("the sampler's returns differ in structure from "
                             "round to round")
        draw_leaves = [leaves for leaves, _ in drawn]
        key = (length, logs)
        graph = self._graphs.get(key)
        if graph is None or not graph.matches(st_def, st_leaves, draw_def,
                                              draw_leaves, r0):
            self.stats["draw_s"] += time.perf_counter() - t0
            t_cap = time.perf_counter()
            built0 = _build.stats["build_s"]
            graph = _ChunkGraph(
                self, st_def, st_leaves, draw_def, draw_leaves,
                self._fixed(draw_def, draw_leaves, r0, final_round, sampler,
                            length), r0, logs, length)
            graph.load(st_leaves, draw_leaves)
            graph.capture(self._pool, self.buffer)
            self._pool = getattr(graph.graph, "pool", None)
            self._graphs[key] = graph
            self.stats["captures"] += 1
            self.stats["capture_s"] += (time.perf_counter() - t_cap
                                        - (_build.stats["build_s"] - built0))
        else:
            graph.load(st_leaves, draw_leaves)
            self.stats["draw_s"] += time.perf_counter() - t0
        self.stats["replays"] += 1
        return graph.replay(r0)

    @staticmethod
    def _fixed(draw_def, draw_leaves, r0, final_round, sampler,
               length) -> list:
        """Per draw leaf position, the tensor every round returns unchanged
        (baked into the graph by address), or None.  A round outside the
        chunk (when the run has one) keeps a one-round chunk from baking in
        its noise."""
        probe = (r0 + length if r0 + length <= final_round
                 else r0 - 1 if r0 >= 1 else None)
        rounds = list(draw_leaves)
        if probe is not None:
            probe_leaves, probe_def = tree_lib.flatten(sampler(probe))
            if probe_def == draw_def:
                rounds.append(probe_leaves)
        fixed = []
        for j, x in enumerate(draw_leaves[0]):
            if len({_is_tensor(r[j]) for r in draw_leaves}) != 1:
                raise ValueError(f"draw leaf {j} is a tensor in some rounds "
                                 "and a host value in others")
            fixed.append(x if _is_tensor(x) and all(r[j] is x for r in rounds)
                         else None)
        return fixed


def chunk_program(round_step, sampler: Sampler,
                  metrics_fn: Optional[MetricsFn] = None, *,
                  log_every: int = 1, length: int):
    """The eager ``chunk_step(state, final_round) -> (state, buffer)``.

    ``buffer`` is None without ``metrics_fn``, else ``(names, rounds,
    rows, shapes)``: the logged round indices (host ints), an on-device
    ``(len(rounds), width)`` f32 tensor whose rows hold the metrics in
    ``names`` order, each flattened (``(len(rounds), len(names))`` when all
    are scalars), and each metric's shape.  A round logs when it hits the
    ``log_every`` grid or equals ``final_round``.
    """
    runner = ChunkRunner(round_step, metrics_fn, log_every=log_every,
                         capture=False)
    return lambda state, final_round: runner(state, final_round,
                                             sampler=sampler, length=length)


def make_chunk_builder(round_step, sampler: Sampler,
                       metrics_fn: Optional[MetricsFn] = None, *,
                       log_every: int = 1, capture: Optional[bool] = None,
                       donate: bool = False):
    """Returns ``build(length) -> chunk_step(state, final_round)``: the
    chunks of one :class:`ChunkRunner`, which keeps one CUDA graph per
    chunk length and log pattern (and per whatever else a graph bakes
    in).  ``build.stats`` is the runner's."""
    runner = ChunkRunner(round_step, metrics_fn, log_every=log_every,
                         capture=capture, donate=donate)

    def build(length: int):
        return lambda state, final_round: runner(
            state, final_round, sampler=sampler, length=length)

    build.stats = runner.stats
    return build


def row_to_record(row: Dict[str, Any], round_idx: int) -> dict:
    """One metrics row (host values) -> a plain-python history record:
    scalars become floats, vectors become lists."""
    rec: dict = {"round": int(round_idx)}
    for name, v in row.items():
        v = np.asarray(v)
        rec[name] = float(v) if v.ndim == 0 else v.tolist()
    return rec


def records_from_buffer(buf) -> List[dict]:
    """Metrics buffer ``(names, rounds, rows, shapes)`` -> plain-python
    history records, one device-to-host transfer per chunk."""
    if buf is None:
        return []
    names, rounds, rows, shapes = buf
    if not rounds:
        return []
    sizes = [math.prod(shape) for shape in shapes]
    host = rows.cpu().numpy()
    records = []
    for r, vals in zip(rounds, host):
        row, at = {}, 0
        for name, shape, size in zip(names, shapes, sizes):
            row[name] = vals[at:at + size].reshape(shape)
            at += size
        records.append(row_to_record(row, r))
    return records


def run(state, build_chunk: Callable[[int], Any], *, total_rounds: int,
        chunk_rounds: int, hooks: Sequence[Hook] = (),
        stop_fn: Optional[Callable[[List[dict]], bool]] = None,
        wall_clock: bool = True, boundary_every: Optional[int] = None,
        telemetry=None):
    """Drives chunks from ``state.round`` up to ``total_rounds``.

    Hooks run at every chunk boundary as ``hook(state, records,
    prev_round)``; ``boundary_every=N`` splits chunks so a boundary lands
    on every multiple of N (pass the checkpoint cadence so
    ``checkpoint_hook`` fires at the exact rounds); ``stop_fn(records) ->
    bool`` ends the run early at a boundary.  Returns ``(state,
    history)``.  Unless disabled, each record carries ``wall_s``
    (elapsed), ``build_s`` (kernel builds in this run so far),
    ``capture_s`` (CUDA graph warm-ups and captures in this run so far,
    from ``build_chunk.stats``) and ``run_s = wall_s − build_s −
    capture_s``.

    ``telemetry`` (``repro_torch.obs.Telemetry`` or anything with its
    ``span``/``span_event``) wraps each chunk's dispatch and read-back in
    spans and emits a ``capture`` span for a chunk that captured a graph;
    None touches no telemetry object.
    """
    chunk_rounds = max(int(chunk_rounds), 1)
    stats = getattr(build_chunk, "stats", {"capture_s": 0.0})
    history: List[dict] = []
    final_round = total_rounds - 1
    t0 = time.perf_counter()
    build_before = _build.stats["build_s"]
    capture_before = stats["capture_s"]
    r = state.round
    while r < total_rounds:
        length = min(chunk_rounds, total_rounds - r)
        if boundary_every:
            length = min(length, (r // boundary_every + 1) * boundary_every
                         - r)
        chunk = build_chunk(length)
        if telemetry is None:
            state, buf = chunk(state, final_round)
            records = records_from_buffer(buf)
        else:
            capture_prev = stats["capture_s"]
            with telemetry.span("dispatch", round=r, length=length):
                state, buf = chunk(state, final_round)
            captured = stats["capture_s"] - capture_prev
            if captured > 0:
                telemetry.span_event("capture", captured, round=r,
                                     length=length)
            with telemetry.span("readback", round=r):
                records = records_from_buffer(buf)
        if wall_clock:
            wall = time.perf_counter() - t0
            built = _build.stats["build_s"] - build_before
            captured = stats["capture_s"] - capture_before
            for rec in records:
                rec["wall_s"] = wall
                rec["build_s"] = built
                rec["capture_s"] = captured
                rec["run_s"] = max(wall - built - captured, 0.0)
        history.extend(records)
        for hook in hooks:
            hook(state, records, r)
        r += length
        if stop_fn is not None and stop_fn(records):
            break
    return state, history


def telemetry_hook(telemetry, *, ledger=None, health_fn=None,
                   health_every: int = 1) -> Hook:
    """Chunk-boundary telemetry, the sibling of :func:`checkpoint_hook`.

    Per boundary, emits into ``telemetry``: one ``metrics`` event per
    history record of the chunk; a ``ledger`` event when a
    ``repro_torch.obs.CommLedger`` is given (its rounds are added here,
    from ``state.round``); and the ``health_fn(state) -> {name: float}``
    gauges every ``health_every``-th boundary.  Only ``health_fn`` touches
    the device; the hook never alters the trajectory.
    """
    boundaries = {"n": 0}

    def hook(state, records, prev_round):
        for rec in records:
            telemetry.metrics(rec)
        if ledger is not None:
            rounds = int(state.round) - int(prev_round)
            if rounds > 0:
                ledger.add_rounds(rounds)
                telemetry.emit(ledger.event(rounds=rounds,
                                            round=int(state.round)))
        if health_fn is not None:
            b = boundaries["n"]
            boundaries["n"] = b + 1
            if b % max(int(health_every), 1) == 0:
                for name, value in health_fn(state).items():
                    telemetry.gauge(name, value, round=int(state.round))

    return hook


def checkpoint_hook(directory: str, every: int,
                    metadata: Optional[dict] = None,
                    verbose: bool = False, save=None) -> Hook:
    """Chunk-boundary checkpointing: saves ``round_%06d.npz`` when the
    boundary crosses a multiple of ``every`` rounds (``state.round`` in the
    name and metadata keeps the resume point exact); pass
    ``boundary_every=every`` to :func:`run` to land on the exact
    multiples.  ``save(path, state, metadata=)`` writes (default
    ``checkpoint.save``; the decentralized mesh's gathers first)."""
    from repro_torch.checkpoint import checkpoint as ckpt_lib

    save = save or ckpt_lib.save

    def hook(state, records, prev_round):
        r = int(state.round)
        if not every or r // every <= prev_round // every:
            return
        path = os.path.join(directory, f"round_{r:06d}.npz")
        meta = dict(metadata or {})
        meta["round"] = r
        save(path, state, metadata=meta)
        if verbose:
            print(f"[engine] checkpoint -> {path}", flush=True)

    return hook
