"""Telemetry events: span timers, counters/gauges, and pluggable sinks
(a copy of ``repro.obs.events``, which is pure Python).

An *event* is one flat JSON-able dict.  Every event carries:

* ``v``    — the schema version (:data:`TELEMETRY_VERSION`);
* ``type`` — ``"span" | "counter" | "gauge" | "metrics" | "ledger" | "meta"``;
* ``t``    — wall-clock unix seconds at emit time.

Type-specific fields:

* ``span``    — ``name`` + ``dur_s`` (monotonic-clock duration; extra
  attributes ride alongside, e.g. ``round``/``length`` for a chunk
  dispatch).  Spans come from the ``with telemetry.span("dispatch"): …``
  context manager or, for durations measured elsewhere (the CUDA graph
  capture seconds the engine accumulates), from
  :meth:`Telemetry.span_event`.
* ``counter`` — ``name`` + ``value`` (a monotonically accumulated quantity:
  bytes communicated, rounds executed).
* ``gauge``   — ``name`` + ``value`` (a point-in-time sample: Σc drift,
  consensus error, EF residual norm).
* ``metrics`` — one engine history record verbatim (``round`` + the metric
  columns + the ``wall_s/build_s/capture_s/run_s`` stamps).
* ``ledger``  — a communication-ledger update (``repro.obs.ledger``).
* ``meta``    — one-shot run description (config summary, versions).

Sinks are deliberately dumb: ``emit(event)`` and optional ``close()``.
``Telemetry`` fans one event out to every sink.  A ``Telemetry`` with no
sinks is *disabled*: every method is a cheap no-op (``span`` returns a
shared null context manager without touching the clock), which is what the
zero-overhead guarantee rides on.
"""
from __future__ import annotations

import json
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

TELEMETRY_VERSION = 1

EVENT_TYPES = ("span", "counter", "gauge", "metrics", "ledger", "meta")


class MemorySink:
    """Collects events in a list — tests and in-process consumers."""

    def __init__(self) -> None:
        self.events: List[dict] = []

    def emit(self, event: dict) -> None:
        self.events.append(event)

    def close(self) -> None:
        pass


class JsonlSink:
    """One JSON object per line, append-mode, flushed per event.

    The file is opened lazily on the first event, so constructing a sink
    (e.g. from a CLI flag) touches nothing until telemetry actually flows.
    Values that are not JSON-native (numpy scalars, tensors) go through
    ``float()``/``str()`` fallbacks — the sink never raises mid-run.
    """

    def __init__(self, path: str) -> None:
        self.path = path
        self._fh = None

    @staticmethod
    def _default(obj: Any):
        try:
            return float(obj)
        except (TypeError, ValueError):
            return str(obj)

    def emit(self, event: dict) -> None:
        if self._fh is None:
            self._fh = open(self.path, "a")
        self._fh.write(json.dumps(event, default=self._default) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class StderrSink:
    """Human-readable console stream.

    ``formatter(event) -> str | None`` picks the representation; ``None``
    drops the event from the console (the JSONL sink still records it).
    The default formatter renders every event type one-per-line.
    """

    def __init__(self,
                 formatter: Optional[Callable[[dict], Optional[str]]] = None,
                 stream=None) -> None:
        self.formatter = formatter or self._default_format
        self.stream = stream

    @staticmethod
    def _default_format(event: dict) -> Optional[str]:
        etype = event.get("type", "?")
        skip = {"v", "type", "t", "name", "dur_s", "value"}
        attrs = " ".join(f"{k}={event[k]}" for k in event if k not in skip)
        if etype == "span":
            return (f"[obs] span {event.get('name')} "
                    f"{event.get('dur_s', 0):.3f}s {attrs}".rstrip())
        if etype in ("counter", "gauge"):
            return (f"[obs] {etype} {event.get('name')}="
                    f"{event.get('value')} {attrs}".rstrip())
        return f"[obs] {etype} {attrs}".rstrip()

    def emit(self, event: dict) -> None:
        line = self.formatter(event)
        if line is None:
            return
        print(line, file=self.stream or sys.stderr, flush=True)

    def close(self) -> None:
        pass


class _NullSpan:
    """Shared no-op context manager: the disabled-telemetry span."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    def __init__(self, telemetry: "Telemetry", name: str, attrs: dict) -> None:
        self._telemetry = telemetry
        self._name = name
        self._attrs = attrs
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        dur = time.monotonic() - self._t0
        self._telemetry.span_event(self._name, dur, **self._attrs)
        return False


class Telemetry:
    """Fans events out to sinks; a sink-less instance is a no-op."""

    def __init__(self, sinks: Sequence[Any] = ()) -> None:
        self.sinks = list(sinks)

    @property
    def enabled(self) -> bool:
        return bool(self.sinks)

    def emit(self, event: Dict[str, Any]) -> None:
        if not self.sinks:
            return
        event = dict(event)
        event.setdefault("v", TELEMETRY_VERSION)
        event.setdefault("t", time.time())
        for sink in self.sinks:
            sink.emit(event)

    def span(self, name: str, **attrs):
        """``with telemetry.span("dispatch", round=r): …`` — emits a span
        event with the monotonic-clock duration on exit."""
        if not self.sinks:
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def span_event(self, name: str, dur_s: float, **attrs) -> None:
        """A span whose duration was measured elsewhere (e.g. the capture
        seconds ``engine.ChunkRunner`` accumulates)."""
        self.emit({"type": "span", "name": name,
                   "dur_s": round(float(dur_s), 6), **attrs})

    def counter(self, name: str, value, **attrs) -> None:
        self.emit({"type": "counter", "name": name, "value": value, **attrs})

    def gauge(self, name: str, value, **attrs) -> None:
        self.emit({"type": "gauge", "name": name, "value": float(value),
                   **attrs})

    def metrics(self, record: dict) -> None:
        """One engine history record as a ``metrics`` event, verbatim."""
        if not self.sinks:
            return
        self.emit({"type": "metrics", **record})

    def meta(self, name: str, **fields) -> None:
        self.emit({"type": "meta", "name": name,
                   "telemetry_version": TELEMETRY_VERSION, **fields})

    def close(self) -> None:
        for sink in self.sinks:
            close = getattr(sink, "close", None)
            if close is not None:
                close()


#: The shared disabled instance — pass where a telemetry object is required
#: but nothing should be recorded.
NULL = Telemetry(())
