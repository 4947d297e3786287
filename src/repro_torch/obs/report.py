"""Fold a telemetry JSONL into a run summary (a copy of
``repro.obs.report``: pure Python).

  PYTHONPATH=src python -m repro_torch.obs.report /tmp/run.jsonl

Renders the time breakdown (per-span totals), the communication ledger
(bytes/round, GB total, collectives), throughput (rounds/s from the metric
stamps), and the convergence tail (the last logged metrics row).  Exits
nonzero on a missing, empty, or malformed artifact.  The port's engine
stamps ``build_s`` and ``capture_s`` (kernel builds, CUDA graph captures)
where the reference stamps ``compile_s``: they are stamps too, and
``capture_s`` is reported beside ``compile_s``.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

# metric-record bookkeeping stamps that are not convergence metrics
_STAMPS = ("v", "type", "t", "round", "wall_s", "compile_s", "run_s",
           "build_s", "capture_s")


class ReportError(Exception):
    """A telemetry artifact that cannot be summarized."""


def load(path: str) -> List[dict]:
    """Parse a JSONL telemetry file; raise :class:`ReportError` on a
    missing/empty file or any malformed line (line number in the message)."""
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError as e:
        raise ReportError(f"cannot read {path}: {e}") from e
    events = []
    for i, line in enumerate(lines, 1):
        if not line.strip():
            continue
        try:
            ev = json.loads(line)
        except ValueError as e:
            raise ReportError(f"{path}:{i}: malformed JSONL line: {e}") from e
        if not isinstance(ev, dict) or "type" not in ev:
            raise ReportError(f"{path}:{i}: event is not a typed object")
        events.append(ev)
    if not events:
        raise ReportError(f"{path}: no telemetry events")
    return events


def summarize(events: List[dict]) -> dict:
    """Fold events into the summary dict :func:`render` prints.

    Every event type contributes: spans into the time breakdown, ledger
    events into the communication block, metrics into throughput + the
    convergence tail, counters/gauges into their last-value tables, meta
    into the run header.
    """
    spans: Dict[str, dict] = {}
    counters: Dict[str, dict] = {}
    gauges: Dict[str, float] = {}
    metrics: List[dict] = []
    ledger: Optional[dict] = None
    meta: dict = {}
    for ev in events:
        etype = ev.get("type")
        if etype == "span":
            s = spans.setdefault(ev.get("name", "?"),
                                 {"count": 0, "total_s": 0.0})
            s["count"] += 1
            s["total_s"] += float(ev.get("dur_s", 0.0))
        elif etype == "counter":
            c = counters.setdefault(ev.get("name", "?"),
                                    {"count": 0, "sum": 0.0})
            c["count"] += 1
            c["sum"] += float(ev.get("value", 0.0))
        elif etype == "gauge":
            gauges[ev.get("name", "?")] = float(ev.get("value", 0.0))
        elif etype == "metrics":
            metrics.append(ev)
        elif etype == "ledger":
            ledger = ev  # running totals: the last event wins
        elif etype == "meta":
            meta.update({k: v for k, v in ev.items()
                         if k not in ("v", "type", "t")})
    out: dict = {"num_events": len(events), "spans": spans,
                 "counters": counters, "gauges": gauges, "meta": meta}
    cache = {name[len("compile_cache."):]: c["sum"]
             for name, c in counters.items()
             if name.startswith("compile_cache.")}
    if cache:
        # the CompileCache emits integral counters; keep them integral
        out["compile_cache"] = {k: int(v) if float(v).is_integer() else v
                                for k, v in cache.items()}
    if metrics:
        last = metrics[-1]
        rounds = int(last.get("round", len(metrics) - 1)) + 1
        out["rounds"] = rounds
        out["num_metric_rows"] = len(metrics)
        run_s = last.get("run_s", last.get("wall_s"))
        if run_s:
            out["run_s"] = float(run_s)
            out["rounds_per_s"] = round(rounds / float(run_s), 3)
        for stamp in ("compile_s", "capture_s"):
            if stamp in last:
                out[stamp] = float(last[stamp])
        out["tail"] = {k: v for k, v in last.items() if k not in _STAMPS}
    if ledger is not None:
        bytes_total = int(ledger.get("bytes_total", 0))
        out["ledger"] = {
            "mixing_impl": ledger.get("mixing_impl"),
            "bytes_per_round": int(ledger.get("bytes_per_round", 0)),
            "collectives_per_round": int(
                ledger.get("collectives_per_round", 0)),
            "rounds": int(ledger.get("rounds_total", 0)),
            "bytes_total": bytes_total,
            "gb_total": round(bytes_total / 1e9, 6),
        }
    return out


def _fmt_bytes(b: int) -> str:
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if b >= div:
            return f"{b / div:.3f} {unit}"
    return f"{b} B"


def render(summary: dict) -> str:
    """The human-readable summary table."""
    lines = []
    meta = summary.get("meta", {})
    if meta:
        head = " ".join(f"{k}={v}" for k, v in sorted(meta.items())
                        if not isinstance(v, (dict, list)))
        lines.append(f"run: {head}")
    lines.append(f"events: {summary['num_events']}")
    if summary.get("spans"):
        lines.append("time breakdown:")
        width = max(len(n) for n in summary["spans"])
        for name, s in sorted(summary["spans"].items(),
                              key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"  {name:<{width}}  {s['total_s']:9.3f}s"
                         f"  x{s['count']}")
    if "rounds" in summary:
        thr = (f"  ({summary['rounds_per_s']} rounds/s over "
               f"{summary['run_s']:.3f}s run)"
               if "rounds_per_s" in summary else "")
        lines.append(f"rounds: {summary['rounds']} "
                     f"({summary['num_metric_rows']} logged){thr}")
    led = summary.get("ledger")
    if led:
        lines.append(
            f"communication [{led['mixing_impl']}]: "
            f"{_fmt_bytes(led['bytes_per_round'])}/round, "
            f"{led['collectives_per_round']} collectives/round, "
            f"{_fmt_bytes(led['bytes_total'])} total over "
            f"{led['rounds']} rounds")
    cc = summary.get("compile_cache")
    if cc:
        parts = [f"{k}={cc[k]}" for k in
                 ("hits", "memo_hits", "misses", "puts", "errors")
                 if k in cc]
        for k in ("bytes_read", "bytes_written"):
            if k in cc:
                parts.append(f"{k}={_fmt_bytes(int(cc[k]))}")
        lines.append("compile cache: " + ", ".join(parts))
    if summary.get("gauges"):
        lines.append("health (last sample):")
        for name, v in sorted(summary["gauges"].items()):
            lines.append(f"  {name} = {v:.6g}")
    if summary.get("tail"):
        tail = "  ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in sorted(summary["tail"].items())
            if not isinstance(v, (list, dict)))
        lines.append(f"convergence tail: {tail}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.report",
        description="Summarize a telemetry JSONL artifact")
    ap.add_argument("path", help="telemetry JSONL file (--telemetry-out)")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as JSON instead of a table")
    args = ap.parse_args(argv)
    try:
        summary = summarize(load(args.path))
    except ReportError as e:
        print(f"repro_torch.obs.report: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(summary, indent=1, default=str))
    else:
        print(render(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
