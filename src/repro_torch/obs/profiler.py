"""Opt-in profiler capture and algorithm-health gauges (port of
``repro.obs.profiler``).

:class:`Profiler` wraps ``torch.profiler`` behind an N-round window:
``start()`` before ``engine.run`` opens the trace, and the profiler's
chunk-boundary hook closes it once the requested number of rounds has run
(0 = the whole run, closed by ``stop()`` / context exit).  The trace is
written under ``directory`` as a Chrome trace (``trace_<k>.json``, one per
window), which opens in Perfetto; on a CUDA device it records the card's
kernels too.

:func:`health_gauges` samples the quantities the theory says to watch,
on the host from the state at a chunk boundary, so they cost a handful of
small reductions only when telemetry is on (on the decentralized mesh,
from each rank's rows, all-reduced over the clients axis):

* ``corr_x_drift`` / ``corr_y_drift`` — ‖c̄‖ for both corrections (Lemma 8
  says exactly 0 for the tracking variants);
* ``consensus_x`` / ``consensus_y`` — the client-variance consensus errors;
* ``ef_x_norm`` / ``ef_y_norm`` — the error-feedback residual norms, only
  under ``gossip_compress`` (a growing residual means the quantizer is
  systematically starved).
"""
from __future__ import annotations

import os
from typing import Optional

import torch


def health_gauges(state, axis=None) -> dict:
    """Algorithm-health gauges from a ``KGTState`` (host floats).  On the
    decentralized mesh (``axis``, a ``dist.collectives.ClientsAxis``: the
    state holds this rank's clients' rows) each gauge is summed over the
    clients axis, so every rank gets the whole state's values."""
    from repro_torch.core import kgt_minimax as kgt
    from repro_torch.core import mixing as mixing_lib
    from repro_torch.dist import collectives

    with collectives.phase("telemetry"):
        out = {
            "corr_x_drift": float(kgt.correction_mean_norm(state.cx, axis)),
            "corr_y_drift": float(kgt.correction_mean_norm(state.cy, axis)),
            "consensus_x": float(mixing_lib.consensus_error(state.x, axis)),
            "consensus_y": float(mixing_lib.consensus_error(state.y, axis)),
        }
        for name in ("ef_x", "ef_y"):
            buf = getattr(state, name, None)
            if buf is not None:
                sq = torch.sum(torch.square(buf.to(torch.float32)))
                if axis is not None:
                    sq = collectives.all_reduce_sum(sq, axis)
                out[f"{name}_norm"] = float(torch.sqrt(sq))
    return out


class Profiler:
    """An N-round ``torch.profiler`` capture window.

    >>> prof = Profiler("/tmp/trace", num_rounds=8)
    >>> prof.start()                       # before engine.run
    >>> hooks.append(prof.hook)            # closes after 8 rounds
    >>> ...
    >>> prof.stop()                        # idempotent backstop

    ``num_rounds=0`` captures the whole run.  ``paths`` lists the traces
    written.  A failure to start or stop is printed and swallowed:
    profiling must never take a run down.
    """

    def __init__(self, directory: str, num_rounds: int = 0) -> None:
        self.directory = directory
        self.num_rounds = int(num_rounds)
        self.active = False
        self.paths: list = []
        self._prof = None
        self._stop_round: Optional[int] = None

    def start(self) -> None:
        if self.active:
            return
        try:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            self._stop_round = None
            self.active = True
        except Exception as e:  # noqa: BLE001 — never take the run down
            print(f"[obs] profiler start failed: {e!r}", flush=True)

    def stop(self) -> None:
        if not self.active:
            return
        self.active = False
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.stop()
            os.makedirs(self.directory, exist_ok=True)
            path = os.path.join(self.directory,
                                f"trace_{len(self.paths)}.json")
            self._prof.export_chrome_trace(path)
            self.paths.append(path)
            print(f"[obs] profiler trace -> {path}", flush=True)
        except Exception as e:  # noqa: BLE001
            print(f"[obs] profiler stop failed: {e!r}", flush=True)

    def hook(self, state, records, prev_round) -> None:
        """Engine chunk-boundary hook: close the window once ``num_rounds``
        rounds have run since capture started."""
        if not self.active or not self.num_rounds:
            return
        if self._stop_round is None:
            # first boundary after start(): the window began at prev_round
            self._stop_round = int(prev_round) + self.num_rounds
        if int(state.round) >= self._stop_round:
            self.stop()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
