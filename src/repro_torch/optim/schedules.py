"""Learning-rate schedules (port of ``repro.optim.schedules``): constant,
cosine and WSD (warmup–stable–decay, the MiniCPM schedule,
arXiv:2404.06395).

A schedule maps the round index (a host int) to a host float.  The round
step multiplies its local stepsizes by it on the host, so a captured
engine chunk bakes in one value per round, and the engine captures such a
chunk once per start (``round_step.uses_round``; the train driver passes
no schedule where it is 1 every round).  The reference computes the same
expressions in f32 on the device; here they are f64 on the host.
"""
from __future__ import annotations

import math


def _warmup(t: float, warmup: int) -> float:
    return min(1.0, (t + 1) / max(warmup, 1))


def constant(total_rounds: int, warmup: int = 0):
    """1 after a linear warmup."""
    def fn(t):
        return _warmup(float(t), warmup) if warmup else 1.0
    return fn


def cosine(total_rounds: int, warmup: int = 0, floor: float = 0.1):
    def fn(t):
        t = float(t)
        prog = min(max((t - warmup) / max(total_rounds - warmup, 1), 0.0),
                   1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * prog))
        return _warmup(t, warmup) * cos
    return fn


def wsd(total_rounds: int, warmup: int = 0, decay_start_frac: float = 0.8,
        floor: float = 0.1):
    """Warmup -> stable (lr = 1) -> geometric decay to ``floor`` in the
    last (1 - decay_start_frac) fraction of training."""
    def fn(t):
        t = float(t)
        start = decay_start_frac * total_rounds
        prog = min(max((t - start) / max(total_rounds - start, 1), 0.0), 1.0)
        return _warmup(t, warmup) * (1.0 if t < start else floor ** prog)
    return fn


SCHEDULES = {"constant": constant, "cosine": cosine, "wsd": wsd}


def get_schedule(name: str, total_rounds: int, warmup: int = 0, **kw):
    return SCHEDULES[name](total_rounds, warmup, **kw)
