"""Minimal optimizers over tensor trees (port of
``repro.optim.optimizers``).

An optimizer is an (init, update) pair; ``update(grads, state, params,
lr)`` returns (new_params, new_state), arithmetic in f32 and the params'
dtypes kept.  Algorithm 1's local update is plain SGD (the round step
writes it out); ``momentum`` and ``adam`` are beyond-paper inner
optimizers.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import tree as tree_lib

F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], tuple]  # (grads, state, params, lr)


def _zeros(params):
    return tree_lib.tree_map(lambda p: torch.zeros_like(p, dtype=F32), params)


def sgd() -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, lr):
        new = tree_lib.tree_map(
            lambda p, g: (p.to(F32) - lr * g.to(F32)).to(p.dtype),
            params, grads)
        return new, state

    return Optimizer(init, update)


def momentum(beta: float = 0.9) -> Optimizer:
    def update(grads, state, params, lr):
        m = tree_lib.tree_map(lambda s, g: beta * s + g.to(F32), state, grads)
        new = tree_lib.tree_map(
            lambda p, mm: (p.to(F32) - lr * mm).to(p.dtype), params, m)
        return new, m

    return Optimizer(_zeros, update)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """Adam with bias correction; the step count ``t`` is a host int."""
    def init(params):
        return {"m": _zeros(params), "v": _zeros(params), "t": 0}

    def update(grads, state, params, lr):
        t = state["t"] + 1
        m = tree_lib.tree_map(lambda s, g: b1 * s + (1 - b1) * g.to(F32),
                              state["m"], grads)
        v = tree_lib.tree_map(
            lambda s, g: b2 * s + (1 - b2) * torch.square(g.to(F32)),
            state["v"], grads)
        mh = 1.0 - b1 ** t
        vh = 1.0 - b2 ** t
        new = tree_lib.tree_map(
            lambda p, mm, vv: (p.to(F32) - lr * (mm / mh)
                               / (torch.sqrt(vv / vh) + eps)).to(p.dtype),
            params, m, v)
        return new, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


OPTIMIZERS = {"sgd": sgd, "momentum": momentum, "adam": adam}


def get_optimizer(name: str, **kw) -> Optimizer:
    return OPTIMIZERS[name](**kw)
