"""A decode step over static buffers, captured as one CUDA graph on the
card, and the scheduler's sampling.

:class:`DecodeStep` runs ``models.model.decode_step`` on its own buffers:
tokens (B, 1[, C]), positions (B,) — each row at its own, so the slots of
a continuous-batching pool decode in one step — and the caches
(``init_cache``'s layout), which each call advances in place.  With
``sample`` it also draws a token a row (a token of each codebook) by
:func:`sample`.  On a CUDA device the step is one CUDA graph
(``engine.CudaGraph``: a warm-up on a side stream, then the capture),
captured once when the step is made and replayed by every call; the
caller copies its inputs into the buffers first, the noise included (the
engine's "draws before each replay" rule).  ``capture=False`` runs the
same function eagerly: the reference the graph is held to.  A capture
that fails raises; nothing falls back to eager.

Sampling is ``jax.random.categorical``'s own form: the argmax of the f32
logits over the temperature plus Gumbel noise (:func:`gumbel_noise`, as
``jax.random.gumbel`` draws it), so a caller that feeds the reference's
noise samples the reference's tokens.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.engine.engine import CudaGraph
from repro_torch.models import model as model_lib


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Gumbel(0, 1) noise of ``shape`` in f32: −log(−log u), u uniform in
    [tiny, 1) (``jax.random.gumbel``'s default form)."""
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def sample(logits, temps, noise) -> torch.Tensor:
    """(B, 1, V) logits -> (B,) tokens, or (B, 1, C, V) -> (B, C):
    argmax(logits[:, -1].float() / t + noise) with ``temps`` (B,) a
    temperature a row and ``noise`` (B, V) or (B, C, V)."""
    flat = logits[:, -1].to(torch.float32)
    t = temps.reshape((-1,) + (1,) * (flat.dim() - 1))
    return torch.argmax(flat / t + noise, dim=-1)


def _discard(dst, src) -> None:
    """The warm-up's store: none, so the warm-up leaves the buffers as
    they were."""


class DecodeStep:
    """``decode_step`` of ``model`` over static buffers (module
    docstring): ``tokens``, ``pos`` and, with ``sample``, ``temps`` (B,)
    f32 and ``noise`` (B[, C], V) f32 are the inputs; ``caches`` (given,
    ``batch`` rows; advanced in place), ``logits`` (B, 1[, C], V) in the
    compute dtype and, with ``sample``, ``sampled`` (B[, C]) the outputs.
    ``capture`` None captures on a CUDA device; ``capture_s`` is the
    warm-up's and the capture's seconds."""

    graph_type = CudaGraph

    def __init__(self, model: model_lib.Model, caches, batch: int, *,
                 compute_dtype=torch.bfloat16,
                 capture: Optional[bool] = None, sample: bool = False):
        cfg = model.cfg
        dev = model.embed.device
        cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
        self.model, self.caches = model, caches
        self.compute_dtype = compute_dtype
        self.sample = sample
        self.tokens = torch.zeros((batch, 1, *cb), dtype=torch.long,
                                  device=dev)
        self.pos = torch.zeros((batch,), dtype=torch.long, device=dev)
        self.logits = torch.zeros((batch, 1, *cb, cfg.vocab_size),
                                  dtype=compute_dtype, device=dev)
        if sample:
            self.temps = torch.ones((batch,), dtype=torch.float32,
                                    device=dev)
            self.noise = torch.zeros((batch, *cb, cfg.vocab_size),
                                     dtype=torch.float32, device=dev)
            self.sampled = torch.zeros((batch, *cb), dtype=torch.long,
                                       device=dev)
        self.graph = None
        self.capture_s = 0.0
        if capture is None:
            capture = dev.type == "cuda"
        if capture:
            t0 = time.perf_counter()
            graph = self.graph_type()
            with torch.no_grad():
                graph.warm_up(lambda: self._body(_discard))
                graph.capture(lambda: self._body(graph.write))
            self.graph = graph
            self.capture_s = time.perf_counter() - t0

    def _body(self, write) -> None:
        logits, new = model_lib.decode_step(
            self.model, self.caches, self.tokens, self.pos,
            compute_dtype=self.compute_dtype)
        for cache, fresh in zip(self.caches, new):
            for name, buf in cache.items():
                write(buf, fresh[name])
        write(self.logits, logits)
        if self.sample:
            write(self.sampled, sample(logits, self.temps, self.noise))

    @torch.no_grad()
    def __call__(self) -> None:
        """One step on the buffers' current inputs: a replay of the graph,
        or the same function eagerly."""
        if self.graph is not None:
            self.graph.replay()
        else:
            self._body(CudaGraph.write)
