"""Continuous-batching serving loop (port of ``repro.serving.scheduler``).

A fixed pool of decode slots is stepped in lockstep, one decode step per
tick; between ticks the scheduler admits queued requests into free slots
(first in, first out), prefills them token by token into the slot's cache
rows, and retires sequences on length, EOS or the cache's cap.  The batch
dimension is the slot pool, and each slot decodes at its own position:
the reference ``vmap``s batch-1 calls, the port passes ``decode_step`` a
(num_slots,) position tensor.

The device part of a tick — the decode step at every slot's position, the
new caches written into the engine's cache buffers and the sampling — is
``serving.decode.DecodeStep``: one CUDA graph on the card, captured when
the engine is made and replayed every tick; ``capture=False`` runs it
eagerly.  Each tick copies the tokens, positions, temperatures and the
tick's noise into the step's buffers first.  The noise is Gumbel noise
drawn from the engine's own ``torch.Generator`` on the device, or what
the ``noise`` callable returns (``noise(shape) -> tensor``).

Like the reference, admission does not reset a slot's caches: attention
caches need no reset (the validity mask hides what a request has not
written), but a recurrent layer's state carries into the next request
admitted to the slot (ROADMAP §C quirk 6).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import model as model_lib
from repro_torch.serving.decode import DecodeStep, gumbel_noise


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (P,) or (P, ncb)
    max_new_tokens: int
    temperature: float = 1.0
    eos_token: Optional[int] = None
    # filled by the engine:
    output: Optional[np.ndarray] = None


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    pos: int = 0                  # next absolute position to write
    prompt_cursor: int = 0        # tokens of the prompt already consumed
    generated: List = dataclasses.field(default_factory=list)


class ServingEngine:
    """Lockstep continuous-batching engine over ``num_slots`` sequences of
    ``model`` (on its device), caches of ``max_len`` positions in the
    compute dtype.  ``step`` is the engine's ``DecodeStep``; after a tick
    ``step.logits`` holds its logits."""

    def __init__(self, model: model_lib.Model, *, num_slots: int = 4,
                 max_len: int = 512, seed: int = 0,
                 compute_dtype=torch.bfloat16,
                 capture: Optional[bool] = None,
                 noise: Optional[Callable[[tuple], torch.Tensor]] = None):
        self.model = model
        self.cfg = model.cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.device = model.embed.device
        self.caches = model_lib.init_cache(self.cfg, num_slots, max_len,
                                           dtype=compute_dtype,
                                           device=self.device)
        self.slots = [_Slot() for _ in range(num_slots)]
        self.queue: List[Request] = []
        self.done: Dict[int, Request] = {}
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.noise = noise
        self._tick = 0
        self.step = DecodeStep(model, self.caches, num_slots,
                               compute_dtype=compute_dtype, capture=capture,
                               sample=True)

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for slot in self.slots:
            if slot.request is None and self.queue:
                req = self.queue.pop(0)
                slot.request = req
                slot.pos = 0
                slot.prompt_cursor = 0
                slot.generated = []

    def _next_tokens(self) -> np.ndarray:
        """Next input token per slot, (num_slots, 1[, ncb]): prompt token
        (prefill phase) or the last sampled token (decode phase); idle
        slots feed token 0."""
        toks = []
        for slot in self.slots:
            if slot.request is None:
                toks.append(np.zeros(self._tok_shape(), np.int64))
            elif slot.prompt_cursor < len(slot.request.prompt):
                toks.append(np.asarray(
                    slot.request.prompt[slot.prompt_cursor], np.int64))
            else:
                toks.append(np.asarray(slot.generated[-1], np.int64))
        return np.stack(toks)[:, None]

    def _tok_shape(self):
        return (self.cfg.num_codebooks,) if self.cfg.num_codebooks else ()

    # ------------------------------------------------------------------
    def tick(self) -> int:
        """One lockstep decode step across all slots; returns #active."""
        self._admit()
        active = [s for s in self.slots if s.request is not None]
        if not active:
            return 0
        step = self.step
        step.tokens.copy_(torch.from_numpy(self._next_tokens()))
        step.pos.copy_(torch.tensor([s.pos for s in self.slots]))
        step.temps.copy_(torch.tensor(
            [s.request.temperature if s.request else 1.0
             for s in self.slots], dtype=torch.float32))
        shape = tuple(step.noise.shape)
        step.noise.copy_(self.noise(shape) if self.noise else
                         gumbel_noise(shape, self.generator, self.device))
        step()
        sampled = np.array(step.sampled.cpu())    # a copy, on the CPU too

        for i, slot in enumerate(self.slots):
            req = slot.request
            if req is None:
                continue
            in_prefill = slot.prompt_cursor < len(req.prompt)
            slot.pos += 1
            if in_prefill:
                slot.prompt_cursor += 1
                if slot.prompt_cursor == len(req.prompt):
                    slot.generated.append(sampled[i])  # first real sample
            else:
                slot.generated.append(sampled[i])
            done_len = len(slot.generated) >= req.max_new_tokens
            done_eos = (req.eos_token is not None and slot.generated
                        and np.all(slot.generated[-1] == req.eos_token))
            done_cap = slot.pos >= self.max_len - 1
            if (not in_prefill or slot.prompt_cursor == len(req.prompt)) and (
                    done_len or done_eos or done_cap):
                req.output = np.stack(slot.generated)
                self.done[req.uid] = req
                slot.request = None
        self._tick += 1
        return len(active)

    def run(self, max_ticks: int = 10_000) -> Dict[int, Request]:
        for _ in range(max_ticks):
            if not self.tick() and not self.queue:
                break
        return self.done
