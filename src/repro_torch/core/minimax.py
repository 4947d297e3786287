"""MinimaxProblem: the NC-SC problem abstraction Algorithm 1 optimizes.

Port of ``repro.core.minimax``.  A problem supplies per-client oracles
written for a *single* client; the algorithm layer vmaps them over the
leading clients dim.  Where the JAX oracles take a PRNG key, these take the
noise itself as a tensor (``noise``: one ``(noise_dim,)`` row per client
and local step), so the samplers own the random stream and the parity
tests can feed the reference's draws in.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
# torch.func.grad imports torch._dynamo on its first call, and that import
# keeps the frames then on the stack (the caller's locals: a training
# state's GBs) in a reference cycle until a full collection; importing it
# here puts only import frames in that cycle
import torch._dynamo  # noqa: F401
from torch.func import grad

from repro_torch.core import tree as tree_lib


@dataclasses.dataclass(frozen=True)
class MinimaxProblem:
    """NC-SC minimax problem  min_x max_y (1/n) Σ_i f_i(x, y)."""

    # init_x(gen) -> x pytree ; init_y(gen) -> y pytree (shared across clients)
    init_x: Callable[[torch.Generator], Any]
    init_y: Callable[[torch.Generator], Any]
    # value(x, y, batch, noise) -> scalar f_i(x, y; ξ); the client identity
    # enters through ``batch``
    value: Callable[[Any, Any, Any, torch.Tensor], torch.Tensor]
    # width of one client's noise row
    noise_dim: int
    # exact ∇Φ of the global primal function (the synthetic quadratic)
    phi_grad: Optional[Callable[[Any], Any]] = None
    # affine_coeffs(batch, noise) -> (G, h) with (∇x f, ∇y f) = split(G z + h)
    # for z = (x; y) of one client.  ``noise`` may carry leading step dims
    # (..., noise_dim); G depends on the batch only and is built once, h
    # takes noise's leading shape.  Needed by mixing_impl="fused_round".
    affine_coeffs: Optional[Callable[[Any, torch.Tensor], Any]] = None
    mu: float = 1.0

    def grads(self, x, y, batch, noise):
        """(∇x f_i, ∇y f_i) at (x, y) on ``batch`` with noise row ``noise``."""
        return grad(self.value, argnums=(0, 1))(x, y, batch, noise)

    def phi_grad_norm(self, x) -> torch.Tensor:
        if self.phi_grad is None:
            raise ValueError("problem lacks the exact Phi oracle")
        g = self.phi_grad(x)
        return torch.sqrt(sum(torch.sum(l * l) for l in tree_lib.leaves(g)))
