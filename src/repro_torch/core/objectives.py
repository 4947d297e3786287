"""Concrete NC-SC minimax objectives (port of ``repro.core.objectives``).

* ``quadratic_problem`` — the synthetic NC-SC quadratic

      f_i(x, y) = ½xᵀA_i x + q_iᵀx + yᵀB_i x + b_iᵀy − μ/2‖y‖²  (+ σ·noise)

  Stochasticity is additive noise on the linear terms: one ``(dx + dy,)``
  row per client and local step, ``[nx; ny]``, entering as
  ``σ(nxᵀx + nyᵀy)``.  The JAX package draws ``nx``/``ny`` from a key split
  inside the oracle; here the row arrives as a tensor
  (``repro_torch.engine.sampler`` draws it).
* ``dro_problem`` — distributionally robust LM training over G token
  groups: y ∈ R^G, f_i(x, y) = Σ_g y_g ℓ_g(x; D_i) + aux − μ/2‖y‖².
* ``adversarial_problem`` — a universal adversarial embedding
  perturbation: y ∈ R^{d_model}, f_i(x, y) = ℓ(x; E + scale·y) − μ/2‖y‖².

For the two LM problems x is one client's parameter dict
(``models.model.param_dict``), run through ``models.model.call`` on a
skeleton of the model, and the data batch is the only source of
randomness (``noise_dim`` 0).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.minimax import MinimaxProblem


def make_quadratic_data(
    gen: torch.Generator,
    n_clients: int,
    dx: int = 10,
    dy: int = 5,
    mu: float = 1.0,
    l_smooth: float = 4.0,
    heterogeneity: float = 1.0,
    nonconvexity: float = 0.5,
) -> Dict[str, Any]:
    """Per-client data, drawn from ``gen`` on ``gen.device``.

    Same construction as the reference: a PSD global Ā with eigenvalues in
    [0.1, l_smooth/2] plus zero-mean symmetric per-client perturbations, a
    B̄ of spectral norm l_smooth/2 plus zero-mean per-client offsets.  The
    draws differ from the JAX package's (another generator); parity tests
    take the reference's data through ``repro_torch.core.from_reference``.
    """
    dev = gen.device

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    q_rot = torch.linalg.qr(normal(dx, dx))[0]
    eigs = torch.linspace(0.1, l_smooth / 2, dx, device=dev)
    base_a = (q_rot * eigs) @ q_rot.T

    e = normal(n_clients, dx, dx) / np.sqrt(dx)
    e = 0.5 * (e + e.transpose(-1, -2))
    e = e - e.mean(0, keepdim=True)
    a = base_a[None] + (nonconvexity + heterogeneity) * e

    base_b = normal(dy, dx) / np.sqrt(max(dx, dy))
    base_b = base_b * (l_smooth / 2 / torch.linalg.matrix_norm(base_b, ord=2))
    db = normal(n_clients, dy, dx) / np.sqrt(dx)
    db = db - db.mean(0, keepdim=True)
    b_mat = base_b[None] + heterogeneity * db

    b_vec = normal(n_clients, dy) * heterogeneity
    q_vec = normal(n_clients, dx) * heterogeneity
    return {"A": a, "B": b_mat, "b": b_vec, "q": q_vec, "mu": float(mu)}


def _value(x, y, batch, noise, *, mu, dx, sigma):
    f = (
        0.5 * x @ (batch["A"] @ x)
        + batch["q"] @ x
        + y @ (batch["B"] @ x)
        + batch["b"] @ y
        - 0.5 * mu * torch.sum(y * y)
    )
    if sigma is not None:
        f = f + sigma * (noise[:dx] @ x + noise[dx:] @ y)
    return f


def _quadratic_affine_coeffs(batch, noise, *, mu, dy, sigma):
    """(G, h) with (∇x f, ∇y f) = split(G z + h) for z = concat(x, y).

        G = [[A, Bᵀ], [B, −μI]]       h = [q; b] (+ σ·noise)

    ``noise`` may carry leading step dims; h broadcasts to them while G is
    built once.
    """
    a, b_mat = batch["A"], batch["B"]
    top = torch.cat([a, b_mat.transpose(-1, -2)], dim=-1)
    bottom = torch.cat(
        [b_mat, -mu * torch.eye(dy, dtype=a.dtype, device=a.device)], dim=-1)
    g = torch.cat([top, bottom], dim=-2)
    h = torch.cat([batch["q"], batch["b"]], dim=-1)
    if sigma is not None:
        h = h + sigma * noise
    return g, h


def quadratic_problem(data: Dict[str, Any], sigma: float = 0.0) -> MinimaxProblem:
    """MinimaxProblem over per-client slices of ``data``.

    The per-client batch is {"A": (dx,dx), "B": (dy,dx), "b": (dy,),
    "q": (dx,)}; ``sigma > 0`` adds the noise row's linear terms.
    """
    mu = float(data["mu"])
    dx = data["A"].shape[-1]
    dy = data["B"].shape[-2]
    dev = data["A"].device
    sig = float(sigma) if sigma > 0.0 else None

    a_bar = data["A"].mean(0)
    b_bar = data["B"].mean(0)
    bv_bar = data["b"].mean(0)
    q_bar = data["q"].mean(0)

    def value(x, y, batch, noise):
        return _value(x, y, batch, noise, mu=mu, dx=dx, sigma=sig)

    def phi_grad(x):
        # y*(x) = (B̄x + b̄)/μ ; ∇Φ = Āx + q̄ + B̄ᵀ y*(x)
        ystar = (b_bar @ x + bv_bar) / mu
        return a_bar @ x + q_bar + b_bar.T @ ystar

    def affine_coeffs(batch, noise):
        return _quadratic_affine_coeffs(batch, noise, mu=mu, dy=dy, sigma=sig)

    return MinimaxProblem(
        init_x=lambda gen: torch.randn((dx,), generator=gen, device=dev),
        init_y=lambda gen: torch.zeros((dy,), device=dev),
        value=value,
        noise_dim=dx + dy,
        phi_grad=phi_grad,
        affine_coeffs=affine_coeffs,
        mu=mu,
    )


def quadratic_cell_problem(dx: int, dy: int, mu: float = 1.0,
                           noise: bool = False,
                           device: str = "cuda") -> MinimaxProblem:
    """The quadratic with every per-client coefficient read from the batch.

    The per-client slice is ``{"A", "B", "b", "q"}`` plus, when ``noise``, a
    scalar ``"sigma"``.  No Φ oracle: the sweep runner (ROADMAP A5)
    evaluates it over its own stacked constants.
    """

    def value(x, y, batch, nz):
        f = _value(x, y, batch, None, mu=mu, dx=dx, sigma=None)
        if noise:
            f = f + batch["sigma"] * (nz[:dx] @ x + nz[dx:] @ y)
        return f

    def affine_coeffs(batch, nz):
        g, h = _quadratic_affine_coeffs(batch, None, mu=mu, dy=dy, sigma=None)
        if noise:
            h = h + batch["sigma"] * nz
        return g, h

    return MinimaxProblem(
        init_x=lambda gen: torch.randn((dx,), generator=gen, device=device),
        init_y=lambda gen: torch.zeros((dy,), device=device),
        value=value,
        noise_dim=dx + dy,
        affine_coeffs=affine_coeffs,
        mu=mu,
    )


# ---------------------------------------------------------------------------
# DRO over a language model
# ---------------------------------------------------------------------------

def _lm_init_x(cfg):
    """Fresh f32 parameters of ``cfg`` on the generator's device, as a
    parameter dict."""
    from repro_torch.models import model as model_lib

    def init_x(gen: torch.Generator):
        return model_lib.param_dict(model_lib.init_params(
            cfg, generator=gen, device=gen.device))

    return init_x


def dro_group_losses(cfg, *, num_groups: int, compute_dtype=torch.bfloat16,
                     kernels: bool = True, shard=None, remat: bool = False):
    """``losses(x, batch) -> ((G,) per-group losses, aux)`` of
    ``models.model.per_group_loss`` on a client's parameters ``x``: the
    whole dict through ``models.model.call``, or with ``shard`` (a
    ``dist.tensor_parallel.ClientShard``) this rank's pieces of it on the
    fsdp rank's rows of the batch, under the shard's slots, each group's
    mean over the client's whole batch.  ``remat``: each unit of the stack
    under activation checkpointing (``models.transformer.UnitRemat``)."""
    from repro_torch.dist import context as dist_ctx
    from repro_torch.models import model as model_lib

    kw = dict(num_groups=num_groups, compute_dtype=compute_dtype,
              kernels=kernels, remat=remat)
    if shard is None:
        skel = model_lib.skeleton(cfg)
        return lambda x, batch: model_lib.call(
            skel, x, model_lib.per_group_loss, batch, **kw)

    def losses(x, batch):
        with dist_ctx.residual_constraint(**shard.slots()):
            return model_lib.per_group_loss(shard.model_of(x),
                                            shard.batch(batch), **kw)

    return losses


def dro_problem(cfg, *, num_groups: int = 8, mu: float = 1.0,
                compute_dtype=torch.bfloat16, kernels: bool = True,
                shard=None, remat: bool = False) -> MinimaxProblem:
    """Reference :201.  ``value`` is Σ_g y_g ℓ_g + aux − μ/2‖y‖² with the
    per-group losses of ``models.model.per_group_loss`` computing in
    ``compute_dtype``; ``kernels`` as there (B5 and B6 on the card,
    differentiated through their autograd Functions; ``False`` runs the
    plain versions, the check on the card); ``remat`` each unit of the
    stack under activation checkpointing (the reference's ``remat``, its
    default False here as there).

    ``shard``: a ``dist.tensor_parallel.ClientShard``, this rank's place
    on a client's ``(fsdp, model)`` block of the decentralized mesh.  x is
    then this rank's pieces of a client's weights (``init_x`` draws the
    whole model's draws and keeps them), gathered where the forward reads
    them, so ``grad`` returns the pieces' gradient summed over the block;
    y stays whole, and its gradient ℓ − μy is the same on every rank of
    the block (not summed over it) (:func:`dro_group_losses`)."""
    losses_of = dro_group_losses(cfg, num_groups=num_groups,
                                 compute_dtype=compute_dtype,
                                 kernels=kernels, shard=shard, remat=remat)

    def value(x, y, batch, noise):
        del noise  # the data batch is the only source of randomness
        losses, aux = losses_of(x, batch)
        return torch.dot(y, losses) + aux - 0.5 * mu * torch.sum(y * y)

    init_x = (_lm_init_x(cfg) if shard is None else
              lambda gen: shard.init(gen, device=gen.device))
    return MinimaxProblem(
        init_x=init_x,
        init_y=lambda gen: torch.zeros((num_groups,), device=gen.device),
        value=value, noise_dim=0, mu=mu)


def adversarial_problem(cfg, *, mu: float = 10.0, scale: float = 0.1,
                        compute_dtype=torch.bfloat16,
                        remat: bool = False) -> MinimaxProblem:
    """Reference :225: the NLL of the full logits with ``scale·y`` added to
    every token's embedding, + aux − μ/2‖y‖²; ``remat`` as
    :func:`dro_problem`'s."""
    from repro_torch.models import model as model_lib

    skel = model_lib.skeleton(cfg)

    def value(x, y, batch, noise):
        del noise
        perturbed = dict(batch)
        perturbed["embed_bias"] = scale * y
        logits, _, aux = model_lib.call(
            skel, x, model_lib.forward, perturbed, mode="train",
            compute_dtype=compute_dtype, remat=remat)
        nll = model_lib.token_losses(logits, batch["labels"]).mean()
        return nll + aux - 0.5 * mu * torch.sum(y * y)

    return MinimaxProblem(
        init_x=_lm_init_x(cfg),
        init_y=lambda gen: torch.zeros((cfg.d_model,), device=gen.device),
        value=value, noise_dim=0, mu=mu)
