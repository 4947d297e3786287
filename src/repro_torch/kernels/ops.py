"""Dispatch between the three round kernels and their plain PyTorch versions.

Counterparts of ``repro.kernels.ops.fused_gossip_round`` (:171),
``fused_round`` (:202) and ``sparse_gossip_round`` (:253): the packed
gossip epilogue (``csrc/gossip.cu``), the whole round
(``csrc/fused_round.cu``) and the neighbor-gather epilogue
(``csrc/neighbor_gossip.cu``).  ``backend``:

* ``"auto"`` — the CUDA kernel for CUDA tensors, the plain version for CPU
  tensors;
* ``"kernel"`` — the CUDA kernel (a CPU tensor raises);
* ``"torch"`` — the plain version (a CUDA tensor raises: on the card the
  kernel runs, and ``chip_smoke.py`` calls the plain version directly).

There is no fallback between the two: a kernel that fails to build or
launch raises.  No padding either: the kernels mask their ragged edges.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fused_round as fround_lib
from repro_torch.kernels import gossip as gossip_lib
from repro_torch.kernels import neighbor_gossip as ngossip_lib
from repro_torch.kernels import ref as ref_lib

GOSSIP_BACKENDS = ("auto", "kernel", "torch")


def use_kernel(backend: str, x: torch.Tensor) -> bool:
    """Whether ``backend`` runs the CUDA kernel on tensors like ``x``."""
    if backend not in GOSSIP_BACKENDS:
        raise ValueError(
            f"unknown gossip_backend {backend!r}: {GOSSIP_BACKENDS}")
    if backend == "kernel" and not x.is_cuda:
        raise ValueError("gossip_backend='kernel' needs CUDA tensors; "
                         f"got a tensor on {x.device}")
    if backend == "torch" and x.is_cuda:
        raise ValueError("gossip_backend='torch' is the plain version for "
                         "CPU tensors; on CUDA tensors the kernel runs")
    return x.is_cuda


def _f32c(x):
    return x.to(torch.float32).contiguous()


def fused_gossip_round(w, delta, theta, c, eta_s, corr_scale, *,
                       backend: str = "auto", gossip_dtype=None):
    """Fused round epilogue over packed client state.

    w: (n, n); delta/theta/c: (n, D).  Returns f32
    (θ_new, c_new) = (Wθ + η_s·WΔ, c + corr_scale·(Δ − WΔ)).
    """
    if use_kernel(backend, delta):
        return gossip_lib.fused_gossip_nd(
            _f32c(w), _f32c(delta), _f32c(theta), _f32c(c), eta_s,
            corr_scale, gossip_dtype=gossip_dtype)
    return ref_lib.fused_gossip_ref(w, delta, theta, c, eta_s, corr_scale,
                                    gossip_dtype=gossip_dtype)


def fused_round(w, z0, c, ef, g_mat, h_steps, step, etas, corr, mask, *,
                backend: str = "auto", compress=None, gossip_dtype=None):
    """Whole Algorithm-1 round (K affine local SGDA steps + gossip epilogue)
    over the packed z = (x; y) state.

    w: (n, n); z0/c/ef: (n, dz); g_mat: (n, dz, dz); h_steps: (K, n, dz);
    step/etas/corr/mask: (n, dz) per-column vectors.  Returns f32
    (z_new, c_new, ef_new).  The kernel takes dz ≤ 1024 (ValueError
    beyond, as in the JAX package).
    """
    if use_kernel(backend, z0):
        return fround_lib.fused_round_nd(
            _f32c(w), _f32c(z0), _f32c(c), _f32c(ef), _f32c(g_mat),
            _f32c(h_steps), _f32c(step), _f32c(etas), _f32c(corr),
            _f32c(mask), compress=compress, gossip_dtype=gossip_dtype)
    return ref_lib.fused_round_ref(w, z0, c, ef, g_mat, h_steps, step, etas,
                                   corr, mask, compress=compress,
                                   gossip_dtype=gossip_dtype)


def sparse_gossip_round(neighbor_idx, neighbor_w, self_w, delta, theta, c,
                        eta_s, corr_scale, *, backend: str = "auto",
                        gossip_dtype=None):
    """Fused round epilogue over packed client state, sparse W.

    neighbor_idx: (n, m) padded-CSR neighbor lists (padding = own index);
    neighbor_w: (n, m) with padding weight 0; self_w: (n,) diagonal;
    delta/theta/c: (n, D).  Returns f32
    (θ_new, c_new) = (Wθ + η_s·WΔ, c + corr_scale·(Δ − WΔ)), the contract
    of :func:`fused_gossip_round` in O(n·m·D).  Raw tensors, not a
    ``SparseTopology``, so the kernels package needs nothing of ``core``.
    """
    if use_kernel(backend, delta):
        return ngossip_lib.sparse_gossip_nd(
            neighbor_idx.to(torch.int32).contiguous(), _f32c(neighbor_w),
            _f32c(self_w), _f32c(delta), _f32c(theta), _f32c(c), eta_s,
            corr_scale, gossip_dtype=gossip_dtype)
    return ref_lib.sparse_gossip_ref(neighbor_idx, neighbor_w, self_w, delta,
                                     theta, c, eta_s, corr_scale,
                                     gossip_dtype=gossip_dtype)
