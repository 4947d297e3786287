"""Wrapper of the whole-round kernel (``csrc/fused_round.cu``).

Replaces ``repro/kernels/fused_round.py::fused_round_nd``: K affine local
SGDA steps per client, optional error-feedback quantization of the round
delta, then the gossip epilogue, over the packed z = (x; y):

    repeat K:  z ← z − step ⊙ (G z + h_k + c)
    Δ = z_K − z₀;  q = Δ, or v = mask ⊙ (Δ + e), q = Q(v), e' = v − q
    z' = W z₀ + η_s ⊙ W q;   c' = c + corr ⊙ (q − W q)

Bound on an H100: reading G (n·dz²·4 bytes) once, ~2.5 µs at n = 8,
dz = 512.  Two routes for the K steps, chosen by :func:`route`: the cluster
route (a thread-block cluster per client holds its G slice in registers
across the K steps; dz ≤ 512) and the block route (one block per client,
G restreamed from L2 every step) for larger dz — see the notes in
``csrc/fused_round.cu``.  The plain version is
``repro_torch.kernels.ref.fused_round_ref``; dispatch between the plain
version and the kernel is ``repro_torch.kernels.ops.fused_round``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gossip_torch_dtype

COMPRESS_CODES = {None: 0, "bf16": 1, "int8": 2}
MAX_DZ = 1024  # the JAX package's ceiling (ops.fused_round), kept as is
ROUTES = ("cluster", "block")
# the cluster route's limits (csrc/fused_round.cu): cluster sizes up to the
# portable 8, and a block's rows of G in registers — at most 64 rows of at
# most 512 columns (16 a lane)
CLUSTER_SIZES = (1, 2, 4, 8)
MAX_CLUSTER_DZ = 512
ROWS_PER_BLOCK = 64


def cluster_size(dz: int) -> int:
    """The smallest cluster whose blocks hold at most 64 rows of the
    client's G each (1 at dz = 15, 8 at dz = 512), or 0 past dz = 512."""
    if dz > MAX_CLUSTER_DZ:
        return 0
    return next(cs for cs in CLUSTER_SIZES if -(-dz // cs) <= ROWS_PER_BLOCK)


def route(dz: int) -> str:
    """``"cluster"`` where a cluster holds G on chip (:func:`cluster_size`),
    ``"block"`` otherwise.  The client count n does not enter: a cluster
    serves one client, and the grid is n clusters."""
    return "cluster" if cluster_size(dz) else "block"


def check_dz(dz: int) -> None:
    if dz > MAX_DZ:
        raise ValueError(
            f"fused_round takes dz ≤ {MAX_DZ}, as the JAX package does; "
            f"dz={dz} — use mixing_impl='pallas_packed' for larger problems")


def fused_round_wire(w, z0, c, ef, g, h_steps, step, etas, corr, mask, *,
                     compress=None, gossip_dtype=None, force_route=None):
    """The kernel call, also returning what went on the wire.

    w: (n, n); z0/c/ef/step/etas/corr/mask: (n, dz); g: (n, dz, dz);
    h_steps: (K, n, dz); all contiguous f32 CUDA tensors on one device.
    Returns fresh (z_new, c_new, ef_new, q): q is what went on the wire,
    Δ itself without compression.  The route is :func:`route`'s;
    ``force_route="block"`` takes the block route whatever dz, and forcing
    ``"cluster"`` where no cluster holds G raises.  Counts its launches in
    ``fused_round_nd.launches`` and, by route, in ``fused_round_nd.routes``;
    a launch with ``compress`` also by route in ``fused_round_nd.compressed``.
    """
    if compress not in COMPRESS_CODES:
        raise ValueError(f"unknown compress {compress!r}")
    bf16 = gossip_torch_dtype(gossip_dtype) is not None
    n, dz = z0.shape
    check_dz(dz)
    k_steps = h_steps.shape[0]
    _build.check_operand("w", w, (n, n))
    _build.check_operand("g", g, (n, dz, dz))
    _build.check_operand("h_steps", h_steps, (k_steps, n, dz))
    for name, x in (("z0", z0), ("c", c), ("ef", ef), ("step", step),
                    ("etas", etas), ("corr", corr), ("mask", mask)):
        _build.check_operand(name, x, (n, dz))
    which = _build.forced_route(route(dz), force_route, universal="block")
    lib = _build.library("fused_round")
    z_new, c_new, e_new, q = (torch.empty_like(z0) for _ in range(4))
    stream = torch.cuda.current_stream(z0.device).cuda_stream
    err = lib.fused_round_launch(
        w.data_ptr(), z0.data_ptr(), c.data_ptr(), ef.data_ptr(),
        g.data_ptr(), h_steps.data_ptr(), step.data_ptr(), etas.data_ptr(),
        corr.data_ptr(), mask.data_ptr(), z_new.data_ptr(), c_new.data_ptr(),
        e_new.data_ptr(), q.data_ptr(), n, dz, k_steps,
        COMPRESS_CODES[compress], int(bf16),
        cluster_size(dz) if which == "cluster" else 0, stream)
    _build.check(err, "fused_round_launch")
    fused_round_nd.launches += 1
    fused_round_nd.routes[which] += 1
    if compress is not None:
        fused_round_nd.compressed[which] += 1
    return z_new, c_new, e_new, q


def fused_round_nd(w, z0, c, ef, g, h_steps, step, etas, corr, mask, *,
                   compress=None, gossip_dtype=None, force_route=None):
    """As :func:`fused_round_wire`, returning (z_new, c_new, ef_new)."""
    return fused_round_wire(w, z0, c, ef, g, h_steps, step, etas, corr, mask,
                            compress=compress, gossip_dtype=gossip_dtype,
                            force_route=force_route)[:3]


fused_round_nd.launches = 0
fused_round_nd.routes = dict.fromkeys(ROUTES, 0)
fused_round_nd.compressed = dict.fromkeys(ROUTES, 0)
