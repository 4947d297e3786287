"""Production, decentralized and serving meshes (port of
``repro.launch.mesh``).

The decentralized logical mesh is ``(clients, fsdp, model)``: one
K-GT-Minimax client a contiguous block of ``fsdp × model`` ranks.  Here a
mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of a world,
one rank a device (:func:`train_mesh`); :func:`train_axes` gives a rank
its three axes as ``dist.collectives`` groups (:class:`TrainAxes`: the
clients axis over the ranks that hold the same piece of every client,
the fsdp and model axes and the whole block of its client).  The
production meshes (256 and 512 chips) exist on no world this repository
starts, so their shapes come as abstract meshes
(``dist.compat.abstract_mesh``) for spec work.

The serving mesh ``(data, model)`` is a :class:`ServeMesh`: the batch
rows split over ``data``, the weights over ``model``
(``dist.tensor_parallel``); the ``(pod, data, model)`` layout exists only
as the abstract production mesh.  It carries this rank's two
axes as ``dist.collectives.MeshAxis`` groups, so it may span a sub-set of
the world's ranks (``serve_mesh(..., ranks=)``), as the reference's
``compat.make_mesh((4, 2), ("data", "model"))`` (its ``launch/smoke.py``
:164) spans 8 of a host's devices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch.distributed as dist

from repro_torch.configs.base import MeshConfig
from repro_torch.dist import collectives, compat
from repro_torch.dist.sharding import CLIENTS, FSDP, MODEL


def make_production_mesh(*, multi_pod: bool = False) -> compat.AbstractMesh:
    """The launch-spec serving mesh's shape: (data 16, model 16), or (pod
    2, data 16, model 16)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat.abstract_mesh(dict(zip(axes, shape)))


def make_decentralized_mesh(mcfg: MeshConfig) -> compat.AbstractMesh:
    """The production device array reshaped to (clients, fsdp, model), as
    an abstract mesh."""
    prod = make_production_mesh(multi_pod=mcfg.multi_pod)
    if prod.size != mcfg.devices_needed:
        raise ValueError(f"{mcfg} needs {mcfg.devices_needed} devices, the "
                         f"production mesh has {prod.size}")
    return compat.abstract_mesh({CLIENTS: mcfg.num_clients, FSDP: mcfg.fsdp,
                                 MODEL: mcfg.model})


# per-arch overrides of the decentralized layout: the 70B-class model needs
# a bigger per-client sub-mesh to fit its f32 tracking state
_ARCH_MESH = {
    "internvl2-76b": dict(num_clients=2, fsdp=8),
    "qwen1.5-32b": dict(num_clients=4, fsdp=4),
}


def decentralized_mesh_config(arch_id: str, *,
                              multi_pod: bool = False) -> MeshConfig:
    kw = dict(_ARCH_MESH.get(arch_id, dict(num_clients=4, fsdp=4)))
    kw["model"] = 16
    if multi_pod:
        kw["num_clients"] *= 2  # the clients axis spans the pod dimension
    return MeshConfig(multi_pod=multi_pod, **kw)


def local_mesh(n_ranks: int = None, *, device_type: str = None):
    """``(clients = n_ranks, 1, 1)`` over the first ``n_ranks`` ranks of
    the default process group (all of them by default)."""
    n = n_ranks or dist.get_world_size()
    return compat.mesh_of(np.arange(n).reshape(n, 1, 1),
                          (CLIENTS, FSDP, MODEL), device_type=device_type)


def train_mesh(num_clients: int, fsdp: int, model: int, *,
               device_type: str = None):
    """The decentralized mesh ``(clients, fsdp, model)`` over a world of
    ``num_clients × fsdp × model`` ranks, laid out row-major (one client a
    contiguous block of ``fsdp × model`` ranks), its device type this
    rank's (``cuda`` on the card, as ranks sharing one card over gloo
    have it)."""
    need = num_clients * fsdp * model
    have = dist.get_world_size()
    if have != need:
        raise RuntimeError(f"a ({num_clients}, {fsdp}, {model}) mesh needs "
                           f"a world of {need} ranks, this one has {have}")
    return compat.make_mesh((num_clients, fsdp, model),
                            (CLIENTS, FSDP, MODEL), device_type=device_type)


def fake_mesh(num_clients: int = 2, fsdp: int = 2, model: int = 2):
    """A decentralized mesh over a CPU world (gloo) of ``num_clients ×
    fsdp × model`` ranks, for tests and the smoke run (started by
    ``dist.launch.run_world``): :func:`train_mesh` on the CPU."""
    return train_mesh(num_clients, fsdp, model, device_type="cpu")


@dataclasses.dataclass(frozen=True)
class TrainAxes:
    """This rank's three axes on the decentralized mesh: ``clients``, the
    ranks that hold the same ``(fsdp, model)`` piece of every client (the
    gossip's group); ``fsdp`` and ``model``, the ranks of its client's
    block that share its model piece or its batch rows; ``block``, all
    ``fsdp × model`` ranks of its client."""
    clients: collectives.ClientsAxis
    fsdp: collectives.MeshAxis
    model: collectives.MeshAxis
    block: collectives.MeshAxis


def _mesh_axis(mesh, name: str) -> collectives.MeshAxis:
    size = mesh.size(mesh.mesh_dim_names.index(name))
    if size == 1:
        return collectives.MeshAxis(rank=0, size=1)
    group = mesh.get_group(name)
    return collectives.MeshAxis(rank=mesh.get_local_rank(name), size=size,
                                group=group, backend=dist.get_backend(group))


def train_axes(mesh, n: int) -> TrainAxes:
    """This rank's :class:`TrainAxes` on a ``(clients, fsdp, model)``
    ``DeviceMesh``, for ``n`` clients (every rank calls it: it makes the
    block's groups where the block has more than one rank)."""
    sizes = compat.axis_sizes(mesh)
    per_client = sizes[FSDP] * sizes[MODEL]
    if per_client == 1:
        block = collectives.MeshAxis(rank=0, size=1)
    else:
        # the block moves only maxima and norms: no stream groups
        block = collectives.sub_axes(
            mesh.mesh.reshape(sizes[CLIENTS], per_client).tolist(),
            streams=False)
    return TrainAxes(clients=collectives.clients_axis(mesh, n),
                     fsdp=_mesh_axis(mesh, FSDP),
                     model=_mesh_axis(mesh, MODEL), block=block)


# ---------------------------------------------------------------------------
# the serving mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeMesh(compat.AbstractMesh):
    """A ``(data, model)`` mesh of named sizes (``shape``, as an abstract
    mesh) and this rank's place on it: its axis over the ``data`` ranks
    (those that hold the same weight shard) and over the ``model`` ranks
    (those that hold the same batch rows, a prefill's residual split by
    sequence over them: ``dist.tensor_parallel.SeqSplit``)."""
    batch_axis: collectives.MeshAxis = None
    model_axis: collectives.MeshAxis = None


def serve_mesh(data: int, model: int, *,
               ranks: Optional[Sequence[int]] = None) -> Optional[ServeMesh]:
    """The serving mesh over ``ranks`` of the world (default: all of it,
    which must then hold ``data × model`` ranks), laid out row-major as
    ``(data, model)``: the ``model`` ranks of a batch shard are
    contiguous.  Every rank of the world calls it (it makes the axes'
    groups); a rank outside ``ranks`` gets None."""
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    if len(ranks) != data * model:
        raise ValueError(f"a serving mesh of {data} x {model} needs "
                         f"{data * model} ranks, got {len(ranks)}")
    grid = np.asarray(ranks).reshape(data, model)
    model_ax = collectives.sub_axes(grid.tolist())
    batch_ax = collectives.sub_axes(grid.T.tolist())
    if dist.get_rank() not in ranks:
        return None
    return ServeMesh(("data", MODEL), (data, model),
                     batch_axis=batch_ax, model_axis=model_ax)


def fake_serve_mesh(data: int = 4, model: int = 2) -> ServeMesh:
    """A serving mesh over a CPU world (gloo) of ``data × model`` ranks,
    for tests and the smoke run (started by ``dist.launch.run_world``)."""
    have = dist.get_world_size()
    if have != data * model:
        raise RuntimeError(f"fake_serve_mesh needs a world of {data * model} "
                           f"ranks, this one has {have}")
    return serve_mesh(data, model)
