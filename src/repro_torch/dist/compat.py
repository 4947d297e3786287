"""Mesh constructors of the port (the torch meaning of ``repro.dist.
compat``).

JAX builds a mesh over the devices of one process; the port's mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of a process
group, one rank a device.  ``abstract_mesh`` is a device-free mesh of
named sizes, for spec work (``dist.sharding``) on meshes larger than any
world this machine starts, as the reference's ``AbstractMesh``.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Named axis sizes and nothing else: ``shape`` maps each axis name to
    its size, in order, as ``jax.sharding.AbstractMesh.shape`` does."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def default_device_type() -> str:
    """The device type of this rank's mesh: ``cuda`` where the process has
    a current CUDA device, else ``cpu``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              device_type: str = None):
    """A ``DeviceMesh`` of ``axis_shapes`` over every rank of the default
    process group (``init_device_mesh``), axes named ``axis_names``."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type or default_device_type(),
                            tuple(axis_shapes),
                            mesh_dim_names=tuple(axis_names))


def mesh_of(ranks, axis_names: Sequence[str], *, device_type: str = None):
    """A ``DeviceMesh`` over an explicit array of ranks (its shape is the
    mesh's), axes named ``axis_names``: the decentralized mesh's
    constructor, one client a contiguous ``fsdp × model`` block."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type or default_device_type(),
                      torch.as_tensor(ranks, dtype=torch.int64),
                      mesh_dim_names=tuple(axis_names))


def abstract_mesh(axis_sizes: Mapping[str, int]) -> AbstractMesh:
    """A device-free mesh of ``{axis name: size}``, in order."""
    items = tuple(axis_sizes.items())
    return AbstractMesh(tuple(n for n, _ in items),
                        tuple(int(s) for _, s in items))


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)
