"""Device meshes over the ranks of a torch.distributed job (counterpart of
kafka_ps_tpu/parallel/mesh.py).

The JAX package lays one process's devices out as a `jax.sharding.Mesh`;
the port maps one device to one rank of a job (parallel/multihost.py), so
its mesh is a `torch.distributed.device_mesh.DeviceMesh` over ranks,
row-major: rank r sits at (r // params, r % params), the order in which
the JAX `worker_param_mesh` reshapes its devices.  The `workers` axis is
the data-parallel one (the fused BSP step all-reduces deltas over it),
the optional `params` axis range-shards the parameter vector
(parallel/range_sharded.py).

Without an initialised group the port's device count is 1, and both
builders give a `LocalMesh`: one rank, no group, every collective over it
the identity, which the fused path runs as its one-device branch.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from kafka_ps_tpu_torch.utils.config import resolve_device

WORKER_AXIS = "workers"
PARAM_AXIS = "params"


class LocalMesh:
    """The mesh of a run outside any job: one rank, no process group.
    It answers the parts of the DeviceMesh interface the port reads."""

    def __init__(self, mesh_dim_names: tuple[str, ...]):
        self.mesh_dim_names = mesh_dim_names
        self.shape = (1,) * len(mesh_dim_names)

    def size(self, mesh_dim=None) -> int:
        return 1

    def get_group(self, mesh_dim=None):
        return None

    def get_local_rank(self, mesh_dim=None) -> int:
        return 0

    def get_coordinate(self) -> tuple[int, ...]:
        return (0,) * len(self.mesh_dim_names)


def device_count() -> int:
    """The job's world size: one device per rank; 1 without a job."""
    return dist.get_world_size() if dist.is_initialized() else 1


def in_job(mesh) -> bool:
    """True when `mesh` spans ranks of a job (its collectives are real)."""
    return mesh is not None and not isinstance(mesh, LocalMesh)


def axes(mesh) -> dict[str, int]:
    """{axis name: size}, the JAX Mesh's `shape`."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _mesh(shape: tuple[int, ...], names: tuple[str, ...]):
    need, have = 1, device_count()
    for n in shape:
        need *= n
    if need > have:
        raise ValueError(f"need {need} devices, have {have}")
    if not dist.is_initialized():
        return LocalMesh(names)
    # the first `need` ranks, row-major; every rank of the job builds it
    # (its sub-groups are made collectively)
    return DeviceMesh(resolve_device().type,
                      torch.arange(need).reshape(shape),
                      mesh_dim_names=names)


def worker_mesh(num_devices: int | None = None):
    """1-D mesh over the worker axis (data parallelism): the job's first
    `num_devices` ranks, all of them by default."""
    return _mesh((num_devices or device_count(),), (WORKER_AXIS,))


def worker_param_mesh(num_worker_shards: int, num_param_shards: int):
    """2-D mesh: data parallelism × parameter-range sharding."""
    return _mesh((num_worker_shards, num_param_shards),
                 (WORKER_AXIS, PARAM_AXIS))
