"""Multi-process jobs over torch.distributed (counterpart of
kafka_ps_tpu/parallel/multihost.py).

The reference scales out by pointing every JVM at one Kafka broker
(`-r/--remote`); the JAX package joins a `jax.distributed` job, one
process per host owning all of that host's devices.  The port maps one
device to one rank: each rank is a process on one card (`cuda:(rank %
cards)`, or the CPU under KPS_PLATFORM=cpu), and a mesh of the job is a
DeviceMesh over ranks (parallel/mesh.py).

Design rules, as in the JAX package:
  * the worker axis is laid out rank-major: workers are block-assigned
    to mesh positions, and a rank feeds only its own block's buffers
    (`local_worker_ids`, the per-broker-partition analogue);
  * the fused step is the same program with or without a job; only the
    slabs differ (`shard_worker_batches_global`: each rank's own stacked
    slabs on its device).

The backend is decided up front from the layout and printed: gloo on the
CPU; on CUDA NCCL, unless ranks of the job share a card (more ranks than
this host's cards), which NCCL refuses, and then gloo on the card's
tensors.  A rank never drops to the CPU, a failed init or collective
raises, and the group's timeout is finite, so that a rank that dies ends
the job instead of hanging it.
"""

from __future__ import annotations

import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from kafka_ps_tpu_torch.parallel.mesh import worker_mesh
from kafka_ps_tpu_torch.utils.config import resolve_device

# seconds a rank waits at the rendezvous or in a collective for the others
JOB_TIMEOUT_S = 60.0


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               timeout_s: float = JOB_TIMEOUT_S) -> bool:
    """Join the job (the broker-rendezvous analogue).  No-op single-process
    run when unconfigured: returns False.

    Configuration precedence: explicit args > KPS_COORDINATOR (host:port
    of rank 0's store) / KPS_NUM_PROCESSES / KPS_PROCESS_ID env vars.  A
    configured job needs all three."""
    coordinator_address = (coordinator_address
                           or os.environ.get("KPS_COORDINATOR"))
    if num_processes is None and "KPS_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["KPS_NUM_PROCESSES"])
    if process_id is None and "KPS_PROCESS_ID" in os.environ:
        process_id = int(os.environ["KPS_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False          # single-process deployment
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "a job needs KPS_COORDINATOR, KPS_NUM_PROCESSES and "
            f"KPS_PROCESS_ID (got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r})")
    device = resolve_device()
    backend = "gloo"
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        device = torch.device("cuda", process_id % cards)
        torch.cuda.set_device(device)
        if num_processes <= cards:
            backend = "nccl"
    print(f"multihost: rank {process_id} of {num_processes} on {device}, "
          f"backend {backend}", file=sys.stderr, flush=True)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def shutdown() -> None:
    """Leave the job, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_worker_mesh():
    """1-D mesh over every rank of the job (a LocalMesh without one)."""
    return worker_mesh()


def local_worker_ids(num_workers: int, mesh=None) -> list[int]:
    """The logical workers this rank hosts.

    Workers are block-assigned to mesh positions, row-major (num_workers
    must be a multiple of the mesh size, parallel/bsp.py): position p owns
    workers [p*k, (p+1)*k), and rank r sits at position r.  The stream
    producer of this rank feeds exactly these."""
    mesh = mesh if mesh is not None else global_worker_mesh()
    n = mesh.size()
    if num_workers % n != 0:
        raise ValueError(
            f"num_workers {num_workers} must be a multiple of the mesh "
            f"size {n}")
    per_device = num_workers // n
    pos = process_index()
    if pos >= n:
        return []
    return list(range(pos * per_device, (pos + 1) * per_device))


def shard_worker_batches_global(mesh, local_x, local_y, local_mask,
                                device=None):
    """This rank's stacked slabs [k, ...] (its local_worker_ids order) on
    its device: under a job each rank holds only its own block, which is
    the whole of what the JAX package's global array puts on its
    devices."""
    dev = resolve_device(device)
    return tuple(torch.as_tensor(a).to(dev)
                 for a in (local_x, local_y, local_mask))


def unreplicate(x) -> np.ndarray:
    """A replicated tensor (every rank holds the same values) on the
    host."""
    return np.asarray(torch.as_tensor(x).detach().cpu())
