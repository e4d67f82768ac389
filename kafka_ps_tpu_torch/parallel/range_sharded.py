"""Range-sharded parameter server over a workers × params mesh
(counterpart of kafka_ps_tpu/parallel/range_sharded.py): the reference's
latent KeyRange axis made real.

The parameter vector is padded to a multiple of the params axis and each
rank keeps one key range of it, the shard at its params coordinate
(replicated over the workers axis); logical workers are sharded over
BOTH axes, row-major, so every rank trains.  One round, on every rank:

    all_gather the shards over the params sub-group  → full θ (the pull)
    the family's gang kernel (K2 logreg, K6 MLP) on the full θ for this
      rank's workers, each delta zero-padded past num_params
    all_reduce of the delta sum and the loss sum over the whole mesh
      (the workers sub-group, then the params sub-group: every rank ends
      with the same bits)
    keep this rank's slice: θ_shard + server_lr · slice  (the push)

Where the JAX package runs this single-process over local devices with
shard_map, the port runs it inside a job, one rank per device
(parallel/multihost.py); on a LocalMesh (no job) every collective is the
identity.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from kafka_ps_tpu_torch.models.task import get_task
from kafka_ps_tpu_torch.parallel import bsp
from kafka_ps_tpu_torch.parallel.mesh import PARAM_AXIS, WORKER_AXIS, axes
from kafka_ps_tpu_torch.utils.config import ModelConfig, resolve_device


def padded_num_params(layout, num_param_shards: int) -> int:
    """theta length padded so every param shard is equal-size (the pad
    keys are dead weight ignored by unflatten).  `layout` is anything
    with `.num_params`: a ModelConfig (logreg's layout) or a task."""
    p = layout.num_params
    return p + (-p) % num_param_shards


def pad_theta(theta, layout, num_param_shards: int) -> torch.Tensor:
    theta = torch.as_tensor(theta)
    return F.pad(theta, (0, padded_num_params(layout, num_param_shards)
                         - layout.num_params))


def _param_shards(mesh) -> int:
    return axes(mesh)[PARAM_AXIS]


def shard_theta(mesh, theta, layout) -> torch.Tensor:
    """This rank's key range of the padded parameter vector (a copy),
    the shard at its params coordinate."""
    shards = _param_shards(mesh)
    full = pad_theta(theta, layout, shards)
    n = full.shape[0] // shards
    p = mesh.get_local_rank(PARAM_AXIS)
    return full[p * n:(p + 1) * n].clone()


def shard_worker_batches(mesh, x, y, mask, device=None):
    """This rank's block of the stacked worker slabs [N, ...], workers
    sharded over BOTH mesh axes in row-major rank order (the JAX
    package's P((workers, params)) device order), on its device."""
    dev = resolve_device(device)
    n = mesh.size()
    pos = mesh.get_local_rank(WORKER_AXIS) * _param_shards(mesh) \
        + mesh.get_local_rank(PARAM_AXIS)
    k = len(x) // n
    return tuple(torch.as_tensor(np.asarray(a[pos * k:(pos + 1) * k])).to(dev)
                 for a in (x, y, mask))


def gather_theta(mesh, theta_shard: torch.Tensor) -> torch.Tensor:
    """The full padded parameter vector from every rank's shard (an
    all_gather over the params sub-group; the shard itself on one)."""
    group = mesh.get_group(PARAM_AXIS)
    if group is None or dist.get_world_size(group) == 1:
        return theta_shard.clone()
    parts = [torch.empty_like(theta_shard)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, theta_shard.contiguous(), group=group)
    return torch.cat(parts)


def _sum_over_mesh(mesh, t: torch.Tensor) -> torch.Tensor:
    """`t` summed over every rank of the mesh, in place."""
    for axis in (WORKER_AXIS, PARAM_AXIS):
        group = mesh.get_group(axis)
        if group is not None:
            dist.all_reduce(t, group=group)
    return t


# step(theta_shard, x, y, mask) -> (theta_shard', mean_loss | losses[rounds])
RangeShardedStep = Callable[..., tuple[torch.Tensor, torch.Tensor]]


def make_range_sharded_step(cfg: ModelConfig, num_workers: int,
                            server_lr: float, mesh, rounds: int = 1,
                            task=None) -> RangeShardedStep:
    """Fused BSP round(s) with range-sharded parameters on a 2-D
    (workers × params) mesh.  `rounds > 1` runs that many rounds per call
    and returns the per-round losses, like bsp.make_bsp_multi_step (on
    the rounds' collectives, eagerly: no CUDA graph)."""
    shape = axes(mesh)
    if WORKER_AXIS not in shape or PARAM_AXIS not in shape:
        raise ValueError(
            f"mesh must have axes ({WORKER_AXIS!r}, {PARAM_AXIS!r}), "
            f"got {shape}")
    num_devices = shape[WORKER_AXIS] * shape[PARAM_AXIS]
    if num_workers % num_devices != 0:
        raise ValueError(
            f"num_workers {num_workers} must be a multiple of the mesh "
            f"size {num_devices} (workers are sharded over both axes)")
    task = task or get_task("logreg", cfg)
    batched = bsp.gang_kernel(task)
    n_real = task.num_params
    param_shards = shape[PARAM_AXIS]
    n_pad = padded_num_params(task, param_shards)
    shard_len = n_pad // param_shards
    lo = mesh.get_local_rank(PARAM_AXIS) * shard_len

    def step(theta_shard, x, y, mask):
        theta_full = gather_theta(mesh, theta_shard)[:n_real]
        deltas, losses = batched([theta_full] * len(x), x, y, mask, cfg=cfg)
        # one reduction carries the padded delta sum and the loss sum
        sums = _sum_over_mesh(mesh, torch.cat([
            F.pad(deltas.sum(0), (0, n_pad - n_real)), losses.sum()[None]]))
        return (theta_shard + server_lr * sums[lo:lo + shard_len],
                sums[n_pad] / num_workers)

    return step if rounds == 1 else bsp.MultiStep(step, rounds, graph=False)


def assert_pad_clean(theta_padded, layout) -> None:
    """Pad-hygiene invariant: the pad keys appended by `pad_theta` are
    DEAD — every delta is zero-padded, so nothing may ever land there.  A
    nonzero pad region means a delta leaked past `num_params` (a kernel
    writing out of its logical range, or a theta padded from a wrong
    layout), and the real parameters next to the boundary can no longer
    be trusted.  unshard_theta would silently drop the evidence; this
    check turns the leak into an error at the unshard boundary."""
    n = layout.num_params
    pad = np.asarray(torch.as_tensor(theta_padded)[n:].detach().cpu())
    if pad.size and np.any(pad != 0):
        bad = int(np.flatnonzero(pad)[0])
        raise ValueError(
            f"delta leaked into the shard pad region: key {n + bad} "
            f"(pad begins at {n}, padded length {len(theta_padded)}) "
            f"holds {float(pad[bad])!r}, expected 0")


def unshard_theta(theta_padded, layout) -> torch.Tensor:
    """Back to the flat layout (drops the shard padding) from the full
    padded vector (`gather_theta`): a new tensor on its device, after
    asserting that the pad it drops is clean (assert_pad_clean)."""
    assert_pad_clean(theta_padded, layout)
    return torch.as_tensor(theta_padded)[:layout.num_params].clone()
