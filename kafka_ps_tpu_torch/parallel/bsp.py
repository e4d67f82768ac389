"""Fused BSP training step (counterpart of kafka_ps_tpu/parallel/bsp.py).

The sequential consistency model as one device program per round: every
worker runs the k-step local solver on its buffer slab from the same
theta, and the server applies the sum of the deltas,

    theta' = theta + server_lr * sum_i delta_i,   loss = sum_i loss_i / N,

which is the message-driven sequential round (runtime/server.py,
consistency 0, server_lr = 1/N) without the messages.  Where the JAX
package vmaps its local update over the worker axis, the port runs the
family's gang kernel: one K2 call (`fused_update.local_update_batched`)
for logreg, one K6 call (`mlp_local_update_batched`) for the MLP, every
member reading the one theta tensor.  CPU tensors run the kernels' plain
versions, as everywhere in the port.

`make_bsp_multi_step` runs `rounds` rounds per call (the JAX package's
`lax.scan`).  On the card it replays them as one captured CUDA graph: the
graph is captured at the first call for a (slab shape, device), on
static copies of theta and the slabs; a call copies theta into its
static input, and the slabs only when they are other tensors or were
written since the last call.  The rounds inside are the single step's
launches in the single step's order, so a chunk is bitwise `rounds`
single steps.  A failed capture raises.

With a mesh of a job (parallel/mesh.py; the JAX package's `shard_map`
branch) each rank holds its block of N/d workers (`shard_worker_batches`),
runs the gang kernel on it, and all-reduces the delta sum and the loss
sum over the workers axis before the apply; every rank issues the same
collectives in the same order.  The multi-round step then runs its rounds
eagerly, one all-reduce per round: no CUDA graph holds a collective.  A
LocalMesh (no job) is the one-device branch, unchanged.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from kafka_ps_tpu_torch.models.mlp import MLPTask
from kafka_ps_tpu_torch.models.task import LogRegTask, get_task
from kafka_ps_tpu_torch.ops import fused_update
from kafka_ps_tpu_torch.parallel.mesh import WORKER_AXIS, in_job
from kafka_ps_tpu_torch.utils.config import ModelConfig, resolve_device

# step(theta, x, y, mask) -> (theta', mean_loss)
#   theta: [P]; x: [N, cap, F]; y: [N, cap]; mask: [N, cap]
BspStep = Callable[..., tuple[torch.Tensor, torch.Tensor]]

# the gang kernel of each task family
_BATCHED = {LogRegTask: fused_update.local_update_batched,
            MLPTask: fused_update.mlp_local_update_batched}


def gang_kernel(task):
    """The wrapper of `task`'s gang kernel: K2 for logreg, K6 for the
    MLP."""
    return _BATCHED[type(task)]


def make_bsp_step(cfg: ModelConfig, num_workers: int, server_lr: float,
                  mesh=None, task=None) -> BspStep:
    """The fused one-round BSP step: one gang kernel call over the
    workers' slabs, then the server's apply.  With a mesh of a job, the
    slabs are this rank's block and the sums are all-reduced over the
    workers axis first."""
    task = task or get_task("logreg", cfg)
    batched = gang_kernel(task)
    group = None
    if in_job(mesh):
        if num_workers % mesh.size() != 0:
            raise ValueError(
                f"num_workers {num_workers} must be a multiple of mesh "
                f"size {mesh.size()}")
        group = mesh.get_group(WORKER_AXIS)

    def step(theta, x, y, mask):
        deltas, losses = batched([theta] * len(x), x, y, mask, cfg=cfg)
        if group is None:
            return (theta + server_lr * deltas.sum(0),
                    losses.sum() / num_workers)
        # one reduction carries the delta sum and the loss sum
        sums = torch.cat([deltas.sum(0), losses.sum()[None]])
        dist.all_reduce(sums, group=group)
        return theta + server_lr * sums[:-1], sums[-1] / num_workers

    return step


class _Graph:
    """`rounds` rounds captured as one CUDA graph on static inputs."""

    def __init__(self, one_round, rounds: int, theta, x, y, mask):
        self.theta = theta.clone()
        self.slab = tuple(a.clone() for a in (x, y, mask))
        # the tensors the slab was copied from, and their versions then
        self.source = tuple((a, a._version) for a in (x, y, mask))
        before = fused_update.counts()
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: the log drain threads may fetch finished rows
        # while this thread captures
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            t, losses = self.theta, []
            for _ in range(rounds):
                t, loss = one_round(t, *self.slab)
                losses.append(loss)
            self.out = (t, torch.stack(losses))
        # a capture launches nothing: its wrapper calls are counted at
        # each replay instead
        self.launches = {k: v - before[k]
                         for k, v in fused_update.counts().items()
                         if v != before[k]}
        fused_update.add_counts({k: -v for k, v in self.launches.items()})

    def __call__(self, theta, x, y, mask):
        self.theta.copy_(theta)
        if any(a is not src or a._version != ver
               for a, (src, ver) in zip((x, y, mask), self.source)):
            for dst, a in zip(self.slab, (x, y, mask)):
                dst.copy_(a)
            self.source = tuple((a, a._version) for a in (x, y, mask))
        self.graph.replay()
        fused_update.add_counts(self.launches)
        # the graph writes its outputs in place at every replay
        return self.out[0].clone(), self.out[1].clone()


class MultiStep:
    """`rounds` fused BSP rounds per call → (theta, losses[rounds]).  On
    the card one graph replay per call (`captures` counts the graphs
    captured); on the CPU, or with `graph=False` (rounds that hold
    collectives), the rounds run one after the other."""

    def __init__(self, one_round, rounds: int, graph: bool = True):
        self.one_round = one_round
        self.rounds = rounds
        self.graph = graph
        self._graphs: dict = {}
        self.captures = 0

    def __call__(self, theta, x, y, mask):
        if x.device.type != "cuda" or not self.graph:
            losses = []
            for _ in range(self.rounds):
                theta, loss = self.one_round(theta, x, y, mask)
                losses.append(loss)
            return theta, torch.stack(losses)
        key = (x.device, tuple(x.shape), x.dtype, tuple(theta.shape))
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = _Graph(self.one_round, self.rounds,
                                               theta, x, y, mask)
            self.captures += 1
        return graph(theta, x, y, mask)


def make_bsp_multi_step(cfg: ModelConfig, num_workers: int, server_lr: float,
                        rounds: int, mesh=None, task=None) -> MultiStep:
    """`rounds` BSP rounds as one dispatch: on the card one CUDA graph
    replay (eager rounds with a mesh of a job); bitwise `rounds` calls of
    make_bsp_step's step."""
    return MultiStep(make_bsp_step(cfg, num_workers, server_lr, mesh=mesh,
                                   task=task),
                     rounds, graph=not in_job(mesh))


def shard_worker_batches(mesh, x, y, mask, device=None):
    """This rank's block of the stacked per-worker slabs [N, ...] (the
    workers axis split over the mesh's ranks, row-major), on its
    device."""
    dev = resolve_device(device)
    k = len(x) // mesh.size()
    pos = mesh.get_local_rank(WORKER_AXIS)
    return tuple(torch.as_tensor(np.asarray(a[pos * k:(pos + 1) * k])).to(dev)
                 for a in (x, y, mask))
