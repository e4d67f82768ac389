"""Worker compute node (counterpart of kafka_ps_tpu/runtime/worker.py).

On each WeightsMessage: overwrite the local parameters with the server's,
bring the worker's device slab up to date with its sliding buffer, run
the k-step local update (on the card: the family's CUDA kernel in
ops/fused_update.py) fused with the evaluation of the updated model, log
the worker CSV row and send the delta back as a GradientMessage with the
same vector clock.

The iteration performs no host synchronization: theta, the delta and the
row's loss/F1/accuracy stay device tensors (utils/asynclog.DeferredSink
formats the row when they resolve).  An empty buffer raises
RuntimeError, as the reference does.
"""

from __future__ import annotations

import functools
import time
from typing import Callable

import torch

from kafka_ps_tpu_torch.compress.slab import SlabStore
from kafka_ps_tpu_torch.data.buffer import SlidingBuffer
from kafka_ps_tpu_torch.models.task import get_task
from kafka_ps_tpu_torch.ops import fused_update
from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime.messages import (GradientMessage, KeyRange,
                                                 WeightsMessage)
from kafka_ps_tpu_torch.utils import asynclog
from kafka_ps_tpu_torch.utils.config import ModelConfig, PSConfig

LogSink = Callable[[str], None]


# the single-worker kernel of each task family (K1, K4)
SOLVERS = {"logreg": fused_update.local_update,
           "mlp": fused_update.mlp_local_update}


@functools.lru_cache(maxsize=None)
def _solver_fns(task_name: str, cfg: ModelConfig):
    """(update, update_and_eval) for one (task, cfg), shared by every
    WorkerNode.  `update` is the family's kernel wrapper (K1 for logreg,
    K4 for the MLP): the CUDA kernel for tensors on the card, its plain
    version for CPU tensors.  `update_and_eval` also evaluates theta +
    delta on the test set, as the reference evaluates each worker's
    post-fit model."""
    task = get_task(task_name, cfg)
    solver = SOLVERS[task_name]

    def update_fn(theta, x, y, mask):
        return solver(theta, x, y, mask, cfg=cfg)

    def update_and_eval(theta, x, y, mask, test_x, test_y):
        delta, loss = update_fn(theta, x, y, mask)
        m = task.evaluate(theta + delta, test_x, test_y)
        return delta, loss, m.f1, m.accuracy

    return update_fn, update_and_eval


def _as_device(a, device, dtype):
    if a is None:
        return None
    return torch.as_tensor(a, dtype=dtype, device=device)


class WorkerNode:
    """One logical worker: private buffer + full model replica + local
    solver."""

    def __init__(self, worker_id: int, cfg: PSConfig,
                 fabric: fabric_mod.Fabric, buffer: SlidingBuffer,
                 device, test_x=None, test_y=None,
                 log: LogSink | None = None):
        self.worker_id = worker_id
        self.cfg = cfg
        self.fabric = fabric
        self.buffer = buffer
        self.device = torch.device(device)
        self.task = get_task(cfg.task, cfg.model)
        self.theta = self.task.init_params(self.device)
        self.test_x = _as_device(test_x, self.device, torch.float32)
        self.test_y = _as_device(test_y, self.device, torch.int32)
        self.log = log or (lambda line: None)
        # device slab keyed by the buffer's mutation counter: steady
        # state uploads only the dirty rows
        self._slab_version: int | None = None
        self._slab_store = SlabStore(buffer.cfg.max_size,
                                     buffer.num_features, self.device)
        self.iterations = 0

    def _prepare(self, msg: WeightsMessage):
        """Pre-dispatch half of an iteration: theta overwrite, slab
        update.  Returns (theta, x, y, mask, num_tuples_seen,
        want_eval)."""
        r = msg.key_range
        if r.start != 0 or r.end != self.task.num_params:
            raise ValueError(
                f"weights for keys [{r.start}, {r.end}): this worker takes "
                f"the full range [0, {self.task.num_params}) only")
        # the server's theta is replaced, never mutated, so aliasing it
        # is safe
        self.theta = msg.values

        seen = self.buffer.num_tuples_seen
        if self.buffer.count == 0:
            raise RuntimeError(
                f"There is no data in the buffer of worker {self.worker_id}")
        ver = self.buffer.version
        if ver != self._slab_version:
            store = self._slab_store
            if not store.ready:
                store.upload_full(*self.buffer.snapshot(clear_dirty=True))
            else:
                slots, xr, yr, mr = self.buffer.drain_dirty()
                if 2 * len(slots) >= store.capacity:
                    # mass churn: one contiguous upload beats a near-full
                    # scatter
                    store.upload_full(*self.buffer.snapshot(clear_dirty=True))
                elif len(slots):
                    store.apply_rows(slots, xr, yr, mr)
            self._slab_version = ver
        x, y, mask = self._slab_store.arrays()
        want_eval = (self.test_x is not None
                     and msg.vector_clock % self.cfg.eval_every == 0)
        return self.theta, x, y, mask, seen, want_eval

    def _finish(self, msg: WeightsMessage, seen: int,
                delta, loss, f1, acc) -> None:
        """Post-dispatch half: the worker CSV row (fields stay device
        tensors), the iteration count and the GradientMessage."""
        # schema: timestamp;partition;vectorClock;loss;fMeasure;accuracy;
        # numTuplesSeen
        asynclog.submit_or_write(
            self.log,
            f"{int(time.time() * 1000)};{self.worker_id};"
            f"{msg.vector_clock};{{}};{{}};{{}};{seen}",
            loss, f1, acc)
        self.iterations += 1
        self.fabric.send(fabric_mod.GRADIENTS_TOPIC, 0, GradientMessage(
            vector_clock=msg.vector_clock,
            key_range=KeyRange(0, self.task.num_params),
            values=delta,
            worker_id=self.worker_id))

    def on_weights(self, msg: WeightsMessage) -> None:
        theta, x, y, mask, seen, want_eval = self._prepare(msg)
        update_fn, update_eval_fn = _solver_fns(self.cfg.task,
                                                self.cfg.model)
        # off-cadence clocks log the reference's -1 "not computed"
        f1, acc = -1.0, -1.0
        if want_eval:
            delta, loss, f1, acc = update_eval_fn(
                theta, x, y, mask, self.test_x, self.test_y)
        else:
            delta, loss = update_fn(theta, x, y, mask)
        self._finish(msg, seen, delta, loss, f1, acc)

