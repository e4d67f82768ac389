"""Worker compute node (counterpart of kafka_ps_tpu/runtime/worker.py).

On each WeightsMessage: overwrite the local parameters with the server's,
bring the worker's device slab (f32, bf16 or int8 storage,
cfg.slab_dtype) up to date with its sliding buffer, run the k-step local
update (on the card: the family's CUDA kernel in ops/fused_update.py, K1
or K4 for an f32 slab, K3 or K5 for a reduced one) fused with the
evaluation of the updated model, log
the worker CSV row and send the delta back as a GradientMessage with the
same vector clock.

The iteration performs no host synchronization: theta, the delta and the
row's loss/F1/accuracy stay device tensors (utils/asynclog.DeferredSink
formats the row when they resolve).  An empty buffer raises
RuntimeError, as the reference does.

A weights message over a sub-range is spliced into the local replica (a
new tensor; the other keys keep their values).  With a `shard_router`
(runtime/sharding.ShardRouter, set for a range-sharded server group or
an aggregation relay) the outgoing delta and its redelivery resend go
through the router instead of the fabric.

Telemetry (tracer=, telemetry=; null by default): the
`worker.local_update` span around the kernel call and a
`dispatch.device` count per call, `worker_updates_total{worker}` per
iteration and `worker_update_ms{worker}`, the host time of the call.
The span and the histogram time the kernel's LAUNCH: nothing waits on
the device to take them (its time is what `--device_trace` records).
With a model-health plane set (`modelhealth`, split mode's
--model-health) every row's loss and F1 go to it as they are, tensors
included: its sampler thread resolves them.
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
from kafka_ps_tpu_torch.telemetry.modelhealth import NULL_MODEL_HEALTH
from kafka_ps_tpu_torch.telemetry.registry import NULL_TELEMETRY
from kafka_ps_tpu_torch.utils import asynclog
from kafka_ps_tpu_torch.utils.config import ModelConfig, PSConfig
from kafka_ps_tpu_torch.utils.trace import NULL_TRACER

LogSink = Callable[[str], None]


# the single-worker kernel of each task family (K1/K3, K4/K5 by slab form)
SOLVERS = {"logreg": fused_update.local_update,
           "mlp": fused_update.mlp_local_update}


@functools.lru_cache(maxsize=None)
def _solver_fns(task_name: str, cfg: ModelConfig):
    """(update, update_and_eval) for one (task, cfg), shared by every
    WorkerNode.  `update` is the family's kernel wrapper (K1 or K3 for
    logreg, K4 or K5 for the MLP, by the slab's storage form): the CUDA
    kernel for tensors on the card, its plain version for CPU tensors.  `update_and_eval` also evaluates theta +
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
                 log: LogSink | None = None, tracer=None, telemetry=None):
        self.tracer = tracer or NULL_TRACER
        self.telemetry = telemetry or NULL_TELEMETRY
        # resolved here: one leaf-lock inc / observe per iteration with
        # telemetry on, nothing with it off
        self._m_updates = self.telemetry.counter(
            "worker_updates_total", worker=str(worker_id))
        self._m_update_ms = self.telemetry.histogram(
            "worker_update_ms", worker=str(worker_id))
        # model-health plane (telemetry/modelhealth.py): a split-mode
        # worker process's one plane over its rows, set by the CLI
        self.modelhealth = NULL_MODEL_HEALTH
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
        # device slab in cfg.slab_dtype storage, keyed by the buffer's
        # mutation counter: steady state uploads only the dirty rows
        # (unless cfg.slab_incremental is off)
        self._slab_version: int | None = None
        self._slab_store = SlabStore(cfg.slab_dtype, buffer.cfg.max_size,
                                     buffer.num_features, self.device,
                                     telemetry=self.telemetry)
        self.iterations = 0
        # iterations counted at (re)admission: the supervisor grants the
        # first iteration SINCE joining its 10x grace (runtime/app.py)
        self.iterations_at_join = 0
        # heartbeat read by the supervisor: the monotonic time of the
        # last iteration started or finished
        self.last_progress = time.monotonic()
        # gradient-side compression (compress.ErrorFeedback), set by the
        # app when cfg.compress != "none"
        self.compressor = None
        # (clock, GradientMessage) of the newest compressed send: a
        # restart may redeliver a weights clock this worker already
        # trained on, and the residual must advance once per clock
        # (_redelivered_weights)
        self._last_sent = None
        self.redelivered = 0         # redelivered clocks answered from it
        # range sharding / relays: splits each delta into per-shard
        # slices (None: the unsharded send)
        self.shard_router = None

    def _prepare(self, msg: WeightsMessage):
        """Pre-dispatch half of an iteration: theta overwrite, slab
        update.  Returns (theta, x, y, mask, num_tuples_seen,
        want_eval)."""
        # heartbeat: a slow iteration is measured from its own start
        self.last_progress = time.monotonic()
        r = msg.key_range
        if r.start == 0 and r.end == self.task.num_params:
            # the server's theta is replaced, never mutated, so aliasing
            # it is safe
            self.theta = msg.values
        else:
            if r.end > self.task.num_params:
                raise ValueError(
                    f"weights for keys [{r.start}, {r.end}) outside the "
                    f"model's [0, {self.task.num_params})")
            t = self.theta
            self.theta = torch.cat([t[:r.start],
                                    msg.values.to(t.device, t.dtype),
                                    t[r.end:]])

        seen = self.buffer.num_tuples_seen
        if self.buffer.count == 0:
            raise RuntimeError(
                f"There is no data in the buffer of worker {self.worker_id}")
        ver = self.buffer.version
        if ver != self._slab_version:
            store = self._slab_store
            if not (self.cfg.slab_incremental and store.ready):
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
        if self.modelhealth.enabled:
            self.modelhealth.observe_eval(loss, f1)
        encoded = None
        if self.compressor is not None:
            # the server applies the DECODED delta; the quantization
            # error stays here as the residual of the next iteration
            delta, encoded = self.compressor.step(delta)
        out = GradientMessage(
            vector_clock=msg.vector_clock,
            key_range=KeyRange(0, self.task.num_params),
            values=delta, encoded=encoded, worker_id=self.worker_id)
        self._send(out)
        if self.compressor is not None:
            self._last_sent = (msg.vector_clock, out)
        if self.telemetry.enabled:
            self._m_updates.inc()
        self.last_progress = time.monotonic()

    def _redelivered_weights(self, msg: WeightsMessage) -> bool:
        """True when `msg` is a weights clock this worker already trained
        on and the step must NOT run again.  Only compressed workers
        dedup: a second step would advance the error-feedback residual
        twice for one clock.  The newest clock's cached gradient is sent
        again, so a gate waiting on this worker still completes (the
        server's duplicate filter drops it if the original got through);
        older clocks are dropped."""
        if self.compressor is None:
            return False
        last = self._last_sent
        if last is None or msg.vector_clock > last[0]:
            return False
        if msg.vector_clock == last[0]:
            self._send(last[1])
        self.redelivered += 1
        return True

    def _send(self, out: GradientMessage) -> None:
        if self.shard_router is not None:
            # per-shard slices, cached for a recovering shard's resend
            self.shard_router.route(out)
        else:
            self.fabric.send(fabric_mod.GRADIENTS_TOPIC, 0, out)

    def on_weights(self, msg: WeightsMessage) -> None:
        if self._redelivered_weights(msg):
            return
        theta, x, y, mask, seen, want_eval = self._prepare(msg)
        update_fn, update_eval_fn = _solver_fns(self.cfg.task,
                                                self.cfg.model)
        # off-cadence clocks log the reference's -1 "not computed"
        f1, acc = -1.0, -1.0
        t0 = time.perf_counter()
        with self.tracer.span("worker.local_update", worker=self.worker_id,
                              clock=msg.vector_clock):
            if want_eval:
                delta, loss, f1, acc = update_eval_fn(
                    theta, x, y, mask, self.test_x, self.test_y)
            else:
                delta, loss = update_fn(theta, x, y, mask)
        self.tracer.count("dispatch.device")
        if self.telemetry.enabled:
            # the launch's host time: nothing syncs the device for it
            self._m_update_ms.observe((time.perf_counter() - t0) * 1e3)
        self._finish(msg, seen, delta, loss, f1, acc)

