"""The parameter server, per-message path (counterpart of
kafka_ps_tpu/runtime/server.py).

State: the flat parameter vector on the device, a MessageTracker and the
consistency gate.  theta is updated by REPLACEMENT (`t + lr*d` out of
place, never `add_`), so weights messages and evaluations can alias it
without copies.  Aggregation: theta += server_lr * delta with server_lr
defaulting to 1/num_workers, which makes the BSP update the average of
the workers' deltas.  On eval clocks of worker 0's gradients the apply
and the test-set evaluation run together; the CSV row is formatted when
its device scalars resolve (utils/asynclog.DeferredSink).

Consistency dispatch:
  * eventual (-1): answer only the sender, at once;
  * sequential (0): when all gradients for clock t arrived, answer ALL
    workers with clock t+1;
  * bounded delay (k>0): answer every worker with an outstanding reply
    whose next clock is <= k ahead of the slowest worker.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from kafka_ps_tpu_torch.models.task import get_task
from kafka_ps_tpu_torch.parallel.tracker import MessageTracker
from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime.messages import (GradientMessage, KeyRange,
                                                 WeightsMessage)
from kafka_ps_tpu_torch.utils import asynclog
from kafka_ps_tpu_torch.utils.config import EVENTUAL, PSConfig

LogSink = Callable[[str], None]


class ServerNode:
    """Central aggregator + consistency gate + online evaluator."""

    def __init__(self, cfg: PSConfig, fabric: fabric_mod.Fabric, device,
                 test_x=None, test_y=None, log: LogSink | None = None):
        self.cfg = cfg
        self.fabric = fabric
        self.device = torch.device(device)
        self.tracker = MessageTracker(cfg.num_workers)
        self.task = get_task(cfg.task, cfg.model)
        self._range = KeyRange(0, self.task.num_params)
        self.theta = self.task.init_params(self.device)
        self.test_x = (None if test_x is None else torch.as_tensor(
            test_x, dtype=torch.float32, device=self.device))
        self.test_y = (None if test_y is None else torch.as_tensor(
            test_y, dtype=torch.int32, device=self.device))
        self.log = log or (lambda line: None)
        self.iterations = 0          # total gradient messages applied
        self._loop_started = False   # bootstrap broadcast done once

    def _apply_full(self, t: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        return t + self.cfg.server_lr * d

    def _apply_full_eval(self, t, d):
        """Apply + evaluation of the new theta, back to back on the
        device."""
        t2 = self._apply_full(t, d)
        return t2, self.task.evaluate(t2, self.test_x, self.test_y)

    def _emit_eval(self, clock: int, m) -> None:
        """The eval emission point.  Schema: timestamp;partition;
        vectorClock;loss;fMeasure;accuracy with partition=-1 and the real
        test loss (the reference logs -1 there)."""
        asynclog.submit_or_write(
            self.log,
            f"{int(time.time() * 1000)};-1;{clock};"
            "{};{};{}", m.loss, m.f1, m.accuracy)

    # -- bootstrap ------------------------------------------------------------

    def start_training_loop(self) -> None:
        """Broadcast WeightsMessages to kick off the self-sustaining loop:
        every worker starts in the already-replied state and gets clock 0;
        the gate then releases whatever it permits (nothing, on a cold
        start)."""
        if self._loop_started:
            # resuming a drive loop: the in-flight messages are still in
            # the fabric, a second broadcast would double-deliver
            return
        self._loop_started = True
        for worker, status in enumerate(self.tracker.tracker):
            if status.active and status.weights_message_sent:
                self.fabric.send(fabric_mod.WEIGHTS_TOPIC, worker,
                                 self._weights_message(status.vector_clock))
        self._flush_gate()

    def _weights_message(self, vector_clock: int) -> WeightsMessage:
        # theta is immutable by contract: safe to alias
        return WeightsMessage(vector_clock=vector_clock,
                              key_range=self._range, values=self.theta)

    def send_weights(self, worker: int, clock: int) -> None:
        """The single weights-send site: dispatch + tracker bookkeeping."""
        self.fabric.send(fabric_mod.WEIGHTS_TOPIC, worker,
                         self._weights_message(clock))
        self.tracker.sent_message(worker, clock)

    # -- consistency gate -----------------------------------------------------

    def workers_to_respond_to(self, received_vc: int,
                              sender: int) -> set[tuple[int, int]]:
        delay = self.cfg.max_vector_clock_delay
        if delay == EVENTUAL:
            return {(sender, received_vc + 1)}
        if delay == 0:
            if self.tracker.has_received_all_messages(received_vc):
                return {(w, received_vc + 1)
                        for w in self.tracker.active_workers}
            return set()
        return set(self.tracker.get_all_sendable_messages(delay))

    def _flush_gate(self) -> list[tuple[int, int]]:
        """Send every reply the gate now permits; returns the release
        set."""
        delay = self.cfg.max_vector_clock_delay
        if delay == EVENTUAL:
            return []
        release = sorted(self.tracker.get_all_sendable_messages(
            max(delay, 0)))
        for worker, clock in release:
            self.send_weights(worker, clock)
        return release

    def dispatch_release_set(self, release) -> None:
        """Sorted per-worker sends: worker-id order keeps serial
        scheduling deterministic."""
        for worker, clock in sorted(release):
            self.send_weights(worker, clock)

    # -- the hot path -----------------------------------------------------------

    def process(self, msg: GradientMessage) -> None:
        r = msg.key_range
        if r.start != self._range.start or r.end != self._range.end:
            raise ValueError(
                f"gradient for keys [{r.start}, {r.end}): this server "
                f"applies the full range [0, {self._range.end}) only")
        self.tracker.received_message(msg.worker_id, msg.vector_clock)
        want_eval = (msg.worker_id == 0 and self.test_x is not None
                     and msg.vector_clock % self.cfg.eval_every == 0)
        if want_eval:
            self.theta, m = self._apply_full_eval(self.theta, msg.values)
        else:
            self.theta = self._apply_full(self.theta, msg.values)
        self.iterations += 1
        if want_eval:
            self._emit_eval(msg.vector_clock, m)
        self.dispatch_release_set(
            self.workers_to_respond_to(msg.vector_clock, msg.worker_id))
