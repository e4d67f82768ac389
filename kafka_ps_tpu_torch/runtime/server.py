"""The parameter server (counterpart of kafka_ps_tpu/runtime/server.py).

State: the flat parameter vector on the device, a MessageTracker and the
consistency gate.  theta is updated by REPLACEMENT (`t + lr*d` out of
place, never `add_`), so weights messages, queued evaluations and gang
members can alias it without copies.  Aggregation: theta += server_lr *
delta with server_lr defaulting to 1/num_workers, which makes the BSP
update the average of the workers' deltas.

Evaluation runs on eval clocks of worker 0's gradients.  Without an eval
engine the apply and the test-set evaluation run together (fused); with
one attached (`attach_eval_engine`, evaluation/engine.py) the apply
hands (theta, clock) to the engine, which evaluates on its own thread
and calls `_emit_eval` back in clock order.  Either way the CSV row is
formatted when its device scalars resolve (utils/asynclog.DeferredSink).

Consistency dispatch:
  * eventual (-1): answer only the sender, at once;
  * sequential (0): when all gradients for clock t arrived, answer ALL
    workers with clock t+1;
  * bounded delay (k>0): answer every worker with an outstanding reply
    whose next clock is <= k ahead of the slowest worker.

Gang dispatch (cfg.use_gang, runtime/gang.py): a release of several
workers at one moment is also advertised as a GangNotice, and
`process_batch` applies queued gradients as one chained batch — bitwise
the per-message results.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from kafka_ps_tpu_torch.models.task import get_task
from kafka_ps_tpu_torch.parallel.tracker import MessageTracker
from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime.messages import (GangNotice, GradientMessage,
                                                 KeyRange, WeightsMessage)
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
        self.batched_applies = 0     # process_batch calls that chained
        self.eval_engine = None
        self._loop_started = False   # bootstrap broadcast done once

    def attach_eval_engine(self, engine):
        """Arm the async eval plane: eval-cadence applies stop fusing the
        eval and submit (theta, clock) to the engine, which calls
        `_emit_eval` back in clock order.  Returns the engine."""
        self.eval_engine = engine
        return engine

    def _apply_full(self, t: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        return t + self.cfg.server_lr * d

    def _apply_full_eval(self, t, d):
        """Apply + evaluation of the new theta, back to back on the
        device."""
        t2 = self._apply_full(t, d)
        return t2, self.task.evaluate(t2, self.test_x, self.test_y)

    def _emit_eval(self, clock: int, m) -> None:
        """The one eval emission point, for the fused paths and the
        engine's thread alike.  Schema: timestamp;partition;vectorClock;
        loss;fMeasure;accuracy with partition=-1 and the real test loss
        (the reference logs -1 there)."""
        asynclog.submit_or_write(
            self.log,
            f"{int(time.time() * 1000)};-1;{clock};"
            "{};{};{}", m.loss, m.f1, m.accuracy)

    # -- bootstrap ------------------------------------------------------------

    def start_training_loop(self) -> None:
        """Broadcast WeightsMessages to kick off the self-sustaining loop:
        every worker starts in the already-replied state and gets clock 0;
        the gate then releases whatever it permits (nothing, on a cold
        start).  The broadcast is one release moment: one gang notice
        covers it."""
        if self._loop_started:
            # resuming a drive loop: the in-flight messages are still in
            # the fabric, a second broadcast would double-deliver
            return
        self._loop_started = True
        released = []
        for worker, status in enumerate(self.tracker.tracker):
            if status.active and status.weights_message_sent:
                self.fabric.send(fabric_mod.WEIGHTS_TOPIC, worker,
                                 self._prepared_message(status.vector_clock,
                                                        self.theta))
                released.append((worker, status.vector_clock))
        released.extend(self._flush_gate(notify=False))
        self._emit_gang_notice(sorted(released))

    def _prepared_message(self, clock: int, theta) -> WeightsMessage:
        # theta is immutable by contract: safe to alias
        return WeightsMessage(vector_clock=clock, key_range=self._range,
                              values=theta)

    def send_weights(self, worker: int, clock: int) -> None:
        """The single weights-send site: dispatch + tracker bookkeeping."""
        self.fabric.send(fabric_mod.WEIGHTS_TOPIC, worker,
                         self._prepared_message(clock, self.theta))
        self.tracker.sent_message(worker, clock)

    def _send_weights_prepared(self, worker: int, clock: int,
                               theta) -> None:
        """Fabric send for a release whose tracker bookkeeping already ran
        (process_batch records it at gate-decision time and sends once
        the batched apply has produced the prefix theta the release
        observes)."""
        self.fabric.send(fabric_mod.WEIGHTS_TOPIC, worker,
                         self._prepared_message(clock, theta))

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

    def _flush_gate(self, notify: bool = True) -> list[tuple[int, int]]:
        """Send every reply the gate now permits; returns the release
        set.  `notify=False` leaves the gang notice to a caller that
        folds several release sources into one moment."""
        delay = self.cfg.max_vector_clock_delay
        if delay == EVENTUAL:
            return []
        release = sorted(self.tracker.get_all_sendable_messages(
            max(delay, 0)))
        for worker, clock in release:
            self.send_weights(worker, clock)
        if notify:
            self._emit_gang_notice(release)
        return release

    def _emit_gang_notice(self, release: list[tuple[int, int]]) -> None:
        """Advertise a multi-member release set on GANG_TOPIC, beside the
        per-worker messages (which remain the protocol)."""
        if self.cfg.use_gang and len(release) > 1:
            self.fabric.send_transient(fabric_mod.GANG_TOPIC, 0,
                                       GangNotice(members=tuple(release)))

    def dispatch_release_set(self, release) -> None:
        """Sorted per-worker sends (worker-id order keeps serial
        scheduling deterministic) plus the gang notice when several
        workers were released at one moment."""
        release = sorted(release)
        for worker, clock in release:
            self.send_weights(worker, clock)
        self._emit_gang_notice(release)

    # -- the hot path -----------------------------------------------------------

    def _check_range(self, msg: GradientMessage) -> None:
        r = msg.key_range
        if r.start != self._range.start or r.end != self._range.end:
            raise ValueError(
                f"gradient for keys [{r.start}, {r.end}): this server "
                f"applies the full range [0, {self._range.end}) only")

    def _wants_eval(self, msg: GradientMessage) -> bool:
        return (msg.worker_id == 0 and self.test_x is not None
                and msg.vector_clock % self.cfg.eval_every == 0)

    def process(self, msg: GradientMessage) -> None:
        self._check_range(msg)
        self.tracker.received_message(msg.worker_id, msg.vector_clock)
        want_eval = self._wants_eval(msg)
        fused_eval = want_eval and self.eval_engine is None
        if fused_eval:
            self.theta, m = self._apply_full_eval(self.theta, msg.values)
        else:
            self.theta = self._apply_full(self.theta, msg.values)
        self.iterations += 1
        if fused_eval:
            self._emit_eval(msg.vector_clock, m)
        elif want_eval:
            # immutable alias hand-off; the engine evaluates off this thread
            self.eval_engine.submit(self.theta, msg.vector_clock)
        self.dispatch_release_set(
            self.workers_to_respond_to(msg.vector_clock, msg.worker_id))

    def process_batch(self, msgs: list[GradientMessage]) -> None:
        """Apply several queued gradients as one chained batch — bitwise
        what `process` per message gives:
          * the gate runs incrementally per message, in queue order, and
            its tracker bookkeeping happens at decision time; the sends
            wait until the chain has produced each release's PREFIX
            theta, the theta after exactly the deltas the per-message
            path would have applied before it;
          * evals land at the same clocks, on the same prefix thetas, in
            the same row order;
          * the update is a chain `t = t + lr*d` in member order, never
            `deltas.sum(0)`: float addition does not associate.
        All the releases of the batch form one gang notice."""
        for m in msgs:
            self._check_range(m)
        if len(msgs) < 2:
            for m in msgs:
                self.process(m)
            return
        defer_eval = self.eval_engine is not None
        eval_at: dict[int, int] = {}              # position -> clock
        release_at: dict[int, list[tuple[int, int]]] = {}
        for i, m in enumerate(msgs):
            self.tracker.received_message(m.worker_id, m.vector_clock)
            if self._wants_eval(m):
                eval_at[i] = m.vector_clock
            release = sorted(self.workers_to_respond_to(m.vector_clock,
                                                        m.worker_id))
            for w, c in release:
                self.tracker.sent_message(w, c)
            if release:
                release_at[i] = release
        lr = self.cfg.server_lr
        t = self.theta
        batch_released: list[tuple[int, int]] = []
        for i, m in enumerate(msgs):
            t = t + lr * m.values
            if i in eval_at:
                if defer_eval:
                    self.eval_engine.submit(t, eval_at[i])
                else:
                    self._emit_eval(eval_at[i], self.task.evaluate(
                        t, self.test_x, self.test_y))
            for worker, clock in release_at.get(i, ()):
                self._send_weights_prepared(worker, clock, t)
                batch_released.append((worker, clock))
        self.theta = t
        self.iterations += len(msgs)
        self.batched_applies += 1
        self._emit_gang_notice(sorted(batch_released))
