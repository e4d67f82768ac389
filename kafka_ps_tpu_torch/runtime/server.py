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

Membership: `remove_worker` evicts a failed worker (every gate stops
waiting for it; its in-flight gradients are dropped as zombies) and
`readmit_worker` rejoins it at the slowest active clock.  A gradient
whose clock the tracker already passed is a redelivery and is dropped.
Checkpoints (utils/checkpoint.py) are written every `checkpoint_every`
applied iterations when `checkpoint_path` is set; on a durable fabric
each is a commit point of the log.  A restored server re-issues its
workers' current clocks through `start_training_loop`, except where a
replayed reply is already queued.
With compression on (`compressor`, compress/codecs.WeightsCompressor)
every WeightsMessage carries the quantize-dequantized theta and its
encoded parts; the master theta stays full precision.

Serving (serving/): with a SnapshotRegistry attached (`serving`), every
gate release publishes (theta, stable clock): the per-message and gang
releases, the bootstrap broadcast, a membership flush and the fused
loop's chunk boundaries (runtime/app.py).  A snapshot aliases theta,
which no path writes in place, so publishing copies nothing, waits on
nothing and leaves training bitwise as it is; a gang publishes each
release's prefix theta at the clock its gate decision saw, the sequence
the per-message path publishes.

Range sharding (runtime/sharding.py): a node built with `key_range` owns
that slice of the flat vector, polls its gradients under `grad_key` and
answers with weights slices over its range.  A dense slice of its range
applies as `t + lr*d`; a SparseDeltaMessage as a new tensor with
theta[idx] + lr*vals written at its (unique, sorted) indices, and an
empty one advances the gate with no device work; a gradient over a
sub-range is spliced into a new tensor.  The defaults (the full range,
shard 0 of 1, key 0) are the unsharded node.

Aggregation relays (agg/): a CompositeDelta advances every member's
clock as if its deltas had come one by one.  Stacked members apply in
member order: under BSP through the round buffer (`_agg_pending`), whole
rounds in worker-id order, which `bsp_order` extends to direct
gradients; otherwise through `process_batch`.  A summed composite is one
apply for all its members.  A member whose clock was applied already
(a restarted relay's resend) gets the current weights again, at most
once per composite.  `weights_group_send` (the socket bridge's grouped
fan-out) may claim a release set and ship it in one frame per relay.

Tiered residency (store/): with a TieredParamStore attached
(`attach_param_store`) the store owns the slice and `theta` is a
property: the getter assembles a new tensor on the server's device from
the pages (hot pages as they are, warm ones uploaded, cold ones read
from the log), the setter scatters into them.  A dense apply runs per
page, the same `t + lr*d` on the device for hot and warm pages alike,
so each element is bitwise the whole-slice apply; an eval apply runs the
whole-slice apply and evaluation on the assembled slice and scatters the
result back; a sparse slice applies per touched page.  `process_batch`
then runs per message, bitwise by the gang contract.  Residency never
changes a value, so a capped run is bitwise the fully resident one.

Telemetry (tracer=, telemetry=; null by default), the JAX node's hooks
at the same sites under the same names: the `server.apply` span (a
nested `server.eval` on a fused eval) with a `dispatch.device` count,
the retroactive `gate.wait` span at each release, the `server.*`
counters on the tracer, and the families `gate_wait_ms`, `clock_lag`
(CLOCK_BUCKETS), `worker_clock_lag{worker}`,
`gradients_applied_total{worker}`, `snapshots_published_total` and
`serving_clock`, each with a `shard` label on a node of a sharded group.
Their children are resolved here, so the hot path never takes the
registry's family lock.  With the flight recorder armed, every arrival
and release is a `gate.arrive` / `gate.release` record and a beat of the
gate watchdog.  Everything read for them is a host int or the host
clock: nothing waits on the device.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import numpy as np
import torch

from kafka_ps_tpu_torch.models.task import get_task
from kafka_ps_tpu_torch.parallel.tracker import MessageTracker
from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime.messages import (CompositeDelta, GangNotice,
                                                 GradientMessage, KeyRange,
                                                 WeightsMessage)
from kafka_ps_tpu_torch.telemetry.flight import FLIGHT
from kafka_ps_tpu_torch.telemetry.modelhealth import NULL_MODEL_HEALTH
from kafka_ps_tpu_torch.telemetry.registry import (CLOCK_BUCKETS,
                                                   NULL_TELEMETRY,
                                                   model_name)
from kafka_ps_tpu_torch.utils import asynclog
from kafka_ps_tpu_torch.utils.config import (EVENTUAL, PSConfig,
                                             canonical_device)
from kafka_ps_tpu_torch.utils.trace import NULL_TRACER

LogSink = Callable[[str], None]


class ServerNode:
    """Central aggregator + consistency gate + online evaluator."""

    def __init__(self, cfg: PSConfig, fabric: fabric_mod.Fabric, device,
                 test_x=None, test_y=None, log: LogSink | None = None,
                 key_range: KeyRange | None = None, shard_id: int = 0,
                 num_shards: int = 1, grad_key: int = 0, tracer=None,
                 telemetry=None):
        self.tracer = tracer or NULL_TRACER
        self.telemetry = telemetry or NULL_TELEMETRY
        self.cfg = cfg
        self.fabric = fabric
        self.device = torch.device(device)
        self.tracker = MessageTracker(cfg.num_workers)
        self.task = get_task(cfg.task, cfg.model)
        # range sharding: this node owns `key_range` of the flat vector
        # (the module docstring); the defaults are the unsharded node
        self.shard_id = shard_id
        self.num_shards = num_shards
        self._grad_key = grad_key
        # the consistency model's observations (the module docstring);
        # a node of a sharded group labels every family with its shard
        model = model_name(cfg.consistency_model)
        self._model = model          # span label, stable per node
        shard_labels = ({"shard": str(shard_id)} if num_shards > 1 else {})
        self._m_gate_wait = self.telemetry.histogram(
            "gate_wait_ms", model=model, **shard_labels)
        self._m_clock_lag = self.telemetry.histogram(
            "clock_lag", buckets=CLOCK_BUCKETS, model=model,
            **shard_labels)
        self._m_worker_lag = [
            self.telemetry.gauge("worker_clock_lag", worker=str(w),
                                 **shard_labels)
            for w in range(cfg.num_workers)]
        self._m_grads = [
            self.telemetry.counter("gradients_applied_total", worker=str(w),
                                   **shard_labels)
            for w in range(cfg.num_workers)]
        self._m_snapshots = self.telemetry.counter(
            "snapshots_published_total", **shard_labels)
        self._m_serving_clock = self.telemetry.gauge("serving_clock",
                                                     **shard_labels)
        # (perf_counter stamp, clock) of each worker's last unanswered
        # gradient: gate wait = release time - arrival time
        self._grad_arrived: dict[int, tuple[float, int]] = {}
        # trace context of the gradient being applied (the id the socket
        # bridge set on a traced message): the snapshot its release
        # publishes carries it, extending the delta.wire flow into the
        # serving plane
        self._pending_trace = None
        self._range = (key_range if key_range is not None
                       else KeyRange(0, self.task.num_params))
        theta = self.task.init_params(self.device)
        if key_range is not None:
            # a shard owns only its slice of the init vector
            theta = theta[key_range.start:key_range.end].clone()
        # tiered residency (store/); None: theta is one device tensor
        self.param_store = None
        self.theta = theta
        self.test_x = (None if test_x is None else torch.as_tensor(
            test_x, dtype=torch.float32, device=self.device))
        self.test_y = (None if test_y is None else torch.as_tensor(
            test_y, dtype=torch.int32, device=self.device))
        self.log = log or (lambda line: None)
        self.iterations = 0          # total gradient messages applied
        self.batched_applies = 0     # process_batch calls that chained
        self.eval_engine = None
        self._loop_started = False   # bootstrap broadcast done once
        # drops: gradients of evicted workers, and redeliveries
        self.zombie_gradients_dropped = 0
        self.duplicate_gradients_dropped = 0
        # monotonic stamp of the last weights send per worker (the
        # supervisor's heartbeat baseline, runtime/app.py)
        self.weights_sent_at = [time.monotonic()] * cfg.num_workers
        # periodic checkpointing (utils/checkpoint.py); <= 0: exit only
        self.checkpoint_path: str | None = None
        self.checkpoint_every: int = 50
        self._last_checkpoint_iteration = 0
        self.checkpoint_saves = 0
        self.checkpoint_save_s = 0.0     # host seconds spent saving
        # in-process runs fold the workers' buffers and error-feedback
        # residuals ({worker: ErrorFeedback}) into the checkpoint
        self.checkpoint_buffers = None
        self.checkpoint_residuals = None
        # weights-side compression (compress.WeightsCompressor)
        self.compressor = None
        # the durable-log offsets a restored checkpoint covers
        self.restored_log_offsets: dict[str, int] | None = None
        # logical-run identity: survives checkpoint resumes, changes on
        # every fresh start
        self.run_id = time.time_ns()
        # membership record (timestamp_ms, "evict" | "readmit" |
        # "resume", worker); `membership_log` (a CsvLogSink) writes each
        # event as it happens
        self.membership_events: list[tuple[int, str, int]] = []
        self.membership_log = None
        # aggregation (module docstring): the BSP round buffer (clock ->
        # {worker: delta}), the ordering knob for direct gradients, and
        # the socket bridge's grouped-fanout hook
        self._agg_pending: dict[int, dict[int, GradientMessage]] = {}
        self.bsp_order = False
        self.weights_group_send = None
        self.composites_received = 0
        self.sparse_applies = 0          # non-empty sparse slices applied
        self.empty_slices = 0            # empty ones: gate only
        # serving (module docstring): the registry releases publish to,
        # None to publish nothing; the publications and the last clock
        self.serving = None
        self.snapshots_published = 0
        self.last_published_clock: int | None = None
        # model-health plane (telemetry/modelhealth.py, --model-health):
        # per-update diagnostics and drift detection; the null plane
        # costs one attribute load, and the armed one only reads values
        # the update produced, so theta is bitwise the same either way
        self.modelhealth = NULL_MODEL_HEALTH

    # -- tiered residency (store/) --------------------------------------------

    @property
    def theta(self) -> torch.Tensor:
        """The owned slice: one device tensor when fully resident, else a
        new tensor assembled from the store's pages.  Either way nothing
        writes it in place; writers go through the setter."""
        if self.param_store is not None:
            return self.param_store.assembled_tensor()
        return self._theta

    @theta.setter
    def theta(self, value) -> None:
        if self.param_store is not None:
            self.param_store.replace_all(value)
            return
        self._theta = value

    def attach_param_store(self, store) -> None:
        """Give this node's slice to a TieredParamStore over its range and
        on its device: the store is seeded from the current theta (before
        or after a checkpoint restore alike), dense applies then run per
        page, and one rebalance settles residency under the caps."""
        if (store.key_range.start != self._range.start
                or store.key_range.end != self._range.end):
            raise ValueError(
                f"store range [{store.key_range.start}, "
                f"{store.key_range.end}) != shard range "
                f"[{self._range.start}, {self._range.end})")
        if store.device != canonical_device(self.device):
            raise ValueError(f"store on {store.device}, server on "
                             f"{self.device}")
        store.replace_all(self._theta)
        self.param_store = store
        self._theta = None           # the store owns the values now
        store.rebalance()

    def attach_model_health(self, plane) -> None:
        """Arm the model-health plane (telemetry/modelhealth.py): the
        apply path feeds it every accepted gradient and eval row.  Detach
        by attaching NULL_MODEL_HEALTH."""
        self.modelhealth = plane

    def _observe_update(self, msg) -> None:
        """Hand one accepted gradient to the armed model-health plane:
        the host array a socket or log frame was decoded from (computed
        inline), else the tensor (deferred to the plane's sampler)."""
        host = msg.host_values
        self.modelhealth.observe_update(
            msg.worker_id, msg.values if host is None else host)

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
        (the reference logs -1 there).  The metrics may be tensors still
        being computed: the log and the model-health plane resolve them
        off this thread."""
        asynclog.submit_or_write(
            self.log,
            f"{int(time.time() * 1000)};-1;{clock};"
            "{};{};{}", m.loss, m.f1, m.accuracy)
        if self.modelhealth.enabled:
            self.modelhealth.observe_eval(m.loss, m.f1)

    # -- bootstrap ------------------------------------------------------------

    def start_training_loop(self) -> None:
        """Broadcast WeightsMessages to kick off the self-sustaining loop.

        Cold start: every worker is in the already-replied state and gets
        clock 0.  After a checkpoint restore: workers whose reply was
        delivered get their current clock again (the in-flight message
        died with the stop); workers with a withheld reply go back
        through the gate (the eventual model answers them at once); a
        reply already pending on the fabric is not sent twice.  The
        broadcast is one release moment: one gang notice covers it."""
        if self._loop_started:
            # resuming a drive loop: the in-flight messages are still in
            # the fabric, a second broadcast would double-deliver
            return
        self._loop_started = True
        released = []
        for worker, status in enumerate(self.tracker.tracker):
            if not status.active:
                continue
            if self.fabric.pending(fabric_mod.WEIGHTS_TOPIC, worker):
                if not status.weights_message_sent:
                    self.tracker.sent_message(worker, status.vector_clock)
                continue
            if status.weights_message_sent:
                self.fabric.send(fabric_mod.WEIGHTS_TOPIC, worker,
                                 self._prepared_message(status.vector_clock,
                                                        self.theta))
                self.weights_sent_at[worker] = time.monotonic()
                released.append((worker, status.vector_clock))
        if self.cfg.max_vector_clock_delay == EVENTUAL:
            for worker, st in enumerate(self.tracker.tracker):
                if st.active and not st.weights_message_sent:
                    self.send_weights(worker, st.vector_clock)
                    released.append((worker, st.vector_clock))
        else:
            released.extend(self._flush_gate(notify=False))
        self._emit_gang_notice(sorted(released))
        # the weights the loop starts from (cold start or restore) are
        # servable before any gradient arrives
        self.publish_snapshot()

    def _prepared_message(self, clock: int, theta) -> WeightsMessage:
        """WeightsMessage over `theta` (immutable by contract: safe to
        alias).  With a compressor, the decoded copy and its parts; a
        release of several workers on one theta encodes once (the
        compressor's identity cache)."""
        encoded = None
        if self.compressor is not None:
            theta, encoded = self.compressor.encode(theta)
        return WeightsMessage(vector_clock=clock, key_range=self._range,
                              values=theta, encoded=encoded)

    def send_weights(self, worker: int, clock: int) -> None:
        """The single weights-send site: dispatch, tracker bookkeeping
        and the sent-at stamp the supervisor's heartbeat measures from
        (time a worker spends gate-blocked must not count against it)."""
        self.fabric.send(fabric_mod.WEIGHTS_TOPIC, worker,
                         self._prepared_message(clock, self.theta))
        self.weights_sent_at[worker] = time.monotonic()
        self.tracker.sent_message(worker, clock)
        self._observe_gate_release(worker)
        if FLIGHT.enabled:
            FLIGHT.record("gate.release", shard=self.shard_id,
                          worker=worker, clock=clock)
            FLIGHT.beat("gate")

    def _send_weights_prepared(self, worker: int, clock: int,
                               theta) -> None:
        """Fabric send for a release whose tracker bookkeeping already ran
        (process_batch records it at gate-decision time and sends once
        the batched apply has produced the prefix theta the release
        observes)."""
        self.fabric.send(fabric_mod.WEIGHTS_TOPIC, worker,
                         self._prepared_message(clock, theta))
        self.weights_sent_at[worker] = time.monotonic()
        self._observe_gate_release(worker)
        if FLIGHT.enabled:
            FLIGHT.record("gate.release", shard=self.shard_id,
                          worker=worker, clock=clock, gang=True)
            FLIGHT.beat("gate")

    def _observe_gate_release(self, worker: int) -> None:
        """Gate-wait sample: how long this worker's gradient sat at the
        gate before its reply went out, and the retroactive `gate.wait`
        span over that hold (the gate holds releases, not applies, so
        the hold is known only now).  Bootstrap and readmission sends
        have no arrival stamp and record nothing.  The tracer's default
        clock is the perf_counter the arrival stamp used."""
        if not self.telemetry.enabled:
            return
        entry = self._grad_arrived.pop(worker, None)
        if entry is not None:
            arrived, clock = entry
            now = time.perf_counter()
            self._m_gate_wait.observe((now - arrived) * 1e3)
            self.tracer.span_at("gate.wait", arrived, now, worker=worker,
                                clock=clock, model=self._model,
                                shard=self.shard_id)

    def gate_waiting(self) -> int:
        """Active workers parked at the gate (gradient received, reply
        withheld): the gate watchdog's demand (telemetry/health.py).
        Host ints only; safe from any thread."""
        return sum(1 for w in self.tracker.active_workers
                   if not self.tracker.tracker[w].weights_message_sent)

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

    # -- membership -----------------------------------------------------------

    def record_membership_event(self, kind: str, worker: int) -> None:
        ev = (int(time.time() * 1000), kind, worker)
        self.membership_events.append(ev)
        if self.membership_log is not None:
            self.membership_log(f"{ev[0]};{kind};{worker}")

    def remove_worker(self, worker: int) -> None:
        """Evict a failed worker: every gate stops waiting for its
        gradients, and any round it was blocking is released."""
        self.tracker.deactivate_worker(worker)
        self.record_membership_event("evict", worker)
        self.tracer.count("server.workers_removed")
        if self._agg_pending:
            # the evictee's buffered round members go, and a round it was
            # the last missing member of is applied now
            for bucket in self._agg_pending.values():
                bucket.pop(worker, None)
            self._flush_agg_rounds()
        self._flush_gate()

    def readmit_worker(self, worker: int) -> int:
        """Rejoin at the slowest active clock with the current weights.
        The worker's pre-eviction traffic is purged first: a stale
        gradient or weights message becoming live again would break the
        clock protocol."""
        self.fabric.purge(fabric_mod.GRADIENTS_TOPIC, self._grad_key,
                          lambda m: getattr(m, "worker_id", None) == worker)
        self.fabric.purge(fabric_mod.WEIGHTS_TOPIC, worker, lambda m: True)
        clock = self.tracker.reactivate_worker(worker)
        self.record_membership_event("readmit", worker)
        self.tracer.count("server.workers_readmitted")
        self.send_weights(worker, clock)
        return clock

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
            if release:
                self.publish_snapshot()
        return release

    def _emit_gang_notice(self, release: list[tuple[int, int]]) -> None:
        """Advertise a multi-member release set on GANG_TOPIC, beside the
        per-worker messages (which remain the protocol)."""
        if self.cfg.use_gang and len(release) > 1:
            self.fabric.send_transient(fabric_mod.GANG_TOPIC, 0,
                                       GangNotice(members=tuple(release)))
            self.tracer.count("server.gang_release_sets")

    def dispatch_release_set(self, release) -> None:
        """Sorted per-worker sends (worker-id order keeps serial
        scheduling deterministic) plus the gang notice when several
        workers were released at one moment.  The grouped-fanout hook,
        when attached, claims first: the members it shipped get the
        bookkeeping of a send without the per-worker fabric send."""
        release = sorted(release)
        handled = self._group_send(
            release, lambda clock: self._prepared_message(clock,
                                                          self.theta))
        for worker, clock in release:
            if worker in handled:
                self._mark_grouped_release(worker, clock)
            else:
                self.send_weights(worker, clock)
        self._emit_gang_notice(release)
        if release:
            self.publish_snapshot()

    def _group_send(self, release, builder) -> set:
        """Offer a sorted release set to `weights_group_send`;
        `builder(clock)` makes the WeightsMessage a grouped frame
        carries.  Returns the worker ids the hook shipped."""
        if self.weights_group_send is None or not release:
            return set()
        return self.weights_group_send(release, builder)

    def _mark_grouped_release(self, worker: int, clock: int) -> None:
        """send_weights' bookkeeping for a release that went out inside
        a grouped frame."""
        self.weights_sent_at[worker] = time.monotonic()
        self.tracker.sent_message(worker, clock)
        self._observe_gate_release(worker)
        if FLIGHT.enabled:
            FLIGHT.record("gate.release", shard=self.shard_id,
                          worker=worker, clock=clock, grouped=True)
            FLIGHT.beat("gate")

    def serving_clock(self) -> int:
        """The slowest active worker's clock: every weights message
        released so far carries a clock >= it (the stable clock; a
        sharded group's frontier is its minimum over the shards)."""
        active = self.tracker.active_workers
        if not active:
            return 0
        return min(self.tracker.tracker[w].vector_clock for w in active)

    def publish_snapshot(self, theta=None, clock=None, trace=None) -> None:
        """Publish (theta, stable clock) to the attached registry; a no-op
        with serving off.  `theta` defaults to the current theta, `clock`
        to `serving_clock()`; `trace` (by default the context of the
        gradient being applied) rides on the snapshot, so the serving
        plane can close the delta.wire flow at its first read.  O(1) on
        the host: the snapshot aliases the tensor."""
        registry = self.serving
        if registry is None:
            return
        if trace is None:
            trace = self._pending_trace
        # pscheck: disable=PS102 (the gate's clock is a host int; the coercion only normalizes a numpy int)
        clock = self.serving_clock() if clock is None else int(clock)
        registry.publish(self.theta if theta is None else theta, clock,
                         trace=trace)
        if trace is not None:
            # the flow's publish step: the segment between the apply and
            # the first serving read starts here
            self.tracer.flow_step("delta.wire", trace, step="publish",
                                  clock=clock)
        self.snapshots_published += 1
        self.last_published_clock = clock
        self.tracer.count("serving.snapshots_published")
        if self.telemetry.enabled:
            self._m_snapshots.inc()
            self._m_serving_clock.set(clock)
        if FLIGHT.enabled:
            FLIGHT.record("snapshot.publish", shard=self.shard_id,
                          clock=clock)

    # -- the hot path ---------------------------------------------------------

    def _full_dense(self, msg) -> bool:
        """A dense gradient over exactly this node's range."""
        r = msg.key_range
        return (getattr(msg, "indices", None) is None
                and r.start == self._range.start and r.end == self._range.end)

    def _wants_eval(self, msg: GradientMessage) -> bool:
        return (msg.worker_id == 0 and self.test_x is not None
                and msg.vector_clock % self.cfg.eval_every == 0)

    def _dropped(self, msg: GradientMessage, duplicate: bool) -> bool:
        """Count and report a gradient that must not be applied: one of
        an evicted worker (a zombie), or a redelivery (`duplicate`: its
        clock was applied before)."""
        if not self.tracker.tracker[msg.worker_id].active:
            self.zombie_gradients_dropped += 1
            self.tracer.count("server.zombie_gradients_dropped")
            return True
        if duplicate:
            self.duplicate_gradients_dropped += 1
            self.tracer.count("server.duplicate_gradients_dropped")
            return True
        return False

    def _arrived(self, worker: int, clock: int) -> None:
        """One gradient past the gate's filters, its clock recorded:
        the applied count and, when on, the consistency observations and
        the flight record."""
        self.tracer.count("server.gradients_applied")
        if self.telemetry.enabled:
            self._observe_arrival(worker, clock)
        if FLIGHT.enabled:
            self._flight_arrival(worker, clock)

    def _observe_arrival(self, worker: int, clock: int) -> None:
        """Per-gradient consistency observations, all host ints: the
        arrival stamp (the gate-wait baseline), the applied count, every
        active worker's lag behind the fastest and this worker's."""
        self._grad_arrived[worker] = (time.perf_counter(), clock)
        self._m_grads[worker].inc()
        active = self.tracker.active_workers
        if active:
            fastest = max(self.tracker.tracker[w].vector_clock
                          for w in active)
            for w in active:
                lag = fastest - self.tracker.tracker[w].vector_clock
                self._m_worker_lag[w].set(lag)
            self._m_clock_lag.observe(
                fastest - self.tracker.tracker[worker].vector_clock)

    def _flight_arrival(self, worker: int, clock: int) -> None:
        """The flight recorder's view of one arrival: the whole vector
        clock at the gate's decision (evicted workers' clocks frozen),
        this worker's lag and how many wait at the gate."""
        states = self.tracker.tracker
        clocks = [st.vector_clock for st in states]
        waiting = sum(1 for st in states
                      if st.active and not st.weights_message_sent)
        FLIGHT.record("gate.arrive", shard=self.shard_id, worker=worker,
                      clock=clock, lag=max(clocks) - clock,
                      waiting=waiting, clocks=clocks)
        FLIGHT.beat("gate")

    def process(self, msg) -> None:
        if isinstance(msg, CompositeDelta):
            self.process_composite(msg)
            return
        if (self.bsp_order and self.cfg.max_vector_clock_delay == 0
                and self._full_dense(msg)):
            # the round buffer composites use: a direct run applies each
            # BSP round in worker-id order, as an aggregated run does
            if self._buffer_round_member(msg):
                self._flush_agg_rounds()
            return
        self._process_direct(msg)

    def _process_direct(self, msg) -> None:
        """One gradient, dense, sparse or sub-range, through the gate."""
        if self._dropped(msg, self.tracker.is_duplicate(msg.worker_id,
                                                        msg.vector_clock)):
            return
        self.tracker.received_message(msg.worker_id, msg.vector_clock)
        self._arrived(msg.worker_id, msg.vector_clock)
        if self.modelhealth.enabled:
            self._observe_update(msg)
        self._apply_and_release(msg, msg.vector_clock, [msg.worker_id],
                                worker=msg.worker_id)
        self.maybe_checkpoint()

    def _apply_and_release(self, msg, clock: int, live: list,
                           **span_args) -> None:
        """Apply `msg`'s delta (dense, sparse or sub-range) for the
        `live` workers, whose clock the tracker has recorded: evaluate
        at `clock` when worker 0 is among them, count one iteration per
        worker and send the replies their gradients release.  The apply
        is the `server.apply` span, `span_args` its arguments."""
        want_eval = (0 in live and self.test_x is not None
                     and clock % self.cfg.eval_every == 0)
        fused_eval = want_eval and self.eval_engine is None
        m = deferred = None
        fid = getattr(msg, "trace", None)
        self._pending_trace = fid
        with self.tracer.span("server.apply", **span_args, clock=clock,
                              shard=self.shard_id, model=self._model):
            if getattr(msg, "indices", None) is not None:
                self._apply_sparse(msg)
                if fid is not None:
                    # the flow per delta slice: the wire arrow lands on
                    # the shard's net.recv, this step on its apply
                    self.tracer.flow_step("delta.wire", fid, clock=clock,
                                          shard=self.shard_id)
            elif self._full_dense(msg):
                if self.param_store is not None:
                    m, deferred = self._apply_tiered(
                        msg.values, fused_eval, want_eval and not fused_eval,
                        clock)
                elif fused_eval:
                    with self.tracer.span("server.eval", clock=clock):
                        self.theta, m = self._apply_full_eval(self.theta,
                                                              msg.values)
                else:
                    self.theta = self._apply_full(self.theta, msg.values)
                self.tracer.count("dispatch.device")
                if fid is not None:
                    # the wire arrow lands on net.recv, this step on the
                    # apply
                    self.tracer.flow_step("delta.wire", fid, clock=clock)
            else:
                self.theta = self._apply_splice(msg)
            self.iterations += len(live)
        if fused_eval:
            if m is None:                # the sparse and splice paths
                with self.tracer.span("server.eval", clock=clock):
                    m = self.task.evaluate(self.theta, self.test_x,
                                           self.test_y)
                    self.tracer.count("dispatch.device")
            self._emit_eval(clock, m)
        elif want_eval:
            # immutable alias hand-off; the engine evaluates off this
            # thread (the tiered apply's own new slice where it made one)
            self.eval_engine.submit(
                self.theta if deferred is None else deferred, clock)
        release: set = set()
        for worker in live:
            release |= self.workers_to_respond_to(clock, worker)
        self.dispatch_release_set(release)
        self._pending_trace = None

    def _apply_sparse(self, msg) -> None:
        """theta[idx] += lr * vals for a SparseDeltaMessage, into a new
        tensor.  The indices are unique (a top-k survivor set), so the
        indexed write is deterministic and each element is the same
        `t + lr*d` the dense apply computes.  An empty slice only moved
        the gate."""
        if len(msg.indices) == 0:
            self.empty_slices += 1
            self.tracer.count("dispatch.skipped_empty_slice")
            return
        if self.param_store is not None:
            self._apply_sparse_tiered(msg)
        else:
            idx = msg.indices.to(self.device, torch.long)
            vals = msg.values.to(self.device, torch.float32)
            t = self.theta.clone()
            t[idx] = self.theta[idx] + self.cfg.server_lr * vals
            self.theta = t
        self.sparse_applies += 1
        self.tracer.count("dispatch.device")

    def _apply_tiered(self, delta, fused_eval: bool, defer_eval: bool,
                      clock: int):
        """A dense apply over this node's range against the tiered store.
        Returns (metrics, deferred theta); at most one is not None.

        Without an eval: `t_p + lr*d_p` per page, on the server's device
        for a warm page too (uploaded; `update_page` fetches the result
        back to the host), so each element is bitwise the whole-slice
        apply.  With the fused eval: the resident path's `_apply_full_eval`
        on the assembled slice, scattered back, so the row is bitwise the
        resident run's.  With a deferred eval: the whole-slice apply on
        the assembled slice, scattered back, and the new slice returned
        for the engine, a tensor later page updates cannot touch."""
        store = self.param_store
        if fused_eval or defer_eval:
            t = store.assembled_tensor()
            if fused_eval:
                with self.tracer.span("server.eval", clock=clock):
                    t2, m = self._apply_full_eval(t, delta)
            else:
                t2, m = self._apply_full(t, delta), None
            store.replace_all(t2)
            return m, (t2 if defer_eval else None)
        base = self._range.start
        for i, kr, value in store.pin_pages(self._range):
            lo, hi = kr.start - base, kr.end - base
            store.update_page(i, self._apply_full(store.to_device(value),
                                                  delta[lo:hi]))
        return None, None

    def _apply_sparse_tiered(self, msg) -> None:
        """A sparse slice against the tiered store: the indices grouped
        by page (sorted, as the slice's indices are), and per touched
        page the resident path's indexed write into a new page tensor.
        Pages the slice skips stay untouched, and so stay cool: the skew
        the heat policy feeds on."""
        store = self.param_store
        size = store.page_params
        # the (few) indices on the host for the grouping; values stay put
        idx = msg.indices.to("cpu", torch.long).numpy()
        pages = idx // size
        for page in np.unique(pages):
            page = int(page)
            a, b = np.searchsorted(pages, [page, page + 1])
            local = torch.from_numpy(idx[a:b] - page * size).to(self.device)
            vals = msg.values[a:b].to(self.device, torch.float32)
            (_, _, value), = store.pin_pages(store.page_range(page))
            t = store.to_device(value)
            t2 = t.clone()
            t2[local] = t[local] + self.cfg.server_lr * vals
            store.update_page(page, t2)

    def _apply_splice(self, msg) -> torch.Tensor:
        """A dense gradient over a sub-range of this node's range,
        spliced into a new tensor."""
        r = msg.key_range
        lo, hi = r.start - self._range.start, r.end - self._range.start
        if lo < 0 or hi > len(self._range):
            raise ValueError(
                f"gradient range [{r.start}, {r.end}) outside this "
                f"server's range [{self._range.start}, {self._range.end})")
        t = self.theta
        part = t[lo:hi] + self.cfg.server_lr * msg.values.to(t.device)
        return torch.cat([t[:lo], part, t[hi:]])

    # -- aggregation relays (agg/) -------------------------------------------

    def process_composite(self, comp: CompositeDelta) -> None:
        """Apply one relay composite (the module docstring): stacked
        members through the BSP round buffer or `process_batch`, a
        summed composite as one apply."""
        self.composites_received += 1
        self.tracer.count("server.composites_received")
        if FLIGHT.enabled:
            FLIGHT.record("agg.composite", shard=self.shard_id,
                          agg=comp.agg_id, fan_in=comp.fan_in,
                          summed=comp.summed)
        if comp.summed:
            self._process_summed(comp)
            return
        resent: set = set()
        if self.cfg.max_vector_clock_delay == 0:
            buffered = False
            for d in comp.deltas:
                buffered |= self._buffer_round_member(d, resent)
            if buffered:
                self._flush_agg_rounds()
            return
        live = [d for d in comp.deltas
                if self._composite_member_live(d.worker_id,
                                               d.vector_clock, resent)]
        if live:
            self.process_batch(live)

    def _composite_member_live(self, worker: int, clock: int,
                               resent: set | None = None) -> bool:
        """The zombie and duplicate filter for one composite member.  A
        duplicate whose reply was issued gets the current weights again:
        the reply may have died inside a killed relay.  `resent` bounds
        that to once per worker per composite (a reconnecting worker's
        cache resend can hold many applied clocks)."""
        status = self.tracker.tracker[worker]
        if not status.active:
            self.zombie_gradients_dropped += 1
            self.tracer.count("server.zombie_gradients_dropped")
            return False
        if self.tracker.is_duplicate(worker, clock):
            self.duplicate_gradients_dropped += 1
            self.tracer.count("server.duplicate_gradients_dropped")
            if status.weights_message_sent and (resent is None
                                                or worker not in resent):
                if resent is not None:
                    resent.add(worker)
                self.send_weights(worker, status.vector_clock)
            return False
        return True

    def _buffer_round_member(self, msg, resent: set | None = None) -> bool:
        """Queue one BSP round member for the ordered flush."""
        if not self._composite_member_live(msg.worker_id, msg.vector_clock,
                                           resent):
            return False
        bucket = self._agg_pending.setdefault(msg.vector_clock, {})
        if msg.worker_id in bucket:
            self.duplicate_gradients_dropped += 1
            self.tracer.count("server.duplicate_gradients_dropped")
            return False
        bucket[msg.worker_id] = msg
        return True

    def _flush_agg_rounds(self) -> None:
        """Apply every complete buffered round, lowest clock first, in
        worker-id order: one process_batch per round, so evals and
        releases fall as in a worker-id-ordered serial direct run."""
        while self._agg_pending:
            clock = min(self._agg_pending)
            bucket = self._agg_pending[clock]
            expected = [w for w in self.tracker.active_workers
                        if self.tracker.tracker[w].vector_clock == clock]
            if not expected or any(w not in bucket for w in expected):
                return
            del self._agg_pending[clock]
            self.process_batch([bucket[w] for w in sorted(expected)])

    def _process_summed(self, comp: CompositeDelta) -> None:
        """One apply of a summed composite, whose members share one
        clock.  All members applied already: a redelivery, the released
        replies are re-issued; some but not all: a protocol error (a sum
        cannot be applied in part)."""
        clocks = sorted({c for _, c in comp.members})
        if len(clocks) != 1:
            raise ValueError(f"summed composite spans clocks {clocks}")
        clock = clocks[0]
        live, dup = [], []
        for worker, c in comp.members:
            if not self.tracker.tracker[worker].active:
                raise ValueError(
                    f"summed composite includes evicted worker {worker}")
            (dup if self.tracker.is_duplicate(worker, c)
             else live).append(worker)
        if not live:
            self.duplicate_gradients_dropped += 1
            self.tracer.count("server.duplicate_gradients_dropped")
            for worker in dup:
                status = self.tracker.tracker[worker]
                if status.weights_message_sent:
                    self.send_weights(worker, status.vector_clock)
            return
        if dup:
            raise ValueError(
                f"summed composite partially applied: duplicates {dup} "
                f"alongside live members {live}")
        for worker in live:
            self.tracker.received_message(worker, clock)
            self._arrived(worker, clock)
        self._apply_and_release(comp.deltas[0], clock, live,
                                agg=comp.agg_id, fan_in=len(live))
        if self._agg_pending:
            # a round's members buffered from a stacked flush (a relay
            # sends a one-member flush stacked) are its remainder now
            self._flush_agg_rounds()
        self.maybe_checkpoint()

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
            `deltas.sum(0)`: float addition does not associate;
          * zombie and duplicate drops run per message, the duplicate
            filter seeing the clocks the earlier members will advance (a
            redelivered gradient can appear twice in one batch).
        All the releases of the batch form one gang notice; a checkpoint
        is due at most once, at the end.  Sparse and sub-range gradients
        take the per-message path, and so does every gradient when a
        tiered store holds the slice (bitwise by the contract above)."""
        if (self.param_store is not None
                or not all(self._full_dense(m) for m in msgs)):
            for m in msgs:
                self._process_direct(m)
            return
        live, ahead = [], {}
        for m in msgs:
            expected = ahead.get(
                m.worker_id, self.tracker.tracker[m.worker_id].vector_clock)
            if self._dropped(m, m.vector_clock < expected):
                continue
            ahead[m.worker_id] = m.vector_clock + 1
            live.append(m)
        msgs = live
        if len(msgs) < 2:
            for m in msgs:
                self._process_direct(m)
            return
        defer_eval = self.eval_engine is not None
        eval_at: dict[int, int] = {}              # position -> clock
        release_at: dict[int, list[tuple[int, int]]] = {}
        snap_clocks: dict[int, int] = {}          # position -> stable clock
        for i, m in enumerate(msgs):
            self.tracker.received_message(m.worker_id, m.vector_clock)
            self._arrived(m.worker_id, m.vector_clock)
            if self.modelhealth.enabled:
                self._observe_update(m)
            if self._wants_eval(m):
                eval_at[i] = m.vector_clock
            release = sorted(self.workers_to_respond_to(m.vector_clock,
                                                        m.worker_id))
            for w, c in release:
                self.tracker.sent_message(w, c)
            if release:
                release_at[i] = release
                if self.serving is not None:
                    # the stable clock at gate-decision time: the tracker
                    # here is the per-message path's after message i
                    # (sent_message moves no clock)
                    snap_clocks[i] = self.serving_clock()
        lr = self.cfg.server_lr
        t = self.theta
        # the per-message path's span name: one entry covers the k
        # chained applies, and the evals and sends between them
        batch_released: list[tuple[int, int]] = []
        with self.tracer.span("server.apply", gang=len(msgs),
                              workers=[m.worker_id for m in msgs],
                              model=self._model):
            for i, m in enumerate(msgs):
                t = t + lr * m.values
                if i in eval_at:
                    if defer_eval:
                        self.eval_engine.submit(t, eval_at[i])
                    else:
                        with self.tracer.span("server.eval",
                                              clock=eval_at[i], fused=True):
                            self._emit_eval(eval_at[i], self.task.evaluate(
                                t, self.test_x, self.test_y))
                rel = release_at.get(i, ())
                if rel:
                    handled = self._group_send(
                        rel,
                        lambda clock, t=t: self._prepared_message(clock, t))
                    for worker, clock in rel:
                        if worker in handled:
                            # the tracker's bookkeeping ran at decision time
                            self.weights_sent_at[worker] = time.monotonic()
                            self._observe_gate_release(worker)
                            if FLIGHT.enabled:
                                FLIGHT.record("gate.release",
                                              shard=self.shard_id,
                                              worker=worker, clock=clock,
                                              gang=True, grouped=True)
                                FLIGHT.beat("gate")
                        else:
                            self._send_weights_prepared(worker, clock, t)
                    batch_released.extend(rel)
                    if self.serving is not None:
                        # the prefix theta this release observed, one
                        # snapshot per release event, as the per-message
                        # path publishes
                        self.publish_snapshot(t, snap_clocks[i])
            self.theta = t
            self.iterations += len(msgs)
        self.tracer.count("dispatch.device")
        self.tracer.count("server.gang_batched_applies")
        self.batched_applies += 1
        self._emit_gang_notice(sorted(batch_released))
        self.maybe_checkpoint()

    # -- checkpoints --------------------------------------------------------

    def maybe_checkpoint(self) -> None:
        """Save once every `checkpoint_every` applied iterations, crossing
        based, so any stride (1 on the message path, the active workers
        on the fused path) triggers on schedule."""
        if not self.checkpoint_path or self.checkpoint_every <= 0:
            return
        if (self.iterations - self._last_checkpoint_iteration
                >= self.checkpoint_every):
            self.save_checkpoint_now()

    def save_checkpoint_now(self) -> None:
        """Write the checkpoint: theta, clocks, membership, iterations and
        run id, with the buffers and residuals the app handed over.

        On a durable fabric (log/durable_fabric.py) it is a COMMIT POINT:
        snapshot the consumer offsets the state covers, store them in the
        checkpoint (authoritative for replay), then commit them durably so
        retention can reap fully-consumed segments.  Offsets are committed
        only once the checkpoint covering them is on disk, so a crash
        between the two replays extra records instead of losing them.
        The fabric's commit lock holds ingestion off between the offsets'
        snapshot and the buffers' copy."""
        if not self.checkpoint_path:
            return
        from kafka_ps_tpu_torch.utils import checkpoint as ckpt
        t0 = time.perf_counter()
        durable = self.fabric.durable
        offsets = None
        with (self.fabric.commit_lock if durable
              else contextlib.nullcontext()):
            if durable:
                offsets = self.fabric.snapshot_offsets()
            ckpt.save(self.checkpoint_path, self,
                      buffers=self.checkpoint_buffers, log_offsets=offsets,
                      residuals=self.checkpoint_residuals)
        if offsets is not None:
            self.fabric.commit(offsets)
        self._last_checkpoint_iteration = self.iterations
        self.checkpoint_saves += 1
        self.checkpoint_save_s += time.perf_counter() - t0
