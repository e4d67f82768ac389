"""Micro-batching prediction engine (counterpart of
kafka_ps_tpu/serving/engine.py): gang dispatch for the read path.

Requests queue up; one batcher thread coalesces them until `max_batch`
rows are waiting or `deadline_s` has passed since the first row arrived,
then runs ONE forward over a padded fixed-shape batch.  The argument is
the training side's gang dispatch: a dispatch costs its kernel launches
and one device-to-host read whatever its row count, so k requests per
dispatch pay about 1/k of that each.

Under load the engine protects itself instead of queueing to death:

  * admission control: `queue_limit` bounds each tenant's outstanding
    admitted requests; `submit` on a full queue raises a typed
    `policy.OverloadedError` SYNCHRONOUSLY (the transport answers
    OVERLOADED at once).  `shed_deadline_s` also sheds when the predicted
    queueing delay (backlog over the batch capacity, times the EWMA
    batch service time) exceeds that budget, before the queue fills;
  * adaptive sizes: dispatch shapes are power-of-two buckets of the live
    row count, capped at `max_batch`, so at most log2(max_batch) + 1
    shapes per model family (`TRACE_COUNTS["compiles"]` counts the
    first-seen ones; the JAX package compiles a program per shape).

Batching itself is measured (`auto=True`): each tenant carries a
`DispatchCostModel` (serving/costmodel.py) fed by the per-dispatch
timings.  Below the learned break-even occupancy `submit` serves the
request inline on the caller's thread; above it the batcher's window is
sized from the live arrival rate.  A cold engine keeps the batching path;
`warmup()` calibrates.

Tenants: `add_model(model_id, task, registry)` registers another model
family with its own registry and admission budget; requests carry a
model id (the wire's trailer, runtime/net.py).  Each per-tenant
micro-batch reads its registry ONCE, so all its rows are answered from
one (theta, clock) pair, each row's bound checked against it.

The forward is `task.predict_logits` -> softmax -> (argmax, max
probability) in eager PyTorch, built once per tenant (the JAX engine
jits it; no Pallas kernel is involved).  It runs where the snapshot's
theta lives: on the card the rows go up through pinned memory without a
synchronisation, and the labels and confidences come back in ONE small
device-to-host copy of the dispatch's own outputs, which waits only for
the work queued on the default stream before it.  No call here
synchronises the device.

Telemetry (`tracer=`, `telemetry=`, null by default) is the JAX engine's:
the families `serving_requests_total`, `serving_rejections_total`,
`serving_queue_depth`, `serving_shed_total`, `serving_batch_size`,
`serving_latency_ms`, `snapshot_age_ms` and `serving_dispatch_mode{mode}`
(resolved at construction, observed per micro-batch, never per row), the
tracer's `serving.*` counts and `serving.predict` span, the
`serving.batch` flight record with a `serving` beat per serve (the
serving watchdog's progress), and the end of a snapshot's `delta.wire`
flow at its first read.  The plain counters and `stats()` stay beside
them.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from kafka_ps_tpu_torch.analysis.lockgraph import OrderedLock
from kafka_ps_tpu_torch.serving import policy
from kafka_ps_tpu_torch.serving.costmodel import DispatchCostModel
from kafka_ps_tpu_torch.serving.snapshot import SnapshotRegistry
from kafka_ps_tpu_torch.telemetry import NULL_TELEMETRY
from kafka_ps_tpu_torch.telemetry.flight import FLIGHT
from kafka_ps_tpu_torch.utils.trace import NULL_TRACER, LatencyRecorder


class Prediction(NamedTuple):
    label: int             # argmax class
    confidence: float      # softmax mass on the argmax class
    vector_clock: int      # clock of the snapshot that answered
    wall_time: float       # publication time of that snapshot


class _Request(NamedTuple):
    x: np.ndarray
    bound: policy.ReadBound | None
    callback: Callable     # called with a Prediction or an Exception
    t0: float              # monotonic enqueue time (latency accounting)
    model_id: int          # the tenant the request addresses


class _Tenant:
    """One served model family: its task, snapshot ring, forward,
    dispatch cost model and admission bookkeeping."""

    __slots__ = ("model_id", "task", "registry", "predict", "depth",
                 "last_traced_seq", "cost", "compiled")

    def __init__(self, model_id: int, task, registry: SnapshotRegistry,
                 max_batch: int):
        self.model_id = model_id
        self.task = task
        self.registry = registry
        self.predict = None        # the forward, built on first dispatch
        # seq of the last snapshot whose delta.wire flow ended here: a
        # flow ends once, at the snapshot's FIRST serving read
        self.last_traced_seq = -1
        self.depth = 0             # admitted-but-unserved requests
        # dispatch economics (serving/costmodel.py): fed by warmup and
        # every live dispatch, read by submit's bypass decision
        self.cost = DispatchCostModel(max_batch)
        # bucket shapes this tenant has dispatched
        self.compiled: set[int] = set()


_SENTINEL = object()

# shape and dispatch-mode accounting for regression tests: "compiles"
# counts first-seen (tenant, bucket) dispatch shapes, at most one per
# bucket per model family across any batch-size sequence
TRACE_COUNTS = {"compiles": 0, "batch": 0, "bypass": 0}


def _bucket(n: int, cap: int) -> int:
    """Smallest power of two >= n, capped: the adaptive dispatch shape."""
    b = 1
    while b < n and b < cap:
        b <<= 1
    return min(b, cap)


def make_forward(task):
    """The tenant's forward: (theta, rows [B, F] float32 numpy) ->
    host float32 [2, B], labels over confidences.  On the card the rows
    cross through pinned memory and the result comes back in one copy."""

    def forward(theta, xs: np.ndarray) -> np.ndarray:
        theta = torch.as_tensor(theta)
        if theta.is_cuda:
            host = torch.empty(xs.shape, dtype=torch.float32,
                               pin_memory=True)
            host.numpy()[...] = xs
            x = host.to(theta.device, non_blocking=True)
        else:
            x = torch.from_numpy(xs)
        lg = task.predict_logits(theta, x)
        conf = torch.softmax(lg, dim=-1).amax(dim=-1)
        labels = torch.argmax(lg, dim=-1).to(torch.float32)
        return torch.stack([labels, conf]).cpu().numpy()

    return forward


def make_engine(task, registry: SnapshotRegistry, scfg, tracer=None,
                telemetry=None) -> "PredictionEngine":
    """The engine a utils.config.ServingConfig sizes (the --serve flags)."""
    return PredictionEngine(
        task, registry, max_batch=scfg.max_batch,
        deadline_s=scfg.deadline_ms / 1000.0, queue_limit=scfg.queue_limit,
        shed_deadline_s=(scfg.shed_deadline_ms / 1000.0
                         if scfg.shed_deadline_ms else None),
        auto=scfg.auto, tracer=tracer, telemetry=telemetry)


class PredictionEngine:
    """Deadline- and size-capped micro-batcher over per-model snapshot
    rings, with bounded admission and explicit load shedding."""

    def __init__(self, task, registry: SnapshotRegistry, *,
                 max_batch: int = 16, deadline_s: float = 0.002,
                 queue_limit: int = 0, shed_deadline_s: float | None = None,
                 adaptive: bool = True, auto: bool = True,
                 tracer=None, telemetry=None, now=time.time):
        self.max_batch = max(1, int(max_batch))
        self.deadline_s = max(0.0, float(deadline_s))
        # 0 = unbounded; > 0 bounds EACH tenant's outstanding requests
        self.queue_limit = max(0, int(queue_limit))
        self.shed_deadline_s = shed_deadline_s
        self.adaptive = adaptive
        # adaptive dispatch-mode selection, engaged once a tenant's cost
        # model is calibrated (warmup, or live samples of both ends of
        # the batch-latency curve); cold engines batch
        self.auto = bool(auto)
        self._now = now
        self.tracer = tracer or NULL_TRACER
        self.telemetry = telemetry or NULL_TELEMETRY
        # resolved once (null when telemetry is off): observed per
        # micro-batch, never per row, never on device data
        self._m_snapshot_age = self.telemetry.histogram("snapshot_age_ms")
        self._m_requests = self.telemetry.counter("serving_requests_total")
        self._m_rejections = self.telemetry.counter(
            "serving_rejections_total")
        self._m_queue_depth = self.telemetry.gauge("serving_queue_depth")
        self._m_sheds = self.telemetry.counter("serving_shed_total")
        self._m_batch_size = self.telemetry.histogram("serving_batch_size")
        self._m_latency = self.telemetry.histogram("serving_latency_ms")
        # the dispatch-mode family (the shm transport counts its own
        # child in runtime/net.py)
        self._m_mode = {
            "batch": self.telemetry.counter("serving_dispatch_mode",
                                            mode="batch"),
            "bypass": self.telemetry.counter("serving_dispatch_mode",
                                             mode="bypass"),
        }
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        # admission bookkeeping: the depth counters gate sheds, so they
        # move under one leaf lock, never nested
        self._admission = OrderedLock("PredictionEngine.admission")
        # guarded-by: _admission (queue_depth/stats reads are lock-free gauge snapshots)
        self._depth = 0            # total admitted-but-unserved requests
        # inline bypass serves running on caller threads: while one is in
        # flight new arrivals take the queue, which is how sustained
        # concurrency reaches the demand estimate
        self._bypassing = 0
        self._ewma_batch_s: float | None = None
        # guarded-by: _admission (add_model writes hold it; steady-state reads are GIL-atomic dict gets)
        self._tenants: dict[int, _Tenant] = {
            0: _Tenant(0, task, registry, self.max_batch)}
        self.latency = LatencyRecorder()
        # guarded-by: _admission (stats reads are lock-free snapshots)
        self.requests = 0
        # guarded-by: _admission (stats reads are lock-free snapshots)
        self.batches = 0          # forward dispatches
        # guarded-by: _admission (stats reads are lock-free snapshots)
        self.batched_rows = 0     # rows that made it into a dispatch
        # guarded-by: _admission (stats reads are lock-free snapshots)
        self.rejections = 0       # staleness rejections
        self.sheds = 0            # admission-control sheds (typed)
        # guarded-by: _admission (stats reads are lock-free snapshots)
        self.bypasses = 0         # requests served on the fast path
        # guarded-by: _admission (stats reads are lock-free snapshots)
        self.errors = 0
        # guarded-by: _admission (stats reads are lock-free snapshots)
        self.callback_errors = 0  # callbacks that raised (rows answered)
        self._closed = False
        # threads that have made their device current (a CUDA theta)
        self._device_set = threading.local()
        self._thread = threading.Thread(
            target=self._loop, name="kps-serve-batch", daemon=True)
        self._thread.start()

    # the model-0 surface every single-tenant caller uses
    @property
    def task(self):
        return self._tenants[0].task

    @property
    def registry(self) -> SnapshotRegistry:
        return self._tenants[0].registry

    # -- multi-model surface -------------------------------------------------

    def add_model(self, model_id: int, task,
                  registry: SnapshotRegistry | None = None,
                  capacity: int = 8) -> SnapshotRegistry:
        """Register another served model family; returns its registry
        (a fresh one when none is passed)."""
        model_id = int(model_id)
        with self._admission:
            if model_id in self._tenants:
                raise ValueError(f"model {model_id} already registered")
            reg = registry if registry is not None \
                else SnapshotRegistry(capacity=capacity)
            self._tenants[model_id] = _Tenant(model_id, task, reg,
                                              self.max_batch)
            return reg

    def model_ids(self) -> tuple[int, ...]:
        return tuple(sorted(self._tenants))

    def registry_for(self, model_id: int) -> SnapshotRegistry:
        return self._tenants[model_id].registry

    # -- request entry points ------------------------------------------------

    def submit(self, x, bound: policy.ReadBound | None = None,
               callback: Callable = lambda result: None, *,
               model_id: int = 0) -> None:
        """Async predict: `callback` fires with a Prediction, or with the
        StalenessError or Exception that ended the request.  Never blocks
        on a batch window; raises policy.OverloadedError synchronously
        when admission control sheds the request (nothing is queued)."""
        if self._closed:
            raise RuntimeError("prediction engine is closed")
        tenant = self._tenants.get(model_id)
        if tenant is None:
            raise ValueError(f"unknown model id {model_id}")
        with self._admission:
            if self.queue_limit and tenant.depth >= self.queue_limit:
                self._shed(tenant, f"admission queue full "
                                   f"({tenant.depth}/{self.queue_limit})")
            if self.shed_deadline_s is not None \
                    and self._ewma_batch_s is not None:
                # predicted queueing delay: batches ahead of this row
                # times the EWMA batch service time
                predicted = ((self._depth // self.max_batch + 1)
                             * self._ewma_batch_s)
                if predicted > self.shed_deadline_s:
                    self._shed(tenant,
                               f"predicted queueing delay "
                               f"{predicted * 1e3:.1f}ms > shed deadline "
                               f"{self.shed_deadline_s * 1e3:.1f}ms")
            tenant.depth += 1
            self._depth += 1
            tenant.cost.observe_arrival(time.monotonic())
            # the bypass decision, per request at admission: below the
            # learned engage threshold serve on the caller's thread.  At
            # most two inline lanes run beside the batcher; the overflow
            # goes through the queue, which feeds the demand estimate
            # that re-engages batching under sustained concurrency
            bypass = (self.auto and self._bypassing < 2
                      and tenant.cost.bypass())
            if bypass:
                self._bypassing += 1
            if self.telemetry.enabled:
                self._m_queue_depth.set(self._depth)
        # pscheck: disable=PS102 (client boundary: coerces caller-supplied x)
        row = np.asarray(x, dtype=np.float32).reshape(-1)
        req = _Request(row, bound, callback, time.monotonic(), model_id)
        if bypass:
            try:
                self._serve([req], mode="bypass")
            finally:
                with self._admission:
                    self._bypassing -= 1
        else:
            self._q.put(req)

    def _shed(self, tenant: _Tenant, why: str):
        """Count and raise the typed rejection (admission lock held)."""
        self.sheds += 1
        self.tracer.count("serving.sheds")
        if self.telemetry.enabled:
            self._m_sheds.inc()
        raise policy.OverloadedError(
            f"request shed: {why}", queue_depth=tenant.depth,
            queue_limit=self.queue_limit or None, model_id=tenant.model_id)

    def predict(self, x, bound: policy.ReadBound | None = None, *,
                min_clock: int | None = None, max_age_s: float | None = None,
                model_id: int = 0, timeout: float = 30.0) -> Prediction:
        """Sync predict; raises StalenessError when the bound rejects and
        OverloadedError when admission control sheds."""
        if bound is None and (min_clock is not None or max_age_s is not None):
            bound = policy.ReadBound(min_clock=min_clock, max_age_s=max_age_s)
        done = threading.Event()
        box: list = []

        def _cb(result):
            box.append(result)
            done.set()

        self.submit(x, bound, _cb, model_id=model_id)
        if not done.wait(timeout):
            raise TimeoutError("prediction timed out")
        result = box[0]
        if isinstance(result, BaseException):
            raise result
        return result

    # -- batcher loop --------------------------------------------------------

    def _loop(self) -> None:
        while True:
            first = self._q.get()
            if first is _SENTINEL:
                return
            batch = [first]
            stop = False
            # instant drain: rows queued while the last window served
            # join at no wait.  A calibrated auto engine sizes the drain
            # by regime: below the engage threshold ONE row per cycle
            # (staggered wake-ups); once batching engages, the backlog
            # minus one row, so the batcher re-enters get() hot and the
            # clients' wake-ups overlap the next dispatch
            limit = self.max_batch
            if self.auto:
                cost = self._tenants[first.model_id].cost
                if cost.calibrated:
                    limit = 1 if cost.bypass() \
                        else min(limit, max(1, self._q.qsize()))
            while len(batch) < limit:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is _SENTINEL:
                    stop = True
                    break
                batch.append(nxt)
            # the window opens only when the drain ran the queue dry: a
            # calibrated auto engine waits as long as the arrival rate
            # needs to fill the batch, otherwise the configured deadline
            if not stop and len(batch) < limit:
                deadline = time.monotonic() + self._window_s(first)
                while len(batch) < self.max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        nxt = self._q.get(timeout=remaining)
                    except queue.Empty:
                        break
                    if nxt is _SENTINEL:
                        stop = True
                        break
                    batch.append(nxt)
            self._serve(batch)
            if stop:
                return

    def queue_depth(self) -> int:
        """Admitted-but-unserved requests right now."""
        return self._depth

    def _window_s(self, first: _Request) -> float:
        tenant = self._tenants[first.model_id]
        if self.auto and tenant.cost.calibrated:
            return tenant.cost.window_s(1, self.deadline_s)
        return self.deadline_s

    def _serve(self, batch: list[_Request], mode: str = "batch") -> None:
        cost = self._tenants[batch[0].model_id].cost
        with self._admission:
            self.requests += len(batch)
            if mode == "bypass":
                self.bypasses += len(batch)
            for req in batch:
                self._tenants[req.model_id].depth -= 1
            self._depth -= len(batch)
            if self.telemetry.enabled:
                self._m_queue_depth.set(self._depth)
        TRACE_COUNTS[mode] += 1
        if FLIGHT.enabled:
            FLIGHT.record("serving.batch", n=len(batch),
                          depth=self._depth, mode=mode,
                          occupancy=round(cost.occupancy, 2),
                          break_even=round(cost.break_even, 2))
            FLIGHT.beat("serving")
        if self.telemetry.enabled:
            self._m_requests.inc(len(batch))
            self._m_mode[mode].inc()
        # the backlog a full drain could have collected now: the demand
        # sample (None for bypass serves, which never see the queue)
        avail = None
        if mode == "batch":
            avail = min(self.max_batch, len(batch) + self._q.qsize())
        # group by tenant in arrival order: one window serves every model
        # family present in it
        groups: dict[int, list[_Request]] = {}
        for req in batch:
            groups.setdefault(req.model_id, []).append(req)
        t_start = time.monotonic()
        for model_id in sorted(groups):
            self._serve_tenant(self._tenants[model_id],
                               groups[model_id], mode, avail)
        # the window's service time feeds the predictive shed
        dt = time.monotonic() - t_start
        with self._admission:
            self._ewma_batch_s = dt if self._ewma_batch_s is None \
                else 0.2 * dt + 0.8 * self._ewma_batch_s

    def _serve_tenant(self, tenant: _Tenant, batch: list[_Request],
                      mode: str = "batch",
                      avail: int | None = None) -> None:
        # one snapshot per tenant micro-batch: every row is answered
        # from the same hot-swapped (theta, clock) pair
        snap = tenant.registry.latest
        now = self._now()
        if self.telemetry.enabled and snap is not None:
            # read-side staleness: the answering snapshot's age at serve
            # time (one sample per micro-batch)
            self._m_snapshot_age.observe(
                max(0.0, (now - snap.wall_time) * 1e3))
        live: list[_Request] = []
        for req in batch:
            try:
                policy.check(snap, req.bound, now)
            except policy.StalenessError as err:
                with self._admission:
                    self.rejections += 1
                self.tracer.count("serving.staleness_rejections")
                if self.telemetry.enabled:
                    self._m_rejections.inc()
                self._finish(req, err)
                continue
            live.append(req)
        if not live:
            return
        try:
            out = self._dispatch(tenant, snap, live, mode, avail)
        except Exception as err:  # noqa: BLE001 — fail the rows, not the loop
            with self._admission:
                self.errors += 1
            for req in live:
                self._finish(req, err)
            return
        with self._admission:
            # bypass serves run on caller threads beside the batcher
            self.batches += 1
            self.batched_rows += len(live)
        self.tracer.count("serving.batch_dispatches")
        if self.telemetry.enabled:
            self._m_batch_size.observe(len(live))
        for i, req in enumerate(live):
            self._finish(req, Prediction(int(out[0, i]), float(out[1, i]),
                                         snap.vector_clock, snap.wall_time))

    def _dispatch(self, tenant: _Tenant, snap, live: list[_Request],
                  mode: str = "batch", avail: int | None = None):
        fn = self._predict_fn(tenant)
        # a power-of-two bucket of the live count: batch size, not
        # dispatch count, absorbs the offered rate
        rows = _bucket(len(live), self.max_batch) if self.adaptive \
            else self.max_batch
        self._note_shape(tenant, rows)
        t0 = time.monotonic()
        xs = np.zeros((rows, tenant.task.cfg.num_features),
                      dtype=np.float32)
        for i, req in enumerate(live):
            xs[i, :req.x.size] = req.x[:xs.shape[1]]
        self._use_device(snap.theta)
        with self.tracer.span("serving.predict", rows=len(live)):
            if snap.trace is not None and snap.seq > tenant.last_traced_seq:
                # the delta.wire flow ends at this snapshot's FIRST read:
                # solve -> wire -> apply -> publish -> here
                tenant.last_traced_seq = snap.seq
                self.tracer.flow_end("delta.wire", snap.trace,
                                     clock=snap.vector_clock)
            out = fn(snap.theta, xs)
        # the same sample calibrates the cost model: assembly, forward
        # and the read-back, one bucket
        tenant.cost.observe_dispatch(len(live), rows,
                                     time.monotonic() - t0,
                                     batched=(mode == "batch"),
                                     avail=avail)
        return out

    def _use_device(self, theta) -> None:
        """Make theta's card current on this thread once (the batcher and
        bypass callers launch work; a thread without a current device
        would run on device 0's context)."""
        if isinstance(theta, torch.Tensor) and theta.is_cuda \
                and getattr(self._device_set, "device", None) != theta.device:
            torch.cuda.set_device(theta.device)
            self._device_set.device = theta.device

    def _note_shape(self, tenant: _Tenant, rows: int) -> None:
        """Count a first-seen dispatch shape (the TRACE_COUNTS surface)."""
        fresh = False
        with self._admission:
            if rows not in tenant.compiled:
                tenant.compiled.add(rows)
                fresh = True
        if fresh:
            TRACE_COUNTS["compiles"] += 1

    def _predict_fn(self, tenant: _Tenant):
        if tenant.predict is None:
            # double-checked under the admission lock: bypass serves run
            # on caller threads, so two first dispatches can race here
            with self._admission:
                if tenant.predict is None:
                    tenant.predict = make_forward(tenant.task)
        return tenant.predict

    def warmup(self, model_id: int = 0) -> int:
        """Dispatch every adaptive bucket shape of a tenant once against
        its current snapshot (a no-op when none is published), then time
        a second call per bucket to seed the dispatch cost model: a
        warmed engine is calibrated before its first request, and no
        first-call cost lands in a client's p99.  Returns the number of
        shapes."""
        tenant = self._tenants[model_id]
        snap = tenant.registry.latest
        if snap is None:
            return 0
        fn = self._predict_fn(tenant)
        self._use_device(snap.theta)
        shapes = 0
        b = 1 if self.adaptive else self.max_batch
        while True:
            xs = np.zeros((b, tenant.task.cfg.num_features), np.float32)
            fn(snap.theta, xs)
            self._note_shape(tenant, b)
            t0 = time.monotonic()
            fn(snap.theta, xs)
            tenant.cost.seed(b, time.monotonic() - t0)
            shapes += 1
            if b >= self.max_batch:
                return shapes
            b <<= 1

    def _finish(self, req: _Request, result) -> None:
        elapsed = time.monotonic() - req.t0
        self.latency.record(elapsed)
        if self.telemetry.enabled:
            self._m_latency.observe(elapsed * 1e3)
        try:
            req.callback(result)
        except Exception:  # noqa: BLE001 — a callback must not stall serving
            # the batcher and bypass callers finish rows at once
            with self._admission:
                self.callback_errors += 1
            self.tracer.count("serving.callback_errors")

    # -- ops surface ---------------------------------------------------------

    def stats(self) -> dict:
        occupancy = (round(self.batched_rows / self.batches, 2)
                     if self.batches else 0.0)
        cost = self._tenants[0].cost
        out = {"requests": self.requests, "batches": self.batches,
               "occupancy": occupancy, "rejections": self.rejections,
               "sheds": self.sheds, "queue_depth": self._depth,
               "errors": self.errors, "bypasses": self.bypasses,
               # the regime the next lone request would be served in
               "mode": ("bypass" if self.auto and cost.bypass()
                        else "batch"),
               "break_even": round(cost.break_even, 2),
               "arrival_qps": round(cost.arrival_qps, 1)}
        out.update(self.latency.percentiles_ms(50, 99))
        return out

    def close(self, timeout: float = 30.0) -> None:
        """Stop the batcher thread.  Call before interpreter exit: the
        thread may be inside a CUDA call."""
        if self._closed:
            return
        self._closed = True
        self._q.put(_SENTINEL)
        self._thread.join(timeout)
