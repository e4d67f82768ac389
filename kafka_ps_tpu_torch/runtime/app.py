"""System assembly + drive loops (counterpart of kafka_ps_tpu/runtime/app.py).

Wires: CSV stream producer → per-worker sliding buffers, WorkerNodes ↔
ServerNode over the in-process fabric, with three drive modes:

  * `run_serial` — deterministic single-thread scheduler;
  * `run_threaded` — one thread per worker, the server on the calling
    thread (the reference's stream threads).  A worker's exception stops
    the run and is re-raised (failure policy "halt"), or evicts the
    worker and the run goes on with the survivors ("rebalance", with a
    heartbeat for hung workers); a CUDA error always halts;
  * `run_fused_bsp` — the sequential model without messages: each round
    is one gang kernel call over all active workers plus the server's
    apply (parallel/bsp.py), stretches between eval clocks run as chunks
    of FUSED_CHUNK_ROUNDS rounds (one CUDA graph replay on the card).

The first two run gang dispatch when cfg.use_gang (runtime/gang.py), and
the server's evaluations go to the async eval engine when cfg.eval_async
and there is a test set (evaluation/engine.py); the fused path evaluates
inline.  With cfg.compress the server gets a weights compressor and each
worker an error-feedback residual (compress/); rows meant for an evicted
worker go round-robin to the survivors.  On a durable fabric
(log/durable_fabric.py) every message and stream row is logged, and
`recover_durable` replays the unconsumed tail after a checkpoint
restore.  `enable_serving` attaches the online serving plane (serving/):
the server publishes a snapshot at every gate release, the fused loop at
every chunk boundary, and a PredictionEngine answers reads from them.
`enable_tiering` gives the server's theta to a tiered store (store/)
under cfg.tier's byte caps, with its policy thread running.

Telemetry: `tracer` and `telemetry` (null by default) go to the fabric,
the buffers, the server, the workers, the gang and the eval engine.  The
app counts `data.replay_skipped_rows` and `data.rerouted_rows`, the fused
loop's rounds are `bsp.step` spans with a `bsp.steps` count, and
`status()` is the pulse the drive loops print every `status_every`
seconds as a `[status]` line (utils/status.py).
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np
import torch

from kafka_ps_tpu_torch.data.buffer import SlidingBuffer
from kafka_ps_tpu_torch.data.stream import CsvStreamProducer
from kafka_ps_tpu_torch.parallel import bsp
from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime.messages import LabeledData
from kafka_ps_tpu_torch.runtime.server import LogSink, ServerNode
from kafka_ps_tpu_torch.runtime.worker import WorkerNode
from kafka_ps_tpu_torch.telemetry.registry import NULL_TELEMETRY
from kafka_ps_tpu_torch.utils import asynclog
from kafka_ps_tpu_torch.utils.asynclog import DeferredSink
from kafka_ps_tpu_torch.utils.config import (SEQUENTIAL, PSConfig,
                                             resolve_device)
from kafka_ps_tpu_torch.utils.csvlog import NullLogSink
from kafka_ps_tpu_torch.utils.trace import NULL_TRACER


def _device_fault(e: BaseException | None) -> bool:
    """True when `e`, or an exception it wraps, is an error of the CUDA
    device or its runtime: it poisons the context that every worker
    shares, so no worker can be evicted and the rest carry on.  A
    GangError is one when any of its members' failures is."""
    if any(map(_device_fault, getattr(e, "failures", ()))):
        return True
    fault = getattr(torch, "AcceleratorError", ())
    seen = set()
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if isinstance(e, fault) or "CUDA error" in str(e):
            return True
        e = e.__cause__ or e.__context__
    return False


class StreamingPSApp:
    """One process hosting the server + N logical workers.

    `device` follows utils.config.resolve_device: CUDA unless the caller
    passes device="cpu" or sets KPS_PLATFORM=cpu."""

    def __init__(self, cfg: PSConfig,
                 test_x: np.ndarray | None = None,
                 test_y: np.ndarray | None = None,
                 server_log: LogSink | None = None,
                 worker_log: LogSink | None = None,
                 clock_ms=None,
                 device=None,
                 fabric=None,
                 tracer=None,
                 telemetry=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tracer = tracer or NULL_TRACER
        self.telemetry = telemetry or NULL_TELEMETRY
        # a durable fabric (log/durable_fabric.py, `--durable-log`) may be
        # handed in; the default is the volatile in-memory one
        self.fabric = (fabric if fabric is not None
                       else fabric_mod.Fabric(tracer=self.tracer))
        self.buffers = [
            SlidingBuffer(cfg.model.num_features, cfg.buffer,
                          clock_ms=clock_ms, telemetry=self.telemetry,
                          worker=w)
            for w in range(cfg.num_workers)]
        # one device copy of the test set, read by the server and every
        # worker
        if test_x is not None:
            test_x = torch.as_tensor(test_x, dtype=torch.float32,
                                     device=self.device)
            test_y = torch.as_tensor(test_y, dtype=torch.int32,
                                     device=self.device)
        # deferred sinks: rows carry device scalars, formatted when ready
        # and force-flushed at drive-loop exit
        server_log = DeferredSink(server_log or NullLogSink())
        worker_log = DeferredSink(worker_log or NullLogSink())
        self.server = ServerNode(cfg, self.fabric, self.device, test_x,
                                 test_y, server_log, tracer=self.tracer,
                                 telemetry=self.telemetry)
        self.workers = [
            WorkerNode(w, cfg, self.fabric, self.buffers[w], self.device,
                       test_x, test_y, worker_log, tracer=self.tracer,
                       telemetry=self.telemetry)
            for w in range(cfg.num_workers)]
        self._stop = threading.Event()
        self.gang = None             # the last drive loop's dispatcher
        self.eval_engine = None
        # fused BSP (step, multi_step) per active-worker count, and the
        # counts of the fused rounds run: all, in chunks, chunk dispatches
        self._fused_programs: dict = {}
        self._fused_slab = None
        self.fused_stats = {"rounds": 0, "chunk_rounds": 0, "chunks": 0}
        # the serving plane's engine (enable_serving); None: a trainer only
        self.serving_engine = None
        # compressed delta transport: one weights compressor on the
        # server, one error-feedback residual per worker ({} when off);
        # the residuals ride the server's checkpoint beside the buffers
        self.compressors: dict[int, object] = {}
        if cfg.compress not in (None, "", "none"):
            from kafka_ps_tpu_torch import compress
            codec = compress.get_codec(compress.parse_codec(cfg.compress),
                                       self.server.task.num_params)
            self.server.compressor = compress.WeightsCompressor(codec)
            for w in self.workers:
                w.compressor = compress.ErrorFeedback(codec, self.device)
                self.compressors[w.worker_id] = w.compressor
            self.server.checkpoint_residuals = self.compressors
        # rows of evicted workers sent to survivors, and the evictions of
        # the last threaded run: (worker, exception or reason)
        self.rerouted_rows = 0
        self.worker_failures: list[tuple[int, BaseException | str]] = []
        # the iteration a checkpoint restored, and the seconds it took
        self.restored_at: int | None = None
        self.restore_s = 0.0
        # durable resume: leading stream rows to drop because the log
        # already holds them (the producer re-produces the same global row
        # order, so "skip the first N" is exactly-once re-ingestion; set
        # by recover_durable), the rows dropped so far, and the replay's
        # counts per topic and seconds
        self._ingest_skip = 0
        self.skipped_rows = 0
        self.replay_counts: dict[str, int] | None = None
        self.replay_s = 0.0
        if cfg.eval_async and test_x is not None:
            self.enable_async_eval()

    # -- async eval plane -----------------------------------------------------

    def enable_async_eval(self):
        """Attach the async eval engine to the server: eval-cadence
        applies hand (theta, clock) to its thread, which emits the rows
        back through `server._emit_eval` in clock order.  Idempotent;
        returns the engine (None without a test set)."""
        if self.eval_engine is None and self.server.test_x is not None:
            from kafka_ps_tpu_torch.evaluation.engine import EvalEngine
            self.eval_engine = self.server.attach_eval_engine(EvalEngine(
                self.server.task, self.server.test_x, self.server.test_y,
                self.server._emit_eval, telemetry=self.telemetry,
                tracer=self.tracer))
        return self.eval_engine

    def close_eval(self) -> None:
        """Evaluate what is pending and join the engine thread."""
        if self.eval_engine is not None:
            self.eval_engine.close()

    # -- serving plane (serving/) ---------------------------------------------

    def enable_serving(self):
        """Attach the serving plane: a SnapshotRegistry on the server (a
        publication at every gate release) and a PredictionEngine
        batching reads against it, sized by cfg.serving.  Idempotent;
        returns the engine."""
        if self.serving_engine is None:
            from kafka_ps_tpu_torch.serving.engine import make_engine
            from kafka_ps_tpu_torch.serving.snapshot import SnapshotRegistry
            registry = SnapshotRegistry(
                capacity=self.cfg.serving.ring_capacity)
            self.server.serving = registry
            self.serving_engine = make_engine(
                self.server.task, registry, self.cfg.serving,
                tracer=self.tracer, telemetry=self.telemetry)
        return self.serving_engine

    def close_serving(self) -> None:
        """Join the engine's batcher thread (it may be inside a CUDA call:
        join it before interpreter exit)."""
        if self.serving_engine is not None:
            self.serving_engine.close()

    # -- tiered residency (store/) --------------------------------------------

    def enable_tiering(self, cold_dir: str | None = None):
        """Attach a TieredParamStore over the whole parameter vector, on
        the server's device, per cfg.tier, and start its policy thread.
        `cold_dir` holds the cold partition (needed when the warm tier is
        capped; the CLI passes `<durable-log>/param-cold`).  Returns the
        store, or None when both caps are 0 (theta stays resident)."""
        if self.server.param_store is not None:
            return self.server.param_store
        from kafka_ps_tpu_torch.runtime.messages import KeyRange
        from kafka_ps_tpu_torch.store import attach_tiered_store
        return attach_tiered_store(
            self.server, self.cfg.tier,
            KeyRange(0, self.server.task.num_params), cold_dir)

    def close_tiering(self) -> None:
        """Join the policy thread and close the cold log; after the final
        checkpoint save, which may still read cold pages."""
        if self.server.param_store is not None:
            self.server.param_store.close()

    # -- ingestion sink (the INPUT_DATA topic hop) ----------------------------

    def data_sink(self, worker: int, features, label: int) -> None:
        """One stream row (a {feature: value} dict, or a dense row) into
        its worker's buffer.  On a durable fabric the row is logged under
        its FINAL key (after any reroute) and marked consumed as it is
        inserted, under the fabric's commit lock, so the ingest group's
        offsets count the buffered rows at every commit point."""
        if self._ingest_skip > 0:
            # durable resume: the log (and, via checkpoint + replay, a
            # buffer) already holds this row
            self._ingest_skip -= 1
            self.skipped_rows += 1
            self.tracer.count("data.replay_skipped_rows")
            return
        if not self.server.tracker.tracker[worker].active:
            # partition reassignment: an evicted worker's rows go
            # round-robin to the survivors
            active = self.server.tracker.active_workers
            worker = active[self.rerouted_rows % len(active)]
            self.rerouted_rows += 1
            self.tracer.count("data.rerouted_rows")
        if not self.fabric.durable:
            self.buffers[worker].add(features, label)
            return
        if not isinstance(features, dict):
            features = dict(enumerate(
                np.asarray(features, dtype=np.float32).tolist()))
        with self.fabric.commit_lock:
            offset = self.fabric.persist(
                fabric_mod.INPUT_DATA_TOPIC, worker,
                LabeledData(features=features, label=label))
            self.buffers[worker].add(features, label)
            self.fabric.mark_consumed(fabric_mod.INPUT_DATA_TOPIC, worker,
                                      offset)

    def make_producer(self, csv_path: str,
                      has_header: bool = True) -> CsvStreamProducer:
        return CsvStreamProducer(
            csv_path, self.cfg.num_workers, self.data_sink,
            time_per_event_ms=self.cfg.stream.time_per_event_ms,
            prefill_per_worker=self.cfg.stream.prefill_per_worker,
            has_header=has_header,
            num_features=self.cfg.model.num_features)

    def wait_for_prefill(self, min_per_worker: int = 1,
                         timeout: float = 60.0) -> None:
        """Wait until every active worker's buffer holds `min_per_worker`
        rows (an evicted worker's rows are rerouted)."""
        deadline = time.monotonic() + timeout
        waiting = self.server.tracker.active_workers
        while any(self.buffers[w].count < min_per_worker for w in waiting):
            if time.monotonic() > deadline:
                raise TimeoutError("buffers not prefilled in time")
            time.sleep(0.01)

    def wait_for_stream_settle(self, producer,
                               timeout: float = 120.0) -> None:
        """Wait until the producer's unthrottled prefill burst is done
        (prefill rows sent, stream ended, or producer stopped), so early
        windows do not race the burst."""
        prefill = self.cfg.num_workers * self.cfg.stream.prefill_per_worker
        deadline = time.monotonic() + timeout
        while (producer.rows_sent < prefill
               and not producer.finished.is_set()
               and not producer.stopped.is_set()):
            if time.monotonic() > deadline:
                return
            time.sleep(0.005)

    # -- durable-log recovery (log/durable_fabric.py) -------------------------

    def recover_durable(self) -> dict[str, int]:
        """Crash recovery over a durable fabric, run once AFTER the
        checkpoint restore and BEFORE the producer starts:

          * re-enqueue the unconsumed WEIGHTS / GRADIENTS tail (the
            in-flight messages the dead process held), on this app's
            device;
          * replay the unconsumed INPUT_DATA tail into the restored
            buffers (rows ingested after the last checkpoint);
          * arm the re-ingestion skip, so that the restarted producer
            drops the rows the log already holds.

        The replay floor is the checkpoint's recorded offsets when the
        restore found any (`server.restored_log_offsets`), else the
        durably committed ones.  Returns replay counts per topic."""
        t0 = time.perf_counter()
        ckpt_offsets = self.server.restored_log_offsets
        counts = self.fabric.recover(ckpt_offsets)
        replayed_rows = 0
        total_logged = 0
        manager = self.fabric.manager
        for topic, key in manager.partitions(fabric_mod.INPUT_DATA_TOPIC):
            total_logged += manager.get(topic, key).next_offset
            for offset, row in self.fabric.replay(topic, key, ckpt_offsets):
                self.buffers[key].add(row.features, row.label)
                self.fabric.mark_consumed(topic, key, offset)
                replayed_rows += 1
        self._ingest_skip = total_logged
        counts[fabric_mod.INPUT_DATA_TOPIC] = replayed_rows
        self.replay_counts = counts
        self.replay_s = time.perf_counter() - t0
        return counts

    # -- membership and checkpoints -------------------------------------------

    def readmit_worker(self, worker_id: int) -> int:
        """Rejoin an evicted worker on the server, and reset its grace
        baseline so the supervisor grants its first iteration since
        rejoining the 10x heartbeat grace."""
        clock = self.server.readmit_worker(worker_id)
        w = self.workers[worker_id]
        w.iterations_at_join = w.iterations
        w.last_progress = time.monotonic()
        return clock

    def restore_checkpoint(self, path: str) -> bool:
        """Restore a checkpoint, if `path` exists, into the server, the
        buffers and the residuals.  Only before any drive loop ran: the
        fused slab cache and the in-flight messages of a started loop
        predate the restored state."""
        if self.server._loop_started or self.fused_stats["rounds"]:
            raise RuntimeError("restore a checkpoint before the first drive "
                               "loop, not after it")
        from kafka_ps_tpu_torch.utils import checkpoint as ckpt
        t0 = time.perf_counter()
        if not ckpt.maybe_restore(path, self.server, buffers=self.buffers,
                                  residuals=self.compressors or None):
            return False
        self.restored_at = self.server.iterations
        self.restore_s = time.perf_counter() - t0
        return True

    def build_kernels(self) -> None:
        """Build every CUDA kernel now, on the card (a no-op on the CPU):
        the first CUDA call would otherwise run nvcc inside a worker's
        first iteration, where a heartbeat could take the build for a
        hang."""
        if self.device.type == "cuda":
            from kafka_ps_tpu_torch.ops import _build
            _build.build(_build.sources())

    # -- live observability (utils/status.py) --------------------------------

    def status(self) -> dict:
        """One sample of the runtime's pulse, printed by StatusReporter
        as the periodic `[status]` line (`status_every`): the JAX app's
        keys, less `critpath` and `modelhealth` (their planes are not
        ported yet).  Host state only."""
        tr = self.server.tracker
        active = tr.active_workers
        out = {
            "iters": self.server.iterations,
            "clocks": [f"{w}:{tr.tracker[w].vector_clock}"
                       for w in range(self.cfg.num_workers)],
            "active": f"{len(active)}/{self.cfg.num_workers}",
            "pending": {
                "weights": self.fabric.total_pending(
                    fabric_mod.WEIGHTS_TOPIC),
                "gradients": self.fabric.total_pending(
                    fabric_mod.GRADIENTS_TOPIC)},
            "buffers": [b.count for b in self.buffers],
        }
        if self.eval_engine is not None:
            out["eval_lag"] = self.eval_engine.lag_clocks
        if self.serving_engine is not None:
            s = self.serving_engine.stats()
            # a cumulative count under a *_per_s key: the reporter prints
            # the rate since the last line (predictions per second)
            out["predictions_per_s"] = s["requests"]
            out["serving"] = {
                "occ": s["occupancy"], "p50_ms": s["p50_ms"],
                "p99_ms": s["p99_ms"], "stale": s["rejections"]}
        if self.telemetry.enabled:
            out["metrics"] = self.telemetry.summary()
        return out

    def _start_status(self, status_every: float | None):
        from kafka_ps_tpu_torch.utils.status import StatusReporter
        return StatusReporter(status_every or 0.0, self.status).start()

    # -- drive loops ----------------------------------------------------------

    def _sinks(self):
        return (self.server.log,
                *{id(w.log): w.log for w in self.workers}.values())

    def flush_logs(self) -> None:
        """Force every deferred log row out (waits on the device).
        Pending async evals drain FIRST: their rows enter the server
        sink before the sink is flushed."""
        if self.eval_engine is not None:
            self.eval_engine.drain()
        for sink in self._sinks():
            flush = getattr(sink, "flush", None)
            if flush is not None:
                flush()

    def close_logs(self) -> None:
        """Close the eval engine, then the deferred sinks: joins their
        threads and closes the wrapped file sinks, even when the engine
        reports a failed evaluation."""
        try:
            self.close_eval()
        finally:
            for sink in self._sinks():
                close = getattr(sink, "close", None)
                if close is not None:
                    close()

    def _make_gang(self):
        """The gang dispatcher for a drive loop, or None with gang
        dispatch off."""
        if not self.cfg.use_gang:
            return None
        from kafka_ps_tpu_torch.runtime.gang import GangDispatcher
        self.gang = GangDispatcher(self.workers, self.fabric, self.cfg,
                                   tracer=self.tracer,
                                   telemetry=self.telemetry)
        return self.gang

    def _queued_gradients(self, max_server_iterations: int, first=None):
        """The gradients already queued, `first` ahead of them, capped so
        that applying them all cannot overshoot the iteration budget."""
        batch = [] if first is None else [first]
        while self.server.iterations + len(batch) < max_server_iterations:
            g = self.fabric.poll(fabric_mod.GRADIENTS_TOPIC, 0)
            if g is None:
                break
            batch.append(g)
        return batch

    def _apply(self, batch) -> None:
        if len(batch) > 1:
            self.server.process_batch(batch)
        elif batch:
            self.server.process(batch[0])

    def run_serial(self, max_server_iterations: int, pump=None,
                   status_every: float | None = None) -> None:
        """Deterministic scheduler: alternate weights delivery and
        gradient processing until the server has applied
        `max_server_iterations` gradient messages.  `pump()` (optional)
        feeds more stream rows between rounds.

        With gang dispatch each round drains the release sets whole: the
        gang notices first (one batched kernel call per set), then the
        per-message stragglers, then the queued gradients as one batch
        for the server's chained apply.  Without it each round is
        strictly per message.  `status_every` > 0 prints a `[status]`
        line that often."""
        reporter = self._start_status(status_every)
        stalled_rounds = 0
        gang = self._make_gang()
        try:
            self.server.start_training_loop()
            while self.server.iterations < max_server_iterations:
                progressed = gang is not None and gang.drain_serial()
                for worker in self.workers:
                    msg = self.fabric.poll(fabric_mod.WEIGHTS_TOPIC,
                                           worker.worker_id)
                    if msg is not None:
                        worker.on_weights(msg)
                        progressed = True
                if gang is None:
                    while self.server.iterations < max_server_iterations:
                        g = self.fabric.poll(fabric_mod.GRADIENTS_TOPIC, 0)
                        if g is None:
                            break
                        self.server.process(g)
                        progressed = True
                else:
                    batch = self._queued_gradients(max_server_iterations)
                    self._apply(batch)
                    progressed = progressed or bool(batch)
                if pump is not None:
                    pump()
                # pump() only adds buffer rows, never messages: rounds
                # without progress are a protocol deadlock
                stalled_rounds = 0 if progressed else stalled_rounds + 1
                if stalled_rounds > (1000 if pump is not None else 0):
                    raise RuntimeError("deadlock: no deliverable messages")
        finally:
            reporter.stop()
            self.flush_logs()

    def run_threaded(self, max_server_iterations: int,
                     poll_timeout: float = 0.1,
                     failure_policy: str = "halt",
                     heartbeat_timeout: float | None = None,
                     status_every: float | None = None) -> None:
        """One thread per worker; the server on the calling thread, also
        the supervisor.

        `failure_policy="halt"`: any worker exception stops the run and
        is re-raised.  `"rebalance"`: a crashed worker (exception) or a
        hung one (no progress within `heartbeat_timeout` seconds while
        it owes a gradient) is evicted: the gates stop waiting for it,
        its rows reroute to the survivors (data_sink) and its in-flight
        gradients are dropped as zombies; the run goes on.  The last
        active worker is never evicted: its failure halts.  A CUDA error
        halts under either policy: it poisons the context every worker
        shares.  The kernels are built before the supervisor's clock
        starts.  `status_every` > 0 prints a `[status]` line that
        often."""
        if failure_policy not in ("halt", "rebalance"):
            raise ValueError(f"unknown failure_policy {failure_policy!r}")
        self._stop.clear()
        self.worker_failures = []
        worker_errors: list[BaseException] = []
        failed_q: deque[tuple[int, BaseException]] = deque()
        gang = self._make_gang()
        from kafka_ps_tpu_torch.runtime.gang import GangError
        self.build_kernels()

        def worker_loop(worker: WorkerNode):
            try:
                while not self._stop.is_set():
                    msg = self.fabric.poll_blocking(
                        fabric_mod.WEIGHTS_TOPIC, worker.worker_id,
                        timeout=poll_timeout)
                    if msg is None:
                        continue
                    if gang is None:
                        worker.on_weights(msg)
                        continue
                    try:
                        # the first arrival a gang notice covers leads
                        # the set; otherwise the message runs solo
                        gang.offer(worker, msg)
                    except GangError as e:
                        # the members' failures surface on the leader's
                        # thread: each is queued against its member, and
                        # the leader runs on unless it failed itself
                        if failure_policy != "rebalance" or _device_fault(e):
                            raise
                        failed_q.extend((f.worker_id, f) for f in e.failures)
                        if any(f.worker_id == worker.worker_id
                               for f in e.failures):
                            return
            except BaseException as e:   # surfaced on the server thread
                if failure_policy == "rebalance" and not _device_fault(e):
                    failed_q.append((worker.worker_id, e))
                else:
                    worker_errors.append(e)
                    self._stop.set()

        def evict(worker_id: int, reason) -> None:
            if not self.server.tracker.tracker[worker_id].active:
                return              # already evicted
            try:
                self.server.remove_worker(worker_id)
            except ValueError:      # the last active worker: halt
                self._stop.set()
                worker_errors.append(
                    reason if isinstance(reason, BaseException)
                    else RuntimeError(f"worker {worker_id}: {reason}"))
                return
            self.worker_failures.append((worker_id, reason))

        def supervise() -> None:
            # a crashed worker queues itself before its thread exits
            while failed_q:
                evict(*failed_q.popleft())
            if heartbeat_timeout is None:
                return
            now = time.monotonic()
            for w in list(self.server.tracker.active_workers):
                # hung: owes a gradient, that gradient is not queued
                # behind a slow server, and no sign of life within the
                # timeout, measured from the later of its own progress
                # and the server's send; the first iteration since
                # (re)admission gets 10x grace
                wk = self.workers[w]
                grace = 10.0 if wk.iterations == wk.iterations_at_join \
                    else 1.0
                baseline = max(wk.last_progress,
                               self.server.weights_sent_at[w])
                hung = (self.server.tracker.tracker[w].weights_message_sent
                        and not self.fabric.contains(
                            fabric_mod.GRADIENTS_TOPIC, 0,
                            lambda m, w=w: m.worker_id == w)
                        and now - baseline > heartbeat_timeout * grace)
                if hung:
                    evict(w, f"no heartbeat for {heartbeat_timeout}s")

        threads = [threading.Thread(target=worker_loop, args=(w,),
                                    daemon=True, name=f"worker-{w.worker_id}")
                   for w in self.workers]
        for t in threads:
            t.start()
        reporter = self._start_status(status_every)
        try:
            self.server.start_training_loop()
            while (self.server.iterations < max_server_iterations
                   and not self._stop.is_set()):
                g = self.fabric.poll_blocking(fabric_mod.GRADIENTS_TOPIC, 0,
                                              timeout=poll_timeout)
                if g is not None:
                    if gang is None:
                        self.server.process(g)
                    else:
                        # whatever else has ALREADY arrived joins this
                        # apply
                        self._apply(self._queued_gradients(
                            max_server_iterations, first=g))
                if failure_policy == "rebalance":
                    supervise()
        finally:
            reporter.stop()
            self._stop.set()
            for t in threads:
                t.join(timeout=60.0)
            self.flush_logs()
        if worker_errors:
            raise RuntimeError("worker thread failed") from worker_errors[0]

    # -- fused BSP ------------------------------------------------------------

    # rounds per fused chunk dispatch: enough to amortize the host's cost
    # of a dispatch, few enough that stream arrivals are picked up soon
    FUSED_CHUNK_ROUNDS = 8

    def run_fused_bsp(self, max_server_iterations: int,
                      log_metrics: bool = True,
                      status_every: float | None = None) -> None:
        """Sequential consistency as fused BSP rounds: each round is one
        full iteration of every active worker (all advance one clock),
        one gang kernel call on their slabs plus the server's apply
        (parallel/bsp.py).  Resumes from the minimum active clock.
        `status_every` > 0 prints a `[status]` line that often."""
        if self.cfg.consistency_model != SEQUENTIAL:
            raise ValueError("fused path implements the sequential model only")
        # only active workers take part
        active = self.server.tracker.active_workers
        task = self.server.task
        progs = self._fused_programs.get(len(active))
        if progs is None:
            progs = self._fused_programs[len(active)] = (
                bsp.make_bsp_step(self.cfg.model, len(active),
                                  self.cfg.server_lr, task=task),
                bsp.make_bsp_multi_step(self.cfg.model, len(active),
                                        self.cfg.server_lr,
                                        self.FUSED_CHUNK_ROUNDS, task=task))
        # under BSP all active clocks are equal; resume from the restored
        # one
        clock = min(self.server.tracker.tracker[w].vector_clock
                    for w in active)
        reporter = self._start_status(status_every)
        try:
            self._run_fused_loop(max_server_iterations, log_metrics, progs,
                                 self.server.theta, clock, active)
        finally:
            reporter.stop()
            self.flush_logs()

    def _upload_fused_slab(self, active):
        """The active workers' buffers stacked into [N, cap, F] (y, mask
        [N, cap]) and copied to the device once, from pinned memory on
        the card; the device tensors are reused across uploads."""
        snaps = []
        for w in active:
            sx, sy, sm = self.buffers[w].snapshot()
            if sm.sum() == 0:
                raise RuntimeError(
                    f"There is no data in the buffer of worker {w}")
            snaps.append((sx, sy, sm))
        host = [torch.from_numpy(np.stack([s[i] for s in snaps]))
                for i in range(3)]
        if self.device.type != "cuda":
            return host
        cache = self._fused_slab
        if cache is None or [tuple(t.shape) for t in cache[1]] != \
                [tuple(t.shape) for t in host]:
            pinned = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                      for t in host]
            dev = [torch.empty(t.shape, dtype=t.dtype, device=self.device)
                   for t in host]
            cache = self._fused_slab = [None, pinned, dev]
        done, pinned, dev = cache
        if done is not None:
            done.synchronize()     # the last copy out of pinned has run
        for p, h, d in zip(pinned, host, dev):
            p.copy_(h)
            d.copy_(p, non_blocking=True)
        cache[0] = torch.cuda.Event()
        cache[0].record(torch.cuda.current_stream(self.device))
        return dev

    def _run_fused_loop(self, max_server_iterations, log_metrics, progs,
                        theta, clock, active) -> None:
        step, multi_step = progs
        # A stretch with no eval clock in it runs CHUNK rounds as one
        # dispatch (parallel/bsp.make_bsp_multi_step: one CUDA graph
        # replay on the card); a chunk never crosses an eval clock, and
        # any shorter stretch runs round by round, so eval_every=1 is
        # always per round.
        CHUNK = self.FUSED_CHUNK_ROUNDS
        n = len(active)
        evaluate = log_metrics and self.server.test_x is not None
        x = y = mask = None
        slab_versions: list[int] | None = None
        while self.server.iterations < max_server_iterations:
            # the slab cache is keyed by num_tuples_seen, which grows with
            # every insert: between arrivals the rounds re-train on the
            # same device slabs
            versions = [self.buffers[w].num_tuples_seen for w in active]
            if versions != slab_versions:
                x, y, mask = self._upload_fused_slab(active)
                slab_versions = versions
            # rounds until the run cap / the next eval clock
            rounds_left = -((self.server.iterations - max_server_iterations)
                            // n)
            r = min(CHUNK, rounds_left)
            if evaluate:
                r = min(r, self.cfg.eval_every
                        - (clock % self.cfg.eval_every))
            losses = None
            use_chunk = r == CHUNK
            if not use_chunk:
                r = 1
            with self.tracer.span("bsp.step", clock=clock + 1, rounds=r):
                if use_chunk:
                    theta, losses = multi_step(theta, x, y, mask)
                    last_loss = losses[-1]
                else:
                    theta, mean_loss = step(theta, x, y, mask)
                    last_loss = mean_loss
                if self.tracer.enabled:
                    # the span waits for the round's loss, so that it
                    # measures the step and not its launch (a graph
                    # replay, outside any capture); the rows keep the
                    # device tensor
                    float(last_loss)
            self.tracer.count("bsp.steps")
            if use_chunk:
                self.fused_stats["chunks"] += 1
                self.fused_stats["chunk_rounds"] += r
            self.fused_stats["rounds"] += r
            clock += r
            self.server.iterations += r * n
            # theta is replaced, never mutated (runtime/server.py)
            self.server.theta = theta
            for w in active:
                self.workers[w].iterations += r
                self.server.tracker.tracker[w].vector_clock = clock
                self.server.tracker.tracker[w].weights_message_sent = True
            # the chunk boundary is the gate release: every active worker
            # reached `clock`
            self.server.publish_snapshot()
            self.server.maybe_checkpoint()
            if not evaluate:
                continue
            is_eval = clock % self.cfg.eval_every == 0
            now = int(time.time() * 1000)
            m = None
            if is_eval:
                m = self.server.task.evaluate(theta, self.server.test_x,
                                              self.server.test_y)
                asynclog.submit_or_write(
                    self.server.log, f"{now};-1;{clock};{{}};{{}};{{}}",
                    m.loss, m.f1, m.accuracy)
            # Worker rows keep the per-node schema and cadence: one row per
            # worker per CLOCK, clock-major, the reference's -1
            # placeholders off cadence and the shared test metrics on it
            # (the weights are replicated under BSP).  A chunk logs each
            # of its rounds with that round's mean local loss.
            # numTuplesSeen is chunk-granular: every row of a chunk stamps
            # the buffer version read after its dispatch (its rounds ran
            # on one slab).
            for i in range(r):
                ci = clock - r + 1 + i
                round_loss = losses[i] if losses is not None else mean_loss
                on_eval = is_eval and ci == clock
                f1 = m.f1 if on_eval else -1.0
                acc = m.accuracy if on_eval else -1.0
                for w in active:
                    asynclog.submit_or_write(
                        self.workers[w].log,
                        f"{now};{w};{ci};{{}};{{}};{{}};"
                        f"{self.buffers[w].num_tuples_seen}",
                        round_loss, f1, acc)

    def stop(self) -> None:
        self._stop.set()
