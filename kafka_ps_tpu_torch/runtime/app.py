"""System assembly + drive loops (counterpart of kafka_ps_tpu/runtime/app.py).

Wires: CSV stream producer → per-worker sliding buffers, WorkerNodes ↔
ServerNode over the in-process fabric, with two drive modes:

  * `run_serial` — deterministic single-thread scheduler;
  * `run_threaded` — one thread per worker, the server on the calling
    thread (the reference's stream threads).  A worker's exception stops
    the run and is re-raised (failure policy "halt").

Both run gang dispatch when cfg.use_gang (runtime/gang.py), and the
server's evaluations go to the async eval engine when cfg.eval_async
and there is a test set (evaluation/engine.py).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from kafka_ps_tpu_torch.data.buffer import SlidingBuffer
from kafka_ps_tpu_torch.data.stream import CsvStreamProducer
from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime.server import LogSink, ServerNode
from kafka_ps_tpu_torch.runtime.worker import WorkerNode
from kafka_ps_tpu_torch.utils.asynclog import DeferredSink
from kafka_ps_tpu_torch.utils.config import PSConfig, resolve_device
from kafka_ps_tpu_torch.utils.csvlog import NullLogSink


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
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.fabric = fabric_mod.Fabric()
        self.buffers = [
            SlidingBuffer(cfg.model.num_features, cfg.buffer,
                          clock_ms=clock_ms)
            for _ in range(cfg.num_workers)]
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
                                 test_y, server_log)
        self.workers = [
            WorkerNode(w, cfg, self.fabric, self.buffers[w], self.device,
                       test_x, test_y, worker_log)
            for w in range(cfg.num_workers)]
        self._stop = threading.Event()
        self.gang = None             # the last drive loop's dispatcher
        self.eval_engine = None
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
                self.server._emit_eval))
        return self.eval_engine

    def close_eval(self) -> None:
        """Evaluate what is pending and join the engine thread."""
        if self.eval_engine is not None:
            self.eval_engine.close()

    # -- ingestion sink (the INPUT_DATA topic hop) ----------------------------

    def data_sink(self, worker: int, features: dict[int, float],
                  label: int) -> None:
        self.buffers[worker].add(features, label)

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
        """Wait until every worker's buffer holds `min_per_worker` rows."""
        deadline = time.monotonic() + timeout
        while any(b.count < min_per_worker for b in self.buffers):
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
        self.gang = GangDispatcher(self.workers, self.fabric, self.cfg)
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

    def run_serial(self, max_server_iterations: int, pump=None) -> None:
        """Deterministic scheduler: alternate weights delivery and
        gradient processing until the server has applied
        `max_server_iterations` gradient messages.  `pump()` (optional)
        feeds more stream rows between rounds.

        With gang dispatch each round drains the release sets whole: the
        gang notices first (one batched kernel call per set), then the
        per-message stragglers, then the queued gradients as one batch
        for the server's chained apply.  Without it each round is
        strictly per message."""
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
            self.flush_logs()

    def run_threaded(self, max_server_iterations: int,
                     poll_timeout: float = 0.1) -> None:
        """One thread per worker; the server on the calling thread.  Any
        worker exception stops the run and is re-raised."""
        self._stop.clear()
        worker_errors: list[BaseException] = []
        gang = self._make_gang()

        def worker_loop(worker: WorkerNode):
            try:
                while not self._stop.is_set():
                    msg = self.fabric.poll_blocking(
                        fabric_mod.WEIGHTS_TOPIC, worker.worker_id,
                        timeout=poll_timeout)
                    if msg is None:
                        continue
                    if gang is not None:
                        # the first arrival a gang notice covers leads
                        # the set; otherwise the message runs solo
                        gang.offer(worker, msg)
                    else:
                        worker.on_weights(msg)
            except BaseException as e:   # surfaced on the server thread
                worker_errors.append(e)
                self._stop.set()

        threads = [threading.Thread(target=worker_loop, args=(w,),
                                    daemon=True, name=f"worker-{w.worker_id}")
                   for w in self.workers]
        for t in threads:
            t.start()
        try:
            self.server.start_training_loop()
            while (self.server.iterations < max_server_iterations
                   and not self._stop.is_set()):
                g = self.fabric.poll_blocking(fabric_mod.GRADIENTS_TOPIC, 0,
                                              timeout=poll_timeout)
                if g is None:
                    continue
                if gang is None:
                    self.server.process(g)
                else:
                    # whatever else has ALREADY arrived joins this apply
                    self._apply(self._queued_gradients(
                        max_server_iterations, first=g))
        finally:
            self._stop.set()
            for t in threads:
                t.join(timeout=60.0)
            self.flush_logs()
        if worker_errors:
            raise RuntimeError("worker thread failed") from worker_errors[0]

    def stop(self) -> None:
        self._stop.set()
