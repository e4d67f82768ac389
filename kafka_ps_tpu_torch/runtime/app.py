"""System assembly + drive loops (counterpart of kafka_ps_tpu/runtime/app.py).

Wires: CSV stream producer → per-worker sliding buffers, WorkerNodes ↔
ServerNode over the in-process fabric, with two drive modes:

  * `run_serial` — deterministic single-thread scheduler;
  * `run_threaded` — one thread per worker, the server on the calling
    thread (the reference's stream threads).  A worker's exception stops
    the run and is re-raised (failure policy "halt").
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
        """Force every deferred log row out (waits on the device)."""
        for sink in self._sinks():
            flush = getattr(sink, "flush", None)
            if flush is not None:
                flush()

    def close_logs(self) -> None:
        """Close the deferred sinks: joins their drain threads and closes
        the wrapped file sinks."""
        for sink in self._sinks():
            close = getattr(sink, "close", None)
            if close is not None:
                close()

    def run_serial(self, max_server_iterations: int, pump=None) -> None:
        """Deterministic scheduler: alternate weights delivery and
        gradient processing until the server has applied
        `max_server_iterations` gradient messages.  `pump()` (optional)
        feeds more stream rows between rounds."""
        stalled_rounds = 0
        try:
            self.server.start_training_loop()
            while self.server.iterations < max_server_iterations:
                progressed = False
                for worker in self.workers:
                    msg = self.fabric.poll(fabric_mod.WEIGHTS_TOPIC,
                                           worker.worker_id)
                    if msg is not None:
                        worker.on_weights(msg)
                        progressed = True
                while self.server.iterations < max_server_iterations:
                    g = self.fabric.poll(fabric_mod.GRADIENTS_TOPIC, 0)
                    if g is None:
                        break
                    self.server.process(g)
                    progressed = True
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

        def worker_loop(worker: WorkerNode):
            try:
                while not self._stop.is_set():
                    msg = self.fabric.poll_blocking(
                        fabric_mod.WEIGHTS_TOPIC, worker.worker_id,
                        timeout=poll_timeout)
                    if msg is not None:
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
                if g is not None:
                    self.server.process(g)
        finally:
            self._stop.set()
            for t in threads:
                t.join(timeout=60.0)
            self.flush_logs()
        if worker_errors:
            raise RuntimeError("worker thread failed") from worker_errors[0]

    def stop(self) -> None:
        self._stop.set()
