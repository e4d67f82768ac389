"""Streaming ingestion simulator (counterpart of
kafka_ps_tpu/data/stream.py, Python parser only).

Reads a training CSV row by row, turns each row into a sparse sample
(zero features dropped, label = last column), assigns it round-robin to
a logical worker (row_count % num_workers) and paces delivery: the first
num_workers * prefill_per_worker rows go unthrottled, after which the
producer sleeps 1 s every (1000 / time_per_event_ms) rows.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterator

import numpy as np

Sink = Callable[[int, dict[int, float], int], None]  # (worker, features, label)


def iter_csv_rows(csv_path: str, has_header: bool = True,
                  num_features: int | None = None
                  ) -> Iterator[tuple[dict[int, float], int]]:
    """Yield (sparse_features, label) per CSV row, dropping zero
    features."""
    with open(csv_path) as f:
        if has_header:
            f.readline()
        for line in f:
            line = line.strip()
            if not line:
                continue
            cols = line.split(",")
            if num_features is not None and len(cols) != num_features + 1:
                raise ValueError(
                    f"row has {len(cols)} columns, expected {num_features + 1}")
            feats = {}
            for i, v in enumerate(cols[:-1]):
                fv = float(v)
                if fv != 0.0:
                    feats[i] = fv
            yield feats, int(float(cols[-1]))


class CsvStreamProducer:
    """Paced row pump: CSV → sink(worker, features, label)."""

    def __init__(self, csv_path: str, num_workers: int, sink: Sink,
                 time_per_event_ms: float = 200.0,
                 prefill_per_worker: int = 128,
                 has_header: bool = True,
                 num_features: int | None = None):
        self.csv_path = csv_path
        self.num_workers = num_workers
        self.sink = sink
        self.time_per_event_ms = time_per_event_ms
        self.prefill_per_worker = prefill_per_worker
        self.has_header = has_header
        self.num_features = num_features
        self.rows_sent = 0       # written by the producer thread only
        self.finished = threading.Event()
        self.stopped = threading.Event()
        self._thread: threading.Thread | None = None

    def run(self) -> None:
        prefill = self.num_workers * self.prefill_per_worker
        # 1 s sleep every this many rows; <= 0 ms per event = unthrottled
        rows_per_sleep = (max(1, int(1000 / self.time_per_event_ms))
                          if self.time_per_event_ms > 0 else 0)
        for feats, label in iter_csv_rows(self.csv_path, self.has_header,
                                          self.num_features):
            if self.stopped.is_set():
                break
            worker = self.rows_sent % self.num_workers
            self.sink(worker, feats, label)
            self.rows_sent += 1
            if (rows_per_sleep and self.rows_sent >= prefill
                    and self.rows_sent % rows_per_sleep == 0):
                # waiting on the stop event lets stop() cut a sleep short
                if self.stopped.wait(1.0):
                    break
        self.finished.set()

    def run_in_background(self) -> threading.Thread:
        t = threading.Thread(target=self.run, daemon=True,
                             name="csv-stream-producer")
        self._thread = t
        t.start()
        return t

    def stop(self, join_timeout: float = 10.0) -> None:
        """Stop the pump and join its thread."""
        self.stopped.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=join_timeout)


def load_csv_dataset(csv_path: str, has_header: bool = True
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Whole CSV as dense (x float32, y int32), label in the last column."""
    data = np.loadtxt(csv_path, delimiter=",",
                      skiprows=1 if has_header else 0)
    if data.ndim == 1:
        data = data[None, :]
    return data[:, :-1].astype(np.float32), data[:, -1].astype(np.int32)
