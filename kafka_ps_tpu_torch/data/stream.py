"""Streaming ingestion simulator (counterpart of
kafka_ps_tpu/data/stream.py).

Reads a training CSV, turns each row into a sparse sample (zero features
dropped, label = last column), assigns it round-robin to a logical
worker (row_count % num_workers) and paces delivery: the first
num_workers * prefill_per_worker rows go unthrottled, after which the
producer sleeps 1 s every (1000 / time_per_event_ms) rows.

Two parsers give the same rows: the native one (native/, C++) parses the
whole file in one pass and replays rows from its CSR arrays; the Python
one streams line by line.  `use_native=None` (the default) picks the
native parser when it is available and falls back to Python where the
stricter C parser rejects the file.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterator

import numpy as np

Sink = Callable[[int, dict[int, float], int], None]  # (worker, features, label)


def _native_parse(csv_path: str, has_header: bool,
                  num_features: int | None, use_native: bool | None):
    """The native parse of the file, or None where the Python parser
    takes it: use_native False, or None with the parser unavailable or
    refusing the file (the C parser is stricter: uniform width, no stray
    whitespace)."""
    if use_native is False:
        return None
    from kafka_ps_tpu_torch import native
    parsed = None
    if native.is_available():
        try:
            parsed = native.parse_csv(csv_path, has_header=has_header)
        except RuntimeError:
            if use_native:
                raise
    elif use_native:
        raise RuntimeError("native CSV parser requested but unavailable")
    if (parsed is not None and num_features is not None
            and parsed.num_rows > 0 and parsed.num_features != num_features):
        raise ValueError(
            f"rows have {parsed.num_features + 1} columns, "
            f"expected {num_features + 1}")
    return parsed


def _python_rows(csv_path: str, has_header: bool, num_features: int | None
                 ) -> Iterator[tuple[dict[int, float], int]]:
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


def _open_rows(csv_path: str, has_header: bool, num_features: int | None,
               use_native: bool | None):
    """("native" | "python", the row iterator)."""
    parsed = _native_parse(csv_path, has_header, num_features, use_native)
    if parsed is None:
        return "python", _python_rows(csv_path, has_header, num_features)
    return "native", (parsed.row(i) for i in range(parsed.num_rows))


def iter_csv_rows(csv_path: str, has_header: bool = True,
                  num_features: int | None = None,
                  use_native: bool | None = None
                  ) -> Iterator[tuple[dict[int, float], int]]:
    """Yield (sparse_features, label) per CSV row, dropping zero
    features.

    `use_native`: True forces the C++ parser, False forces Python, None
    (default) picks the native parser when it is available and falls
    back to Python on a file it refuses."""
    yield from _open_rows(csv_path, has_header, num_features,
                          use_native)[1]


class CsvStreamProducer:
    """Paced row pump: CSV → sink(worker, features, label)."""

    def __init__(self, csv_path: str, num_workers: int, sink: Sink,
                 time_per_event_ms: float = 200.0,
                 prefill_per_worker: int = 128,
                 has_header: bool = True,
                 num_features: int | None = None,
                 use_native: bool | None = None):
        self.csv_path = csv_path
        self.num_workers = num_workers
        self.sink = sink
        self.time_per_event_ms = time_per_event_ms
        self.prefill_per_worker = prefill_per_worker
        self.has_header = has_header
        self.num_features = num_features
        # None = auto (the native one-pass parse when available); False =
        # the line-by-line Python parser
        self.use_native = use_native
        # written by the producer thread only, read after it ends: rows
        # sent, the parser that ran, and the seconds of the native
        # one-pass parse (the Python parser parses row by row as the loop
        # pulls, outside this count)
        self.rows_sent = 0
        self.parser: str | None = None
        self.parse_s = 0.0
        self.finished = threading.Event()
        self.stopped = threading.Event()
        self._thread: threading.Thread | None = None

    def run(self) -> None:
        prefill = self.num_workers * self.prefill_per_worker
        # 1 s sleep every this many rows; <= 0 ms per event = unthrottled
        rows_per_sleep = (max(1, int(1000 / self.time_per_event_ms))
                          if self.time_per_event_ms > 0 else 0)
        t0 = time.perf_counter()
        self.parser, rows = _open_rows(self.csv_path, self.has_header,
                                       self.num_features, self.use_native)
        self.parse_s += time.perf_counter() - t0
        for feats, label in rows:
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
