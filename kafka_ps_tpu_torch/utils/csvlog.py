"""CSV performance logging (counterpart of kafka_ps_tpu/utils/csvlog.py).

Schemas are the reference's, so its evaluation notebooks parse our logs:
  server: timestamp;partition;vectorClock;loss;fMeasure;accuracy
  worker: timestamp;partition;vectorClock;loss;fMeasure;accuracy;numTuplesSeen
"""

from __future__ import annotations

import sys
import threading

SERVER_HEADER = "timestamp;partition;vectorClock;loss;fMeasure;accuracy"
WORKER_HEADER = SERVER_HEADER + ";numTuplesSeen"


class NullLogSink:
    """Discard-everything sink (the log of an app built without one)."""

    def __call__(self, line: str) -> None:
        pass

    def close(self) -> None:
        pass


class CsvLogSink:
    """Thread-safe line sink to a new file (with header) or stdout."""

    def __init__(self, path: str | None, header: str):
        self._lock = threading.Lock()
        if path is None:
            self._fh = sys.stdout
            self._close = False
        else:
            self._fh = open(path, "w")
            self._close = True
        self._fh.write(header + "\n")
        self._fh.flush()

    def __call__(self, line: str) -> None:
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self) -> None:
        # idempotent: a CsvLogSink wrapped in a DeferredSink is closed by
        # the wrapper and by the CLI's own cleanup
        with self._lock:
            if self._close:
                self._close = False
                self._fh.close()
