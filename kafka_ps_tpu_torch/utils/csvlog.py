"""CSV performance logging (counterpart of kafka_ps_tpu/utils/csvlog.py).

Schemas are the reference's, so its evaluation notebooks parse our logs:
  server: timestamp;partition;vectorClock;loss;fMeasure;accuracy
  worker: timestamp;partition;vectorClock;loss;fMeasure;accuracy;numTuplesSeen
  events: timestamp;event;partition (evict / readmit / resume, written
          as they happen so that a crash cannot lose the record)
"""

from __future__ import annotations

import os
import sys
import threading

SERVER_HEADER = "timestamp;partition;vectorClock;loss;fMeasure;accuracy"
WORKER_HEADER = SERVER_HEADER + ";numTuplesSeen"
EVENTS_HEADER = "timestamp;event;partition"


class NullLogSink:
    """Discard-everything sink (the log of an app built without one)."""

    def __call__(self, line: str) -> None:
        pass

    def close(self) -> None:
        pass


class CsvLogSink:
    """Thread-safe line sink to a file (with header) or stdout.

    `append=True` (checkpoint-resumed runs) continues an existing log
    instead of truncating it; the header is written only when the file
    is new or empty."""

    def __init__(self, path: str | None, header: str, append: bool = False):
        self._lock = threading.Lock()
        write_header = True
        if path is None:
            self._fh = sys.stdout
            self._close = False
        else:
            exists = os.path.exists(path) and os.path.getsize(path) > 0
            self._fh = open(path, "a" if append else "w")
            self._close = True
            write_header = not (append and exists)
        if write_header:
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
