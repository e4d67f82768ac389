"""Latency recording (the part of kafka_ps_tpu/utils/trace.py the serving
plane needs).  The tracer, its spans, counters and flow events, and the
device profiler hook are not ported yet (the telemetry plane's ROADMAP
item)."""

from __future__ import annotations

import threading
from collections import deque


class LatencyRecorder:
    """Sliding-window latency samples with percentile export, the serving
    plane's p50/p99 (seconds in, milliseconds out).  Bounded, so a
    long-lived server never grows; thread-safe, so request callbacks and
    readers can share one recorder."""

    def __init__(self, window: int = 4096):
        self._samples: deque[float] = deque(maxlen=max(1, window))
        self._lock = threading.Lock()
        self.count = 0

    def record(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(seconds)
            self.count += 1

    def percentiles_ms(self, *ps: float) -> dict[str, float | None]:
        """{"p50_ms": ..., "p99_ms": ...}; None before any sample."""
        with self._lock:
            data = sorted(self._samples)
        out: dict[str, float | None] = {}
        for p in ps:
            key = f"p{p:g}_ms"
            if not data:
                out[key] = None
            else:
                idx = min(len(data) - 1, round(p / 100 * (len(data) - 1)))
                out[key] = round(data[idx] * 1e3, 3)
        return out
