"""Periodic runtime status line (counterpart of
kafka_ps_tpu/utils/status.py): a one-line heartbeat on stderr, emitted
by the drive loops every `--status_every` seconds, in the JAX format
character for character:

    [status] iters=412 (+38.0/s) clocks=0:103,1:103,2:102,3:103 \
        active=4/4 pending weights=2 gradients=1 buffers=256,256,256,256

Post-hoc inspection stays with the tracer (`--trace`, utils/trace.py);
this is the live pulse: is it making progress, how fast, who is
lagging, is a queue backing up.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Callable


class StatusReporter:
    """Prints `source()` every `interval` seconds on its own thread.

    `source` returns a dict; an `iters` key gets a derived rate
    (+N/s since the previous line), and ANY key suffixed `_per_s`
    (top-level or nested one dict deep) is treated as a cumulative
    count and rendered as the rate since the previous line ("--" until
    a baseline exists) — how the serving plane's QPS rides the same
    heartbeat.  The thread only formats and prints host-side state,
    and stop() joins it."""

    def __init__(self, interval: float, source: Callable[[], dict],
                 out=None, clock=time.monotonic):
        self.interval = interval
        self.source = source
        self.out = out if out is not None else sys.stderr
        self._clock = clock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # per-key (last value, last timestamp) for every derived-rate
        # key — `iters` and the `*_per_s` family share the mechanism
        # pscheck: disable=PS201 (rate scratch for the status line; a torn read skews one printed rate)
        self._last_counts: dict[str, tuple[float, float]] = {}

    def start(self) -> "StatusReporter":
        if self.interval and self.interval > 0 and self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="kps-status")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.emit()

    def emit(self) -> None:
        """One status line now (also called directly by tests)."""
        try:
            fields = self.source()
        except Exception as e:       # a torn-down source must not kill
            fields = {"error": repr(e)}
        now = self._clock()
        parts = []
        for k, v in fields.items():
            if k == "iters" and isinstance(v, (int, float)):
                per_s = self._rate("iters", v, now)
                rate = "" if per_s is None else f" (+{per_s:.1f}/s)"
                parts.append(f"iters={v}{rate}")
            elif k.endswith("_per_s") and isinstance(v, (int, float)):
                parts.append(f"{k}={self._fmt_rate(k, v, now)}")
            elif isinstance(v, dict):
                inner = " ".join(
                    f"{ik}={self._fmt_rate(f'{k}.{ik}', iv, now)}"
                    if ik.endswith("_per_s") and isinstance(iv, (int, float))
                    else f"{ik}={iv}"
                    for ik, iv in v.items())
                parts.append(f"{k} {inner}")
            elif isinstance(v, (list, tuple)):
                parts.append(f"{k}=" + ",".join(str(i) for i in v))
            else:
                parts.append(f"{k}={v}")
        print("[status] " + " ".join(parts), file=self.out, flush=True)

    def _rate(self, key: str, value: float, now: float) -> float | None:
        """Derived rate for a cumulative count since its previous
        sample; None until a baseline exists (first line)."""
        prev = self._last_counts.get(key)
        self._last_counts[key] = (value, now)
        if prev is None or now <= prev[1]:
            return None
        return (value - prev[0]) / (now - prev[1])

    def _fmt_rate(self, key: str, value: float, now: float) -> str:
        per_s = self._rate(key, value, now)
        return "--" if per_s is None else f"{per_s:.1f}"

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=10.0)
