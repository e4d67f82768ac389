"""Continuous sampling profiler (counterpart of
kafka_ps_tpu/telemetry/profiler.py) — stdlib-only, cheap enough to leave
on.

The flight recorder answers "what was each thread doing at the moment
of death"; a wedged-but-alive process needs "where has each thread been
*spending time*".  `SamplingProfiler` wakes ~`hz` times a second on its
own named daemon thread (`kps-profiler`), grabs every thread's current
frame via `sys._current_frames()`, folds each stack to a compact
`module.function` path, and counts (thread name, stack) pairs in a
bounded table.  Thread names are the ones the runtime already assigns
(`kps-serve-batch`, `kps-eval`, `kps-net-reader`, ...), so profiles line
up with flight events and watchdog verdicts by name, and since the
port's module paths mirror the JAX package's, the two packages'
profiles name the same functions.  It walks Python frames only: a
kernel's time shows as the frame that waits in a torch call.

Output is collapsed-stack text (one `thread;frame;frame;... count`
line per distinct stack, the flamegraph.pl / speedscope interchange
format):

  * `GET /profilez` on the `--health-port` plane serves the full
    collapsed profile as text/plain;
  * a watchdog trip's flight dump carries `top_stacks()` automatically
    (telemetry/flight.py attaches the armed profiler), so a postmortem
    sees where the wedged process was burning its time.

Costs and invariants:

  * the sample loop paces itself with `Event.wait` on the monotonic
    clock and reads frames without ever touching application locks —
    `sys._current_frames()` is a C-level snapshot;
  * the stack table is bounded (`max_stacks`): once full, new distinct
    stacks fold into an `(other)` bucket instead of growing the heap;
  * the profiler's own sampler thread is excluded from its samples;
  * it reads frames only, so theta is bitwise the same with it off.
"""

from __future__ import annotations

import os
import sys
import threading
import time

from kafka_ps_tpu_torch.analysis.lockgraph import OrderedLock

_MAX_DEPTH = 64          # frames kept per stack (root dropped beyond)
_OTHER = "(other)"
_MAX_TOKENS = 4096       # cached per-code-object tokens


def _token(code) -> str:
    base = os.path.basename(code.co_filename)
    if base.endswith(".py"):
        base = base[:-3]
    return f"{base}.{code.co_name}"


def _fold(frame, cache: dict | None = None) -> tuple[str, ...]:
    """Leaf frame -> root-first tuple of `module.function` tokens.
    `cache` (code object -> token) skips the string formatting for
    frames seen before — code objects live as long as their module, so
    at steady state a 100 Hz sampler does dict lookups only."""
    rev: list[str] = []
    depth = 0
    while frame is not None and depth < _MAX_DEPTH:
        code = frame.f_code
        if cache is None:
            tok = _token(code)
        else:
            tok = cache.get(code)
            if tok is None:
                tok = _token(code)
                if len(cache) < _MAX_TOKENS:
                    cache[code] = tok
        rev.append(tok)
        frame = frame.f_back
        depth += 1
    rev.reverse()
    return tuple(rev)


class SamplingProfiler:
    """Whole-process wall-clock sampling profiler.

    `start()`/`stop()` bound the sampler thread's lifetime (OpsPlane
    drives both behind `--profile`); `sample_once()` is the thread's
    body and is directly callable by tests — no thread, no timing."""

    def __init__(self, hz: float = 100.0, max_stacks: int = 512):
        self.hz = float(hz)
        self.max_stacks = int(max_stacks)
        # guarded-by: _lock (sampler writes hold it; stats reads are snapshots)
        self.samples = 0
        # guarded-by: _lock (sampler writes hold it; stats reads are snapshots)
        self.dropped = 0                 # samples folded into (other)
        self._counts: dict[tuple[str, tuple[str, ...]], int] = {}
        self._tokens: dict[object, str] = {}     # code object -> token
        self._lock = OrderedLock("telemetry.profiler")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._mono0: float | None = None
        # wall-clock anchor: display-only, so /profilez can say when
        # the window started; never feeds a measurement
        self.started_wall = time.time()  # pscheck: disable=PS104 (display-only wall anchor for /profilez)

    # -- sampling -----------------------------------------------------------

    def sample_once(self) -> int:
        """Take one sample of every live thread except the sampler
        itself; returns the number of stacks recorded."""
        me = threading.get_ident()
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        # fold OUTSIDE the lock: readers (/profilez, flight dumps) must
        # never wait on frame walking
        folded = [(names.get(ident, str(ident)),
                   _fold(frame, self._tokens))
                  for ident, frame in frames.items() if ident != me]
        taken = 0
        with self._lock:
            for key in folded:
                if key in self._counts:
                    self._counts[key] += 1
                elif len(self._counts) < self.max_stacks:
                    self._counts[key] = 1
                else:
                    other = (key[0], (_OTHER,))
                    self._counts[other] = self._counts.get(other, 0) + 1
                    self.dropped += 1
                taken += 1
            self.samples += 1
        return taken

    def _loop(self) -> None:
        period = 1.0 / self.hz if self.hz > 0 else 0.01
        while not self._stop.wait(period):
            try:
                self.sample_once()
            except RuntimeError:
                # thread set mutated mid-walk; skip this tick
                continue

    def start(self) -> "SamplingProfiler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._mono0 = time.monotonic()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="kps-profiler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=10.0)
        self._thread = None

    # -- read side ----------------------------------------------------------

    def _snapshot(self) -> list[tuple[str, tuple[str, ...], int]]:
        with self._lock:
            items = list(self._counts.items())
        return [(thread, stack, n) for (thread, stack), n in items]

    def collapsed(self) -> str:
        """Collapsed-stack text, hottest first: one
        `thread;frame;frame;... count` line per distinct stack."""
        rows = sorted(self._snapshot(), key=lambda r: -r[2])
        return "\n".join(f"{thread};{';'.join(stack)} {n}"
                         for thread, stack, n in rows)

    def top_stacks(self, k: int = 20) -> list[str]:
        """The `k` hottest collapsed lines (flight-dump payload)."""
        rows = sorted(self._snapshot(), key=lambda r: -r[2])[:max(0, k)]
        return [f"{thread};{';'.join(stack)} {n}"
                for thread, stack, n in rows]

    def stats(self) -> dict:
        """Header block for /profilez."""
        elapsed = (time.monotonic() - self._mono0
                   if self._mono0 is not None else 0.0)
        with self._lock:
            stacks = len(self._counts)
        return {"hz": self.hz, "samples": self.samples,
                "stacks": stacks, "dropped": self.dropped,
                "elapsed_s": round(elapsed, 3),
                "started_wall": self.started_wall,
                "running": self._thread is not None}
