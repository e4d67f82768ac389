"""Black-box flight recorder (counterpart of
kafka_ps_tpu/telemetry/flight.py): fixed-cost event rings that survive
the process they describe.

Metrics and traces explain runs that finish; this module explains runs
that wedge or die.  Instrumented subsystems (the consistency gate, the
socket bridges, the durable log, the shard router and assembler, the
relay, the serving engine, the replica tailer, the tiered store, the eval
engine) append small structured events into a per-thread ring buffer:

  * **lock-free append**: each ring has exactly one writer (its thread),
    so the hot path is two list stores and an index bump — no lock, no
    allocation beyond the event tuple.  Ring creation (first event from
    a new thread) takes a creation-only lock, like the metrics
    registry's family lock.
  * **fixed size**: a ring holds the last `capacity` events and wraps.
  * **near-zero when off**: the process-global `FLIGHT` starts
    disabled; instrumentation sites guard with `if FLIGHT.enabled:`
    so an un-enabled recorder costs one attribute load per site.

Timestamps are `time.monotonic()` at record time; the wall/mono anchor
pair captured at `enable()` converts them to wall-clock at dump time —
the `wallClockT0` convention utils/trace.Tracer exports, which lets
`telemetry postmortem` (this package's or the JAX package's) merge dumps
from different processes onto one timeline.

`dump()` writes an atomic `flightdump-<pid>.json` (tmp + os.replace)
containing the ring contents, every thread's stack, a metrics snapshot
and the watchdog panel's verdicts, in the JAX recorder's schema
(`kps-flightdump-v1`, the same keys).  Its `lockEdges` are the
lock-order edges the port's recorder has observed
(analysis/lockgraph.py `export_edges()`) when one is installed, `[]`
otherwise; its `profile` holds the armed sampling profiler's
20 hottest stacks (`--profile`, telemetry/profiler.py), `[]` without
one.  `install_death_hooks()` arranges for that dump on SIGTERM/SIGABRT
plus `faulthandler` coverage for the hard faults — a SIGKILLed process
writes nothing, which is why its peers' dumps carry the evidence.

Call sites pass only host ints and strings as fields: the recorder
stamps time itself, and nothing reads a device value to build an event.
"""

from __future__ import annotations

import faulthandler
import json
import os
import signal
import sys
import threading
import time
import traceback

from kafka_ps_tpu_torch.analysis import lockgraph


DUMP_SCHEMA = "kps-flightdump-v1"
DEFAULT_RING_CAPACITY = 512


class _Ring:
    """One thread's event ring: single-writer, readers tolerate tears
    (a half-updated slot shows the old or the new event, never garbage —
    slot stores are atomic under the GIL)."""

    __slots__ = ("thread", "buf", "idx", "total")

    def __init__(self, thread_name: str, capacity: int):
        self.thread = thread_name
        self.buf = [None] * capacity
        self.idx = 0
        self.total = 0

    def append(self, event) -> None:
        buf = self.buf
        i = self.idx
        buf[i] = event
        self.idx = (i + 1) % len(buf)
        self.total += 1

    def events(self) -> list:
        """Oldest-first snapshot (racy read; tears drop at most the
        event being written)."""
        i = self.idx
        out = [e for e in self.buf[i:] + self.buf[:i] if e is not None]
        return out


class FlightRecorder:
    """Process-global black box.  Use the module singleton `FLIGHT`;
    tests may build private instances.

    Besides events, the recorder keeps two tiny liveness surfaces the
    watchdogs (telemetry/health.py) read:

      * `beat(name)` — "subsystem `name` made progress now" (a gate
        release, a replica poll, an fsync completing);
      * `enter(name)` / `exit(name)` — bracket an operation that can
        wedge (the fsync syscall), so a watchdog can see "in flight
        for 40 s" without the operation ever completing.

    Both are single dict stores — GIL-atomic, no lock.
    """

    def __init__(self, capacity: int = DEFAULT_RING_CAPACITY):
        self.enabled = False
        self.capacity = capacity
        self.role = "unknown"
        self.shard = None
        self.meta: dict = {}
        self.flight_dir: str | None = None
        self.telemetry = None
        self.panel = None               # WatchdogPanel (health.py), if any
        self.profiler = None            # SamplingProfiler, if armed — a
                                        # watchdog trip ships its own
                                        # profile (telemetry/profiler.py)
        self._wall0 = 0.0
        self._mono0 = 0.0
        self._beats: dict[str, float] = {}
        self._inflight: dict[str, float] = {}
        self._tls = threading.local()
        self._rings: list[_Ring] = []
        self._rings_lock = lockgraph.OrderedLock("flight.rings")
        self._dump_lock = lockgraph.OrderedLock("flight.dump")
        self._prev_handlers: dict[int, object] = {}
        self._hooks_installed = False

    # -- lifecycle ----------------------------------------------------------

    def enable(self, *, role: str = "run", shard: int | None = None,
               flight_dir: str | None = None, telemetry=None,
               meta: dict | None = None,
               capacity: int | None = None) -> "FlightRecorder":
        """Arm the recorder.  Idempotent-ish: re-enabling refreshes the
        identity/anchors but keeps already-written rings."""
        self.role = role
        self.shard = shard
        self.flight_dir = flight_dir
        self.telemetry = telemetry
        self.meta = dict(meta or {})
        if capacity is not None:
            self.capacity = capacity
        self._wall0 = time.time()
        self._mono0 = time.monotonic()
        self.enabled = True
        return self

    def disable(self) -> None:
        """Disarm and forget (tests; CLI teardown).  Restores any signal
        handlers install_death_hooks replaced."""
        self.enabled = False
        self.panel = None
        self.profiler = None
        self.telemetry = None
        for signum, prev in self._prev_handlers.items():
            try:
                signal.signal(signum, prev)
            except (ValueError, OSError, TypeError):
                pass
        self._prev_handlers.clear()
        self._hooks_installed = False
        with self._rings_lock:
            self._rings = []
        self._tls = threading.local()
        self._beats.clear()
        self._inflight.clear()

    # -- the hot path -------------------------------------------------------

    def _ring(self) -> _Ring:
        r = getattr(self._tls, "ring", None)
        if r is None:
            r = _Ring(threading.current_thread().name, self.capacity)
            with self._rings_lock:
                self._rings.append(r)
            self._tls.ring = r
        return r

    def record(self, kind: str, **fields) -> None:
        """Append one structured event to this thread's ring.  Fields
        must be JSON-serializable host values (ints, floats, strings,
        small lists) — never device arrays."""
        if not self.enabled:
            return
        self._ring().append((time.monotonic(), kind, fields))

    def beat(self, name: str) -> None:
        """Progress heartbeat for subsystem `name` (watchdog food)."""
        if self.enabled:
            self._beats[name] = time.monotonic()

    def last_beat(self, name: str) -> float | None:
        return self._beats.get(name)

    def enter(self, name: str) -> None:
        """Mark an op that can wedge as in-flight (e.g. the fsync)."""
        if self.enabled:
            self._inflight[name] = time.monotonic()

    def exit(self, name: str) -> None:
        """Op completed: clear in-flight and beat."""
        if self.enabled:
            self._inflight.pop(name, None)
            self._beats[name] = time.monotonic()

    def inflight_age(self, name: str) -> float | None:
        """Seconds the named op has been in flight, or None."""
        t0 = self._inflight.get(name)
        return None if t0 is None else time.monotonic() - t0

    # -- read side ----------------------------------------------------------

    def _to_wall(self, mono: float) -> float:
        return self._wall0 + (mono - self._mono0)

    def tail(self, n: int = 100) -> list[dict]:
        """The `n` most recent events across all rings, oldest first,
        wall-clock stamped (the /flightz payload)."""
        with self._rings_lock:
            rings = list(self._rings)
        merged = []
        for r in rings:
            for (mono, kind, fields) in r.events():
                merged.append((mono, r.thread, kind, fields))
        merged.sort(key=lambda e: e[0])
        return [{"t": self._to_wall(mono), "thread": thread,
                 "kind": kind, **fields}
                for (mono, thread, kind, fields) in merged[-n:]]

    def total_events(self) -> int:
        """Events ever recorded across all rings, including ones the
        wrap already overwrote."""
        with self._rings_lock:
            return sum(r.total for r in self._rings)

    def default_dump_path(self) -> str:
        d = self.flight_dir or "."
        return os.path.join(d, f"flightdump-{os.getpid()}.json")

    def dump(self, path: str | None = None, reason: str = "") -> str | None:
        """Write the black box atomically; returns the path, or None
        when another dump is mid-write (signal re-entry guard)."""
        if not self._dump_lock.acquire(blocking=False):
            return None
        try:
            return self._dump_locked(path, reason)
        finally:
            self._dump_lock.release()

    def _dump_locked(self, path: str | None, reason: str) -> str:
        path = path or self.default_dump_path()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        payload = self.snapshot(reason)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return path

    def snapshot(self, reason: str = "") -> dict:
        """The dump payload as a dict (schema DUMP_SCHEMA)."""
        now_mono = time.monotonic()
        events = self.tail(n=10 ** 9)          # everything we still hold
        threads = {}
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in frames.items():
            threads[names.get(ident, str(ident))] = \
                traceback.format_stack(frame)
        graph = lockgraph.current()
        lock_edges = graph.export_edges() if graph is not None else []
        metrics = {}
        if self.telemetry is not None:
            try:
                metrics = self.telemetry.snapshot()
            except Exception:           # noqa: BLE001 — never lose the box
                metrics = {"error": "metrics snapshot failed"}
        watchdogs = self.panel.states() if self.panel is not None else {}
        profile: list[str] = []
        if self.profiler is not None:
            try:
                profile = self.profiler.top_stacks(20)
            except Exception:           # noqa: BLE001 — never lose the box
                profile = ["error: profile snapshot failed"]
        return {
            "schema": DUMP_SCHEMA,
            "pid": os.getpid(),
            "role": self.role,
            "shard": self.shard,
            "meta": self.meta,
            "reason": reason,
            "wallClockT0": self._wall0,
            "dumpedAt": self._to_wall(now_mono),
            "events": events,
            "beats": {k: self._to_wall(v) for k, v in self._beats.items()},
            "inflight": {k: now_mono - v
                         for k, v in self._inflight.items()},
            "threads": threads,
            "lockEdges": lock_edges,
            "metrics": metrics,
            "watchdogs": watchdogs,
            "profile": profile,
        }

    # -- dump-on-death ------------------------------------------------------

    def install_death_hooks(self) -> bool:
        """SIGTERM/SIGABRT → dump then chain to the previous handler,
        plus faulthandler for the hard faults (SIGSEGV et al. print
        stacks to stderr — a fault can't safely run Python).  Signal
        handlers only install from the main thread; False when not
        there (the caller loses dump-on-TERM, nothing else)."""
        if self._hooks_installed:
            return True
        if threading.current_thread() is not threading.main_thread():
            return False
        try:
            faulthandler.enable()
        except (RuntimeError, OSError):
            pass
        for signum in (signal.SIGTERM, signal.SIGABRT):
            try:
                self._prev_handlers[signum] = signal.signal(
                    signum, self._on_signal)
            except (ValueError, OSError):
                pass
        self._hooks_installed = True
        return True

    def _on_signal(self, signum, frame) -> None:
        try:
            self.dump(reason=f"signal:{signal.Signals(signum).name}")
        except Exception:               # noqa: BLE001 — dying anyway
            pass
        prev = self._prev_handlers.get(signum)
        if callable(prev):
            prev(signum, frame)
            return
        # default disposition: restore and re-raise so the exit status
        # says "killed by signal", as the supervisor expects
        try:
            signal.signal(signum, prev if prev is not None
                          else signal.SIG_DFL)
        except (ValueError, OSError, TypeError):
            signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)


# The process-global black box.  Instrumentation sites import THIS and
# guard with `if FLIGHT.enabled:` — the whole cost when disarmed.
FLIGHT = FlightRecorder()
