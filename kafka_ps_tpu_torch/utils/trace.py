"""Tracing and profiling hooks (counterpart of kafka_ps_tpu/utils/trace.py).

Three layers:
  * `Tracer` — host-side span + counter + flow-event recorder.  Spans
    export as Chrome trace-event JSON (chrome://tracing or Perfetto);
    counters are sampled over time as `ph: "C"` counter events (the
    per-topic message-flow timeline); flow events (`ph: s/t/f`) connect
    a delta's lifecycle across threads.  The dump's JSON is the JAX
    tracer's, so either package's merge tool stitches a dump of either
    package with one of the other.
  * `LatencyRecorder` — the serving plane's sliding-window percentiles.
  * `device_trace(logdir, device)` — torch.profiler over a block: CPU
    activity always, CUDA activity when the device is a CUDA device,
    written with `export_chrome_trace` to LOGDIR/devicetrace-<pid>.json
    (Chrome trace JSON; Perfetto or chrome://tracing reads it).

Zero overhead when disabled: the module-level NULL_TRACER no-ops every
call, and runtime code takes `tracer or NULL_TRACER`.  Spans time the
host: a span around a kernel call measures its launch, never the
device's work (nothing here waits on the device); the device's time is
what `device_trace` records.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict, deque


class Tracer:
    """Span + counter + flow recorder with Chrome trace-event export.

    `pid` labels every event (defaults to the real process id — the
    merge tool keys track groups off it);
    `counter_sample_s` throttles how often a hot counter emits a
    timeline sample (0 = every increment, for deterministic tests)."""

    def __init__(self, clock=time.perf_counter, pid: int | None = None,
                 counter_sample_s: float = 0.01):
        self._clock = clock
        self._t0 = clock()
        # wall-clock anchor for cross-process merging: perf_counter
        # epochs are process-private, so dump() records where this
        # tracer's zero sits on the shared wall clock
        self._wall0 = time.time()
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._counters: dict[str, int] = defaultdict(int)
        # sampled (ts_us, name, total) points -> ph:"C" events at dump
        self._counter_samples: list[tuple[float, str, int]] = []
        self._sample_every = counter_sample_s
        self._last_sample: dict[str, float] = {}
        self._flow_seq = 0
        self.pid = os.getpid() if pid is None else pid
        self.enabled = True

    # -- spans -------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **args):
        if not self.enabled:
            yield
            return
        start = self._clock()
        try:
            yield
        finally:
            end = self._clock()
            with self._lock:
                self._events.append({
                    "name": name,
                    "ph": "X",                      # complete event
                    "ts": (start - self._t0) * 1e6,  # µs, trace convention
                    "dur": (end - start) * 1e6,
                    "pid": self.pid,
                    "tid": threading.get_ident() % 2 ** 31,
                    "args": args,
                })

    def span_at(self, name: str, start: float, end: float, **args) -> None:
        """Record a complete span from two clock values already taken
        (same clock as this tracer, time.perf_counter by default): a
        section whose start predates the decision to record it, such as
        the consistency gate's hold, known only at the release
        (runtime/server.py:_observe_gate_release)."""
        if not self.enabled:
            return
        with self._lock:
            self._events.append({
                "name": name,
                "ph": "X",
                "ts": (start - self._t0) * 1e6,
                "dur": max(0.0, end - start) * 1e6,
                "pid": self.pid,
                "tid": threading.get_ident() % 2 ** 31,
                "args": args,
            })

    # -- counters (message-flow view) --------------------------------------
    def count(self, name: str, n: int = 1) -> None:
        if not self.enabled:
            return
        now = self._clock()
        with self._lock:
            self._counters[name] += n
            # throttled timeline sample: Perfetto renders these as a
            # counter track
            if now - self._last_sample.get(name, -1e18) >= self._sample_every:
                self._last_sample[name] = now
                self._counter_samples.append(
                    ((now - self._t0) * 1e6, name, self._counters[name]))

    # -- flow events (cross-thread / cross-process causality) --------------
    def new_flow_id(self) -> int:
        """Globally-unique flow id: pid in the high bits so ids from
        different processes never collide in a merged trace."""
        with self._lock:
            self._flow_seq += 1
            return ((self.pid & 0xFFFF) << 40) | self._flow_seq

    def flow(self, ph: str, name: str, flow_id: int, **args) -> None:
        """One flow event: ph 's' (start), 't' (step), 'f' (end).
        Emit from inside a span — viewers bind the arrow endpoints to
        the enclosing slice on this (pid, tid)."""
        if not self.enabled:
            return
        now = self._clock()
        ev = {"name": name, "cat": "flow", "ph": ph, "id": flow_id,
              "ts": (now - self._t0) * 1e6, "pid": self.pid,
              "tid": threading.get_ident() % 2 ** 31, "args": args}
        if ph == "f":
            ev["bp"] = "e"      # bind the arrowhead to the enclosing slice
        with self._lock:
            self._events.append(ev)

    def flow_start(self, name: str, flow_id: int, **args) -> None:
        self.flow("s", name, flow_id, **args)

    def flow_step(self, name: str, flow_id: int, **args) -> None:
        self.flow("t", name, flow_id, **args)

    def flow_end(self, name: str, flow_id: int, **args) -> None:
        self.flow("f", name, flow_id, **args)

    def clear(self) -> None:
        """Drop every recorded event and counter sample (warm up, clear,
        then trace the steady state).  Flow ids keep advancing, so
        events after a clear never collide with discarded ones."""
        with self._lock:
            self._events.clear()
            self._counter_samples.clear()

    # -- export ------------------------------------------------------------
    def counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def span_stats(self) -> dict[str, dict]:
        """Per-span-name count/total/mean milliseconds."""
        with self._lock:
            acc: dict[str, list[float]] = defaultdict(list)
            for e in self._events:
                acc[e["name"]].append(e["dur"] / 1e3)
        return {name: {"count": len(ds), "total_ms": round(sum(ds), 3),
                       "mean_ms": round(sum(ds) / len(ds), 3)}
                for name, ds in sorted(acc.items())}

    def dump(self, path: str) -> str:
        """Chrome trace-event JSON: {traceEvents: [...], counters: ...}.

        Counters land on the timeline as `ph: "C"` counter events (one
        per throttled sample plus a closing sample at dump time); the
        top-level "counters" totals stay for programmatic readers.
        "wallClockT0" anchors this process's ts=0 on the shared wall
        clock for the merge tool."""
        now_us = (self._clock() - self._t0) * 1e6
        with self._lock:
            events = list(self._events)
            tid = threading.get_ident() % 2 ** 31
            for ts_us, name, total in self._counter_samples:
                events.append({"name": name, "ph": "C", "ts": ts_us,
                               "pid": self.pid, "tid": tid,
                               "args": {"value": total}})
            for name, total in sorted(self._counters.items()):
                events.append({"name": name, "ph": "C", "ts": now_us,
                               "pid": self.pid, "tid": tid,
                               "args": {"value": total}})
            payload = {"traceEvents": events,
                       "counters": dict(self._counters),
                       "wallClockT0": self._wall0,
                       "pid": self.pid}
        with open(path, "w") as f:
            json.dump(payload, f)
        return path


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


class _NullTracer(Tracer):
    """No-op tracer (observability off — the default)."""

    def __init__(self):
        super().__init__()
        self.enabled = False


NULL_TRACER = _NullTracer()


def device_trace_path(logdir: str) -> str:
    """The file `device_trace(logdir, ...)` writes in this process."""
    return os.path.join(logdir, f"devicetrace-{os.getpid()}.json")


def kernel_names(path: str) -> set[str]:
    """Names of the CUDA kernel events (`cat: "kernel"`) in a trace
    `device_trace` wrote."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return {e.get("name", "") for e in events if e.get("cat") == "kernel"}


@contextlib.contextmanager
def device_trace(logdir: str | None, device=None):
    """torch.profiler over the block (per-kernel device time, the host's
    op timeline).  CPU activity always, CUDA activity when `device`
    (resolved as every entry point resolves it, utils.config) is a CUDA
    device.  The trace is written with `export_chrome_trace` to
    `device_trace_path(logdir)`, also when the block raises.  None → no-op.

    On a CUDA device a trace holding no CUDA kernel event raises
    RuntimeError: a run asked for its device's trace must not end with a
    host-only one."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    from kafka_ps_tpu_torch.utils.config import resolve_device
    cuda = resolve_device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = device_trace_path(logdir)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
    if cuda and not kernel_names(path):
        raise RuntimeError(f"device trace {path} holds no CUDA kernel event")
