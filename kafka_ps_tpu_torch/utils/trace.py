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
call, and runtime code takes `tracer or NULL_TRACER`.  `span` times the
host: a span around a kernel call measures its launch, never the
device's work.  `device_span` times the device's work on a CUDA stream
with a pair of timing events, resolved later without waiting; its one
synchronise is the clock anchor it takes at its first use (after the
tracer is enabled or cleared).

While torch's profiler records, every span and device span (of any
tracer, NULL_TRACER too) also opens a profiler range of its name, so
that the program's spans lie on the profiler's host timeline, on its
clock: a `--device_trace` file holds them.  The range is the profiler's
function scope (`_RecordFunctionFast`), not `record_function`'s user
scope, which the profiler mirrors onto the device's timeline as an
annotation spanning the range's kernels (a device event that is no
device work).  `wallClockT0 + ts` of a dump is epoch time, the clock of
the profiler's events.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict, deque

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

# a reusable no-op context: the profiler range when nothing records
_NO_RANGE = contextlib.nullcontext()
# device tracks' tids lie above every host tid (thread ident mod 2**31)
_TRACK_TID0 = 2 ** 31


def _profiler_range(name: str):
    """A profiler range of `name` while torch's profiler records, else
    a no-op context (one C call to decide)."""
    return _RecordFunctionFast(name) if _profiler_enabled() else _NO_RANGE


def _epoch_at(t: float) -> float:
    """Epoch seconds at time.perf_counter() value `t`, from the tightest
    bracket of a few paired readings of the two clocks."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return (t * 1e9 + best[1]) / 1e9


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
        # tracer's zero sits on the shared wall clock (epoch seconds)
        self._wall0 = (_epoch_at(self._t0) if clock is time.perf_counter
                       else time.time())
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._counters: dict[str, int] = defaultdict(int)
        # sampled (ts_us, name, total) points -> ph:"C" events at dump
        self._counter_samples: list[tuple[float, str, int]] = []
        self._sample_every = counter_sample_s
        self._last_sample: dict[str, float] = {}
        self._flow_seq = 0
        # device spans in the order opened: (name, args, tid, anchor, start
        # event, end event); per device index the clock anchor (event,
        # this tracer's clock at it); device track label -> tid
        self._pending: deque = deque()
        self._anchors: dict[int, tuple] = {}
        self._tracks: dict[str, int] = {}
        self.pid = os.getpid() if pid is None else pid
        self._enabled = True

    @property
    def enabled(self) -> bool:
        return self._enabled

    @enabled.setter
    def enabled(self, on: bool) -> None:
        if on and not self._enabled:
            with self._lock:
                self._anchors.clear()    # retaken at the next device span
        self._enabled = on

    # -- spans -------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **args):
        """Host span.  Yields its args: the body may add what it learns
        inside the span."""
        with _profiler_range(name):
            if not self._enabled:
                yield args
                return
            start = self._clock()
            try:
                yield args
            finally:
                end = self._clock()
                self._record(name, start, end,
                             threading.get_ident() % 2 ** 31, args)

    def _record(self, name, start, end, tid, args) -> None:
        with self._lock:
            self._events.append({
                "name": name,
                "ph": "X",                      # complete event
                "ts": (start - self._t0) * 1e6,  # µs, trace convention
                "dur": (end - start) * 1e6,
                "pid": self.pid,
                "tid": tid,
                "args": args,
            })

    @contextlib.contextmanager
    def device_span(self, name: str, device=None, **args):
        """Span of the device's work that the body enqueues on `device`'s
        current stream, on a track of its own.  On a CUDA device: a
        timing event recorded at entry and one at exit, never waited on;
        spans resolve oldest first once their end event has completed
        (checked at each new device span; `dump` waits for the rest), and
        lie at their device times on this tracer's clock through the
        device's anchor.  Elsewhere (`device` None or a CPU device) the
        work is synchronous, so the host's times are the device's.
        Yields its args, as `span` does."""
        with _profiler_range(name):
            if not self._enabled:
                yield args
                return
            device = torch.device("cpu" if device is None else device)
            if device.type != "cuda":
                start = self._clock()
                try:
                    yield args
                finally:
                    self._record(name, start, self._clock(),
                                 self._track("cpu"), args)
                return
            stream = torch.cuda.current_stream(device)
            anchor = self._anchors.get(stream.device_index)
            if anchor is None:
                anchor = self._anchor(stream)
            self._resolve(wait=False)
            tid = self._track(f"cuda:{stream.device_index} stream "
                              f"{stream.stream_id}")
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            try:
                yield args
            finally:
                end = torch.cuda.Event(enable_timing=True)
                end.record(stream)
                with self._lock:
                    self._pending.append((name, args, tid, anchor, start,
                                          end))

    def _track(self, label: str) -> int:
        with self._lock:
            return self._tracks.setdefault(
                label, _TRACK_TID0 + len(self._tracks))

    def _anchor(self, stream) -> tuple:
        """The device's clock anchor: after one synchronise, an event
        recorded on the idle stream and this tracer's clock read around
        the record (the event's first record creates it, so it is
        recorded once before)."""
        event = torch.cuda.Event(enable_timing=True)
        event.record(stream)
        torch.cuda.synchronize(stream.device)
        before = self._clock()
        event.record(stream)
        anchor = (event, (before + self._clock()) / 2)
        with self._lock:
            self._anchors[stream.device_index] = anchor
        return anchor

    def _resolve(self, wait: bool) -> None:
        """Place the pending device spans, oldest first: those whose end
        event has completed, or (wait) all of them."""
        while True:
            with self._lock:
                if not self._pending:
                    return
                name, args, tid, (anchor, at), start, end = \
                    self._pending[0]
                if not wait and not end.query():
                    return
                self._pending.popleft()
            end.synchronize()
            t = at + anchor.elapsed_time(start) / 1e3
            self._record(name, t, t + start.elapsed_time(end) / 1e3, tid,
                         args)

    def span_at(self, name: str, start: float, end: float, **args) -> None:
        """Record a complete span from two clock values already taken
        (same clock as this tracer, time.perf_counter by default): a
        section whose start predates the decision to record it, such as
        the consistency gate's hold, known only at the release
        (runtime/server.py:_observe_gate_release)."""
        if not self.enabled:
            return
        self._record(name, start, max(start, end),
                     threading.get_ident() % 2 ** 31, args)

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
        then trace the steady state), pending device spans and the clock
        anchors.  Flow ids keep advancing, so events after a clear never
        collide with discarded ones."""
        with self._lock:
            self._events.clear()
            self._counter_samples.clear()
            self._pending.clear()
            self._anchors.clear()

    # -- export ------------------------------------------------------------
    def counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def span_stats(self) -> dict[str, dict]:
        """Per-span-name count/total/mean milliseconds (waits for the
        pending device spans)."""
        self._resolve(wait=True)
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
        clock for the merge tool.  Device spans wait to be resolved
        first; each device track is named by a `thread_name` metadata
        event."""
        self._resolve(wait=True)
        now_us = (self._clock() - self._t0) * 1e6
        with self._lock:
            events = list(self._events)
            used = {e["tid"] for e in events}
            for label, track in self._tracks.items():
                if track in used:
                    events.append({"name": "thread_name", "ph": "M",
                                   "pid": self.pid, "tid": track,
                                   "args": {"name": label}})
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
