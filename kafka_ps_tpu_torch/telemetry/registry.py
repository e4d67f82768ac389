"""Metrics registry (counterpart of kafka_ps_tpu/telemetry/registry.py):
thread-safe counters, gauges and fixed-bucket histograms grouped into
labeled families (`gradients_applied_total{worker=...}`,
`gate_wait_ms{model=...}`), exported three ways:

  * `snapshot()` — nested dict for the status heartbeat and a flight dump;
  * `prometheus_text()` — Prometheus text exposition (`--metrics-file`,
    rewritten every `--metrics-every` seconds; `/varz`);
  * `Telemetry.summary()` — a small flat dict the heartbeat inlines.

The three exports are the JAX registry's, string for string, for the
same sequence of updates.

The `Telemetry` facade owns one registry plus the `utils/trace.Tracer`
backend (spans/flows/counter samples) so instrumentation sites take ONE
object.  The module is stdlib-only.

Zero-cost when disabled: `NULL_TELEMETRY` mirrors `NULL_TRACER` —
every factory returns the shared no-op metric, `enabled` is False so
hot paths can skip even the argument computation, and runtime code
takes `telemetry or NULL_TELEMETRY`.  Instrumented modules resolve the
children they mutate at construction, so the hot path never takes the
registry's family lock.

Locking: metric mutation takes the metric's own leaf lock (named
`telemetry.metric`, an analysis/lockgraph.OrderedLock) and never does
I/O or acquires anything else under it (PS105); the registry lock
(`telemetry.registry`) only guards family/child creation.  The periodic
Prometheus dumper is a named daemon thread (`kps-metrics`) that the
owner stops (`stop_dumper`) before interpreter exit.
"""

from __future__ import annotations

import bisect
import math
import os
import threading

from kafka_ps_tpu_torch.analysis.lockgraph import OrderedLock
from kafka_ps_tpu_torch.utils.trace import NULL_TRACER

# Default latency buckets (milliseconds): sub-ms dispatch waits through
# multi-second stalls, roughly log-spaced like Prometheus defaults.
LATENCY_BUCKETS_MS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                      100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0)
# Vector-clock lag buckets (unit: clocks).  0 is its own bucket — BSP
# releases everyone at lag 0, and that spike IS the interesting shape.
CLOCK_BUCKETS = (0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 32.0)


def interp_quantile(bounds, counts, total: int, q: float) -> float | None:
    """Counts-based quantile estimate with linear interpolation inside
    the bucket holding the q-th sample.  The first bucket's lower edge
    is 0.0 (every histogram here measures nonnegative ms/counts); the
    +Inf overflow bucket clamps to the last finite edge — an estimator
    must never invent a value past what the buckets can witness.
    None before any observation.

    Shared by `Histogram.quantile` and by windowed readers that
    subtract two `state()` snapshots and need the same math over the
    difference.
    """
    if total <= 0:
        return None
    rank = q * total
    seen = 0
    n = len(bounds)
    for i, c in enumerate(counts):
        if not c:
            continue
        if seen + c >= rank:
            if i >= n:                      # +Inf overflow bucket
                return bounds[-1] if n else math.inf
            lo = bounds[i - 1] if i else 0.0
            frac = (rank - seen) / c
            if frac < 0.0:
                frac = 0.0
            return lo + frac * (bounds[i] - lo)
        seen += c
    return bounds[-1] if n else math.inf


def model_name(consistency_model: int) -> str:
    """Stable label value for the three consistency models
    (utils/config.py: 0 BSP, k>0 SSP, -1 ASP)."""
    if consistency_model == 0:
        return "sequential"
    if consistency_model > 0:
        return "bounded"
    return "eventual"


class Counter:
    """Monotonic counter (float-tolerant, like Prometheus)."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = OrderedLock("telemetry.metric")
        self.value = 0

    def inc(self, n=1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = OrderedLock("telemetry.metric")
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v

    def inc(self, n=1) -> None:
        with self._lock:
            self.value += n


class Histogram:
    """Fixed-bucket histogram: `bounds` are inclusive upper edges
    (value <= bound lands in that bucket; Prometheus `le` semantics),
    with an implicit +Inf overflow bucket at the end."""

    __slots__ = ("_lock", "bounds", "bucket_counts", "sum", "count")

    def __init__(self, bounds=LATENCY_BUCKETS_MS):
        self._lock = OrderedLock("telemetry.metric")
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError(f"bucket bounds must be strictly increasing, "
                             f"got {bounds}")
        self.bucket_counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.bucket_counts[i] += 1
            self.sum += v
            self.count += 1

    # -- read side (lock held only to copy) --------------------------------
    def state(self) -> tuple[list[int], float, int]:
        with self._lock:
            return list(self.bucket_counts), self.sum, self.count

    def quantile(self, q: float) -> float | None:
        """Quantile estimate, linearly interpolated inside the bucket
        holding the q-th sample (the +Inf bucket clamps to the largest
        finite edge — see `interp_quantile`).  None before any
        observation."""
        counts, _, total = self.state()
        return interp_quantile(self.bounds, counts, total, q)

    def summary(self) -> dict:
        counts, total_sum, total = self.state()
        out = {"count": total, "sum": round(total_sum, 3)}
        if total:
            out["mean"] = round(total_sum / total, 4)
            out["p50"] = self.quantile(0.5)
            out["p95"] = self.quantile(0.95)
            out["max_bucket"] = (self.bounds[-1] if counts[-1]
                                 else self.bounds[
                                     max(i for i, c in enumerate(counts)
                                         if c)])
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


def _escape_label_value(v: str) -> str:
    """Prometheus exposition-format label-value escaping: backslash
    FIRST (it is the escape character), then quote and newline."""
    return (v.replace("\\", r"\\")
             .replace('"', r'\"')
             .replace("\n", r"\n"))


class _Family:
    """One named metric family: children keyed by label-value tuples."""

    def __init__(self, kind: str, name: str, label_names: tuple[str, ...],
                 help_text: str = "", buckets=None):
        self.kind = kind
        self.name = name
        self.label_names = label_names
        self.help = help_text
        self.buckets = buckets
        self._children: dict[tuple, object] = {}
        self._lock = OrderedLock("telemetry.registry")

    def labels(self, **labels):
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name} expects labels {self.label_names}, "
                f"got {tuple(labels)}")
        key = tuple(str(labels[n]) for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    if self.kind == "histogram":
                        child = Histogram(self.buckets
                                          if self.buckets is not None
                                          else LATENCY_BUCKETS_MS)
                    else:
                        child = _KINDS[self.kind]()
                    self._children[key] = child
        return child

    def children(self) -> dict[tuple, object]:
        with self._lock:
            return dict(self._children)


class MetricsRegistry:
    """Families keyed by metric name; creation is idempotent and the
    kind/labels of an existing family must match."""

    def __init__(self):
        self._families: dict[str, _Family] = {}
        self._lock = OrderedLock("telemetry.registry")

    def _family(self, kind: str, name: str, label_names, help_text,
                buckets=None) -> _Family:
        label_names = tuple(label_names)
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = _Family(kind, name, label_names, help_text,
                                  buckets)
                    self._families[name] = fam
        if fam.kind != kind or fam.label_names != label_names:
            raise ValueError(
                f"metric {name} already registered as {fam.kind}"
                f"{fam.label_names}, not {kind}{label_names}")
        return fam

    def counter(self, name: str, help_text: str = "", **labels) -> Counter:
        return self._family("counter", name, sorted(labels), help_text) \
            .labels(**labels)

    def gauge(self, name: str, help_text: str = "", **labels) -> Gauge:
        return self._family("gauge", name, sorted(labels), help_text) \
            .labels(**labels)

    def histogram(self, name: str, buckets=None, help_text: str = "",
                  **labels) -> Histogram:
        return self._family("histogram", name, sorted(labels), help_text,
                            buckets).labels(**labels)

    def families(self) -> dict[str, _Family]:
        with self._lock:
            return dict(self._families)

    # -- exports ------------------------------------------------------------
    def snapshot(self) -> dict:
        """{name: {label-string: value-or-histogram-summary}} — the
        heartbeat / flight-dump form."""
        out: dict[str, dict] = {}
        for name, fam in sorted(self.families().items()):
            entry: dict[str, object] = {}
            for key, child in sorted(fam.children().items()):
                label = ",".join(f"{n}={v}"
                                 for n, v in zip(fam.label_names, key)) \
                    or "_total"
                if fam.kind == "histogram":
                    entry[label] = child.summary()
                else:
                    entry[label] = child.value
            out[name] = entry
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (one dump, no timestamps).
        Label VALUES are escaped per the format (backslash, double
        quote, newline) — a `--connect` address or file path with a
        quote in it must not produce an unparseable exposition."""
        lines: list[str] = []
        for name, fam in sorted(self.families().items()):
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key, child in sorted(fam.children().items()):
                label = ",".join(
                    f'{n}="{_escape_label_value(v)}"'
                    for n, v in zip(fam.label_names, key))
                if fam.kind == "histogram":
                    counts, hsum, total = child.state()
                    cum = 0
                    for bound, c in zip(child.bounds, counts):
                        cum += c
                        le = label + ("," if label else "") + f'le="{bound:g}"'
                        lines.append(f"{name}_bucket{{{le}}} {cum}")
                    cum += counts[-1]
                    le = label + ("," if label else "") + 'le="+Inf"'
                    lines.append(f"{name}_bucket{{{le}}} {cum}")
                    suffix = f"{{{label}}}" if label else ""
                    lines.append(f"{name}_sum{suffix} {hsum:g}")
                    lines.append(f"{name}_count{suffix} {total}")
                else:
                    suffix = f"{{{label}}}" if label else ""
                    lines.append(f"{name}{suffix} {child.value:g}")
        return "\n".join(lines) + "\n"


class Telemetry:
    """One handle for every instrumentation site: a metrics registry
    plus the Tracer backend (spans / flow events / counter samples).

    `enabled` gates the non-trivial recording paths; hot sites cache
    the metric children they mutate (`self._m_... = telemetry.counter(
    ...)` at construction) so the steady state is one lock + add.
    """

    def __init__(self, tracer=None, registry: MetricsRegistry | None = None):
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.registry = registry if registry is not None else MetricsRegistry()
        self.enabled = True
        self._dump_stop = threading.Event()
        self._dump_thread: threading.Thread | None = None

    # metric factories (thin passthroughs so call sites need one object)
    def counter(self, name: str, help_text: str = "", **labels):
        return self.registry.counter(name, help_text, **labels)

    def gauge(self, name: str, help_text: str = "", **labels):
        return self.registry.gauge(name, help_text, **labels)

    def histogram(self, name: str, buckets=None, help_text: str = "",
                  **labels):
        return self.registry.histogram(name, buckets, help_text, **labels)

    # -- exports ------------------------------------------------------------
    def snapshot(self) -> dict:
        return self.registry.snapshot()

    def summary(self) -> dict:
        """Small flat dict for the status heartbeat: counter totals
        (labels summed) and histogram p50s."""
        out: dict[str, object] = {}
        for name, fam in sorted(self.registry.families().items()):
            children = fam.children().values()
            if not children:
                continue
            if fam.kind == "histogram":
                total = sum(c.count for c in children)
                if total:
                    out[f"{name}_p50"] = max(
                        (c.quantile(0.5) for c in children if c.count),
                        default=None)
                    out[f"{name}_n"] = total
            else:
                out[name] = round(sum(c.value for c in children), 3)
        return out

    def prometheus_text(self) -> str:
        return self.registry.prometheus_text()

    def write_prometheus(self, path: str) -> str:
        """Atomic rewrite (tmp + rename): a scraper never reads a torn
        file."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(self.prometheus_text())
        os.replace(tmp, path)
        return path

    # -- the --metrics-every dumper thread ----------------------------------
    def start_dumper(self, path: str, every: float) -> None:
        """Rewrite `path` every `every` seconds until stop_dumper().
        Idempotent start; `every <= 0` writes once and starts nothing."""
        self.write_prometheus(path)
        if every is None or every <= 0 or self._dump_thread is not None:
            return
        self._dump_stop.clear()

        def _loop():
            while not self._dump_stop.wait(every):
                try:
                    self.write_prometheus(path)
                except OSError:
                    pass        # transient FS trouble; final write retries

        self._dump_thread = threading.Thread(
            target=_loop, daemon=True, name="kps-metrics")
        self._dump_thread.start()

    def stop_dumper(self, path: str | None = None) -> None:
        """Stop the dumper and (when `path` given) write a final dump —
        drive loops call this from their teardown."""
        self._dump_stop.set()
        t = self._dump_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=10.0)
        self._dump_thread = None
        if path is not None:
            try:
                self.write_prometheus(path)
            except OSError:
                pass


class _NullMetric:
    """Shared no-op child: every mutator swallows its arguments."""

    __slots__ = ()

    def inc(self, n=1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def observe(self, v) -> None:
        pass

    value = 0
    count = 0


_NULL_METRIC = _NullMetric()


class _NullTelemetry(Telemetry):
    """Telemetry off — the default, mirroring NULL_TRACER: factories
    hand back the shared no-op metric, exports are empty."""

    def __init__(self):
        super().__init__()
        self.enabled = False

    def counter(self, name, help_text="", **labels):
        return _NULL_METRIC

    def gauge(self, name, help_text="", **labels):
        return _NULL_METRIC

    def histogram(self, name, buckets=None, help_text="", **labels):
        return _NULL_METRIC

    def snapshot(self) -> dict:
        return {}

    def summary(self) -> dict:
        return {}


NULL_TELEMETRY = _NullTelemetry()


def maybe_telemetry(tracer=None, want_metrics: bool = False):
    """CLI helper: a real Telemetry when tracing or metrics were asked
    for, NULL_TELEMETRY otherwise (so runtime wiring can pass the result
    through unconditionally)."""
    if want_metrics or (tracer is not None and tracer.enabled):
        return Telemetry(tracer=tracer)
    return NULL_TELEMETRY
