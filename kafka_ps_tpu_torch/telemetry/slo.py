"""Declarative SLOs with multi-window burn rates over the metrics
registry (counterpart of kafka_ps_tpu/telemetry/slo.py).

Raw metrics say what the system *did*; an SLO says what it *promised*.
Each `SLO` is (name, target fraction, a zero-arg `good_total` callable
returning cumulative (good, total) event counts read off the metrics
registry).  The `SLOPlane` samples every armed SLO on a named daemon
thread (`kps-slo`, ~5 s cadence), keeps a bounded history of
(monotonic, good, total) points, and derives the SRE-workbook
multi-window burn rate

    burn(window) = bad_fraction(window) / (1 - target)

over a fast (5 min) and a slow (1 h) window: burn 1.0 means "spending
exactly the error budget", a fast-window burn over 1.0 means the budget
is burning *right now*.  Three consumers:

  * Prometheus — `slo_burn_rate{slo=...,window=...}` gauges in the
    existing registry, exported by /varz and --metrics-file;
  * `/healthz` — `detail()` rides the health body so a probe sees
    targets and burn rates next to the watchdog verdicts;
  * the flight plane — the plane beats `slo` while healthy and exposes
    `burning()` as a demand predicate, so OpsPlane can arm a standard
    demand-gated watchdog (telemetry/health.py semantics): a budget
    burning continuously past the threshold trips one flight dump with
    the profile and metrics attached.

The standard objectives (`standard_slos`) are pure reads of existing
families plus the new `serving_latency_ms` histogram:

    serving_availability   good = served requests; bad = admission
                           rejections + load sheds
    serving_latency        good = requests answered within the deadline
                           (interpolated cumulative bucket count <=
                           threshold — `count_le`, the same linear-
                           interpolation convention as interp_quantile)
    snapshot_freshness     good = snapshot-age observations within the
                           staleness bound

Everything here is stdlib + registry reads: sampling never touches the
hot paths it judges, and the plane is inert unless a --slo-* flag armed
it (cli/run.py, cli/socket_mode.py:_make_ops).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from kafka_ps_tpu_torch.analysis.lockgraph import OrderedLock

# (label, seconds) burn windows — SRE-workbook fast/slow pairing.
WINDOWS = (("fast", 300.0), ("slow", 3600.0))
DEFAULT_SAMPLE_EVERY_S = 5.0
# bounded history: slow window / cadence, with slack for jitter
_HISTORY = 1024


def count_le(bounds, counts, x: float) -> float:
    """How many of the histogram's observations were <= `x`, linearly
    interpolated inside the bucket containing `x` (the read-side dual
    of `interp_quantile`: that maps rank -> value, this maps value ->
    rank).  Observations in the +Inf overflow bucket are never <= a
    finite threshold."""
    cum = 0.0
    lo = 0.0
    for bound, c in zip(bounds, counts):
        if x >= bound:
            cum += c
        else:
            if x > lo:
                cum += c * (x - lo) / (bound - lo)
            return cum
        lo = bound
    return cum


class SLO:
    """One objective: `good_total()` returns cumulative (good, total)
    floats; `target` is the promised good fraction (0.999 = "three
    nines")."""

    def __init__(self, name: str, target: float, good_total, *,
                 description: str = ""):
        if not 0.0 < target < 1.0:
            raise ValueError(f"SLO target must be in (0, 1), got {target}")
        self.name = name
        self.target = float(target)
        self.good_total = good_total
        self.description = description


class SLOPlane:
    """Samples armed SLOs, derives burn rates, exports gauges, feeds
    the watchdog plane.  `sample_once()` is the thread body and is
    directly callable by tests with an explicit `now`."""

    def __init__(self, telemetry, *,
                 sample_every_s: float = DEFAULT_SAMPLE_EVERY_S,
                 flight=None):
        # late import: flight.py must stay importable without slo.py
        from kafka_ps_tpu_torch.telemetry.flight import FLIGHT
        self.telemetry = telemetry
        self.flight = flight if flight is not None else FLIGHT
        self.sample_every_s = sample_every_s
        self.slos: list[SLO] = []
        # guarded-by: _lock (add populates before start - the add-before-start contract)
        self._history: dict[str, deque] = {}
        # pscheck: disable=PS201 (registered by add before the sampler starts; the sampler only reads)
        self._gauges: dict[tuple[str, str], object] = {}
        # pscheck: disable=PS201 (sampler is the sole writer; burning reads tolerate one interval of staleness)
        self._burning: dict[str, bool] = {}
        self._lock = OrderedLock("telemetry.slo")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def add(self, slo: SLO) -> SLO:
        self.slos.append(slo)
        self._history[slo.name] = deque(maxlen=_HISTORY)
        for wname, _ in WINDOWS:
            self._gauges[(slo.name, wname)] = self.telemetry.gauge(
                "slo_burn_rate",
                help_text="error-budget burn rate (1.0 = spending "
                          "exactly the budget)",
                slo=slo.name, window=wname)
        return slo

    # -- sampling -----------------------------------------------------------

    def sample_once(self, now: float | None = None) -> dict:
        """One sampling round: append history, refresh gauges, beat the
        flight plane while no fast window is burning.  Returns
        {slo: {window: burn}} for tests and detail()."""
        now = time.monotonic() if now is None else now
        out: dict[str, dict[str, float]] = {}
        any_burning = False
        for slo in self.slos:
            try:
                good, total = slo.good_total()
            except Exception:   # noqa: BLE001 — a broken reader must
                continue        # never take down the sampler thread
            with self._lock:
                self._history[slo.name].append(
                    (now, float(good), float(total)))
            burns: dict[str, float] = {}
            for wname, wsecs in WINDOWS:
                b = self.burn(slo.name, wsecs, now=now)
                burns[wname] = b
                self._gauges[(slo.name, wname)].set(round(b, 4))
            fast = burns.get("fast", 0.0)
            self._burning[slo.name] = fast > 1.0
            any_burning = any_burning or fast > 1.0
            out[slo.name] = burns
        if self.slos and not any_burning:
            self.flight.beat("slo")
        return out

    def burn(self, name: str, window_s: float,
             now: float | None = None) -> float:
        """Burn rate over the trailing window: bad fraction of the
        events that happened in the window, over the budget.  0.0 with
        fewer than two samples or no traffic (no data is not a burn)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            hist = list(self._history.get(name, ()))
        if len(hist) < 2:
            return 0.0
        cutoff = now - window_s
        base = None
        for point in hist:
            if point[0] >= cutoff:
                base = point
                break
        if base is None or base is hist[-1]:
            return 0.0
        _, g0, t0 = base
        _, g1, t1 = hist[-1]
        d_total = t1 - t0
        if d_total <= 0:
            return 0.0
        bad_fraction = max(0.0, (d_total - (g1 - g0)) / d_total)
        slo = next(s for s in self.slos if s.name == name)
        return bad_fraction / (1.0 - slo.target)

    def burning(self) -> bool:
        """Any SLO's fast window burning — the watchdog's demand
        predicate (cheap: reads the flags the sampler maintains)."""
        return any(self._burning.values())

    def detail(self) -> dict:
        """The /healthz block: per-SLO target, burn rates, cumulative
        counts at the last sample."""
        out: dict[str, dict] = {}
        for slo in self.slos:
            with self._lock:
                hist = self._history.get(slo.name)
                last = hist[-1] if hist else None
            entry: dict[str, object] = {"target": slo.target}
            if last is not None:
                _, good, total = last
                entry["good"] = good
                entry["total"] = total
            entry["burn"] = {
                wname: round(self.burn(slo.name, wsecs), 4)
                for wname, wsecs in WINDOWS}
            entry["burning"] = self._burning.get(slo.name, False)
            out[slo.name] = entry
        return out

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "SLOPlane":
        if self._thread is not None or not self.slos:
            return self
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.sample_every_s):
                self.sample_once()

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="kps-slo")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=10.0)
        self._thread = None


# -- the standard objectives over the existing registry families ------------


def _sum_counters(registry, name: str) -> float:
    fam = registry.families().get(name)
    if fam is None or fam.kind != "counter":
        return 0.0
    return float(sum(c.value for c in fam.children().values()))


def _hist_le_total(registry, name: str, x: float) -> tuple[float, float]:
    """(observations <= x, observations) summed across a histogram
    family's children."""
    fam = registry.families().get(name)
    if fam is None or fam.kind != "histogram":
        return 0.0, 0.0
    good = total = 0.0
    for child in fam.children().values():
        counts, _, n = child.state()
        good += count_le(child.bounds, counts, x)
        total += n
    return good, total


def serving_availability_slo(telemetry, target: float = 0.999) -> SLO:
    """Served vs turned-away: serving_requests_total counts only
    requests that were actually answered (serving/engine.py), so the
    denominator adds back the admission rejections and load sheds."""
    reg = telemetry.registry

    def good_total():
        served = _sum_counters(reg, "serving_requests_total")
        bad = (_sum_counters(reg, "serving_rejections_total")
               + _sum_counters(reg, "serving_shed_total"))
        return served, served + bad

    return SLO("serving_availability", target, good_total,
               description="requests served vs rejected/shed")


def serving_latency_slo(telemetry, threshold_ms: float,
                        target: float = 0.99) -> SLO:
    """p99-style deadline: at `target`=0.99, burn > 1 means more than
    1% of recent requests exceeded `threshold_ms` (read off the
    serving_latency_ms histogram, serving/engine.py:_finish)."""
    reg = telemetry.registry

    def good_total():
        return _hist_le_total(reg, "serving_latency_ms", threshold_ms)

    return SLO("serving_latency", target, good_total,
               description=f"served within {threshold_ms:g}ms")


def snapshot_freshness_slo(telemetry, bound_ms: float,
                           target: float = 0.99) -> SLO:
    """Staleness promise: snapshot_age_ms observations (one per served
    micro-batch) within the bound."""
    reg = telemetry.registry

    def good_total():
        return _hist_le_total(reg, "snapshot_age_ms", bound_ms)

    return SLO("snapshot_freshness", target, good_total,
               description=f"snapshot age within {bound_ms:g}ms")


def model_health_slo(telemetry, target: float = 0.99) -> SLO:
    """Model-health promise: the fraction of streaming eval rows with
    no active drift signal (telemetry/drift.py feeds both counters —
    unhealthy = the observation carried a warn/trip level).  Burn > 1
    at target 0.99 means more than 1% of recent eval rows saw the
    detectors agitated — the budget starts burning at WARNING, before
    the state machine latches DRIFT."""
    reg = telemetry.registry

    def good_total():
        total = _sum_counters(reg, "modelhealth_evals_total")
        bad = _sum_counters(reg, "modelhealth_unhealthy_total")
        return total - bad, total

    return SLO("model_health", target, good_total,
               description="eval rows with no active drift signal")


def standard_slos(telemetry, *, serving_p99_ms: float | None = None,
                  freshness_ms: float | None = None,
                  model_health: bool = False) -> list[SLO]:
    """The flag-driven objective set (cli flags --slo-serving-p99-ms /
    --slo-freshness-ms, plus the model_health objective once
    --model-health armed the drift counters): availability always
    rides along once any SLO is armed."""
    slos = [serving_availability_slo(telemetry)]
    if serving_p99_ms is not None:
        slos.append(serving_latency_slo(telemetry, serving_p99_ms))
    if freshness_ms is not None:
        slos.append(snapshot_freshness_slo(telemetry, freshness_ms))
    if model_health:
        slos.append(model_health_slo(telemetry))
    return slos


def plane_from_args(args, telemetry) -> SLOPlane | None:
    """CLI seam (cli/run.py, cli/socket_mode.py:_make_ops): an armed
    SLOPlane when any --slo-* flag (or --model-health, which brings
    its objective along) was given, else None — so the ops wiring can
    pass the result through unconditionally."""
    p99 = getattr(args, "slo_serving_p99_ms", None)
    fresh = getattr(args, "slo_freshness_ms", None)
    mh = bool(getattr(args, "model_health", False))
    if p99 is None and fresh is None and not mh:
        return None
    plane = SLOPlane(telemetry)
    for slo in standard_slos(telemetry, serving_p99_ms=p99,
                             freshness_ms=fresh, model_health=mh):
        plane.add(slo)
    return plane
