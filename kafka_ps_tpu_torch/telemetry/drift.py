"""Online drift detection over the streaming eval signal (counterpart of
kafka_ps_tpu/telemetry/drift.py; the same detectors, states, counters,
flight records and CSV rows for the same observations).

Two classic streaming change detectors run on the host scalars the
server already emits per eval row:

  * `PageHinkley` — Page's CUSUM-style test (Page, 1954): O(1) state,
    trips when the cumulative positive deviation of the signal from its
    running mean exceeds a threshold.  Directional (detects increases;
    feed `-x` to watch for drops).
  * `AdwinLite` — a windowed ADWIN-style detector (Bifet & Gavaldà,
    2007): keeps the last W observations and cuts the window wherever
    the two halves' means differ by more than a Bernstein/Hoeffding
    bound.  Two-sided, adapts its sensitivity to the observed variance.
  * `WelfordSketch` + `stability_score` — a vectorized per-feature
    mean/variance sketch over sampled buffer arrivals; the normalized
    mean-shift between a frozen reference window and the current window
    is a population-stability score (a PSI-like scalar) that flags
    covariate shift even before the eval metric moves.

`DriftMonitor` composes them into a STABLE -> WARNING -> DRIFT state
machine: detectors emit warn/trip levels per observation, WARNING
decays after a calm stretch, DRIFT latches (until `reset()`).
Transitions export as the `drift_state` gauge, record `drift.warn` /
`drift.trip` flight events, append to the drift CSV sink (the CLI stamps
the wall clock — this module never reads one), and feed the
`model_health` SLO counters.

Detectors count in observations, never in wall-clock seconds, so a
replayed run produces the identical verdict sequence; every metric and
flight call receives host scalars only (the monitor is fed Python
floats, never tensors: telemetry/modelhealth.py resolves them first).
"""

from __future__ import annotations

from collections import deque

import numpy as np

from kafka_ps_tpu_torch.analysis.lockgraph import OrderedLock
from kafka_ps_tpu_torch.telemetry.flight import FLIGHT

# state-machine levels (the drift_state gauge values)
STABLE, WARNING, DRIFT = 0, 1, 2
_STATE_NAMES = {STABLE: "STABLE", WARNING: "WARNING", DRIFT: "DRIFT"}

# detector defaults — the JAX package's, tuned on its synthetic
# label-flip regime: loss is O(1)-scaled, so a sustained
# +0.1 shift crosses PH_THRESHOLD within ~15 eval rows while the
# stable arm's jitter never accumulates past the drift tolerance.
PH_THRESHOLD = 1.5
PH_DELTA = 0.02
PH_MIN_N = 10
ADWIN_WINDOW = 200
ADWIN_DELTA = 0.002
ADWIN_MIN_CUT = 8
WARN_RATIO = 0.6
# consecutive calm evals before WARNING decays back to STABLE
CLEAR_AFTER = 20
# feature-sketch cadence and window sizing
FEATURE_SAMPLE_EVERY = 16
SKETCH_REF_ROWS = 64
SKETCH_CUR_ROWS = 64
STABILITY_WARN = 0.5
_EPS = 1e-8


class PageHinkley:
    """Page–Hinkley test for an upward mean shift: O(1) per update.

    m_t accumulates (x - mean_t - delta); the statistic is m_t minus
    its running minimum.  `update(x)` returns the alarm level for this
    observation: 0 calm, 1 warn (past `warn_ratio` of the threshold),
    2 trip."""

    name = "ph"

    def __init__(self, threshold: float = PH_THRESHOLD,
                 delta: float = PH_DELTA, min_n: int = PH_MIN_N,
                 warn_ratio: float = WARN_RATIO):
        self.threshold = float(threshold)
        self.delta = float(delta)
        self.min_n = int(min_n)
        self.warn_ratio = float(warn_ratio)
        self.reset()

    def reset(self) -> None:
        self.n = 0
        self.mean = 0.0
        self._m = 0.0
        self._m_min = 0.0
        self.statistic = 0.0

    def update(self, x: float) -> int:
        self.n += 1
        self.mean += (x - self.mean) / self.n
        self._m += x - self.mean - self.delta
        self._m_min = min(self._m_min, self._m)
        self.statistic = self._m - self._m_min
        if self.n < self.min_n:
            return STABLE
        if self.statistic > self.threshold:
            return DRIFT
        if self.statistic > self.warn_ratio * self.threshold:
            return WARNING
        return STABLE


class AdwinLite:
    """Windowed ADWIN-style detector: keep the last `window` points and
    test every power-of-two-ish cut for a mean difference past the
    Bernstein bound at confidence `delta`.  Two-sided; `update(x)`
    returns 0/1/2 like PageHinkley.  On a trip the pre-cut prefix is
    dropped, so the detector re-baselines onto the new regime."""

    name = "adwin"

    def __init__(self, window: int = ADWIN_WINDOW,
                 delta: float = ADWIN_DELTA,
                 min_cut: int = ADWIN_MIN_CUT,
                 warn_ratio: float = WARN_RATIO,
                 trip_ratio: float = 1.0):
        self.window = int(window)
        self.delta = float(delta)
        self.min_cut = int(min_cut)
        self.warn_ratio = float(warn_ratio)
        self.trip_ratio = float(trip_ratio)
        self.reset()

    def reset(self) -> None:
        self._buf: deque[float] = deque(maxlen=self.window)
        self.statistic = 0.0     # best |mean gap| / bound ratio seen

    def _bound(self, var: float, m: int) -> float:
        # Bernstein-style bound (the real ADWIN's variance-aware cut):
        # eps = sqrt(2/m * var * ln(2/d)) + (2/(3m)) * ln(2/d)
        ln = np.log(2.0 / self.delta)
        return float(np.sqrt(2.0 * var * ln / m) + 2.0 * ln / (3.0 * m))

    def update(self, x: float) -> int:
        self._buf.append(float(x))
        n = len(self._buf)
        if n < 2 * self.min_cut:
            self.statistic = 0.0
            return STABLE
        arr = np.asarray(self._buf, dtype=np.float64)
        var = float(arr.var())
        best = 0.0
        cut_at = None
        # cuts at geometric points: cheap (O(log W) tests per update)
        # while still localizing the change within a factor of two
        cut = self.min_cut
        while cut <= n - self.min_cut:
            m = min(cut, n - cut)       # harmonic-ish effective count
            gap = abs(float(arr[:cut].mean()) - float(arr[cut:].mean()))
            ratio = gap / (self._bound(var, m) + _EPS)
            if ratio > best:
                best = ratio
                cut_at = cut
            cut *= 2
        self.statistic = best
        if best > self.trip_ratio:
            # drop the old regime so the window re-baselines
            keep = list(self._buf)[cut_at:]
            self._buf.clear()
            self._buf.extend(keep)
            return DRIFT
        if best > self.warn_ratio:
            return WARNING
        return STABLE


def make_detector(kind: str, threshold: float | None = None):
    """Factory behind --drift-detector; `threshold` overrides the
    trip bound (PH statistic / ADWIN confidence-ratio scale)."""
    if kind == "ph":
        return PageHinkley(threshold=PH_THRESHOLD if threshold is None
                           else threshold)
    if kind == "adwin":
        if threshold is None:
            return AdwinLite()
        # the ADWIN statistic is a mean-gap-to-bound ratio; the flag
        # moves the trip ratio (and the warn point with it)
        return AdwinLite(warn_ratio=WARN_RATIO * threshold,
                         trip_ratio=threshold)
    raise ValueError(f"unknown drift detector {kind!r} "
                     "(expected 'ph' or 'adwin')")


class WelfordSketch:
    """Vectorized per-feature running mean/variance (Welford, 1962) —
    one O(F) numpy update per sampled row, no row retention."""

    def __init__(self, num_features: int):
        self.n = 0
        self.mean = np.zeros(num_features, dtype=np.float64)
        self._m2 = np.zeros(num_features, dtype=np.float64)

    def update(self, row: np.ndarray) -> None:
        self.n += 1
        d = row - self.mean
        self.mean += d / self.n
        self._m2 += d * (row - self.mean)

    def var(self) -> np.ndarray:
        if self.n < 2:
            return np.zeros_like(self._m2)
        return self._m2 / (self.n - 1)


def stability_score(ref: WelfordSketch, cur: WelfordSketch) -> float:
    """PSI-like population-stability scalar between two sketches: the
    mean over features of the squared mean shift normalized by the
    pooled variance.  ~0 when the windows agree; O(1) per unit of
    shift-in-sigmas squared."""
    if ref.n < 2 or cur.n < 2:
        return 0.0
    pooled = 0.5 * (ref.var() + cur.var()) + _EPS
    d = (cur.mean - ref.mean) ** 2 / pooled
    return float(d.mean())


class DriftMonitor:
    """The state machine over the detectors.  Fed host floats only:

      * `observe_eval(loss, f1)` — one streaming eval row (the server's
        continuous test-set evaluation); f1 < 0 is the reference's
        "not computed" placeholder and feeds loss alone;
      * `observe_row(features)` — one sampled buffer arrival (sparse
        dict or dense vector) into the Welford reference/current
        windows.

    `log` is an optional callable taking the CSV remainder
    `event;detector;statistic;signal` — the cli wiring wraps it with a
    wall-clock timestamp so this module stays replay-pure."""

    def __init__(self, telemetry, *, detector: str = "ph",
                 threshold: float | None = None,
                 num_features: int | None = None,
                 feature_sample_every: int = FEATURE_SAMPLE_EVERY,
                 clear_after: int = CLEAR_AFTER,
                 log=None, shard: int | None = None, flight=None):
        self.detector_kind = detector
        # loss rises and f1 falls under drift; PH is directional so the
        # metric detector watches -f1.  AdwinLite is two-sided already.
        self._d_loss = make_detector(detector, threshold)
        self._d_metric = make_detector(detector, threshold)
        self._sample_every = max(1, int(feature_sample_every))
        self._clear_after = int(clear_after)
        self.log = log
        self.flight = flight if flight is not None else FLIGHT
        self._lock = OrderedLock("telemetry.drift")
        labels = {"shard": str(shard)} if shard is not None else {}
        self._g_state = telemetry.gauge(
            "drift_state",
            help_text="0 STABLE / 1 WARNING / 2 DRIFT", **labels)
        self._g_stability = telemetry.gauge(
            "drift_population_stability",
            help_text="PSI-like feature-shift score vs the reference "
                      "window", **labels)
        self._c_evals = telemetry.counter(
            "modelhealth_evals_total", **labels)
        self._c_unhealthy = telemetry.counter(
            "modelhealth_unhealthy_total", **labels)
        self._c_warns = telemetry.counter("drift_warn_total", **labels)
        self._c_trips = telemetry.counter("drift_trip_total", **labels)
        self._g_state.set(STABLE)
        self.state = STABLE
        self.evals = 0
        self.trips = 0
        self.warns = 0
        self.last_trip_eval: int | None = None
        self.last_statistic = 0.0
        self._calm_streak = 0
        self._psi_level = STABLE
        self._stability = 0.0
        # feature sketch state (lazy: dims known at first row)
        self._num_features = num_features
        self._rows_seen = 0
        self._ref: WelfordSketch | None = None
        self._cur: WelfordSketch | None = None

    # -- eval signal --------------------------------------------------------

    def observe_eval(self, loss: float, f1: float) -> None:
        with self._lock:
            self.evals += 1
            lv_loss = self._d_loss.update(float(loss))
            lv_metric = STABLE
            if f1 >= 0.0:
                lv_metric = self._d_metric.update(-float(f1))
            level = max(lv_loss, lv_metric, self._psi_level)
            signal = ("loss" if lv_loss >= lv_metric else "f1")
            if level == self._psi_level and level > max(lv_loss,
                                                        lv_metric):
                signal = "features"
            stat = (self._d_loss.statistic if signal == "loss"
                    else self._d_metric.statistic if signal == "f1"
                    else self._stability)
            self.last_statistic = stat
            transition = self._advance(level)
            eval_idx = self.evals
            state = self.state
        # metrics/flight outside the lock, host scalars only
        self._c_evals.inc()
        if level > STABLE:
            self._c_unhealthy.inc()
        if transition == DRIFT:
            self.trips += 1
            self.last_trip_eval = eval_idx
            self._c_trips.inc()
            self._g_state.set(DRIFT)
            if self.flight.enabled:
                self.flight.record("drift.trip",
                                   detector=self.detector_kind,
                                   statistic=round(stat, 4),
                                   signal=signal, eval_row=eval_idx)
            self._emit_log("trip", stat, signal)
            # re-baseline so a later regime change is detectable even
            # while the state stays latched at DRIFT
            self._d_loss.reset()
            self._d_metric.reset()
        elif transition == WARNING:
            self.warns += 1
            self._c_warns.inc()
            self._g_state.set(WARNING)
            if self.flight.enabled:
                self.flight.record("drift.warn",
                                   detector=self.detector_kind,
                                   statistic=round(stat, 4),
                                   signal=signal, eval_row=eval_idx)
            self._emit_log("warn", stat, signal)
        elif transition == STABLE:
            self._g_state.set(STABLE)
        else:
            self._g_state.set(state)

    def _advance(self, level: int) -> int | None:
        """State transition for one observation; returns the new state
        on an edge, None when unchanged.  Caller holds the lock."""
        if self.state == DRIFT:
            return None                  # latched until reset()
        if level == DRIFT:
            self.state = DRIFT
            return DRIFT
        if level == WARNING:
            self._calm_streak = 0
            if self.state != WARNING:
                self.state = WARNING
                return WARNING
            return None
        # calm observation
        if self.state == WARNING:
            self._calm_streak += 1
            if self._calm_streak >= self._clear_after:
                self.state = STABLE
                self._calm_streak = 0
                return STABLE
        return None

    def _emit_log(self, event: str, stat: float, signal: str) -> None:
        if self.log is not None:
            self.log(f"{event};{self.detector_kind};{stat:.6g};{signal}")

    # -- feature signal (sampled buffer arrivals) ---------------------------

    def observe_row(self, features) -> None:
        """One buffer arrival; only every `feature_sample_every`-th row
        is densified and sketched (the rest cost one counter bump)."""
        with self._lock:
            self._rows_seen += 1
            if self._rows_seen % self._sample_every:
                return
            row = self._densify(features)
            if row is None:
                return
            if self._ref is None:
                self._ref = WelfordSketch(len(row))
                self._cur = WelfordSketch(len(row))
            if self._ref.n < SKETCH_REF_ROWS:
                self._ref.update(row)
                return
            self._cur.update(row)
            if self._cur.n < SKETCH_CUR_ROWS:
                return
            score = stability_score(self._ref, self._cur)
            self._stability = score
            self._psi_level = WARNING if score > STABILITY_WARN \
                else STABLE
            self._cur = WelfordSketch(len(row))
        self._g_stability.set(round(score, 4))

    def _densify(self, features) -> np.ndarray | None:
        if isinstance(features, dict):
            if self._num_features is None:
                return None              # dims unknown; skip sparse rows
            row = np.zeros(self._num_features, dtype=np.float64)
            keys = sorted(features)
            for k in keys:
                if 0 <= k < self._num_features:
                    row[k] = features[k]
            return row
        return np.asarray(features, dtype=np.float64)

    # -- read side ----------------------------------------------------------

    def in_drift(self) -> bool:
        """The armed watchdog's demand predicate (health.py semantics):
        latched DRIFT is continuous demand with no beat, so the dog
        trips once and ships the flight dump."""
        return self.state == DRIFT

    @property
    def state_name(self) -> str:
        return _STATE_NAMES[self.state]

    def reset(self) -> None:
        """Un-latch DRIFT and re-baseline every detector."""
        with self._lock:
            self.state = STABLE
            self._calm_streak = 0
            self._psi_level = STABLE
            self._d_loss.reset()
            self._d_metric.reset()
            self._ref = None
            self._cur = None
        self._g_state.set(STABLE)

    def summary(self) -> dict:
        return {"state": self.state_name, "evals": self.evals,
                "trips": self.trips, "warns": self.warns}

    def detail(self) -> dict:
        with self._lock:
            return {
                "state": self.state_name,
                "detector": self.detector_kind,
                "evals": self.evals,
                "trips": self.trips,
                "warns": self.warns,
                "last_trip_eval": self.last_trip_eval,
                "loss_statistic": round(self._d_loss.statistic, 4),
                "metric_statistic": round(self._d_metric.statistic, 4),
                "population_stability": round(self._stability, 4),
                "rows_sketched": (0 if self._ref is None
                                  else self._ref.n
                                  + (self._cur.n if self._cur else 0)),
            }
