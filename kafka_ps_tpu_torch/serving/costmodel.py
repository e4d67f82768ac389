"""Online dispatch cost model: batching as a measured decision (a copy of
kafka_ps_tpu/serving/costmodel.py).

The engine's micro-batching default is only the right call when enough
rows share a window to amortize the per-dispatch tax (the forward's
kernel launches and its device-to-host read).  Below that occupancy,
batching is pure loss: the window wait buys nothing and the padded
dispatch costs the same as a single-row one.  Clipper calls
this out directly (adaptive batching, NSDI'17) and Nexus builds its
whole scheduler on the batch-latency curve (SOSP'19): the break-even
point is a *property of the model family*, so it must be measured, not
configured.

`DispatchCostModel` learns three things per tenant, all from samples
the engine already produces (the same per-dispatch timings that feed
`LatencyRecorder`; no new instrumentation on the hot path):

  * `t(bucket)` — EWMA wall seconds of one padded dispatch per
    power-of-two bucket shape.  `PredictionEngine.warmup` seeds every
    bucket with a second, compile-free timed call, so a warmed engine
    is calibrated before the first client request.
  * occupancy — EWMA rows per dispatch, the live estimate of how many
    rows a batching window actually collects under the current load.
  * arrival rate — EWMA inter-arrival seconds of admitted requests
    (the same signal the predictive shed estimator reasons about),
    used to size the batching window instead of always sleeping the
    full configured deadline.

Break-even occupancy falls out of the timings: batching k rows costs
`t(max_bucket) / k` per row against `t(1)` unbatched, so batching wins
iff `k > t(max_bucket) / t(1)`.  The t-ratio is necessary but not
sufficient — a micro-batch also convoys its clients' wake-ups, a cost
the dispatch timings cannot see — so batching only ENGAGES once the
measured backlog clears `max(break_even, max_batch/2)`.  Below that the
engine serves inline on caller threads (up to two lanes) and serves
queued overflow one row per cycle; the overflow's backlog feeds the
demand estimate that re-engages batching the moment sustained
concurrency returns.
"""

from __future__ import annotations

import math


class DispatchCostModel:
    """Per-model-family dispatch economics, learned online.

    All updates are single float/dict stores (GIL-atomic); callers may
    feed it from the batcher thread and request threads concurrently
    without a lock — a lost EWMA sample is noise, not corruption.
    """

    # demand within this margin of break-even counts as below it: the
    # boundary region is measurement noise, and the EWMA decays toward
    # 1.0 asymptotically from above — ties must not strand the engine
    # in batch mode paying window waits for nothing
    BYPASS_SLACK = 0.25
    # batching must also fill a decisive fraction of capacity before it
    # engages.  The t-ratio break-even only prices the dispatch; a
    # micro-batch additionally convoys its clients' wake-ups (k events
    # set back-to-back, k callers contending for the scheduler at
    # once), a cost the dispatch timings cannot see.  Measured on a
    # contended host, half-full windows trade even at best against
    # serving the backlog one row at a time with staggered wake-ups —
    # so below half capacity the engine keeps the serial queued path
    # and batching waits for demand that decisively amortizes.
    BATCH_FLOOR_FRAC = 0.5

    def __init__(self, max_batch: int, *, alpha: float = 0.2):
        self.max_batch = max(1, int(max_batch))
        self.alpha = alpha
        # EWMA dispatch seconds per bucket shape; seeded by warmup,
        # refined by every live dispatch
        self._t: dict[int, float] = {}
        # EWMA rows per dispatch, over ALL dispatches (reporting)
        self.occupancy = 1.0
        # EWMA rows AVAILABLE per queued-path serve — the decision
        # signal.  Sampled as what a full drain could have collected
        # (rows served + rows still queued, capped at max_batch), NOT
        # what this serve took: in the serial regime every queued serve
        # is one row, so serve size alone could never report demand
        # deep enough to re-engage batching.  Bypass serves are
        # excluded: they never see the queue, so they say nothing about
        # what a batching window would collect.  Sustained concurrency
        # overflows the inline lanes into the queue, shows up here
        # within a few serves, and flips the engine to batching; a
        # lone closed-loop client never does, and stays on the fast
        # path.
        self.demand = 1.0
        # EWMA seconds between admitted requests
        self._interarrival_s: float | None = None
        self._last_arrival: float | None = None
        self.dispatches = 0

    # -- sample intake ------------------------------------------------------

    def observe_arrival(self, t_mono: float) -> None:
        """One admitted request at monotonic time `t_mono`."""
        last, self._last_arrival = self._last_arrival, t_mono
        if last is None:
            return
        gap = t_mono - last
        if gap < 0.0:
            return
        self._interarrival_s = gap if self._interarrival_s is None \
            else self.alpha * gap + (1 - self.alpha) * self._interarrival_s

    def observe_dispatch(self, rows: int, bucket: int, dt_s: float,
                         batched: bool = True,
                         avail: int | None = None) -> None:
        """One completed dispatch: `rows` live rows padded to `bucket`
        took `dt_s` wall seconds (assembly + device call + sync).
        `avail` is the backlog a full drain could have collected at
        serve time (rows + still-queued, engine-capped at max_batch);
        it feeds the demand estimate when given, `rows` otherwise.
        `batched=False` marks a bypass serve — it refines the timing
        curve but not the demand estimate (see `demand`)."""
        self.dispatches += 1
        have = self._t.get(bucket)
        self._t[bucket] = dt_s if have is None \
            else self.alpha * dt_s + (1 - self.alpha) * have
        self.occupancy = (self.alpha * rows
                          + (1 - self.alpha) * self.occupancy)
        if batched:
            sample = min(self.max_batch, avail) if avail is not None \
                else rows
            self.demand = (self.alpha * sample
                           + (1 - self.alpha) * self.demand)

    def seed(self, bucket: int, dt_s: float) -> None:
        """Warmup calibration: a compile-free timed dispatch of this
        bucket shape.  Overwrites any prior estimate — a fresh steady-
        state sample beats a stale one."""
        self._t[bucket] = dt_s

    # -- the learned quantities ---------------------------------------------

    @property
    def calibrated(self) -> bool:
        """Both ends of the batch-latency curve measured: trust the
        break-even estimate only once t(1) and t(max_bucket) exist."""
        return 1 in self._t and self.max_batch in self._t

    @property
    def arrival_qps(self) -> float:
        ia = self._interarrival_s
        return 0.0 if not ia else 1.0 / ia

    @property
    def break_even(self) -> float:
        """Occupancy above which batched dispatch beats per-request
        dispatch: t(max_bucket) / t(1), floored at 1 (batching a single
        row is never cheaper than dispatching it)."""
        t1 = self._t.get(1)
        tb = self._t.get(self.max_batch)
        if not t1 or not tb:
            return 1.0
        return max(1.0, tb / t1)

    # -- the decisions ------------------------------------------------------

    @property
    def engage_threshold(self) -> float:
        """Demand above which the queued path switches from serving
        rows serially to micro-batching them: the dispatch-cost
        break-even OR the half-capacity floor, whichever is higher
        (see BATCH_FLOOR_FRAC for why the t-ratio alone is not
        sufficient)."""
        return max(self.break_even + self.BYPASS_SLACK,
                   self.BATCH_FLOOR_FRAC * self.max_batch)

    def bypass(self) -> bool:
        """Stay off the batching regime?  True while the measured
        backlog sits below the engage threshold — windows would
        collect too few rows to pay for themselves.  In this regime
        the engine serves inline on caller threads when a lane is
        free and serves queued overflow one row per cycle (staggered
        wake-ups); batching engages only on demand that decisively
        amortizes.  Always False uncalibrated: the cold default is
        the batching path (the status quo)."""
        return self.calibrated and self.demand < self.engage_threshold

    def window_s(self, have: int, deadline_s: float) -> float:
        """How long the batcher should wait for more rows, given `have`
        already collected.  Zero in the bypass regime (rows only reach
        the queue there on a concurrent burst — serve them now); else
        the time the live arrival rate needs to fill the batch to the
        MEASURED demand, capped at the configured deadline.  The fill
        target is demand, not capacity: at demand d << max_batch,
        waiting to fill max_batch stalls every collected row for
        (max_batch - d) interarrivals it will never collect — the very
        fixed-window regression adaptive dispatch exists to close."""
        if not self.calibrated:
            return deadline_s
        if self.bypass():
            return 0.0
        target = min(self.max_batch, math.ceil(self.demand))
        if have >= target:
            return 0.0
        ia = self._interarrival_s
        if not ia:
            return deadline_s
        # waiting one interarrival buys one row; dispatching what we
        # have costs t(1)-ish and keeps collecting DURING the dispatch.
        # So a wait only pays when arrivals outpace an unbatched
        # dispatch — otherwise any window re-opens the closed-loop
        # spiral (slow serving -> depressed arrival rate -> longer
        # window -> slower serving) that parks latency at the deadline.
        if ia > self._t.get(1, math.inf):
            return 0.0
        return min(deadline_s, (target - have) * ia)

    def as_dict(self) -> dict:
        """Host-value summary for stats()/flight events."""
        return {"calibrated": self.calibrated,
                "break_even": round(self.break_even, 2),
                "engage_threshold": round(self.engage_threshold, 2),
                "occupancy": round(self.occupancy, 2),
                "demand": round(self.demand, 2),
                "arrival_qps": round(self.arrival_qps, 1),
                "dispatches": self.dispatches}
