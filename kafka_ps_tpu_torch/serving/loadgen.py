"""Closed- and open-loop load generation for the serving plane (a copy
of kafka_ps_tpu/serving/loadgen.py, with a stop event on the closed
loop).

Two questions a serving stack must answer with numbers, not vibes:

  * where is the knee — the max sustained QPS at which p99 still meets
    the deadline SLO (`find_knee`), and
  * how does it fail past the knee — explicit typed sheds with the
    accepted requests still fast (`OverloadedError` counted separately
    from staleness and transport errors).

Closed loop (`run_closed_loop`) models a fixed fleet of synchronous
callers: N threads each issuing back-to-back requests — throughput
adapts to service time, so it measures capacity, not latency under a
target rate.  Open loop (`run_open_loop`) models independent arrivals:
a Poisson or bursty schedule fixes WHEN each request fires regardless
of how the previous one fared; latency is measured from the scheduled
arrival (not the actual send), so client-side lag counts against the
server — the coordinated-omission-safe convention.

Targets abstract the two paths the engine serves: `EngineTarget` drives
the in-process `PredictionEngine`, `SocketTarget` drives a serving port
through per-thread `PredictClient`s (one outstanding request per
connection, like real thin clients).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np

from kafka_ps_tpu_torch.analysis.lockgraph import OrderedLock
from kafka_ps_tpu_torch.serving import policy
from kafka_ps_tpu_torch.utils.trace import LatencyRecorder


@dataclass
class LoadResult:
    """One load run's ledger.  Latency percentiles cover ACCEPTED
    (OK) requests only — a fast typed rejection must not flatter p99."""

    requests: int
    ok: int
    stale: int
    shed: int
    errors: int
    duration_s: float
    achieved_qps: float
    p50_ms: float | None
    p99_ms: float | None
    offered_qps: float | None = None   # None for closed-loop runs

    @property
    def shed_rate(self) -> float:
        return self.shed / max(self.requests, 1)

    def meets(self, deadline_ms: float) -> bool:
        """Did this run sustain the SLO: every request answered, p99 of
        accepted requests within the deadline, nothing shed?"""
        return (self.ok > 0 and self.shed == 0 and self.errors == 0
                and self.p99_ms is not None
                and self.p99_ms <= deadline_ms)

    def as_dict(self) -> dict:
        out = {"requests": self.requests, "ok": self.ok,
               "stale": self.stale, "shed": self.shed,
               "errors": self.errors,
               "duration_s": round(self.duration_s, 3),
               "achieved_qps": round(self.achieved_qps, 1),
               "p50_ms": self.p50_ms, "p99_ms": self.p99_ms,
               "shed_rate": round(self.shed_rate, 4)}
        if self.offered_qps is not None:
            out["offered_qps"] = round(self.offered_qps, 1)
        return out


class EngineTarget:
    """Drive an in-process serving.engine.PredictionEngine."""

    def __init__(self, engine, bound: policy.ReadBound | None = None,
                 model_id: int = 0, timeout: float = 30.0):
        self.engine = engine
        self.bound = bound
        self.model_id = model_id
        self.timeout = timeout

    def make_issue(self):
        engine, bound = self.engine, self.bound
        model_id, timeout = self.model_id, self.timeout

        def _issue(x):
            return engine.predict(x, bound, model_id=model_id,
                                  timeout=timeout)

        return _issue

    def close(self) -> None:
        pass                        # the engine belongs to the caller


class SocketTarget:
    """Drive a serving socket through per-thread PredictClients.

    One client per load thread — the PredictClient contract is one
    outstanding request per connection, so concurrency comes from the
    thread count, exactly like a fleet of thin clients."""

    def __init__(self, host: str, port: int, *,
                 min_clock: int | None = None,
                 max_age_s: float | None = None, model_id: int = 0,
                 reconnect: bool = False, timeout: float = 30.0,
                 shm: bool = False):
        self.host, self.port = host, port
        self.min_clock, self.max_age_s = min_clock, max_age_s
        self.model_id = model_id
        self.reconnect = reconnect
        self.timeout = timeout
        self.shm = shm          # per-client shared-memory negotiation
        self._clients: list = []
        self._lock = OrderedLock("loadgen.SocketTarget.clients")

    def make_issue(self):
        from kafka_ps_tpu_torch.runtime import net
        client = net.PredictClient(self.host, self.port,
                                   timeout=self.timeout,
                                   reconnect=self.reconnect,
                                   model_id=self.model_id,
                                   shm=self.shm)
        with self._lock:
            self._clients.append(client)
        min_clock, max_age_s = self.min_clock, self.max_age_s

        def _issue(x):
            return client.predict(x, min_clock, max_age_s)

        return _issue

    def close(self) -> None:
        with self._lock:
            clients, self._clients = self._clients, []
        for c in clients:
            c.close()


class RoundRobinTarget:
    """Spread load threads across replica targets, round-robin.

    Models a client fleet balanced over N serving endpoints (a load
    balancer in front of read replicas): each load thread is
    pinned to one replica for its lifetime, consecutive threads land on
    consecutive replicas."""

    def __init__(self, targets):
        if not targets:
            raise ValueError("need at least one target")
        self.targets = list(targets)
        self._next = 0
        self._lock = OrderedLock("loadgen.RoundRobinTarget.next")

    def make_issue(self):
        with self._lock:
            target = self.targets[self._next % len(self.targets)]
            self._next += 1
        return target.make_issue()

    def close(self) -> None:
        for t in self.targets:
            t.close()


# -- arrival processes -------------------------------------------------------

def poisson_arrivals(rate_qps: float, duration_s: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Absolute arrival times in [0, duration): exponential
    inter-arrivals at `rate_qps` — independent memoryless clients."""
    n = max(1, int(rate_qps * duration_s * 1.5) + 8)
    gaps = rng.exponential(1.0 / rate_qps, size=n)
    times = np.cumsum(gaps)
    while times[-1] < duration_s:        # tail shortfall: extend
        more = np.cumsum(rng.exponential(1.0 / rate_qps, size=n))
        times = np.concatenate([times, times[-1] + more])
    return times[times < duration_s]


def bursty_arrivals(rate_qps: float, duration_s: float,
                    rng: np.random.Generator, *, period_s: float = 0.5,
                    duty: float = 0.25) -> np.ndarray:
    """On/off arrivals averaging `rate_qps`: each `period_s` window
    front-loads all traffic into its first `duty` fraction at rate
    rate/duty — the flash-crowd shape that stresses the admission queue
    harder than Poisson at the same mean rate."""
    if not 0 < duty <= 1:
        raise ValueError(f"duty {duty} must be in (0, 1]")
    base = poisson_arrivals(rate_qps, duration_s, rng)
    # compress each period's arrivals into its first `duty` fraction:
    # the count (mean rate) is unchanged, the instantaneous on-rate is
    # rate/duty
    period_idx = np.floor(base / period_s)
    within = base - period_idx * period_s
    times = np.sort(period_idx * period_s + within * duty)
    return times[times < duration_s]


# -- load loops --------------------------------------------------------------

class _Ledger:
    """Shared counters for one run; one leaf lock, no nesting."""

    def __init__(self):
        self.lock = OrderedLock("loadgen.ledger")
        self.ok = 0
        self.stale = 0
        self.shed = 0
        self.errors = 0
        self.latency = LatencyRecorder(window=65536)

    def settle(self, err: BaseException | None, t0: float) -> None:
        """Account one finished request (latency from `t0`, recorded
        for accepted requests only)."""
        dt = time.monotonic() - t0
        with self.lock:
            if err is None:
                self.ok += 1
                self.latency.record(dt)
            elif isinstance(err, policy.OverloadedError):
                self.shed += 1
            elif isinstance(err, policy.StalenessError):
                self.stale += 1
            else:
                self.errors += 1

    def result(self, requests: int, duration_s: float,
               offered_qps: float | None = None) -> LoadResult:
        pct = self.latency.percentiles_ms(50, 99)
        return LoadResult(requests=requests, ok=self.ok, stale=self.stale,
                          shed=self.shed, errors=self.errors,
                          duration_s=duration_s,
                          achieved_qps=self.ok / max(duration_s, 1e-9),
                          p50_ms=pct["p50_ms"], p99_ms=pct["p99_ms"],
                          offered_qps=offered_qps)


def _rows(features, rng: np.random.Generator, n: int = 64) -> np.ndarray:
    """Pre-built request rows: either the caller's matrix or synthetic
    standard-normal rows at `features` width."""
    if isinstance(features, int):
        return rng.standard_normal((n, features)).astype(np.float32)
    rows = np.asarray(features, dtype=np.float32)
    return rows.reshape(1, -1) if rows.ndim == 1 else rows


def run_closed_loop(target, features, *, concurrency: int = 4,
                    duration_s: float = 2.0, seed: int = 0,
                    stop: threading.Event | None = None) -> LoadResult:
    """`concurrency` synchronous callers, back-to-back for
    `duration_s`, or until `stop` is set when one is given.  Measures
    capacity: achieved QPS at this fleet size."""
    rng = np.random.default_rng(seed)
    rows = _rows(features, rng)
    ledger = _Ledger()
    counts = [0] * concurrency
    start = time.monotonic()
    stop_at = start + duration_s

    def _drive(tid: int) -> None:
        issue = target.make_issue()
        i = tid
        while time.monotonic() < stop_at and not (
                stop is not None and stop.is_set()):
            t0 = time.monotonic()
            err = None
            try:
                issue(rows[i % len(rows)])
            except Exception as e:  # noqa: BLE001 — the ledger classifies
                err = e
            ledger.settle(err, t0)
            counts[tid] += 1
            i += concurrency

    threads = [threading.Thread(target=_drive, args=(t,), daemon=True,
                                name=f"kps-loadgen-{t}")
               for t in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return ledger.result(sum(counts), time.monotonic() - start)


def run_open_loop(target, features, *, rate_qps: float,
                  duration_s: float = 2.0, concurrency: int = 8,
                  arrivals: str = "poisson", seed: int = 0) -> LoadResult:
    """Offered-rate run: a Poisson or bursty schedule fixes every
    arrival time up front; `concurrency` load threads fire them on
    schedule (round-robin).  Latency counts from the SCHEDULED arrival,
    so a lagging load thread inflates p99 instead of hiding queueing —
    coordinated omission never flatters the result."""
    rng = np.random.default_rng(seed)
    rows = _rows(features, rng)
    if arrivals == "poisson":
        sched = poisson_arrivals(rate_qps, duration_s, rng)
    elif arrivals == "bursty":
        sched = bursty_arrivals(rate_qps, duration_s, rng)
    else:
        raise ValueError(f"unknown arrival process {arrivals!r}")
    ledger = _Ledger()
    start = time.monotonic()

    def _drive(tid: int) -> None:
        issue = target.make_issue()
        for i in range(tid, len(sched), concurrency):
            at = start + float(sched[i])  # pscheck: disable=PS102 (host-side schedule arithmetic; keeps np.float64 out of the recorder)
            delay = at - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            err = None
            try:
                issue(rows[i % len(rows)])
            except Exception as e:  # noqa: BLE001 — the ledger classifies
                err = e
            ledger.settle(err, at)
    threads = [threading.Thread(target=_drive, args=(t,), daemon=True,
                                name=f"kps-loadgen-{t}")
               for t in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return ledger.result(len(sched), time.monotonic() - start,
                         offered_qps=rate_qps)


def find_knee(run_at, deadline_ms: float, *, lo_qps: float = 50.0,
              hi_qps: float = 100000.0, bisect_steps: int = 4) -> dict:
    """Max sustained QPS with p99 <= deadline and zero sheds/errors.

    `run_at(rate_qps) -> LoadResult` is the probe (an open-loop run at
    that offered rate).  Geometric ramp doubles from `lo_qps` until the
    SLO breaks (or `hi_qps`), then bisects the last good/first bad
    bracket.  Returns {knee_qps, probes: [LoadResult.as_dict()...]}."""
    probes: list[LoadResult] = []

    def probe(rate: float) -> LoadResult:
        r = run_at(rate)
        probes.append(r)
        return r

    good, bad = None, None
    rate = lo_qps
    while rate <= hi_qps:
        r = probe(rate)
        if r.meets(deadline_ms):
            good = rate
            rate *= 2
        else:
            bad = rate
            break
    if good is None:                    # SLO broken at the floor rate
        return {"knee_qps": 0.0,
                "probes": [p.as_dict() for p in probes]}
    if bad is not None:
        for _ in range(bisect_steps):
            mid = (good + bad) / 2
            if probe(mid).meets(deadline_ms):
                good = mid
            else:
                bad = mid
    return {"knee_qps": round(good, 1),
            "probes": [p.as_dict() for p in probes]}
