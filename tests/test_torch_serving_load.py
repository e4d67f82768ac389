"""The load generator (kafka_ps_tpu_torch/serving/loadgen.py) against the
JAX package's (kafka_ps_tpu/serving/loadgen.py) on the same seeds, and
the snapshot ring's wraparound edges.

  * the Poisson and bursty arrival schedules are the JAX package's,
    value for value, on the same numpy seed;
  * the ledger classifies accepted, stale, shed and failed requests as
    the JAX ledger does, and the summary dict is the same;
  * `find_knee` probes the same rates and returns the same dict on the
    same synthetic server;
  * closed- and open-loop runs against a port engine and a port serving
    socket; a stop event ends a closed loop;
  * the staleness policy at the ring's edges and at frontier cuts.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from kafka_ps_tpu.serving import loadgen as jloadgen
from kafka_ps_tpu.serving import policy as jpolicy
from kafka_ps_tpu_torch.models.task import get_task
from kafka_ps_tpu_torch.runtime import net
from kafka_ps_tpu_torch.serving import (OverloadedError, StalenessError,
                                        loadgen, policy)
from kafka_ps_tpu_torch.serving.engine import PredictionEngine
from kafka_ps_tpu_torch.serving.snapshot import (FrontierCutPublisher,
                                                 SnapshotRegistry)
from kafka_ps_tpu_torch.utils.config import ModelConfig


def make_engine(**kw):
    cfg = ModelConfig(num_features=4, num_classes=2)
    task = get_task("logreg", cfg)
    theta = torch.from_numpy(np.random.default_rng(3).normal(
        size=task.num_params).astype(np.float32))
    registry = SnapshotRegistry()
    registry.publish(theta, vector_clock=7)
    return PredictionEngine(task, registry, **kw), cfg


# -- arrivals and the ledger against the JAX loadgen --------------------------


@pytest.mark.parametrize("rate,dur,seed", [(1000.0, 2.0, 0), (37.5, 3.0, 4),
                                           (5000.0, 0.2, 9)])
def test_arrivals_are_the_jax_schedules(rate, dur, seed):
    for kind, kw in (("poisson_arrivals", {}),
                     ("bursty_arrivals", {"period_s": 0.5, "duty": 0.25}),
                     ("bursty_arrivals", {"period_s": 0.1, "duty": 0.6})):
        ours = getattr(loadgen, kind)(rate, dur, np.random.default_rng(seed),
                                      **kw)
        ref = getattr(jloadgen, kind)(rate, dur, np.random.default_rng(seed),
                                      **kw)
        assert np.array_equal(ours, ref)
        assert ours[0] >= 0 and ours[-1] < dur
        assert np.all(np.diff(ours) >= 0)
    times = loadgen.poisson_arrivals(1000.0, 2.0, np.random.default_rng(0))
    assert 1800 <= len(times) <= 2200
    with pytest.raises(ValueError):
        loadgen.bursty_arrivals(10.0, 1.0, np.random.default_rng(0),
                                duty=0.0)


def test_ledger_classifies_as_the_jax_ledger():
    outcomes = [None, None, policy.StalenessError("s"),
                policy.OverloadedError("o"), RuntimeError("f"), None]
    ref_outcomes = [None, None, jpolicy.StalenessError("s"),
                    jpolicy.OverloadedError("o"), RuntimeError("f"), None]
    ours, ref = loadgen._Ledger(), jloadgen._Ledger()
    t0 = time.monotonic()
    for a, b in zip(outcomes, ref_outcomes):
        ours.settle(a, t0)
        ref.settle(b, t0)
    for ledger in (ours, ref):
        ledger.latency._samples.clear()
        for s in (0.001, 0.002, 0.004):
            ledger.latency.record(s)
    a, b = ours.result(6, 2.0), ref.result(6, 2.0)
    assert a.as_dict() == b.as_dict()
    assert (a.ok, a.stale, a.shed, a.errors) == (3, 1, 1, 1)
    assert a.shed_rate == b.shed_rate and not a.meets(10.0)
    assert loadgen.LoadResult(1, 1, 0, 0, 0, 1.0, 1.0, 1.0, 2.0).meets(2.0)


def test_find_knee_is_the_jax_search():
    def synthetic(cls):
        def run_at(rate):
            ok = int(rate)
            return cls(requests=ok, ok=ok, stale=0, shed=0, errors=0,
                       duration_s=1.0, achieved_qps=min(rate, 1000.0),
                       p50_ms=1.0, p99_ms=2.0 if rate <= 1000.0 else 80.0,
                       offered_qps=rate)
        return run_at

    ours = loadgen.find_knee(synthetic(loadgen.LoadResult), 10.0,
                             lo_qps=100.0, bisect_steps=5)
    ref = jloadgen.find_knee(synthetic(jloadgen.LoadResult), 10.0,
                             lo_qps=100.0, bisect_steps=5)
    assert ours == ref and 800.0 <= ours["knee_qps"] <= 1000.0

    def always_bad(rate):
        return loadgen.LoadResult(requests=1, ok=0, stale=0, shed=1,
                                  errors=0, duration_s=1.0,
                                  achieved_qps=0.0, p50_ms=None,
                                  p99_ms=None, offered_qps=rate)

    out = loadgen.find_knee(always_bad, deadline_ms=10.0, lo_qps=50.0)
    assert out["knee_qps"] == 0.0 and len(out["probes"]) == 1


def test_round_robin_target_spreads_threads():
    class Counting:
        def __init__(self):
            self.issues = 0

        def make_issue(self):
            self.issues += 1
            return lambda x: None

        def close(self):
            pass

    a, b = Counting(), Counting()
    rr = loadgen.RoundRobinTarget([a, b])
    for _ in range(4):
        rr.make_issue()
    assert (a.issues, b.issues) == (2, 2)
    with pytest.raises(ValueError):
        loadgen.RoundRobinTarget([])


# -- load loops against the port ----------------------------------------------


def test_closed_and_open_loops_against_an_engine():
    engine, cfg = make_engine()
    engine.warmup()
    try:
        res = loadgen.run_closed_loop(loadgen.EngineTarget(engine),
                                      cfg.num_features, concurrency=3,
                                      duration_s=0.3)
        assert res.ok == res.requests > 0
        assert res.shed == res.errors == res.stale == 0
        assert res.p99_ms >= res.p50_ms and res.offered_qps is None
        opened = loadgen.run_open_loop(loadgen.EngineTarget(engine),
                                       cfg.num_features, rate_qps=300.0,
                                       duration_s=0.3, concurrency=4)
        assert opened.offered_qps == 300.0 and opened.ok == opened.requests
        stale = loadgen.run_open_loop(
            loadgen.EngineTarget(engine, bound=policy.fresh(10**9)),
            cfg.num_features, rate_qps=200.0, duration_s=0.2,
            concurrency=2, arrivals="bursty")
        assert stale.stale == stale.requests > 0 and stale.ok == 0
        with pytest.raises(ValueError):
            loadgen.run_open_loop(loadgen.EngineTarget(engine), 4,
                                  rate_qps=10.0, arrivals="uniform")
        # a stop event ends a closed loop long before its duration
        stop = threading.Event()
        threading.Timer(0.2, stop.set).start()
        t0 = time.monotonic()
        res = loadgen.run_closed_loop(loadgen.EngineTarget(engine),
                                      cfg.num_features, concurrency=2,
                                      duration_s=60.0, stop=stop)
        assert time.monotonic() - t0 < 30.0 and res.ok > 0
    finally:
        engine.close()


def test_socket_target_and_typed_sheds_over_the_wire():
    engine, cfg = make_engine(queue_limit=1, max_batch=2, deadline_s=0.0)
    engine.warmup()
    bridge = net.ServerBridge(device="cpu", engine=engine)
    target = loadgen.SocketTarget("127.0.0.1", bridge.port)
    try:
        res = loadgen.run_closed_loop(target, cfg.num_features,
                                      concurrency=2, duration_s=0.3)
        assert res.ok > 0 and res.errors == 0
        assert res.ok + res.shed == res.requests
        issue = target.make_issue()
        with engine._admission:
            engine._tenants[0].depth = 1      # the queue is full
        with pytest.raises(OverloadedError):
            issue(np.zeros(cfg.num_features, np.float32))
        with engine._admission:
            engine._tenants[0].depth = 0
        assert issue(np.zeros(cfg.num_features, np.float32)).vector_clock == 7
    finally:
        target.close()
        bridge.close()
        engine.close()


# -- the staleness policy at the ring's edges ---------------------------------


def test_min_clock_just_above_oldest_retained_serves_latest():
    reg = SnapshotRegistry(capacity=3)
    for clock in range(6):
        reg.publish(torch.full((2,), float(clock)), vector_clock=clock)
    assert reg.snapshots()[0].vector_clock == 3
    assert reg.get(min_clock=4).vector_clock == 5
    assert reg.get(min_clock=5).vector_clock == 5
    with pytest.raises(StalenessError):
        reg.get(min_clock=6)


def test_at_clock_exactly_at_frontier_cut():
    reg = SnapshotRegistry(capacity=4)
    pub = FrontierCutPublisher(reg)
    assert pub.maybe_publish([(torch.full((2,), 1.0), 10),
                              (torch.full((2,), 2.0), 12)]) is not None
    assert pub.maybe_publish([(lambda: torch.full((2,), 3.0), 14),
                              (torch.full((2,), 4.0), 12)]) is not None
    assert pub.maybe_publish([(torch.full((2,), 5.0), 14),
                              (torch.full((2,), 6.0), 12)]) is None
    assert torch.equal(reg.get(at_clock=10).theta,
                       torch.tensor([1.0, 1.0, 2.0, 2.0]))
    assert torch.equal(reg.get(at_clock=12).theta,
                       torch.tensor([3.0, 3.0, 4.0, 4.0]))
    with pytest.raises(StalenessError):
        reg.get(at_clock=11)


def test_lapped_ring_raises_staleness_not_stale_hit():
    reg = SnapshotRegistry(capacity=2)
    for clock in (1, 2, 3, 4):
        reg.publish(torch.full((2,), float(clock)), vector_clock=clock)
    with pytest.raises(StalenessError) as ei:
        reg.get(at_clock=1)
    assert ei.value.have_clock == 4
    assert reg.get(at_clock=3).vector_clock == 3
    assert reg.get(at_clock=4).vector_clock == 4
