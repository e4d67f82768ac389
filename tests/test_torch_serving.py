"""The port's serving plane (kafka_ps_tpu_torch/serving/) on the CPU,
against the JAX package's (kafka_ps_tpu/serving/) where both compute.

  * the registry: lock-free hot swap is atomic under threads, the ring
    keeps the newest N, bounds serve the newest or raise;
  * the cost model: the same sample sequence gives the JAX model's
    decisions exactly (plain float arithmetic in both);
  * the engine: labels and confidences against the JAX engine on the
    same snapshots at F=1024, C=5 (logreg, and the MLP at H=128), at
    every bucket size: confidences within rtol 1e-5, atol 1e-6, labels
    equal wherever the top-two logit margin exceeds 1e-5, clocks exact;
    one first-seen shape per bucket; warmup; admission, the predictive
    shed, tenants; the adaptive dispatch driven through the cost model's
    seed hook (no wall-clock thresholds);
  * the trainer: serving does not perturb a serial run (theta and rows
    bitwise with and without a live read load at -c 0, 3, -1); the
    threaded runtime serves while it trains, clocks never going back;
    the gang's prefix snapshots are bitwise the per-message sequence;
    a published snapshot's bytes never change under later applies, on
    every apply path.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from kafka_ps_tpu.models.task import get_task as jget_task
from kafka_ps_tpu.serving import costmodel as jcostmodel
from kafka_ps_tpu.serving.engine import PredictionEngine as JEngine
from kafka_ps_tpu.serving.engine import _Request as JRequest
from kafka_ps_tpu.serving.snapshot import SnapshotRegistry as JRegistry
from kafka_ps_tpu.utils.config import ModelConfig as JModelConfig
from kafka_ps_tpu_torch.models.task import get_task
from kafka_ps_tpu_torch.serving import (EVENTUAL_READ, MultiModelRegistry,
                                        OverloadedError, ReadBound, Snapshot,
                                        SnapshotRegistry, StalenessError,
                                        policy)
from kafka_ps_tpu_torch.serving import engine as engine_mod
from kafka_ps_tpu_torch.serving.costmodel import DispatchCostModel
from kafka_ps_tpu_torch.serving.engine import (PredictionEngine, _bucket,
                                               _Request)
from kafka_ps_tpu_torch.utils.config import EVENTUAL, ModelConfig
from torch_serving_runs import (CONF_ATOL, CONF_RTOL, MARGIN, bucket_outputs,
                                build_app, read_load_run, serve_config,
                                snapshot_sequence, strip_ts, top_two_margin)


# -- registry: hot swap, ring, bounds -----------------------------------------


def test_hot_swap_atomic_under_threads():
    """Readers racing a publisher only ever see whole snapshots: every
    theta uniform and equal to its clock, seq monotone per reader."""
    reg = SnapshotRegistry(capacity=4)
    reg.publish(torch.zeros(4), vector_clock=0)
    stop = threading.Event()
    errors = []

    def reader():
        last_seq = -1
        while not stop.is_set():
            s = reg.latest
            th = s.theta
            if not bool((th == th[0]).all()):
                errors.append(f"torn theta {th}")
                return
            if float(th[0]) != float(s.vector_clock):
                errors.append(f"theta/clock mismatch {th[0]} {s}")
                return
            if s.seq < last_seq:
                errors.append(f"seq went backwards {s.seq} < {last_seq}")
                return
            last_seq = s.seq

    readers = [threading.Thread(target=reader) for _ in range(4)]
    for t in readers:
        t.start()
    for clock in range(1, 500):
        reg.publish(torch.full((4,), float(clock)), vector_clock=clock)
    stop.set()
    for t in readers:
        t.join(timeout=30.0)
        assert not t.is_alive()
    assert not errors, errors
    assert reg.latest.vector_clock == 499


def test_ring_evicts_oldest_keeps_newest():
    reg = SnapshotRegistry(capacity=3)
    for clock in range(6):
        reg.publish(torch.full((2,), float(clock)), vector_clock=clock)
    assert len(reg) == 3
    assert [s.vector_clock for s in reg.snapshots()] == [3, 4, 5]
    assert reg.latest.vector_clock == 5
    assert reg.get(at_clock=4).vector_clock == 4
    with pytest.raises(StalenessError):
        reg.get(at_clock=1)


def test_staleness_bounds_with_injected_clock():
    now = {"t": 100.0}
    reg = SnapshotRegistry(capacity=4, now=lambda: now["t"])
    reg.publish(torch.zeros(2), vector_clock=5)        # wall_time = 100.0
    assert reg.get(EVENTUAL_READ).vector_clock == 5
    assert reg.get(min_clock=5).vector_clock == 5
    with pytest.raises(StalenessError) as ei:
        reg.get(min_clock=6)
    assert ei.value.min_clock == 6 and ei.value.have_clock == 5
    now["t"] = 103.0
    assert reg.get(max_age_s=5.0).vector_clock == 5
    with pytest.raises(StalenessError) as ei:
        reg.get(max_age_s=2.0)
    assert ei.value.max_age_s == 2.0 and ei.value.have_age_s == 3.0
    with pytest.raises(StalenessError):
        SnapshotRegistry().get()


def test_read_bound_validation_and_policy_helpers():
    with pytest.raises(ValueError):
        SnapshotRegistry().get(ReadBound(min_clock=1), min_clock=2)
    assert EVENTUAL_READ.unbounded
    assert not ReadBound(min_clock=1).unbounded
    assert isinstance(Snapshot(torch.zeros(1), 0, 0.0, 0), tuple)
    assert policy.fresh(3) == ReadBound(min_clock=3)
    assert policy.bounded(0.5) == ReadBound(max_age_s=0.5)
    multi = MultiModelRegistry()
    reg = multi.register(2)
    assert multi.register(2) is reg and multi.get(2) is reg
    with pytest.raises(ValueError):
        multi.register(2, SnapshotRegistry())
    multi.register(0, capacity=3)
    assert multi.model_ids() == (0, 2) and len(multi) == 2


# -- the cost model -----------------------------------------------------------


def test_cost_model_decisions_equal_the_reference_on_a_seeded_sequence():
    """The same seeded stream of arrivals, dispatches and seeds into both
    packages' models: every decision and summary equal, exactly."""
    rng = np.random.default_rng(21)
    ours, ref = DispatchCostModel(8), jcostmodel.DispatchCostModel(8)
    t = 50.0
    for step in range(400):
        kind = rng.integers(0, 4)
        if kind == 0:
            t += float(rng.exponential(0.0005))
            ours.observe_arrival(t)
            ref.observe_arrival(t)
        elif kind == 1:
            rows = int(rng.integers(1, 9))
            bucket = _bucket(rows, 8)
            dt = float(rng.uniform(1e-4, 5e-3))
            batched = bool(rng.integers(0, 2))
            avail = int(rng.integers(rows, 20))
            ours.observe_dispatch(rows, bucket, dt, batched, avail)
            ref.observe_dispatch(rows, bucket, dt, batched, avail)
        elif kind == 2 and step % 50 == 0:
            b = int(2 ** rng.integers(0, 4))
            dt = float(rng.uniform(1e-4, 5e-3))
            ours.seed(b, dt)
            ref.seed(b, dt)
        have = int(rng.integers(0, 9))
        assert ours.bypass() == ref.bypass()
        assert ours.window_s(have, 0.002) == ref.window_s(have, 0.002)
        assert ours.as_dict() == ref.as_dict()
    assert ours.calibrated


def test_cost_model_break_even_demand_and_window():
    cm = DispatchCostModel(8)
    assert not cm.calibrated and not cm.bypass()
    assert cm.window_s(1, 0.002) == 0.002
    cm.seed(1, 0.001)
    cm.seed(8, 0.004)
    assert cm.calibrated and cm.break_even == pytest.approx(4.0)
    assert cm.bypass() and cm.window_s(1, 0.002) == 0.0
    for _ in range(60):
        cm.observe_dispatch(8, 8, 0.004)
    assert cm.demand > cm.break_even + cm.BYPASS_SLACK and not cm.bypass()
    demand = cm.demand
    for _ in range(60):
        cm.observe_dispatch(1, 1, 0.001, batched=False)
    assert cm.demand == demand and cm.occupancy < demand
    cm2 = DispatchCostModel(8)
    t = 100.0
    for _ in range(30):
        cm2.observe_arrival(t)
        t += 0.0001
    cm2.seed(1, 0.001)
    cm2.seed(8, 0.004)
    for _ in range(60):
        cm2.observe_dispatch(8, 8, 0.004)
    assert cm2.window_s(1, 0.002) == pytest.approx(7 * 0.0001)
    assert cm2.window_s(1, 0.0003) == 0.0003
    assert cm2.arrival_qps == pytest.approx(10000.0, rel=0.01)


# -- the engine against the JAX engine ---------------------------------------


def _engines(task: str, hidden: int = 128, seed: int = 4):
    """The port's and the JAX package's engines over one snapshot of the
    same float32 theta at F=1024, C=5, clock 6."""
    import jax.numpy as jnp
    cfg = ModelConfig(num_features=1024, num_classes=5, hidden_dim=hidden)
    jcfg = JModelConfig(num_features=1024, num_classes=5, hidden_dim=hidden)
    ours_task, ref_task = get_task(task, cfg), jget_task(task, jcfg)
    rng = np.random.default_rng(seed)
    scale = 0.05 if task == "logreg" else (2.0 / 1024) ** 0.5
    theta = (rng.normal(size=ours_task.num_params) * scale).astype(np.float32)
    reg, jreg = SnapshotRegistry(), JRegistry()
    reg.publish(torch.from_numpy(theta), vector_clock=6)
    jreg.publish(jnp.asarray(theta), vector_clock=6)
    rows = rng.normal(size=(16, 1024)).astype(np.float32)
    return (PredictionEngine(ours_task, reg, max_batch=16),
            JEngine(ref_task, jreg, max_batch=16), theta, rows, ours_task)


@pytest.mark.parametrize("task", ["logreg", "mlp"])
def test_engine_matches_the_reference_engine_at_every_bucket(task):
    ours, ref, theta, rows, t = _engines(task)
    try:
        logits = t.predict_logits(torch.from_numpy(theta),
                                  torch.from_numpy(rows)).numpy()
        defined = top_two_margin(logits) > MARGIN
        tenant, jtenant = ours._tenants[0], ref._tenants[0]
        snap, jsnap = tenant.registry.latest, jtenant.registry.latest
        got = bucket_outputs(ours, rows, range(1, 17))
        for n, out in zip(range(1, 17), got):
            reqs = [JRequest(rows[i], None, lambda r: None,
                             time.monotonic(), 0) for i in range(n)]
            labels, confs = ref._dispatch(jtenant, jsnap, reqs)
            labels, confs = np.asarray(labels)[:n], np.asarray(confs)[:n]
            np.testing.assert_allclose(out[1], confs, rtol=CONF_RTOL,
                                       atol=CONF_ATOL)
            d = defined[:n]
            np.testing.assert_array_equal(out[0][d], labels[d])
        assert defined.sum() >= 15
        # the public path: one row at a time, clocks exact
        for i in range(4):
            p, jp = ours.predict(rows[i]), ref.predict(rows[i])
            assert p.vector_clock == jp.vector_clock == 6
            assert p.wall_time == snap.wall_time
            assert p.confidence == pytest.approx(jp.confidence,
                                                 rel=CONF_RTOL,
                                                 abs=CONF_ATOL)
            if defined[i]:
                assert p.label == jp.label
    finally:
        ours.close()
        ref.close()


def _light_engine(max_batch=16, **kw):
    cfg = ModelConfig(num_features=6, num_classes=2)
    task = get_task("logreg", cfg)
    theta = torch.from_numpy(np.random.default_rng(7).normal(
        size=task.num_params).astype(np.float32))
    registry = SnapshotRegistry()
    registry.publish(theta, vector_clock=3)
    return PredictionEngine(task, registry, max_batch=max_batch, **kw), cfg


def _serve_sizes(eng, cfg, sizes):
    row = np.zeros(cfg.num_features, np.float32)
    for n in sizes:
        reqs = [_Request(row, None, lambda r: None, time.monotonic(), 0)
                for _ in range(n)]
        with eng._admission:             # pre-admit, as submit would
            eng._tenants[0].depth += n
            eng._depth += n
        eng._serve(reqs)


def test_trace_counts_one_shape_per_bucket():
    eng, cfg = _light_engine(max_batch=16)
    try:
        rng = np.random.default_rng(11)
        sizes = [int(rng.integers(1, 17)) for _ in range(40)]
        before = engine_mod.TRACE_COUNTS["compiles"]
        _serve_sizes(eng, cfg, sizes)
        assert engine_mod.TRACE_COUNTS["compiles"] - before == len(
            {_bucket(n, 16) for n in sizes})
        before = engine_mod.TRACE_COUNTS["compiles"]
        _serve_sizes(eng, cfg, sizes)
        assert engine_mod.TRACE_COUNTS["compiles"] == before
        # the forward is built once per tenant, never per call
        fn = eng._tenants[0].predict
        _serve_sizes(eng, cfg, [3, 9])
        assert eng._tenants[0].predict is fn
    finally:
        eng.close()


def test_warmup_dispatches_every_bucket():
    eng, cfg = _light_engine(max_batch=16)
    try:
        assert eng.warmup() == 5                  # 1, 2, 4, 8, 16
        assert eng._tenants[0].cost.calibrated
        before = engine_mod.TRACE_COUNTS["compiles"]
        for _ in range(10):
            eng.predict(np.ones(cfg.num_features, np.float32))
        assert engine_mod.TRACE_COUNTS["compiles"] == before
    finally:
        eng.close()
    empty = PredictionEngine(get_task("logreg", cfg), SnapshotRegistry())
    try:
        assert empty.warmup() == 0                # nothing published
    finally:
        empty.close()


class _FixedCurve(DispatchCostModel):
    """The dispatch-time curve of the seeds only: live dispatches move
    occupancy and demand, never t(bucket), so the engine's decisions do
    not depend on this machine's timing."""

    def observe_dispatch(self, rows, bucket, dt_s, batched=True,
                         avail=None):
        super().observe_dispatch(rows, bucket, self._t[bucket], batched,
                                 avail)


def test_auto_dispatch_bypasses_then_rebatches():
    """A lone client settles on the bypass path; a standing backlog
    re-engages batching; the load dropping brings bypass back.  The
    curve is seeded (break-even 2, so the engage threshold is the
    half-capacity floor 4) and the backlog is made by holding the
    batcher, not by racing threads against wall time."""
    eng, cfg = _light_engine(max_batch=8)
    tenant = eng._tenants[0]
    tenant.cost = _FixedCurve(8)
    for b, dt in ((1, 0.001), (2, 0.0012), (4, 0.0015), (8, 0.002)):
        tenant.cost.seed(b, dt)
    x = np.ones(cfg.num_features, np.float32)
    try:
        for _ in range(30):
            eng.predict(x)
        s = eng.stats()
        assert s["mode"] == "bypass" and s["bypasses"] == 30, s
        # a standing backlog: both inline lanes taken, the batcher held
        # in its first dispatch while 59 more requests queue behind it
        hold, entered = threading.Event(), threading.Event()
        inner = eng._predict_fn(tenant)

        def held(theta, xs):
            entered.set()
            hold.wait(timeout=30.0)
            return inner(theta, xs)

        tenant.predict = held
        with eng._admission:
            eng._bypassing = 2
        done = threading.Semaphore(0)
        eng.submit(x, callback=lambda r: done.release())
        assert entered.wait(timeout=30.0)
        for _ in range(59):
            eng.submit(x, callback=lambda r: done.release())
        before = eng.stats()
        hold.set()
        for _ in range(60):
            assert done.acquire(timeout=30.0)
        tenant.predict = inner
        with eng._admission:
            eng._bypassing = 0
        s = eng.stats()
        queued_serves = s["batches"] - before["batches"]
        assert queued_serves < 59 and 60 / queued_serves > 1.2, s
        assert tenant.cost.demand >= tenant.cost.engage_threshold
        for _ in range(60):
            eng.predict(x)
        assert eng.stats()["mode"] == "bypass"
    finally:
        eng.close()


def test_auto_off_keeps_batching():
    eng, cfg = _light_engine(max_batch=16, auto=False)
    try:
        eng.warmup()
        for _ in range(20):
            eng.predict(np.ones(cfg.num_features, np.float32))
        s = eng.stats()
        assert s["bypasses"] == 0 and s["mode"] == "batch"
    finally:
        eng.close()


# -- admission control, the predictive shed, tenants --------------------------


def _stall(engine, hold: threading.Event, model_id: int = 0):
    """The tenant's forward blocks on `hold`, so admitted requests pile
    up behind it; auto off keeps every request on the queued path."""
    engine.warmup(model_id)
    engine.auto = False
    tenant = engine._tenants[model_id]
    inner = tenant.predict

    def stalled(theta, xs):
        hold.wait(timeout=30.0)
        return inner(theta, xs)

    tenant.predict = stalled


def test_queue_limit_sheds_typed_and_recovers():
    eng, cfg = _light_engine(queue_limit=2, max_batch=4, deadline_s=0.0)
    hold = threading.Event()
    _stall(eng, hold)
    x = np.zeros(cfg.num_features, np.float32)
    done = []
    try:
        sheds = 0
        for _ in range(12):
            try:
                eng.submit(x, callback=done.append)
            except OverloadedError as e:
                sheds += 1
                assert e.queue_limit == 2 and e.queue_depth >= 2
                assert e.model_id == 0
        assert sheds > 0 and eng.stats()["sheds"] == sheds
        hold.set()
        deadline = time.monotonic() + 10.0
        while len(done) < 12 - sheds and time.monotonic() < deadline:
            time.sleep(0.005)
        assert len(done) == 12 - sheds
        assert eng.predict(x).label in (0, 1, 2)
        assert eng.stats()["queue_depth"] == 0
    finally:
        hold.set()
        eng.close()


def test_predictive_shed_uses_ewma_service_time():
    eng, cfg = _light_engine(max_batch=2, shed_deadline_s=0.010)
    eng.warmup()
    x = np.zeros(cfg.num_features, np.float32)
    try:
        eng.predict(x)
        with eng._admission:
            eng._ewma_batch_s = 0.1
        with pytest.raises(OverloadedError, match="predicted queueing"):
            eng.predict(x)
        with eng._admission:
            eng._ewma_batch_s = 1e-5
        assert eng.predict(x).label in (0, 1, 2)
    finally:
        eng.close()


def test_per_tenant_admission_budget_isolates_models():
    eng, cfg = _light_engine(queue_limit=2, max_batch=4, deadline_s=0.0)
    task2 = get_task("logreg", cfg)
    reg2 = SnapshotRegistry()
    reg2.publish(torch.ones(task2.num_params), vector_clock=1)
    assert eng.add_model(5, task2, reg2) is reg2
    with pytest.raises(ValueError):
        eng.add_model(5, task2)
    assert eng.model_ids() == (0, 5) and eng.registry_for(5) is reg2
    hold = threading.Event()
    _stall(eng, hold)
    _stall(eng, hold, model_id=5)
    x = np.zeros(cfg.num_features, np.float32)
    try:
        with pytest.raises(OverloadedError):
            for _ in range(6):
                eng.submit(x, model_id=0)
        eng.submit(x, model_id=5)
        eng.submit(x, model_id=5)
        with pytest.raises(OverloadedError) as ei:
            eng.submit(x, model_id=5)
        assert ei.value.model_id == 5
        with pytest.raises(ValueError, match="unknown model"):
            eng.submit(x, model_id=9)
    finally:
        hold.set()
        eng.close()


# -- the engine on the trainer ------------------------------------------------


def test_engine_batches_and_is_correct_under_threads():
    app, x, _ = build_app(serve_config(0), "cpu")
    engine = app.enable_serving()
    try:
        app.run_serial(max_server_iterations=24)
        theta = app.server.theta
        expect = torch.argmax(app.server.task.predict_logits(
            theta, torch.from_numpy(x[:32])), dim=1).numpy()
        results = [None] * 32

        def drive(t):
            for j in range(t * 8, t * 8 + 8):
                results[j] = engine.predict(x[j])

        ths = [threading.Thread(target=drive, args=(t,)) for t in range(4)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60.0)
        for j, pred in enumerate(results):
            assert pred.label == int(expect[j]), (j, pred)
            assert 0.0 < pred.confidence <= 1.0
            assert pred.vector_clock == app.server.serving_clock()
        s = engine.stats()
        assert s["requests"] >= 32 and s["batches"] < s["requests"], s
        assert s["occupancy"] > 1.0, s
    finally:
        app.close_serving()
        app.close_logs()


def test_engine_staleness_rejection_paths():
    app, x, _ = build_app(serve_config(0), "cpu")
    engine = app.enable_serving()
    try:
        with pytest.raises(StalenessError):
            engine.predict(x[0])          # nothing published yet
        app.run_serial(max_server_iterations=12)
        engine.predict(x[0])
        with pytest.raises(StalenessError):
            engine.predict(x[0], min_clock=10**9)
        with pytest.raises(StalenessError):
            engine.predict(x[0], max_age_s=0.0)
        assert engine.stats()["rejections"] >= 3
    finally:
        app.close_serving()
        app.close_logs()


def test_engine_rejects_after_close():
    app, x, _ = build_app(serve_config(0), "cpu")
    engine = app.enable_serving()
    assert app.enable_serving() is engine
    app.run_serial(max_server_iterations=12)
    app.close_serving()
    app.close_logs()
    with pytest.raises(RuntimeError):
        engine.predict(x[0])


@pytest.mark.parametrize("consistency", [0, 3, EVENTUAL])
def test_serving_does_not_perturb_training(consistency):
    """With serving on and a live read load, the final theta and the
    rows are bitwise the run without serving."""
    cfg = serve_config(consistency)
    on = read_load_run(cfg, "cpu", serve=True)
    off = read_load_run(cfg, "cpu", serve=False)
    assert on["stats"]["requests"] > 0
    assert torch.equal(on["theta"], off["theta"])
    assert strip_ts(on["worker"]) == strip_ts(off["worker"])
    assert strip_ts(on["server"]) == strip_ts(off["server"])


def test_threaded_runtime_serves_while_training():
    run = read_load_run(serve_config(0), "cpu", serve=True, iters=40,
                        mode="threaded")
    clocks = run["clocks"]
    assert clocks and clocks[-1] > 0
    assert all(a <= b for a, b in zip(clocks, clocks[1:])), clocks


@pytest.mark.parametrize("consistency", [0, 3, EVENTUAL])
def test_snapshot_sequence_gang_bitwise(consistency):
    """A gang publishes each release's prefix theta at the clock its gate
    decision saw: the per-message path's sequence, bitwise."""
    gang = snapshot_sequence(serve_config(consistency, use_gang=True), "cpu")
    single = snapshot_sequence(serve_config(consistency, use_gang=False),
                               "cpu")
    assert len(gang) > 1
    assert gang == single


def test_snapshot_clock_is_min_active_clock():
    app, _, _ = build_app(serve_config(0), "cpu")
    reg = SnapshotRegistry(capacity=1024)
    app.server.serving = reg
    app.run_serial(max_server_iterations=24)
    app.close_logs()
    tracker = app.server.tracker
    assert reg.latest.vector_clock == min(
        tracker.tracker[w].vector_clock for w in tracker.active_workers)
    assert reg.latest.theta is app.server.theta     # an alias, not a copy
    assert app.server.snapshots_published == len(reg)
    assert app.server.last_published_clock == reg.latest.vector_clock


class _Recording(SnapshotRegistry):
    """Keeps a private copy of every published theta."""

    def __init__(self):
        super().__init__(capacity=100000)
        self.copies = []

    def publish(self, theta, vector_clock, wall_time=None, trace=None):
        self.copies.append(torch.as_tensor(theta).clone())
        return super().publish(theta, vector_clock, wall_time, trace)


@pytest.mark.parametrize("path", ["gang", "per-message", "threaded",
                                  "fused", "int8", "topk", "restore"])
def test_published_snapshots_are_unchanged_by_later_applies(path, tmp_path):
    """Every snapshot's bytes at the end of the run are its bytes at
    publication: no apply path writes a published theta in place."""
    kw = {"compress": {"int8": "int8", "topk": "topk:0.2"}.get(path, "none"),
          "use_gang": path not in ("per-message", "int8", "topk")}
    cfg = serve_config(0 if path != "threaded" else 2)
    import dataclasses
    cfg = dataclasses.replace(cfg, **kw)
    app, _, _ = build_app(cfg, "cpu")
    reg = _Recording()
    app.server.serving = reg
    ck = str(tmp_path / "ck.npz")
    if path == "restore":
        app.server.checkpoint_path = ck
        app.run_serial(20)
        app.server.save_checkpoint_now()
        app, _, _ = build_app(cfg, "cpu")
        app.server.serving = reg
        assert app.restore_checkpoint(ck)
    if path == "fused":
        app.run_fused_bsp(40)
    elif path == "threaded":
        app.run_threaded(40)
    else:
        app.run_serial(40)
    app.close_logs()
    assert len(reg) > 5
    for snap, copy in zip(reg.snapshots(), reg.copies):
        assert torch.equal(torch.as_tensor(snap.theta), copy), snap.seq
