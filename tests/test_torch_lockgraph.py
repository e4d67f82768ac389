"""The port's runtime lock-order recorder (kafka_ps_tpu_torch/analysis/
lockgraph.py) and the OrderedLocks at the port's lock sites: the recorder
itself, the threaded subsystems driven under an isolated recorder beside
the JAX package's, the pytest plugin in a subprocess, the flight dump's
lockEdges, and the races the port's checks found (ROADMAP C)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from kafka_ps_tpu.analysis import lockgraph as jlockgraph
from kafka_ps_tpu_torch.analysis import lockgraph

REPO = Path(__file__).resolve().parent.parent


def _run_threads(*fns, timeout=60):
    ts = [threading.Thread(target=fn) for fn in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
        assert not t.is_alive()


def _nested(outer, inner):
    def take():
        with outer:
            with inner:
                pass
    return take


# -- the recorder ----------------------------------------------------------

def test_ab_ba_acquisition_is_reported_as_cycle():
    with lockgraph.isolated() as g:
        a = lockgraph.OrderedLock("fixture.A")
        b = lockgraph.OrderedLock("fixture.B")
        _run_threads(_nested(a, b))      # sequential: no real deadlock,
        _run_threads(_nested(b, a))      # the ORDER inconsistency is it
        cycles = g.cycles()
    assert len(cycles) == 1
    assert {e.src for e in cycles[0]} == {"fixture.A", "fixture.B"}
    assert all("test_torch_lockgraph.py" in e.site for e in cycles[0])


def test_consistent_order_is_not_a_cycle():
    with lockgraph.isolated() as g:
        a = lockgraph.OrderedLock("fixture.A")
        b = lockgraph.OrderedLock("fixture.B")
        _run_threads(_nested(a, b), _nested(a, b))
        assert g.cycles() == []
        assert ("fixture.A", "fixture.B") in g.edges
        assert "2 locks, 1 ordered pairs" in g.summary()


def test_condition_wait_keeps_bookkeeping_balanced():
    with lockgraph.isolated() as g:
        cond = lockgraph.OrderedCondition("fixture.cond")
        other = lockgraph.OrderedLock("fixture.other")
        items = []

        def consumer():
            with cond:
                assert cond.wait_for(lambda: items, timeout=5)
                # wait() released and reacquired the lock; the held-stack
                # must still attribute this nesting to the condition
                with other:
                    pass

        def producer():
            with cond:
                items.append(1)
                cond.notify_all()

        t = threading.Thread(target=consumer)
        t.start()
        _run_threads(producer)
        t.join(timeout=10)
        assert not t.is_alive()
        assert ("fixture.cond", "fixture.other") in g.edges
        assert g.cycles() == []


def test_reentrant_lock_records_no_self_edge():
    with lockgraph.isolated() as g:
        r = lockgraph.OrderedLock("fixture.R", reentrant=True)
        with r:
            with r:
                pass
        assert g.edges == {} and g.cycles() == []
        assert g.acquisitions == 2


def test_disabled_recorder_is_passthrough():
    saved = lockgraph.current()
    lockgraph.disable()
    try:
        lock = lockgraph.OrderedLock("fixture.off")
        with lock:
            assert lock.locked()
        assert not lock.locked()
        assert lockgraph.current() is None
    finally:
        if saved is not None:
            lockgraph.enable()


def test_the_recorders_of_the_two_packages_are_apart():
    """The suite's conftest arms the JAX recorder; the port's locks
    report only to the port's."""
    with lockgraph.isolated() as g, jlockgraph.isolated() as jg:
        _nested(lockgraph.OrderedLock("port.A"),
                lockgraph.OrderedLock("port.B"))()
        _nested(jlockgraph.OrderedLock("jax.A"),
                jlockgraph.OrderedLock("jax.B"))()
        assert set(g.edges) == {("port.A", "port.B")}
        assert set(jg.edges) == {("jax.A", "jax.B")}


# -- the port's threaded subsystems under an isolated recorder -------------

def _drive_subsystems(pkg: str, tmp_path):
    """The JAX package's migrated-locks drive (tests/test_analysis.py),
    on `pkg`: fabric, buffer, snapshot registry, CSV sink and deferred
    sink from a producer and a consumer thread."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    lg, fabric_mod = mod("analysis.lockgraph"), mod("runtime.fabric")
    with lg.isolated() as g:
        fab = fabric_mod.Fabric()
        buf = mod("data.buffer").SlidingBuffer(
            4, mod("utils.config").BufferConfig(min_size=16, max_size=64))
        reg = mod("serving.snapshot").SnapshotRegistry()
        csv = mod("utils.csvlog").CsvLogSink(str(tmp_path / f"{pkg}.csv"),
                                             header="a;b")
        sink = mod("utils.asynclog").DeferredSink(csv)

        def producer():
            for i in range(50):
                fab.send(fabric_mod.WEIGHTS_TOPIC, 0, i)
                buf.add([float(i)] * 4, i % 2)
                reg.publish([float(i)], vector_clock=i)
                sink(f"{i};x")

        def consumer():
            for _ in range(50):
                fab.poll_blocking(fabric_mod.WEIGHTS_TOPIC, 0, timeout=2)
                buf.snapshot()
                _ = reg.latest

        _run_threads(producer, consumer)
        sink.close()
        csv.close()
    return g


def test_the_ported_subsystems_order_their_locks_as_the_jax_ones(tmp_path):
    ours = _drive_subsystems("kafka_ps_tpu_torch", tmp_path)
    ref = _drive_subsystems("kafka_ps_tpu", tmp_path)
    assert ours.cycles() == [] and ref.cycles() == []
    assert ours.acquisitions > 0
    assert set(ours.edges) == set(ref.edges) == {
        ("DeferredSink.turn", "CsvLogSink.write")}
    assert {"Fabric.cond", "SlidingBuffer.state", "SnapshotRegistry.publish",
            "DeferredSink.pending", "DeferredSink.turn",
            "CsvLogSink.write"} <= set(ours.names)


def _durable_app(tmp_path, iters=60, threaded=True, logs=None):
    from kafka_ps_tpu_torch.data.synth import generate
    from kafka_ps_tpu_torch.log import DurableFabric, LogConfig
    from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
    from kafka_ps_tpu_torch.utils.config import (BufferConfig, ModelConfig,
                                                 PSConfig)
    cfg = PSConfig(num_workers=4, consistency_model=2,
                   model=ModelConfig(num_features=64, num_classes=5),
                   buffer=BufferConfig(min_size=8, max_size=32))
    x, y = generate(200, 64, 5, seed=2, center_scale=0.3)
    logs = logs if logs is not None else ([], [])
    app = StreamingPSApp(
        cfg, test_x=x[150:], test_y=y[150:], server_log=logs[0].append,
        worker_log=logs[1].append,
        clock_ms=iter(range(0, 10 ** 9, 40)).__next__, device="cpu",
        fabric=DurableFabric(str(tmp_path / "wal"), LogConfig(fsync="none"),
                             device="cpu"))
    for i in range(150):
        app.data_sink(i % 4, x[i], int(y[i]))
    if threaded:
        app.run_threaded(iters, poll_timeout=0.02)
    else:
        app.run_serial(iters)
    assert app.gang is not None and app.eval_engine is not None
    app.close_logs()
    app.fabric.close()
    return app


def test_the_threaded_trainer_on_the_durable_log_orders_its_locks(tmp_path):
    """Gang dispatch, async eval and the durable log from four worker
    threads and the server (threaded -c 2): no cycle, and the log's
    locks nest as C.8's repair takes them."""
    with lockgraph.isolated() as g:
        app = _durable_app(tmp_path)
    assert app.server.iterations >= 60
    assert g.cycles() == []
    assert g.acquisitions > 0
    edges = set(g.edges)
    assert {("DurableFabric.commit", "CommitLog.lock"),
            ("DurableFabric.commit", "SlidingBuffer.state"),
            ("CommitLog.lock", "DurableFabric.cond")} <= edges
    assert {"GangDispatcher.offer", "EvalEngine.pending",
            "LogManager.partitions"} <= set(g.names)


def test_a_serial_run_is_bitwise_with_and_without_the_recorder(tmp_path):
    """The recorder observes: θ and every CSV row stay as they are."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    armed_logs, plain_logs = ([], []), ([], [])
    with lockgraph.isolated() as g:
        armed = _durable_app(tmp_path / "a", iters=30, threaded=False,
                             logs=armed_logs)
    assert g.acquisitions > 0 and g.cycles() == []
    saved = lockgraph.current()
    lockgraph.disable()
    try:
        plain = _durable_app(tmp_path / "b", iters=30, threaded=False,
                             logs=plain_logs)
    finally:
        if saved is not None:
            lockgraph.enable()
    assert torch.equal(armed.server.theta, plain.server.theta)

    def keyed(rows):         # without the wall-clock timestamp column
        return [r.split(";", 1)[1] for r in rows]

    for ours, ref in zip(armed_logs, plain_logs):
        assert keyed(ours) == keyed(ref) and len(ours) > 0


# -- the plugin, in a subprocess -------------------------------------------

@pytest.mark.parametrize("case,rc,line", [
    ("consistent", 0, "no ordering cycles"),
    ("inverted", 7, "cycle: helper.A -> helper.B -> helper.A"),
])
def test_the_plugin_fails_a_session_on_a_cycle(case, rc, line):
    env = dict(os.environ, PYTHONPATH=str(REPO),
               PYTEST_DISABLE_PLUGIN_AUTOLOAD="1")
    env.pop("LOCKGRAPH", None)
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-p",
         "kafka_ps_tpu_torch.analysis.pytest_plugin", "--noconftest",
         "-p", "no:cacheprovider", "-q",
         "tests/torch_lockgraph_runs.py", "-k", case],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == rc, proc.stdout + proc.stderr
    assert line in proc.stdout
    assert "1 passed" in proc.stdout


def test_lockgraph_0_disarms_the_plugin():
    env = dict(os.environ, PYTHONPATH=str(REPO), LOCKGRAPH="0",
               PYTEST_DISABLE_PLUGIN_AUTOLOAD="1")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-p",
         "kafka_ps_tpu_torch.analysis.pytest_plugin", "--noconftest",
         "-p", "no:cacheprovider", "-q",
         "tests/torch_lockgraph_runs.py", "-k", "inverted"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "lockgraph" not in proc.stdout


# -- the flight dump's lockEdges -------------------------------------------

def test_an_armed_flight_dump_carries_the_recorders_edges(tmp_path):
    from kafka_ps_tpu.telemetry import postmortem as jpostmortem
    from kafka_ps_tpu_torch.telemetry.flight import FlightRecorder
    from kafka_ps_tpu_torch.telemetry.registry import Telemetry

    fr = FlightRecorder()
    fr.enable(role="run", shard=0, flight_dir=str(tmp_path),
              telemetry=Telemetry())
    try:
        assert fr.snapshot("unarmed")["lockEdges"] == []
        with lockgraph.isolated() as g:
            _run_threads(_nested(lockgraph.OrderedLock("dump.A"),
                                 lockgraph.OrderedLock("dump.B")))
            fr.record("gate.release", worker=0, clock=1)
            # a dump takes its own locks: the first one records them
            fr.dump(reason="warm")
            edges = g.export_edges()
            path = fr.dump(reason="unit")
            assert g.export_edges() == edges
    finally:
        fr.disable()
    d = json.loads(Path(path).read_text())
    assert d["lockEdges"] == edges
    assert {("dump.A", "dump.B"), ("flight.dump", "flight.rings")} <= {
        (e["src"], e["dst"]) for e in edges}
    dumps = jpostmortem.load_dumps(str(tmp_path))
    assert [x["lockEdges"] for x in dumps] == [edges]
    report = jpostmortem.analyze(dumps)
    assert "unit" in jpostmortem.format_report(report)


# -- lockset races the port's checks found (ROADMAP C) ---------------------

def _hammer(fn, threads=8, each=3000):
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _run_threads(*[lambda: [fn() for _ in range(each)]] * threads)
    finally:
        sys.setswitchinterval(saved)
    return threads * each


def test_failed_callbacks_are_counted_exactly_from_every_thread():
    """PredictionEngine._finish: the batcher and the bypass callers
    finish rows at once; a failed callback's count is a read-modify-write
    from several threads, taken under the admission lock (PS201 flagged
    it unlocked)."""
    from kafka_ps_tpu_torch.models.task import get_task
    from kafka_ps_tpu_torch.serving.engine import PredictionEngine, _Request
    from kafka_ps_tpu_torch.serving.snapshot import SnapshotRegistry
    from kafka_ps_tpu_torch.utils.config import ModelConfig

    engine = PredictionEngine(
        get_task("logreg", ModelConfig(num_features=4, num_classes=2)),
        SnapshotRegistry())

    def raising(_result):
        raise RuntimeError("callback failed")

    req = _Request(np.zeros(4, np.float32), None, raising, 0.0, 0)
    try:
        n = _hammer(lambda: engine._finish(req, None))
        assert engine.callback_errors == n
    finally:
        engine.close()


class _DeviceTensorStandIn:
    """What TieredParamStore._host reads of a tensor on the card."""

    nbytes = 64

    def __init__(self):
        self._host = torch.zeros(16)
        self.device = type("Device", (), {"type": "cuda"})()

    def detach(self):
        return self

    def to(self, *_args):
        return self._host


def test_host_fetch_bytes_count_exactly_from_every_thread():
    """TieredParamStore._host: the policy thread's demotions and the
    apply path both fetch pages off the card; the byte count is a
    read-modify-write from two threads, taken under the residency lock
    (PS201 flagged it unlocked)."""
    from kafka_ps_tpu_torch.runtime.messages import KeyRange
    from kafka_ps_tpu_torch.store.tiered import TieredParamStore

    store = TieredParamStore(np.zeros(64, np.float32), KeyRange(0, 64),
                             page_params=16, device="cpu")
    try:
        before = store.host_fetch_bytes
        page = _DeviceTensorStandIn()
        n = _hammer(lambda: store._host(page))
        assert store.host_fetch_bytes - before == n * page.nbytes
    finally:
        store.close()
