"""The port's flight recorder, watchdogs and health plane
(kafka_ps_tpu_torch/telemetry/{flight,health}.py), held to the JAX
package's semantics (tests/test_flight.py): ring wrap and merge, the
dump's schema and keys, watchdog trips, the HTTP endpoints, dump on
SIGTERM; the JAX postmortem reads the port's dumps."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from kafka_ps_tpu.telemetry import FlightRecorder as JFlightRecorder
from kafka_ps_tpu.telemetry import Telemetry as JTelemetry
from kafka_ps_tpu.telemetry import postmortem
from kafka_ps_tpu.telemetry.health import OpsPlane as JOpsPlane
from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
from kafka_ps_tpu_torch.telemetry import FLIGHT, FlightRecorder, Telemetry
from kafka_ps_tpu_torch.telemetry.flight import DUMP_SCHEMA
from kafka_ps_tpu_torch.telemetry.health import (Liveness, OpsPlane,
                                                 WatchdogPanel)
from kafka_ps_tpu_torch.utils.config import (BufferConfig, ModelConfig,
                                             PSConfig, StreamConfig)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _global_flight_reset():
    """Tests that drive real instrumentation arm the process-global
    FLIGHT; never leak an armed recorder into the next test."""
    yield
    FLIGHT.disable()


# -- the ring ---------------------------------------------------------------

def test_ring_wraps_and_keeps_last():
    fr = FlightRecorder(capacity=8)
    fr.enable(role="test")
    for i in range(20):
        fr.record("tick", i=i)
    events = fr.tail(100)
    assert [e["i"] for e in events] == list(range(12, 20))   # the last 8
    assert fr.total_events() == 20
    assert all(e["kind"] == "tick" for e in events)
    assert events[0]["t"] <= events[-1]["t"]


def test_disarmed_recorder_is_a_noop():
    fr = FlightRecorder()
    fr.record("x", a=1)
    fr.beat("gate")
    fr.enter("log.fsync")
    assert fr.tail() == [] and fr.total_events() == 0
    assert fr.last_beat("gate") is None
    assert fr.inflight_age("log.fsync") is None


def test_tail_merges_threads_in_time_order():
    fr = FlightRecorder()
    fr.enable(role="test")
    start = threading.Barrier(3)

    def work(name):
        start.wait()
        for i in range(50):
            fr.record("tick", src=name, i=i)

    threads = [threading.Thread(target=work, args=(n,), name=n)
               for n in ("a", "b")]
    for t in threads:
        t.start()
    start.wait()
    fr.record("main")
    for t in threads:
        t.join()
    events = fr.tail(1000)
    assert len(events) == 101
    assert [e["t"] for e in events] == sorted(e["t"] for e in events)
    assert {e["thread"] for e in events} == {"a", "b",
                                             threading.current_thread().name}
    assert [e["i"] for e in events if e.get("src") == "a"] == list(range(50))
    assert len(fr.tail(10)) == 10


def _fill(fr, tel):
    fr.record("gate.arrive", shard=0, worker=1, clock=4, lag=0, waiting=1,
              clocks=[4, 4])
    fr.beat("gate")
    fr.enter("log.fsync")
    tel.counter("gradients_applied_total", worker="1").inc(3)


def test_dump_schema_and_keys_equal_the_jax_dump(tmp_path):
    ours, ref = FlightRecorder(), JFlightRecorder()
    tels = (Telemetry(), JTelemetry())
    for fr, tel in zip((ours, ref), tels):
        fr.enable(role="run", shard=0, flight_dir=str(tmp_path),
                  telemetry=tel, meta={"k": 1})
        _fill(fr, tel)
    path = ours.dump(reason="unit")
    assert Path(path).name == f"flightdump-{os.getpid()}.json"
    d = json.loads(Path(path).read_text())
    r = ref.snapshot("unit")
    assert d["schema"] == DUMP_SCHEMA == r["schema"] == "kps-flightdump-v1"
    assert set(d) == set(r)
    assert d["lockEdges"] == [] and d["profile"] == []
    assert (d["role"], d["shard"], d["meta"], d["reason"]) == \
        (r["role"], r["shard"], r["meta"], r["reason"])
    assert d["metrics"] == r["metrics"]
    assert [{k: v for k, v in e.items() if k not in ("t", "thread")}
            for e in d["events"]] == \
        [{k: v for k, v in e.items() if k not in ("t", "thread")}
         for e in r["events"]]
    assert set(d["beats"]) == set(r["beats"]) == {"gate"}
    assert set(d["inflight"]) == {"log.fsync"}
    assert threading.current_thread().name in d["threads"]
    ref.disable()


def test_jax_postmortem_reads_port_dumps(tmp_path):
    """A clean port dump and one with a tripped gate watchdog: the JAX
    analyzer loads both, names no dead shard and surfaces the trip."""
    fr = FlightRecorder()
    fr.enable(role="run", flight_dir=str(tmp_path), meta={"shards": [0]})
    panel = WatchdogPanel(flight=fr)
    fr.panel = panel
    demand = {"v": True}
    panel.add(Liveness("gate", 0.02, beat_name="gate",
                       demand=lambda: demand["v"], flight=fr))
    fr.record("gate.arrive", shard=0, worker=0, clock=9, lag=5,
              waiting=1, clocks=[9, 4])
    panel.check_now()
    time.sleep(0.06)
    assert panel.check_now() is False        # tripped: the panel dumps
    fr.dump(path=str(tmp_path / "flightdump-1.json"), reason="shutdown")
    dumps, unreadable = postmortem.load_dumps_with_errors(str(tmp_path))
    assert len(dumps) == 2 and unreadable == []
    report = postmortem.analyze(dumps)
    assert report["deadShards"] == []
    assert {t["watchdog"] for t in report["watchdogTrips"]} == {"gate"}
    assert "watchdog trip" in postmortem.format_report(report)
    assert postmortem.main(str(tmp_path)) in (0, 1)


# -- watchdogs --------------------------------------------------------------

def _bsp_app():
    cfg = PSConfig(num_workers=4, consistency_model=0,
                   model=ModelConfig(num_features=8, num_classes=3),
                   buffer=BufferConfig(min_size=4, max_size=8),
                   stream=StreamConfig(time_per_event_ms=0))
    app = StreamingPSApp(cfg, device="cpu")
    for w in range(4):
        for i in range(4):
            app.data_sink(w, {0: float(i), 1: 1.0}, i % 3)
    return app


def test_sleepy_bsp_round_does_not_trip_gate_watchdog():
    """Three gradients arrive (each beating "gate") and three workers
    park: demand outlives the threshold, but the beats keep the dog
    quiet; the straggler releases the round."""
    app = _bsp_app()
    FLIGHT.enable(role="test")
    panel = WatchdogPanel(flight=FLIGHT)
    threshold = 0.5
    panel.add(Liveness("gate", threshold, beat_name="gate",
                       demand=lambda: app.server.gate_waiting() > 0,
                       flight=FLIGHT))
    app.server.start_training_loop()
    for w in range(4):
        app.workers[w].on_weights(
            app.fabric.poll(fabric_mod.WEIGHTS_TOPIC, w))
    t0 = time.monotonic()
    for _ in range(3):                      # one worker is asleep
        app.server.process(app.fabric.poll(fabric_mod.GRADIENTS_TOPIC, 0))
        assert app.server.gate_waiting() > 0
        assert panel.check_now() is True
        time.sleep(0.25)
    assert time.monotonic() - t0 > threshold
    assert panel.check_now() is True
    app.server.process(app.fabric.poll(fabric_mod.GRADIENTS_TOPIC, 0))
    assert app.server.gate_waiting() == 0
    assert panel.check_now() is True
    assert all(d.trip_count == 0 for d in panel.watchdogs)
    kinds = [e["kind"] for e in FLIGHT.tail(100)]
    assert kinds.count("gate.arrive") == 4
    assert kinds.count("gate.release") >= 4


def test_true_gate_stall_trips_dumps_once_and_recovers(tmp_path):
    app = _bsp_app()
    FLIGHT.enable(role="run", flight_dir=str(tmp_path))
    panel = WatchdogPanel(flight=FLIGHT)
    FLIGHT.panel = panel
    panel.add(Liveness("gate", 0.05, beat_name="gate",
                       demand=lambda: app.server.gate_waiting() > 0,
                       flight=FLIGHT))
    app.server.start_training_loop()
    for w in range(4):
        app.workers[w].on_weights(
            app.fabric.poll(fabric_mod.WEIGHTS_TOPIC, w))
    for _ in range(3):
        app.server.process(app.fabric.poll(fabric_mod.GRADIENTS_TOPIC, 0))
    assert panel.check_now() is True
    time.sleep(0.15)                        # the straggler never shows
    assert panel.check_now() is False
    assert panel.check_now() is False       # still tripped, no new edge
    dumps = list(tmp_path.glob("flightdump-*.json"))
    assert len(dumps) == 1
    d = json.loads(dumps[0].read_text())
    assert d["reason"] == "watchdog:gate"
    assert d["watchdogs"]["gate"]["tripped"] is True
    trips = [e for e in FLIGHT.tail(200) if e["kind"] == "watchdog.trip"]
    assert len(trips) == 1 and trips[0]["name"] == "gate"
    app.server.process(app.fabric.poll(fabric_mod.GRADIENTS_TOPIC, 0))
    assert panel.check_now() is True        # readiness comes back


def test_fsync_watchdog_trips_on_a_held_fsync(tmp_path, monkeypatch):
    """An fsync that does not return: the commit log's FLIGHT.enter
    marks it in flight, the fsync watchdog trips while it is held and
    recovers once it returns."""
    from kafka_ps_tpu_torch.log.log import CommitLog, LogConfig
    from kafka_ps_tpu_torch.log.segment import LogSegment

    FLIGHT.enable(role="run")
    ops = OpsPlane(flight_dir=None, health_port=None)
    assert ops.panel is None                # inert: no dir, no port
    panel = WatchdogPanel(flight=FLIGHT)
    panel.add(Liveness("log.fsync", 0.05, beat_name="log.fsync",
                       demand=lambda: FLIGHT.inflight_age("log.fsync")
                       is not None, flight=FLIGHT))
    log = CommitLog(str(tmp_path / "p"), LogConfig(fsync="always"))
    held, entered = threading.Event(), threading.Event()
    flush = LogSegment.flush

    def slow_flush(self, sync=False):
        if sync:
            entered.set()
            held.wait(10)
        return flush(self, sync=sync)

    monkeypatch.setattr(LogSegment, "flush", slow_flush)
    t = threading.Thread(target=log.append, args=(b"record",))
    t.start()
    try:
        assert entered.wait(10)
        assert panel.check_now() is True    # stamps the demand window
        time.sleep(0.12)
        assert panel.check_now() is False
        assert panel.states()["log.fsync"]["trip_count"] == 1
    finally:
        held.set()
        t.join(10)
    assert panel.check_now() is True
    kinds = [e["kind"] for e in FLIGHT.tail(10)]
    assert "log.fsync" in kinds and "log.append" in kinds
    log.close()


# -- the health plane -------------------------------------------------------

def _get(port, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=5) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:     # 503/404 are valid answers
        return e.code, e.headers.get("Content-Type"), e.read()


class _Engine:
    def stats(self):
        return {"pending": 0, "submitted_clock": 4, "evaluated_clock": 4,
                "lag_clocks": 0, "dispatches": 2, "evals": 5,
                "max_width": 32, "widths": {"1": 1, "4": 1}}


def _plane(ops_cls, flight, tel, tmp):
    ops = ops_cls(flight_dir=str(tmp), health_port=0, telemetry=tel,
                  role="server", shard=1, flight=flight)
    demanded = {"v": False}
    ops.add_watchdog("gate", 0.05, demand=lambda: demanded["v"])
    ops.add_eval_engine(_Engine())
    ops.start()
    flight.record("gate.arrive", shard=1, worker=0, clock=2, lag=0,
                  waiting=0, clocks=[2, 2])
    return ops, demanded


def test_endpoints_answer_as_the_jax_plane(tmp_path):
    planes = []
    for ops_cls, fr, tel, sub in (
            (OpsPlane, FlightRecorder(), Telemetry(), "port"),
            (JOpsPlane, JFlightRecorder(), JTelemetry(), "jax")):
        (tmp_path / sub).mkdir()
        tel.counter("frames_sent", topic="gradients").inc(3)
        planes.append((_plane(ops_cls, fr, tel, tmp_path / sub), fr))
    try:
        answers = []
        for (ops, demanded), fr in planes:
            port = ops.health.port
            got = {p: _get(port, p) for p in (
                "/healthz", "/varz", "/flightz?n=5", "/evalz",
                "/profilez", "/modelz", "/nope")}
            demanded["v"] = True            # trip: readiness flips
            ops.panel.check_now()
            time.sleep(0.1)
            ops.panel.check_now()
            got["tripped"] = _get(port, "/healthz")
            answers.append(got)
        ours, ref = answers
        for path in ours:
            assert ours[path][:2] == ref[path][:2], path
        assert ours["/healthz"][0] == 200 and ours["tripped"][0] == 503
        assert ours["/profilez"][0] == ours["/modelz"][0] == 404
        assert ours["/profilez"][2] == ref["/profilez"][2]
        assert ours["/modelz"][2] == ref["/modelz"][2]
        assert ours["/varz"][2] == ref["/varz"][2]
        assert b'frames_sent{topic="gradients"} 3' in ours["/varz"][2]
        for path in ("/healthz", "tripped", "/evalz"):
            a, b = json.loads(ours[path][2]), json.loads(ref[path][2])
            assert a.keys() == b.keys(), path
        hz = json.loads(ours["tripped"][2])
        assert hz["healthy"] is False and (hz["role"], hz["shard"]) == \
            ("server", 1)
        assert json.loads(ours["/evalz"][2]) == json.loads(ref["/evalz"][2])
        fz = json.loads(ours["/flightz?n=5"][2])
        assert fz["enabled"] and fz["events"][-1]["kind"] == "gate.arrive"
    finally:
        for (ops, _), _fr in planes:
            ops.close()
    dumps = list((tmp_path / "port").glob("flightdump-*.json"))
    reasons = {json.loads(p.read_text())["reason"] for p in dumps}
    assert "shutdown" in reasons
    assert planes[0][1].enabled is False


def test_evalz_is_404_without_an_engine_and_an_inert_plane_is_safe():
    fr = FlightRecorder()
    ops = OpsPlane(health_port=0, flight=fr)
    ops.start()
    try:
        assert _get(ops.health.port, "/evalz")[0] == 404
        assert _get(ops.health.port, "/healthz")[0] == 200
    finally:
        ops.close()
    inert = OpsPlane(flight_dir=None, health_port=None, role="worker")
    assert inert.enabled is False
    inert.add_gate_watchdog(object())       # must not touch the dummy
    inert.add_fsync_watchdog()
    inert.add_eval_engine(object())
    inert.start()
    assert inert.health is None
    inert.close()


# -- dump-on-death ----------------------------------------------------------

def test_sigterm_death_hook_writes_dump(tmp_path):
    """The trainer's OpsPlane with --flight-dir: SIGTERM dumps, then the
    process dies by the signal, as a supervisor expects."""
    script = (
        "import sys, time\n"
        "from kafka_ps_tpu_torch.telemetry.flight import FLIGHT\n"
        "from kafka_ps_tpu_torch.telemetry.health import OpsPlane\n"
        "ops = OpsPlane(flight_dir=sys.argv[1], role='run')\n"
        "ops.start()\n"
        "FLIGHT.record('gate.arrive', shard=0, worker=0, clock=1, lag=0,"
        " waiting=0, clocks=[1])\n"
        "print('ready', flush=True)\n"
        "time.sleep(30)\n"
    )
    proc = subprocess.Popen(
        [sys.executable, "-c", script, str(tmp_path)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        assert proc.stdout.readline().strip() == "ready"
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=20)
    finally:
        proc.kill()
    assert proc.returncode == -signal.SIGTERM
    dumps = list(tmp_path.glob(f"flightdump-{proc.pid}.json"))
    assert len(dumps) == 1
    d = json.loads(dumps[0].read_text())
    assert d["reason"] == "signal:SIGTERM" and d["role"] == "run"
    assert any(e["kind"] == "gate.arrive" for e in d["events"])
    report = postmortem.analyze(postmortem.load_dumps(str(tmp_path)))
    assert report["deadShards"] == []
