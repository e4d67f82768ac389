"""The port's analysis planes against the JAX package's, unit by unit on
the same seeded inputs (kafka_ps_tpu_torch/telemetry/{drift,modelhealth,
slo,profiler,critpath,merge,postmortem,__main__}.py; the JAX package has
no unit tests of its model-health and drift planes, so these drive both
packages directly):

  * drift: the detectors' levels and statistics, the Welford sketch and
    the stability score, and DriftMonitor's states, summary, detail, CSV
    rest strings, flight records and families, bitwise;
  * model health: ModelHealth fed the same numpy deltas gives the same
    summary, detail and family text; the deferred path (CPU tensors and
    scalar tensors, resolved by the sampler) gives bitwise what the
    inline numpy path gives, and what the JAX deferred path gives;
  * SLO: count_le, the burn math under an explicit clock, the standard
    objectives over registry families, plane_from_args;
  * profiler: _fold, the bounded table's (other) bucket, the collapsed
    format and /profilez, /modelz on the health plane;
  * critpath: decompose, aggregate, analyze_trace and the report on the
    JAX package's synthetic trace and on real traced bridge rounds (the
    port's, and a port server with a JAX worker), RollingCritpath's
    window diffs;
  * the tools: merge_traces and postmortem on mixed JAX and port inputs,
    and `python -m kafka_ps_tpu_torch.telemetry`'s output and exit codes.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from argparse import Namespace
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kafka_ps_tpu.runtime import fabric as jfabric
from kafka_ps_tpu.runtime import messages as jmsg
from kafka_ps_tpu.runtime import net as jnet
from kafka_ps_tpu.telemetry import FlightRecorder as JFlightRecorder
from kafka_ps_tpu.telemetry import Telemetry as JTelemetry
from kafka_ps_tpu.telemetry import __main__ as jmain
from kafka_ps_tpu.telemetry import critpath as jcritpath
from kafka_ps_tpu.telemetry import drift as jdrift
from kafka_ps_tpu.telemetry import merge as jmerge
from kafka_ps_tpu.telemetry import modelhealth as jmodelhealth
from kafka_ps_tpu.telemetry import postmortem as jpostmortem
from kafka_ps_tpu.telemetry import profiler as jprofiler
from kafka_ps_tpu.telemetry import slo as jslo
from kafka_ps_tpu.utils.trace import Tracer as JTracer
from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime import net
from kafka_ps_tpu_torch.runtime.messages import (GradientMessage, KeyRange,
                                                 WeightsMessage)
from kafka_ps_tpu_torch.telemetry import FLIGHT, FlightRecorder, Telemetry
from kafka_ps_tpu_torch.telemetry import __main__ as tmain
from kafka_ps_tpu_torch.telemetry import (critpath, drift, merge,
                                          modelhealth, postmortem, profiler,
                                          slo)
from kafka_ps_tpu_torch.telemetry.health import HealthServer
from kafka_ps_tpu_torch.utils.trace import Tracer
from tests.test_observability import _full_flow_events
from tests.torch_split_round import bridge_round

REPO = Path(__file__).resolve().parent.parent
F = 8                        # features of the drift and model-health inputs


@pytest.fixture(autouse=True)
def _global_flight_reset():
    yield
    FLIGHT.disable()


def _records(fr) -> list:
    """A recorder's events without their time and thread."""
    return [{k: v for k, v in e.items() if k not in ("t", "thread")}
            for e in fr.tail(10 ** 6)]


# -- drift ------------------------------------------------------------------

def _signal(n=160, shift_at=80, shift=0.5, seed=0) -> list:
    x = np.random.default_rng(seed).normal(1.0, 0.05, n)
    x[shift_at:] += shift
    return x.tolist()


@pytest.mark.parametrize("kind,threshold", [
    ("ph", None), ("ph", 0.8), ("adwin", None), ("adwin", 1.5)])
def test_detectors_give_the_jax_levels_and_statistics(kind, threshold):
    ours = drift.make_detector(kind, threshold)
    ref = jdrift.make_detector(kind, threshold)
    got = [(ours.update(x), ours.statistic) for x in _signal()]
    want = [(ref.update(x), ref.statistic) for x in _signal()]
    assert got == want
    assert drift.DRIFT in [lv for lv, _ in got]      # the shift trips
    ours.reset()
    ref.reset()
    assert ours.statistic == ref.statistic == 0.0


def test_unknown_detector_is_refused_as_in_jax():
    for mod in (drift, jdrift):
        with pytest.raises(ValueError, match="unknown drift detector"):
            mod.make_detector("cusum")


def test_welford_sketch_and_stability_score_are_the_jax_bits():
    rng = np.random.default_rng(1)
    rows = rng.normal(size=(40, F))
    out = []
    for mod in (drift, jdrift):
        ref, cur = mod.WelfordSketch(F), mod.WelfordSketch(F)
        for r in rows:
            ref.update(r)
        for r in rows + 0.7:
            cur.update(r)
        out.append((ref.mean.tobytes(), ref.var().tobytes(),
                    cur.var().tobytes(), mod.stability_score(ref, cur),
                    mod.stability_score(ref, mod.WelfordSketch(F))))
    assert out[0] == out[1]
    assert out[0][3] > drift.STABILITY_WARN and out[0][4] == 0.0


def _rows(n, seed, shift=0.0) -> list:
    """Sparse stream rows (dicts) with `shift` added to every value."""
    x = np.random.default_rng(seed).normal(size=(n, F))
    x[x < -0.5] = 0.0
    return [{j: float(v + shift) for j, v in enumerate(r) if v != 0.0}
            for r in x]


def _eval_stream(seed=2):
    """(loss, f1) rows: a calm stretch, a transient bump, calm again, a
    lasting shift; every fourth f1 the reference's -1 placeholder."""
    rng = np.random.default_rng(seed)
    loss = 0.5 + rng.normal(0.0, 0.02, 140)
    loss[40:46] += 0.25
    loss[100:] += 1.0
    f1 = 0.8 + rng.normal(0.0, 0.01, 140)
    f1[100:] -= 0.3
    f1[::4] = -1.0
    return list(zip(loss.tolist(), f1.tolist()))


def _drive_monitor(mod, flight_cls, tel_cls, detector, shard):
    tel, fr, logged = tel_cls(), flight_cls(capacity=256), []
    fr.enable(role="test")
    mon = mod.DriftMonitor(tel, detector=detector, num_features=F,
                           log=logged.append, shard=shard, flight=fr)
    states = []
    rows = _rows(2400, 3) + _rows(2400, 4, shift=1.0)
    for i, (loss, f1) in enumerate(_eval_stream()):
        for features in rows[i * 34:(i + 1) * 34]:
            mon.observe_row(features)
        mon.observe_row(np.zeros(F))           # a dense row too
        mon.observe_eval(loss, f1)
        states.append((mon.state, mon.last_statistic, mon.in_drift()))
    out = (states, mon.summary(), mon.detail(), logged, _records(fr),
           tel.prometheus_text())
    mon.reset()
    fr.disable()
    return out + (mon.detail(), tel.prometheus_text())


@pytest.mark.parametrize("detector,shard", [("ph", None), ("adwin", 2)])
def test_drift_monitor_equals_the_jax_monitor(detector, shard):
    got = _drive_monitor(drift, FlightRecorder, Telemetry, detector, shard)
    want = _drive_monitor(jdrift, JFlightRecorder, JTelemetry, detector,
                          shard)
    assert got == want
    states, summary, detail, logged, records = got[:5]
    assert summary["trips"] >= 1 and states[-1][0] == drift.DRIFT
    assert detail["rows_sketched"] > 0
    assert any(line.startswith(f"trip;{detector};") for line in logged)
    assert "drift.trip" in {r["kind"] for r in records}
    assert got[6]["state"] == "STABLE"                   # after reset()


# -- model health -----------------------------------------------------------

def _deltas(n=40, seed=5) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        d = rng.normal(0.0, 0.1 + 0.02 * (i % 4), F * 4).astype(np.float32)
        if i == 7:
            d[:] = 0.0                         # a zero delta
        out.append((i % 4, d))
    return out


def _evals(n=30, seed=6) -> list:
    rng = np.random.default_rng(seed)
    return [(float(v), float(f)) for v, f in zip(
        0.6 + rng.normal(0.0, 0.05, n), 0.7 + rng.normal(0.0, 0.02, n))]


def _plane(mod, tel_cls, shard=None):
    tel = tel_cls()
    mon = mod.DriftMonitor(tel, num_features=F, shard=shard,
                           flight=(FlightRecorder if mod is modelhealth
                                   else JFlightRecorder)())
    return tel, mod.ModelHealth(tel, mon, model="bounded", shard=shard)


def _feed(plane, deltas, evals, as_value, as_scalar, poll_every=16):
    polls = []
    for i, (w, d) in enumerate(deltas):
        plane.observe_update(w, as_value(d))
        if i < len(evals):
            loss, f1 = evals[i]
            plane.observe_eval(as_scalar(loss), as_scalar(f1))
        if (i + 1) % poll_every == 0:
            polls.append(plane.poll())
    polls.append(plane.poll())
    return polls, plane.summary(), plane.detail()


@pytest.mark.parametrize("shard", [None, 1])
def test_model_health_inline_equals_the_jax_plane(shard):
    out = []
    for mod, tel_cls in ((modelhealth, Telemetry),
                         (jmodelhealth, JTelemetry)):
        tel, plane = _plane(mod, tel_cls, shard)
        out.append(_feed(plane, _deltas(), _evals(), lambda d: d.copy(),
                         float) + (tel.prometheus_text(),))
    assert out[0] == out[1]
    polls, summary, detail, text = out[0]
    assert summary["updates"] == 40 and detail["pending_deltas"] == 0
    assert set(detail["workers"]) == {"0", "1", "2", "3"}
    assert "modelhealth_deferred_total" in text and \
        "update_norm_bucket" in text


def test_deferred_tensors_resolve_to_the_inline_bits():
    """CPU tensors on the deferred path (the in-process fabric's) and
    scalar tensors for the evals give, once the sampler resolved them,
    the gauges, histogram and drift verdict the inline numpy path gives,
    and the JAX plane's deferred path gives them too."""
    runs = {}
    for name, mod, tel_cls, as_value, as_scalar in (
            ("inline", modelhealth, Telemetry, lambda d: d.copy(), float),
            ("deferred", modelhealth, Telemetry,
             lambda d: torch.from_numpy(d.copy()), torch.tensor),
            ("jax", jmodelhealth, JTelemetry, jnp.asarray, jnp.asarray)):
        tel, plane = _plane(mod, tel_cls)
        runs[name] = _feed(plane, _deltas(), _evals(), as_value,
                           as_scalar) + (tel.prometheus_text(),)
    assert runs["deferred"] == runs["jax"]

    def drop_deferred(text):
        return [ln for ln in text.splitlines()
                if not ln.startswith("modelhealth_deferred_total ")]
    inline, deferred = runs["inline"], runs["deferred"]
    assert inline[1:3] == deferred[1:3]
    assert drop_deferred(inline[3]) == drop_deferred(deferred[3])
    assert "modelhealth_deferred_total 0" in inline[3]
    assert "modelhealth_deferred_total 40" in deferred[3]
    assert [p["resolved_deltas"] for p in deferred[0]] == [16, 16, 8]


def test_sampler_thread_resolves_and_stop_drains():
    tel, plane = _plane(modelhealth, Telemetry)
    plane.sample_every_s = 0.01
    plane.start()
    assert plane.start() is plane
    for w, d in _deltas(20):
        plane.observe_update(w, torch.from_numpy(d))
    plane.observe_eval(torch.tensor(0.5), torch.tensor(0.8))
    plane.stop()
    assert plane.updates == 20 and plane.drift.evals == 1
    assert not any(t.name == "kps-modelhealth"
                   for t in threading.enumerate())


def test_plane_from_args_and_the_null_plane():
    tel = Telemetry()
    assert modelhealth.plane_from_args(Namespace(), tel) is None
    rows = []
    plane = modelhealth.plane_from_args(
        Namespace(model_health=True, drift_detector="adwin",
                  drift_threshold=2.0), tel, shard=3, num_features=F,
        model="eventual", log=rows.append)
    jplane = jmodelhealth.plane_from_args(
        Namespace(model_health=True, drift_detector="adwin",
                  drift_threshold=2.0), JTelemetry(), shard=3,
        num_features=F, model="eventual")
    assert plane.drift.detector_kind == jplane.drift.detector_kind == \
        "adwin"
    assert plane.drift._d_loss.trip_ratio == \
        jplane.drift._d_loss.trip_ratio == 2.0
    assert plane.drift.log == rows.append and plane.shard == 3
    null = modelhealth.NULL_MODEL_HEALTH
    assert not null.enabled and null.start() is null
    assert (null.poll(), null.summary(), null.detail(), null.in_drift()) \
        == ({}, {}, {}, False)


# -- SLO --------------------------------------------------------------------

def test_count_le_equals_the_jax_function():
    rng = np.random.default_rng(7)
    for _ in range(50):
        bounds = tuple(np.cumsum(rng.uniform(0.5, 5.0, 6)).tolist())
        counts = rng.integers(0, 20, 7).tolist()
        for x in (-1.0, 0.0, *rng.uniform(0.0, 40.0, 5).tolist(),
                  bounds[2], 1e9):
            assert slo.count_le(bounds, counts, x) == \
                jslo.count_le(bounds, counts, x)
    assert slo.count_le((1.0, 2.0, 4.0), [4, 2, 2, 3], 1.5) == 5.0


def _burns(mod, tel_cls, flight_cls):
    """The JAX test's explicit-clock scenario and a broken reader, in one
    package: (samples, burning flags, details, beats, family text)."""
    tel, fr = tel_cls(), flight_cls(capacity=16)
    fr.enable(role="test")
    plane = mod.SLOPlane(tel, flight=fr)
    state = {"good": 0.0, "total": 0.0}
    plane.add(mod.SLO("availability", 0.99,
                      lambda: (state["good"], state["total"])))

    def boom():
        raise RuntimeError("reader died")
    plane.add(mod.SLO("broken", 0.9, boom))
    out, burning, beats = [], [], []
    for now, good, total in ((0.0, 0.0, 0.0), (10.0, 90.0, 100.0),
                             (20.0, 190.0, 200.0), (400.0, 390.0, 400.0),
                             (5000.0, 390.0, 400.0)):
        state.update(good=good, total=total)
        out.append(plane.sample_once(now=now))
        burning.append(plane.burning())
        beats.append(fr.last_beat("slo") is not None)
    detail = {k: {kk: vv for kk, vv in v.items() if kk != "burn"}
              for k, v in plane.detail().items()}
    fr.disable()
    return out, burning, detail, beats, tel.prometheus_text()


def test_burn_rates_under_an_explicit_clock_equal_the_jax_plane():
    got = _burns(slo, Telemetry, FlightRecorder)
    assert got == _burns(jslo, JTelemetry, JFlightRecorder)
    assert got[0][1]["availability"]["fast"] == pytest.approx(10.0)
    assert got[1] == [False, True, True, False, False]
    with pytest.raises(ValueError, match="target"):
        slo.SLO("bad", 1.0, lambda: (0, 0))


def _standard(mod, tel_cls, args):
    tel = tel_cls()
    plane = mod.plane_from_args(args, tel)
    if plane is None:
        return None
    lat = tel.histogram("serving_latency_ms")
    age = tel.histogram("snapshot_age_ms")
    out = []
    for step, (fast, slow, shed) in enumerate(((9, 1, 0), (0, 10, 2),
                                               (20, 0, 0))):
        for _ in range(fast):
            lat.observe(5.0)
            age.observe(100.0)
        for _ in range(slow):
            lat.observe(500.0)
            age.observe(5000.0)
        tel.counter("serving_requests_total").inc(fast + slow)
        tel.counter("serving_shed_total").inc(shed)
        tel.counter("modelhealth_evals_total").inc(10)
        tel.counter("modelhealth_unhealthy_total").inc(step)
        out.append(plane.sample_once(now=10.0 * step))
    return [s.name for s in plane.slos], out, tel.prometheus_text()


@pytest.mark.parametrize("args", [
    Namespace(),
    Namespace(slo_serving_p99_ms=50.0, slo_freshness_ms=None),
    Namespace(slo_serving_p99_ms=None, slo_freshness_ms=1000.0,
              model_health=True),
    Namespace(slo_serving_p99_ms=50.0, slo_freshness_ms=1000.0,
              model_health=False)])
def test_standard_objectives_equal_the_jax_plane(args):
    got = _standard(slo, Telemetry, args)
    assert got == _standard(jslo, JTelemetry, args)
    if got is not None:
        assert got[0][0] == "serving_availability"
        assert [s.name for s in slo.standard_slos(
            Telemetry(), serving_p99_ms=50.0, freshness_ms=2000.0,
            model_health=True)] == ["serving_availability",
                                    "serving_latency", "snapshot_freshness",
                                    "model_health"]


# -- profiler ---------------------------------------------------------------

def _leaf():
    pass


def _middle():
    pass


def _chain(codes) -> SimpleNamespace:
    """A fake leaf frame over `codes`, root first."""
    frame = None
    for code in codes:
        frame = SimpleNamespace(f_code=code, f_back=frame)
    return frame


def test_fold_equals_the_jax_fold():
    codes = [_middle.__code__, threading.Thread.run.__code__,
             _leaf.__code__]
    frame = _chain(codes)
    for cache in (None, {}):
        assert profiler._fold(frame, cache) == jprofiler._fold(frame, cache)
    assert profiler._fold(frame) == (
        "test_torch_analysis_planes._middle", "threading.run",
        "test_torch_analysis_planes._leaf")
    deep = _chain([_leaf.__code__] * 100)
    assert len(profiler._fold(deep)) == profiler._MAX_DEPTH == \
        len(jprofiler._fold(deep))


def _profile(mod, monkeypatch):
    """Three sampling rounds over four fake threads with three distinct
    stacks into a table of two: (collapsed, top 2, counts)."""
    frames = {11: _chain([_middle.__code__, _leaf.__code__]),
              12: _chain([_leaf.__code__]),
              13: _chain([_middle.__code__]),
              14: _chain([_middle.__code__, _leaf.__code__])}
    names = [SimpleNamespace(ident=i, name=f"kps-fake-{i % 2}")
             for i in (11, 12, 13)]
    monkeypatch.setattr(sys, "_current_frames", lambda: dict(frames))
    monkeypatch.setattr(threading, "enumerate", lambda: list(names))
    prof = mod.SamplingProfiler(hz=50.0, max_stacks=2)
    taken = [prof.sample_once() for _ in range(3)]
    monkeypatch.undo()
    stats = prof.stats()
    return (prof.collapsed(), prof.top_stacks(2), taken, prof.samples,
            prof.dropped, {k: stats[k] for k in ("hz", "samples", "stacks",
                                                 "dropped", "running")})


def test_bounded_table_and_collapsed_format_equal_the_jax_profiler(
        monkeypatch):
    got = _profile(profiler, monkeypatch)
    assert got == _profile(jprofiler, monkeypatch)
    collapsed, top, taken, samples, dropped, _ = got
    assert taken == [4, 4, 4] and samples == 3 and dropped == 6
    assert "kps-fake-1;(other) 3" in collapsed.splitlines()
    for line in collapsed.splitlines():
        head, _, count = line.rpartition(" ")
        assert head and count.isdigit()
    assert top == collapsed.splitlines()[:2]


def test_profilez_and_modelz_answer_when_armed():
    fr = FlightRecorder(capacity=16)
    fr.enable(role="run", shard=2)
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, daemon=True, name="kps-eval")
    t.start()
    prof = profiler.SamplingProfiler(hz=100.0)
    fr.profiler = prof
    for _ in range(5):
        prof.sample_once()
    tel, plane = _plane(modelhealth, Telemetry)
    plane.observe_update(0, np.ones(F, dtype=np.float32))
    hs = HealthServer(0, flight=fr, modelhealth=plane)
    try:
        base = f"http://127.0.0.1:{hs.port}"
        with urllib.request.urlopen(base + "/profilez", timeout=10) as r:
            assert r.status == 200
            assert r.headers["Content-Type"] == "text/plain"
            body = r.read().decode()
        with urllib.request.urlopen(base + "/modelz", timeout=10) as r:
            assert r.status == 200
            mz = json.loads(r.read())
    finally:
        hs.close()
        stop.set()
        t.join()
        fr.disable()
    assert "# samples: 5\n" in body and "# running: False\n" in body
    eval_line = next(ln for ln in body.splitlines()
                     if ln.startswith("kps-eval;"))
    assert "threading.wait" in eval_line and eval_line.endswith(" 5")
    # the plane's own shard (None) wins over the recorder's, as in JAX
    assert (mz["role"], mz["shard"], mz["updates"]) == ("run", None, 1)
    assert mz["drift"]["state"] == "STABLE"
    assert fr.snapshot()["profile"] == []            # disabled, detached


# -- critpath ---------------------------------------------------------------

def _crit(mod, events, path):
    flows = mod.decompose(events)
    result = mod.aggregate(flows)
    return (flows, result, mod.format_report(result, "t.json"),
            mod.analyze_trace(path))


def test_critpath_of_the_jax_synthetic_trace_equals_the_jax_tool(
        tmp_path, capsys):
    events = _full_flow_events()
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = _crit(critpath, events, str(path))
    assert got == _crit(jcritpath, events, str(path))
    segs = got[0][0]["segments"]
    assert segs["wire"] == pytest.approx(3.8) and len(segs) == 7
    assert got[1]["models"]["sequential"]["dominant"] == "gate_wait"
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"traceEvents": []}))
    for trace in (path, empty, tmp_path / "missing.json"):
        rcs = []
        for mod in (critpath, jcritpath):
            rcs.append((mod.critpath_main(str(trace)),
                        capsys.readouterr().out))
        assert rcs[0] == rcs[1]
    assert rcs[0][0] == 2


def _traced_round(tmp_path, task):
    """A traced port bridge round: the server's and the worker's trace
    files (pids 1001 and 2002)."""
    tracers = {"server": Tracer(pid=1001, counter_sample_s=0.0),
               "worker": Tracer(pid=2002, counter_sample_s=0.0)}
    bridge_round("cpu", task, obs=lambda role: (tracers[role], None))
    return [tracers[r].dump(str(tmp_path / f"{task}-{r}.json"))
            for r in ("server", "worker")]


@pytest.mark.parametrize("task", ["logreg", "mlp"])
def test_critpath_and_merge_of_a_port_trace_equal_the_jax_tools(task,
                                                                tmp_path):
    paths = _traced_round(tmp_path, task)
    out = tmp_path / "port.json", tmp_path / "jax.json"
    stats = (merge.merge_traces(paths, str(out[0])),
             jmerge.merge_traces(paths, str(out[1])))
    assert stats[0] == stats[1] and stats[0]["cross_process_flows"] >= 2
    assert json.loads(out[0].read_text()) == json.loads(out[1].read_text())
    events = critpath.load_events(str(out[0]))
    got = _crit(critpath, events, str(out[0]))
    assert got == _crit(jcritpath, events, str(out[0]))
    assert got[1]["flows"] >= 2
    assert {"local_train", "wire", "apply"} <= set(
        got[1]["models"]["sequential"]["segments"])


def test_merge_and_critpath_of_mixed_package_traces(tmp_path):
    """A port server bridge with a JAX worker bridge, both traced, and a
    JAX tracer of a third process claiming the server's pid: merged by
    either tool alike, the pid collision renumbered, the delta flows
    decomposed alike."""
    st, wt = Tracer(pid=1001), JTracer(pid=2002)
    sb = net.ServerBridge(run_id=7, device="cpu", tracer=st)
    sfab = sb.wrap(fabric_mod.Fabric())
    wb = jnet.WorkerBridge("127.0.0.1", sb.port, [0], tracer=wt)
    wfab = wb.make_fabric()
    reader = threading.Thread(target=wb.run_reader, args=({},), daemon=True)
    reader.start()
    vals = np.arange(16, dtype=np.float32)
    try:
        sb.wait_for_connected([0], timeout=10.0)
        wb.mark_ready(0)
        sb.wait_for_workers([0], timeout=10.0)
        for clock in range(3):
            sfab.send(fabric_mod.WEIGHTS_TOPIC, 0, WeightsMessage(
                vector_clock=clock, key_range=KeyRange(0, 16),
                values=torch.from_numpy(vals)))
            wfab.poll_blocking(jfabric.WEIGHTS_TOPIC, 0, timeout=10.0)
            wfab.send(jfabric.GRADIENTS_TOPIC, 0, jmsg.GradientMessage(
                vector_clock=clock, key_range=jmsg.KeyRange(0, 16),
                values=vals, worker_id=0))
            msg = sfab.poll_blocking(fabric_mod.GRADIENTS_TOPIC, 0,
                                     timeout=10.0)
            assert isinstance(msg, GradientMessage)
            with st.span("server.apply", worker=0, clock=clock,
                         model="eventual"):
                st.flow_step("delta.wire", msg.trace, clock=clock)
    finally:
        wb.close()
        sb.close()
        reader.join(timeout=10.0)
    third = JTracer(pid=1001)
    with third.span("other"):
        pass
    paths = [st.dump(str(tmp_path / "s.json")),
             wt.dump(str(tmp_path / "w.json")),
             third.dump(str(tmp_path / "x.json"))]
    out = tmp_path / "port.json", tmp_path / "jax.json"
    stats = (merge.merge_traces(paths, str(out[0])),
             jmerge.merge_traces(paths, str(out[1])))
    assert stats[0] == stats[1] and len(stats[0]["pids"]) == 3
    assert json.loads(out[0].read_text()) == json.loads(out[1].read_text())
    events = critpath.load_events(str(out[0]))
    got = _crit(critpath, events, str(out[0]))
    assert got == _crit(jcritpath, events, str(out[0]))
    assert got[1]["flows"] == 3
    assert set(got[1]["models"]["eventual"]["segments"]) == {"apply", "wire"}


def _rolling(mod, tel_cls):
    tel = tel_cls()
    gate = tel.histogram("gate_wait_ms", model="bsp")
    gate2 = tel.histogram("gate_wait_ms", model="eventual")
    serve = tel.histogram("serving_latency_ms")
    step = tel.histogram("worker_update_ms", worker="0")
    crit = mod.RollingCritpath(tel)
    out = [crit.sample()]
    for _ in range(4):
        gate.observe(50.0)
    gate2.observe(3.0)
    serve.observe(2.0)
    out.append(crit.sample())
    for _ in range(8):
        serve.observe(30.0)
        step.observe(0.4)
    out.append(crit.sample())
    out.append(crit.sample())
    return out


def test_rolling_critpath_windows_equal_the_jax_sampler():
    got = _rolling(critpath, Telemetry)
    assert got == _rolling(jcritpath, JTelemetry)
    assert [r["dominant"] for r in got] == ["idle", "gate_wait", "serving",
                                            "idle"]
    assert got[1]["gate_wait_n"] == 5 and "gate_wait_n" not in got[2]
    assert got[2]["local_train_n"] == 8


# -- postmortem and the CLI -------------------------------------------------

def _dumps(tmp_path) -> Path:
    """A port worker's dump naming shards 0 and 1, a JAX shard-0 server's
    dump with a stalled gate, a drift trip and a watchdog trip, and a
    torn file: shard 1 died."""
    d = tmp_path / "flight"
    d.mkdir()
    fr = FlightRecorder()
    fr.enable(role="worker", meta={"shards": [0, 1]})
    for clock in range(3):
        for shard in (0, 1):
            fr.record("shard.weights", shard=shard, worker=0, clock=clock)
    fr.record("drift.warn", detector="ph", statistic=1.0, signal="loss",
              eval_row=4)
    fr.dump(path=str(d / "flightdump-2002.json"), reason="shutdown")
    fr.disable()
    jfr = JFlightRecorder()
    jfr.enable(role="server", shard=0, meta={"shards": [0, 1]})
    jfr.record("gate.arrive", shard=0, worker=1, clock=9, lag=5,
               waiting=1, clocks=[9, 4])
    jfr.record("watchdog.trip", name="gate", reason="stalled 31.0s")
    jfr.record("drift.trip", detector="adwin", statistic=2.5,
               signal="f1", eval_row=17)
    jfr.dump(path=str(d / "flightdump-1001.json"), reason="signal:SIGTERM")
    jfr.disable()
    (d / "flightdump-3003.json").write_text('{"schema": "kps-flight')
    return d


def test_postmortem_of_mixed_dumps_equals_the_jax_analyzer(tmp_path,
                                                          capsys):
    d = _dumps(tmp_path)
    got = postmortem.load_dumps_with_errors(str(d))
    want = jpostmortem.load_dumps_with_errors(str(d))
    assert got == want
    report = postmortem.analyze(*got)
    assert report == jpostmortem.analyze(*want)
    assert postmortem.format_report(report) == \
        jpostmortem.format_report(report)
    assert report["deadShards"] == [1] and report["lastAcks"][1]["clock"] \
        == 2
    assert [e["event"] for e in report["driftEvents"]] == ["trip", "warn"]
    assert len(report["unreadable"]) == 1
    assert postmortem.load_dumps(str(d)) == got[0]
    rcs = []
    for mod in (postmortem, jpostmortem):
        rcs.append((mod.main(str(d)), mod.main(str(tmp_path)),
                    capsys.readouterr().out))
    assert rcs[0] == rcs[1] and rcs[0][:2] == (0, 1)


def test_telemetry_cli_gives_the_jax_output_and_exit_codes(tmp_path,
                                                          capsys):
    d = _dumps(tmp_path)
    trace = tmp_path / "t.json"
    trace.write_text(json.dumps({"traceEvents": _full_flow_events()}))
    flowless = tmp_path / "f.json"
    flowless.write_text(json.dumps([{"name": "x", "ph": "X", "ts": 0.0}]))
    for argv in (["merge", "-o", str(tmp_path / "m.json"), str(trace),
                  str(flowless)],
                 ["critpath", str(tmp_path / "m.json")],
                 ["critpath", str(flowless)],
                 ["critpath", str(tmp_path / "missing.json")],
                 ["postmortem", str(d)],
                 ["postmortem", str(tmp_path / "nowhere")]):
        got = (tmain.main(argv), capsys.readouterr().out)
        assert got == (jmain.main(argv), capsys.readouterr().out), argv
    for mod in (tmain, jmain):
        with pytest.raises(SystemExit) as e:
            mod.main([])
        assert e.value.code == 2
    capsys.readouterr()
    # the module entry point itself
    procs = [subprocess.run(
        [sys.executable, "-m", pkg, "critpath", str(trace)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
        for pkg in ("kafka_ps_tpu_torch.telemetry",
                    "kafka_ps_tpu.telemetry")]
    assert procs[0].returncode == procs[1].returncode == 0
    assert procs[0].stdout == procs[1].stdout
    assert "dominant=gate_wait" in procs[0].stdout
