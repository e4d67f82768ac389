"""Runs with the port's analysis planes armed (--profile, the --slo-*
flags, --model-health), in both packages on the same rows:

  * in process, θ and the CSV rows with the planes armed (the tracer,
    registry, flight recorder, sampling profiler, SLO plane and
    model-health plane with its drift monitor on the buffers) are
    bitwise the run without them, at -c 0, 2 and -1, and every delta the
    plane defers still holds at the end what it held when observed;
  * the armed run's families and label sets equal the JAX run's, and its
    counters of host decisions — `modelhealth_deferred_total` (every
    in-process delta is deferred in both), `modelhealth_updates_total`,
    `modelhealth_evals_total`, the `update_norm` observations — equal;
  * a drift injection (label-flipped, mean-shifted rows after a calm
    baseline) trips in both packages with the same trip count and final
    state; a clean control stretch trips in neither;
  * /profilez and /modelz answer 200 when armed in both packages, their
    404 bodies are byte-equal when not, and the JAX postmortem reads a
    port dump that carries a profile;
  * one split deployment per package (a server and one worker process,
    --model-health on both), and one of two shard servers and a sharded
    worker, give the JAX roles' counts: every delta off the socket
    computed inline, none deferred.
`cli.run` with every flag of the JAX CLI but --device_trace is
tests/test_torch_telemetry_runs.py's CLI test.
"""

from __future__ import annotations

import dataclasses
import json
import os
import urllib.error
import urllib.request
from argparse import Namespace

import numpy as np
import pytest
import torch

from kafka_ps_tpu.runtime.app import StreamingPSApp as JApp
from kafka_ps_tpu.telemetry import FLIGHT as JFLIGHT
from kafka_ps_tpu.telemetry import Telemetry as JTelemetry
from kafka_ps_tpu.telemetry import model_name
from kafka_ps_tpu.telemetry import modelhealth as jmodelhealth
from kafka_ps_tpu.telemetry import postmortem as jpostmortem
from kafka_ps_tpu.telemetry import slo as jslo
from kafka_ps_tpu.telemetry.health import OpsPlane as JOpsPlane
from kafka_ps_tpu.utils import config as jconfig
from kafka_ps_tpu.utils.trace import Tracer as JTracer
from kafka_ps_tpu_torch.data.synth import generate, write_csv
from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
from kafka_ps_tpu_torch.telemetry import FLIGHT, Telemetry, modelhealth, slo
from kafka_ps_tpu_torch.telemetry.health import OpsPlane
from kafka_ps_tpu_torch.utils import config
from kafka_ps_tpu_torch.utils.trace import Tracer
from tests.test_torch_slice import _clock, _configs, _data
from tests.torch_role_runs import JAX_PKG, PORT_PKG, Role, free_port

ITERS = 36
F = 64                       # tests/test_torch_slice.py's width
MH_ARGS = Namespace(model_health=True, drift_detector="ph",
                    drift_threshold=None, slo_serving_p99_ms=50.0,
                    slo_freshness_ms=1000.0)
PKGS = {
    "port": dict(app=StreamingPSApp, config=config, tel=Telemetry,
                 tracer=Tracer, mh=modelhealth, slo=slo, ops=OpsPlane),
    "jax": dict(app=JApp, config=jconfig, tel=JTelemetry, tracer=JTracer,
                mh=jmodelhealth, slo=jslo, ops=JOpsPlane)}


@pytest.fixture(autouse=True)
def _global_flight_reset():
    yield
    FLIGHT.disable()
    JFLIGHT.disable()


def _arm(pkg: str, app, c: int, *, health_port=None, flight_dir=None):
    """Every analysis plane on `app` (its telemetry is on): the
    model-health plane on the server and the buffers, the ops plane with
    the profiler, the SLO plane and the model-health plane, started.
    Returns (ops, plane, drift rows logged)."""
    p = PKGS[pkg]
    logged: list = []
    plane = p["mh"].plane_from_args(MH_ARGS, app.telemetry,
                                    num_features=F, model=model_name(c),
                                    log=logged.append)
    app.server.attach_model_health(plane)
    for b in app.buffers:
        b.attach_drift(plane.drift)
    ops = p["ops"](telemetry=app.telemetry, role="run", profile=True,
                   health_port=health_port, flight_dir=flight_dir,
                   slo_plane=p["slo"].plane_from_args(MH_ARGS,
                                                      app.telemetry),
                   modelhealth=plane)
    ops.start()
    return ops, plane, logged


def _run(pkg: str, c: int, armed: bool):
    """One serial run of `pkg` on tests/test_torch_slice.py's rows:
    (theta bytes or array, server rows, worker rows, app, plane), stamps
    stripped.  Armed, the plane is polled between rounds (the sampler
    thread polls too), so no delta is dropped from its queue."""
    p = PKGS[pkg]
    rows, tx, ty = _data()
    # the port's defaults in both packages: gang dispatch, the async eval
    cfg = dataclasses.replace(_configs(p["config"], c), use_gang=True,
                              eval_async=True)
    kw = {"device": "cpu"} if pkg == "port" else {}
    if armed:
        tracer = p["tracer"](counter_sample_s=0.0)
        kw.update(tracer=tracer, telemetry=p["tel"](tracer=tracer))
    server, worker = [], []
    app = p["app"](cfg, test_x=tx, test_y=ty, server_log=server.append,
                   worker_log=worker.append, clock_ms=_clock(), **kw)
    ops = plane = None
    if armed:
        ops, plane, _ = _arm(pkg, app, c)
    w = cfg.num_workers
    prefill = 40 * w
    for i, (feats, label) in enumerate(rows[:prefill]):
        app.data_sink(i % w, feats, label)
    tail = iter(enumerate(rows[prefill:], start=prefill))

    def pump():
        nxt = next(tail, None)
        if nxt is not None:
            app.data_sink(nxt[0] % w, *nxt[1])
        if plane is not None:
            plane.poll()
    app.run_serial(ITERS, pump=pump)
    app.close_logs()
    if ops is not None:
        ops.close()          # stops the samplers; the plane drains
    theta = app.server.theta
    theta = (theta.numpy().tobytes() if pkg == "port"
             else np.asarray(theta))
    strip = [r.split(";", 1)[1] for r in server]
    return theta, strip, [r.split(";", 1)[1] for r in worker], app, plane


@pytest.mark.parametrize("c", [0, 2, -1])
def test_armed_planes_leave_theta_and_rows_bitwise(c):
    off = _run("port", c, armed=False)
    on = _run("port", c, armed=True)
    assert on[:3] == off[:3] and off[1] and off[2]
    plane = on[4]
    assert plane.updates == ITERS and plane.drift.evals == len(on[1])


@pytest.mark.parametrize("c", [0, -1])
def test_deferred_deltas_are_never_written_after_they_are_observed(
        c, monkeypatch):
    """The plane keeps references to the deltas it defers: every tensor
    the in-process apply paths hand it (the gang's chained batch at -c 0,
    the per-message path at -1) still holds, when the run is over, the
    values it held when it was observed."""
    seen = []
    real = modelhealth.ModelHealth.observe_update

    def observe(self, worker, values):
        seen.append((values, values.clone()))
        real(self, worker, values)
    monkeypatch.setattr(modelhealth.ModelHealth, "observe_update", observe)
    _run("port", c, armed=True)
    assert len(seen) == ITERS
    assert all(torch.equal(v, at) for v, at in seen)


def _states(tel) -> dict:
    return {name: set(fam.children())
            for name, fam in tel.registry.families().items()}


def _value(tel, name):
    snap = tel.snapshot()[name]
    (v,) = snap.values()
    return v["count"] if isinstance(v, dict) else v


@pytest.mark.parametrize("c", [0, 2])
def test_armed_families_and_counts_equal_the_jax_run(c):
    port, jax = _run("port", c, armed=True), _run("jax", c, armed=True)
    ptel, jtel = port[3].telemetry, jax[3].telemetry
    assert _states(ptel) == _states(jtel)
    for name in ("modelhealth_deferred_total", "modelhealth_updates_total",
                 "modelhealth_evals_total", "update_norm", "drift_state",
                 "drift_trip_total", "modelhealth_unhealthy_total"):
        assert _value(ptel, name) == _value(jtel, name), name
    # in process every delta is a tensor (a device array in JAX): deferred
    assert _value(ptel, "modelhealth_deferred_total") == ITERS
    assert {k for k in _states(ptel)["slo_burn_rate"]} == {
        (s, w) for s in ("serving_availability", "serving_latency",
                         "snapshot_freshness", "model_health")
        for w in ("fast", "slow")}
    assert port[4].summary()["updates"] == jax[4].summary()["updates"]


# -- drift injection --------------------------------------------------------

DRIFT_F, DRIFT_C, DRIFT_W, CAP = 32, 3, 4, 128


def _drift_arm(pkg: str, inject: bool, chunk=8, baseline=40,
               max_evals=400) -> dict:
    """The JAX package's drift-detection arm at a small shape: a calm
    baseline, then label-flipped and mean-shifted rows (inject) or fresh
    clean rows (control), eval at every clock, the plane polled after
    every chunk of iterations."""
    p = PKGS[pkg]
    n = DRIFT_W * CAP
    x, y = generate(2 * n + 256, DRIFT_F, DRIFT_C, seed=31)
    tx, ty = x[2 * n:], y[2 * n:]
    cx, cy = x[n:2 * n], y[n:2 * n]
    dx, dy = generate(n, DRIFT_F, DRIFT_C, seed=37, label_noise=0.95)
    dx = dx + 1.0
    mod = p["config"]
    cfg = mod.PSConfig(
        num_workers=DRIFT_W, consistency_model=0, eval_every=1,
        use_gang=False, eval_async=False,
        model=mod.ModelConfig(num_features=DRIFT_F, num_classes=DRIFT_C),
        buffer=mod.BufferConfig(min_size=CAP, max_size=CAP))
    kw = {"device": "cpu"} if pkg == "port" else {}
    app = p["app"](cfg, test_x=tx, test_y=ty, telemetry=p["tel"](), **kw)
    logged: list = []
    plane = p["mh"].plane_from_args(MH_ARGS, app.telemetry,
                                    num_features=DRIFT_F, log=logged.append)
    app.server.attach_model_health(plane)
    for b in app.buffers:
        b.attach_drift(plane.drift)
    mon = plane.drift
    for i in range(n):
        app.data_sink(i % DRIFT_W, dict(enumerate(x[i].tolist())),
                      int(y[i]))
    done = 0

    def advance(iters):
        nonlocal done
        done += iters
        app.run_serial(max_server_iterations=done)
        plane.poll()

    advance(baseline)
    at = mon.evals
    sx, sy = (dx, dy) if inject else (cx, cy)
    for i in range(n):
        app.data_sink(i % DRIFT_W, dict(enumerate(sx[i].tolist())),
                      int(sy[i]))
    while mon.evals < max_evals:
        if (inject and mon.trips) or (not inject and mon.evals >= at + 160):
            break
        advance(chunk)
    return {**mon.detail(), "at": at, "logged": logged,
            "delay": (None if mon.last_trip_eval is None
                      else mon.last_trip_eval - at)}


def test_drift_injection_trips_in_both_packages_and_control_does_not():
    port = {arm: _drift_arm("port", arm) for arm in (True, False)}
    jax = {arm: _drift_arm("jax", arm) for arm in (True, False)}
    for arm in (True, False):
        for key in ("state", "trips", "at"):
            assert port[arm][key] == jax[arm][key], (arm, key)
    assert port[True]["state"] == "DRIFT" and port[True]["trips"] == 1
    assert port[True]["logged"][-1].startswith("trip;ph;")
    # the trip's eval row: float32 sums in another order may move the
    # statistic across the threshold one eval row apart, never more
    assert abs(port[True]["delay"] - jax[True]["delay"]) <= 1
    assert port[False]["state"] == "STABLE" and port[False]["trips"] == 0
    assert port[False]["logged"] == jax[False]["logged"] == []


# -- the health plane and the flight dump -----------------------------------

def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _endpoints(pkg: str, armed: bool, tmp_path):
    p = PKGS[pkg]
    tel = p["tel"]()
    if armed:
        plane = p["mh"].plane_from_args(MH_ARGS, tel, num_features=F)
        ops = p["ops"](telemetry=tel, role="run", health_port=0,
                       profile=True,
                       slo_plane=p["slo"].plane_from_args(MH_ARGS, tel),
                       modelhealth=plane,
                       flight_dir=str(tmp_path / pkg))
    else:
        ops = p["ops"](telemetry=tel, role="run", health_port=0)
    ops.start()
    try:
        if armed:
            for _ in range(3):
                ops.profiler.sample_once()
        return {path: _get(ops.health.port, path)
                for path in ("/profilez", "/modelz", "/healthz")}
    finally:
        ops.close()


def test_profilez_and_modelz_as_the_jax_plane(tmp_path):
    ours = _endpoints("port", False, tmp_path)
    ref = _endpoints("jax", False, tmp_path)
    for path in ("/profilez", "/modelz"):
        assert ours[path] == ref[path] and ours[path][0] == 404
    ours = _endpoints("port", True, tmp_path)
    ref = _endpoints("jax", True, tmp_path)
    for path in ("/profilez", "/modelz", "/healthz"):
        assert ours[path][:2] == ref[path][:2]
        assert ours[path][0] == 200, path
    assert b"# samples: " in ours["/profilez"][2]
    mz, jmz = (json.loads(r["/modelz"][2]) for r in (ours, ref))
    assert mz == jmz and mz["drift"]["state"] == "STABLE"
    hz, jhz = (json.loads(r["/healthz"][2]) for r in (ours, ref))
    assert set(hz["watchdogs"]) == set(jhz["watchdogs"]) == {"slo", "drift"}
    assert hz["slo"].keys() == jhz["slo"].keys()
    # the exit dumps carry the profile; the JAX postmortem reads ours
    (dump,) = (tmp_path / "port").glob("flightdump-*.json")
    assert json.loads(dump.read_text())["profile"]
    dumps, unreadable = jpostmortem.load_dumps_with_errors(
        str(tmp_path / "port"))
    assert len(dumps) == 1 and unreadable == []
    assert dumps[0]["profile"] and dumps[0]["role"] == "run"
    assert jpostmortem.analyze(dumps)["watchdogTrips"] == []


# -- one split deployment per package ---------------------------------------

SPLIT_ITERS = 60


def _env() -> dict:
    env = dict(os.environ, KPS_PLATFORM="cpu", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_split_roles_with_model_health_count_as_the_jax_roles(tmp_path):
    x, y = generate(460, 16, 3, noise=1.0, sparsity=0.5, seed=0)
    train, test = str(tmp_path / "train.csv"), str(tmp_path / "test.csv")
    write_csv(train, x[:400], y[:400])
    write_csv(test, x[400:], y[400:])
    common = ["-test", test, "--num_features", "16", "--num_classes", "3",
              "--num_workers", "4", "--model-health", "-l"]
    runs = {}
    for pkg in (PORT_PKG, JAX_PKG):
        port = free_port()
        server = Role(pkg, "server_runner",
                      ["--listen", port, "-training", train, "-c", "2",
                       "-p", "1", "--max_iterations", SPLIT_ITERS,
                       "--status_every", "0.05", "--profile",
                       "--slo-freshness-ms", "1000", *common],
                      tmp_path / pkg / "server", _env())
        worker = Role(pkg, "worker_runner",
                      ["--connect", f"127.0.0.1:{port}", "--worker_ids",
                       "0,1,2,3", *common], tmp_path / pkg / "worker",
                      _env())
        runs[pkg] = server, worker
    try:
        for server, worker in runs.values():
            for role in (server, worker):
                assert role.wait() == 0, role.err[-4000:]
    finally:
        for server, worker in runs.values():
            server.kill()
            worker.kill()
    (server, worker), (jserver, jworker) = runs[PORT_PKG], runs[JAX_PKG]
    assert server.metric_types() == jserver.metric_types()
    assert worker.metric_types() == jworker.metric_types()
    iters = server.stats("server")["server_iterations"]
    for role, n in ((server, iters), (jserver, SPLIT_ITERS)):
        m = role.metrics()
        # every delta arrived as a frame: computed inline, none deferred
        assert m["modelhealth_updates_total"][""] == n
        assert m["modelhealth_deferred_total"][""] == 0
        assert m["update_norm_count"]['model="bounded"'] == n
        assert 'slo="snapshot_freshness",window="fast"' in \
            m["slo_burn_rate"]
    # each worker process's plane saw every row it wrote
    rows = sum(worker.stats("worker")["rows"].values())
    wm, jwm = worker.metrics(), jworker.metrics()
    assert wm["modelhealth_evals_total"][""] == rows > 0
    assert wm["modelhealth_updates_total"][""] == 0 == \
        jwm["modelhealth_updates_total"][""]
    status = [ln for ln in server.lines if ln.startswith("[status] ")]
    assert status and all(" critpath " in ln and " modelhealth " in ln
                          for ln in status)
    for role in (server, worker):
        (dump,) = role.dumps()
        assert dump["profile"] if role is server else not dump["profile"]
    with open(server.path("logs-drift.csv")) as f:
        assert f.readline().strip() == "timestamp;event;detector;" \
            "statistic;signal"
    assert os.path.exists(worker.path("logs-drift-worker.csv"))


def test_shard_roles_with_model_health_count_as_the_jax_roles(tmp_path):
    """Two shard servers and one sharded worker process per package,
    --model-health on each: every shard's plane, its families labelled
    with its shard, computes each slice off the socket inline, as the JAX
    shards do; each process writes its own drift log."""
    x, y = generate(460, 16, 3, noise=1.0, sparsity=0.5, seed=0)
    train, test = str(tmp_path / "train.csv"), str(tmp_path / "test.csv")
    write_csv(train, x[:400], y[:400])
    write_csv(test, x[400:], y[400:])
    common = ["-test", test, "--num_features", "16", "--num_classes", "3",
              "--num_workers", "4", "--model-health", "-l"]
    runs = {}
    for pkg in (PORT_PKG, JAX_PKG):
        ports = [free_port(), free_port()]
        shards = [Role(pkg, "server_runner",
                       ["--listen", ports[i], "--shards", "2",
                        "--shard-id", i, "-c", "2", "--max_iterations",
                        SPLIT_ITERS, *(("-training", train, "-p", "1")
                                       if i == 0 else ()), *common],
                       tmp_path / pkg / f"s{i}", _env()) for i in (0, 1)]
        worker = Role(pkg, "worker_runner",
                      ["--connect", ",".join(f"127.0.0.1:{p}"
                                             for p in ports),
                       "--worker_ids", "0,1,2,3", *common],
                      tmp_path / pkg / "worker", _env())
        runs[pkg] = (*shards, worker)
    try:
        for roles in runs.values():
            for role in roles:
                assert role.wait() == 0, role.err[-4000:]
    finally:
        for roles in runs.values():
            for role in roles:
                role.kill()
    for role, jrole in zip(runs[PORT_PKG], runs[JAX_PKG]):
        assert role.metric_types() == jrole.metric_types()
    for i in (0, 1):
        for role in (runs[PORT_PKG][i], runs[JAX_PKG][i]):
            m = role.metrics()
            label = f'shard="{i}"'
            assert m["modelhealth_updates_total"][label] == SPLIT_ITERS
            assert m["modelhealth_deferred_total"][label] == 0
            assert os.path.exists(role.path(f"logs-drift-shard{i}.csv"))
    worker = runs[PORT_PKG][2]
    rows = sum(worker.stats("worker")["rows"].values())
    assert worker.metrics()["modelhealth_evals_total"][""] == rows > 0
