"""Runs with the port's telemetry on (kafka_ps_tpu_torch/telemetry/,
utils/trace.py, utils/status.py).

  * Telemetry off, null and fully on (tracer, registry, flight recorder)
    give bitwise the same theta and CSV rows, stamps stripped: serial
    -c 0/2/-1 for logreg and the MLP, gang dispatch off, --fused and a
    durable log.
  * The port's run against the JAX run on the same inputs, flags and
    theta0: the same metric families and label sets; the counters of
    host decisions equal exactly; the timing histograms equal in their
    observation counts.
  * `cli.run` with every telemetry flag of the JAX CLI (the base's seven,
    the profiler's, the SLO plane's and the model-health plane's)
    against the JAX CLI with the same flags (one subprocess each, run
    side by side), and the role runners' refusal of `--device_trace`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

from kafka_ps_tpu.runtime.app import StreamingPSApp as JApp
from kafka_ps_tpu.telemetry import Telemetry as JTelemetry
from kafka_ps_tpu.utils import config as jconfig
from kafka_ps_tpu.utils.trace import Tracer as JTracer
from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
from kafka_ps_tpu_torch.telemetry import (FLIGHT, NULL_TELEMETRY,
                                          Telemetry)
from kafka_ps_tpu_torch.utils import config
from kafka_ps_tpu_torch.utils.trace import NULL_TRACER, Tracer
from kafka_ps_tpu_torch.weights import from_jax_params
from tests.test_torch_slice import (ATOL, RTOL, _configs, _data, _drive,
                                    _split)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 36


@pytest.fixture(autouse=True)
def _global_flight_reset():
    yield
    FLIGHT.disable()


def _telemetry(mode: str):
    """(tracer, telemetry) for one arm: off (None), null (the null
    objects) or on (a tracer sampling every count, a registry, and the
    process-wide flight recorder armed)."""
    if mode == "off":
        return None, None
    if mode == "null":
        return NULL_TRACER, NULL_TELEMETRY
    tracer = Tracer(counter_sample_s=0.0)
    FLIGHT.enable(role="run")
    return tracer, Telemetry(tracer=tracer)


def _stripped(lines):
    return [line.split(";", 1)[1] for line in lines]


def _run(task: str, c: int, variant: str, mode: str, tmp_path):
    """One port run in telemetry `mode`: (theta bytes, server rows,
    worker rows), stamps stripped.  `variant`: "" (gang dispatch and the
    async eval engine, the defaults), "nogang" (per-message dispatch and
    fused evals), "fused" (run_fused_bsp) or "durable" (a DurableFabric
    under the app)."""
    rows, tx, ty = _data()
    tracer, telemetry = _telemetry(mode)
    cfg = _configs(config, c, task)
    kw = {}
    if variant == "nogang":
        cfg = dataclasses.replace(cfg, use_gang=False, eval_async=False)
    if variant == "durable":
        from kafka_ps_tpu_torch.log import DurableFabric, LogConfig
        kw["fabric"] = DurableFabric(str(tmp_path / f"wal-{mode}"),
                                     LogConfig(fsync="always"), device="cpu",
                                     tracer=tracer, telemetry=telemetry)
    if variant == "fused":
        server, worker = [], []
        cfg = dataclasses.replace(cfg, eval_every=3)
        app = StreamingPSApp(cfg, test_x=tx, test_y=ty, device="cpu",
                             server_log=server.append,
                             worker_log=worker.append, tracer=tracer,
                             telemetry=telemetry)
        for i, (feats, label) in enumerate(rows[:120]):
            app.data_sink(i % cfg.num_workers, feats, label)
        app.run_fused_bsp(max_server_iterations=cfg.num_workers * 20)
        app.close_logs()
    else:
        app, server, worker = _drive(StreamingPSApp, cfg, rows, tx, ty,
                                     ITERS, device="cpu", tracer=tracer,
                                     telemetry=telemetry, **kw)
    if variant == "durable":
        kw["fabric"].close()
    if mode == "on":
        # the instrumented run recorded something (the fused rounds pass
        # no gate, so they leave the flight recorder empty, as in JAX; the
        # fused loop records spans and no tracer counter)
        recorded = (tracer.span_stats() if variant == "fused"
                    else tracer.counters())
        assert recorded and telemetry.snapshot()
        assert (FLIGHT.total_events() > 0) == (variant != "fused")
    FLIGHT.disable()
    theta = app.server.theta.numpy().tobytes()
    return theta, _stripped(server), _stripped(worker)


@pytest.mark.parametrize("task,c,variant", [
    ("logreg", 0, ""), ("logreg", 2, ""), ("logreg", -1, ""),
    ("mlp", 0, ""), ("mlp", 2, ""), ("mlp", -1, ""),
    ("logreg", 0, "nogang"), ("logreg", 0, "fused"),
    ("logreg", 0, "durable")])
def test_telemetry_off_null_and_on_give_the_same_bits(task, c, variant,
                                                      tmp_path):
    off = _run(task, c, variant, "off", tmp_path)
    assert off[1] and off[2]
    assert _run(task, c, variant, "null", tmp_path) == off
    assert _run(task, c, variant, "on", tmp_path) == off


# -- the port's counters against the JAX package's --------------------------

# families whose every child counts a host decision: equal exactly
EXACT = ("gradients_applied_total", "clock_lag", "worker_clock_lag",
         "gang_dispatches_total", "gang_members_total",
         "worker_updates_total", "buffer_rows_ingested_total",
         "slab_upload_bytes_total", "snapshots_published_total",
         "serving_clock", "eval_lag_clocks", "log_appends_total",
         "log_replays_total")
# timing histograms: equal in their observation counts only
TIMED = ("gate_wait_ms", "worker_update_ms", "log_fsync_ms")
# the async eval's coalescing widths depend on the engine thread's
# timing (ROADMAP C.1): the number of batches does too, so only the sum
# of the widths, the evaluations made, is compared
WIDTHS = "eval_coalesce_width"


def _states(tel):
    """{family: {label tuple: value or (bucket counts, sum, count)}}."""
    out = {}
    for name, fam in tel.registry.families().items():
        out[name] = {
            key: (child.state() if fam.kind == "histogram"
                  else child.value)
            for key, child in fam.children().items()}
    return out


def _pair(task: str, c: int, gang: bool, durable: bool, tmp_path):
    rows, tx, ty = _data()
    out = []
    jtheta0 = None
    for cls, mod in ((JApp, jconfig), (StreamingPSApp, config)):
        cfg = dataclasses.replace(_configs(mod, c, task), use_gang=gang,
                                  eval_async=True)
        if cls is JApp:
            tracer = JTracer(counter_sample_s=0.0)
            tel = JTelemetry(tracer=tracer)
            kw = {}
            if task == "mlp":
                jtheta0 = np.asarray(JApp(cfg).server.theta)
                kw["theta0"] = jtheta0
            if durable:
                from kafka_ps_tpu.log import DurableFabric, LogConfig
                kw["fabric"] = DurableFabric(
                    str(tmp_path / "jwal"), LogConfig(fsync="none"),
                    tracer=tracer, telemetry=tel)
        else:
            tracer = Tracer(counter_sample_s=0.0)
            tel = Telemetry(tracer=tracer)
            kw = {"device": "cpu"}
            if task == "mlp":
                kw["theta0"] = from_jax_params(jtheta0, cfg.model, "cpu",
                                               task="mlp")
            if durable:
                from kafka_ps_tpu_torch.log import DurableFabric, LogConfig
                kw["fabric"] = DurableFabric(
                    str(tmp_path / "twal"), LogConfig(fsync="none"),
                    device="cpu", tracer=tracer, telemetry=tel)
        app, server, worker = _drive(cls, cfg, rows, tx, ty, ITERS,
                                     tracer=tracer, telemetry=tel, **kw)
        if durable:
            kw["fabric"].close()
        out.append((app, tracer, tel, _split(server), _split(worker)))
    return out


@pytest.mark.parametrize("task,c,gang,durable", [
    ("logreg", 0, True, False), ("logreg", 2, True, False),
    ("logreg", -1, True, False), ("logreg", 0, False, False),
    ("mlp", 0, True, False), ("logreg", 0, True, True)])
def test_counters_equal_the_jax_run(task, c, gang, durable, tmp_path):
    (japp, jtr, jtel, js, jw), (tapp, ttr, ttel, ts, tw) = _pair(
        task, c, gang, durable, tmp_path)
    ours, ref = _states(ttel), _states(jtel)
    # the same families, and in each the same label sets
    assert {n: set(v) for n, v in ours.items()} == \
        {n: set(v) for n, v in ref.items()}
    for name in EXACT:
        if name in ref:
            assert ours[name] == ref[name], name
    for name in TIMED:
        if name in ref:
            assert {k: v[2] for k, v in ours[name].items()} == \
                {k: v[2] for k, v in ref[name].items()}, name
    assert {k: v[1] for k, v in ours[WIDTHS].items()} == \
        {k: v[1] for k, v in ref[WIDTHS].items()}
    # the tracer's host-decision counters: dispatch.device, server.*,
    # data.* (and the fabric's and the gang's) equal exactly
    jc, tc = jtr.counters(), ttr.counters()
    decisions = {n for n in jc if n.startswith(
        ("dispatch.", "server.", "data.", "send.", "gang.", "log.appends",
         "serving."))}
    assert decisions and {n: tc.get(n) for n in decisions} == \
        {n: jc[n] for n in decisions}
    assert set(tc) == set(jc)
    sum_grads = sum(ours["gradients_applied_total"].values())
    assert sum_grads == tapp.server.iterations == ITERS
    # the runs themselves agree as the parity tests hold them
    assert [r[1:3] for r in ts] == [r[1:3] for r in js]
    assert [r[1:3] + r[6:] for r in tw] == [r[1:3] + r[6:] for r in jw]
    np.testing.assert_allclose(tapp.server.theta.numpy(),
                               np.asarray(japp.server.theta),
                               rtol=RTOL, atol=ATOL)
    for a, b in zip(ts + tw, js + jw):
        np.testing.assert_allclose(float(a[3]), float(b[3]), rtol=RTOL,
                                   atol=ATOL)


# -- the CLI ----------------------------------------------------------------

FLAGS = ("--status_every", "0.1", "--trace", "trace.json",
         "--metrics-file", "metrics.prom", "--metrics-every", "0.2",
         "--flight-dir", "flight", "--health-port", "0",
         "--device_trace", "dtrace", "--profile", "--model-health",
         "--slo-serving-p99-ms", "50", "--slo-freshness-ms", "1000")


def _keys(block: str) -> set:
    return {tok.split("=", 1)[0] for tok in block.split(" ")
            if tok and not tok.startswith("(+")}


def _status_keys(lines):
    """(keys before the metrics block, keys of the metrics block, of the
    critpath block, of the modelhealth block) over the [status] lines.
    Which histograms have a `_p50`/`_n` pair in a line depends on what
    was observed by then (in the critpath block: in that window), so
    those keys are held to family and segment names, not compared line
    by line."""
    head, metrics, crit, health = set(), set(), set(), set()
    for line in lines:
        body, _, mh = line[len("[status] "):].partition(" modelhealth ")
        body, _, cp = body.partition(" critpath ")
        before, _, block = body.partition(" metrics ")
        head |= _keys(before)
        metrics |= _keys(block)
        crit |= _keys(cp)
        health |= _keys(mh)
    return head, metrics, crit, health


def test_cli_runs_with_every_telemetry_flag_as_the_jax_cli(tmp_path):
    from kafka_ps_tpu_torch.data.synth import generate, write_csv
    x, y = generate(800, 16, 3, seed=0)
    for sub in ("port", "jax"):
        (tmp_path / sub).mkdir()
        write_csv(str(tmp_path / sub / "train.csv"), x[:512], y[:512])
        write_csv(str(tmp_path / sub / "test.csv"), x[512:], y[512:])
    args = ["-training", "train.csv", "-test", "test.csv",
            "--num_features", "16", "--num_classes", "3", "-c", "0",
            "-p", "0", "-l", "--mode", "serial", "--max_iterations", "240",
            *FLAGS]
    env = dict(os.environ, PYTHONPATH=REPO, KPS_PLATFORM="cpu",
               JAX_PLATFORMS="cpu", MKL_CBWR="COMPATIBLE",
               OMP_NUM_THREADS="1")
    jproc = subprocess.Popen(
        [sys.executable, "-m", "kafka_ps_tpu.cli.run", *args],
        cwd=tmp_path / "jax", env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kafka_ps_tpu_torch.cli.run", *args],
        cwd=tmp_path / "port", env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        err, healthz, planes = [], None, {}
        for line in proc.stderr:
            err.append(line)
            m = re.match(r"health plane on port (\d+)", line)
            if m and healthz is None:
                # answered while the run is going
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{m.group(1)}/healthz",
                        timeout=10) as r:
                    healthz = (r.status, json.loads(r.read()))
                for path in ("/profilez", "/modelz"):
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{m.group(1)}{path}",
                            timeout=10) as r:
                        planes[path] = (r.status, r.read().decode())
        assert proc.wait(timeout=300) == 0, "".join(err)
        jerr = jproc.communicate(timeout=300)[1]
        assert jproc.returncode == 0, jerr
    finally:
        proc.kill()
        jproc.kill()
    assert healthz[0] == 200 and healthz[1]["healthy"] is True
    assert healthz[1]["role"] == "run" and {"gate", "slo", "drift"} <= \
        set(healthz[1]["watchdogs"])
    assert set(healthz[1]["slo"]) == {"serving_availability",
                                      "serving_latency",
                                      "snapshot_freshness", "model_health"}
    assert planes["/profilez"][0] == planes["/modelz"][0] == 200
    assert "# samples: " in planes["/profilez"][1]
    assert json.loads(planes["/modelz"][1])["drift"]["detector"] == "ph"
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    # [status] lines: rising iters, the JAX keys
    status = [ln.rstrip("\n") for ln in err if ln.startswith("[status] ")]
    jstatus = [ln for ln in jerr.splitlines() if ln.startswith("[status] ")]
    iters = [int(ln.split()[1].split("=")[1]) for ln in status]
    assert len(iters) >= 2 and iters == sorted(iters) and iters[-1] > 0
    (head, metrics, crit, health), (jhead, _, jcrit, jhealth) = \
        _status_keys(status), _status_keys(jstatus)
    assert head == jhead and {"iters", "clocks", "pending", "eval_lag"} <= head
    assert all(" critpath " in ln and " modelhealth " in ln
               for ln in status)
    assert health == jhealth and {"updates", "norm", "cos", "drift"} <= \
        health
    assert "dominant" in crit and "dominant" in jcrit
    assert {re.sub(r"_(p50|n)$", "", k) for k in crit | jcrit} <= {
        "dominant", "gate_wait", "local_train", "staleness", "serving"}
    # the metrics file: the JAX CLI's families
    types = [dict(re.findall(r"^# TYPE (\S+) (\S+)", (d / "metrics.prom")
                             .read_text(), re.M))
             for d in (port_dir, jax_dir)]
    assert types[0] == types[1] and "gate_wait_ms" in types[0]
    # the [status] summary: every counter and gauge family, and the
    # histograms' p50 and count under their family's name
    plain = {n for n, kind in types[1].items() if kind != "histogram"}
    assert plain <= metrics
    assert {re.sub(r"_(p50|n)$", "", k) for k in metrics - plain} <= \
        set(types[1]) - plain
    # the trace: spans and counters, the stats printed after its path
    trace = json.loads((port_dir / "trace.json").read_text())
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    assert {"worker.local_update", "server.apply", "server.eval",
            "gate.wait"} <= names
    assert trace["counters"]["server.gradients_applied"] == 240
    assert "wallClockT0" in trace
    stats_at = next(i for i, ln in enumerate(err) if ln.strip()
                    .endswith("trace.json"))
    assert '"spans"' in "".join(err[stats_at:])
    # the flight dump at clean exit
    (dump,) = (port_dir / "flight").glob("flightdump-*.json")
    d = json.loads(dump.read_text())
    assert d["schema"] == "kps-flightdump-v1" and d["reason"] == "shutdown"
    assert {"gate.arrive", "gate.release"} <= {e["kind"]
                                               for e in d["events"]}
    assert d["watchdogs"]["gate"]["trip_count"] == 0
    assert d["profile"] and all(line.rpartition(" ")[2].isdigit()
                                for line in d["profile"])
    # the drift log's header (no verdict on this clean stream)
    assert (port_dir / "logs-drift.csv").read_text() == \
        (jax_dir / "logs-drift.csv").read_text()
    # the device trace (CPU activity only here)
    (dt,) = (port_dir / "dtrace").glob("devicetrace-*.json")
    assert any(e.get("cat") == "cpu_op"
               for e in json.loads(dt.read_text())["traceEvents"])
    # the stats line still closes the run
    assert err[-1].startswith("kafka_ps_tpu_torch run: ")


@pytest.mark.parametrize("runner,argv", [
    ("server_runner", ["--listen", "0", "--device_trace", "d"]),
    ("worker_runner", ["--connect", "127.0.0.1:1", "--device_trace", "d"]),
    ("agg_runner", ["--connect", "127.0.0.1:1", "--metrics-file", "m",
                    "--device_trace", "d"])])
def test_role_runners_refuse_the_device_trace(runner, argv):
    """The JAX roles parse --device_trace and record nothing: the port's
    runners refuse it by name (the other telemetry flags they take,
    tests/test_torch_role_telemetry_runs.py)."""
    import importlib
    mod = importlib.import_module(f"kafka_ps_tpu_torch.cli.{runner}")
    with pytest.raises(SystemExit) as e:
        mod.main(argv)
    msg = str(e.value.code)
    assert msg.startswith("--device_trace: the role runners take no "
                          "device trace, as in the JAX package")
    assert "ROADMAP" not in msg and "--metrics-file" not in msg
