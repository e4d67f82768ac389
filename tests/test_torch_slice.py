"""The port's trainer end to end on the CPU: parity with kafka_ps_tpu on
the same rows, the threaded driver, the CLI, the import boundary and the
device rule.

Parity tolerances (float32, different summation orders, compounded over
the run's iterations): loss and theta rtol=1e-4, atol=1e-5; F1 and
accuracy within 1/len(test), one flipped argmax of a near tie.
"""

import json
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import kafka_ps_tpu_torch
from kafka_ps_tpu.data.synth import generate
from kafka_ps_tpu.evaluation.logs import load_server_log, load_worker_log
from kafka_ps_tpu.evaluation.validate import validate_run
from kafka_ps_tpu.models import logreg as jlogreg
from kafka_ps_tpu.runtime.app import StreamingPSApp as JApp
from kafka_ps_tpu.utils import config as jconfig
from kafka_ps_tpu_torch.cli import run as cli_run
from kafka_ps_tpu_torch.data.synth import write_csv
from kafka_ps_tpu_torch.evaluation import validate as port_validate
from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
from kafka_ps_tpu_torch.utils import config
from kafka_ps_tpu_torch.utils.csvlog import (SERVER_HEADER, WORKER_HEADER,
                                             CsvLogSink)
from kafka_ps_tpu_torch.weights import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, C, W = 64, 5, 3
RTOL, ATOL = 1e-4, 1e-5
POLICY = dict(min_size=8, max_size=32, coefficient=0.3, arrival_window=20)


def _configs(mod, c, task="logreg", **kw):
    model = mod.ModelConfig(num_features=F, num_classes=C, hidden_dim=24)
    buf = mod.BufferConfig(**POLICY)
    # the reference runs the per-message path with fused apply+eval; the
    # port runs its defaults, gang dispatch and async eval, which give
    # its per-message results bit for bit (tests/test_torch_gang.py,
    # tests/test_torch_eval_engine.py)
    if mod is jconfig:
        kw.update(use_gang=False, eval_async=False)
    return mod.PSConfig(num_workers=W, consistency_model=c, model=model,
                        buffer=buf, task=task, **kw)


def _data(n_train=260, n_test=90):
    x, y = generate(n_train + n_test, F, C, noise=2.0, seed=5,
                    center_scale=0.3)
    rows = [({j: float(v) for j, v in enumerate(r) if v != 0.0}, int(lbl))
            for r, lbl in zip(x[:n_train], y[:n_train])]
    return rows, x[n_train:], y[n_train:]


def _clock():
    # arrival gaps that move the buffer target up and down
    gaps = [30.0] * 40 + [900.0] * 30 + [20.0] * 50
    state = {"t": 0.0, "i": 0}

    def clock_ms():
        state["t"] += gaps[state["i"] % len(gaps)]
        state["i"] += 1
        return state["t"]
    return clock_ms


def _drive(app_cls, cfg, rows, tx, ty, iters, theta0=None, **kw):
    server, worker = [], []
    app = app_cls(cfg, test_x=tx, test_y=ty, server_log=server.append,
                  worker_log=worker.append, clock_ms=_clock(), **kw)
    if theta0 is not None:
        app.server.theta = theta0      # before start_training_loop
    prefill = 40 * W
    for i, (feats, label) in enumerate(rows[:prefill]):
        app.data_sink(i % W, feats, label)
    tail = iter(enumerate(rows[prefill:], start=prefill))

    def pump():       # one more stream row between scheduling rounds
        nxt = next(tail, None)
        if nxt is not None:
            app.data_sink(nxt[0] % W, *nxt[1])
    app.run_serial(iters, pump=pump)
    app.close_logs()
    return app, server, worker


def _split(lines):
    return [line.split(";") for line in lines]


@pytest.mark.parametrize("c", [0, 2, -1])
def test_serial_run_matches_reference(c):
    rows, tx, ty = _data()
    iters = 36
    japp, js, jw = _drive(JApp, _configs(jconfig, c), rows, tx, ty, iters)
    tapp, ts, tw = _drive(StreamingPSApp, _configs(config, c), rows, tx, ty,
                          iters, device="cpu")
    js, jw, ts, tw = map(_split, (js, jw, ts, tw))
    assert len(ts) == len(js) > 0 and len(tw) == len(jw) >= iters
    # host decisions: partition, vector clock, numTuplesSeen — exactly
    assert [r[1:3] for r in ts] == [r[1:3] for r in js]
    assert [r[1:3] + r[6:] for r in tw] == [r[1:3] + r[6:] for r in jw]
    tol = 1.0 / len(ty)
    for ours, ref in zip(ts + tw, js + jw):
        np.testing.assert_allclose(float(ours[3]), float(ref[3]),
                                   rtol=RTOL, atol=ATOL)       # loss
        assert abs(float(ours[4]) - float(ref[4])) <= tol       # F1
        assert abs(float(ours[5]) - float(ref[5])) <= tol       # accuracy
    assert tapp.server.iterations == japp.server.iterations == iters
    np.testing.assert_allclose(tapp.server.theta.numpy(),
                               np.asarray(japp.server.theta),
                               rtol=RTOL, atol=ATOL)
    # the stream kept arriving during training: the slab took the
    # incremental path
    assert any(w._slab_store.incremental_applies for w in tapp.workers)


@pytest.mark.parametrize("c", [0, -1])
def test_serial_mlp_run_matches_reference(c):
    """The MLP app from the JAX package's θ₀ (its PRNGKey(0) He init,
    carried across as the parity contract asks)."""
    rows, tx, ty = _data()
    iters = 36
    jcfg, cfg = _configs(jconfig, c, "mlp"), _configs(config, c, "mlp")
    jtheta0 = np.asarray(JApp(jcfg).server.theta)
    japp, js, jw = _drive(JApp, jcfg, rows, tx, ty, iters,
                          theta0=jtheta0)
    tapp, ts, tw = _drive(StreamingPSApp, cfg, rows, tx, ty, iters,
                          theta0=from_jax_params(jtheta0, cfg.model, "cpu",
                                                 task="mlp"),
                          device="cpu")
    js, jw, ts, tw = map(_split, (js, jw, ts, tw))
    assert len(ts) == len(js) > 0 and len(tw) == len(jw) >= iters
    assert [r[1:3] for r in ts] == [r[1:3] for r in js]
    assert [r[1:3] + r[6:] for r in tw] == [r[1:3] + r[6:] for r in jw]
    tol = 1.0 / len(ty)
    for ours, ref in zip(ts + tw, js + jw):
        np.testing.assert_allclose(float(ours[3]), float(ref[3]),
                                   rtol=RTOL, atol=ATOL)       # loss
        assert abs(float(ours[4]) - float(ref[4])) <= tol       # F1
        assert abs(float(ours[5]) - float(ref[5])) <= tol       # accuracy
    np.testing.assert_allclose(tapp.server.theta.numpy(),
                               np.asarray(japp.server.theta),
                               rtol=RTOL, atol=ATOL)
    assert tapp.gang.dispatches > 0 and tapp.eval_engine is not None


@pytest.mark.parametrize("c", [0, 2, -1])
def test_threaded_run_keeps_the_clock_protocol(c, tmp_path):
    rows, tx, ty = _data()
    s_path, w_path = tmp_path / "server.csv", tmp_path / "worker.csv"
    app = StreamingPSApp(
        _configs(config, c), test_x=tx, test_y=ty,
        server_log=CsvLogSink(str(s_path), SERVER_HEADER),
        worker_log=CsvLogSink(str(w_path), WORKER_HEADER), device="cpu")
    for i, (feats, label) in enumerate(rows):
        app.data_sink(i % W, feats, label)
    iters = 30
    app.run_threaded(iters)
    app.close_logs()
    assert app.server.iterations == iters
    wdf, sdf = load_worker_log(str(w_path)), load_server_log(str(s_path))
    assert len(wdf) >= iters and len(sdf) >= 1
    for _, g in wdf.groupby("partition"):
        clocks = g["vectorClock"].tolist()
        assert clocks == list(range(clocks[0], clocks[0] + len(clocks)))
    assert sdf["vectorClock"].is_monotonic_increasing
    assert np.isfinite(wdf[["loss", "fMeasure", "accuracy"]].values).all()
    assert validate_run(wdf, sdf, c) == []
    assert port_validate.validate_run(wdf, sdf, c) == []


@pytest.mark.parametrize("mode,c", [("serial", 0), ("threaded", -1)])
def test_cli_runs_on_cpu(mode, c, tmp_path, monkeypatch):
    x, y = generate(300, 16, 3, seed=1)
    write_csv(str(tmp_path / "train.csv"), x[:240], y[:240])
    write_csv(str(tmp_path / "test.csv"), x[240:], y[240:])
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("KPS_PLATFORM", "cpu")
    rc = cli_run.main(["-training", "train.csv", "-test", "test.csv",
                       "--num_features", "16", "--num_classes", "3",
                       "--num_workers", "2", "-c", str(c), "-p", "0", "-l",
                       "-min", "8", "-max", "32", "--mode", mode,
                       "--max_iterations", "12", "--no-gang",
                       "--no-eval-async"])
    assert rc == 0
    server = (tmp_path / "logs-server.csv").read_text().splitlines()
    worker = (tmp_path / "logs-worker.csv").read_text().splitlines()
    assert server[0] == SERVER_HEADER and worker[0] == WORKER_HEADER
    assert len(worker) - 1 >= 12 and len(server) - 1 >= 1
    for line in worker[1:]:
        fields = line.split(";")
        assert len(fields) == 7 and "tensor" not in line
        assert all(np.isfinite(float(v)) for v in fields[3:6])


@pytest.mark.parametrize("mode,c,task", [("serial", 0, "logreg"),
                                         ("threaded", 2, "logreg"),
                                         ("serial", 0, "mlp"),
                                         ("threaded", -1, "mlp")])
def test_cli_default_flags_run_gang_and_async_eval(mode, c, task, tmp_path,
                                                   monkeypatch, capsys):
    x, y = generate(300, 16, 3, seed=1)
    write_csv(str(tmp_path / "train.csv"), x[:240], y[:240])
    write_csv(str(tmp_path / "test.csv"), x[240:], y[240:])
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("KPS_PLATFORM", "cpu")
    rc = cli_run.main(["-training", "train.csv", "-test", "test.csv",
                       "--num_features", "16", "--num_classes", "3",
                       "--num_workers", "2", "-c", str(c), "-p", "0", "-l",
                       "-min", "8", "-max", "32", "--mode", mode,
                       "--max_iterations", "12", "--task", task,
                       "--hidden_dim", "8"])
    assert rc == 0
    err = capsys.readouterr().err
    stats = [line for line in err.splitlines()
             if line.startswith("kafka_ps_tpu_torch run: ")]
    assert len(stats) == 1 and "not ported" not in err
    stats = json.loads(stats[0].split(": ", 1)[1])
    assert stats["server_iterations"] == 12
    assert stats["eval"]["lag_clocks"] == 0 and stats["eval"]["evals"] > 0
    assert "gang" in stats
    if mode == "serial":
        assert stats["gang"]["dispatches"] > 0
    server = (tmp_path / "logs-server.csv").read_text().splitlines()
    worker = (tmp_path / "logs-worker.csv").read_text().splitlines()
    assert len(worker) - 1 >= 12 and len(server) - 1 == stats["eval"]["evals"]
    for line in worker[1:] + server[1:]:
        assert "tensor" not in line
        assert all(np.isfinite(float(v)) for v in line.split(";")[3:6])


def test_cli_flags_reach_the_config():
    args = cli_run.build_parser().parse_args([])
    assert (args.task, args.hidden_dim, args.no_gang, args.eval_async) == \
        ("logreg", 128, False, True)
    args = cli_run.build_parser().parse_args(
        ["--task", "mlp", "--hidden_dim", "7", "--no-gang",
         "--no-eval-async"])
    assert (args.task, args.hidden_dim, args.no_gang, args.eval_async) == \
        ("mlp", 7, True, False)


def test_from_jax_params_round_trips():
    cfg = config.ModelConfig(num_features=F, num_classes=C)
    jcfg = jconfig.ModelConfig(num_features=F, num_classes=C)
    rng = np.random.default_rng(0)
    theta = np.asarray(jlogreg.init_params(jcfg).flat) + rng.normal(
        size=jcfg.num_params).astype(np.float32)
    t = from_jax_params(theta, cfg, "cpu")
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), theta)
    w = jlogreg.unflatten(theta, jcfg).weights
    from kafka_ps_tpu_torch.models.logreg import unflatten
    np.testing.assert_array_equal(unflatten(t, cfg).weights.numpy(),
                                  np.asarray(w))
    with pytest.raises(ValueError):
        from_jax_params(theta[:-1], cfg, "cpu")
    with pytest.raises(TypeError):
        from_jax_params(theta.astype(np.float64), cfg, "cpu")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        kafka_ps_tpu_torch.__path__, "kafka_ps_tpu_torch."))


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = _port_modules()
    for m in ("ops.fused_update", "models.mlp", "runtime.gang",
              "evaluation.engine", "parallel.bsp", "native.binding",
              "runtime.wire", "runtime.net", "cli.socket_mode",
              "cli.server_runner", "cli.worker_runner",
              "runtime.sharding", "agg", "agg.core", "agg.relay",
              "cli.agg_runner", "serving", "serving.policy",
              "serving.snapshot", "serving.costmodel", "serving.engine",
              "serving.shm", "serving.replica", "serving.loadgen",
              "utils.trace", "store", "store.cold", "store.tiered",
              "utils.status", "telemetry", "telemetry.registry",
              "telemetry.flight", "telemetry.health", "evaluation",
              "evaluation.logs", "evaluation.validate", "evaluation.plots",
              "evaluation.ground_truth", "evaluation.__main__",
              "parallel.mesh", "parallel.multihost",
              "parallel.range_sharded", "analysis", "analysis.__main__",
              "analysis.lockgraph", "analysis.pytest_plugin",
              "analysis.pscheck", "analysis.program", "analysis.threadck",
              "analysis.lockflow", "analysis.wireck", "analysis.psverify"):
        assert f"kafka_ps_tpu_torch.{m}" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'kafka_ps_tpu' or "
            "m.startswith('kafka_ps_tpu.'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_port_sources_have_no_import_of_the_jax_package():
    pattern = re.compile(r"^\s*(from|import)\s+kafka_ps_tpu(\.|\s|$)")
    jax_pattern = re.compile(r"^\s*(from|import)\s+jax(\.|\s|$)")
    root = os.path.dirname(kafka_ps_tpu_torch.__file__)
    offenders = []
    for dirpath, _, files in os.walk(root):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                for n, line in enumerate(f, 1):
                    if pattern.match(line) or jax_pattern.match(line):
                        offenders.append(f"{path}:{n}: {line.strip()}")
    assert offenders == []
    # the scan tells the packages apart
    assert pattern.match("from kafka_ps_tpu.models import logreg")
    assert pattern.match("import kafka_ps_tpu")
    assert not pattern.match("from kafka_ps_tpu_torch.models import logreg")


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch,
                                                      tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("KPS_PLATFORM", raising=False)
    cfg = _configs(config, 0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        StreamingPSApp(cfg)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        config.resolve_device()
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli_run.main(["--num_features", str(F)])
    assert StreamingPSApp(cfg, device="cpu").device.type == "cpu"
    monkeypatch.setenv("KPS_PLATFORM", "cpu")
    assert config.resolve_device().type == "cpu"
    assert StreamingPSApp(cfg).device.type == "cpu"
    monkeypatch.setenv("KPS_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="KPS_PLATFORM"):
        config.resolve_device()


def test_threaded_stress_more_workers_than_cores(tmp_path, monkeypatch):
    """16 worker threads under a tiny switch interval: every gradient is
    applied once, every worker's clocks step by one, the log keeps the
    staleness bound (lost updates or reordered rows would break these)."""
    import threading
    from kafka_ps_tpu_torch.utils import asynclog

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers, iters = 16, 96
        model = config.ModelConfig(num_features=16, num_classes=3)
        cfg = config.PSConfig(num_workers=workers, consistency_model=1,
                              model=model,
                              buffer=config.BufferConfig(min_size=4,
                                                         max_size=8))
        x, y = generate(workers * 6 + 40, 16, 3, seed=4)
        w_path = tmp_path / "worker.csv"
        app = StreamingPSApp(cfg, test_x=x[-40:], test_y=y[-40:],
                             worker_log=CsvLogSink(str(w_path),
                                                   WORKER_HEADER),
                             device="cpu")
        for i in range(workers * 6):
            app.data_sink(i % workers, x[i], int(y[i]))
        app.run_threaded(iters)
        app.close_logs()
        assert app.server.iterations == iters
        wdf = load_worker_log(str(w_path))
        assert validate_run(wdf, None, 1) == []
        assert port_validate.validate_run(wdf, None, 1) == []
        assert sorted(wdf.groupby("partition").size().index) == list(
            range(workers))

        # the sink alone: rows from many threads, each once, each
        # thread's rows in its own order
        lines = []
        monkeypatch.setattr(asynclog, "DRAIN_INTERVAL_S", 0.001)
        sink = asynclog.DeferredSink(lines.append)

        def writer(t):
            for i in range(200):
                sink.submit(f"{t};{i};{{}}", torch.tensor(float(i)))
        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        sink.close()
        assert len(lines) == 12 * 200
        for t in range(12):
            mine = [line.split(";") for line in lines
                    if line.startswith(f"{t};")]
            assert [int(m[1]) for m in mine] == list(range(200))
            assert all(float(m[2]) == int(m[1]) for m in mine)
    finally:
        sys.setswitchinterval(old)


def test_deferred_sink_keeps_rows_when_a_fetch_fails(monkeypatch):
    """A fetch that raises in the drain thread puts its rows back: the
    close that follows writes every row once, in submit order."""
    import threading
    from kafka_ps_tpu_torch.utils import asynclog

    real_fetch, failed = asynclog._fetch, threading.Event()

    def flaky_fetch(tensors):
        if not failed.is_set():
            failed.set()
            raise RuntimeError("injected fetch failure")
        return real_fetch(tensors)

    monkeypatch.setattr(asynclog, "_fetch", flaky_fetch)
    monkeypatch.setattr(asynclog, "DRAIN_INTERVAL_S", 0.001)
    lines = []
    sink = asynclog.DeferredSink(lines.append)
    for i in range(50):
        sink.submit(f"{i};{{}}", torch.tensor(float(i)))
    assert failed.wait(timeout=30)
    sink.close()
    assert lines == [f"{i};{float(i)}" for i in range(50)]


def test_app_without_log_sinks_discards_rows():
    from kafka_ps_tpu_torch.utils.csvlog import NullLogSink

    sink = NullLogSink()
    sink("a;b")
    sink.close()
    rows, tx, ty = _data(n_train=120, n_test=30)
    app = StreamingPSApp(_configs(config, 0), test_x=tx, test_y=ty,
                         device="cpu")
    for i, (feats, label) in enumerate(rows):
        app.data_sink(i % W, feats, label)
    app.run_serial(6)
    app.close_logs()
    assert app.server.iterations == 6
