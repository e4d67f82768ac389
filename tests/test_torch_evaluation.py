"""The port's offline evaluation tools (kafka_ps_tpu_torch/evaluation/:
logs.py, validate.py, plots.py, ground_truth.py and the CLI) against the
JAX package's on the same CSVs, written by each package: an elastic run
(a worker evicted and readmitted, logs-events.csv), the same run's
worker log with a lost iteration (violations), and a drift log.

Tables, summaries and violation lists must equal the JAX tools' exactly,
and the CLIs' stdout and exit codes too.  The ground-truth fit: theta
within rtol 1e-4, atol 1e-5 of the JAX fit (float32 full-batch steps
summed in other orders), F1 and accuracy within 1/len(test), the report
text equal on this seed.  Plots are written (no pixel check).  The
trainer's path imports no pandas, matplotlib or sklearn.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from kafka_ps_tpu.data.synth import generate
from kafka_ps_tpu.evaluation import __main__ as jcli
from kafka_ps_tpu.evaluation import ground_truth as jgt
from kafka_ps_tpu.evaluation import logs as jlogs
from kafka_ps_tpu.evaluation import validate as jvalidate
from kafka_ps_tpu.runtime.app import StreamingPSApp as JApp
from kafka_ps_tpu.utils import config as jconfig
from kafka_ps_tpu.utils import csvlog as jcsvlog
from kafka_ps_tpu_torch import evaluation
from kafka_ps_tpu_torch.data.synth import write_csv
from kafka_ps_tpu_torch.evaluation import __main__ as cli
from kafka_ps_tpu_torch.evaluation import ground_truth, logs, plots, validate
from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
from kafka_ps_tpu_torch.utils import config, csvlog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, F, C = 3, 16, 3
SOURCES = ["port", "jax"]


def _elastic_run(pkg: str, d: str) -> dict:
    """A serial -c 0 run of `pkg`'s app, worker 1 evicted and readmitted
    on the way, its server, worker and events logs under `d`."""
    mod, app_cls, sinks = ((config, StreamingPSApp, csvlog) if pkg == "port"
                           else (jconfig, JApp, jcsvlog))
    kw = {"device": "cpu"} if pkg == "port" else {}
    cfg = mod.PSConfig(
        num_workers=W, consistency_model=0,
        model=mod.ModelConfig(num_features=F, num_classes=C),
        buffer=mod.BufferConfig(min_size=4, max_size=16),
        **({"use_gang": False, "eval_async": False} if pkg == "jax"
           else {}))
    x, y = generate(160, F, C, noise=1.0, seed=2)
    paths = {k: os.path.join(d, f"logs-{k}.csv")
             for k in ("server", "worker", "events")}
    server = sinks.CsvLogSink(paths["server"], sinks.SERVER_HEADER)
    worker = sinks.CsvLogSink(paths["worker"], sinks.WORKER_HEADER)
    events = sinks.CsvLogSink(paths["events"], sinks.EVENTS_HEADER)
    app = app_cls(cfg, test_x=x[-40:], test_y=y[-40:], server_log=server,
                  worker_log=worker, **kw)
    app.server.membership_log = events
    rows = [({j: float(v) for j, v in enumerate(r) if v}, int(lbl))
            for r, lbl in zip(x[:120], y[:120])]
    for i, row in enumerate(rows[:48]):
        app.data_sink(i % W, *row)
    app.run_serial(12, pump=lambda: None)
    app.server.remove_worker(1)
    for i, row in enumerate(rows[48:84]):
        app.data_sink(i % W, *row)
    app.run_serial(30, pump=lambda: None)
    app.readmit_worker(1)
    for i, row in enumerate(rows[84:]):
        app.data_sink(i % W, *row)
    app.run_serial(60, pump=lambda: None)
    if pkg == "port":
        app.close_logs()
    else:
        app.flush_logs()
    for sink in (server, worker, events):
        sink.close()
    # the same worker log with a lost iteration of worker 0
    lines = open(paths["worker"]).read().splitlines()
    lost = next(i for i, line in enumerate(lines[1:], 1)
                if line.split(";")[1:3] == ["0", "5"])
    paths["lossy"] = os.path.join(d, "logs-worker-lossy.csv")
    with open(paths["lossy"], "w") as f:
        f.write("\n".join(lines[:lost] + lines[lost + 1:]) + "\n")
    paths["drift"] = os.path.join(d, "logs-drift.csv")
    drift = sinks.CsvLogSink(paths["drift"], sinks.DRIFT_HEADER)
    stamps = pd.read_csv(paths["server"], sep=";")["timestamp"].tolist()
    for ts, event, stat in ((stamps[3], "warn", 1.25),
                            (stamps[5], "trip", 2.5),
                            (stamps[9] + 1, "trip", 3.75)):
        drift(f"{ts};{event};ph;{stat};loss")
    drift.close()
    return paths


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {pkg: _elastic_run(pkg, str(tmp_path_factory.mktemp(pkg)))
            for pkg in SOURCES}


LOADERS = [("server", "load_server_log"), ("worker", "load_worker_log"),
           ("lossy", "load_worker_log"), ("drift", "load_drift_log")]


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("kind,loader", LOADERS)
def test_loaders_equal_the_jax_ones(runs, source, kind, loader):
    path = runs[source][kind]
    ours, ref = getattr(logs, loader)(path), getattr(jlogs, loader)(path)
    pd.testing.assert_frame_equal(ours, ref)
    assert len(ours) > 0


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("with_worker", [False, True])
def test_summaries_equal_the_jax_ones(runs, source, with_worker):
    p = runs[source]
    wdf = logs.load_worker_log(p["worker"]) if with_worker else None
    ours = logs.summarize_run(logs.load_server_log(p["server"]), wdf,
                              f1_targets=(0.3, 0.6, 0.99))
    ref = jlogs.summarize_run(jlogs.load_server_log(p["server"]), wdf,
                              f1_targets=(0.3, 0.6, 0.99))
    assert ours.row() == ref.row()


def test_compare_runs_equals_the_jax_table(runs):
    named = {pkg: runs[pkg]["server"] for pkg in SOURCES}
    pd.testing.assert_frame_equal(logs.compare_runs(named),
                                  jlogs.compare_runs(named))


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("fn", ["tuples_seen_curve", "worker_clock_spread"])
def test_worker_curves_equal_the_jax_ones(runs, source, fn):
    wdf = jlogs.load_worker_log(runs[source]["worker"])
    pd.testing.assert_frame_equal(getattr(logs, fn)(wdf),
                                  getattr(jlogs, fn)(wdf))


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("empty", [False, True])
def test_drift_events_equal_the_jax_join(runs, source, empty):
    sdf = jlogs.load_server_log(runs[source]["server"])
    ddf = jlogs.load_drift_log(runs[source]["drift"])
    if empty:
        ddf = ddf.iloc[:0]
    ours = logs.with_drift_events(sdf, ddf)
    pd.testing.assert_frame_equal(ours, jlogs.with_drift_events(sdf, ddf))
    assert ours["drift_events"].max() == (0 if empty else 2)


def _violations(mod, paths, worker, c, elastic, events, server=True):
    lmod = logs if mod is validate else jlogs
    wdf = lmod.load_worker_log(paths[worker])
    sdf = lmod.load_server_log(paths["server"]) if server else None
    ev = mod.load_membership_events(paths["events"]) if events else None
    return [(v.rule, v.detail) for v in
            mod.validate_run(wdf, sdf, c, elastic=elastic,
                             membership_events=ev)]


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("worker,c,elastic,events,server", [
    ("worker", 0, False, True, True),
    ("worker", 0, True, False, True),
    ("worker", 0, False, False, True),
    ("worker", -1, False, False, False),
    ("lossy", 0, False, True, True),
    ("lossy", 2, False, False, True),
    ("lossy", 0, True, False, False),
])
def test_violation_lists_equal_the_jax_ones(runs, source, worker, c,
                                            elastic, events, server):
    ours = _violations(validate, runs[source], worker, c, elastic, events,
                       server)
    ref = _violations(jvalidate, runs[source], worker, c, elastic, events,
                      server)
    assert ours == ref
    if worker == "worker" and events:
        assert ours == []            # the elastic run under its contract
    if worker == "lossy" and not elastic:
        assert ours != []            # the lost iteration


@pytest.mark.parametrize("source", SOURCES)
def test_membership_events_equal_the_jax_ones(runs, source):
    path = runs[source]["events"]
    ours = validate.load_membership_events(path)
    assert ours == jvalidate.load_membership_events(path)
    assert [k for _, k, _ in ours] == ["evict", "readmit"]


def test_plots_are_written(runs, tmp_path):
    p = runs["port"]
    outs = [plots.plot_run(p["server"], p["worker"],
                           str(tmp_path / "run.png")),
            plots.plot_run(p["server"], None, str(tmp_path / "srv.png")),
            plots.plot_comparison({k: runs[k]["server"] for k in SOURCES},
                                  str(tmp_path / "cmp.png")),
            plots.plot_clock_spread(p["worker"],
                                    str(tmp_path / "spread.png"))]
    for out in outs:
        assert os.path.getsize(out) > 1000
    pd.testing.assert_frame_equal(
        plots.comparison_table({"a": p["server"]}),
        logs.compare_runs({"a": p["server"]}))


def _run_cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _cli_cases(p):
    return [
        ["summarize", "--server", p["server"]],
        ["summarize", "--server", p["server"], "--worker", p["worker"]],
        ["compare", "--runs", f"a={p['server']}", f"b={p['server']}"],
        ["validate", "--worker", p["worker"], "--server", p["server"],
         "--events", p["events"]],
        ["validate", "--worker", p["worker"], "--server", p["server"]],
        ["validate", "--worker", p["worker"], "-c", "-1"],
        ["validate", "--worker", p["lossy"], "--server", p["server"],
         "-c", "2"],
        ["validate", "--worker", p["lossy"], "--elastic"],
    ]


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("case", range(8))
def test_cli_output_and_exit_codes_equal_the_jax_cli(runs, source, case):
    argv = _cli_cases(runs[source])[case]
    ours, ref = _run_cli(cli.main, argv), _run_cli(jcli.main, argv)
    assert ours == ref
    assert ours[1]


def test_cli_validate_exits_one_on_violations(runs):
    p = runs["port"]
    rc, out = _run_cli(cli.main, ["validate", "--worker", p["lossy"]])
    assert rc == 1 and "VIOLATION [" in out
    rc, out = _run_cli(cli.main, ["validate", "--worker", p["worker"],
                                  "--events", p["events"]])
    assert (rc, out) == (0, "0 violation(s)\n")


@pytest.mark.parametrize("argv,text", [
    (["validate"], "validate needs --worker and/or --server"),
    (["compare", "--runs", "nopath"], "--runs entries must be name=path"),
    (["plot", "--server", "s.csv", "--out", "o.png", "--spread-out",
      "x.png"], "--spread-out requires --worker"),
])
def test_cli_refusals_equal_the_jax_ones(argv, text):
    with pytest.raises(SystemExit) as ours:
        cli.main(argv)
    with pytest.raises(SystemExit) as ref:
        jcli.main(argv)
    assert str(ours.value) == str(ref.value)
    assert text in str(ours.value)


def test_cli_plot_writes_its_files(runs, tmp_path):
    p = runs["jax"]
    out, spread = str(tmp_path / "run.png"), str(tmp_path / "spread.png")
    rc, text = _run_cli(cli.main, ["plot", "--server", p["server"],
                                   "--worker", p["worker"], "--out", out,
                                   "--spread-out", spread])
    assert (rc, text) == (0, f"{out}\n{spread}\n")
    assert os.path.getsize(out) > 1000 and os.path.getsize(spread) > 1000
    cmp = str(tmp_path / "cmp.png")
    rc, text = _run_cli(cli.main, ["compare", "--runs",
                                   f"a={p['server']}", "--out", cmp])
    assert rc == 0 and text.endswith(f"{cmp}\n")
    assert os.path.getsize(cmp) > 1000


# -- ground truth -----------------------------------------------------------


GT_STEPS = 100


def _gt_data(seed=4, n_train=300, n_test=100):
    x, y = generate(n_train + n_test, F, C, noise=1.5, seed=seed)
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]


@pytest.fixture(scope="module")
def gt_pair():
    tx, ty, vx, vy = _gt_data()
    cfg = config.ModelConfig(num_features=F, num_classes=C)
    jcfg = jconfig.ModelConfig(num_features=F, num_classes=C)
    ours = ground_truth.compute(tx, ty, vx, vy, cfg, steps=GT_STEPS,
                                device="cpu")
    ref = jgt.compute(tx, ty, vx, vy, jcfg, steps=GT_STEPS)
    return ours, ref, len(vy)


def test_ground_truth_theta_matches_the_jax_fit(gt_pair):
    ours, ref, _ = gt_pair
    assert ours.theta.dtype == np.float32
    np.testing.assert_allclose(ours.theta, ref.theta, rtol=1e-4, atol=1e-5)
    assert np.abs(ours.theta).sum() > 0


def test_ground_truth_metrics_and_report_match_the_jax_ones(gt_pair):
    ours, ref, n = gt_pair
    assert abs(ours.f1 - ref.f1) <= 1.0 / n
    assert abs(ours.accuracy - ref.accuracy) <= 1.0 / n
    np.testing.assert_allclose(ours.loss, ref.loss, rtol=1e-4, atol=1e-5)
    assert ours.report == ref.report
    assert ours.f1 > 0.6


def test_ground_truth_follows_the_device_rule(monkeypatch):
    import torch
    tx, ty, _, _ = _gt_data()
    cfg = config.ModelConfig(num_features=F, num_classes=C)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("KPS_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ground_truth.train_offline(tx, ty, cfg, steps=1)
    monkeypatch.setenv("KPS_PLATFORM", "cpu")
    theta = ground_truth.train_offline(tx, ty, cfg, steps=3)
    assert np.array_equal(theta, ground_truth.train_offline(
        tx, ty, cfg, steps=3, device="cpu"))


def test_ground_truth_cli_equals_the_jax_cli(tmp_path, monkeypatch):
    monkeypatch.setenv("KPS_PLATFORM", "cpu")
    tx, ty, vx, vy = _gt_data()
    train, test = str(tmp_path / "train.csv"), str(tmp_path / "test.csv")
    write_csv(train, tx, ty)
    write_csv(test, vx, vy)
    argv = ["ground-truth", "--train", train, "--test", test, "--steps",
            str(GT_STEPS)]
    ours, ref = _run_cli(cli.main, argv), _run_cli(jcli.main, argv)
    assert ours == ref
    assert ours[0] == 0 and '"f1"' in ours[1]


# -- imports ----------------------------------------------------------------


def test_the_package_reexports_the_log_tools_lazily():
    assert evaluation.RunSummary is logs.RunSummary
    assert evaluation.summarize_run is logs.summarize_run
    assert evaluation.load_server_log is logs.load_server_log
    assert evaluation.load_worker_log is logs.load_worker_log
    with pytest.raises(AttributeError):
        evaluation.no_such_name


def test_the_trainer_path_imports_no_pandas_matplotlib_or_sklearn(tmp_path):
    code = """
import sys
import numpy as np
import kafka_ps_tpu_torch.evaluation
from kafka_ps_tpu_torch.evaluation.engine import EvalEngine
from kafka_ps_tpu_torch.cli import run
from kafka_ps_tpu_torch.data.synth import generate
from kafka_ps_tpu_torch.parallel import bsp, mesh, multihost, range_sharded
from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
from kafka_ps_tpu_torch.utils.config import BufferConfig, ModelConfig, PSConfig
cfg = PSConfig(num_workers=2, model=ModelConfig(num_features=8, num_classes=2),
               buffer=BufferConfig(min_size=4, max_size=16))
x, y = generate(60, 8, 2, seed=0)
app = StreamingPSApp(cfg, test_x=x[-10:], test_y=y[-10:], device="cpu")
for i in range(40):
    app.data_sink(i % 2, x[i], int(y[i]))
app.run_serial(10, pump=lambda: None)
app.close_logs()
assert app.server.iterations == 10
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("pandas", "matplotlib", "sklearn"))
assert not bad, bad
print("clean")
"""
    env = dict(os.environ, PYTHONPATH=REPO, KPS_PLATFORM="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "clean"
