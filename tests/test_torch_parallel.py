"""The port's fused BSP path (parallel/bsp.py, StreamingPSApp.run_fused_bsp,
cli.run --fused) on the CPU: against the port's own message-driven
sequential round, against the JAX package's fused path on the same
inputs, chunk against single rounds, the log cadence and the CLI's
rejections.

Tolerances (float32): the fused step against one message round of the
port, atol 2e-5 (tests/test_parallel.py's; the message path chains
theta + lr*delta per worker where the fused step adds the summed
deltas); against the JAX package, theta and losses rtol 1e-4, atol 1e-5
(PyTorch and XLA sum in different orders), F1 and accuracy within
1/len(test).  Inside the port a chunk of rounds is bitwise the same
rounds run one at a time.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kafka_ps_tpu.data.synth import generate
from kafka_ps_tpu.evaluation import validate
from kafka_ps_tpu.evaluation.logs import load_server_log, load_worker_log
from kafka_ps_tpu.models.task import get_task as jget_task
from kafka_ps_tpu.parallel import bsp as jbsp
from kafka_ps_tpu.runtime.app import StreamingPSApp as JApp
from kafka_ps_tpu.utils import config as jconfig
from kafka_ps_tpu_torch.cli import run as cli_run
from kafka_ps_tpu_torch.data.synth import write_csv
from kafka_ps_tpu_torch.models.task import get_task
from kafka_ps_tpu_torch.ops import fused_update
from kafka_ps_tpu_torch.parallel import bsp
from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
from kafka_ps_tpu_torch.utils import config
from kafka_ps_tpu_torch.weights import from_jax_params

F, C, W, H = 16, 3, 4, 12
RTOL, ATOL = 1e-4, 1e-5
MSG_ATOL = 2e-5
TASKS = ["logreg", "mlp"]


def _cfg(mod, task="logreg", c=0, eval_every=1, **kw):
    model = mod.ModelConfig(num_features=F, num_classes=C, hidden_dim=H,
                            local_learning_rate=0.5)
    if mod is jconfig:
        kw.update(use_gang=False, eval_async=False)
    return mod.PSConfig(num_workers=W, consistency_model=c, task=task,
                        model=model,
                        buffer=mod.BufferConfig(min_size=8, max_size=32),
                        eval_every=eval_every, **kw)


def _data(n_train=200, n_test=60, seed=0):
    x, y = generate(n_train + n_test, F, C, noise=1.0, sparsity=0.5,
                    seed=seed)
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]


def _rows(x, y):
    return [({j: float(v) for j, v in enumerate(r) if v != 0.0}, int(lbl))
            for r, lbl in zip(x, y)]


def _app(cls, cfg, rows, tx, ty, theta0=None, **kw):
    """An app whose buffers hold `rows` round-robin (arrival clock fixed,
    so both packages choose the same buffer slots)."""
    server, worker = [], []
    app = cls(cfg, test_x=tx, test_y=ty, server_log=server.append,
              worker_log=worker.append,
              clock_ms=iter(range(0, 10 ** 9, 40)).__next__, **kw)
    if theta0 is not None:
        app.server.theta = theta0
    for i, (feats, label) in enumerate(rows):
        app.data_sink(i % cfg.num_workers, feats, label)
    return app, server, worker


def _pair(task, eval_every=1, n_train=200, **kw):
    """The JAX app and the port's, same rows, the port's theta set to the
    JAX package's initial theta."""
    x, y, tx, ty = _data(n_train)
    rows = _rows(x, y)
    jcfg, cfg = _cfg(jconfig, task, eval_every=eval_every, **kw), \
        _cfg(config, task, eval_every=eval_every, **kw)
    japp = _app(JApp, jcfg, rows, tx, ty)
    theta0 = from_jax_params(np.asarray(japp[0].server.theta), cfg.model,
                             "cpu", task=task)
    tapp = _app(StreamingPSApp, cfg, rows, tx, ty, theta0=theta0,
                device="cpu")
    return japp, tapp, ty


def _stacked(app):
    snaps = [b.snapshot() for b in app.buffers]
    return [np.stack([s[i] for s in snaps]) for i in range(3)]


def _inputs(task, seed=3):
    """Seeded numpy inputs of both packages' BSP steps: theta, x [W, 32,
    F], y [W, 32] with one out-of-range label, mask with masked rows."""
    cfg = _cfg(config, task).model
    n = get_task(task, cfg).num_params
    rng = np.random.default_rng(seed)
    x, y = generate(W * 32, F, C, noise=1.0, seed=seed)
    y[5] = C + 2
    mask = (rng.random(W * 32) < 0.85).astype(np.float32)
    theta = rng.normal(scale=0.2, size=n).astype(np.float32)
    return (theta, x.reshape(W, 32, F), y.reshape(W, 32),
            mask.reshape(W, 32))


def _port(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# -- the fused step ---------------------------------------------------------------


@pytest.mark.parametrize("task", TASKS)
def test_fused_step_matches_one_message_round(task):
    """One fused step == one message-driven sequential round of the port
    (4 gradient messages)."""
    x, y, tx, ty = _data()
    rows = _rows(x, y)
    cfg = _cfg(config, task)
    msg, _, _ = _app(StreamingPSApp, cfg, rows, tx, ty, device="cpu")
    fused, _, _ = _app(StreamingPSApp, cfg, rows, tx, ty, device="cpu")
    theta0 = fused.server.theta
    msg.run_serial(max_server_iterations=W)
    step = bsp.make_bsp_step(cfg.model, W, cfg.server_lr,
                             task=fused.server.task)
    theta, _ = step(theta0, *_port(_stacked(fused)))
    torch.testing.assert_close(theta, msg.server.theta, rtol=0,
                               atol=MSG_ATOL)


@pytest.mark.parametrize("task", TASKS)
def test_bsp_step_matches_jax(task):
    theta, x, y, mask = _inputs(task)
    cfg, jcfg = _cfg(config, task).model, _cfg(jconfig, task).model
    jt, jloss = jbsp.make_bsp_step(jcfg, W, 0.25, task=jget_task(task, jcfg))(
        jnp.asarray(theta), jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(mask))
    tt, tloss = bsp.make_bsp_step(cfg, W, 0.25, task=get_task(task, cfg))(
        *_port((theta, x, y, mask)))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("task", TASKS)
def test_bsp_multi_step_matches_jax(task):
    """theta after 8 rounds and each round's mean loss."""
    theta, x, y, mask = _inputs(task, seed=4)
    cfg, jcfg = _cfg(config, task).model, _cfg(jconfig, task).model
    jt, jlosses = jbsp.make_bsp_multi_step(
        jcfg, W, 0.25, 8, task=jget_task(task, jcfg))(
        jnp.asarray(theta), jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(mask))
    multi = bsp.make_bsp_multi_step(cfg, W, 0.25, 8,
                                    task=get_task(task, cfg))
    tt, tlosses = multi(*_port((theta, x, y, mask)))
    assert tuple(tlosses.shape) == (8,) and multi.captures == 0
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("task", TASKS)
def test_chunk_is_bitwise_its_single_rounds(task):
    theta, x, y, mask = _port(_inputs(task, seed=5))
    cfg = _cfg(config, task).model
    t = get_task(task, cfg)
    rounds = StreamingPSApp.FUSED_CHUNK_ROUNDS
    step = bsp.make_bsp_step(cfg, W, 0.25, task=t)
    th, losses = theta, []
    for _ in range(rounds):
        th, loss = step(th, x, y, mask)
        losses.append(loss)
    ct, closses = bsp.make_bsp_multi_step(cfg, W, 0.25, rounds, task=t)(
        theta, x, y, mask)
    assert torch.equal(ct, th)
    assert torch.equal(closses, torch.stack(losses))


def test_cpu_rounds_count_no_kernel_launch():
    """CPU tensors run the plain versions: no kernel counter moves."""
    fused_update.reset_counts()
    cfg = _cfg(config).model
    bsp.make_bsp_multi_step(cfg, W, 0.25, 2)(*_port(_inputs("logreg")))
    assert not any(fused_update.counts().values())


# -- run_fused_bsp ----------------------------------------------------------------


def _check_rows_against_jax(js, jw, ts, tw, ty):
    js, jw, ts, tw = ([r.split(";") for r in rows]
                      for rows in (js, jw, ts, tw))
    assert len(ts) == len(js) and len(tw) == len(jw) > 0
    # partition, clock (and numTuplesSeen for workers) exactly
    assert [r[1:3] for r in ts] == [r[1:3] for r in js]
    assert [r[1:3] + r[6:] for r in tw] == [r[1:3] + r[6:] for r in jw]
    # the -1 placeholders in the same places
    assert [[v == "-1.0" for v in r[4:6]] for r in tw] == \
        [[float(v) == -1.0 for v in r[4:6]] for r in jw]
    tol = 1.0 / len(ty)
    for ours, ref in zip(ts + tw, js + jw):
        np.testing.assert_allclose(float(ours[3]), float(ref[3]),
                                   rtol=RTOL, atol=ATOL)       # loss
        assert abs(float(ours[4]) - float(ref[4])) <= tol       # F1
        assert abs(float(ours[5]) - float(ref[5])) <= tol       # accuracy


@pytest.mark.parametrize("task,eval_every", [
    ("logreg", 1), ("logreg", 10), ("mlp", 1), ("mlp", 10)])
def test_run_fused_bsp_matches_jax(task, eval_every):
    (japp, js, jw), (tapp, ts, tw), ty = _pair(task, eval_every)
    japp.run_fused_bsp(max_server_iterations=40 * W)
    tapp.run_fused_bsp(max_server_iterations=40 * W)
    tapp.close_logs()
    _check_rows_against_jax(js, jw, ts, tw, ty)
    assert len(tw) == 40 * W and len(ts) == 40 // eval_every
    assert tapp.server.iterations == japp.server.iterations == 40 * W
    np.testing.assert_allclose(tapp.server.theta.numpy(),
                               np.asarray(japp.server.theta), rtol=RTOL,
                               atol=ATOL)
    assert [s.vector_clock for s in tapp.server.tracker.tracker] == [40] * W
    assert all(w.iterations == 40 for w in tapp.workers)
    chunks = 0 if eval_every == 1 else 4
    assert tapp.fused_stats == {"rounds": 40, "chunk_rounds": 8 * chunks,
                                "chunks": chunks}


def test_run_fused_bsp_resumes_and_picks_up_new_rows():
    """Two calls with rows arriving between them give the JAX package's
    rows and theta: the second call resumes from the tracker's clock and
    re-uploads the changed slabs."""
    (japp, js, jw), (tapp, ts, tw), ty = _pair("logreg", eval_every=3)
    x, y = generate(30, F, C, noise=1.0, sparsity=0.5, seed=9)
    for app in (japp, tapp):
        app.run_fused_bsp(max_server_iterations=10 * W)
        for i, feats_label in enumerate(_rows(x, y)):
            app.data_sink(i % W, *feats_label)
        app.run_fused_bsp(max_server_iterations=25 * W)
    tapp.close_logs()
    _check_rows_against_jax(js, jw, ts, tw, ty)
    assert [int(r.split(";")[2]) for r in tw[::W]] == list(range(1, 26))
    np.testing.assert_allclose(tapp.server.theta.numpy(),
                               np.asarray(japp.server.theta), rtol=RTOL,
                               atol=ATOL)


def test_only_active_workers_take_part():
    (japp, js, jw), (tapp, ts, tw), ty = _pair("logreg", eval_every=2)
    for app in (japp, tapp):
        app.server.tracker.tracker[2].active = False
        app.run_fused_bsp(max_server_iterations=12 * (W - 1))
    tapp.close_logs()
    _check_rows_against_jax(js, jw, ts, tw, ty)
    assert {r.split(";")[1] for r in tw} == {"0", "1", "3"}
    assert tapp.workers[2].iterations == 0
    assert tapp.server.tracker.tracker[2].vector_clock == 0
    np.testing.assert_allclose(tapp.server.theta.numpy(),
                               np.asarray(japp.server.theta), rtol=RTOL,
                               atol=ATOL)


def test_without_logging_chunks_run_to_the_cap():
    (_, _, _), (tapp, ts, tw), _ = _pair("logreg", eval_every=1)
    tapp.run_fused_bsp(max_server_iterations=19 * W, log_metrics=False)
    assert ts == [] and tw == []
    assert tapp.fused_stats == {"rounds": 19, "chunk_rounds": 16,
                                "chunks": 2}


@pytest.mark.parametrize("c", [2, -1])
def test_fused_requires_sequential(c):
    x, y, tx, ty = _data()
    app, _, _ = _app(StreamingPSApp, _cfg(config, c=c), _rows(x, y), tx, ty,
                     device="cpu")
    with pytest.raises(ValueError, match="sequential"):
        app.run_fused_bsp(max_server_iterations=4)


def test_empty_buffer_raises_the_reference_error():
    x, y, tx, ty = _data()
    app, _, _ = _app(StreamingPSApp, _cfg(config), _rows(x, y)[:3], tx, ty,
                     device="cpu")
    with pytest.raises(RuntimeError,
                       match="There is no data in the buffer of worker 3"):
        app.run_fused_bsp(max_server_iterations=4)


def test_mlp_learns_in_fused_bsp():
    """After tests/test_task.py's MLP case: 80 fused rounds on 4 buffers
    of 16 rows lower the loss and beat chance on held-out rows."""
    cfg = config.ModelConfig(num_features=16, num_classes=3, hidden_dim=32)
    task = get_task("mlp", cfg)
    nw, cap = 4, 16
    x, y = generate(nw * cap + 200, 16, 3, noise=0.5, sparsity=0.3, seed=2)
    xb = torch.from_numpy(x[:nw * cap].reshape(nw, cap, -1))
    yb = torch.from_numpy(y[:nw * cap].reshape(nw, cap))
    mb = torch.ones((nw, cap))
    step = bsp.make_bsp_multi_step(cfg, nw, 1.0 / nw, rounds=80, task=task)
    theta, losses = step(task.init_params("cpu"), xb, yb, mb)
    assert float(losses[-1]) < float(losses[0])
    m = task.evaluate(theta, torch.from_numpy(x[nw * cap:]),
                      torch.from_numpy(y[nw * cap:]))
    assert float(m.accuracy) > 0.55


# -- the CLI ------------------------------------------------------------------------


def _write_csvs():
    x, y = generate(460, 16, 3, noise=1.0, sparsity=0.5, seed=0)
    write_csv("train.csv", x[:400], y[:400])
    write_csv("test.csv", x[400:], y[400:])


def _cli(*flags):
    return ["-training", "train.csv", "-test", "test.csv",
            "--num_features", "16", "--num_classes", "3", "--num_workers",
            "4", "-p", "1", "-l", *flags]


def test_fused_cli_keeps_per_clock_cadence(tmp_path, monkeypatch, capsys):
    """After tests/test_cli_and_utils.py's fused cadence case: eval_every
    10 engages the chunks, and the worker log still carries one row per
    worker per clock, -1 placeholders off cadence, server rows exactly
    on cadence, auditor-clean under the sequential contract."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("KPS_PLATFORM", "cpu")
    _write_csvs()
    assert cli_run.main(_cli("--fused", "--eval_every", "10",
                             "--max_iterations", "160",
                             "--local_learning_rate", "0.1")) == 0
    w = load_worker_log("logs-worker.csv")
    s = load_server_log("logs-server.csv")
    for _, g in w.groupby("partition"):
        assert g["vectorClock"].tolist() == list(range(1, 41))
    off = w[w["vectorClock"] % 10 != 0]
    assert (off["fMeasure"] == -1).all() and (off["accuracy"] == -1).all()
    assert (w[w["vectorClock"] % 10 == 0]["fMeasure"] > 0).all()
    assert (off["loss"] != -1).any()
    assert s["vectorClock"].tolist() == [10, 20, 30, 40]
    assert validate.validate_run(w, s, consistency_model=0) == []
    stats = json.loads(capsys.readouterr().err.split(
        "kafka_ps_tpu_torch run: ")[-1])
    assert stats["fused"] == {"rounds": 40, "chunk_rounds": 32,
                              "chunks": 4, "graph_captures": 0}
    assert stats["producer"]["rows"] == 400
    assert stats["producer"]["parser"] in ("native", "python")


@pytest.mark.parametrize("flags,message", [
    (("--pallas",), "--pallas applies to the per-node worker path only"),
    (("--slab-dtype", "bf16"), "--slab-dtype applies to the per-node"),
    (("--slab-dtype", "int8"), "--slab-dtype applies to the per-node")])
def test_fused_cli_rejects_the_reference_combinations(flags, message):
    with pytest.raises(SystemExit, match=message):
        cli_run.main(_cli("--fused", *flags))


def test_fused_cli_rejects_a_non_sequential_model(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("KPS_PLATFORM", "cpu")
    _write_csvs()
    with pytest.raises(ValueError, match="sequential model only"):
        cli_run.main(_cli("--fused", "-c", "2", "--max_iterations", "8"))
