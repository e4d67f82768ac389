"""Gang dispatch in the port (kafka_ps_tpu_torch.runtime.gang, K2 and
K6's plain versions), on the CPU.

Against the JAX package: the plain batched updates equal its batched
Pallas kernels in interpret mode within rtol=1e-4, atol=1e-6 (float32,
different summation orders).  Inside the port the contract is bitwise,
as in the JAX package: a gang member equals a single call, and a run
with gang dispatch equals the per-message run — theta bits, worker and
server CSV rows apart from timestamps — for both families, all three
consistency models, on and off eval cadence, while making fewer solver
dispatches.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kafka_ps_tpu.data.synth import generate
from kafka_ps_tpu.models import mlp as jmlp
from kafka_ps_tpu.ops import fused_update as jfused
from kafka_ps_tpu.utils.config import ModelConfig as JModelConfig
from kafka_ps_tpu_torch.models import mlp
from kafka_ps_tpu_torch.ops import fused_update
from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
from kafka_ps_tpu_torch.runtime.messages import GangNotice
from kafka_ps_tpu_torch.utils.config import (BufferConfig, ModelConfig,
                                             PSConfig)

RTOL, ATOL = 1e-4, 1e-6
F, C, HID = 16, 3, 20


def _stack(task, members=3, batch=24, seed=7, shared=False):
    cfg = ModelConfig(num_features=F, num_classes=C, hidden_dim=HID)
    jcfg = JModelConfig(num_features=F, num_classes=C, hidden_dim=HID)
    rng = np.random.default_rng(seed)
    n = cfg.num_params if task == "logreg" else mlp.num_params(cfg)
    base = (np.zeros(n, np.float32) if task == "logreg"
            else np.asarray(jmlp.MLPTask(jcfg).init_params()))
    thetas = (base + rng.normal(scale=0.1, size=(members, n))).astype(
        np.float32)
    if shared:
        thetas[:] = thetas[0]
    xs = rng.normal(size=(members, batch, F)).astype(np.float32)
    ys = rng.integers(1, C + 1, size=(members, batch)).astype(np.int32)
    ys[0, 1] = C + 4                                   # out of range
    masks = (rng.random((members, batch)) < 0.8).astype(np.float32)
    return cfg, jcfg, thetas, xs, ys, masks


FAMILIES = {
    "logreg": (fused_update.local_update_batched, fused_update.local_update,
               jfused.local_update_batched),
    "mlp": (fused_update.mlp_local_update_batched,
            fused_update.mlp_local_update, jfused.mlp_local_update_batched),
}


@pytest.mark.parametrize("task", ["logreg", "mlp"])
@pytest.mark.parametrize("shared", [False, True])
def test_batched_plain_matches_jax_batched_kernel(task, shared):
    cfg, jcfg, thetas, xs, ys, masks = _stack(task, shared=shared)
    batched, _, jbatched = FAMILIES[task]
    dj, lj = jbatched(*(jnp.asarray(a) for a in (thetas, xs, ys, masks)),
                      cfg=jcfg, interpret=True, allow_fallback=False)
    counts = fused_update.counts()
    dt, lt = batched(*(torch.from_numpy(a) for a in (thetas, xs, ys, masks)),
                     cfg=cfg)
    assert fused_update.counts() == counts      # CPU tensors: no kernel
    assert dt.shape == thetas.shape and lt.shape == (len(thetas),)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("task", ["logreg", "mlp"])
def test_batched_member_is_bitwise_a_single_call(task):
    """Per-member sequences (what the gang passes, a shared theta as one
    tensor k times) and stacked tensors give the single calls' bits."""
    cfg, _, thetas, xs, ys, masks = _stack(task, members=4)
    batched, single, _ = FAMILIES[task]
    t = [torch.from_numpy(a) for a in (thetas, xs, ys, masks)]
    shared_theta = [t[0][0]] * 4
    for th in (t[0], shared_theta):
        deltas, losses = batched(th, t[1], t[2], t[3], cfg=cfg)
        for i in range(4):
            d, loss = single(th[i], t[1][i], t[2][i], t[3][i], cfg=cfg)
            assert torch.equal(deltas[i], d) and torch.equal(losses[i], loss)


def test_batched_wrapper_checks_members():
    cfg, _, thetas, xs, ys, masks = _stack("logreg")
    t = [list(torch.from_numpy(a)) for a in (thetas, xs, ys, masks)]
    with pytest.raises(ValueError, match="one theta, x, y and mask"):
        fused_update.local_update_batched(t[0][:2], *t[1:], cfg=cfg)
    short = [list(a) for a in t[1:]]
    for a in short:                  # member 1: a well-formed but shorter
        a[1] = a[1][:-1]             # buffer than member 0's
    with pytest.raises(ValueError, match="share device and batch"):
        fused_update.local_update_batched(t[0], *short, cfg=cfg)
    with pytest.raises(TypeError):
        fused_update.mlp_local_update_batched(
            t[0], [x.double() for x in t[1]], t[2], t[3], cfg=cfg)


# -- the gang in the trainer ---------------------------------------------------


def _cfg(c, task, use_gang, eval_every=1, eval_async=False, workers=4):
    return PSConfig(num_workers=workers, consistency_model=c, task=task,
                    model=ModelConfig(num_features=8, num_classes=2,
                                      hidden_dim=16),
                    buffer=BufferConfig(min_size=8, max_size=32),
                    use_gang=use_gang, eval_every=eval_every,
                    eval_async=eval_async)


def _app(cfg):
    x, y = generate(256, 8, 2, seed=0)
    logs = {"server": [], "worker": []}
    app = StreamingPSApp(cfg, test_x=x, test_y=y,
                         server_log=logs["server"].append,
                         worker_log=logs["worker"].append, device="cpu")
    for i in range(len(x)):
        app.data_sink(i % cfg.num_workers, x[i], int(y[i]))
    return app, logs


def _strip(rows):
    """Drop the timestamp, the one field allowed to differ."""
    return [r.split(";", 1)[1] for r in rows]


def _serial_pair(c, task, **kw):
    out = {}
    for gang in (True, False):
        fused_update.reset_counts()
        app, logs = _app(_cfg(c, task, gang, **kw))
        app.run_serial(40)
        app.close_logs()
        out[gang] = (app, logs, fused_update.counts())
    return out


@pytest.mark.parametrize("task", ["logreg", "mlp"])
@pytest.mark.parametrize("c", [0, 2, -1])
@pytest.mark.parametrize("eval_every", [1, 3])
def test_serial_gang_is_bitwise_the_per_message_path(task, c, eval_every):
    res = _serial_pair(c, task, eval_every=eval_every)
    (on, logs_on, _), (off, logs_off, _) = res[True], res[False]
    assert on.server.theta.numpy().tobytes() == \
        off.server.theta.numpy().tobytes()
    assert _strip(logs_on["worker"]) == _strip(logs_off["worker"])
    assert _strip(logs_on["server"]) == _strip(logs_off["server"])
    assert len(logs_on["server"]) > 0
    assert on.server.iterations == off.server.iterations == 40


@pytest.mark.parametrize("task", ["logreg", "mlp"])
@pytest.mark.parametrize("c", [0, 2, -1])
def test_serial_gang_reduces_dispatches(task, c, monkeypatch):
    calls = {"single": 0, "batched": 0}

    def count(kind, fn):
        def wrapped(*a, **k):
            calls[kind] += 1
            return fn(*a, **k)
        return wrapped
    from kafka_ps_tpu_torch.runtime import gang, worker
    monkeypatch.setitem(worker.SOLVERS, task, count(
        "single", worker.SOLVERS[task]))
    monkeypatch.setitem(gang.BATCHED_SOLVERS, task, count(
        "batched", gang.BATCHED_SOLVERS[task]))
    worker._solver_fns.cache_clear()
    gang._gang_solver_fns.cache_clear()
    try:
        res = {}
        for use_gang in (True, False):
            calls.update(single=0, batched=0)
            app, _ = _app(_cfg(c, task, use_gang))
            app.run_serial(40)
            app.close_logs()
            res[use_gang] = (dict(calls), app)
    finally:
        worker._solver_fns.cache_clear()
        gang._gang_solver_fns.cache_clear()
    on, app_on = res[True]
    off, _ = res[False]
    assert off == {"single": 40, "batched": 0}
    assert on["batched"] > 0
    assert on["single"] + on["batched"] < off["single"]
    assert app_on.gang.dispatches == on["batched"]
    assert app_on.gang.members + on["single"] == 40
    assert app_on.server.batched_applies > 0


def test_gang_notices_are_transient_and_cover_release_sets():
    sent = []                        # (topic, message, through transient)
    app, _ = _app(_cfg(0, "logreg", True))
    real_send, real_transient = app.fabric.send, app.fabric.send_transient
    in_transient = []

    def send(topic, key, msg):
        sent.append((topic, msg, bool(in_transient)))
        real_send(topic, key, msg)

    def send_transient(topic, key, msg):
        in_transient.append(True)
        try:
            real_transient(topic, key, msg)
        finally:
            in_transient.pop()
    app.fabric.send = send
    app.fabric.send_transient = send_transient
    app.run_serial(16)
    app.close_logs()
    notices = [m for t, m, tr in sent if isinstance(m, GangNotice)]
    assert notices and all(tr == isinstance(m, GangNotice)
                           for _, m, tr in sent)
    assert all(t == fabric_mod.GANG_TOPIC for t, m, _ in sent
               if isinstance(m, GangNotice))
    # sequential consistency: every release (bootstrap included) is the
    # whole worker set at one clock
    for notice in notices:
        assert [w for w, _ in notice.members] == [0, 1, 2, 3]
        assert len({c for _, c in notice.members}) == 1
    # gang off: no notice at all
    app, _ = _app(_cfg(0, "logreg", False))
    app.run_serial(8)
    app.close_logs()
    assert app.fabric.pending(fabric_mod.GANG_TOPIC, 0) == 0
    assert not app.fabric.contains(fabric_mod.GANG_TOPIC, 0,
                                   lambda m: True)
    assert app.fabric.contains(fabric_mod.WEIGHTS_TOPIC, 0,
                               lambda m: m.vector_clock == 2)


def test_gang_runs_each_members_prepare_and_finish_in_worker_order(
        monkeypatch):
    """A gang dispatch is the per-message iteration split in two: every
    member's own `_prepare`, one batched call, then every member's own
    `_finish` in worker-id order, so each worker sees each of its clocks
    exactly once and the gradients reach the server in the per-message
    order."""
    from kafka_ps_tpu_torch.runtime import worker as worker_mod
    calls = []
    real_prepare, real_finish = (worker_mod.WorkerNode._prepare,
                                 worker_mod.WorkerNode._finish)

    def prepare(self, msg):
        calls.append(("prepare", self.worker_id, msg.vector_clock))
        return real_prepare(self, msg)

    def finish(self, msg, *rest):
        calls.append(("finish", self.worker_id, msg.vector_clock))
        return real_finish(self, msg, *rest)
    monkeypatch.setattr(worker_mod.WorkerNode, "_prepare", prepare)
    monkeypatch.setattr(worker_mod.WorkerNode, "_finish", finish)
    app, _ = _app(_cfg(0, "logreg", True))
    app.run_serial(20)
    app.close_logs()
    assert app.gang.dispatches == 5 and app.gang.members == 20
    finishes = [(w, c) for kind, w, c in calls if kind == "finish"]
    assert finishes == [(w, c) for c in range(5) for w in range(4)]
    # sequential consistency: each round prepares all four, then
    # finishes all four
    for c in range(5):
        rnd = [k for k, w, cl in calls if cl == c]
        assert rnd == ["prepare"] * 4 + ["finish"] * 4


@pytest.mark.parametrize("task", ["logreg", "mlp"])
@pytest.mark.parametrize("c", [0, 2, -1])
def test_threaded_gang_keeps_the_clock_protocol(task, c):
    app, logs = _app(_cfg(c, task, True, eval_async=True))
    app.run_threaded(40)
    app.close_logs()
    assert app.server.iterations == 40
    rows = [r.split(";") for r in logs["worker"]]
    assert len(rows) >= 40 and all(len(r) == 7 for r in rows)
    for w in range(4):
        clocks = [int(r[2]) for r in rows if int(r[1]) == w]
        assert clocks == list(range(len(clocks))) and clocks
    assert np.isfinite([[float(v) for v in r[3:6]] for r in rows]).all()
    server_clocks = [int(r.split(";")[2]) for r in logs["server"]]
    assert server_clocks == sorted(set(server_clocks))
    assert all(w.iterations > 0 for w in app.workers)
    assert app.gang.members == 0 or app.gang.members >= 2
    assert app.eval_engine.lag_clocks == 0
