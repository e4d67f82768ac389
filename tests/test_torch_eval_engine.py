"""The async eval engine in the port (kafka_ps_tpu_torch.evaluation.engine),
on the CPU.

The contract, as in the JAX package: `--eval-async` is pure mechanism —
theta and the server's eval rows (timestamps stripped) are bitwise those
of the fused apply+eval, for all three consistency models, gang on or
off, at any eval cadence; rows come out in strict clock order, and the
lag returns to 0 when the drive loop drains.  The oracle of a coalesced
row is the standalone `evaluate` of its theta, bit for bit.
"""

import threading

import numpy as np
import pytest
import torch

from kafka_ps_tpu.data.synth import generate
from kafka_ps_tpu_torch.evaluation import engine as engine_mod
from kafka_ps_tpu_torch.evaluation.engine import (EVAL_BYTE_BUDGET,
                                                  MAX_COALESCE, EvalEngine,
                                                  coalesce_width_cap)
from kafka_ps_tpu_torch.models.task import get_task
from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
from kafka_ps_tpu_torch.utils.config import (BufferConfig, ModelConfig,
                                             PSConfig)


def _cfg(c, *, eval_async, gang=True, eval_every=1, task="logreg"):
    return PSConfig(num_workers=4, consistency_model=c, task=task,
                    model=ModelConfig(num_features=8, num_classes=2,
                                      hidden_dim=16),
                    buffer=BufferConfig(min_size=8, max_size=32),
                    eval_async=eval_async, use_gang=gang,
                    eval_every=eval_every)


def _run(cfg, iters=24, drive="serial"):
    x, y = generate(256, 8, 2, seed=1)
    rows: list = []
    app = StreamingPSApp(cfg, test_x=x, test_y=y, server_log=rows.append,
                         device="cpu")
    for i in range(len(x)):
        app.data_sink(i % cfg.num_workers, x[i], int(y[i]))
    if drive == "serial":
        app.run_serial(iters)
    else:
        app.run_threaded(iters)
    lag = None if app.eval_engine is None else app.eval_engine.lag_clocks
    app.close_logs()
    return ([r.split(";", 1)[1] for r in rows],
            app.server.theta.numpy().tobytes(), app, lag)


@pytest.mark.parametrize("c", [0, 2, -1])
@pytest.mark.parametrize("gang", [True, False])
@pytest.mark.parametrize("task", ["logreg", "mlp"])
def test_async_eval_bitwise_matches_fused(c, gang, task):
    fused_rows, fused_theta, fused_app, _ = _run(
        _cfg(c, eval_async=False, gang=gang, task=task))
    async_rows, async_theta, app, lag = _run(
        _cfg(c, eval_async=True, gang=gang, task=task))
    assert fused_app.eval_engine is None and app.eval_engine is not None
    assert async_theta == fused_theta
    assert async_rows == fused_rows and len(fused_rows) > 0
    assert lag == 0
    assert app.eval_engine.stats()["evals"] == len(async_rows)


@pytest.mark.parametrize("eval_every", [2, 3])
def test_async_eval_cadence_matches_fused(eval_every):
    """Off-cadence clocks produce no row and on-cadence clocks exactly
    one, under gang dispatch, where eval positions become prefix
    thetas of the chained apply."""
    fused_rows, fused_theta, _, _ = _run(
        _cfg(0, eval_async=False, eval_every=eval_every))
    async_rows, async_theta, _, _ = _run(
        _cfg(0, eval_async=True, eval_every=eval_every))
    assert async_theta == fused_theta and async_rows == fused_rows
    clocks = [int(r.split(";")[1]) for r in async_rows]
    assert clocks == sorted(clocks)
    assert all(c % eval_every == 0 for c in clocks)


@pytest.mark.parametrize("c", [0, 2, -1])
@pytest.mark.parametrize("gang", [True, False])
def test_async_eval_under_threaded_drive(c, gang):
    """Threaded runs differ from run to run (arrival order), so the
    contract here is within the run: one row per eval clock, in strict
    clock order, and the lag back to 0 after the drive loop's drain."""
    rows, _, app, lag = _run(_cfg(c, eval_async=True, gang=gang),
                             drive="threaded")
    clocks = [int(r.split(";")[1]) for r in rows]
    assert clocks and clocks == sorted(set(clocks))
    assert lag == 0
    assert app.eval_engine.stats()["evals"] == len(rows)
    assert np.isfinite([[float(v) for v in r.split(";")[2:5]]
                        for r in rows]).all()


# -- the engine alone ------------------------------------------------------------


def _fixture(n_test=32):
    task = get_task("logreg", ModelConfig(num_features=8, num_classes=2))
    x, y = generate(n_test, 8, 2, seed=2)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    emitted: list = []
    eng = EvalEngine(task, tx, ty,
                     lambda clock, m: emitted.append((clock, m)))
    rng = np.random.default_rng(1)
    thetas = [torch.from_numpy(rng.normal(size=task.num_params).astype(
        np.float32)) for _ in range(10)]
    return task, tx, ty, eng, emitted, thetas


@pytest.fixture
def no_thread(monkeypatch):
    """Engines made under this fixture start no thread: the test polls
    them on its own thread (close() then evaluates the rest)."""
    monkeypatch.setattr(EvalEngine, "_ensure_thread", lambda self: None)


def test_backlog_coalesces_into_one_dispatch_in_clock_order(no_thread):
    task, tx, ty, eng, emitted, thetas = _fixture()
    for c, t in enumerate(thetas[:5]):
        eng.submit(t, c)
    assert eng.lag_clocks == 5        # clocks 0..4 pending, none evaluated
    assert eng.poll()                 # one batch for the whole backlog
    assert not eng.poll()
    s = eng.stats()
    assert s["dispatches"] == 1 and s["widths"] == {"5": 1}
    assert [c for c, _ in emitted] == [0, 1, 2, 3, 4]
    assert eng.lag_clocks == 0
    # each row is bitwise the standalone evaluation of its theta
    for (_, m), t in zip(emitted, thetas):
        ref = task.evaluate(t, tx, ty)
        for field in ("loss", "f1", "accuracy"):
            assert torch.equal(getattr(m, field), getattr(ref, field))


def test_width_cap_bounds_one_dispatch(no_thread, monkeypatch):
    monkeypatch.setattr(engine_mod, "MAX_COALESCE", 4)
    _, _, _, eng, emitted, thetas = _fixture()
    for c, t in enumerate(thetas):
        eng.submit(t, c)
    eng.close()                       # no thread: polls until empty
    s = eng.stats()
    assert s["dispatches"] == 3 and s["evals"] == 10   # 4 + 4 + 2
    assert max(int(w) for w in s["widths"]) <= 4
    assert [c for c, _ in emitted] == list(range(10))


def test_threaded_engine_drains_reaps_and_close_joins(monkeypatch):
    monkeypatch.setattr(engine_mod, "IDLE_EXIT_S", 0.1)
    _, _, _, eng, emitted, thetas = _fixture()
    for c, t in enumerate(thetas[:6]):
        eng.submit(t, c)
    thread = eng._thread
    assert thread is not None and thread.name == "kps-eval"
    eng.drain()
    assert [c for c, _ in emitted] == list(range(6))
    assert eng.lag_clocks == 0
    thread.join(timeout=30)           # idle: the thread reaps itself
    assert not thread.is_alive()
    eng.submit(thetas[6], 6)          # ... and the next submit restarts it
    thread = eng._thread
    eng.close()
    assert not thread.is_alive()
    assert [c for c, _ in emitted] == list(range(7))


def test_backlog_past_max_pending_blocks_the_submitter(monkeypatch):
    monkeypatch.setattr(engine_mod, "MAX_PENDING", 2)
    task, tx, ty, _, _, thetas = _fixture()
    gate = threading.Event()

    class SlowTask:
        num_params = task.num_params

        def evaluate_batch(self, thetas, x, y):
            gate.wait(timeout=30)
            return task.evaluate_batch(thetas, x, y)
    emitted: list = []
    eng = EvalEngine(SlowTask(), tx, ty,
                     lambda clock, m: emitted.append(clock))
    done = threading.Event()

    def submitter():
        for c in range(4):
            eng.submit(thetas[c], c)
        done.set()
    t = threading.Thread(target=submitter)
    t.start()
    assert not done.wait(timeout=0.5)     # blocked, nothing dropped
    gate.set()
    assert done.wait(timeout=30)
    t.join(timeout=30)
    eng.close()
    assert emitted == [0, 1, 2, 3]


def test_failed_evaluation_is_raised_by_drain():
    task, tx, ty, _, _, thetas = _fixture()

    class BadTask:
        num_params = task.num_params

        def evaluate_batch(self, thetas, x, y):
            raise ValueError("injected")
    eng = EvalEngine(BadTask(), tx, ty, lambda clock, m: None)
    eng.submit(thetas[0], 0)
    with pytest.raises(RuntimeError, match="evaluation failed"):
        eng.drain()
    eng.close()


def test_coalesce_width_cap_properties(monkeypatch):
    # powers of two, >= 1, bounded by the hard ceiling
    for budget, width in ((8 * (100 + 100), 2), (1, 1)):
        monkeypatch.setattr(engine_mod, "EVAL_BYTE_BUDGET", budget)
        assert coalesce_width_cap(100, 100) == width
    monkeypatch.setattr(engine_mod, "EVAL_BYTE_BUDGET", 1 << 40)
    assert coalesce_width_cap(8, 8) == MAX_COALESCE
    monkeypatch.undo()
    # a test set past the budget forbids coalescing
    assert coalesce_width_cap(6150, EVAL_BYTE_BUDGET // 4) == 1
    for n_params, n_test in [(6150, 2000), (131_974, 2000), (10, 10),
                             (530_000, 2048)]:
        w = coalesce_width_cap(n_params, n_test)
        assert 1 <= w <= MAX_COALESCE and (w & (w - 1)) == 0
        assert w == 1 or w * 4 * (n_params + n_test) <= EVAL_BYTE_BUDGET
