"""The port's failure detection and elastic recovery: tracker membership,
server eviction and readmission, data rerouting and the supervised
threaded runtime with fault injection (the cases of tests/test_failure.py,
run on kafka_ps_tpu_torch), parity with kafka_ps_tpu on the same forced
evictions, and the kernel build kept out of the heartbeat's clock.

Parity tolerance: gate releases, clocks, membership events and rerouted
row counts exactly; theta rtol=1e-4, atol=1e-5 (float32, different
summation orders, as tests/test_torch_slice.py).
"""

import threading
import time

import numpy as np
import pytest
import torch

from kafka_ps_tpu.runtime.app import StreamingPSApp as JApp
from kafka_ps_tpu.utils import config as jconfig
from kafka_ps_tpu_torch.data.synth import generate
from kafka_ps_tpu_torch.ops import _build
from kafka_ps_tpu_torch.parallel.tracker import MessageTracker
from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
from kafka_ps_tpu_torch.utils import config
from kafka_ps_tpu_torch.utils.config import BufferConfig, ModelConfig, PSConfig

CFG_KW = dict(
    model=ModelConfig(num_features=16, num_classes=3),
    buffer=BufferConfig(min_size=4, max_size=8),
)


def _make_app(num_workers=3, consistency=0, **kw):
    cfg = PSConfig(num_workers=num_workers, consistency_model=consistency,
                   **CFG_KW)
    x, y = generate(80, 16, 3, seed=0)
    app = StreamingPSApp(cfg, test_x=x[-8:], test_y=y[-8:], device="cpu",
                         **kw)
    for i in range(num_workers * 8):
        app.data_sink(i % num_workers,
                      {j: float(x[i, j]) for j in range(16)}, int(y[i]))
    return app


# -- tracker membership ----------------------------------------------------

def test_tracker_deactivate_releases_gate():
    t = MessageTracker(3)
    t.received_message(0, 0)
    t.received_message(1, 0)
    assert not t.has_received_all_messages(0)
    t.deactivate_worker(2)
    assert t.has_received_all_messages(0)
    assert t.active_workers == [0, 1]
    assert all(w != 2 for w, _ in t.get_all_sendable_messages(0))


def test_tracker_cannot_deactivate_last_worker():
    t = MessageTracker(2)
    t.deactivate_worker(0)
    with pytest.raises(ValueError, match="last active worker"):
        t.deactivate_worker(1)
    assert t.tracker[1].active


def test_tracker_reactivate_joins_at_slowest_clock():
    t = MessageTracker(3)
    t.deactivate_worker(2)
    for clock in range(4):
        for w in (0, 1):
            t.received_message(w, clock)
            t.sent_message(w, clock + 1)
    join = t.reactivate_worker(2)
    assert join == 4
    assert t.tracker[2].active and not t.tracker[2].weights_message_sent
    assert t.has_received_all_messages(3)
    assert t.clocks == [4, 4, 4]


def test_tracker_is_duplicate():
    t = MessageTracker(2)
    t.received_message(0, 0)
    assert t.is_duplicate(0, 0)
    assert not t.is_duplicate(0, 1) and not t.is_duplicate(1, 0)


# -- server eviction / readmission (serial, deterministic) -----------------

def test_sequential_run_survives_worker_death():
    app = _make_app(num_workers=3)
    app.run_serial(max_server_iterations=3, pump=lambda: None)
    theta_before = app.server.theta.clone()
    app.server.remove_worker(2)
    app.run_serial(max_server_iterations=9, pump=lambda: None)
    assert app.server.iterations >= 9
    assert not torch.equal(app.server.theta, theta_before)
    assert 2 not in app.server.tracker.active_workers


def test_zombie_gradient_dropped():
    app = _make_app(num_workers=2)
    app.server.start_training_loop()
    for w in (0, 1):
        msg = app.fabric.poll(fabric_mod.WEIGHTS_TOPIC, w)
        app.workers[w].on_weights(msg)
    app.server.remove_worker(1)
    applied_before = app.server.iterations
    for _ in range(2):
        g = app.fabric.poll(fabric_mod.GRADIENTS_TOPIC, 0)
        if g is not None:
            app.server.process(g)
    assert app.server.iterations == applied_before + 1
    assert app.server.tracker.clocks[1] == 0
    assert app.server.zombie_gradients_dropped == 1


def test_duplicate_gradients_dropped_per_message_and_in_a_batch():
    """A redelivered gradient is dropped, also when it appears twice in
    one batch (the filter sees the clocks earlier members advance)."""
    app = _make_app(num_workers=2, consistency=-1)
    app.server.start_training_loop()
    grads = []
    for w in (0, 1):
        app.workers[w].on_weights(app.fabric.poll(fabric_mod.WEIGHTS_TOPIC,
                                                  w))
        grads.append(app.fabric.poll(fabric_mod.GRADIENTS_TOPIC, 0))
    app.server.process_batch([grads[0], grads[0], grads[1]])
    assert app.server.iterations == 2
    assert app.server.duplicate_gradients_dropped == 1
    app.server.process(grads[1])
    assert app.server.duplicate_gradients_dropped == 2
    assert app.server.tracker.clocks == [1, 1]


def test_readmission_rejoins_and_contributes():
    app = _make_app(num_workers=3)
    app.run_serial(max_server_iterations=3, pump=lambda: None)
    app.server.remove_worker(1)
    app.run_serial(max_server_iterations=7, pump=lambda: None)
    clock = app.server.readmit_worker(1)
    assert clock == min(app.server.tracker.clocks[0],
                        app.server.tracker.clocks[2])
    before = app.workers[1].iterations
    app.run_serial(max_server_iterations=13, pump=lambda: None)
    assert app.workers[1].iterations > before
    assert app.server.tracker.tracker[1].active
    assert [(k, w) for _, k, w in app.server.membership_events] == [
        ("evict", 1), ("readmit", 1)]


def test_data_rerouted_from_dead_worker():
    app = _make_app(num_workers=3)
    app.server.remove_worker(2)
    seen_before = [b.num_tuples_seen for b in app.buffers]
    x, y = generate(30, 16, 3, seed=9)
    for i in range(30):
        app.data_sink(2, {j: float(x[i, j]) for j in range(16)}, int(y[i]))
    assert app.buffers[2].num_tuples_seen == seen_before[2]
    for w in (0, 1):
        assert app.buffers[w].num_tuples_seen == seen_before[w] + 15
    assert app.rerouted_rows == 30


def test_readmission_drains_zombie_gradient():
    app = _make_app(num_workers=2)
    app.server.start_training_loop()
    for w in (0, 1):
        app.workers[w].on_weights(app.fabric.poll(fabric_mod.WEIGHTS_TOPIC,
                                                  w))
    app.server.remove_worker(1)
    app.server.process(app.fabric.poll(fabric_mod.GRADIENTS_TOPIC, 0))
    app.server.readmit_worker(1)
    assert app.fabric.poll(fabric_mod.GRADIENTS_TOPIC, 0) is None
    msg = app.fabric.poll(fabric_mod.WEIGHTS_TOPIC, 1)
    assert msg.vector_clock == app.server.tracker.clocks[1]


def test_checkpoint_roundtrips_active_flags(tmp_path):
    from kafka_ps_tpu_torch.utils import checkpoint as ckpt
    app = _make_app(num_workers=3)
    app.run_serial(max_server_iterations=3, pump=lambda: None)
    app.server.remove_worker(1)
    path = str(tmp_path / "ckpt.npz")
    ckpt.save(path, app.server)
    app2 = _make_app(num_workers=3)
    ckpt.restore(path, app2.server)
    assert app2.server.tracker.active_workers == [0, 2]
    assert app2.server.tracker.clocks == app.server.tracker.clocks
    app2.run_serial(max_server_iterations=app2.server.iterations + 4,
                    pump=lambda: None)
    assert 1 not in app2.server.tracker.active_workers


def test_fused_bsp_respects_evictions():
    app = _make_app(num_workers=3)
    app.server.remove_worker(1)
    clocks_before = list(app.server.tracker.clocks)
    app.run_fused_bsp(max_server_iterations=4)
    assert app.server.tracker.clocks[1] == clocks_before[1]
    assert app.server.tracker.clocks[0] > clocks_before[0]
    assert app.workers[1].iterations == 0
    assert app.server.iterations >= 4


def test_wait_for_prefill_skips_evicted_workers():
    app = _make_app(num_workers=2)
    app.server.remove_worker(1)
    # an empty buffer of an evicted worker must not block
    app.buffers[1] = type(app.buffers[1])(16, CFG_KW["buffer"])
    app.wait_for_prefill(min_per_worker=1, timeout=1.0)


# -- threaded runtime with fault injection ---------------------------------

class _CrashAfter:
    """Fault injector: wraps on_weights, raises on the nth call."""

    def __init__(self, worker, n, error=RuntimeError("injected worker "
                                                     "fault")):
        self.worker = worker
        self.n = n
        self.error = error
        self.calls = 0
        self._orig = worker.on_weights
        worker.on_weights = self

    def __call__(self, msg):
        self.calls += 1
        if self.calls > self.n:
            raise self.error
        return self._orig(msg)


def test_threaded_halt_policy_raises():
    app = _make_app(num_workers=2)
    _CrashAfter(app.workers[1], 1)
    with pytest.raises(RuntimeError, match="worker thread failed"):
        app.run_threaded(max_server_iterations=50, poll_timeout=0.02)


def test_threaded_rebalance_survives_crash():
    app = _make_app(num_workers=3)
    _CrashAfter(app.workers[1], 1)
    app.run_threaded(max_server_iterations=12, poll_timeout=0.02,
                     failure_policy="rebalance")
    assert app.server.iterations >= 12
    assert [w for w, _ in app.worker_failures] == [1]
    assert 1 not in app.server.tracker.active_workers


def _fail_prepare_off_own_thread(worker, error=None):
    """`worker._prepare` raises only on another worker's thread, i.e.
    when a sibling leads the gang set that holds it; `on_weights` stays
    the class's, so the worker remains gangable."""
    orig = worker._prepare
    own = f"worker-{worker.worker_id}"

    def prepare(msg):
        if threading.current_thread().name != own:
            raise error or RuntimeError("injected member fault")
        return orig(msg)
    worker._prepare = prepare


def test_gang_reports_every_failed_member_after_the_healthy_ones():
    from kafka_ps_tpu_torch.runtime.gang import GangError, GangMemberError
    app = _make_app(num_workers=4)
    for w in (1, 2):
        app.workers[w]._prepare = lambda msg: 1 / 0
    with pytest.raises(GangError) as e:
        app.run_serial(max_server_iterations=8, pump=lambda: None)
    assert [f.worker_id for f in e.value.failures] == [1, 2]
    assert all(isinstance(f, GangMemberError)
               and isinstance(f.__cause__, ZeroDivisionError)
               for f in e.value.failures)
    assert [app.workers[w].iterations for w in range(4)] == [1, 0, 0, 1]


def _run_threaded_guarded(app, max_server_iterations, timeout=60.0, **kw):
    """run_threaded on a thread of its own; a run that has not ended
    within `timeout` is stopped and fails the test."""
    errors = []

    def run():
        try:
            app.run_threaded(max_server_iterations, **kw)
        except BaseException as e:
            errors.append(e)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        app._stop.set()
        t.join(10.0)
        pytest.fail(f"run_threaded did not end within {timeout}s")
    if errors:
        raise errors[0]


@pytest.mark.parametrize("failing", [(2,), (1, 2)])
def test_threaded_rebalance_evicts_only_the_failed_gang_members(failing):
    """Gang dispatch on: members whose `_prepare` fails on the leader's
    thread are evicted, each of them and only they; the leader's thread
    runs on and the run reaches its budget with no heartbeat."""
    from kafka_ps_tpu_torch.runtime.gang import GangMemberError
    app = _make_app(num_workers=4)
    assert app.cfg.use_gang
    for w in failing:
        _fail_prepare_off_own_thread(app.workers[w])
    _run_threaded_guarded(app, 60, poll_timeout=0.02,
                          failure_policy="rebalance")
    assert app.server.iterations >= 60
    assert sorted(w for w, _ in app.worker_failures) == list(failing)
    assert all(isinstance(r, GangMemberError) for _, r in app.worker_failures)
    assert app.server.tracker.active_workers == [
        w for w in range(4) if w not in failing]


def test_threaded_rebalance_halts_on_a_cuda_error_in_a_gang_member():
    app = _make_app(num_workers=4)
    _fail_prepare_off_own_thread(app.workers[2], RuntimeError(
        "local_update kernel launch failed: CUDA error 700"))
    with pytest.raises(RuntimeError, match="worker thread failed") as e:
        _run_threaded_guarded(app, 200, poll_timeout=0.02,
                              failure_policy="rebalance")
    assert "CUDA error" in repr(e.value.__cause__.failures)
    assert app.worker_failures == []
    assert app.server.tracker.active_workers == [0, 1, 2, 3]


def test_threaded_rebalance_halts_on_a_cuda_error():
    """A CUDA error poisons the context every worker shares: under
    rebalance it halts the run instead of evicting the worker."""
    app = _make_app(num_workers=3)
    _CrashAfter(app.workers[1], 1, RuntimeError(
        "local_update kernel launch failed: CUDA error 700"))
    with pytest.raises(RuntimeError, match="worker thread failed") as e:
        app.run_threaded(max_server_iterations=50, poll_timeout=0.02,
                         failure_policy="rebalance")
    assert "CUDA error" in str(e.value.__cause__)
    assert app.worker_failures == []
    assert app.server.tracker.active_workers == [0, 1, 2]


def test_threaded_rebalance_evicts_hung_worker():
    app = _make_app(num_workers=3)
    app.run_serial(max_server_iterations=3, pump=lambda: None)
    hang = threading.Event()

    def hanging(msg):
        hang.wait(timeout=30)

    app.workers[1].on_weights = hanging
    try:
        app.run_threaded(max_server_iterations=20, poll_timeout=0.02,
                         failure_policy="rebalance", heartbeat_timeout=0.5)
    finally:
        hang.set()
    assert app.server.iterations >= 20
    assert any(w == 1 and "heartbeat" in str(r)
               for w, r in app.worker_failures)


def test_threaded_rebalance_halts_when_no_workers_left():
    app = _make_app(num_workers=2)
    _CrashAfter(app.workers[0], 1)
    _CrashAfter(app.workers[1], 1)
    with pytest.raises(RuntimeError, match="worker thread failed"):
        app.run_threaded(max_server_iterations=100, poll_timeout=0.02,
                         failure_policy="rebalance")


def test_unknown_failure_policy_rejected():
    with pytest.raises(ValueError, match="failure_policy"):
        _make_app().run_threaded(10, failure_policy="retry")


def test_app_readmission_resets_compile_grace():
    app = _make_app(num_workers=3)
    app.server.start_training_loop()
    app.run_serial(max_server_iterations=6)
    assert app.workers[1].iterations > 0
    app.server.remove_worker(1)
    before = app.workers[1].iterations
    clock = app.readmit_worker(1)
    assert app.server.tracker.tracker[1].active
    assert app.workers[1].iterations_at_join == before
    assert clock >= 0
    app.run_serial(max_server_iterations=app.server.iterations + 3)
    assert app.workers[1].iterations > before


# -- the kernel build and the heartbeat ------------------------------------

BUILD_S, HEARTBEAT_S = 6.0, 0.5      # the build outlasts the 10x grace


def _slow_first_build(monkeypatch):
    """Stand in for nvcc: the first build of the process takes BUILD_S,
    later ones find the libraries built.  Every worker's first iteration
    builds, as the kernels' first CUDA call does."""
    built = threading.Event()
    lock = threading.Lock()

    def build(names):
        with lock:
            if not built.is_set():
                time.sleep(BUILD_S)
                built.set()
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build, "sources", lambda: ["local_update.cu"])
    return build


def _run_with_first_iteration_build(monkeypatch, prebuild: bool):
    build = _slow_first_build(monkeypatch)
    app = _make_app(num_workers=3)
    app.device = torch.device("cuda")      # build_kernels builds
    if not prebuild:
        monkeypatch.setattr(app, "build_kernels", lambda: None)
    for w in app.workers:
        orig = w.on_weights

        def first_build(msg, orig=orig):
            build(["local_update.cu"])
            return orig(msg)
        w.on_weights = first_build
    try:
        app.run_threaded(max_server_iterations=12, poll_timeout=0.02,
                         failure_policy="rebalance",
                         heartbeat_timeout=HEARTBEAT_S)
    except RuntimeError:
        # every worker stalled: two evicted, the last one halts the run
        assert not prebuild
    return app


def test_first_iteration_kernel_build_evicts_nobody(monkeypatch):
    """run_threaded builds the kernels before the supervisor's clock
    starts: a build longer than the first iteration's 10x grace evicts
    nobody."""
    app = _run_with_first_iteration_build(monkeypatch, prebuild=True)
    assert app.worker_failures == []
    assert app.server.tracker.active_workers == [0, 1, 2]
    assert app.server.iterations >= 12


def test_first_iteration_kernel_build_without_the_prebuild_evicts(
        monkeypatch):
    """The control: the same build paid inside the first iterations
    trips the heartbeat (all three stall, so two are evicted and the
    last halts the run), so the test above measures the prebuild."""
    app = _run_with_first_iteration_build(monkeypatch, prebuild=False)
    assert app.worker_failures


# -- parity with kafka_ps_tpu on the same forced evictions -----------------

F, C, W = 16, 3, 3


def _parity_app(app_cls, mod, c, **kw):
    cfg = mod.PSConfig(
        num_workers=W, consistency_model=c,
        model=mod.ModelConfig(num_features=F, num_classes=C),
        buffer=mod.BufferConfig(min_size=4, max_size=8),
        **({"use_gang": False, "eval_async": False} if mod is jconfig
           else {}))
    x, y = generate(140, F, C, seed=3)
    app = app_cls(cfg, test_x=x[-20:], test_y=y[-20:],
                  clock_ms=iter(range(0, 10 ** 9, 50)).__next__, **kw)
    sends = []
    orig = app.fabric.send

    def send(topic, key, msg):
        if topic == "weights":
            sends.append((key, msg.vector_clock))
        return orig(topic, key, msg)
    app.fabric.send = send
    rows = [({j: float(v) for j, v in enumerate(r) if v}, int(lbl))
            for r, lbl in zip(x[:120], y[:120])]
    for i, row in enumerate(rows[:48]):
        app.data_sink(i % W, *row)
    return app, sends, rows


def _evict_readmit_run(app, rows):
    app.run_serial(7, pump=lambda: None)
    app.server.remove_worker(1)
    for i, row in enumerate(rows[48:84]):
        app.data_sink(i % W, *row)       # worker 1's third rerouted
    app.run_serial(16, pump=lambda: None)
    app.readmit_worker(1)
    for i, row in enumerate(rows[84:]):
        app.data_sink(i % W, *row)
    app.run_serial(30, pump=lambda: None)
    app.close_logs()


@pytest.mark.parametrize("c", [0, 2, -1])
def test_forced_eviction_matches_reference(c):
    japp, jsends, rows = _parity_app(JApp, jconfig, c)
    tapp, tsends, _ = _parity_app(StreamingPSApp, config, c, device="cpu")
    _evict_readmit_run(japp, rows)
    _evict_readmit_run(tapp, rows)
    assert tsends == jsends
    assert tapp.server.tracker.clocks == japp.server.tracker.clocks
    assert ([(k, w) for _, k, w in tapp.server.membership_events]
            == [(k, w) for _, k, w in japp.server.membership_events]
            == [("evict", 1), ("readmit", 1)])
    assert tapp.rerouted_rows == japp._reroute_counter == 12
    assert tapp.server.iterations == japp.server.iterations
    assert [b.num_tuples_seen for b in tapp.buffers] == [
        b.num_tuples_seen for b in japp.buffers]
    np.testing.assert_allclose(tapp.server.theta.numpy(),
                               np.asarray(japp.server.theta),
                               rtol=1e-4, atol=1e-5)
