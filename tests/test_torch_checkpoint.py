"""The port's checkpoints (kafka_ps_tpu_torch/utils/checkpoint.py): buffer
state, the server checkpoint and its resume, worker state files (the
in-process cases of tests/test_durability.py and the checkpoint cases of
tests/test_cli_and_utils.py, run on the port), checkpoints crossing
between the two packages bit for bit, the slab contract after a restore,
resume against an uninterrupted run, and the CLI's --checkpoint.

Every comparison here is exact: a checkpoint moves bytes, and a resume on
static data replays the same operations on the same inputs.
"""

import json
import os

import numpy as np
import pytest
import torch

from kafka_ps_tpu.runtime.app import StreamingPSApp as JApp
from kafka_ps_tpu.utils import checkpoint as jckpt
from kafka_ps_tpu.utils import config as jconfig
from kafka_ps_tpu_torch.cli import run as cli_run
from kafka_ps_tpu_torch.data.buffer import SlidingBuffer
from kafka_ps_tpu_torch.data.synth import generate, write_csv
from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
from kafka_ps_tpu_torch.runtime.messages import KeyRange, WeightsMessage
from kafka_ps_tpu_torch.runtime.server import ServerNode
from kafka_ps_tpu_torch.utils import checkpoint as ckpt
from kafka_ps_tpu_torch.utils import config
from kafka_ps_tpu_torch.utils.config import (BufferConfig, ModelConfig,
                                             PSConfig, StreamConfig)
from kafka_ps_tpu_torch.utils.csvlog import (EVENTS_HEADER, SERVER_HEADER,
                                             CsvLogSink)


def _filled_buffer(nf=8, n=20, seed=0) -> SlidingBuffer:
    rng = np.random.default_rng(seed)
    buf = SlidingBuffer(nf, BufferConfig(min_size=4, max_size=32))
    for i in range(n):
        buf.add(rng.normal(size=nf).astype(np.float32), int(i % 3))
    return buf


def _server_cfg():
    return PSConfig(num_workers=2,
                    model=ModelConfig(num_features=8, num_classes=3),
                    buffer=BufferConfig(min_size=4, max_size=32))


def _make_server(cfg):
    return ServerNode(cfg, fabric_mod.Fabric(), "cpu")


# -- buffer state and the server checkpoint (tests/test_durability.py) -------

def test_buffer_state_roundtrip():
    src = _filled_buffer()
    dst = SlidingBuffer(8, BufferConfig(min_size=4, max_size=32))
    dst.restore_state(src.state())
    np.testing.assert_array_equal(dst.x, src.x)
    np.testing.assert_array_equal(dst.y, src.y)
    np.testing.assert_array_equal(dst.insertion_id, src.insertion_id)
    assert dst.count == src.count
    assert dst.num_tuples_seen == src.num_tuples_seen
    assert dst.target_size() == src.target_size()
    dst.add(np.zeros(8, dtype=np.float32), 0)
    assert dst.num_tuples_seen == src.num_tuples_seen + 1


def test_buffer_restore_marks_every_slot_dirty_and_bumps_the_version():
    buf = _filled_buffer()
    buf.drain_dirty()
    version = buf.version
    buf.restore_state(_filled_buffer(seed=5).state())
    assert buf.version == version + 1
    assert buf.dirty_slots == list(range(32))


def test_buffer_add_many_is_add_per_row():
    rng = np.random.default_rng(3)
    rows = [(rng.normal(size=8).astype(np.float32), int(i % 3))
            for i in range(40)]
    clock = iter(range(0, 10 ** 6, 7))
    one = SlidingBuffer(8, BufferConfig(min_size=4, max_size=32),
                        clock_ms=clock.__next__)
    for features, label in rows:
        one.add(features, label)
    clock = iter(range(0, 10 ** 6, 7))
    many = SlidingBuffer(8, BufferConfig(min_size=4, max_size=32),
                         clock_ms=clock.__next__)
    many.add_many(iter(rows))
    for k, v in one.state().items():
        np.testing.assert_array_equal(many.state()[k], v)


def test_buffer_state_shape_mismatch_rejected():
    src = _filled_buffer(nf=8)
    dst = SlidingBuffer(16, BufferConfig(min_size=4, max_size=32))
    with pytest.raises(ValueError, match="capacity/features"):
        dst.restore_state(src.state())


def test_checkpoint_folds_buffers(tmp_path):
    cfg = _server_cfg()
    server = _make_server(cfg)
    bufs = [_filled_buffer(seed=1), _filled_buffer(seed=2)]
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, server, buffers=bufs)
    server2 = _make_server(cfg)
    bufs2 = [SlidingBuffer(8, cfg.buffer) for _ in range(2)]
    assert ckpt.maybe_restore(path, server2, buffers=bufs2)
    for a, b in zip(bufs, bufs2):
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.insertion_id, b.insertion_id)
        assert a.num_tuples_seen == b.num_tuples_seen
    assert [e[1:] for e in server2.membership_events] == [("resume", -1)]


def test_old_checkpoint_without_buffers_still_restores(tmp_path):
    cfg = _server_cfg()
    server = _make_server(cfg)
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, server)
    bufs = [SlidingBuffer(8, cfg.buffer) for _ in range(2)]
    assert ckpt.maybe_restore(path, server, buffers=bufs)
    assert all(b.count == 0 for b in bufs)


def test_worker_state_scoped_to_run_id(tmp_path):
    bufs = {0: _filled_buffer(seed=1)}
    path = str(tmp_path / "st.npz")
    ckpt.save_worker(path, bufs, run_id=111)
    assert ckpt.peek_run_id(path) == 111
    fresh = {0: SlidingBuffer(8, BufferConfig(min_size=4, max_size=32))}
    assert not ckpt.maybe_restore_worker(path, fresh, run_id=222)
    assert fresh[0].count == 0
    assert ckpt.maybe_restore_worker(path, fresh, run_id=111)
    assert fresh[0].count == bufs[0].count


def test_run_id_survives_server_checkpoint(tmp_path):
    cfg = _server_cfg()
    server = _make_server(cfg)
    server.run_id = 424242
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, server)
    assert ckpt.peek_run_id(path) == 424242
    server2 = _make_server(cfg)
    assert server2.run_id != 424242
    ckpt.restore(path, server2)
    assert server2.run_id == 424242


def test_log_offsets_ride_the_checkpoint(tmp_path):
    """The consumer offsets a durable log's replay starts from are stored
    as JSON inside the npz and come back on the restored server."""
    cfg = _server_cfg()
    path = str(tmp_path / "ck.npz")
    offsets = {"gradients/0": 17, "weights/1": 4}
    ckpt.save(path, _make_server(cfg), log_offsets=offsets)
    server = _make_server(cfg)
    assert server.restored_log_offsets is None
    ckpt.restore(path, server)
    assert server.restored_log_offsets == offsets


def test_worker_state_file_roundtrip(tmp_path):
    bufs = {3: _filled_buffer(seed=3), 7: _filled_buffer(seed=7)}
    path = ckpt.worker_state_path(str(tmp_path / "job.npz"), [7, 3])
    assert path.endswith(".workers-3-7.npz")
    ckpt.save_worker(path, bufs)
    fresh = {3: SlidingBuffer(8, BufferConfig(min_size=4, max_size=32)),
             7: SlidingBuffer(8, BufferConfig(min_size=4, max_size=32))}
    assert ckpt.maybe_restore_worker(path, fresh)
    for w in (3, 7):
        np.testing.assert_array_equal(fresh[w].x, bufs[w].x)
        assert fresh[w].num_tuples_seen == bufs[w].num_tuples_seen
    assert not ckpt.maybe_restore_worker(str(tmp_path / "nope.npz"), fresh)


def test_shard_state_path():
    assert ckpt.shard_state_path("ck.npz", 0, 1) == "ck.npz"
    assert ckpt.shard_state_path("ck.npz", 1, 4) == "ck.npz.shard1of4.npz"


# -- the app's checkpoint and resume (tests/test_cli_and_utils.py) ----------

def _small_cfg(consistency=0, num_workers=4, **kw):
    return PSConfig(num_workers=num_workers, consistency_model=consistency,
                    model=ModelConfig(num_features=8, num_classes=2,
                                      local_learning_rate=0.5),
                    buffer=BufferConfig(min_size=8, max_size=32),
                    stream=StreamConfig(time_per_event_ms=1.0), **kw)


def _build_app(consistency=0, num_workers=4, logs=None, **kw):
    rng = np.random.default_rng(0)
    y = rng.integers(1, 3, size=256).astype(np.int32)
    centers = np.array([[0.0] * 8, [2.5] * 8, [-2.5] * 8], np.float32)
    x = (centers[y] + rng.normal(scale=0.5, size=(256, 8))).astype(
        np.float32)
    logs = logs if logs is not None else {"server": [], "worker": []}
    app = StreamingPSApp(_small_cfg(consistency, num_workers, **kw),
                         test_x=x, test_y=y,
                         server_log=logs["server"].append,
                         worker_log=logs["worker"].append,
                         clock_ms=iter(range(0, 10 ** 9, 5)).__next__,
                         device="cpu")
    for i in range(len(x)):
        app.data_sink(i % num_workers,
                      {j: float(v) for j, v in enumerate(x[i]) if v}, int(y[i]))
    return app


def test_checkpoint_roundtrip(tmp_path):
    app = _build_app()
    app.run_serial(max_server_iterations=8)
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, app.server)
    app2 = _build_app()
    assert ckpt.maybe_restore(path, app2.server)
    assert torch.equal(app2.server.theta, app.server.theta)
    assert app2.server.theta.device == app2.server.device
    assert app2.server.tracker.clocks == app.server.tracker.clocks
    assert app2.server.iterations == app.server.iterations
    start_clock = min(app2.server.tracker.clocks)
    app2.run_serial(max_server_iterations=app2.server.iterations + 8)
    assert min(app2.server.tracker.clocks) > start_clock


def test_checkpoint_restore_mid_round(tmp_path):
    """Withheld replies go back through the gate, not the broadcast."""
    app = _build_app()
    app.run_serial(max_server_iterations=6)
    clocks = app.server.tracker.clocks
    assert max(clocks) != min(clocks)
    path = str(tmp_path / "mid.npz")
    ckpt.save(path, app.server)
    app2 = _build_app()
    ckpt.maybe_restore(path, app2.server)
    app2.run_serial(max_server_iterations=app2.server.iterations + 12)
    spread = max(app2.server.tracker.clocks) - min(app2.server.tracker.clocks)
    assert spread <= 1


def test_checkpoint_restore_eventual_reissues_withheld_replies(tmp_path):
    app = _build_app(consistency=-1)
    app.run_serial(max_server_iterations=6)
    for s in app.server.tracker.tracker[:2]:
        s.weights_message_sent = False      # replies owed at the stop
    path = str(tmp_path / "ev.npz")
    ckpt.save(path, app.server)
    app2 = _build_app(consistency=-1)
    ckpt.restore(path, app2.server)
    app2.server.start_training_loop()
    for w in range(4):
        msg = app2.fabric.poll(fabric_mod.WEIGHTS_TOPIC, w)
        assert msg.vector_clock == app.server.tracker.clocks[w]
        assert app2.fabric.poll(fabric_mod.WEIGHTS_TOPIC, w) is None


def test_restart_does_not_resend_a_pending_reply():
    app = _build_app()
    app.fabric.send(fabric_mod.WEIGHTS_TOPIC, 1, WeightsMessage(
        vector_clock=0, key_range=KeyRange(0, app.server.task.num_params),
        values=app.server.theta))
    app.server.start_training_loop()
    assert app.fabric.pending(fabric_mod.WEIGHTS_TOPIC, 1) == 1
    assert app.fabric.pending(fabric_mod.WEIGHTS_TOPIC, 0) == 1


def test_checkpoint_every_zero_means_exit_only(tmp_path):
    app = _build_app()
    app.server.checkpoint_path = str(tmp_path / "never.npz")
    app.server.checkpoint_every = 0
    app.run_serial(max_server_iterations=8)
    assert not os.path.exists(app.server.checkpoint_path)


def test_checkpoint_every_saves_on_schedule(tmp_path):
    app = _build_app()
    app.server.checkpoint_path = str(tmp_path / "every.npz")
    app.server.checkpoint_every = 8
    app.run_serial(max_server_iterations=20)
    with np.load(app.server.checkpoint_path) as z:
        assert int(z["iterations"]) == 16


def test_fused_checkpoints_and_resumes(tmp_path):
    app = _build_app()
    app.server.checkpoint_path = str(tmp_path / "fused.npz")
    app.server.checkpoint_every = 8
    app.run_fused_bsp(max_server_iterations=16, log_metrics=False)
    with np.load(app.server.checkpoint_path) as z:
        assert int(z["iterations"]) >= 8
    app2 = _build_app()
    ckpt.restore(str(tmp_path / "fused.npz"), app2.server)
    c0 = min(app2.server.tracker.clocks)
    app2.run_fused_bsp(max_server_iterations=app2.server.iterations + 8,
                       log_metrics=False)
    assert min(app2.server.tracker.clocks) > c0


def test_checkpoint_shape_mismatch(tmp_path):
    app = _build_app()
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, app.server)
    other = StreamingPSApp(_small_cfg(0, num_workers=2), device="cpu")
    with pytest.raises(ValueError, match="worker count"):
        ckpt.restore(path, other.server)


def test_maybe_restore_missing(tmp_path):
    assert not ckpt.maybe_restore(str(tmp_path / "nope.npz"),
                                  _build_app().server)


def test_restore_checkpoint_only_before_the_drive_loop(tmp_path):
    """The fused slab cache and in-flight messages predate a restore made
    after a drive loop ran: the app refuses it."""
    app = _build_app()
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, app.server, buffers=app.buffers)
    fresh = _build_app()
    assert fresh.restore_checkpoint(path)
    assert not fresh.restore_checkpoint(str(tmp_path / "nope.npz"))
    for drive in (lambda a: a.run_serial(4),
                  lambda a: a.run_fused_bsp(4, log_metrics=False)):
        used = _build_app()
        drive(used)
        with pytest.raises(RuntimeError, match="before the first drive"):
            used.restore_checkpoint(path)


def test_csvlog_append_mode(tmp_path):
    p = tmp_path / "log.csv"
    s1 = CsvLogSink(str(p), SERVER_HEADER)
    s1("row1")
    s1.close()
    s2 = CsvLogSink(str(p), SERVER_HEADER, append=True)
    s2("row2")
    s2.close()
    assert p.read_text().splitlines() == [SERVER_HEADER, "row1", "row2"]


# -- resume against an uninterrupted run, bit for bit ------------------------

def _strip(rows):
    return [r.split(";", 1)[1] for r in rows]


@pytest.mark.parametrize("compress", ["none", "int8"])
def test_resume_equals_uninterrupted_run(compress, tmp_path):
    """On static data: 100 iterations, save, restore into a fresh app, 100
    more, equals a 200-iteration run: theta, residuals and the rows of
    the second half, bitwise."""
    whole_logs = {"server": [], "worker": []}
    whole = _build_app(logs=whole_logs, compress=compress)
    whole.run_serial(100)
    whole.flush_logs()
    cut = (len(whole_logs["server"]), len(whole_logs["worker"]))
    whole.run_serial(200)
    whole.close_logs()

    first = _build_app(compress=compress)
    first.server.checkpoint_path = str(tmp_path / "ck.npz")
    first.server.checkpoint_buffers = first.buffers
    first.run_serial(100)
    first.server.save_checkpoint_now()
    first.close_logs()
    resumed_logs = {"server": [], "worker": []}
    resumed = _build_app(logs=resumed_logs, compress=compress)
    for b in resumed.buffers:            # the checkpoint brings them back
        b.restore_state(SlidingBuffer(8, b.cfg).state())
    assert resumed.restore_checkpoint(first.server.checkpoint_path)
    resumed.run_serial(200)
    resumed.close_logs()

    assert torch.equal(resumed.server.theta, whole.server.theta)
    assert resumed.server.tracker.clocks == whole.server.tracker.clocks
    assert _strip(resumed_logs["server"]) == _strip(
        whole_logs["server"][cut[0]:])
    assert _strip(resumed_logs["worker"]) == _strip(
        whole_logs["worker"][cut[1]:])
    for w in range(4):
        if compress != "none":
            assert torch.equal(resumed.compressors[w].residual,
                               whole.compressors[w].residual)


# -- checkpoints across the two packages -------------------------------------

F, C, W = 16, 3, 3


def _pair_app(app_cls, mod, **kw):
    cfg = mod.PSConfig(
        num_workers=W, consistency_model=2, compress="int8",
        model=mod.ModelConfig(num_features=F, num_classes=C),
        buffer=mod.BufferConfig(min_size=4, max_size=16),
        **({"use_gang": False, "eval_async": False} if mod is jconfig
           else {}))
    x, y = generate(90, F, C, seed=4)
    app = app_cls(cfg, test_x=x[-20:], test_y=y[-20:],
                  clock_ms=iter(range(0, 10 ** 9, 30)).__next__, **kw)
    for i in range(60):
        app.data_sink(i % W, {j: float(v) for j, v in enumerate(x[i]) if v},
                      int(y[i]))
    return app


def _contents(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same_archive(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def test_jax_checkpoint_restores_into_the_port_bitwise(tmp_path):
    japp = _pair_app(JApp, jconfig)
    japp.run_serial(11)
    japp.server.remove_worker(2)
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, japp.server, buffers=japp.buffers,
               residuals=japp.compressors)
    tapp = _pair_app(StreamingPSApp, config, device="cpu")
    assert tapp.restore_checkpoint(path)
    s = tapp.server
    assert s.theta.numpy().tobytes() == np.asarray(
        japp.server.theta).tobytes()
    assert s.tracker.clocks == japp.server.tracker.clocks
    assert [t.weights_message_sent for t in s.tracker.tracker] == [
        t.weights_message_sent for t in japp.server.tracker.tracker]
    assert s.tracker.active_workers == [0, 1]
    assert (s.iterations, s.run_id) == (japp.server.iterations,
                                        japp.server.run_id)
    for ours, theirs in zip(tapp.buffers, japp.buffers):
        for k, v in theirs.state().items():
            assert ours.state()[k].tobytes() == v.tobytes(), k
    for w in range(W):
        assert tapp.compressors[w].state().tobytes() == np.asarray(
            japp.compressors[w].residual).tobytes()
    # and re-saved by the port, it is the same archive
    again = str(tmp_path / "again.npz")
    ckpt.save(again, s, buffers=tapp.buffers, residuals=tapp.compressors)
    _same_archive(_contents(again), _contents(path))


def test_port_checkpoint_restores_into_jax_bitwise(tmp_path):
    tapp = _pair_app(StreamingPSApp, config, device="cpu")
    tapp.run_serial(11)
    tapp.server.remove_worker(0)
    path = str(tmp_path / "port.npz")
    ckpt.save(path, tapp.server, buffers=tapp.buffers,
              residuals=tapp.compressors)
    japp = _pair_app(JApp, jconfig)
    assert jckpt.maybe_restore(path, japp.server, buffers=japp.buffers,
                               residuals=japp.compressors)
    assert np.asarray(japp.server.theta).tobytes() == \
        tapp.server.theta.numpy().tobytes()
    assert japp.server.tracker.clocks == tapp.server.tracker.clocks
    assert japp.server.tracker.active_workers == [1, 2]
    assert japp.server.run_id == tapp.server.run_id
    for ours, theirs in zip(tapp.buffers, japp.buffers):
        for k, v in ours.state().items():
            assert theirs.state()[k].tobytes() == v.tobytes(), k
    for w in range(W):
        assert np.asarray(japp.compressors[w].residual).tobytes() == \
            tapp.compressors[w].state().tobytes()
    again = str(tmp_path / "again.npz")
    jckpt.save(again, japp.server, buffers=japp.buffers,
               residuals=japp.compressors)
    _same_archive(_contents(again), _contents(path))


# -- the device slab after a restore ------------------------------------------

@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_incremental_slab_equals_full_after_a_restore(kind):
    """A restore marks every slot dirty and bumps the version, so the
    incremental store uploads the restored rows: bitwise the store that
    re-uploads the whole slab on every change."""
    apps = [_build_app(num_workers=2, slab_dtype=kind,
                       slab_incremental=inc) for inc in (True, False)]
    other = [_filled_buffer(nf=8, n=25, seed=s).state() for s in (8, 9)]
    rng = np.random.default_rng(6)
    extra = [({j: float(v) for j, v in enumerate(rng.normal(size=8))},
              int(rng.integers(1, 3))) for _ in range(6)]
    for app in apps:
        app.run_serial(4)
        for b, st in zip(app.buffers, other):
            b.restore_state(st)
        app.run_serial(8)
        for i, row in enumerate(extra):
            app.data_sink(i % 2, *row)
        app.run_serial(12)
        app.close_logs()
    inc, full = apps
    assert torch.equal(inc.server.theta, full.server.theta)
    for a, b in zip(inc.workers, full.workers):
        xa, ya, ma = a._slab_store.arrays()
        xb, yb, mb = b._slab_store.arrays()
        for p, q in zip(tuple(xa) if kind == "int8" else (xa,),
                        tuple(xb) if kind == "int8" else (xb,)):
            assert torch.equal(p, q)
        assert torch.equal(ya, yb) and torch.equal(ma, mb)
    assert inc.workers[0]._slab_store.full_uploads >= 2


# -- the CLI -------------------------------------------------------------------

def _cli(tmp_path, iters, *flags):
    return cli_run.main([
        "-training", "train.csv", "-test", "test.csv", "--num_features", "16",
        "--num_classes", "3", "--num_workers", "2", "-c", "0", "-p", "0",
        "-l", "-v", "-min", "8", "-max", "32", "--mode", "serial",
        "--max_iterations", str(iters), "--checkpoint", "ck.npz",
        "--checkpoint_every", "10", *flags])


@pytest.mark.parametrize("compress", ["none", "int8"])
def test_cli_checkpoint_resume(compress, tmp_path, monkeypatch, capsys):
    x, y = generate(300, 16, 3, seed=1)
    write_csv(str(tmp_path / "train.csv"), x[:240], y[:240])
    write_csv(str(tmp_path / "test.csv"), x[240:], y[240:])
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("KPS_PLATFORM", "cpu")
    assert _cli(tmp_path, 20, "--compress", compress) == 0
    first = capsys.readouterr()
    assert "restored checkpoint" not in first.out
    with np.load("ck.npz") as z:
        assert int(z["iterations"]) == 20
        residuals = sorted(k for k in z.files if k.startswith("ef"))
    assert residuals == ([] if compress == "none"
                         else ["ef0_residual", "ef1_residual"])
    rows_before = (tmp_path / "logs-server.csv").read_text().splitlines()
    assert _cli(tmp_path, 40, "--compress", compress) == 0
    out = capsys.readouterr()
    assert "restored checkpoint at iteration 20" in out.out
    stats = json.loads([ln for ln in out.err.splitlines() if ln.startswith(
        "kafka_ps_tpu_torch run: ")][-1].split(": ", 1)[1])
    assert stats["server_iterations"] == 40
    if compress != "none":
        c = stats["compress"]
        assert c["codec"] == "int8" and c["raw_bytes"] == 4 * 68
        assert c["message_bytes"] == 4 + 68   # one chunk's scale, q
    server = (tmp_path / "logs-server.csv").read_text().splitlines()
    assert server[:len(rows_before)] == rows_before
    assert server.count(SERVER_HEADER) == 1
    clocks = [int(r.split(";")[2]) for r in server[1:]]
    assert clocks == sorted(clocks) and clocks[-1] > clocks[
        len(rows_before) - 2]
    events = (tmp_path / "logs-events.csv").read_text().splitlines()
    assert events[0] == EVENTS_HEADER
    assert [e.split(";")[1:] for e in events[1:]] == [["resume", "-1"]]
    with np.load("ck.npz") as z:
        assert int(z["iterations"]) == 40
