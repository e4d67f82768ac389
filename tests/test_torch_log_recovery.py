"""Crash recovery on the port's durable log (kafka_ps_tpu_torch/log/):
restart = restore the checkpoint + replay the unconsumed tail, with each
delta applied once (the server drops a replayed gradient whose clock it
already applied).

The cases of tests/test_log_recovery.py run on the port (server restart,
compressed restart with its residuals, full replay without a checkpoint,
unconsumed weights surviving a worker's death, a corrupted tail,
recover-once), each bitwise against an uninterrupted run inside the
port; then a replay that does not share the replayed weights between
workers, `--fused` over the log, a threaded run's offsets, a live
producer against commit points, a JAX package's log and checkpoint
replayed into the port (within rtol 1e-4, atol 1e-5 of the JAX
uninterrupted run; clocks and row keys exact), and the CLI killed with
SIGKILL at a fixed iteration (scripts/torch_kill_at.py) and restarted.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from kafka_ps_tpu.log import DurableFabric as JDurableFabric
from kafka_ps_tpu.log import LogConfig as JLogConfig
from kafka_ps_tpu.runtime.app import StreamingPSApp as JApp
from kafka_ps_tpu.utils import config as jconfig
from kafka_ps_tpu_torch.data.synth import generate, write_csv
from kafka_ps_tpu_torch.log import DurableFabric, LogConfig
from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime import serde
from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
from kafka_ps_tpu_torch.utils import checkpoint as ckpt
from kafka_ps_tpu_torch.utils.config import (BufferConfig, ModelConfig,
                                             PSConfig, StreamConfig)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 4


def small_cfg(compress="none", c=0, mod=None):
    mod = mod or sys.modules[__name__]
    return mod.PSConfig(
        num_workers=W,
        consistency_model=c,
        model=mod.ModelConfig(num_features=8, num_classes=2),
        buffer=mod.BufferConfig(min_size=8, max_size=32),
        stream=mod.StreamConfig(time_per_event_ms=1.0),
        compress=compress,
    )


def make_dataset(n=256, f=8, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, size=n).astype(np.int32)
    centers = np.array([[2.5] * f, [-2.5] * f], np.float32)
    x = (centers[y] + rng.normal(scale=0.5, size=(n, f))).astype(np.float32)
    return x, y


def build_app(fabric=None, compress="none", logs=None, c=0):
    x, y = make_dataset()
    logs = logs if logs is not None else ([], [])
    return StreamingPSApp(small_cfg(compress, c), test_x=x, test_y=y,
                          server_log=logs[0].append,
                          worker_log=logs[1].append,
                          clock_ms=lambda: 0.0, device="cpu", fabric=fabric)


def durable(path):
    return DurableFabric(str(path), LogConfig(fsync="none"), device="cpu")


def fill(app, x, y, start=0):
    for i in range(len(x)):
        app.data_sink((start + i) % W,
                      {j: float(v) for j, v in enumerate(x[i]) if v != 0},
                      int(y[i]))


def arm_checkpoints(app, path, every=16):
    app.server.checkpoint_path = str(path)
    app.server.checkpoint_every = every
    app.server.checkpoint_buffers = app.buffers


def strip(rows):
    return [r.split(";", 1)[1] for r in rows]


def first_of_each_clock(rows):
    """Stamp-stripped worker rows, one per (worker, clock): a replayed
    weights message a plain worker already trained on runs again, and its
    row must equal the first one bitwise."""
    seen: dict[tuple[str, str], str] = {}
    for r in strip(rows):
        key = tuple(r.split(";")[:2])
        assert seen.setdefault(key, r) == r, f"duplicate row differs: {r}"
    return sorted(seen.values())


def rows_from(rows, clocks):
    """Stamp-stripped rows whose clock is at least its worker's restored
    clock (`clocks[w]`; server rows are worker 0's eval clocks)."""
    out = []
    for r in strip(rows):
        part, clock = (int(v) for v in r.split(";")[:2])
        if clock >= clocks[max(part, 0)]:
            out.append(r)
    return out


def crash_and_restart(tmp_path, compress="none", crash_at=24, total=40):
    """(uninterrupted app and logs, restarted app and logs, restored
    clocks, replay counts): the durable run is abandoned at `crash_at` —
    no close, no final save — and a fresh app over the same log restores
    the checkpoint, recovers and runs to `total`."""
    x, y = make_dataset()
    base_logs = ([], [])
    base = build_app(compress=compress, logs=base_logs)
    fill(base, x, y)
    base.run_serial(total)
    base.close_logs()

    app1 = build_app(durable(tmp_path / "wal"), compress)
    arm_checkpoints(app1, tmp_path / "ck.npz")
    fill(app1, x, y)
    app1.run_serial(crash_at)
    app1.close_logs()
    with np.load(tmp_path / "ck.npz") as z:
        assert 16 <= int(z["iterations"]) < crash_at
        assert "log_offsets" in z.files     # the commit point's offsets

    logs = ([], [])
    app2 = build_app(durable(tmp_path / "wal"), compress, logs)
    arm_checkpoints(app2, tmp_path / "ck.npz")
    assert app2.restore_checkpoint(str(tmp_path / "ck.npz"))
    assert app2.server.restored_log_offsets is not None
    clocks = list(app2.server.tracker.clocks)
    counts = app2.recover_durable()
    app2.run_serial(total)
    app2.close_logs()
    return (base, base_logs), (app2, logs), clocks, counts


@pytest.mark.parametrize("compress", ["none", "int8"])
def test_server_restart_replays_to_identical_theta(tmp_path, compress):
    """40 iterations uninterrupted (volatile fabric) against 24 + a
    crash + a recovered restart to 40 (durable fabric): theta, clocks,
    the restarted run's rows and, under int8, the error-feedback
    residuals are bitwise the uninterrupted run's; the restart replayed
    weights and gradients and dropped the redelivered deltas."""
    (base, base_logs), (app2, logs), clocks, counts = crash_and_restart(
        tmp_path, compress)
    assert counts[fabric_mod.GRADIENTS_TOPIC] > 0
    assert counts[fabric_mod.WEIGHTS_TOPIC] > 0
    assert torch.equal(app2.server.theta, base.server.theta)
    assert app2.server.tracker.clocks == base.server.tracker.clocks
    assert app2.server.duplicate_gradients_dropped > 0
    assert strip(logs[0]) == rows_from(base_logs[0], clocks)
    assert first_of_each_clock(logs[1]) == sorted(rows_from(base_logs[1],
                                                            clocks))
    for w in range(W):
        if compress != "none":
            assert torch.equal(app2.compressors[w].residual,
                               base.compressors[w].residual)
    if compress != "none":
        # a compressed worker answers a replayed clock from its cache
        assert sum(w.redelivered for w in app2.workers) > 0


def test_replay_does_not_rest_on_shared_weights(tmp_path):
    """recover() decodes byte-identical weights frames (one release to
    several workers) to one message; give every queued weights message a
    tensor of its own and the restart is still bitwise: the gang's
    kernels take a pointer per member."""
    x, y = make_dataset()
    base = build_app()
    fill(base, x, y)
    base.run_serial(40)
    app1 = build_app(durable(tmp_path / "wal"))
    arm_checkpoints(app1, tmp_path / "ck.npz")
    fill(app1, x, y)
    app1.run_serial(24)
    app2 = build_app(durable(tmp_path / "wal"))
    assert app2.restore_checkpoint(str(tmp_path / "ck.npz"))
    app2.recover_durable()
    queues = app2.fabric._queues
    first = [queues[(fabric_mod.WEIGHTS_TOPIC, w)][0][1] for w in range(W)]
    assert all(m is first[0] for m in first)          # shared on replay
    for w in range(W):
        q = queues[(fabric_mod.WEIGHTS_TOPIC, w)]
        for i, (offset, msg) in enumerate(q):
            q[i] = (offset, dataclasses.replace(msg,
                                                values=msg.values.clone()))
    app2.run_serial(40)
    assert torch.equal(app2.server.theta, base.server.theta)
    for app in (base, app1, app2):
        app.close_logs()


def test_recovery_without_checkpoint_is_full_replay(tmp_path):
    """Crash before the first commit point: recovery replays every
    partition from offset 0 — rows re-enter the buffers from the log,
    gradients re-apply in order — and converges to the uninterrupted
    run's exact theta."""
    x, y = make_dataset()
    base = build_app()
    fill(base, x, y)
    base.run_serial(24)

    app1 = build_app(durable(tmp_path / "wal"))
    fill(app1, x, y)
    app1.run_serial(12)

    app2 = build_app(durable(tmp_path / "wal"))
    counts = app2.recover_durable()
    assert counts[fabric_mod.INPUT_DATA_TOPIC] == len(x)
    assert [b.count for b in app2.buffers] == [b.count for b in app1.buffers]
    for b1, b2 in zip(app1.buffers, app2.buffers):
        np.testing.assert_array_equal(b1.x, b2.x)
    # the producer-resume skip covers every logged row
    assert app2._ingest_skip == len(x)
    fill(app2, x[:5], y[:5])
    assert app2.skipped_rows == 5
    app2.run_serial(24)
    assert torch.equal(app2.server.theta, base.server.theta)
    for app in (base, app1, app2):
        app.close_logs()


def test_worker_restart_unconsumed_weights_survive(tmp_path):
    """A weights message sent but never consumed (the worker died first)
    is re-enqueued by recovery, and the restarted server does NOT send a
    second copy for the same clock (start_training_loop's pending check)
    — the worker sees exactly one delivery."""
    x, y = make_dataset()
    app1 = build_app(durable(tmp_path / "wal"))
    app1.server.checkpoint_path = str(tmp_path / "ck.npz")
    fill(app1, x, y)
    app1.server.start_training_loop()       # bootstrap broadcast logged
    # worker 0 consumes its copy and replies; workers 1-3 die first
    m = app1.fabric.poll(fabric_mod.WEIGHTS_TOPIC, 0)
    app1.workers[0].on_weights(m)
    app1.server.save_checkpoint_now()       # commit point mid-flight

    app2 = build_app(durable(tmp_path / "wal"))
    assert app2.restore_checkpoint(str(tmp_path / "ck.npz"))
    app2.recover_durable()
    # workers 1-3's unconsumed bootstrap copies came back from the log
    for w in (1, 2, 3):
        assert app2.fabric.pending(fabric_mod.WEIGHTS_TOPIC, w) == 1
    app2.server.start_training_loop()
    for w in (1, 2, 3):
        assert app2.fabric.pending(fabric_mod.WEIGHTS_TOPIC, w) == 1, \
            "pending check failed: bootstrap re-sent on top of the replay"
    # and each replayed message is deliverable exactly once
    got = app2.fabric.poll(fabric_mod.WEIGHTS_TOPIC, 1)
    assert got is not None and got.vector_clock == 0
    assert app2.fabric.poll(fabric_mod.WEIGHTS_TOPIC, 1) is None
    for app in (app1, app2):
        app.close_logs()


def test_corrupted_tail_is_discarded_and_regenerated(tmp_path):
    """Garbage bytes on the gradients log tail (a torn write the crash
    left behind): recovery truncates them via CRC, the lost deltas are
    recomputed from the replayed weights, and the run still converges to
    the uninterrupted baseline."""
    x, y = make_dataset()
    base = build_app()
    fill(base, x, y)
    base.run_serial(40)

    app1 = build_app(durable(tmp_path / "wal"))
    arm_checkpoints(app1, tmp_path / "ck.npz")
    fill(app1, x, y)
    app1.run_serial(24)

    grad_log = app1.fabric.manager.get(fabric_mod.GRADIENTS_TOPIC, 0)
    with open(grad_log.active.log_path, "r+b") as fh:
        fh.seek(-11, os.SEEK_END)
        fh.write(b"\xde\xad\xbe\xef garbage")

    fabric2 = durable(tmp_path / "wal")
    assert fabric2.manager.truncated_bytes > 0
    app2 = build_app(fabric2)
    arm_checkpoints(app2, tmp_path / "ck.npz")
    assert app2.restore_checkpoint(str(tmp_path / "ck.npz"))
    app2.recover_durable()
    app2.run_serial(40)
    assert torch.equal(app2.server.theta, base.server.theta)
    for app in (base, app1, app2):
        app.close_logs()


def test_latest_logged_weights_is_the_newest_release(tmp_path):
    """What a restarting serving process would publish: the newest logged
    weights across the partitions, decoded bitwise, here the θ the
    abandoned run released last."""
    x, y = make_dataset()
    app1 = build_app(durable(tmp_path / "wal"))
    fill(app1, x, y)
    app1.run_serial(24)
    app1.close_logs()
    fabric = durable(tmp_path / "wal")
    latest = fabric.latest_logged_weights()
    assert latest.vector_clock == max(app1.server.tracker.clocks)
    assert torch.equal(latest.values, app1.server.theta)
    fabric.close()
    assert durable(tmp_path / "empty").latest_logged_weights() is None


def test_recover_is_once_only(tmp_path):
    f = durable(tmp_path / "wal")
    f.recover()
    with pytest.raises(RuntimeError, match="once"):
        f.recover()
    f.close()


def test_recover_puts_tensors_on_the_card_by_default(tmp_path, monkeypatch):
    """The durable fabric's replay device follows resolve_device: with no
    device asked for it is the card, so here, with no card, it raises."""
    monkeypatch.delenv("KPS_PLATFORM", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: tests/test_torch_cuda.py")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        DurableFabric(str(tmp_path / "wal"))


# -- --fused over the log -----------------------------------------------------

def test_fused_resume_replays_rows_and_matches_uninterrupted(tmp_path):
    """--fused sends no messages; the log carries its input rows.  Rows
    arriving after a commit point are replayed into the restored buffers,
    and the resumed fused run is bitwise the uninterrupted one."""
    x, y = make_dataset()
    a, b = slice(0, 96), slice(96, 160)
    base = build_app()
    fill(base, x[a], y[a])
    base.run_fused_bsp(16)
    fill(base, x[b], y[b], start=96)
    base.run_fused_bsp(48)

    app1 = build_app(durable(tmp_path / "wal"))
    arm_checkpoints(app1, tmp_path / "ck.npz")
    fill(app1, x[a], y[a])
    app1.run_fused_bsp(16)                  # commit point at 16
    fill(app1, x[b], y[b], start=96)        # logged past the commit
    app1.run_fused_bsp(28)                  # abandoned

    app2 = build_app(durable(tmp_path / "wal"))
    arm_checkpoints(app2, tmp_path / "ck.npz")
    assert app2.restore_checkpoint(str(tmp_path / "ck.npz"))
    assert app2.server.iterations == 16
    counts = app2.recover_durable()
    assert counts == {fabric_mod.WEIGHTS_TOPIC: 0,
                      fabric_mod.GRADIENTS_TOPIC: 0,
                      fabric_mod.INPUT_DATA_TOPIC: 64}
    app2.run_fused_bsp(48)
    assert torch.equal(app2.server.theta, base.server.theta)
    assert app2.server.tracker.clocks == base.server.tracker.clocks
    for app in (base, app1, app2):
        app.close_logs()


# -- threads ------------------------------------------------------------------

def test_threaded_offsets_are_unique_and_in_queue_order(tmp_path):
    """Threaded -c 2 on the durable log with a producer thread feeding
    rows while the server checkpoints: every partition's offsets on disk
    are 0..n-1, the server applied gradients in the log's offset order,
    and at every commit point each worker's buffer holds exactly the rows
    its ingest offset counts (the commit lock)."""
    x, y = make_dataset(n=1200)
    app = build_app(durable(tmp_path / "wal"), c=2)
    arm_checkpoints(app, tmp_path / "ck.npz", every=4)
    fill(app, x[:64], y[:64])
    applied = []
    received = app.server.tracker.received_message

    def record(worker, clock):
        applied.append((worker, clock))
        return received(worker, clock)

    app.server.tracker.received_message = record
    mismatches = []
    save = ckpt.save

    def checked_save(path, server, buffers=None, log_offsets=None,
                     residuals=None):
        for w, buf in enumerate(buffers):
            n = log_offsets.get(f"{fabric_mod.INPUT_DATA_TOPIC}/{w}", 0)
            if n != buf.num_tuples_seen:
                mismatches.append((w, n, buf.num_tuples_seen))
        return save(path, server, buffers=buffers, log_offsets=log_offsets,
                    residuals=residuals)

    stop = threading.Event()

    def produce():
        for i in range(64, len(x)):
            if stop.is_set():
                return
            fill(app, x[i:i + 1], y[i:i + 1], start=i)
            time.sleep(0.0005)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    producer = threading.Thread(target=produce)
    try:
        ckpt.save = checked_save
        producer.start()
        app.run_threaded(120, poll_timeout=0.02)
    finally:
        stop.set()
        producer.join(timeout=60)
        ckpt.save = save
        sys.setswitchinterval(old)
        app.close_logs()
    assert not producer.is_alive()
    assert app.server.checkpoint_saves > 0 and not mismatches, mismatches
    app.fabric.close()
    reopened = durable(tmp_path / "wal")
    for topic, key in reopened.manager.partitions():
        offsets = [o for o, _ in reopened.manager.get(topic,
                                                      key).read_from(0)]
        assert offsets == list(range(len(offsets))), (topic, key)
    logged = [serde.from_bytes(p, "cpu") for _, p in reopened.manager.get(
        fabric_mod.GRADIENTS_TOPIC, 0).read_from(0)]
    order = [(m.worker_id, m.vector_clock) for m in logged]
    assert len(applied) >= 120
    assert applied == order[:len(applied)]
    reopened.close()


# -- the JAX package's log replayed into the port -----------------------------

def _jax_app(fabric=None, logs=None):
    x, y = make_dataset()
    cfg = dataclasses.replace(small_cfg(mod=jconfig), use_gang=False,
                              eval_async=False)
    logs = logs if logs is not None else ([], [])
    return JApp(cfg, test_x=x, test_y=y, server_log=logs[0].append,
                worker_log=logs[1].append, clock_ms=lambda: 0.0,
                fabric=fabric)


def test_jax_log_and_checkpoint_replay_into_the_port(tmp_path):
    """A JAX durable run abandoned after a commit point; the port
    restores its checkpoint, replays its log and runs on: θ within rtol
    1e-4, atol 1e-5 of the JAX uninterrupted run, clocks and row keys
    exact."""
    x, y = make_dataset()
    base_logs = ([], [])
    jbase = _jax_app(logs=base_logs)
    fill(jbase, x, y)
    jbase.run_serial(max_server_iterations=40)
    jbase.close_logs()

    jrun = _jax_app(JDurableFabric(str(tmp_path / "wal"),
                                   JLogConfig(fsync="none")))
    arm_checkpoints(jrun, tmp_path / "ck.npz")
    fill(jrun, x, y)
    jrun.run_serial(max_server_iterations=24)    # abandoned
    jrun.close_logs()

    logs = ([], [])
    app = build_app(durable(tmp_path / "wal"), logs=logs)
    assert app.restore_checkpoint(str(tmp_path / "ck.npz"))
    assert app.server.restored_log_offsets
    clocks = list(app.server.tracker.clocks)
    counts = app.recover_durable()
    assert counts[fabric_mod.GRADIENTS_TOPIC] > 0
    app.run_serial(40)
    app.close_logs()
    np.testing.assert_allclose(app.server.theta.numpy(),
                               np.asarray(jbase.server.theta),
                               rtol=1e-4, atol=1e-5)
    assert app.server.tracker.clocks == list(jbase.server.tracker.clocks)

    def keys(rows):
        return sorted(tuple(r.split(";")[:2]) + tuple(r.split(";")[5:])
                      for r in rows)

    assert keys(strip(logs[0])) == keys(rows_from(base_logs[0], clocks))
    assert keys(first_of_each_clock(logs[1])) == \
        keys(rows_from(base_logs[1], clocks))


# -- whole-process SIGKILL through the CLI -----------------------------------

def _env() -> dict:
    """The CLI on the CPU, its BLAS on one thread in MKL's reproducible
    mode: MKL may otherwise pick kernels by the memory alignment of its
    operands, which moves the last bit of a product from one process to
    the next."""
    env = dict(os.environ)
    env.update(KPS_PLATFORM="cpu", OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               MKL_CBWR="COMPATIBLE")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


KILL_AT, TOTAL = 92, 160


@pytest.mark.parametrize("compress", ["none", "int8"])
def test_sigkill_restart_matches_uninterrupted_run(tmp_path, compress):
    """The CLI killed by SIGKILL at a fixed iteration past its fourth
    commit point (scripts/torch_kill_at.py), then restarted with the same
    --durable-log and --checkpoint: it restores, replays and finishes with
    the exact theta and clocks of an uninterrupted run.  The 512-row
    stream (4 workers x 128 prefill) is buffered whole before the first
    iteration, so serial mode is bitwise deterministic; under int8 the
    residuals ride the checkpoint through the kill."""
    x, y = generate(632, 16, 3, noise=1.0, sparsity=0.5, seed=0)
    write_csv(str(tmp_path / "train.csv"), x[:512], y[:512])
    write_csv(str(tmp_path / "test.csv"), x[512:], y[512:])
    for d in ("base", "crash"):
        (tmp_path / d).mkdir()

    args = ["-training", "../train.csv", "-test", "../test.csv",
            "--num_features", "16", "--num_classes", "3",
            "--num_workers", "4", "--mode", "serial", "-p", "2",
            "--eval_every", "10", "--max_iterations", str(TOTAL),
            "--checkpoint", "ck.npz", "--checkpoint_every", "20",
            "--compress", compress, "-v", "-l"]
    cli = [sys.executable, "-m", "kafka_ps_tpu_torch.cli.run"]

    def run(cmd, where):
        return subprocess.run(cmd, cwd=tmp_path / where, env=_env(),
                              capture_output=True, text=True, timeout=120)

    r = run(cli + args, "base")
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(tmp_path / "base" / "ck.npz") as z:
        theta_base = z["theta"].copy()
        clocks_base = z["clocks"].copy()
        assert int(z["iterations"]) == TOTAL

    wal = ["--durable-log", "wal", "--fsync", "interval"]
    kill = [sys.executable, os.path.join(REPO, "scripts", "torch_kill_at.py"),
            str(KILL_AT), "--"]
    r1 = run(kill + args + wal, "crash")
    assert r1.returncode == -signal.SIGKILL, r1.stderr[-3000:]
    with np.load(tmp_path / "crash" / "ck.npz") as z:
        crash_iters = int(z["iterations"])
    assert crash_iters == 80            # the last commit point before 92

    r2 = run(cli + args + wal, "crash")
    assert r2.returncode == 0, r2.stderr[-3000:]
    assert f"restored checkpoint at iteration {crash_iters}" in r2.stdout, \
        r2.stdout[-2000:]
    assert "durable-log replay" in r2.stdout, r2.stdout[-2000:]
    stats = [line for line in r2.stderr.splitlines()
             if line.startswith("kafka_ps_tpu_torch run: ")][-1]
    assert '"durable"' in stats and '"replay_s"' in stats
    with np.load(tmp_path / "crash" / "ck.npz") as z:
        assert int(z["iterations"]) == TOTAL
        np.testing.assert_array_equal(z["clocks"], clocks_base)
        np.testing.assert_array_equal(z["theta"], theta_base)
