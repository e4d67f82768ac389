"""Log-following read replicas (kafka_ps_tpu_torch/serving/replica.py) on
the CPU, against logs written by the port and by the JAX package (the
log files are byte for byte the same format).

  * an unsharded replica converges on the newest logged weights by
    vector clock, incrementally, with no duplicate publication;
  * a sharded replica (`DIR/shard<i>of<N>`) serves the assembled theta
    stamped with the frontier clock, publishes only when the frontier
    advances, is never torn under concurrent shard writers, and takes the
    shard layout when it starts before the shards make their logs;
  * a socket bridge over a durable fabric logs the weights it sends,
    plain and grouped for a relay, so a replica of its log publishes;
  * an engine over the replica's registry answers frontier-bounded
    reads; `server_runner --serve-replica` serves a trainer's log over a
    socket.

Every comparison is exact: the replica decodes the logged float32 bytes.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from kafka_ps_tpu.log import DurableFabric as JDurableFabric
from kafka_ps_tpu.log import LogConfig as JLogConfig
from kafka_ps_tpu.runtime.messages import KeyRange as JKeyRange
from kafka_ps_tpu.runtime.messages import WeightsMessage as JWeights
from kafka_ps_tpu_torch.log import DurableFabric, LogConfig
from kafka_ps_tpu_torch.models.task import get_task
from kafka_ps_tpu_torch.runtime import net, serde
from kafka_ps_tpu_torch.runtime.messages import KeyRange, WeightsMessage
from kafka_ps_tpu_torch.serving import StalenessError
from kafka_ps_tpu_torch.serving.engine import PredictionEngine
from kafka_ps_tpu_torch.serving.replica import (ReplicaFollower,
                                                discover_shards)
from kafka_ps_tpu_torch.utils.config import ModelConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fabric(package, root):
    if package == "jax":
        return JDurableFabric(str(root), JLogConfig(fsync="none"))
    return DurableFabric(str(root), LogConfig(fsync="none"), device="cpu")


def _wmsg(package, clock, lo, hi, fill):
    values = np.full(hi - lo, float(fill), np.float32)
    if package == "jax":
        return JWeights(clock, JKeyRange(lo, hi), values)
    return WeightsMessage(clock, KeyRange(lo, hi), torch.from_numpy(values))


@pytest.mark.parametrize("package", ["port", "jax"])
def test_replica_follows_an_unsharded_log_newest_by_clock(tmp_path, package):
    fab = _fabric(package, tmp_path)
    try:
        for clock in (1, 3, 2):
            for worker in (0, 1):
                fab.send("weights", worker, _wmsg(package, clock, 0, 8,
                                                  clock))
        rep = ReplicaFollower(str(tmp_path), device="cpu")
        assert rep.num_shards == 0 and discover_shards(str(tmp_path)) == []
        assert rep.catch_up() == 1 and rep.clock == 3
        assert torch.equal(rep.registry.latest.theta, torch.full((8,), 3.0))
        assert rep.registry.latest.theta.device.type == "cpu"
        assert rep.catch_up() == 0          # idle: no duplicate publish
        fab.send("weights", 0, _wmsg(package, 4, 0, 8, 4))
        assert rep.catch_up() == 1 and rep.clock == 4
        assert rep.records_read == 7 and rep.publications == 2
    finally:
        fab.close()


def test_replica_background_thread_follows(tmp_path):
    fab = _fabric("port", tmp_path)
    rep = ReplicaFollower(str(tmp_path), poll_interval_s=0.01, device="cpu")
    seen = []
    rep.on_publish = seen.append
    try:
        rep.start()
        with pytest.raises(RuntimeError):
            rep.start()
        fab.send("weights", 0, _wmsg("port", 11, 0, 4, 1))
        deadline = time.monotonic() + 5.0
        while rep.clock != 11 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert rep.clock == 11 and seen == [11]
    finally:
        rep.stop()
        fab.close()


def test_a_failed_tail_thread_is_kept_not_swallowed(tmp_path, monkeypatch):
    rep = ReplicaFollower(str(tmp_path), poll_interval_s=0.01, device="cpu")

    def broken():
        raise OSError("disk gone")

    monkeypatch.setattr(rep, "catch_up", broken)
    rep.start()
    deadline = time.monotonic() + 5.0
    while rep.error is None and time.monotonic() < deadline:
        time.sleep(0.01)
    rep.stop()
    assert isinstance(rep.error, OSError)


def _shard_fabrics(package, root, n=2, width=4):
    fabs = [_fabric(package, os.path.join(root, f"shard{i}of{n}"))
            for i in range(n)]
    return fabs, [(i * width, (i + 1) * width) for i in range(n)]


@pytest.mark.parametrize("package", ["port", "jax"])
def test_replica_serves_the_assembled_theta_of_a_sharded_log(tmp_path,
                                                             package):
    fabs, ranges = _shard_fabrics(package, str(tmp_path))
    try:
        fabs[0].send("weights", 0, _wmsg(package, 5, *ranges[0], 5))
        rep = ReplicaFollower(str(tmp_path), device="cpu")
        assert rep.num_shards == 2
        assert rep.catch_up() == 0          # half a cut does not publish
        assert rep.registry.latest is None
        fabs[1].send("weights", 0, _wmsg(package, 7, *ranges[1], 7))
        assert rep.catch_up() == 1
        snap = rep.registry.latest
        assert snap.vector_clock == 5       # the frontier, min(5, 7)
        assert torch.equal(snap.theta, torch.tensor([5.0] * 4 + [7.0] * 4))
        fabs[0].send("weights", 0, _wmsg(package, 9, *ranges[0], 9))
        assert rep.catch_up() == 1 and rep.registry.latest.vector_clock == 7
        fabs[0].send("weights", 0, _wmsg(package, 10, *ranges[0], 10))
        assert rep.catch_up() == 0          # the frontier stalled
    finally:
        for f in fabs:
            f.close()


@pytest.mark.parametrize("package", ["port", "jax"])
def test_replica_started_before_the_shards_takes_their_layout(tmp_path,
                                                              package):
    """A replica started on a root that holds no log yet finds the shard
    directories when they appear, one at a time, and serves their cut."""
    root = str(tmp_path / "wal")
    rep = ReplicaFollower(root, device="cpu")
    assert rep.num_shards == 0 and rep.catch_up() == 0
    fab0 = _fabric(package, os.path.join(root, "shard0of2"))
    fab1 = None
    try:
        fab0.send("weights", 0, _wmsg(package, 5, 0, 4, 5))
        assert rep.catch_up() == 0          # shard 1 has made nothing yet
        assert rep.num_shards == 2 and rep.registry.latest is None
        fab1 = _fabric(package, os.path.join(root, "shard1of2"))
        fab1.send("weights", 0, _wmsg(package, 6, 4, 8, 6))
        assert rep.catch_up() == 1 and rep.clock == 5
        assert torch.equal(rep.registry.latest.theta,
                           torch.tensor([5.0] * 4 + [6.0] * 4))
    finally:
        fab0.close()
        if fab1 is not None:
            fab1.close()


def test_replica_refuses_a_root_of_two_deployments(tmp_path):
    for name in ("shard0of2", "shard0of3"):
        os.makedirs(tmp_path / name)
    with pytest.raises(ValueError, match=r"\[2, 3\] shards"):
        ReplicaFollower(str(tmp_path), device="cpu")


def test_sharded_replica_snapshots_never_torn_under_writers(tmp_path):
    """Two shard writers racing a polling replica: every snapshot is a
    consistent cut (each slice uniform), stamped with the frontier of
    the slices it serves, and frontiers strictly increase."""
    fabs, ranges = _shard_fabrics("port", str(tmp_path))
    stop = threading.Event()

    def writer(i):
        clock = 0
        while not stop.is_set():
            clock += 1
            fabs[i].send("weights", 0, _wmsg("port", clock, *ranges[i],
                                             clock))

    threads = [threading.Thread(target=writer, args=(i,), daemon=True)
               for i in range(2)]
    for t in threads:
        t.start()
    rep = ReplicaFollower(str(tmp_path), device="cpu")
    seen = []
    try:
        for _ in range(200):
            if rep.catch_up():
                seen.append(rep.registry.latest)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10.0)
        for f in fabs:
            f.close()
    assert len(seen) >= 2
    last = -1
    for snap in seen:
        half0, half1 = snap.theta[:4], snap.theta[4:]
        assert len(set(half0.tolist())) == 1, snap.theta
        assert len(set(half1.tolist())) == 1, snap.theta
        frontier = min(float(half0[0]), float(half1[0]))
        assert snap.vector_clock == frontier > last
        last = frontier


def test_replica_engine_serves_frontier_bounded_reads(tmp_path):
    cfg = ModelConfig(num_features=4, num_classes=2)
    task = get_task("logreg", cfg)
    n = task.num_params
    half = (n + 1) // 2
    fabs, _ = _shard_fabrics("port", str(tmp_path), width=half)
    try:
        fabs[0].send("weights", 0, _wmsg("port", 3, 0, half, 0.1))
        fabs[1].send("weights", 0, _wmsg("port", 4, half, n, 0.2))
        rep = ReplicaFollower(str(tmp_path), device="cpu")
        assert rep.catch_up() == 1
        engine = PredictionEngine(task, rep.registry)
        try:
            x = np.ones(cfg.num_features, np.float32)
            assert engine.predict(x, min_clock=3).vector_clock == 3
            with pytest.raises(StalenessError):
                engine.predict(x, min_clock=4)
        finally:
            engine.close()
    finally:
        for f in fabs:
            f.close()


def test_a_bridged_durable_fabric_logs_the_weights_it_sends(tmp_path,
                                                           monkeypatch):
    """A shard server of a split deployment sends weights over its socket;
    on a durable fabric it also logs them, consumed at once, so a replica
    of its log sees them (the JAX bridge logs none: ROADMAP C.14).  The
    log's frame and the socket's payload are one encode."""
    encodes = []
    to_bytes = serde.to_bytes
    monkeypatch.setattr(serde, "to_bytes",
                        lambda m: encodes.append(m) or to_bytes(m))
    fab = DurableFabric(str(tmp_path), LogConfig(fsync="none"), device="cpu")
    bridge = net.ServerBridge(device="cpu")
    wrapped = bridge.wrap(fab)
    worker = net.WorkerBridge("127.0.0.1", bridge.port, [0], device="cpu")
    local = worker.make_fabric()
    reader = threading.Thread(target=worker.run_reader, args=({},),
                              daemon=True)
    reader.start()
    try:
        bridge.wait_for_connected([0], timeout=10.0)
        msg = WeightsMessage(3, KeyRange(0, 8), torch.full((8,), 0.5))
        wrapped.send("weights", 0, msg)
        got = local.poll_blocking("weights", 0, timeout=10.0)
        assert got.vector_clock == 3 and torch.equal(got.values, msg.values)
        assert encodes == [msg]
        assert wrapped.pending("weights", 0) == 0
        assert wrapped.snapshot_offsets()["weights/0"] == 1
        rep = ReplicaFollower(str(tmp_path), device="cpu")
        assert rep.catch_up() == 1 and rep.clock == 3
        assert torch.equal(rep.registry.latest.theta, msg.values)
    finally:
        worker.close()
        bridge.close()
        reader.join(timeout=10.0)
        fab.close()


def test_a_bridged_durable_fabric_logs_its_grouped_weights(tmp_path):
    """A grouped frame to a relay connection (T_WEIGHTS_AGG) is logged
    once, at its newest member's clock and consumed at once, so a replica
    of a relayed deployment's log publishes it."""
    fab = DurableFabric(str(tmp_path), LogConfig(fsync="none"), device="cpu")
    bridge = net.ServerBridge(run_id=1, device="cpu")
    wrapped = bridge.wrap(fab)
    theta = torch.linspace(-1, 1, 8)
    sock = socket.create_connection(("127.0.0.1", bridge.port))
    try:
        # an aggregator's HELLO for members 0 and 1
        net.send_frame(sock, net.T_HELLO, 0, struct.pack("<q2q", 2, 0, 1)
                       + struct.pack("<Bf", 0, 0.0) + b"\x00\x00\x01")
        assert net.recv_frame(sock)[0] == net.T_CONFIG
        bridge.wait_for_connected([0, 1], timeout=10.0)
        build = lambda clock: WeightsMessage(clock, KeyRange(0, 8), theta)
        assert bridge.send_weights_group([(0, 3), (1, 4)], build) == {0, 1}
        assert wrapped.pending("weights", 1) == 0
        assert wrapped.snapshot_offsets() == {"weights/1": 1}
        rep = ReplicaFollower(str(tmp_path), device="cpu")
        assert rep.catch_up() == 1 and rep.clock == 4
        assert torch.equal(rep.registry.latest.theta, theta)
    finally:
        sock.close()
        bridge.close()
        fab.close()


def test_serve_replica_runner_answers_over_a_socket(tmp_path):
    """`server_runner --serve-replica --durable-log DIR` on a log whose
    newest weights are at clock 6: a client's answers carry clock 6, a
    bound past it is STALE, and SIGINT ends the process with its stats."""
    cfg = ModelConfig(num_features=4, num_classes=2)
    n = get_task("logreg", cfg).num_params
    fab = _fabric("port", tmp_path / "wal")
    for clock in range(7):
        fab.send("weights", clock % 2, _wmsg("port", clock, 0, n,
                                             clock * 0.1))
    fab.close()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, KPS_PLATFORM="cpu", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "kafka_ps_tpu_torch.cli.server_runner",
         "--serve-replica", "--durable-log", str(tmp_path / "wal"),
         "--serve_port", str(port), "--num_features", "4",
         "--num_classes", "2", "--serve-shm"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        client = None
        deadline = time.monotonic() + 60.0
        while client is None:
            try:
                client = net.PredictClient("127.0.0.1", port, shm=True)
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.05)
        x = np.ones(4, np.float32)
        assert client.shm_active
        assert client.predict(x).vector_clock == 6
        with pytest.raises(StalenessError):
            client.predict(x, min_clock=7)
        client.close()
        proc.send_signal(signal.SIGINT)
        _, err = proc.communicate(timeout=60.0)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    assert "single-server log" in err
    line = [ln for ln in err.splitlines()
            if ln.startswith("kafka_ps_tpu_torch replica: ")][-1]
    stats = json.loads(line.split(": ", 1)[1])
    assert stats["clock"] == 6 and stats["publications"] == 1
    assert stats["serving"]["requests"] == 2
    assert stats["shm_predictions"] == 2
