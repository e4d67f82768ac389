"""The serving plane on the wire (kafka_ps_tpu_torch/runtime/net.py,
serving/shm.py) against the JAX package's, in one process over localhost,
and the serving entry points on the CPU.

  * PREDICT / PREDICTION payloads and the shared-memory handshake are
    byte for byte the JAX package's: the client's HELLO, the server's
    CONFIG offer (its layout; the nonce and segment name are random),
    and the channel's segment, which each package's end attaches and
    serves for the other's;
  * a JAX PredictClient against a port ServerBridge and a port
    PredictClient against a JAX ServerBridge, by socket and by shared
    memory: the answers the local engine gives, typed STALE;
  * the port client's fallbacks (a declined offer, a failed attach, a
    channel that dies) and reconnects;
  * a ShardedServerGroup with attach_serving: N=1 publishes the
    unsharded server's snapshot sequence, bitwise; N=2 publishes only at
    frontier advances, each cut bitwise N=1's theta at that clock;
  * `cli.run --serve --serve_port P` under a live socket load: theta and
    the rows bitwise the run without --serve; `server_runner --listen
    --serve --serve-shm` with a worker process answers PREDICT_OK by
    socket and by shared memory.

Confidences crossing between packages: rtol 1e-5, atol 1e-6 (float32
products summed in other orders); labels, clocks and statuses exact.
"""

from __future__ import annotations

import os
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from kafka_ps_tpu.models.task import get_task as jget_task
from kafka_ps_tpu.runtime import net as jnet
from kafka_ps_tpu.serving import StalenessError as JStalenessError
from kafka_ps_tpu.serving import shm as jshm
from kafka_ps_tpu.serving.engine import PredictionEngine as JEngine
from kafka_ps_tpu.serving.snapshot import SnapshotRegistry as JRegistry
from kafka_ps_tpu.utils.config import ModelConfig as JModelConfig
from kafka_ps_tpu_torch.cli import run as cli_run
from kafka_ps_tpu_torch.data.synth import generate, write_csv
from kafka_ps_tpu_torch.models.task import get_task
from kafka_ps_tpu_torch.runtime import net
from kafka_ps_tpu_torch.serving import StalenessError
from kafka_ps_tpu_torch.serving import shm as shm_mod
from kafka_ps_tpu_torch.serving.engine import PredictionEngine
from kafka_ps_tpu_torch.serving.snapshot import SnapshotRegistry
from kafka_ps_tpu_torch.utils.config import ModelConfig
from torch_serving_runs import frontier_check, serve_config, snapshot_sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = 4
CONF_RTOL, CONF_ATOL = 1e-5, 1e-6


def _theta(n):
    return np.random.default_rng(5).normal(size=n).astype(np.float32)


def _port_engine():
    """A port engine over one snapshot at clock 9 (theta seeded)."""
    cfg = ModelConfig(num_features=F, num_classes=2)
    task = get_task("logreg", cfg)
    reg = SnapshotRegistry()
    reg.publish(torch.from_numpy(_theta(task.num_params)), vector_clock=9)
    return PredictionEngine(task, reg)


def _jax_engine():
    """The JAX package's engine over the same snapshot."""
    import jax.numpy as jnp
    task = jget_task("logreg", JModelConfig(num_features=F, num_classes=2))
    reg = JRegistry()
    reg.publish(jnp.asarray(_theta(task.num_params)), vector_clock=9)
    return JEngine(task, reg)


def _rows(n=6):
    return np.random.default_rng(8).normal(size=(n, F)).astype(np.float32)


def _same(a, b):
    """Two answers (of either package's Prediction type) agree."""
    assert (a.label, a.vector_clock, a.wall_time) == (
        b.label, b.vector_clock, b.wall_time)
    assert a.confidence == pytest.approx(b.confidence, rel=CONF_RTOL,
                                         abs=CONF_ATOL)


# -- bytes --------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"min_clock": 7, "max_age_s": 1.5},
                                {"model_id": 3}, {"min_clock": 0}])
def test_predict_frames_are_the_jax_bytes(kw):
    x = np.arange(6, dtype=np.float32) - 2.5
    ours, ref = net.encode_predict_request(x, **kw), \
        jnet.encode_predict_request(x, **kw)
    assert ours == ref
    for payload in (ours, ref):
        a, b = net.decode_predict_request(payload), \
            jnet.decode_predict_request(payload)
        assert np.array_equal(a[0], b[0]) and a[1:] == b[1:]
    for args in [(net.PREDICT_OK, 2, 0.75, 11, 123.5), (net.PREDICT_STALE,),
                 (net.PREDICT_FAILED,), (net.PREDICT_OVERLOADED,)]:
        ours = net.encode_prediction(*args)
        assert ours == jnet.encode_prediction(*args)
        assert net.decode_prediction(ours) == jnet.decode_prediction(ours)


def _hello_of(client_cls):
    """The raw HELLO frame a shm-asking client of either package sends,
    answered by a declined offer."""
    listener = socket.create_server(("127.0.0.1", 0))
    port = listener.getsockname()[1]
    got = {}

    def serve():
        conn, _ = listener.accept()
        head = conn.recv(4)
        (length,) = struct.unpack("<I", head)
        body = b""
        while len(body) < length:
            body += conn.recv(length - len(body))
        got["frame"] = head + body
        config = (struct.pack("<dq", 0.0, 1) + struct.pack("<Bf", 0, 0.0)
                  + struct.pack("<B", 0) + struct.pack("<B16s64s", 0, b"",
                                                       b""))
        net.send_frame(conn, net.T_CONFIG, 0, config)
        got["conn"] = conn

    t = threading.Thread(target=serve)
    t.start()
    client = client_cls("127.0.0.1", port, shm=True)
    t.join(timeout=10.0)
    assert not client.shm_active
    client.close()
    got["conn"].close()
    listener.close()
    return got["frame"]


def test_shm_request_hello_is_the_jax_bytes():
    assert _hello_of(net.PredictClient) == _hello_of(jnet.PredictClient)


def _config_offer(bridge):
    """The CONFIG answering a shm-asking HELLO: (payload, socket)."""
    sock = socket.create_connection(("127.0.0.1", bridge.port))
    net.send_frame(sock, net.T_HELLO, 0,
                   struct.pack("<q", 0) + struct.pack("<Bf", 0, 0.0)
                   + struct.pack("<BB", 0, 1))
    topic, _, payload = net.recv_frame(sock)
    assert topic == net.T_CONFIG
    return bytes(payload), sock


def test_shm_offer_layout_is_the_jax_one_and_segments_cross():
    """Both servers' offers: the same length and fields (granted, a
    16-byte nonce, a NUL-padded name), and each package's client end
    attaches the other's segment and round-trips a request on it."""
    ours_engine, ref_engine = _port_engine(), _jax_engine()
    ours = net.ServerBridge(run_id=3, shm=True, device="cpu")
    ours.attach_serving(ours_engine)
    ref = jnet.ServerBridge(run_id=3, shm=True)
    ref.attach_serving(ref_engine)
    socks = []
    try:
        offers = []
        for bridge in (ours, ref):
            payload, sock = _config_offer(bridge)
            socks.append(sock)
            offers.append(payload)
        assert len(offers[0]) == len(offers[1]) == 16 + 5 + 1 + 81
        assert offers[0][:22] == offers[1][:22]
        for offer, attach in ((offers[0], jshm.ShmChannel.attach),
                              (offers[1], shm_mod.ShmChannel.attach)):
            name, nonce = net._read_shm_offer(offer, 22)
            assert (name, nonce) == jnet._read_shm_offer(offer, 22)
            chan = attach(name, nonce)
            raw = chan.rpc(net.encode_predict_request(_rows()[0]),
                           timeout=10.0)
            assert net.decode_prediction(raw)[0] == net.PREDICT_OK
            chan.close()
    finally:
        for s in socks:
            s.close()
        for b in (ours, ref):
            b.close()
        ours_engine.close()
        ref_engine.close()


@pytest.mark.parametrize("maker,attacher", [
    (shm_mod.ShmChannel.create, jshm.ShmChannel.attach),
    (jshm.ShmChannel.create, shm_mod.ShmChannel.attach)])
def test_shm_channel_serves_the_other_package(maker, attacher):
    server = maker()
    client = attacher(server.name, server.nonce)
    assert client.capacity == server.capacity == shm_mod.DEFAULT_CAPACITY

    def answer():
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            got = server.serve_once()
            if got is not None:
                seq, payload = got
                server.respond(seq, payload[::-1])
                return
            time.sleep(0.0002)

    try:
        for msg in (b"abc", b"0123456789" * 50):
            t = threading.Thread(target=answer)
            t.start()
            assert client.rpc(msg, timeout=10.0) == msg[::-1]
            t.join(timeout=10.0)
        with pytest.raises(shm_mod.ShmError, match="nonce"):
            shm_mod.ShmChannel.attach(server.name, b"\x00" * 16)
    finally:
        client.close()
        server.close()


# -- clients against the other package's bridge -------------------------------


@pytest.mark.parametrize("shm", [False, True])
def test_jax_client_against_a_port_bridge(shm):
    engine = _port_engine()
    bridge = net.ServerBridge(shm=shm, device="cpu")
    bridge.attach_serving(engine)
    client = jnet.PredictClient("127.0.0.1", bridge.port, shm=shm)
    try:
        assert client.shm_active == shm
        for x in _rows():
            _same(client.predict(x), engine.predict(x))
        with pytest.raises(JStalenessError):
            client.predict(_rows()[0], min_clock=10)
        assert client.shm_active == shm
        assert bridge.shm_predictions == (7 if shm else 0)
    finally:
        client.close()
        bridge.close()
        engine.close()


@pytest.mark.parametrize("shm", [False, True])
def test_port_client_against_a_jax_bridge(shm):
    engine = _jax_engine()
    bridge = jnet.ServerBridge(shm=shm)
    bridge.attach_serving(engine)
    client = net.PredictClient("127.0.0.1", bridge.port, shm=shm)
    try:
        assert client.shm_active == shm
        for x in _rows():
            _same(client.predict(x), engine.predict(x))
        with pytest.raises(StalenessError):
            client.predict(_rows()[0], min_clock=10)
    finally:
        client.close()
        bridge.close()
        engine.close()


# -- the port client on its own -----------------------------------------------


def test_port_client_end_to_end_and_fallbacks(monkeypatch):
    engine = _port_engine()
    bridge = net.ServerBridge(shm=True, device="cpu")
    bridge.attach_serving(engine)
    plain = net.PredictClient("127.0.0.1", bridge.port)
    fast = net.PredictClient("127.0.0.1", bridge.port, shm=True)
    try:
        x = _rows()[0]
        local = engine.predict(x)
        assert not plain.shm_active and fast.shm_active
        for c in (plain, fast):
            assert c.predict(x) == local
            assert c.predict(x, min_clock=9).vector_clock == 9
            with pytest.raises(StalenessError):
                c.predict(x, min_clock=10)
        # the channel dies between requests: the socket answers
        fast._chan.mark_closed()
        assert fast.predict(x) == local and not fast.shm_active
        # a declined offer (no engine), and an attach that fails
        bare = net.ServerBridge(shm=True, device="cpu")
        declined = net.PredictClient("127.0.0.1", bare.port, shm=True)
        assert not declined.shm_active
        with pytest.raises(RuntimeError, match="prediction failed"):
            declined.predict(x)
        declined.close()
        bare.close()

        def remote(name, nonce):
            raise FileNotFoundError(f"no segment {name} on this host")

        monkeypatch.setattr(shm_mod.ShmChannel, "attach",
                            staticmethod(remote))
        far = net.PredictClient("127.0.0.1", bridge.port, shm=True)
        assert not far.shm_active and far.predict(x) == local
        far.close()
        assert bridge.dropped_sends == 0
    finally:
        plain.close()
        fast.close()
        bridge.close()
        engine.close()


def test_port_client_reconnects_after_a_server_restart():
    engine = _port_engine()
    bridge = net.ServerBridge(device="cpu")
    port = bridge.port
    bridge.attach_serving(engine)
    client = net.PredictClient("127.0.0.1", port, reconnect=True,
                               reconnect_timeout=10.0)
    plain = net.PredictClient("127.0.0.1", port)
    x = _rows()[0]
    try:
        assert client.predict(x).vector_clock == 9
        bridge.close()
        bridge = net.ServerBridge(port=port, device="cpu")
        bridge.attach_serving(engine)
        assert client.predict(x).vector_clock == 9
        assert client.reconnects == 1
        with pytest.raises((ConnectionError, OSError)):
            plain.predict(x)
    finally:
        client.close()
        plain.close()
        bridge.close()
        engine.close()


# -- the sharded group at the frontier ----------------------------------------


def test_frontier_group_n1_is_the_unsharded_sequence_and_n2_its_cuts():
    out = frontier_check("cpu", serve_config(0, use_gang=False,
                                             eval_async=False))
    assert out["n1_bitwise"] and out["n1_snapshots"] > 3, out
    assert out["cuts"] > 3 and out["cuts_increasing"], out
    assert out["last_is_frontier"] and out["cuts_bitwise"], out


def test_snapshot_sequence_helper_publishes_the_bootstrap():
    seq = snapshot_sequence(serve_config(0), "cpu", iters=8)
    assert seq[0][0] == 0 and len(seq) >= 2


# -- the entry points ---------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Load:
    """A closed-loop PredictClient load on a port that may not listen
    yet: dial until it does, then predict until the server goes."""

    def __init__(self, port: int, rows, shm: bool = False):
        self.port, self.rows, self.shm = port, rows, shm
        self.stop = threading.Event()
        self.answers: list = []          # (status, clock)
        self.shm_seen = False
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        client = None
        while client is None and not self.stop.is_set():
            try:
                client = net.PredictClient("127.0.0.1", self.port,
                                           timeout=30.0, shm=self.shm)
            except OSError:
                time.sleep(0.01)
        if client is None:
            return
        self.shm_seen = client.shm_active
        i = 0
        try:
            while not self.stop.is_set():
                try:
                    p = client.predict(self.rows[i % len(self.rows)])
                    self.answers.append((net.PREDICT_OK, p.vector_clock))
                except StalenessError:
                    self.answers.append((net.PREDICT_STALE, -1))
                except RuntimeError:     # a PREDICT_FAILED answer
                    self.answers.append((net.PREDICT_FAILED, -1))
                i += 1
        except (ConnectionError, OSError):
            pass                          # the server ended the run
        finally:
            client.close()

    def finish(self):
        self.stop.set()
        self.thread.join(timeout=30.0)
        assert not self.thread.is_alive()
        return self.answers


def _cli_csvs(tmp_path, f=16):
    # 512 rows: 4 workers x the 128-row prefill, all buffered before the
    # first iteration, so two serial runs see the same buffers
    x, y = generate(612, f, 3, noise=1.0, seed=2)
    write_csv(str(tmp_path / "train.csv"), x[:512], y[:512])
    write_csv(str(tmp_path / "test.csv"), x[512:], y[512:])


def _cli(tmp_path, name, extra, monkeypatch, f=16):
    d = tmp_path / name
    d.mkdir()
    monkeypatch.chdir(d)
    argv = ["-training", "../train.csv", "-test", "../test.csv",
            "--num_features", str(f), "--num_classes", "3",
            "--num_workers", "4", "-p", "0", "-l", "--mode", "serial",
            "-c", "0", "--max_iterations", "60", "--checkpoint", "ck.npz",
            "--checkpoint_every", "100000", *extra]
    assert cli_run.main(argv) == 0
    rows = {k: [r.split(";", 1)[1] for r in
                (d / f"logs-{k}.csv").read_text().splitlines()[1:]]
            for k in ("server", "worker")}
    with np.load(d / "ck.npz") as z:
        theta = z["theta"].copy()
    return theta, rows


def test_cli_serve_port_under_load_is_bitwise_the_plain_run(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("KPS_PLATFORM", "cpu")
    _cli_csvs(tmp_path)
    port = _free_port()
    rows = np.random.default_rng(1).normal(size=(8, 16)).astype(np.float32)
    load = _Load(port, rows)
    theta_on, rows_on = _cli(tmp_path, "on", ["--serve", "--serve_port",
                                              str(port)], monkeypatch)
    answers = load.finish()
    theta_off, rows_off = _cli(tmp_path, "off", [], monkeypatch)
    assert theta_on.tobytes() == theta_off.tobytes()
    assert rows_on == rows_off
    err = capsys.readouterr().err
    assert f"serving on port {port}" in err
    ok = [c for s, c in answers if s == net.PREDICT_OK]
    assert ok and ok == sorted(ok)
    assert all(s in (net.PREDICT_OK, net.PREDICT_STALE) for s, _ in answers)
    stats = [ln for ln in err.splitlines()
             if ln.startswith("kafka_ps_tpu_torch run: ")]
    import json
    serving = json.loads(stats[0].split(": ", 1)[1])["serving"]
    assert serving["requests"] >= len(ok) and serving["errors"] == 0
    assert serving["snapshots_published"] > 1
    with pytest.raises(SystemExit, match="requires --serve"):
        cli_run.main(["--serve_port", "0"])


def test_split_server_serves_by_socket_and_shm(tmp_path):
    """server_runner --listen --serve --serve-shm with one worker process
    of all 4 workers: plain and shm clients get PREDICT_OK answers whose
    clocks never go back; the stats count both paths."""
    _cli_csvs(tmp_path)
    for d in ("server", "w0"):
        (tmp_path / d).mkdir()
    env = dict(os.environ, KPS_PLATFORM="cpu", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()
    common = ["-test", "../test.csv", "--num_features", "16",
              "--num_classes", "3", "--num_workers", "4", "-l"]
    server = subprocess.Popen(
        [sys.executable, "-m", "kafka_ps_tpu_torch.cli.server_runner",
         "--listen", str(port), "-training", "../train.csv", "-c", "2",
         "-p", "0", "--max_iterations", "400", "--serve", "--serve-shm",
         *common], cwd=tmp_path / "server", env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    # the server's stderr, read as it comes: the clients start once the
    # engine is attached (before that the port answers PREDICT_FAILED)
    lines: list[str] = []
    serving = threading.Event()

    def read_err():
        for ln in server.stderr:
            lines.append(ln)
            if "serving predictions on port" in ln:
                serving.set()

    reader = threading.Thread(target=read_err, daemon=True)
    reader.start()
    rows = np.random.default_rng(3).normal(size=(8, 16)).astype(np.float32)
    assert serving.wait(timeout=60.0), "".join(lines)[-3000:]
    loads = [_Load(port, rows), _Load(port, rows, shm=True)]
    worker = subprocess.Popen(
        [sys.executable, "-m", "kafka_ps_tpu_torch.cli.worker_runner",
         "--connect", f"127.0.0.1:{port}", "--worker_ids", "0,1,2,3",
         *common], cwd=tmp_path / "w0", env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        server.wait(timeout=150.0)
        worker.communicate(timeout=60.0)
    finally:
        for p in (server, worker):
            if p.poll() is None:
                p.kill()
    reader.join(timeout=30.0)
    err = "".join(lines)
    answers = [ld.finish() for ld in loads]
    assert server.returncode == 0, err[-3000:]
    assert loads[1].shm_seen and not loads[0].shm_seen
    for got in answers:
        ok = [c for s, c in got if s == net.PREDICT_OK]
        assert ok and ok == sorted(ok)
        assert all(s in (net.PREDICT_OK, net.PREDICT_STALE) for s, _ in got)
    import json
    line = [ln for ln in err.splitlines()
            if ln.startswith("kafka_ps_tpu_torch server: ")][-1]
    stats = json.loads(line.split(": ", 1)[1])
    assert stats["serving"]["errors"] == 0
    assert stats["shm_predictions"] > 0
    assert stats["serving"]["requests"] >= sum(len(a) for a in answers)
