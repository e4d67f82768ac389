"""The port's socket transport (kafka_ps_tpu_torch/runtime/net.py and
runtime/wire.py) on its own: the cases of tests/test_net_framing.py that
cover the ported surface — torn frames are ConnectionErrors, never an
orderly shutdown; the ServerBridge purges and reports dead connections;
heartbeats, PONGs, the run id and the heartbeat-config floor; the topic
table; codec negotiation; batched ingest; the wire engine — and what
the port adds: an aggregator's HELLO registers a relay, a shared-memory request
gets the declined offer, a frame larger than the writer's queue goes
alone, decoded tensors land on the bridge's device, and a reader's
exception that is not a connection error is kept, never a disconnect.

Every comparison is exact (bytes, or values that crossed a lossless f32
frame).  The prediction and shared-memory cases of the JAX file are in
tests/test_torch_serving_net.py; here, without an engine, a PREDICT is
answered PREDICT_FAILED and a shm request gets the declined offer.
"""

from __future__ import annotations

import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from kafka_ps_tpu_torch import compress
from kafka_ps_tpu_torch.compress import wire as cwire
from kafka_ps_tpu_torch.data.buffer import SlidingBuffer
from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime import net, serde, wire
from kafka_ps_tpu_torch.runtime.messages import (KeyRange, LabeledData,
                                                 WeightsMessage)
from kafka_ps_tpu_torch.utils.config import BufferConfig


def _server(**kw):
    return net.ServerBridge(device="cpu", **kw)


def _worker(port: int, ids, **kw):
    return net.WorkerBridge("127.0.0.1", port, ids, device="cpu", **kw)


def _wait(pred, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


def _reader(worker, buffers=None):
    t = threading.Thread(target=worker.run_reader, args=(buffers or {},),
                         daemon=True)
    t.start()
    return t


# -- frames --------------------------------------------------------------------


@pytest.mark.parametrize("sent,error", [
    (b"", None),                                          # clean EOF
    (b"\x02\x00", "mid-frame"),                           # 2 of 4 header bytes
    (struct.pack("<I", 32) + b"\x01\x00\x00\x00\x00", "mid-frame"),  # torn body
])
def test_recv_frame_eof(sent, error):
    a, b = socket.socketpair()
    a.sendall(sent)
    a.close()
    if error is None:
        assert net.recv_frame(b) is None
    else:
        with pytest.raises(ConnectionError, match=error):
            net.recv_frame(b)
    b.close()


def test_whole_frame_roundtrip():
    a, b = socket.socketpair()
    msg = WeightsMessage(vector_clock=3, key_range=KeyRange(0, 4),
                         values=torch.arange(4, dtype=torch.float32))
    net.send_frame(a, net.T_WEIGHTS, 2, serde.to_bytes(msg))
    topic, key, payload = net.recv_frame(b)
    assert (topic, key) == (net.T_WEIGHTS, 2)
    got = serde.from_bytes(payload, device="cpu")
    assert got.vector_clock == 3 and got.key_range == KeyRange(0, 4)
    assert torch.equal(got.values, msg.values)
    a.close(), b.close()


def test_topic_name_table_is_exhaustive():
    constants = {v for k, v in vars(net).items()
                 if k.startswith("T_") and isinstance(v, int)}
    assert set(net.TOPIC_NAMES) == constants
    assert len(net.TOPIC_NAMES) == len(constants) == 12
    assert all(isinstance(n, str) and n for n in net.TOPIC_NAMES.values())


@pytest.mark.parametrize("topic,payload", [
    (net.T_PING, b""), (net.T_PONG, b""),
    (net.T_CONFIG, struct.pack("<dq", 0.25, 42))])
def test_control_frame_roundtrip(topic, payload):
    a, b = socket.socketpair()
    net.send_frame(a, topic, 0, payload)
    assert net.recv_frame(b) == (topic, 0, payload)
    a.close(), b.close()


def test_recv_frame_payload_is_a_memoryview():
    a, b = socket.socketpair()
    net.send_frame(a, net.T_WEIGHTS, 1, b"abcdef")
    _, _, payload = net.recv_frame(b)
    assert isinstance(payload, memoryview)
    assert np.frombuffer(payload, dtype=np.uint8).tobytes() == b"abcdef"
    a.close(), b.close()


# -- membership and liveness ----------------------------------------------------


def test_server_bridge_reports_disconnect_and_purges():
    bridge = _server()
    gone: list[list[int]] = []
    bridge.on_disconnect = lambda ids: gone.append(sorted(ids))
    worker = _worker(bridge.port, [0, 1])
    bridge.wait_for_connected([0, 1], timeout=10.0)
    worker._sock.close()            # hard death — no goodbye frame
    assert _wait(lambda: gone)
    assert gone == [[0, 1]]
    assert bridge._conn_of == {}
    assert not bridge.send_data(0, {0: 1.0}, 1)   # no crash, just False
    assert bridge.reader_error is None
    bridge.close()


def test_server_bridge_reconnect_reregisters():
    bridge = _server()
    events: list[tuple[str, object]] = []
    bridge.on_disconnect = lambda ids: events.append(("down", sorted(ids)))
    bridge.on_hello = lambda ids: events.append(("hello", sorted(ids)))
    w1 = _worker(bridge.port, [0])
    bridge.wait_for_connected([0], timeout=10.0)
    w1._sock.close()
    assert _wait(lambda: ("down", [0]) in events)
    w2 = _worker(bridge.port, [0])
    bridge.wait_for_connected([0], timeout=10.0)   # re-registered
    assert events.count(("hello", [0])) == 2
    w2.close(), bridge.close()


def test_heartbeat_detects_half_open_connection():
    """A peer that HELLOs and then goes silent (never PONGs) is evicted
    by the PING/timeout path."""
    bridge = _server(heartbeat_interval=0.05, heartbeat_timeout=0.4)
    gone: list[list[int]] = []
    bridge.on_disconnect = lambda ids: gone.append(sorted(ids))
    sock = socket.create_connection(("127.0.0.1", bridge.port))
    net.send_frame(sock, net.T_HELLO, 0, struct.pack("<qq", 1, 7))
    assert _wait(lambda: gone)
    assert gone == [[7]]
    sock.close(), bridge.close()


def test_worker_bridge_pongs_keep_connection_alive():
    bridge = _server(heartbeat_interval=0.05, heartbeat_timeout=0.5)
    gone: list[list[int]] = []
    bridge.on_disconnect = lambda ids: gone.append(sorted(ids))
    worker = _worker(bridge.port, [3], heartbeat_timeout=2.0)
    bridge.wait_for_connected([3], timeout=10.0)
    _reader(worker)                 # the reader answers PINGs
    time.sleep(1.5)                 # >> heartbeat_timeout
    assert gone == []
    assert 3 in bridge._conn_of
    assert worker.traffic[("out", net.T_PONG)][0] > 0
    worker.close(), bridge.close()


def test_handshake_carries_run_id_and_no_read_timeout():
    """The run id crosses in T_CONFIG; with no --heartbeat_timeout the
    worker blocks on a quiet server forever (the 5 s connect timeout
    must not survive onto the socket)."""
    bridge = _server(run_id=987654321)
    worker = _worker(bridge.port, [1])
    assert worker.server_run_id == 987654321
    assert worker._sock.gettimeout() is None
    worker.close(), bridge.close()


@pytest.mark.parametrize("topic,counted", [
    (net.T_PING, 0), (net.T_CONFIG, 0), (net.T_PREDICTION, 0),
    (net.T_WEIGHTS, 1), (net.T_DATA_BATCH, 1)])
def test_dropped_sends_count_only_data_frames(topic, counted):
    """`dropped_sends` diagnoses lost data: a control frame or a
    prediction reply hitting a dead connection does not count."""
    bridge = _server()
    dead = object()                     # never registered -> no lock
    assert bridge._send_raw(dead, topic, 0, b"") is False
    assert bridge.dropped_sends == counted
    bridge.close()


def test_config_frame_floors_too_small_heartbeat_timeout():
    """A worker timeout below 3 server pings is floored at 3 pings."""
    bridge = _server(heartbeat_interval=0.5, heartbeat_timeout=30.0)
    worker = _worker(bridge.port, [1], heartbeat_timeout=0.1)
    _reader(worker)
    assert _wait(lambda: worker._sock.gettimeout() == 1.5)
    assert not worker.disconnected.is_set()
    worker.close(), bridge.close()


def test_config_frame_disables_timeout_when_server_never_pings():
    bridge = _server()                 # no heartbeats
    worker = _worker(bridge.port, [1], heartbeat_timeout=0.2)
    _reader(worker)
    assert _wait(lambda: worker._sock.gettimeout() is None)
    time.sleep(0.5)                     # >> the 0.2 s flag
    assert not worker.disconnected.is_set()
    worker.close(), bridge.close()


# -- HELLO trailers: codecs, and what the port declines -------------------------


@pytest.mark.parametrize("server_codec,worker_codec,agreed", [
    ("int8", "int8", "int8"),
    ("topk:0.1", "topk:0.1", "topk:0.1"),
    ("topk:0.1", "topk:0.5", "none"),     # the parameter must match too
    ("int8", "bf16", "none"),             # mismatch falls back
    ("none", "int8", "none"),             # uncompressed server
    ("bf16", "none", "none")])
def test_codec_negotiation(server_codec, worker_codec, agreed):
    bridge = _server(codec=cwire.parse_codec(server_codec))
    worker = _worker(bridge.port, [0],
                     codec=cwire.parse_codec(worker_codec))
    assert worker.negotiated == cwire.parse_codec(agreed)
    bridge.wait_for_connected([0], timeout=10.0)
    assert bridge._codec_of[bridge._conn_of[0]] == worker.negotiated
    worker.close(), bridge.close()


def _raw_hello(port: int, payload: bytes):
    sock = socket.create_connection(("127.0.0.1", port))
    net.send_frame(sock, net.T_HELLO, 0, payload)
    return sock


def test_legacy_hello_without_trailer_negotiates_none():
    bridge = _server(codec=cwire.parse_codec("int8"), run_id=77)
    sock = _raw_hello(bridge.port, struct.pack("<qq", 1, 4))
    topic, _, payload = net.recv_frame(sock)
    assert topic == net.T_CONFIG
    assert struct.unpack_from("<dq", payload, 0)[1] == 77
    codec_id, _ = struct.unpack_from("<Bf", payload, 16)
    assert codec_id == cwire.CODEC_NONE
    # the trace answer is 0 (this side has no tracer), nothing after it
    assert len(payload) == 16 + 5 + 1 and payload[-1] == 0
    bridge.wait_for_connected([4], timeout=10.0)
    sock.close(), bridge.close()


def test_trace_offer_is_answered_zero_and_shm_request_declined():
    """A JAX worker with tracing on offers 1 and a serving client may ask
    for shared memory: the port answers trace 0 and the declined shm
    offer, and the connection registers as a plain worker."""
    bridge = _server(run_id=5)
    hello = (struct.pack("<qq", 1, 2) + struct.pack("<Bf", 0, 0.0)
             + struct.pack("<B", 1) + struct.pack("<B", 1))
    sock = _raw_hello(bridge.port, hello)
    topic, _, payload = net.recv_frame(sock)
    assert topic == net.T_CONFIG
    trace, = struct.unpack_from("<B", payload, 21)
    granted, nonce, name = struct.unpack_from("<B16s64s", payload, 22)
    assert (trace, granted, nonce, name) == (0, 0, bytes(16), bytes(64))
    bridge.wait_for_connected([2], timeout=10.0)
    sock.close(), bridge.close()


def test_aggregator_hello_is_refused(capsys):
    """The aggregator-role HELLO is no longer refused: it is answered
    with CONFIG and registers a relay connection for its member ids,
    whose loss reports no disconnect (the members live on behind it)."""
    bridge = _server()
    hellos: list = []
    lost: list = []
    bridge.on_hello = hellos.append
    bridge.on_disconnect = lost.append
    hello = (struct.pack("<qq", 1, 9) + struct.pack("<Bf", 0, 0.0)
             + struct.pack("<BBB", 0, 0, 1))
    sock = _raw_hello(bridge.port, hello)
    assert net.recv_frame(sock)[0] == net.T_CONFIG
    bridge.wait_for_connected([9], timeout=10.0)
    assert bridge.aggregators == 1 and hellos == [[9]]
    assert bridge._conn_of[9] in bridge._agg_conns
    assert "refused" not in capsys.readouterr().err
    sock.close()
    deadline = time.monotonic() + 10.0
    while 9 in bridge._conn_of and time.monotonic() < deadline:
        time.sleep(0.01)
    assert 9 not in bridge._conn_of and lost == []
    bridge.close()


def test_worker_tolerates_legacy_16_byte_config():
    """An older SERVER replies a bare <dq> CONFIG: the worker handshake
    completes with negotiated == NONE."""
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]

    def fake_server():
        conn, _ = srv.accept()
        while True:
            frame = net.recv_frame(conn)
            if frame is None:
                break
            if frame[0] == net.T_HELLO:
                net.send_frame(conn, net.T_CONFIG, 0,
                               struct.pack("<dq", 0.0, 55))
        conn.close()

    t = threading.Thread(target=fake_server, daemon=True)
    t.start()
    worker = _worker(port, [0], codec=cwire.parse_codec("int8"))
    assert worker.server_run_id == 55
    assert worker.negotiated.codec_id == cwire.CODEC_NONE
    worker.close()
    t.join(timeout=10.0)
    srv.close()


def test_compressed_weights_downgraded_for_none_peer():
    """A message carrying `encoded` sent to a connection that negotiated
    NONE goes out as a PLAIN frame of the decoded f32 values."""
    n = 300
    wc = compress.WeightsCompressor(compress.get_codec(
        cwire.parse_codec("int8"), n))
    decoded, enc = wc.encode(torch.arange(n, dtype=torch.float32) / n)
    msg = WeightsMessage(vector_clock=1, key_range=KeyRange(0, n),
                         values=decoded, encoded=enc)
    bridge = _server(codec=cwire.parse_codec("int8"))
    worker = _worker(bridge.port, [6])            # no codec
    bridge.wait_for_connected([6], timeout=10.0)
    assert bridge._send(bridge._conn_of[6], net.T_WEIGHTS, 6, msg)
    topic, _, payload = net.recv_frame(worker._sock)
    assert topic == net.T_WEIGHTS
    got = serde.from_bytes(payload, device="cpu")
    assert got.encoded is None
    assert got.values.numpy().tobytes() == decoded.numpy().tobytes()
    worker.close(), bridge.close()


# -- batched stream ingest (T_DATA_BATCH) and weights delivery -------------------


def _buffer(features=4):
    return SlidingBuffer(features, BufferConfig(min_size=4, max_size=16))


def test_send_data_batch_bulk_inserts_via_add_many():
    bridge = _server()
    worker = _worker(bridge.port, [2])
    bridge.wait_for_connected([2], timeout=10.0)
    buffers = {2: _buffer()}
    t = _reader(worker, buffers)
    rows = [({0: float(i), 3: 1.0}, i % 2) for i in range(5)]
    assert bridge.send_data_batch(2, rows)
    assert _wait(lambda: buffers[2].count == 5)
    x, _, mask = buffers[2].snapshot()
    assert sorted(x[mask > 0][:, 0].tolist()) == [0.0, 1.0, 2.0, 3.0, 4.0]
    # ONE frame crossed for the whole batch, no per-row frames
    assert bridge.traffic[("out", net.T_DATA_BATCH)][0] == 1
    assert net.T_DATA not in bridge.wire_bytes
    assert worker.serde_frames[net.T_DATA_BATCH] == 1
    worker.close(), bridge.close()
    t.join(timeout=10.0)


def test_send_data_batch_to_unknown_worker_returns_false():
    bridge = _server()
    assert not bridge.send_data_batch(9, [({0: 1.0}, 1)])
    assert not bridge.send_data(9, {0: 1.0}, 1)
    bridge.close()


def test_legacy_per_row_batch_and_single_rows_accepted_on_receive():
    """A T_DATA_BATCH in the old per-row <i32 len><serde blob> layout,
    and single T_DATA rows, both land in the buffer."""
    rows = [({0: 2.0}, 1), ({1: 3.0}, 0)]
    parts = [struct.pack("<q", len(rows))]
    for feats, label in rows:
        blob = serde.to_bytes(LabeledData(features=feats, label=label))
        parts += [struct.pack("<i", len(blob)), blob]
    bridge = _server()
    worker = _worker(bridge.port, [2])
    bridge.wait_for_connected([2], timeout=10.0)
    buffers = {2: _buffer()}
    t = _reader(worker, buffers)
    conn = bridge._conn_of[2]
    assert bridge._send_raw(conn, net.T_DATA_BATCH, 2, b"".join(parts))
    assert bridge.send_data(2, {3: 4.0}, 1)
    assert _wait(lambda: buffers[2].count == 3)
    x, y, mask = buffers[2].snapshot()
    assert sorted(x[mask > 0].sum(1).tolist()) == [2.0, 3.0, 4.0]
    worker.close(), bridge.close()
    t.join(timeout=10.0)


def test_weights_land_on_the_bridge_device_and_gradients_cross_back():
    """WEIGHTS reach the worker's local fabric and GRADIENTS the server's,
    decoded on each bridge's device, values bitwise."""
    from kafka_ps_tpu_torch.runtime.messages import GradientMessage
    bridge = _server()
    sfab = bridge.wrap(fabric_mod.Fabric())
    worker = _worker(bridge.port, [1])
    wfab = worker.make_fabric()
    bridge.wait_for_connected([1], timeout=10.0)
    t = _reader(worker)
    theta = torch.randn(50, generator=torch.Generator().manual_seed(0))
    sfab.send(fabric_mod.WEIGHTS_TOPIC, 1, WeightsMessage(
        vector_clock=4, key_range=KeyRange(0, 50), values=theta))
    got = wfab.poll_blocking(fabric_mod.WEIGHTS_TOPIC, 1, timeout=10.0)
    assert got.values.device.type == "cpu" and got.vector_clock == 4
    assert torch.equal(got.values, theta)
    wfab.send(fabric_mod.GRADIENTS_TOPIC, 0, GradientMessage(
        vector_clock=4, key_range=KeyRange(0, 50), values=-theta,
        worker_id=1))
    g = sfab.poll_blocking(fabric_mod.GRADIENTS_TOPIC, 0, timeout=10.0)
    assert g.worker_id == 1 and torch.equal(g.values, -theta)
    assert bridge.device == worker.device == torch.device("cpu")
    stats = bridge.stats()["wire"]
    assert stats["weights"]["frames_out"] == 1
    assert stats["gradients"]["frames_in"] == 1
    assert stats["gradients"]["serde_ms_per_frame"] >= 0.0
    worker.close(), bridge.close()
    t.join(timeout=10.0)


def test_bridges_resolve_their_device_like_entry_points(monkeypatch):
    """No device given: KPS_PLATFORM decides, else CUDA, which raises on
    a machine without a card instead of decoding onto the CPU."""
    monkeypatch.setenv("KPS_PLATFORM", "cpu")
    bridge = net.ServerBridge()
    assert bridge.device == torch.device("cpu")
    bridge.close()
    if not torch.cuda.is_available():
        monkeypatch.delenv("KPS_PLATFORM")
        with pytest.raises(RuntimeError, match="no CUDA card"):
            net.ServerBridge()


# -- a reader's exception is not a disconnect ------------------------------------


def _failing_from_bytes(monkeypatch, tid_name):
    """serde.from_bytes raising RuntimeError (a CUDA error stands in) on
    frames of one message type."""
    orig = serde.from_bytes

    def failing(payload, device=None):
        msg = orig(payload, device)
        if type(msg).__name__ == tid_name:
            raise RuntimeError("CUDA error: an illegal memory access "
                               "(injected)")
        return msg

    monkeypatch.setattr(serde, "from_bytes", failing)


def test_server_reader_keeps_a_non_connection_error(monkeypatch):
    from kafka_ps_tpu_torch.runtime.messages import GradientMessage
    _failing_from_bytes(monkeypatch, "GradientMessage")
    bridge = _server()
    bridge.wrap(fabric_mod.Fabric())
    gone: list = []
    bridge.on_disconnect = gone.append
    worker = _worker(bridge.port, [0])
    bridge.wait_for_connected([0], timeout=10.0)
    worker.send_gradients(0, GradientMessage(
        vector_clock=0, key_range=KeyRange(0, 3),
        values=torch.ones(3), worker_id=0))
    assert _wait(lambda: bridge.reader_error is not None)
    assert isinstance(bridge.reader_error, RuntimeError)
    with pytest.raises(RuntimeError, match="socket reader failed"):
        bridge.raise_reader_error()
    time.sleep(0.2)
    assert gone == []                  # no disconnect, so no eviction
    worker.close(), bridge.close()


def test_worker_reader_keeps_a_non_connection_error(monkeypatch):
    _failing_from_bytes(monkeypatch, "WeightsMessage")
    bridge = _server()
    sfab = bridge.wrap(fabric_mod.Fabric())
    worker = _worker(bridge.port, [0])
    worker.make_fabric()
    bridge.wait_for_connected([0], timeout=10.0)
    t = _reader(worker)
    sfab.send(fabric_mod.WEIGHTS_TOPIC, 0, WeightsMessage(
        vector_clock=0, key_range=KeyRange(0, 3), values=torch.ones(3)))
    assert worker.disconnected.wait(10.0)
    assert isinstance(worker.reader_error, RuntimeError)
    with pytest.raises(RuntimeError, match="socket reader failed"):
        worker.raise_reader_error()
    worker.close(), bridge.close()
    t.join(timeout=10.0)


def test_mid_stream_config_and_goodbye():
    """A CONFIG re-sent mid-stream updates the ping cadence (floored at 3
    pings); one with GOODBYE_RUN_ID marks the run over, and the EOF that
    follows is no error."""
    bridge = _server()
    worker = _worker(bridge.port, [0], heartbeat_timeout=0.3)
    bridge.wait_for_connected([0], timeout=10.0)
    t = _reader(worker)
    conn = bridge._conn_of[0]
    assert bridge._send_raw(conn, net.T_CONFIG, 0,
                            struct.pack("<dq", 0.5, 7))
    assert _wait(lambda: worker._sock.gettimeout() == 1.5)
    assert not worker.run_over
    assert bridge._send_raw(conn, net.T_CONFIG, 0,
                            struct.pack("<dq", 0.5, net.GOODBYE_RUN_ID))
    assert _wait(lambda: worker.run_over)
    bridge.close()
    assert worker.disconnected.wait(10.0)
    assert worker.reader_error is None
    worker.close()
    t.join(timeout=10.0)


def test_worker_reader_ends_cleanly_on_server_close():
    bridge = _server()
    worker = _worker(bridge.port, [0])
    t = _reader(worker)
    bridge.close()
    assert worker.disconnected.wait(10.0)
    assert worker.reader_error is None
    worker.raise_reader_error()        # nothing kept: no raise
    worker.close()
    t.join(timeout=10.0)


def test_predict_without_engine_fails_cleanly():
    bridge = _server()
    sock = socket.create_connection(("127.0.0.1", bridge.port))
    net.send_frame(sock, net.T_PREDICT, 41,
                   net.encode_predict_request(np.zeros(4, np.float32),
                                              min_clock=3))
    topic, key, payload = net.recv_frame(sock)
    assert (topic, key) == (net.T_PREDICTION, 41)
    assert net.decode_prediction(payload)[0] == net.PREDICT_FAILED
    assert bridge.dropped_sends == 0
    sock.close(), bridge.close()


def test_predict_request_codec_roundtrip():
    x = np.arange(6, dtype=np.float32)
    row, min_clock, max_age, model = net.decode_predict_request(
        net.encode_predict_request(x, min_clock=9, max_age_s=1.5,
                                   model_id=2))
    assert row.tolist() == x.tolist()
    assert (min_clock, max_age, model) == (9, 1.5, 2)
    row, min_clock, max_age, model = net.decode_predict_request(
        net.encode_predict_request(x))
    assert (min_clock, max_age, model) == (None, None, 0)


# -- the wire engine ---------------------------------------------------------


class _BytesSock:
    """recv_into-only double serving a fixed byte string."""

    def __init__(self, data: bytes):
        self._data = memoryview(data)
        self._off = 0

    def recv_into(self, view) -> int:
        n = min(len(view), len(self._data) - self._off)
        view[:n] = self._data[self._off:self._off + n]
        self._off += n
        return n


class _StallSock:
    """sendall-only double (no sendmsg: the join fallback) that blocks
    every send until released."""

    def __init__(self):
        self.release = threading.Event()
        self.sent: list[bytes] = []

    def sendall(self, data) -> None:
        self.release.wait()
        self.sent.append(bytes(data))

    def shutdown(self, how) -> None:
        pass

    def close(self) -> None:
        pass


class _DeadSock(_StallSock):
    closed = False

    def sendall(self, data) -> None:
        raise ConnectionError("peer gone")

    def close(self) -> None:
        self.closed = True


def _drain_raw(sock):
    chunks: list[bytes] = []

    def run():
        while True:
            try:
                d = sock.recv(1 << 16)
            except OSError:
                break
            if not d:
                break
            chunks.append(d)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return chunks, t


def _random_frames(seed: int = 7, n: int = 40):
    """Every topic, sizes 0..1 MB."""
    rng = np.random.default_rng(seed)
    topics = sorted(net.TOPIC_NAMES)
    sizes = [0, 1, 12, 13, 1 << 20]
    sizes += [int(s) for s in rng.integers(0, 1 << 16, n - len(sizes))]
    frames = []
    for i, size in enumerate(sizes):
        payload = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        key = int(rng.integers(-(1 << 40), 1 << 40))
        frames.append((topics[i % len(topics)], key, payload))
    return frames


def _stream(send_all) -> bytes:
    a, b = socket.socketpair()
    chunks, t = _drain_raw(b)
    send_all(a)
    a.close()
    t.join(timeout=30.0)
    b.close()
    return b"".join(chunks)


def test_wire_roundtrip_property():
    """The coalescing writer's byte stream is sequential send_frame's,
    and RecvBuffer parses it back frame for frame."""
    frames = _random_frames()

    def sequential(sock):
        for topic, key, payload in frames:
            net.send_frame(sock, topic, key, payload)

    def coalesced(sock):
        writer = wire.FrameWriter(sock)
        for topic, key, payload in frames:
            assert writer.send(topic, key, payload)
        writer.close(flush=True)

    data = _stream(sequential)
    assert _stream(coalesced) == data
    rbuf = wire.RecvBuffer(_BytesSock(data))
    for topic, key, payload in frames:
        gt, gk, gp = rbuf.recv_frame()
        assert (gt, gk) == (topic, key)
        assert isinstance(gp, memoryview) and bytes(gp) == payload
    assert rbuf.recv_frame() is None


def test_wire_concurrent_enqueue_no_interleave():
    a, b = socket.socketpair()
    writer = wire.FrameWriter(a)
    got: list[tuple[int, int, bytes]] = []

    def read():
        rbuf = wire.RecvBuffer(b)
        while (f := rbuf.recv_frame()) is not None:
            got.append((f[0], f[1], bytes(f[2])))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()

    def produce(tid: int):
        for i in range(300):
            key = tid * 1000 + i
            assert writer.send(net.T_DATA, key,
                               key.to_bytes(8, "little") * ((i % 32) + 1))

    threads = [threading.Thread(target=produce, args=(t,)) for t in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    writer.close(flush=True)
    a.close()
    reader.join(timeout=30.0)
    b.close()
    assert len(got) == 600
    per_thread: dict[int, list[int]] = {1: [], 2: []}
    for topic, key, payload in got:
        i = key % 1000
        assert payload == key.to_bytes(8, "little") * ((i % 32) + 1)
        per_thread[key // 1000].append(i)
    assert per_thread[1] == per_thread[2] == list(range(300))


def _stalled_writer(**kw):
    sock = _StallSock()
    writer = wire.FrameWriter(sock, max_bytes=1100, **kw)
    assert writer.send(net.T_WEIGHTS, 1, b"x" * 1000)
    assert _wait(lambda: writer.queued_bytes == 0)   # popped, now stalled
    assert writer.send(net.T_WEIGHTS, 2, b"x" * 1000)    # fills the queue
    return sock, writer


def test_wire_backpressure_protocol_blocks_with_deadline():
    sock, writer = _stalled_writer(send_deadline=0.25)
    t0 = time.monotonic()
    assert not writer.send(net.T_WEIGHTS, 3, b"x" * 1000)   # deadline
    assert 0.2 <= time.monotonic() - t0 < 5.0
    sock.release.set()
    writer.close(flush=True)
    assert b"".join(sock.sent).count(b"x" * 1000) == 2


def test_wire_backpressure_advisory_drop():
    sock, writer = _stalled_writer(send_deadline=5.0)
    t0 = time.monotonic()
    assert not writer.send(net.T_PING, 0, b"y" * 200, advisory=True)
    assert time.monotonic() - t0 < 1.0          # immediate, no wait
    assert writer.advisory_dropped == 1
    sock.release.set()
    writer.close(flush=True)


def test_wire_frame_larger_than_the_queue_goes_alone():
    """A protocol frame over the queue's byte cap (an H=4096 weights
    frame is 16.9 MB against an 8 MB cap) waits for an empty queue and
    is sent; the JAX writer waits for room that never comes and refuses
    it at the deadline."""
    sock, writer = _stalled_writer(send_deadline=5.0)
    big = b"z" * 5000
    done = []
    t = threading.Thread(target=lambda: done.append(
        writer.send(net.T_WEIGHTS, 3, big)))
    t.start()
    time.sleep(0.2)
    assert not done                    # waits behind the queued frame
    sock.release.set()
    t.join(timeout=10.0)
    assert done == [True]
    writer.close(flush=True)
    assert big in b"".join(sock.sent)


def test_wire_flush_before_close():
    def send_all(sock):
        writer = wire.FrameWriter(sock)
        for i in range(50):
            assert writer.send(net.T_CONFIG, i, struct.pack("<dq", 0.0, i))
        writer.close(flush=True)

    rbuf = wire.RecvBuffer(_BytesSock(_stream(send_all)))
    for i in range(50):
        assert rbuf.recv_frame()[:2] == (net.T_CONFIG, i)
    assert rbuf.recv_frame() is None


def test_wire_writer_death_marks_dead_and_closes_socket():
    sock = _DeadSock()
    writer = wire.FrameWriter(sock)
    writer.send(net.T_WEIGHTS, 1, b"abc")
    assert _wait(lambda: writer.dead)
    assert sock.closed                  # the reader side is woken
    assert not writer.send(net.T_WEIGHTS, 2, b"def")
    writer.close(flush=True)


def test_wire_frames_per_syscall_counts():
    sock = _StallSock()
    writer = wire.FrameWriter(sock)
    assert writer.send(net.T_WEIGHTS, 0, b"w")
    assert _wait(lambda: writer.queued_bytes == 0)   # flush 1 stalled
    for i in range(9):
        assert writer.send(net.T_GRADIENTS, i, b"g")  # queue behind it
    sock.release.set()
    writer.close(flush=True)
    assert (writer.flushes, writer.frames_flushed, writer.syscalls) == \
        (2, 10, 2)
    want = [0] * len(wire.FPS_BUCKETS)
    want[0] += 1                        # 1 frame per syscall
    want[wire.FPS_BUCKETS.index(16.0)] += 1   # 9 frames: the <=16 bucket
    assert writer.fps_counts == want


def test_recv_buffer_mid_frame_eof_raises():
    rbuf = wire.RecvBuffer(_BytesSock(struct.pack("<I", 32) + b"\x01\x00"))
    with pytest.raises(ConnectionError, match="mid-frame"):
        rbuf.recv_frame()


def test_recv_buffer_grows_past_chunk_size():
    payload = bytes(range(256)) * 1024          # 256 KB >> 4 KB chunk
    data = _stream(lambda s: net.send_frame(s, net.T_WEIGHTS, 5, payload))
    rbuf = wire.RecvBuffer(_BytesSock(data), chunk=4096)
    topic, key, got = rbuf.recv_frame()
    assert (topic, key, bytes(got)) == (net.T_WEIGHTS, 5, payload)
    assert rbuf.recv_frame() is None


def test_bridges_expose_coalesce_lever():
    """coalesce=False: the per-frame locked send on both bridges."""
    for coalesce in (False, True):
        bridge = _server(coalesce=coalesce)
        worker = _worker(bridge.port, [1], coalesce=coalesce)
        bridge.wait_for_connected([1], timeout=10.0)
        assert len(bridge._writer_of) == int(coalesce)
        assert (worker._writer is not None) == coalesce
        buffers = {1: _buffer()}
        t = _reader(worker, buffers)
        assert bridge.send_data(1, {0: 1.0}, 1)     # sends still work
        assert _wait(lambda: buffers[1].count == 1)
        worker.close(), bridge.close()
        t.join(timeout=10.0)
