"""The port's socket transport against the JAX package's
(kafka_ps_tpu/runtime/net.py), both bridges in one process over
localhost, in both directions, for the codecs none, int8, bf16 and
topk:0.01:

  * every frame a bridge of either package puts on the wire for the same
    message — HELLO, CONFIG, WEIGHTS, DATA_BATCH, GRADIENTS, READY — is
    byte for byte the other package's;
  * a port WorkerBridge against a JAX ServerBridge, and a JAX
    WorkerBridge against a port ServerBridge: the run id and the
    negotiated codec as the JAX package negotiates them, DATA_BATCH rows
    landing identically in each package's buffer, WEIGHTS and GRADIENTS
    decoding bitwise equal (values and, when compressed, parts);
  * a codec mismatch falls back to none in both directions, compressed
    weights then crossing as plain f32 frames.

The same message means the same encoded parts: int8 parts come from one
package's codec and are carried across (the JAX package's jitted int8
codec may put a scale 1 ulp off the eager one, ROADMAP C.3).  Every
comparison is exact.
"""

from __future__ import annotations

import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from kafka_ps_tpu import compress as jcompress
from kafka_ps_tpu.compress import wire as jcwire
from kafka_ps_tpu.data.buffer import SlidingBuffer as JBuffer
from kafka_ps_tpu.runtime import fabric as jfabric
from kafka_ps_tpu.runtime import messages as jmsg
from kafka_ps_tpu.runtime import net as jnet
from kafka_ps_tpu.runtime import serde as jserde
from kafka_ps_tpu.utils.config import BufferConfig as JBufferConfig
from kafka_ps_tpu_torch.compress import wire as cwire
from kafka_ps_tpu_torch.data.buffer import SlidingBuffer
from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime import net, serde
from kafka_ps_tpu_torch.runtime.messages import (GradientMessage, KeyRange,
                                                 WeightsMessage)
from kafka_ps_tpu_torch.utils.config import BufferConfig

N = 6150                    # the reference model's parameter count
F = 16                      # the rows' feature width
CODECS = ["none", "int8", "bf16", "topk:0.01"]
RUN_ID = 424242


def _vec(seed):
    return np.random.default_rng(seed).standard_normal(N).astype(np.float32)


def _rows(seed=3, n=20):
    """Stream rows with float32-exact values, as the producer makes."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        keys = sorted(rng.choice(F, size=5, replace=False).tolist())
        vals = rng.standard_normal(5).astype(np.float32).tolist()
        rows.append((dict(zip(keys, vals)), int(rng.integers(0, 3))))
    return rows


def _jax_weights(codec, clock=7, seed=1):
    """A JAX WeightsMessage over a random theta: through the JAX weights
    compressor when `codec` compresses."""
    theta = _vec(seed)
    spec = jcwire.parse_codec(codec)
    if spec.codec_id == jcwire.CODEC_NONE:
        return jmsg.WeightsMessage(vector_clock=clock,
                                   key_range=jmsg.KeyRange(0, N),
                                   values=theta)
    values, enc = jcompress.WeightsCompressor(
        jcompress.get_codec(spec, N)).encode(theta)
    return jmsg.WeightsMessage(vector_clock=clock,
                               key_range=jmsg.KeyRange(0, N),
                               values=values, encoded=enc)


def _jax_gradient(codec, clock=7, worker=0, seed=2):
    delta = _vec(seed)
    spec = jcwire.parse_codec(codec)
    if spec.codec_id == jcwire.CODEC_NONE:
        return jmsg.GradientMessage(vector_clock=clock,
                                    key_range=jmsg.KeyRange(0, N),
                                    values=delta, worker_id=worker)
    values, enc = jcompress.ErrorFeedback(
        jcompress.get_codec(spec, N)).step(delta)
    return jmsg.GradientMessage(vector_clock=clock,
                                key_range=jmsg.KeyRange(0, N),
                                values=values, encoded=enc,
                                worker_id=worker)


def _port_message(jax_message):
    """The port's message with the same values and encoded parts."""
    return serde.from_bytes(jserde.to_bytes(jax_message), device="cpu")


def _hello(codec) -> bytes:
    spec = cwire.parse_codec(codec)
    return (struct.pack("<qq", 1, 0) + struct.pack("<Bf", spec.codec_id,
                                                   spec.param)
            + struct.pack("<B", 0))


def _frames(sock, n):
    out = []
    for _ in range(n):
        topic, key, payload = net.recv_frame(sock)
        out.append((topic, key, bytes(payload)))
    return out


def _same_values(a, b) -> bool:
    return (np.asarray(a, dtype=np.float32).tobytes()
            == np.asarray(b, dtype=np.float32).tobytes())


def _same_parts(a, b) -> bool:
    """Two EncodedValues (either package's) carry the same parts."""
    if a is None or b is None:
        return a is b
    pa = [np.asarray(p.cpu() if isinstance(p, torch.Tensor) else p)
          for p in a.parts]
    pb = [np.asarray(p.cpu() if isinstance(p, torch.Tensor) else p)
          for p in b.parts]
    return (a.codec_id == b.codec_id and a.param == b.param
            and len(pa) == len(pb)
            and all(x.view(np.uint8).tobytes() == y.view(np.uint8).tobytes()
                    for x, y in zip(pa, pb)))


def _server_frames(bridge, fabric, codec, weights, rows):
    """What a server bridge sends a worker that HELLOs with `codec`: the
    CONFIG, one WEIGHTS frame and one DATA_BATCH frame."""
    sock = socket.create_connection(("127.0.0.1", bridge.port))
    net.send_frame(sock, net.T_HELLO, 0, _hello(codec))
    config = _frames(sock, 1)
    bridge.wait_for_connected([0], timeout=10.0)
    fabric.send(fabric_mod.WEIGHTS_TOPIC, 0, weights)
    sent = _frames(sock, 1)
    assert bridge.send_data_batch(0, rows)
    sent += _frames(sock, 1)
    sock.close()
    bridge.close()
    return config + sent


def _worker_frames(make_worker, codec, gradient):
    """What a worker bridge sends a server that answers with `codec`:
    HELLO, then one GRADIENTS frame and one READY."""
    srv = socket.create_server(("127.0.0.1", 0))
    got: list = []
    spec = cwire.parse_codec(codec)

    def serve():
        conn, _ = srv.accept()
        got.extend(_frames(conn, 1))
        net.send_frame(conn, net.T_CONFIG, 0,
                       struct.pack("<dq", 0.0, RUN_ID)
                       + struct.pack("<Bf", spec.codec_id, spec.param)
                       + struct.pack("<B", 0))
        got.extend(_frames(conn, 2))
        conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    worker = make_worker(srv.getsockname()[1])
    worker.send_gradients(0, gradient)
    worker.mark_ready(0)
    t.join(timeout=10.0)
    worker.close()
    srv.close()
    return got


@pytest.mark.parametrize("codec", CODECS)
def test_frames_byte_identical(codec):
    rows = _rows()
    jw = _jax_weights(codec)
    jb = jnet.ServerBridge(run_id=RUN_ID, codec=jcwire.parse_codec(codec))
    jax_server = _server_frames(jb, jb.wrap(jfabric.Fabric()), codec, jw,
                                rows)
    pb = net.ServerBridge(run_id=RUN_ID, codec=cwire.parse_codec(codec),
                          device="cpu")
    port_server = _server_frames(pb, pb.wrap(fabric_mod.Fabric()), codec,
                                 _port_message(jw), rows)
    assert [f[0] for f in port_server] == [net.T_CONFIG, net.T_WEIGHTS,
                                           net.T_DATA_BATCH]
    assert port_server == jax_server

    jg = _jax_gradient(codec)
    jax_worker = _worker_frames(lambda port: jnet.WorkerBridge(
        "127.0.0.1", port, [0], codec=jcwire.parse_codec(codec)), codec, jg)
    port_worker = _worker_frames(lambda port: net.WorkerBridge(
        "127.0.0.1", port, [0], codec=cwire.parse_codec(codec),
        device="cpu"), codec, _port_message(jg))
    assert [f[0] for f in port_worker] == [net.T_HELLO, net.T_GRADIENTS,
                                           net.T_READY]
    assert port_worker == jax_worker


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


def _snapshot(buf):
    x, y, mask = buf.snapshot()
    return np.asarray(x), np.asarray(y), np.asarray(mask)


def _same_buffers(a, b) -> bool:
    return all(np.array_equal(u, v) for u, v in zip(_snapshot(a),
                                                    _snapshot(b)))


def _buffers(pkg):
    if pkg == "jax":
        return {0: JBuffer(F, JBufferConfig(min_size=32, max_size=32))}
    return {0: SlidingBuffer(F, BufferConfig(min_size=32, max_size=32))}


def _bridge_pair(server_pkg, server_codec, worker_codec):
    """(server bridge, its wrapped fabric, worker bridge, its fabric,
    worker buffers, reader thread) with the worker reading."""
    if server_pkg == "jax":
        sb = jnet.ServerBridge(run_id=RUN_ID,
                               codec=jcwire.parse_codec(server_codec))
        sfab = sb.wrap(jfabric.Fabric())
        wb = net.WorkerBridge("127.0.0.1", sb.port, [0],
                              codec=cwire.parse_codec(worker_codec),
                              device="cpu")
        bufs = _buffers("port")
    else:
        sb = net.ServerBridge(run_id=RUN_ID,
                              codec=cwire.parse_codec(server_codec),
                              device="cpu")
        sfab = sb.wrap(fabric_mod.Fabric())
        wb = jnet.WorkerBridge("127.0.0.1", sb.port, [0],
                               codec=jcwire.parse_codec(worker_codec))
        bufs = _buffers("jax")
    wfab = wb.make_fabric()
    sb.wait_for_connected([0], timeout=10.0)
    t = threading.Thread(target=wb.run_reader, args=(bufs,), daemon=True)
    t.start()
    return sb, sfab, wb, wfab, bufs, t


def _close(sb, wb, t):
    wb.close()
    sb.close()
    t.join(timeout=10.0)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_bridges_interoperate(server_pkg, codec):
    """A port worker with a JAX server, and a JAX worker with a port
    server: negotiation, rows, weights and gradients."""
    sb, sfab, wb, wfab, bufs, t = _bridge_pair(server_pkg, codec, codec)
    try:
        assert wb.server_run_id == RUN_ID
        assert (wb.negotiated.codec_id, wb.negotiated.param) == \
            (cwire.parse_codec(codec).codec_id,
             cwire.parse_codec(codec).param)
        # rows land as the other package's buffer holds them
        rows = _rows()
        assert sb.send_data_batch(0, rows)
        assert _wait(lambda: bufs[0].count == len(rows))
        other = _buffers("port" if server_pkg == "jax" else "jax")
        other[0].add_many(rows)
        assert _same_buffers(bufs[0], other[0])
        # weights, server -> worker
        jw = _jax_weights(codec)
        sent = jw if server_pkg == "jax" else _port_message(jw)
        sfab.send(fabric_mod.WEIGHTS_TOPIC, 0, sent)
        got = wfab.poll_blocking(fabric_mod.WEIGHTS_TOPIC, 0, timeout=10.0)
        assert got.vector_clock == jw.vector_clock
        assert _same_values(got.values, jw.values)
        assert _same_parts(got.encoded, jw.encoded)
        # gradients, worker -> server
        jg = _jax_gradient(codec)
        sent = _port_message(jg) if server_pkg == "jax" else jg
        wfab.send(fabric_mod.GRADIENTS_TOPIC, 0, sent)
        g = sfab.poll_blocking(fabric_mod.GRADIENTS_TOPIC, 0, timeout=10.0)
        assert (g.worker_id, g.vector_clock) == (0, jg.vector_clock)
        assert _same_values(g.values, jg.values)
        assert _same_parts(g.encoded, jg.encoded)
    finally:
        _close(sb, wb, t)


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_codec_mismatch_falls_back_to_none(server_pkg):
    """Server int8, worker bf16: both sides agree on none, and the
    server's compressed weights cross as the plain f32 frame of their
    decoded values."""
    sb, sfab, wb, wfab, bufs, t = _bridge_pair(server_pkg, "int8", "bf16")
    try:
        assert wb.negotiated.codec_id == cwire.CODEC_NONE
        jw = _jax_weights("int8")
        sfab.send(fabric_mod.WEIGHTS_TOPIC, 0,
                  jw if server_pkg == "jax" else _port_message(jw))
        got = wfab.poll_blocking(fabric_mod.WEIGHTS_TOPIC, 0, timeout=10.0)
        assert got.encoded is None
        assert _same_values(got.values, jw.values)
    finally:
        _close(sb, wb, t)


def test_port_server_interoperates_with_a_tracing_jax_worker():
    """A JAX worker whose tracer is on offers trace context; the port
    answers 0, so no 16-byte suffix ever crosses and frames decode."""
    from kafka_ps_tpu.utils.trace import Tracer
    sb = net.ServerBridge(run_id=RUN_ID, device="cpu")
    sfab = sb.wrap(fabric_mod.Fabric())
    wb = jnet.WorkerBridge("127.0.0.1", sb.port, [0], tracer=Tracer())
    wfab = wb.make_fabric()
    assert wb.trace_negotiated is False
    t = threading.Thread(target=wb.run_reader, args=({},), daemon=True)
    t.start()
    try:
        sb.wait_for_connected([0], timeout=10.0)
        theta = torch.from_numpy(_vec(4))
        sfab.send(fabric_mod.WEIGHTS_TOPIC, 0, WeightsMessage(
            vector_clock=1, key_range=KeyRange(0, N), values=theta))
        got = wfab.poll_blocking(fabric_mod.WEIGHTS_TOPIC, 0, timeout=10.0)
        assert _same_values(got.values, theta.numpy())
        wfab.send(fabric_mod.GRADIENTS_TOPIC, 0, jmsg.GradientMessage(
            vector_clock=1, key_range=jmsg.KeyRange(0, N),
            values=theta.numpy(), worker_id=0))
        g = sfab.poll_blocking(fabric_mod.GRADIENTS_TOPIC, 0, timeout=10.0)
        assert isinstance(g, GradientMessage)
        assert torch.equal(g.values, theta)
    finally:
        _close(sb, wb, t)
