"""Socket transport (counterpart of kafka_ps_tpu/runtime/net.py): the
cross-process hop of the split deployment (cli/socket_mode.py), carrying
the binary serde frames (runtime/serde.py) over TCP.

The reference's server JVM and worker JVMs exchange WEIGHTS / GRADIENTS /
INPUT_DATA through the broker from different machines; here a server
process (aggregator + consistency gate + producer) and worker processes
(buffers + local solvers) talk over point-to-point sockets in place of
topics.  The frames are byte for byte the JAX package's, so a server of
either package serves workers of the other.

Wire format, little-endian:
    frame  := <u32 length> <u8 topic> <i64 key> <payload>
    topic  := 1 WEIGHTS | 2 GRADIENTS | 3 INPUT_DATA | 4 HELLO | 5 READY
              | 6 PING | 7 PONG | 8 CONFIG | 9 PREDICT | 10 PREDICTION
              | 11 DATA_BATCH | 12 WEIGHTS_AGG
    payload:= serde.to_bytes(message)   (HELLO: <i64 n> <i64 ids[n]>
                                                [<u8 codec_id> <f32 param>]
                                                [<u8 trace offer>]
                                                [<u8 shm request>]
                                                [<u8 aggregator role>];
                                         READY/PING/PONG: empty;
                                         CONFIG: <f64 ping_interval_s>
                                                 <i64 run_id>
                                                 [<u8 codec_id> <f32 param>]
                                                 [<u8 trace answer>]
                                                 [shm offer];
                                         DATA_BATCH: columnar <i64 -nrows>
                                         + packed index/value/label
                                         columns (serde.
                                         encode_labeled_rows); the
                                         legacy <i64 nrows> then per row
                                         <i32 len><serde bytes> layout
                                         is still accepted on receive;
                                         PREDICT / PREDICTION: see the
                                         encode_/decode_ helpers below)
`key` is the logical worker id (the Kafka record key); for
PREDICT/PREDICTION it is the client's request id (echoed back).

Codec negotiation: HELLO optionally carries the worker's `--compress`
codec; the server's CONFIG reply echoes the codec the pair will use —
the server's own when both sides named the SAME one, `none` otherwise.
Trailers are read with unpack_from, so an older peer never sees them and
the pair falls back to plain f32 frames.

Scale-out (runtime/sharding.py, agg/): a range-sharded worker process
keeps one WorkerBridge per shard and plugs each into the weights
assembler (`set_weights_sink`).  A HELLO with the aggregator-role byte
registers a per-host relay for its member ids: its disconnect evicts
nobody (the members live on behind a restarting relay), and a release
set may go to it as ONE T_WEIGHTS_AGG frame (`send_weights_group`:
<q n>, n x <q worker><q clock>, one serde weights body whose clock the
relay rewrites per member).  The relay's side: `WorkerBridge(aggregator=
True)`, `raw_forward` (rows and weights passed on as bytes),
`send_payload` (a composite serialized once), and on its listener
`forward_frame` and `send_goodbye` (the GOODBYE config that tells members
the run ended, unlike a killed relay).

Serving (serving/): a ServerBridge made with `engine=` answers PREDICT
frames from any connection, worker or plain client (a client
sends no HELLO and registers no ids, so routing never sees it), through
the engine asynchronously: the reader never waits on a batch window, and
the reply leaves from the engine's callback.  Without an engine a
PREDICT is answered PREDICT_FAILED.  A bridge made with `shm=True` and an
engine offers a client whose HELLO asks for it a shared-memory channel
(serving/shm.py) on its CONFIG; a declined offer (shm off, no engine, no
segment) keeps the client on the socket.  `PredictClient` is the client:
one outstanding request per connection, typed StalenessError and
OverloadedError, the shm upgrade and reconnects.

Trace-context negotiation rides the same pattern: one `<u8 offer>` byte
after the codec trailer on HELLO (a worker or relay offers 1 iff its
tracer is on) and on CONFIG (the server answers 1 iff the offer arrived
and its own tracer is on).  On a negotiated connection every WEIGHTS and
GRADIENTS payload gains the 16-byte `<u64 flow_id> <u64 parent_span>`
suffix (`_TRACE_CTX`, parent 0) after the serde bytes; the reader strips
it before decoding and records the matching flow event: `delta.wire`
starts at the worker's `net.send` and steps at the server's `net.recv`,
`weights.wire` starts at the server's `net.send` and ends at the
worker's `net.recv`.  A peer of either package that does not offer never
sees a suffix, so an untraced connection's frames are byte for byte the
untraced ones.  The flow ids are the sending tracer's (its pid in the
top bits), so the merge tool (telemetry/merge.py, or the JAX
package's) joins the processes' traces into one chain.

Decoded tensors land on the bridge's device (`device`, resolved once by
utils.config.resolve_device when the bridge is made), passed explicitly
to every `serde.from_bytes`.

A reader ends a connection on ConnectionError/OSError (EOF, reset, a
timeout): that is a disconnect, and the server's `on_disconnect` fires.
Any other exception — a CUDA error while a gradient lands on the card, a
frame that does not decode — is not a disconnect: the reader keeps it in
`reader_error`, fires no `on_disconnect`, and the caller re-raises it
(`raise_reader_error`), so the process exits non-zero instead of
evicting a healthy worker.  The JAX readers run their disconnect path
for every exception.

The counters are plain integers on each bridge: `traffic` frames and
bytes (frame header included) per (direction, topic), with `wire_bytes`
per topic over both directions as in the JAX package, `serde_s` and
`serde_frames` per topic (seconds spent in serde encode and decode, the
device copies included), and `dropped_sends`; `stats()` reads them.

Telemetry (`tracer=`, `telemetry=`, null by default) is the JAX
bridges': the `frames_sent`, `frames_received` and
`wire_bytes_total{topic,direction}` families (resolved once per bridge,
fed at enqueue time: a ServerBridge counts every frame both ways, a
WorkerBridge its received frames and its gradients sent), the writers'
`wire_*` families, `serving_dispatch_mode{mode="shm"}`, the `net.send`
and `net.recv` spans and the flight records `net.send`, `net.recv`,
`net.weights_recv`, `net.hello`, `net.disconnect` and (per shm reply)
`serving.batch`.
"""

from __future__ import annotations

import dataclasses
import socket
import struct
import sys
import threading
import time

from kafka_ps_tpu_torch.analysis.lockgraph import OrderedLock
from kafka_ps_tpu_torch.compress.wire import CODEC_NONE, CodecSpec
from kafka_ps_tpu_torch.compress.wire import NONE as CODEC_SPEC_NONE
from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime import serde
from kafka_ps_tpu_torch.runtime.messages import LabeledData
from kafka_ps_tpu_torch.runtime.wire import (_FRAME, FrameWriter, RecvBuffer,
                                             force_close, sendmsg_all)
from kafka_ps_tpu_torch.serving.engine import Prediction
from kafka_ps_tpu_torch.serving.policy import (OverloadedError, ReadBound,
                                               StalenessError)
from kafka_ps_tpu_torch.serving.shm import ShmChannel, ShmError
from kafka_ps_tpu_torch.telemetry import NULL_TELEMETRY
from kafka_ps_tpu_torch.telemetry.flight import FLIGHT
from kafka_ps_tpu_torch.utils.config import resolve_device
from kafka_ps_tpu_torch.utils.trace import NULL_TRACER

(T_WEIGHTS, T_GRADIENTS, T_DATA, T_HELLO, T_READY,
 T_PING, T_PONG, T_CONFIG, T_PREDICT, T_PREDICTION,
 T_DATA_BATCH, T_WEIGHTS_AGG) = range(1, 13)
# the full frame-topic table: data topics map to their fabric names,
# control/serving topics to wire-only names
TOPIC_NAMES = {T_WEIGHTS: fabric_mod.WEIGHTS_TOPIC,
               T_GRADIENTS: fabric_mod.GRADIENTS_TOPIC,
               T_DATA: fabric_mod.INPUT_DATA_TOPIC,
               T_HELLO: "hello", T_READY: "ready",
               T_PING: "ping", T_PONG: "pong", T_CONFIG: "config",
               T_PREDICT: "predict", T_PREDICTION: "prediction",
               T_DATA_BATCH: "input-data-batch",
               T_WEIGHTS_AGG: "weights-agg"}

# the optional codec trailer on HELLO and CONFIG (negotiation above)
_CODEC_TRAILER = struct.Struct("<Bf")
# the optional trace-offer/answer byte AFTER the codec trailer
_TRACE_TRAILER = struct.Struct("<B")
# the per-message trace context suffixed to WEIGHTS/GRADIENTS payloads
# when the pair negotiated tracing: <u64 flow_id> <u64 parent_span>
_TRACE_CTX = struct.Struct("<QQ")
# the optional shared-memory request byte AFTER the trace trailer on
# HELLO, and the matching offer AFTER the trace trailer on CONFIG:
# <u8 granted> <16s nonce> <64s NUL-padded segment name>
_SHM_TRAILER = struct.Struct("<B")
_SHM_OFFER = struct.Struct("<B16s64s")
# the optional aggregator-role byte AFTER the shm trailer on HELLO: 1
# marks a per-host aggregator relay (its ids are its members)
_AGG_TRAILER = struct.Struct("<B")
# T_CONFIG re-sent mid-stream with this run id is a GOODBYE: the run is
# over and the peer is closing on purpose.  Real run ids are time_ns()
# or checkpointed positives; -1 can never collide.
GOODBYE_RUN_ID = -1
# a T_WEIGHTS_AGG member entry: <q worker> <q clock>
_AGG_MEMBER = struct.Struct("<qq")

# -- serving-plane payloads ---------------------------------------------------
# PREDICT: the feature row plus the request's staleness bound; sentinel
# -1 encodes "unbounded" (clocks are non-negative, ages positive)
_PREDICT_HEADER = struct.Struct("<qdq")   # min_clock, max_age_s, n features
# PREDICTION: status + (label, confidence, snapshot clock, snapshot time)
_PREDICTION = struct.Struct("<Bqdqd")
PREDICT_OK, PREDICT_STALE, PREDICT_FAILED, PREDICT_OVERLOADED = 0, 1, 2, 3
# optional model-id trailer AFTER the feature row, so frames from peers
# that never send it decode as model 0
_MODEL_TRAILER = struct.Struct("<q")


def encode_predict_request(x, min_clock: int | None = None,
                           max_age_s: float | None = None,
                           model_id: int = 0) -> bytes:
    import numpy as np
    row = np.asarray(x, dtype=np.float32).reshape(-1)
    return (_PREDICT_HEADER.pack(
        -1 if min_clock is None else int(min_clock),
        -1.0 if max_age_s is None else float(max_age_s),
        row.size) + row.tobytes()
        + _MODEL_TRAILER.pack(int(model_id)))


def decode_predict_request(payload: bytes):
    """(features, min_clock | None, max_age_s | None, model_id)."""
    import numpy as np
    min_clock, max_age_s, n = _PREDICT_HEADER.unpack_from(payload, 0)
    row = np.frombuffer(payload, dtype=np.float32, count=n,
                        offset=_PREDICT_HEADER.size)
    model_id = 0
    tail = _PREDICT_HEADER.size + row.nbytes
    if len(payload) >= tail + _MODEL_TRAILER.size:
        (model_id,) = _MODEL_TRAILER.unpack_from(payload, tail)
    return (row, None if min_clock < 0 else min_clock,
            None if max_age_s < 0 else max_age_s, model_id)


def encode_prediction(status: int, label: int = -1, confidence: float = 0.0,
                      vector_clock: int = -1, wall_time: float = 0.0) -> bytes:
    return _PREDICTION.pack(status, label, confidence, vector_clock,
                            wall_time)


def decode_prediction(payload: bytes):
    """(status, label, confidence, vector_clock, wall_time)."""
    return _PREDICTION.unpack_from(payload, 0)


def _encode_result(result) -> bytes:
    """A PredictionEngine callback's argument (a Prediction, or the typed
    failure passed instead) as a PREDICTION payload; one mapping for the
    socket and the shm replies."""
    if isinstance(result, OverloadedError):
        return encode_prediction(PREDICT_OVERLOADED)
    if isinstance(result, StalenessError):
        return encode_prediction(PREDICT_STALE)
    if isinstance(result, BaseException):
        return encode_prediction(PREDICT_FAILED)
    return encode_prediction(PREDICT_OK, result.label, result.confidence,
                             result.vector_clock, result.wall_time)


def _read_shm_offer(payload, offset: int) -> tuple[str, bytes] | None:
    """The optional shm offer after the trace trailer on CONFIG:
    (segment name, nonce), or None when absent (an older server) or
    declined (granted byte 0)."""
    if len(payload) < offset + _SHM_OFFER.size:
        return None
    granted, nonce, name = _SHM_OFFER.unpack_from(payload, offset)
    if not granted:
        return None
    return name.rstrip(b"\0").decode("ascii", "replace"), nonce


def send_frame(sock: socket.socket, topic: int, key: int,
               payload: bytes = b"") -> None:
    """One frame, immediately (the non-queued path).  Header and payload
    go out as a two-element scatter-gather send — a multi-KB weights
    payload is never copied just to prepend 13 bytes."""
    header = _FRAME.pack(_FRAME.size - 4 + len(payload), topic, key)
    if len(payload):
        sendmsg_all(sock, (header, payload))
    else:
        sock.sendall(header)


def locked_send(sock: socket.socket, lock, topic: int, key: int,
                payload: bytes = b"") -> None:
    """Serialize one frame write onto `sock` under its dedicated write
    lock: interleaved frame bodies from concurrent senders would corrupt
    the stream, so the lock's whole critical section IS the write."""
    with lock:
        # pscheck: disable=PS105 (dedicated write lock: this send IS the critical section)
        send_frame(sock, topic, key, payload)


def recv_frame(sock: socket.socket) -> tuple[int, int, memoryview] | None:
    """(topic, key, payload) or None on a clean EOF.  The payload is a
    zero-copy memoryview into the received frame body."""
    head = _recv_exact(sock, 4)
    if head is None:
        return None
    (length,) = struct.unpack("<I", head)
    body = _recv_exact(sock, length)
    if body is None:
        raise ConnectionError("mid-frame EOF")
    topic, key = struct.unpack_from("<Bq", body, 0)
    return topic, key, memoryview(body)[9:]


def _read_codec_trailer(payload, offset: int) -> CodecSpec:
    """The optional <u8 codec_id> <f32 param> trailer of a HELLO or
    CONFIG payload; NONE when absent (old peer) or unintelligible
    (newer peer with codec ids we don't know)."""
    if len(payload) < offset + _CODEC_TRAILER.size:
        return CODEC_SPEC_NONE
    cid, param = _CODEC_TRAILER.unpack_from(payload, offset)
    try:
        return CodecSpec(cid, param)
    except ValueError:
        return CODEC_SPEC_NONE


def _read_flag(trailer: struct.Struct, payload, offset: int) -> bool:
    """An optional one-byte trailer (trace offer, shm request,
    aggregator role); False when absent (an older peer)."""
    if len(payload) < offset + trailer.size:
        return False
    (flag,) = trailer.unpack_from(payload, offset)
    return bool(flag)


def _frame_counters(telemetry):
    """Per-topic (frames, wire bytes) counter children, sent and
    received, resolved once per bridge so the frame paths never take the
    registry's family lock; null children when telemetry is off."""
    sent = {t: (telemetry.counter("frames_sent", topic=name),
                telemetry.counter("wire_bytes_total", topic=name,
                                  direction="out"))
            for t, name in TOPIC_NAMES.items()}
    recv = {t: (telemetry.counter("frames_received", topic=name),
                telemetry.counter("wire_bytes_total", topic=name,
                                  direction="in"))
            for t, name in TOPIC_NAMES.items()}
    return sent, recv


def _strip_trace(payload):
    """(payload without its trace suffix, flow id)."""
    cut = len(payload) - _TRACE_CTX.size
    (fid, _parent) = _TRACE_CTX.unpack_from(payload, cut)
    return payload[:cut], fid


def _recv_exact(sock: socket.socket, n: int) -> bytearray | bytes | None:
    """Exactly n bytes, or None on a clean EOF before the first byte.
    EOF after a partial read is a torn frame — a crashed peer, never an
    orderly shutdown — and raises.  The handshake's read path (bridge
    readers use wire.RecvBuffer)."""
    if n == 0:
        return b""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if r == 0:
            if got:
                raise ConnectionError(
                    f"mid-frame EOF ({got}/{n} bytes)")
            return None
        got += r
    return buf


class _Counters:
    """The plain-integer wire counters one bridge keeps (module
    docstring), under one lock, `_wire_lock`: the reader, the sending
    threads and the heartbeat all count.  The bridge names that lock
    (`ServerBridge.wire`, `WorkerBridge.wire`) before it calls this
    __init__."""

    def __init__(self, tracer=None, telemetry=None):
        self.traffic: dict[tuple[str, int], list[int]] = {}
        self.serde_s: dict[int, float] = {}
        self.serde_frames: dict[int, int] = {}
        self._tracer = tracer or NULL_TRACER
        self._telemetry = telemetry or NULL_TELEMETRY
        self._m_sent, self._m_recv = _frame_counters(self._telemetry)

    @property
    def wire_bytes(self) -> dict[int, int]:
        """Bytes on the wire per frame topic, both directions."""
        out: dict[int, int] = {}
        with self._wire_lock:
            for (_, topic), (_, nbytes) in self.traffic.items():
                out[topic] = out.get(topic, 0) + nbytes
        return out

    def _count(self, direction: str, topic: int, payload_len: int) -> None:
        with self._wire_lock:
            t = self.traffic.setdefault((direction, topic), [0, 0])
            t[0] += 1
            t[1] += _FRAME.size + payload_len

    def _family(self, children, topic: int, payload_len: int) -> None:
        """One frame on the `frames_*` and `wire_bytes_total` families."""
        if self._telemetry.enabled:
            frames, nbytes = children[topic]
            frames.inc()
            nbytes.inc(_FRAME.size + payload_len)

    def _traced(self, payload, topic: str, worker: int) -> bytes:
        """`payload` with a fresh flow's trace suffix: `weights.wire`
        (topic "weights") or `delta.wire` (topic "gradients") started on
        a `net.send` span."""
        fid = self._tracer.new_flow_id()
        with self._tracer.span("net.send", topic=topic, worker=worker):
            if topic == "weights":
                self._tracer.flow_start("weights.wire", fid, worker=worker)
            else:
                self._tracer.flow_start("delta.wire", fid)
        return b"".join((payload, _TRACE_CTX.pack(fid, 0)))

    def _serde(self, topic: int, t0: float) -> None:
        dt = time.perf_counter() - t0
        with self._wire_lock:
            self.serde_s[topic] = self.serde_s.get(topic, 0.0) + dt
            self.serde_frames[topic] = self.serde_frames.get(topic, 0) + 1

    def _decode(self, topic: int, payload):
        t0 = time.perf_counter()
        msg = serde.from_bytes(payload, device=self.device)
        self._serde(topic, t0)
        return msg

    def _encode(self, topic: int, message) -> bytes:
        t0 = time.perf_counter()
        payload = serde.to_bytes(message)
        self._serde(topic, t0)
        return payload

    def wire_stats(self) -> dict:
        """Per topic name: frames and bytes out and in, and the serde
        milliseconds per frame where frames were encoded or decoded."""
        out: dict = {}
        with self._wire_lock:
            for (direction, topic), (frames, nbytes) in self.traffic.items():
                t = out.setdefault(TOPIC_NAMES.get(topic, str(topic)), {})
                t[f"frames_{direction}"] = frames
                t[f"bytes_{direction}"] = nbytes
            for topic, n in self.serde_frames.items():
                t = out.setdefault(TOPIC_NAMES.get(topic, str(topic)), {})
                t["serde_frames"] = n
                t["serde_ms_per_frame"] = 1e3 * self.serde_s[topic] / n
        return out

    def raise_reader_error(self) -> None:
        """Re-raise the first exception a reader kept (module
        docstring): the caller's process then exits non-zero."""
        err = self.reader_error
        if err is not None:
            raise RuntimeError(
                f"socket reader failed: {err!r}") from err


def _writer_stats(writers) -> dict:
    """Frames per syscall of a bridge's coalescing writers."""
    frames = sum(w.frames_flushed for w in writers)
    syscalls = sum(w.syscalls for w in writers)
    return {"flushes": sum(w.flushes for w in writers),
            "frames_per_syscall": frames / syscalls if syscalls else None,
            "advisory_dropped": sum(w.advisory_dropped for w in writers)}


class ServerBridge(_Counters):
    """Server-process side: listens for worker processes, forwards
    WEIGHTS / INPUT_DATA to the connection owning each worker key, and
    delivers incoming GRADIENTS into the local fabric's gather queue.

    Install via `bridge.wrap(fabric)`: the returned fabric routes sends
    addressed to remote workers over their socket and leaves local
    behavior untouched (the Kafka-broker role, minus the broker).

    Failure detection (the consumer-group-rebalance analogue): a reader
    hitting EOF/reset purges the connection's worker ids and fires
    `on_disconnect(ids)`; a later HELLO re-registers them and fires
    `on_hello(ids)`; READY fires `on_ready(worker)` — the caller
    (cli/socket_mode.run_server) turns these into evictions and
    readmissions on the ServerNode.  With `heartbeat_interval` set the
    bridge PINGs every connection on that cadence and, when
    `heartbeat_timeout` is also set, force-closes connections silent for
    longer than it — half-open TCP then surfaces as a normal disconnect
    instead of hanging the consistency gate forever."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 heartbeat_interval: float | None = None,
                 heartbeat_timeout: float | None = None,
                 run_id: int = 0, codec: CodecSpec | None = None,
                 coalesce: bool = True, device=None, shm: bool = False,
                 engine=None, tracer=None, telemetry=None):
        self._wire_lock = OrderedLock("ServerBridge.wire")
        super().__init__(tracer, telemetry)
        # `device`: where decoded gradients land (the ServerNode's)
        self.device = resolve_device(device)
        # `run_id` identifies the logical RUN (fresh server start, or the
        # run a checkpoint resume continues), advertised in T_CONFIG so
        # worker processes can tell whether their local state file
        # belongs to THIS run
        self.run_id = run_id
        # `codec`: this server's `--compress` choice; per-connection
        # negotiation lands in `_codec_of`, and sends to a
        # none-negotiated peer strip the encoded payload in _send
        self.codec = codec if codec is not None else CODEC_SPEC_NONE
        # guarded-by: _lock (HELLO writes hold the state lock; send-path reads are GIL-atomic dict gets)
        self._codec_of: dict[socket.socket, CodecSpec] = {}
        # per-connection trace negotiation (module docstring): True iff
        # the peer offered and this side's tracer is on
        # guarded-by: _lock (HELLO writes hold the state lock; send-path reads are GIL-atomic)
        self._trace_of: dict[socket.socket, bool] = {}
        self._listener = socket.create_server((host, port))
        self.port = self._listener.getsockname()[1]
        # guarded-by: _lock (registration holds the cv; routing reads are GIL-atomic dict gets)
        self._conn_of: dict[int, socket.socket] = {}   # worker -> conn
        self._ready: set[int] = set()
        self._lock = OrderedLock("ServerBridge.state", reentrant=True)
        self._cv = threading.Condition(self._lock)
        # pscheck: disable=PS201 (wrap publishes the fabric before any traffic can reference it - attach-before-serve)
        self._fabric: fabric_mod.Fabric | None = None
        self._stop = threading.Event()
        self._send_lock: dict[socket.socket, OrderedLock] = {}
        # `--wire-coalesce`: queue frames per connection and ship them in
        # scatter-gather batches from a dedicated writer thread; off =
        # one sendall per frame under the connection lock
        self._coalesce = bool(coalesce)
        # guarded-by: _lock (accept-loop writes hold the state lock; send-path reads are GIL-atomic)
        self._writer_of: dict[socket.socket, FrameWriter] = {}
        self._writers: list[FrameWriter] = []     # every one made (stats)
        # guarded-by: _lock (registered under the lock; the reader's per-frame store is GIL-atomic and the heartbeat tolerates an interval of staleness)
        self._last_recv: dict[socket.socket, float] = {}
        self.on_disconnect = None   # Callable[[list[int]], None]
        self.on_hello = None        # Callable[[list[int]], None]
        self.on_ready = None        # Callable[[int], None]
        # the PredictionEngine answering PREDICT, set before the listener
        # accepts (no client can find the port without one)
        # pscheck: disable=PS201 (attach_serving publishes the engine before predict frames can arrive)
        self._serving = engine
        # offer the shared-memory channel (module docstring); one channel
        # and one serve thread per connection that took it
        self._shm_enabled = bool(shm)
        # guarded-by: _lock (offer/teardown hold the state lock; reads are GIL-atomic)
        self._shm_of: dict[socket.socket, object] = {}
        self._shm_threads: list[threading.Thread] = []
        # guarded-by: _wire_lock (the shm serve threads count under the wire lock; stats reads are int snapshots)
        self.shm_predictions = 0    # predictions answered over shm
        self._m_shm = self._telemetry.counter("serving_dispatch_mode",
                                              mode="shm")
        # pscheck: disable=PS201 (failure-path counter; a racing increment can only undercount telemetry)
        self.dropped_sends = 0      # frames lost to dead connections
        # connections whose HELLO carried the aggregator-role byte
        self._agg_conns: set[socket.socket] = set()
        # guarded-by: _lock (HELLO writes hold the state lock; stats reads are int snapshots)
        self.aggregators = 0        # relay HELLOs registered
        # the first non-connection exception of a reader
        self.reader_error: Exception | None = None
        self._hb_interval = heartbeat_interval
        self._hb_timeout = heartbeat_timeout
        # guarded-by: _lock (accept loop swaps the list under the state lock; close() joins after the listener is down)
        self._reader_threads: list[threading.Thread] = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="kps-net-accept")
        self._accept_thread.start()
        self._hb_thread = None
        if heartbeat_interval:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True,
                name="kps-net-heartbeat")
            self._hb_thread.start()

    # -- fabric integration ------------------------------------------------

    def wrap(self, fabric: fabric_mod.Fabric) -> fabric_mod.Fabric:
        bridge = self

        # subclass the wrapped fabric's OWN class, not the base Fabric:
        # a wrapped log.durable_fabric.DurableFabric keeps its
        # append-before-enqueue send and its recover/commit surface
        class BridgedFabric(type(fabric)):
            def send(self, topic, key, message):
                conn = bridge._conn_of.get(key) \
                    if topic == fabric_mod.WEIGHTS_TOPIC else None
                if conn is None:
                    super().send(topic, key, message)
                    return
                if not self.durable:
                    bridge._send(conn, T_WEIGHTS, key, message)
                    return
                # logged for read replicas (serving/replica.py) and
                # consumed at once: the socket delivers it, and a
                # restarted server re-sends current weights itself.  The
                # JAX bridge logs none of these (ROADMAP C.14).  The log's
                # frame is the socket's payload, encoded once
                t0 = time.perf_counter()
                frame = self._frame(topic, message)
                bridge._serde(T_WEIGHTS, t0)
                self.mark_consumed(topic, key,
                                   self.append_frame(topic, key, frame))
                bridge._send(conn, T_WEIGHTS, key, message, payload=frame)

        out = object.__new__(BridgedFabric)
        # share ALL state with the original (queues, cond, and any
        # subclass state) so pre-wrap queues stay visible
        out.__dict__ = fabric.__dict__
        self._fabric = out
        return out

    def attach_serving(self, engine) -> None:
        """The JAX bridge's way to set `engine` after the listener starts,
        kept so that code written for it runs here; the port's entry points
        pass `engine=` to the constructor."""
        self._serving = engine

    def send_data(self, worker: int, features: dict[int, float],
                  label: int) -> bool:
        """Forward one stream row to the process hosting `worker`.
        False if that worker is not (yet) connected or its connection
        just died — the caller reroutes or counts the row."""
        conn = self._conn_of.get(worker)
        if conn is None:
            return False
        return self._send(conn, T_DATA, worker, LabeledData(features, label))

    def send_data_batch(self, worker: int, rows) -> bool:
        """Forward N stream rows to the process hosting `worker` in ONE
        columnar frame (serde.encode_labeled_rows), decoded straight into
        SlidingBuffer.add_many.  `rows` is a sequence of (features,
        label); False exactly like send_data (the caller reroutes)."""
        conn = self._conn_of.get(worker)
        if conn is None:
            return False
        t0 = time.perf_counter()
        payload = serde.encode_labeled_rows(rows)
        self._serde(T_DATA_BATCH, t0)
        return self._send_raw(conn, T_DATA_BATCH, worker, payload)

    def send_weights_group(self, release, builder) -> set:
        """Grouped weights fan-out (ServerNode.weights_group_send): ONE
        T_WEIGHTS_AGG frame per relay connection for the members of
        `release` behind it.  `builder(clock)` makes the WeightsMessage
        (once per relay, at its first member's clock).  Returns the
        worker ids shipped; members on plain connections are left to
        the caller."""
        groups: dict[socket.socket, list] = {}
        for worker, clock in release:
            conn = self._conn_of.get(worker)
            if conn is not None and conn in self._agg_conns:
                groups.setdefault(conn, []).append((worker, clock))
        handled: set = set()
        fab = self._fabric
        for conn, members in groups.items():
            msg = builder(members[0][1])
            if fab is not None and fab.durable:
                # logged for read replicas like BridgedFabric.send's
                # weights, once per frame: the newest member's clock under
                # its key, the record a replica would pick of theirs
                worker, clock = max(members, key=lambda m: m[1])
                fab.mark_consumed(fabric_mod.WEIGHTS_TOPIC, worker,
                                  fab.persist(fabric_mod.WEIGHTS_TOPIC,
                                              worker, dataclasses.replace(
                                                  msg, vector_clock=clock)))
            if (msg.encoded is not None
                    and self._codec_of.get(conn, CODEC_SPEC_NONE).codec_id
                    == CODEC_NONE):
                # _send's rule: a none-negotiated relay gets the decoded
                # float32 body its members train on
                msg = dataclasses.replace(msg, encoded=None)
            payload = b"".join(
                [struct.pack("<q", len(members))]
                + [_AGG_MEMBER.pack(w, c) for w, c in members]
                + [self._encode(T_WEIGHTS_AGG, msg)])
            if self._send_raw(conn, T_WEIGHTS_AGG, 0, payload):
                handled.update(w for w, _ in members)
        return handled

    def send_goodbye(self) -> None:
        """The end of the run, to every live connection (T_CONFIG with
        GOODBYE_RUN_ID): a relay's last act before it closes, so its
        members stop instead of waiting for a restart."""
        payload = struct.pack("<dq", self._hb_interval or 0.0,
                              GOODBYE_RUN_ID)
        for conn in list(self._send_lock):
            self._send_raw(conn, T_CONFIG, 0, payload)

    def forward_frame(self, topic: int, worker: int,
                      payload: bytes) -> bool:
        """A pre-serialized frame to the connection owning `worker` (a
        relay's downstream re-broadcast): the bytes cross without a
        decode and encode.  False when the worker has no connection."""
        conn = self._conn_of.get(worker)
        if conn is None:
            return False
        if topic == T_WEIGHTS and self._trace_of.get(conn):
            # a fresh flow per member: the member's reader strips a
            # suffix from every weights frame, and the upstream hop's
            # suffix never crossed the relay
            payload = self._traced(payload, "weights", worker)
        return self._send_raw(conn, topic, worker, payload)

    def wait_for_connected(self, workers, timeout: float = 60.0) -> None:
        """Block until every worker id has a connection (HELLO seen) —
        before this the producer has nowhere to send their rows."""
        with self._cv:
            ok = self._cv.wait_for(
                lambda: all(w in self._conn_of for w in workers),
                timeout=timeout)
        if not ok:
            missing = [w for w in workers if w not in self._conn_of]
            raise TimeoutError(f"workers {missing} not connected in time")

    def wait_for_no_connections(self, timeout: float) -> bool:
        """Block until no worker id has a connection (every peer hung
        up), at most `timeout` seconds; True when none is left."""
        with self._cv:
            return self._cv.wait_for(lambda: not self._conn_of,
                                     timeout=timeout)

    def wait_for_workers(self, workers, timeout: float = 60.0) -> None:
        """Block until every worker id has reported READY (its buffer
        holds data) — the invariant behind the reference's fixed 20 s
        bootstrap sleep."""
        with self._cv:
            ok = self._cv.wait_for(
                lambda: all(w in self._ready for w in workers),
                timeout=timeout)
        if not ok:
            missing = [w for w in workers if w not in self._ready]
            raise TimeoutError(f"workers {missing} not ready in time")

    def stats(self) -> dict:
        return {"wire": self.wire_stats(), "dropped_sends":
                self.dropped_sends, "writers": _writer_stats(self._writers),
                "aggregators": self.aggregators,
                "shm_predictions": self.shm_predictions}

    def close(self) -> None:
        self._stop.set()
        # shutdown BEFORE close: closing the fd does not wake a thread
        # blocked in accept(), and the in-flight syscall would pin the
        # port in LISTEN (a restart on it would fail EADDRINUSE)
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        # join the accept loop FIRST: no reader may be spawned after the
        # sweep below
        if self._accept_thread is not threading.current_thread():
            self._accept_thread.join(timeout=10.0)
        # flush-before-close: writers drain their queues first, then the
        # sockets go down
        for writer in list(self._writer_of.values()):
            writer.close(flush=True)
        # every live connection, including ones that never sent HELLO
        for conn in list(self._send_lock):
            force_close(conn)        # wakes the blocked reader thread
        # shm channels whose connection cleanup has not run yet: close
        # and unlink (this side owns the segments), then join their
        # serve threads
        for chan in list(self._shm_of.values()):
            chan.close()
        for t in list(self._shm_threads):
            if t is not threading.current_thread():
                t.join(timeout=10.0)
        # readers hand gradients into the fabric (device tensors): join
        # every thread before returning
        for t in (*self._reader_threads, self._hb_thread):
            if t is not None and t is not threading.current_thread():
                t.join(timeout=10.0)

    # -- internals ---------------------------------------------------------

    def _send(self, conn, topic, key, message=None,
              payload: bytes | None = None) -> bool:
        """False (never raises) when the connection is gone: the message
        is dropped, like a Kafka send to a dead consumer — the reader's
        disconnect cleanup drives the actual eviction, so a send from
        inside the consistency gate can't crash the server.  `payload`,
        when given, is `message` already encoded (a durable fabric's log
        frame), sent as is unless the peer needs the decoded values."""
        if (message is not None
                and getattr(message, "encoded", None) is not None
                and self._codec_of.get(conn,
                                       CODEC_SPEC_NONE).codec_id
                == CODEC_NONE):
            # this peer negotiated no compression: ship the decoded
            # values as a plain f32 frame — they ARE the values every
            # compressed peer decodes to, so a mixed fleet stays
            # consistent
            message = dataclasses.replace(message, encoded=None)
            payload = None
        if payload is None:
            payload = (self._encode(topic, message) if message is not None
                       else b"")
        if topic == T_WEIGHTS and self._trace_of.get(conn):
            # open the weights flow: an arrow from this send to the
            # worker's net.recv (its reader strips the suffix)
            payload = self._traced(payload, "weights", key)
        return self._send_raw(conn, topic, key, payload)

    def _dropped(self, count: bool) -> None:
        with self._wire_lock:
            self.dropped_sends += count

    def _send_raw(self, conn, topic, key, payload: bytes) -> bool:
        # `dropped_sends` is a data-loss diagnostic: a control frame
        # (PING/CONFIG) hitting a dying connection is not lost training
        # data, and neither is a prediction reply to a vanished client
        count = topic not in (T_PING, T_CONFIG, T_PREDICTION)
        writer = self._writer_of.get(conn)
        if writer is not None:
            # coalesced path: enqueue and return (the counters below run
            # at enqueue time, so both paths count the same).  PINGs are
            # advisory: regenerated next interval, so a full queue drops
            # them instead of blocking the heartbeat thread
            if not writer.send(topic, key, payload,
                               advisory=topic == T_PING):
                self._dropped(count)
                if writer.dead:
                    force_close(conn)   # reader wakes -> cleanup/eviction
                return False
        else:
            lock = self._send_lock.get(conn)
            if lock is None:
                self._dropped(count)
                return False
            try:
                locked_send(conn, lock, topic, key, payload)
            except (ConnectionError, OSError):
                self._dropped(count)
                force_close(conn)   # wake the reader -> cleanup/eviction
                return False
        self._count("out", topic, len(payload))
        self._family(self._m_sent, topic, len(payload))
        if FLIGHT.enabled and topic in (T_WEIGHTS, T_GRADIENTS):
            # the data-plane topics only: a PING every second would
            # evict the telling events from a quiet ring
            FLIGHT.record("net.send", topic=TOPIC_NAMES[topic], peer=key,
                          bytes=len(payload))
        return True

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return
            if self._stop.is_set():
                # raced close(): this connection must not outlive it
                force_close(conn)
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._cv:
                self._send_lock[conn] = OrderedLock("ServerBridge.send")
                if self._coalesce:
                    writer = FrameWriter(conn, telemetry=self._telemetry)
                    self._writer_of[conn] = writer
                    self._writers.append(writer)
                self._last_recv[conn] = time.monotonic()
            t = threading.Thread(target=self._reader, args=(conn,),
                                 daemon=True, name="kps-net-reader")
            t.start()
            # prune finished readers so worker churn over a long
            # rebalance run doesn't accumulate dead Thread objects
            with self._cv:
                self._reader_threads = [r for r in self._reader_threads
                                        if r.is_alive()] + [t]

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self._hb_interval):
            now = time.monotonic()
            for conn in list(self._send_lock):
                silent = now - self._last_recv.get(conn, now)
                if (self._hb_timeout is not None
                        and silent > self._hb_timeout):
                    # half-open: no FIN will ever come; force the
                    # reader's recv to fail so cleanup runs
                    force_close(conn)
                    continue
                self._send(conn, T_PING, 0)

    def _hello(self, conn, payload) -> None:
        """Negotiate, answer T_CONFIG and register the HELLO's worker
        ids (a relay's: its members)."""
        (n,) = struct.unpack_from("<q", payload, 0)
        ids = struct.unpack_from(f"<{n}q", payload, 8)
        off = 8 + 8 * n
        if _read_flag(_AGG_TRAILER, payload, off + _CODEC_TRAILER.size
                      + _TRACE_TRAILER.size + _SHM_TRAILER.size):
            with self._cv:
                self._agg_conns.add(conn)
                self.aggregators += 1
        # negotiation: use our codec iff the peer asked for the SAME one
        # (old peers send no trailer -> NONE)
        peer = _read_codec_trailer(payload, off)
        negotiated = self.codec if peer == self.codec else CODEC_SPEC_NONE
        # trace: on iff the peer offered and our tracer is on
        trace_on = (_read_flag(_TRACE_TRAILER, payload,
                               off + _CODEC_TRAILER.size)
                    and self._tracer.enabled)
        with self._cv:
            # the results land under the state lock BEFORE T_CONFIG goes
            # out: once the peer sees CONFIG it may send coded (and
            # traced) frames
            self._codec_of[conn] = negotiated
            self._trace_of[conn] = trace_on
        # shm: the offer rides CONFIG only when the peer asked, so worker
        # handshakes stay byte-identical; declined without an engine
        shm_tail = b""
        if _read_flag(_SHM_TRAILER, payload, off + _CODEC_TRAILER.size
                      + _TRACE_TRAILER.size):
            chan = self._offer_shm(conn)
            shm_tail = (_SHM_OFFER.pack(0, b"", b"") if chan is None else
                        _SHM_OFFER.pack(
                            1, chan.nonce,
                            # pscheck: disable=PS103 (segment name is a fresh control string, not message parts)
                            chan.name.encode("ascii")))
        # T_CONFIG goes out BEFORE the ids are registered: once
        # registered, the producer thread may race data rows onto this
        # connection, and the worker-side handshake relies on T_CONFIG
        # being the first non-PING frame.  Payload: PING cadence (0.0 =
        # no heartbeats) + the run id + the negotiated codec + the trace
        # answer
        self._send_raw(conn, T_CONFIG, 0,
                       struct.pack("<dq", self._hb_interval or 0.0,
                                   self.run_id)
                       + _CODEC_TRAILER.pack(negotiated.codec_id,
                                             negotiated.param)
                       + _TRACE_TRAILER.pack(int(trace_on)) + shm_tail)
        with self._cv:
            for w in ids:
                self._conn_of[w] = conn
            self._cv.notify_all()
        if FLIGHT.enabled:
            FLIGHT.record("net.hello", workers=list(ids))
        if self.on_hello is not None:
            self.on_hello(list(ids))

    def _reader(self, conn: socket.socket) -> None:
        # buffered receive (wire.RecvBuffer): one recv_into brings in
        # every frame the kernel has ready
        rbuf = RecvBuffer(conn)
        disconnect = True
        try:
            while not self._stop.is_set():
                frame = rbuf.recv_frame()
                if frame is None:
                    break
                self._last_recv[conn] = time.monotonic()
                topic, key, payload = frame
                self._count("in", topic, len(payload))
                self._family(self._m_recv, topic, len(payload))
                if topic == T_HELLO:
                    self._hello(conn, payload)
                elif topic == T_READY:
                    with self._cv:
                        self._ready.add(key)
                        self._cv.notify_all()
                    if self.on_ready is not None:
                        self.on_ready(key)
                elif topic == T_PONG:
                    pass            # liveness already stamped above
                elif topic == T_GRADIENTS and self._fabric is not None:
                    self._gradients(conn, key, payload)
                elif topic == T_PREDICT:
                    self._handle_predict(conn, key, payload)
        except (ConnectionError, OSError):
            pass
        except Exception as e:
            # not a disconnect (module docstring): keep it for the main
            # loop, evict nobody
            disconnect = False
            with self._cv:
                if self.reader_error is None:
                    self.reader_error = e
        finally:
            self._cleanup_conn(conn, disconnect)

    def _gradients(self, conn, key: int, payload) -> None:
        """One GRADIENTS frame into the fabric.  On a traced connection
        the suffix is stripped BEFORE the decode (a compressed frame hands
        its whole tail to unpack_parts) and the delta's flow steps here;
        its id rides on the message as `trace` (a dynamic attribute of
        the frozen dataclass, as in the JAX bridge)."""
        fid = None
        if self._trace_of.get(conn):
            payload, fid = _strip_trace(payload)
        msg = self._decode(T_GRADIENTS, payload)
        if FLIGHT.enabled:
            FLIGHT.record("net.recv", topic="gradients",
                          worker=getattr(msg, "worker_id", key),
                          clock=getattr(msg, "vector_clock", -1))
        if fid is not None:
            with self._tracer.span("net.recv", topic="gradients"):
                self._tracer.flow_step("delta.wire", fid)
            object.__setattr__(msg, "trace", fid)
        self._fabric.send(fabric_mod.GRADIENTS_TOPIC, 0, msg)

    def _handle_predict(self, conn, key: int, payload) -> None:
        """One PREDICT frame: submitted to the engine, answered from its
        callback; PREDICT_FAILED without an engine (an explicit failure
        beats a silent hang on the client) or for a malformed frame,
        PREDICT_OVERLOADED at once for an admission shed."""
        engine = self._serving
        if engine is None:
            self._send_raw(conn, T_PREDICTION, key,
                           encode_prediction(PREDICT_FAILED))
            return
        try:
            x, min_clock, max_age_s, model_id = \
                decode_predict_request(payload)
            bound = ReadBound(min_clock=min_clock, max_age_s=max_age_s)
        except (struct.error, ValueError):      # a malformed frame
            self._send_raw(conn, T_PREDICTION, key,
                           encode_prediction(PREDICT_FAILED))
            return

        def reply(result, conn=conn, key=key):
            self._send_raw(conn, T_PREDICTION, key, _encode_result(result))

        try:
            engine.submit(x, bound, reply, model_id=model_id)
        except OverloadedError:
            # the shed is synchronous: answered now, nothing was queued
            self._send_raw(conn, T_PREDICTION, key,
                           encode_prediction(PREDICT_OVERLOADED))
        except (ValueError, RuntimeError):
            # an unknown model id, or the engine closed (shutdown race)
            self._send_raw(conn, T_PREDICTION, key,
                           encode_prediction(PREDICT_FAILED))

    def _offer_shm(self, conn):
        """A shm channel and its serve thread for `conn`; None (the
        declined offer) when shm is off here, no engine is attached or
        the segment cannot be made (e.g. /dev/shm full)."""
        if not self._shm_enabled or self._serving is None:
            return None
        try:
            chan = ShmChannel.create()
        except OSError:
            return None
        t = threading.Thread(target=self._shm_serve, args=(chan,),
                             daemon=True, name="kps-shm-serve")
        with self._cv:
            self._shm_of[conn] = chan
            self._shm_threads.append(t)
        t.start()
        return chan

    def _shm_serve(self, chan) -> None:
        """One channel's poll loop: pop the pending request, submit it to
        the engine asynchronously (as the socket path does), publish the
        reply from the engine's callback.  Depth 1: an unanswered request
        holds back exactly one client."""
        engine = self._serving
        while not self._stop.is_set() and not chan.closed:
            got = chan.serve_once()
            if got is None:
                time.sleep(0.0002)
                continue
            seq, raw = got
            try:
                x, min_clock, max_age_s, model_id = \
                    decode_predict_request(raw)
                bound = ReadBound(min_clock=min_clock, max_age_s=max_age_s)
            except (struct.error, ValueError):  # a malformed payload
                chan.respond(seq, encode_prediction(PREDICT_FAILED))
                continue

            def reply(result, seq=seq):
                chan.respond(seq, _encode_result(result))
                with self._wire_lock:
                    self.shm_predictions += 1
                self._m_shm.inc()
                if FLIGHT.enabled:
                    FLIGHT.record("serving.batch", n=1, mode="shm")

            try:
                engine.submit(x, bound, reply, model_id=model_id)
            except OverloadedError as err:
                reply(err)
            except (ValueError, RuntimeError) as err:
                reply(err)

    def _cleanup_conn(self, conn: socket.socket, notify: bool) -> None:
        """Purge a dead connection's registrations and, for a disconnect
        (`notify`), surface it — without this the consistency gate waits
        forever for a dead worker's gradients."""
        try:
            conn.close()
        except OSError:
            pass
        writer = self._writer_of.pop(conn, None)
        if writer is not None:
            # the connection is dead — discard the queue, don't flush
            writer.close(flush=False, timeout=2.0)
        with self._cv:
            ids = [w for w, c in self._conn_of.items() if c is conn]
            for w in ids:
                del self._conn_of[w]
                self._ready.discard(w)
            was_agg = conn in self._agg_conns
            self._agg_conns.discard(conn)
            self._send_lock.pop(conn, None)
            self._last_recv.pop(conn, None)
            self._codec_of.pop(conn, None)
            self._trace_of.pop(conn, None)
            chan = self._shm_of.pop(conn, None)
            self._cv.notify_all()
        if chan is not None:
            chan.close()    # ends the connection's shm serve thread
        if FLIGHT.enabled and ids:
            FLIGHT.record("net.disconnect", workers=ids, agg=was_agg)
        # a relay's disconnect is a relay restart, not its members'
        # failure: they resend through the next relay, which re-HELLOs
        if (notify and ids and not was_agg and not self._stop.is_set()
                and self.on_disconnect is not None):
            self.on_disconnect(ids)


class WorkerBridge(_Counters):
    """Worker-process side: connects to the server, registers its
    logical worker ids, feeds received INPUT_DATA rows into the local
    buffers, delivers received WEIGHTS into the local fabric, and routes
    the workers' GRADIENTS sends back over the socket."""

    def __init__(self, host: str, port: int, worker_ids: list[int],
                 connect_timeout: float = 30.0,
                 heartbeat_timeout: float | None = None,
                 codec: CodecSpec | None = None,
                 coalesce: bool = True, device=None,
                 aggregator: bool = False, tracer=None, telemetry=None):
        """`heartbeat_timeout`: seconds of total server silence before
        the connection is declared dead (only sensible when the server
        PINGs; the advertised cadence floors or disables it).
        `codec`: this worker process's `--compress` choice, offered on
        HELLO; `self.negotiated` holds what the server agreed to — the
        caller builds its gradient compressors from THAT, not the flag.
        `coalesce`: queue outgoing frames behind a wire.FrameWriter;
        False is the locked-sendall-per-frame path.  `device`: where
        decoded weights land (the worker process's).  `aggregator`:
        HELLO as a relay for `worker_ids` (module docstring).  `tracer`:
        the offering tracer — when it is on and the server answers the
        offer, `trace_negotiated` goes True and WEIGHTS / GRADIENTS
        frames carry the trace suffix."""
        self._wire_lock = OrderedLock("WorkerBridge.wire")
        super().__init__(tracer, telemetry)
        self.device = resolve_device(device)
        self.worker_ids = list(worker_ids)
        self.aggregator = bool(aggregator)
        # a relay's hook: run_reader hands it rows and weights frames as
        # bytes before any decode; True consumes the frame
        self.raw_forward = None
        self._heartbeat_timeout = heartbeat_timeout
        self.codec = codec if codec is not None else CODEC_SPEC_NONE
        self.negotiated = CODEC_SPEC_NONE
        self.trace_negotiated = False
        # retry: the server process may still be importing/binding when
        # this process is already up (both launched together)
        deadline = time.monotonic() + connect_timeout
        while True:
            try:
                self._sock = socket.create_connection((host, port),
                                                      timeout=5.0)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._send_lock = OrderedLock("WorkerBridge.send")
        self._stop = threading.Event()
        self.disconnected = threading.Event()
        # set by a mid-stream GOODBYE config: the run ended cleanly
        # pscheck: disable=PS201 (monotonic bool set by the reader thread; pollers tolerate one stale read)
        self.run_over = False
        # the first non-connection exception of run_reader
        # pscheck: disable=PS201 (set once by the reader thread just before it sets `disconnected`; read after that event)
        self.reader_error: Exception | None = None
        self.server_run_id: int | None = None
        # pscheck: disable=PS201 (make_fabric publishes before run_reader starts - the handshake orders it)
        self.fabric: fabric_mod.Fabric | None = None
        # HELLO: ids + codec offer + trace offer (1 iff our tracer is on)
        payload = (struct.pack(f"<q{len(self.worker_ids)}q",
                               len(self.worker_ids), *self.worker_ids)
                   + _CODEC_TRAILER.pack(self.codec.codec_id,
                                         self.codec.param)
                   + _TRACE_TRAILER.pack(int(self._tracer.enabled)))
        if self.aggregator:
            # trailers are positional: a not-requesting-shm byte, then
            # the aggregator-role byte
            payload += _SHM_TRAILER.pack(0) + _AGG_TRAILER.pack(1)
        locked_send(self._sock, self._send_lock, T_HELLO, 0, payload)
        self._count("out", T_HELLO, len(payload))
        # synchronous handshake: the server replies T_CONFIG before it
        # registers our ids, so it is the first non-PING frame on the
        # wire — read it HERE, before any reader thread exists, so
        # callers know the server's run id and ping cadence before
        # deciding what local state to restore
        self._sock.settimeout(10.0)
        try:
            while True:
                frame = recv_frame(self._sock)
                if frame is None:
                    raise ConnectionError("server closed during handshake")
                topic, _key, pl = frame
                self._count("in", topic, len(pl))
                if topic == T_PING:
                    locked_send(self._sock, self._send_lock, T_PONG, 0)
                    self._count("out", T_PONG, 0)
                    continue
                if topic == T_CONFIG:
                    interval, run_id = struct.unpack_from("<dq", pl, 0)
                    self.server_run_id = int(run_id)
                    # a 16-byte CONFIG is an old server: no negotiation,
                    # stay uncompressed
                    self.negotiated = _read_codec_trailer(pl, 16)
                    # the trace answer after the codec trailer; an older
                    # server never sends it: no suffix either way
                    self.trace_negotiated = _read_flag(
                        _TRACE_TRAILER, pl, 16 + _CODEC_TRAILER.size)
                    break
                raise ConnectionError(
                    f"expected T_CONFIG during handshake, got topic {topic}")
        except socket.timeout as e:
            raise ConnectionError("no T_CONFIG from server") from e
        # steady state: the configured read timeout (a half-open server
        # link then surfaces as socket.timeout in the read loop), or
        # blocking forever when none was requested; the advertised
        # cadence may floor or disable it
        self._sock.settimeout(heartbeat_timeout)
        self._apply_server_ping_interval(interval)
        # the coalescing writer starts AFTER the synchronous handshake:
        # HELLO went out on the locked path above and nothing else can
        # have been queued yet, so frame order is preserved
        self._writer = (FrameWriter(self._sock, telemetry=self._telemetry)
                        if coalesce else None)

    def _enqueue(self, topic: int, key: int, payload: bytes = b"",
                 advisory: bool = False) -> None:
        """Send one frame via the coalescing writer when enabled, the
        locked direct path otherwise.  A failed protocol enqueue (dead
        writer, or the backpressure deadline expired) raises
        ConnectionError — the failure surface locked_send has."""
        if self._writer is not None:
            if not self._writer.send(topic, key, payload,
                                     advisory=advisory):
                if not advisory:
                    raise ConnectionError("wire writer closed")
                return
        else:
            locked_send(self._sock, self._send_lock, topic, key, payload)
        self._count("out", topic, len(payload))

    def send_gradients(self, key: int, message) -> None:
        """Serialize one gradient message (full-range, or a shard's
        slice) and send it on this bridge's socket (make_fabric's
        GRADIENTS route, or a ShardRouter's per-shard send).  On a traced
        connection each message opens its own `delta.wire` flow."""
        self._send_gradients(key, self._encode(T_GRADIENTS, message),
                             getattr(message, "worker_id", key),
                             clock=getattr(message, "vector_clock", -1))

    def send_payload(self, key: int, payload: bytes) -> None:
        """One pre-serialized GRADIENTS frame (a relay's composite,
        serialized once)."""
        self._send_gradients(key, payload, key)

    def _send_gradients(self, key: int, payload, worker: int,
                        **record) -> None:
        """A GRADIENTS frame with its trace suffix on a traced connection
        (the server strips 16 bytes from every gradients frame there),
        counted and recorded."""
        if self.trace_negotiated:
            payload = self._traced(payload, "gradients", worker)
        self._enqueue(T_GRADIENTS, key, payload)
        self._family(self._m_sent, T_GRADIENTS, len(payload))
        if FLIGHT.enabled:
            FLIGHT.record("net.send", topic="gradients", worker=worker,
                          **record, bytes=len(payload))

    def set_weights_sink(self, sink) -> None:
        """Deliver received WEIGHTS into `sink.send(topic, key, msg)`
        instead of a make_fabric() fabric (a sharded worker's per-shard
        feed of the weights assembler)."""
        self.fabric = sink

    def make_fabric(self) -> fabric_mod.Fabric:
        """Local fabric whose GRADIENTS sends cross the socket (the
        worker's view of the broker)."""
        bridge = self

        class BridgedFabric(fabric_mod.Fabric):
            def send(self, topic, key, message):
                if topic == fabric_mod.GRADIENTS_TOPIC:
                    bridge.send_gradients(key, message)
                else:
                    super().send(topic, key, message)

        self.fabric = BridgedFabric()
        return self.fabric

    def _apply_server_ping_interval(self, interval: float) -> None:
        """React to the server's advertised PING cadence (T_CONFIG).  A
        timeout below a few pings would false-declare a healthy server
        dead, so the effective read timeout is floored at 3 pings, and
        disabled entirely when the server does not ping at all."""
        if self._heartbeat_timeout is None:
            return
        if interval <= 0.0:
            print(f"warning: server sends no heartbeats; ignoring "
                  f"heartbeat_timeout={self._heartbeat_timeout}s",
                  file=sys.stderr, flush=True)
            self._sock.settimeout(None)
            return
        floor = 3.0 * interval
        effective = self._heartbeat_timeout
        if effective < floor:
            print(f"warning: heartbeat_timeout={effective}s is under 3x "
                  f"the server ping interval ({interval}s); using "
                  f"{floor}s", file=sys.stderr, flush=True)
            effective = floor
        self._sock.settimeout(effective)

    def mark_ready(self, worker: int) -> None:
        self._enqueue(T_READY, worker)

    def stats(self) -> dict:
        return {"wire": self.wire_stats(), "writers": _writer_stats(
            [] if self._writer is None else [self._writer])}

    def run_reader(self, buffers: dict[int, object]) -> None:
        """Blocking read loop (call on a dedicated thread): dispatches
        INPUT_DATA to `buffers[worker].add` (batched frames to
        `.add_many`) and WEIGHTS into the local fabric (make_fabric
        first).  Returns on EOF (server done); keeps any exception other
        than a connection error in `reader_error` (module docstring)."""
        rbuf = RecvBuffer(self._sock)
        try:
            while not self._stop.is_set():
                frame = rbuf.recv_frame()
                if frame is None:
                    break
                topic, key, payload = frame
                self._count("in", topic, len(payload))
                self._family(self._m_recv, topic, len(payload))
                fid = None
                if topic == T_WEIGHTS and self.trace_negotiated:
                    payload, fid = _strip_trace(payload)
                if topic == T_PING:
                    # a PONG is liveness, regenerated on the next PING:
                    # advisory — never blocks the reader on backpressure
                    self._enqueue(T_PONG, 0, advisory=True)
                elif topic == T_CONFIG:
                    # normally consumed by the handshake; a re-sent
                    # config mid-stream updates the ping cadence, except
                    # the GOODBYE sentinel announcing a clean end-of-run
                    (interval, rid) = struct.unpack_from("<dq", payload, 0)
                    if rid == GOODBYE_RUN_ID:
                        self.run_over = True
                    else:
                        self._apply_server_ping_interval(interval)
                elif (self.raw_forward is not None
                        and topic in (T_DATA, T_DATA_BATCH, T_WEIGHTS,
                                      T_WEIGHTS_AGG)
                        and self.raw_forward(topic, key, bytes(payload))):
                    # a relay passed the bytes on; the suffix stripped
                    # above was this hop's (forward_frame opens a fresh
                    # flow per member downstream)
                    if fid is not None:
                        self._weights_flow_end(fid, key)
                elif topic == T_DATA_BATCH:
                    buffers[key].add_many(self._decode_rows(payload))
                elif topic == T_DATA:
                    msg = self._decode(T_DATA, payload)
                    buffers[key].add(msg.features, msg.label)
                elif topic == T_WEIGHTS:
                    msg = self._decode(T_WEIGHTS, payload)
                    if FLIGHT.enabled:
                        FLIGHT.record(
                            "net.weights_recv", worker=key,
                            clock=getattr(msg, "vector_clock", -1))
                    if fid is not None:
                        self._weights_flow_end(fid, key)
                        object.__setattr__(msg, "trace", fid)
                    self.fabric.send(fabric_mod.WEIGHTS_TOPIC, key, msg)
                else:
                    raise ValueError(
                        f"unexpected frame topic {topic} "
                        f"({TOPIC_NAMES.get(topic, 'unknown')}) on a "
                        "worker connection")
        except (ConnectionError, OSError):
            pass
        except Exception as e:
            self.reader_error = e
        finally:
            self.disconnected.set()

    def _weights_flow_end(self, fid: int, worker: int) -> None:
        """Close a weights flow on the receiving `net.recv` span."""
        with self._tracer.span("net.recv", topic="weights", worker=worker):
            self._tracer.flow_end("weights.wire", fid)

    def _decode_rows(self, payload) -> list:
        """A T_DATA_BATCH body: columnar (serde.encode_labeled_rows), or
        the legacy per-row <i32 len><serde blob> layout of an older
        server."""
        t0 = time.perf_counter()
        (nrows,) = struct.unpack_from("<q", payload, 0)
        if nrows < 0:
            rows = serde.decode_labeled_rows(payload)
        else:
            off = 8
            rows = []
            for _ in range(nrows):
                # pscheck: disable=PS204 (legacy framing: old servers length-prefixed each row with an i32; the current encoder is columnar and never packs this)
                (blen,) = struct.unpack_from("<i", payload, off)
                off += 4
                row = serde.from_bytes(payload[off:off + blen],
                                       device=self.device)
                off += blen
                rows.append((row.features, row.label))
        self._serde(T_DATA_BATCH, t0)
        return rows

    def close(self) -> None:
        self._stop.set()
        if self._writer is not None:
            # flush-before-close: queued frames (a final gradient, a
            # READY) reach the wire before the socket goes down
            self._writer.close(flush=True)
        # shutdown + close: wakes a reader still blocked in recv (a
        # worker loop's failure closes the bridge under it)
        force_close(self._sock)


class PredictClient:
    """A prediction client of the serving plane.

    Not a worker: it sends no HELLO (unless it asks for shared memory,
    with an empty id list), registers no worker ids and so never receives
    weights or data frames; the connection carries PREDICT/PREDICTION and
    the server's PINGs, answered here.  Synchronous: one outstanding
    request per client; run several clients for concurrency.

    `shm=True` asks the server for a shared-memory channel
    (serving/shm.py) and uses it while it lasts; any failure to set it up
    or a channel dying between requests falls back to the socket, which
    the caller never sees.  `reconnect=True` survives a dropped server
    connection: the client re-dials with exponential backoff up to
    `reconnect_timeout` seconds and replays the in-flight request.  A
    STALE or OVERLOADED reply comes from a healthy connection and never
    re-dials."""

    def __init__(self, host: str, port: int, timeout: float = 30.0, *,
                 reconnect: bool = False, reconnect_timeout: float = 10.0,
                 model_id: int = 0, shm: bool = False):
        self._host, self._port = host, port
        self._timeout = timeout
        self._reconnect = reconnect
        self._reconnect_timeout = reconnect_timeout
        self._model_id = int(model_id)
        self._send_lock = OrderedLock("PredictClient.send")
        self._req = 0
        self._closed = False
        self.reconnects = 0          # successful re-dials
        self._shm = bool(shm)
        self._chan = None            # the ShmChannel once negotiated
        self._sock = self._dial()
        if self._shm:
            self._chan = self._negotiate_shm()

    def _dial(self) -> socket.socket:
        sock = socket.create_connection((self._host, self._port),
                                        timeout=5.0)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(self._timeout)
        return sock

    def _negotiate_shm(self):
        """Ask for a shared-memory channel: an empty-ids HELLO carrying
        the shm request, answered by a CONFIG whose offer names the
        segment.  Any failure (an older server, a declined offer, a
        remote peer whose segment does not exist here, a nonce mismatch)
        returns None and the client stays on its socket."""
        try:
            locked_send(self._sock, self._send_lock, T_HELLO, 0,
                        struct.pack("<q", 0)
                        + _CODEC_TRAILER.pack(CODEC_SPEC_NONE.codec_id,
                                              CODEC_SPEC_NONE.param)
                        + _TRACE_TRAILER.pack(0)
                        + _SHM_TRAILER.pack(1))
            while True:
                frame = recv_frame(self._sock)
                if frame is None:
                    return None
                topic, _key, payload = frame
                if topic == T_PING:
                    locked_send(self._sock, self._send_lock, T_PONG, 0)
                    continue
                if topic != T_CONFIG:
                    continue
                offer = _read_shm_offer(
                    payload, 16 + _CODEC_TRAILER.size + _TRACE_TRAILER.size)
                if offer is None:
                    return None
                name, nonce = offer
                return ShmChannel.attach(name, nonce)
        except (OSError, ShmError, struct.error):
            return None

    def _drop_chan(self) -> None:
        chan, self._chan = self._chan, None
        if chan is not None:
            chan.close()

    def _redial(self) -> None:
        """Replace the dead socket, backing off from 0.05 s doubling to 1 s
        until `reconnect_timeout` is spent."""
        force_close(self._sock)
        deadline = time.monotonic() + self._reconnect_timeout
        backoff = 0.05
        while not self._closed:
            try:
                self._sock = self._dial()
                self.reconnects += 1
                if self._shm:
                    # the old segment died with the old server process
                    self._drop_chan()
                    self._chan = self._negotiate_shm()
                return
            except OSError as err:
                if time.monotonic() + backoff > deadline:
                    raise ConnectionError(
                        f"serving endpoint {self._host}:{self._port} did "
                        f"not come back within {self._reconnect_timeout}s"
                    ) from err
                time.sleep(backoff)
                backoff = min(backoff * 2, 1.0)
        raise ConnectionError("client closed during reconnect")

    def predict(self, x, min_clock: int | None = None,
                max_age_s: float | None = None,
                model_id: int | None = None):
        """A serving.engine.Prediction (label, confidence, vector_clock,
        wall_time); raises serving.policy.StalenessError when the bound
        rejects and serving.policy.OverloadedError when the server shed
        the request (back off and retry)."""
        self._req += 1
        payload = encode_predict_request(
            x, min_clock, max_age_s,
            self._model_id if model_id is None else model_id)
        chan = self._chan
        if chan is not None:
            try:
                raw = chan.rpc(payload, timeout=self._timeout)
            except ShmError:
                # the channel died: fall through to the socket
                self._drop_chan()
            else:
                return self._decode_reply(raw, min_clock, max_age_s)
        while True:
            try:
                locked_send(self._sock, self._send_lock, T_PREDICT,
                            self._req, payload)
                return self._await_reply(min_clock, max_age_s)
            except (ConnectionError, OSError):
                if not self._reconnect or self._closed:
                    raise
                # a fresh socket holds no stale frames: replaying the
                # request id is unambiguous (a prediction is idempotent)
                self._redial()

    def _await_reply(self, min_clock, max_age_s):
        while True:
            frame = recv_frame(self._sock)
            if frame is None:
                raise ConnectionError(
                    "server closed before the prediction arrived")
            topic, key, payload = frame
            if topic == T_PING:
                locked_send(self._sock, self._send_lock, T_PONG, 0)
                continue
            if topic != T_PREDICTION or key != self._req:
                continue            # a stray control frame (a CONFIG)
            return self._decode_reply(payload, min_clock, max_age_s)

    def _decode_reply(self, payload, min_clock, max_age_s):
        """One PREDICTION payload (a socket frame or the shm response) as
        the caller's result: a Prediction, or the typed error."""
        status, label, conf, clock, wall = decode_prediction(payload)
        if status == PREDICT_STALE:
            raise StalenessError(
                f"server rejected the read bound (min_clock="
                f"{min_clock}, max_age_s={max_age_s})",
                min_clock=min_clock, max_age_s=max_age_s)
        if status == PREDICT_OVERLOADED:
            raise OverloadedError(
                "server shed the request (admission queue full)")
        if status != PREDICT_OK:
            raise RuntimeError("prediction failed on the server")
        return Prediction(label, conf, clock, wall)

    @property
    def shm_active(self) -> bool:
        """True while predict() rides the shared-memory channel."""
        return self._chan is not None

    def close(self) -> None:
        self._closed = True
        self._drop_chan()
        force_close(self._sock)
