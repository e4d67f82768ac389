"""Wire engine (counterpart of kafka_ps_tpu/runtime/wire.py, a copy):
coalesced scatter-gather sends and buffered receive for the socket
transport (runtime/net.py).

The frame format is net.py's; this module changes how frames cross the
syscall boundary:

* `FrameWriter` — a bounded per-connection send queue drained by a
  dedicated writer thread.  Producers append (header, payload) pairs
  under the queue lock and return; the writer pops every queued frame
  and ships the batch in ONE `socket.sendmsg([hdr1, payload1, hdr2,
  payload2, ...])` scatter-gather syscall.  The lock is held only for
  the append/pop, never across the kernel call, so a slow peer stalls
  the writer thread instead of every thread that sends.  Backpressure
  when the queue is full is explicit: protocol frames block with a
  deadline, advisory frames (PING/PONG liveness, regenerated every
  interval anyway) take a counted drop.  A frame larger than the queue's
  byte cap waits for an empty queue and then goes alone: it is neither
  dropped nor refused.
* `RecvBuffer` — a growable receive buffer filled with `recv_into` and
  parsed for ALL complete frames per chunk.  Payloads stay zero-copy
  memoryviews into the buffer; exhausted buffers are replaced (never
  compacted in place) so views handed to decode sites — np.frombuffer
  arrays alias them — stay immutable for as long as the decoded
  messages live.
* `sendmsg_all` — the partial-send-safe scatter-gather primitive, also
  the non-queued `send_frame` path's two-element header/payload send.

The byte content of the stream is identical to the sequential
`send_frame` path — same frames, same order per connection — so a
coalescing process interoperates bit for bit with a
`--no-wire-coalesce` one.

The queue lock is the port's lock-order recorder's `OrderedLock`
(`FrameWriter.queue`, analysis/lockgraph.py), under the JAX module's
name.

Telemetry (`telemetry=`, null by default), the JAX writer's:
`wire_frames_per_syscall` (histogram, per flush), `wire_send_queue_depth`
(gauge, bytes queued), `wire_advisory_dropped` (counter), and a
`net.flush` flight record per flush.  Beside them the writer keeps plain
integers, which the bridges' stats lines read: `flushes`,
`frames_flushed`, `syscalls`, `fps_counts` (flushes per `FPS_BUCKETS`
bucket of frames per syscall), `queued_bytes` and `advisory_dropped`.
"""

from __future__ import annotations

import bisect
import socket
import struct
import threading
from collections import deque

from kafka_ps_tpu_torch.analysis.lockgraph import OrderedLock
from kafka_ps_tpu_torch.telemetry import NULL_TELEMETRY
from kafka_ps_tpu_torch.telemetry.flight import FLIGHT

# the one frame header, shared with runtime/net.py (which re-exports
# it): <u32 length> <u8 topic> <i64 key>, length counting topic+key+payload
_FRAME = struct.Struct("<IBq")

# segments per sendmsg call: IOV_MAX is 1024 on Linux — stay safely
# under it (2 segments per frame) and split bigger batches across calls
_IOV_CAP = 512

# frames-per-syscall buckets (upper bounds): powers of two up to the
# best case of a full _IOV_CAP batch (256 two-segment frames in one call)
FPS_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)


def force_close(sock: socket.socket) -> None:
    """shutdown + close: a plain close() does NOT wake a thread blocked
    in recv() on the same socket; shutdown(SHUT_RDWR) delivers EOF to
    it first."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def sendmsg_all(sock: socket.socket, buffers) -> int:
    """Ship every bytes-like in `buffers`, in order, via scatter-gather
    `sendmsg` — partial sends resumed, batches capped at `_IOV_CAP`
    segments.  Returns the number of syscalls issued (the coalescing
    ratio's denominator).  Falls back to one `sendall` of the joined
    bytes on sockets without sendmsg (test doubles)."""
    views = [memoryview(b) for b in buffers if len(b)]
    if not views:
        return 0
    if not hasattr(sock, "sendmsg"):
        sock.sendall(b"".join(views))
        return 1
    syscalls = 0
    i, n = 0, len(views)
    while i < n:
        sent = sock.sendmsg(views[i:i + _IOV_CAP])
        syscalls += 1
        if sent <= 0:
            raise ConnectionError("socket closed mid-send")
        while i < n and sent >= len(views[i]):
            sent -= len(views[i])
            i += 1
        if sent:
            views[i] = views[i][sent:]
    return syscalls


class FrameWriter:
    """Bounded per-connection send queue + dedicated writer thread.

    `send()` appends one frame (header packed here) and returns True;
    the writer thread drains the queue in flush batches of at most
    `flush_budget` bytes / `_IOV_CAP` segments per `sendmsg`.  A send
    failure marks the writer dead, force-closes the socket (waking the
    connection's reader, whose cleanup drives eviction exactly as on
    the unqueued path), and drains the queue — every later `send`
    returns False, like a send to a dead connection.

    Backpressure (queue at `max_bytes`): protocol frames wait up to
    `send_deadline` seconds for space (False on expiry — the caller
    treats it as a dead connection); `advisory=True` frames drop
    immediately and count in `advisory_dropped`.  A protocol frame
    bigger than `max_bytes` (an H=4096 weights or gradients frame is
    16.9 MB) waits for an empty queue, within the same deadline.

    `close(flush=True)` is flush-before-close: the writer finishes the
    queue — a GOODBYE/CONFIG enqueued before close() reaches the wire
    before the socket goes down."""

    def __init__(self, sock: socket.socket, telemetry=None,
                 max_bytes: int = 8 << 20, flush_budget: int = 1 << 20,
                 send_deadline: float = 5.0):
        self._sock = sock
        self._max_bytes = int(max_bytes)
        self._flush_budget = int(flush_budget)
        self._deadline = float(send_deadline)
        self._q: deque = deque()          # (header, payload) pairs
        self.queued_bytes = 0
        # guarded-by: _lock (writers hold the queue lock; the dead property is a lock-free monotonic-bool peek)
        self._dead = False
        self._closing = False
        self._lock = OrderedLock("FrameWriter.queue")
        self._cond = threading.Condition(self._lock)
        self.advisory_dropped = 0
        self.flushes = 0
        self.frames_flushed = 0
        self.syscalls = 0
        self.fps_counts = [0] * len(FPS_BUCKETS)
        telemetry = telemetry or NULL_TELEMETRY
        self._m_fps = telemetry.histogram("wire_frames_per_syscall",
                                          buckets=FPS_BUCKETS)
        self._m_depth = telemetry.gauge("wire_send_queue_depth")
        self._m_dropped = telemetry.counter("wire_advisory_dropped")
        self._thread = threading.Thread(target=self._drain, daemon=True,
                                        name="kps-wire-writer")
        self._thread.start()

    @property
    def dead(self) -> bool:
        """True once a send failed: the socket is force-closed and the
        connection's reader-side cleanup is already in flight."""
        return self._dead

    def _fits(self, size: int) -> bool:
        # an oversize frame goes alone: it waits for an empty queue
        return (self.queued_bytes + size <= self._max_bytes
                or self.queued_bytes == 0)

    def send(self, topic: int, key: int, payload=b"",
             advisory: bool = False) -> bool:
        """Queue one frame.  False when the writer is dead/closing, the
        protocol-frame deadline expired, or an advisory frame hit a
        full queue (counted drop)."""
        header = _FRAME.pack(_FRAME.size - 4 + len(payload), topic, key)
        size = len(header) + len(payload)
        with self._cond:
            if self._dead or self._closing:
                return False
            if not self._fits(size):
                if advisory:
                    # liveness frames are regenerated next interval —
                    # dropping beats blocking the heartbeat thread
                    self.advisory_dropped += 1
                    self._m_dropped.inc()
                    return False
                ok = self._cond.wait_for(
                    lambda: (self._dead or self._closing
                             or self._fits(size)),
                    timeout=self._deadline)
                if not ok or self._dead or self._closing:
                    return False
            self._q.append((header, payload))
            self.queued_bytes += size
            self._m_depth.set(self.queued_bytes)
            self._cond.notify_all()
        return True

    def close(self, flush: bool = True, timeout: float = 10.0) -> None:
        """Stop the writer.  `flush=True` drains the queue first (the
        flush-before-close ordering); `flush=False` discards it.  Does
        NOT close the socket — the owner does, after this returns."""
        with self._cond:
            if not flush:
                self._q.clear()
                self.queued_bytes = 0
            self._closing = True
            self._cond.notify_all()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=timeout)

    # -- the writer thread --------------------------------------------------

    def _pop_batch(self):
        """One flush batch under the queue lock: every queued frame up
        to the byte budget / segment cap.  Returns (segments, nframes,
        nbytes) or None when the writer should exit."""
        with self._cond:
            while not self._q and not self._closing and not self._dead:
                self._cond.wait()
            if self._dead or (self._closing and not self._q):
                return None
            batch = []
            nbytes = 0
            nframes = 0
            while (self._q and nbytes < self._flush_budget
                    and len(batch) + 2 <= _IOV_CAP):
                header, payload = self._q.popleft()
                batch.append(header)
                if len(payload):
                    batch.append(payload)
                nbytes += len(header) + len(payload)
                nframes += 1
            self.queued_bytes -= nbytes
            self._m_depth.set(self.queued_bytes)
            self._cond.notify_all()     # wake producers blocked on space
        return batch, nframes, nbytes

    def _drain(self) -> None:
        while True:
            popped = self._pop_batch()
            if popped is None:
                return
            batch, nframes, nbytes = popped
            try:
                # outside the queue lock: a slow peer stalls this
                # thread only
                syscalls = sendmsg_all(self._sock, batch)
            except (ConnectionError, OSError):
                with self._cond:
                    self._dead = True
                    self._q.clear()
                    self.queued_bytes = 0
                    self._cond.notify_all()
                # wake the connection's reader so its disconnect
                # cleanup runs — same path a failed sendall took
                force_close(self._sock)
                return
            fps = nframes / max(syscalls, 1)
            with self._cond:
                self.flushes += 1
                self.frames_flushed += nframes
                self.syscalls += syscalls
                self.fps_counts[min(bisect.bisect_left(FPS_BUCKETS, fps),
                                    len(FPS_BUCKETS) - 1)] += 1
            self._m_fps.observe(fps)
            if FLIGHT.enabled:
                FLIGHT.record("net.flush", frames=nframes,
                              syscalls=syscalls, bytes=nbytes)


class RecvBuffer:
    """Buffered zero-copy frame reader for one connection.

    `recv_frame()` parses `(topic, key, payload-memoryview)` out of a
    growable buffer filled with `recv_into` — one syscall brings in as
    many frames as the kernel had ready, and every complete frame is
    parsed before the next syscall.  Returns None on a clean EOF at a
    frame boundary; EOF mid-frame raises ConnectionError (a crashed
    peer, never an orderly shutdown).

    Buffers are REPLACED when exhausted, never compacted in place:
    payload memoryviews handed to decode sites alias the buffer
    (np.frombuffer), so a buffer with exported views must stay
    immutable until the decoded messages die; only the unconsumed tail
    is copied into the fresh buffer, which is made as large as the
    frame being read (a 16.9 MB weights frame gets a 16.9 MB buffer)."""

    def __init__(self, sock: socket.socket, chunk: int = 1 << 16):
        self._sock = sock
        self._chunk = int(chunk)
        self._buf = bytearray(self._chunk)
        self._mv = memoryview(self._buf)
        self._pos = 0       # parse offset
        self._end = 0       # filled bytes

    def recv_frame(self):
        """(topic, key, payload) or None on clean EOF."""
        while True:
            avail = self._end - self._pos
            if avail >= 4:
                (length,) = struct.unpack_from("<I", self._buf, self._pos)
                total = 4 + length
                if avail >= total:
                    body = self._mv[self._pos + 4:self._pos + total]
                    topic, key = struct.unpack_from("<Bq", body, 0)
                    self._pos += total
                    return topic, key, body[9:]
                needed = total
            else:
                needed = 4
            if not self._fill(needed):
                return None

    def _fill(self, needed: int) -> bool:
        """Read more bytes (one recv_into), growing/replacing the buffer
        when the frame cannot fit contiguously from `_pos`.  False on a
        clean EOF; raises on EOF with a partial frame buffered."""
        avail = self._end - self._pos
        if self._pos + needed > len(self._buf) or self._end == len(self._buf):
            fresh = bytearray(max(self._chunk, needed))
            fresh[:avail] = self._mv[self._pos:self._end]
            self._buf = fresh
            self._mv = memoryview(fresh)
            self._pos = 0
            self._end = avail
        n = self._sock.recv_into(self._mv[self._end:])
        if n == 0:
            if avail:
                raise ConnectionError(
                    f"mid-frame EOF ({avail} buffered bytes)")
            return False
        self._end += n
        return True
