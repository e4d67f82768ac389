"""Same-host shared-memory fast path for predict traffic (a copy of
kafka_ps_tpu/serving/shm.py; the layout and handshake are the JAX
package's, byte for byte, so either package's client attaches to either
package's server).

A co-located `PredictClient` pays the TCP stack twice per prediction —
frame out, frame back — for bytes that never leave the machine.  This
module replaces that round trip with a depth-1 RPC slot in a
`multiprocessing.shared_memory` segment: the client memcpys its request
payload in and bumps a sequence number; the server's poll thread
decodes it with the SAME codec helpers the socket path uses
(`runtime/net.py` encode/decode_predict_request / encode_prediction),
submits to the `PredictionEngine`, and memcpys the reply back.  No
syscalls on the hot path beyond the client's bounded spin-sleep.

The channel is negotiated, never assumed: the client asks via a
trailer on its HELLO, the server offers `(segment name, nonce)` via a
trailer on its CONFIG — the same append-and-length-check pattern as the
codec/trace trailers, so legacy peers on either side silently degrade to
sockets.  A remote client's
attach fails (the segment name does not exist on its host), nonce
mismatch catches name collisions, and any failure at any point falls
back to the still-open socket.  The socket stays the control plane;
shared memory only ever carries predict payloads.

Layout (little-endian, one segment per connection)::

    [0:16)    nonce — random bytes the CONFIG offer carries; the
              client verifies them after attach
    [16:24)   req_seq  (u64) — client increments after writing request
    [24:32)   resp_seq (u64) — server sets to req_seq after writing
              the matching response
    [32:36)   req_len  (u32)
    [36:40)   resp_len (u32)
    [40:41)   closed   (u8) — either side marks teardown
    [64:64+C) request payload buffer
    [64+C:..) response payload buffer

Depth-1 on purpose: a prediction round trip is tens of microseconds,
so one in-flight request per connection keeps the protocol two seq
words and zero locks shared across processes.  Clients serialize their
own threads on a local lock.
"""

from __future__ import annotations

import os
import struct
import time

from kafka_ps_tpu_torch.analysis.lockgraph import OrderedLock

_NONCE = struct.Struct("<16s")
_SEQ = struct.Struct("<Q")
_LEN = struct.Struct("<I")
_REQ_SEQ_OFF = 16
_RESP_SEQ_OFF = 24
_REQ_LEN_OFF = 32
_RESP_LEN_OFF = 36
_CLOSED_OFF = 40
_DATA_OFF = 64

DEFAULT_CAPACITY = 1 << 18      # per-direction payload buffer (256 KiB)

# client spin policy: a short pure spin catches the common
# tens-of-microseconds reply without ever sleeping; after that, sleep
# in sub-millisecond slices so a slow batched reply costs ~one
# scheduler quantum of extra latency, not a busy core
_SPIN_ITERS = 2000
_POLL_SLEEP_S = 0.0002


class ShmError(RuntimeError):
    """Channel setup or transport failure — callers fall back to the
    socket path, never to the user."""


class ShmChannel:
    """One depth-1 request/response slot in a shared-memory segment.

    The server side `create()`s (and later unlinks) the segment; the
    client side `attach()`es by the negotiated name and verifies the
    nonce.  `rpc()` is the client hot path, `serve_once()`/`respond()`
    the server's.
    """

    def __init__(self, seg, nonce: bytes, capacity: int, owner: bool):
        self._seg = seg
        self.nonce = nonce
        self.capacity = capacity
        self.owner = owner
        self._buf = seg.buf
        self._seq = 0           # client: last request sequence issued
        self._seen = 0          # server: last request sequence popped
        self._lock = OrderedLock("ShmChannel.rpc")

    # -- lifecycle ----------------------------------------------------------

    @classmethod
    def create(cls, capacity: int = DEFAULT_CAPACITY) -> "ShmChannel":
        """Server side: allocate the segment and stamp the nonce."""
        from multiprocessing import shared_memory
        size = _DATA_OFF + 2 * capacity
        seg = shared_memory.SharedMemory(create=True, size=size)
        nonce = os.urandom(16)
        seg.buf[:_DATA_OFF] = b"\0" * _DATA_OFF
        seg.buf[0:16] = nonce
        return cls(seg, nonce, capacity, owner=True)

    @classmethod
    def attach(cls, name: str, nonce: bytes) -> "ShmChannel":
        """Client side: map the offered segment and verify the nonce.
        Raises (FileNotFoundError for a remote peer, ShmError for a
        stale or foreign segment) — callers catch and fall back."""
        from multiprocessing import shared_memory
        seg = shared_memory.SharedMemory(name=name)
        try:
            # the resource tracker assumes whoever maps a segment owns
            # its lifetime; this side explicitly does not (the server
            # unlinks), so unregister to avoid a spurious unlink +
            # KeyError warning at interpreter exit
            from multiprocessing import resource_tracker
            resource_tracker.unregister(seg._name, "shared_memory")
        except Exception:  # noqa: BLE001 — tracker API is CPython-internal
            pass
        if bytes(seg.buf[0:16]) != nonce:
            seg.close()
            raise ShmError(f"segment {name} nonce mismatch")
        capacity = (seg.size - _DATA_OFF) // 2
        return cls(seg, nonce, capacity, owner=False)

    @property
    def name(self) -> str:
        return self._seg.name

    @property
    def closed(self) -> bool:
        return self._buf is None or self._buf[_CLOSED_OFF] != 0

    def mark_closed(self) -> None:
        if self._buf is not None:
            self._buf[_CLOSED_OFF] = 1

    def close(self) -> None:
        """Unmap (and unlink, when owner).  Idempotent."""
        if self._buf is None:
            return
        try:
            self._buf[_CLOSED_OFF] = 1
        except (TypeError, ValueError):
            pass
        self._buf = None
        try:
            self._seg.close()
            if self.owner:
                try:
                    # in-process tests attach the client end in the SAME
                    # process: its unregister (see attach) also removed
                    # OUR registration, and unlink's implicit unregister
                    # would then KeyError inside the tracker process —
                    # re-register first (a set add: no-op cross-process)
                    from multiprocessing import resource_tracker
                    resource_tracker.register(self._seg._name,
                                              "shared_memory")
                except Exception:  # noqa: BLE001 — CPython-internal API
                    pass
                self._seg.unlink()
        except (FileNotFoundError, OSError):
            pass

    # -- client hot path ----------------------------------------------------

    def rpc(self, payload: bytes, timeout: float = 30.0) -> bytes:
        """One predict round trip: write `payload`, spin for the reply.
        Raises ShmError on overflow/teardown/timeout — the caller falls
        back to its socket."""
        if len(payload) > self.capacity:
            raise ShmError(f"payload {len(payload)}B > channel capacity "
                           f"{self.capacity}B")
        with self._lock:
            buf = self._buf
            if buf is None or buf[_CLOSED_OFF]:
                raise ShmError("channel closed")
            self._seq += 1
            seq = self._seq
            buf[_DATA_OFF:_DATA_OFF + len(payload)] = payload
            _LEN.pack_into(buf, _REQ_LEN_OFF, len(payload))
            # request becomes visible to the server at the seq store —
            # payload and length writes are sequenced before it
            _SEQ.pack_into(buf, _REQ_SEQ_OFF, seq)
            deadline = time.monotonic() + timeout
            spins = 0
            while True:
                (resp,) = _SEQ.unpack_from(buf, _RESP_SEQ_OFF)
                if resp == seq:
                    (n,) = _LEN.unpack_from(buf, _RESP_LEN_OFF)
                    off = _DATA_OFF + self.capacity
                    return bytes(buf[off:off + n])
                if buf[_CLOSED_OFF]:
                    raise ShmError("server closed channel")
                if time.monotonic() > deadline:
                    raise ShmError("shm rpc timed out")
                spins += 1
                if spins > _SPIN_ITERS:
                    # pscheck: disable=PS105 (the lock IS the depth-1 request slot; bounded sub-ms poll)
                    time.sleep(_POLL_SLEEP_S)

    # -- server hot path ----------------------------------------------------

    def serve_once(self) -> tuple[int, bytes] | None:
        """Pop the pending request, if any: (seq, payload) once per
        request — the reply is owed via respond(seq, ...)."""
        buf = self._buf
        if buf is None:
            return None
        (req,) = _SEQ.unpack_from(buf, _REQ_SEQ_OFF)
        if req <= self._seen:
            return None
        self._seen = req
        (n,) = _LEN.unpack_from(buf, _REQ_LEN_OFF)
        return req, bytes(buf[_DATA_OFF:_DATA_OFF + n])

    def respond(self, seq: int, payload: bytes) -> None:
        """Publish the reply for `seq` (server side)."""
        buf = self._buf
        if buf is None:
            return
        n = min(len(payload), self.capacity)
        off = _DATA_OFF + self.capacity
        buf[off:off + n] = payload[:n]
        _LEN.pack_into(buf, _RESP_LEN_OFF, n)
        _SEQ.pack_into(buf, _RESP_SEQ_OFF, seq)
