"""The aggregator relay process body (counterpart of
kafka_ps_tpu/agg/relay.py): one per host, between that host's worker
processes and the server (cli/socket_mode.run_aggregator).

    workers --TCP--> AggregatorRelay --one connection--> server

Upstream it is a `net.WorkerBridge` that HELLOs with `aggregator=True`
and all member worker ids: the server routes the members' rows and
weights through this one connection and may group a release set into one
T_WEIGHTS_AGG frame.  Downstream it is a `net.ServerBridge` the members
dial as they would dial a server (the same HELLO and CONFIG, advertising
the upstream run id), which is why `worker_runner --aggregate` reuses the
sharded worker path with one address.

  * gradients: the members' frames decode onto the relay's device, queue
    in a `LocalAggregator` and go upstream as one composite per flush
    (a full round, or `flush_interval` of quiet), serialized once;
  * weights: upstream frames are forwarded raw; a grouped T_WEIGHTS_AGG
    frame is expanded by writing each member's clock into the shared
    body's header (no decode, no encode);
  * rows: forwarded raw, stashed for a member that has not connected yet
    (the server produces as soon as the relay's HELLO registers them).

The relay holds no protocol state a restart needs: workers resend their
redelivery caches and the server's gate drops what it had.  Under
`--compress` the error-feedback residuals live here; a checkpoint saved
after each upstream send keeps the compressed path bitwise across a
kill.

At `close()` the relay's counters are in `stats()`: composites, members,
the fan-in per composite, the bytes sent upstream and the bytes the
direct path would have sent for the same members (`_direct_cost`).

Telemetry (`tracer=`, `telemetry=`, null by default), the JAX relay's:
both bridges and the aggregator get them (the upstream bridge offers
trace context as a worker does, the downstream one answers its members
as a server does), the relay counts `agg_wire_bytes_saved` and records
`agg.forward` per expanded grouped weights frame.
"""

from __future__ import annotations

import os
import struct
import sys
import threading

import numpy as np

from kafka_ps_tpu_torch.analysis.lockgraph import OrderedLock
from kafka_ps_tpu_torch.agg.core import LocalAggregator
from kafka_ps_tpu_torch.compress.wire import CODEC_NONE
from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime import net, serde
from kafka_ps_tpu_torch.runtime.net import (T_DATA, T_DATA_BATCH, T_WEIGHTS,
                                            T_WEIGHTS_AGG)
from kafka_ps_tpu_torch.telemetry import FLIGHT, NULL_TELEMETRY

# serde._HEADER is <4sBq>: the vector-clock word of every nested weights
# body sits at byte offset 5, for plain tid-1 and compressed tid-4 frames
# alike — the grouped frame's expansion rewrites it, nothing else
_CLOCK_OFFSET = 5
# seconds a relay waits, after its GOODBYE, for its members to hang up
GOODBYE_WAIT_S = 3.0


class AggregatorRelay:
    """One host's aggregation relay: combine upstream, fan out down."""

    def __init__(self, agg_id: int, upstream_host: str, upstream_port: int,
                 worker_ids, num_params: int, *,
                 listen_host: str = "127.0.0.1", listen_port: int = 0,
                 codec_spec=None, summed: bool = False,
                 checkpoint_path: str | None = None,
                 checkpoint_every: int = 1,
                 flush_interval: float = 0.002,
                 heartbeat_interval: float | None = None,
                 heartbeat_timeout: float | None = None,
                 connect_timeout: float = 30.0,
                 coalesce: bool = True, device=None, tracer=None,
                 telemetry=None):
        from kafka_ps_tpu_torch.utils.config import resolve_device
        self.agg_id = agg_id
        self.worker_ids = list(worker_ids)
        self.flush_interval = flush_interval
        self.device = resolve_device(device)
        self._stop = threading.Event()
        # upstream first: its CONFIG carries the run id the downstream
        # listener advertises, and the negotiated codec decides whether
        # this relay owns error-feedback state at all
        self.upstream = net.WorkerBridge(
            upstream_host, upstream_port, self.worker_ids,
            connect_timeout=connect_timeout,
            heartbeat_timeout=heartbeat_timeout, codec=codec_spec,
            aggregator=True, coalesce=coalesce, device=self.device,
            tracer=tracer, telemetry=telemetry)
        spec = (self.upstream.negotiated
                if self.upstream.negotiated.codec_id != CODEC_NONE else None)
        self.agg = LocalAggregator(agg_id, num_params, codec_spec=spec,
                                   summed=summed, device=self.device,
                                   telemetry=telemetry, tracer=tracer)
        self._ckpt = checkpoint_path if spec is not None else None
        self._ckpt_every = max(1, int(checkpoint_every))
        self._flushes = 0
        self.restored = self._restore_checkpoint()
        # downstream: the listener the members dial.  No codec: members
        # ship raw float32 to their relay, which encodes once, upstream
        self.downstream = net.ServerBridge(
            host=listen_host, port=listen_port,
            run_id=self.upstream.server_run_id or 0,
            heartbeat_interval=heartbeat_interval,
            heartbeat_timeout=heartbeat_timeout, coalesce=coalesce,
            device=self.device, tracer=tracer, telemetry=telemetry)
        self.port = self.downstream.port
        self.fabric = self.downstream.wrap(fabric_mod.Fabric())
        # rows and weights for a member that has not connected yet
        self._stash_lock = OrderedLock("agg.stash")
        self._stash_rows: dict[int, list] = {}
        self._stash_weights: dict[int, bytes] = {}
        self.bytes_sent = 0              # composite payloads + headers
        self.direct_bytes = 0            # the direct path's for the same
        self.fan_in: dict[int, int] = {}     # fan-in -> composites
        self._m_bytes_saved = (telemetry or NULL_TELEMETRY).counter(
            "agg_wire_bytes_saved")
        self.downstream.on_ready = self._on_member_ready
        self.downstream.on_hello = self._on_member_hello
        self.upstream.raw_forward = self._on_upstream_frame
        self._reader = threading.Thread(
            target=self.upstream.run_reader, args=({},), daemon=True,
            name=f"kps-agg{agg_id}-upstream")
        self._reader.start()

    # -- downstream (member) events ----------------------------------------

    def _on_member_ready(self, worker: int) -> None:
        # READY crosses verbatim: the server's bootstrap waits on the
        # members' readiness, not the relay's
        self.upstream.mark_ready(worker)

    def _on_member_hello(self, ids) -> None:
        for worker in ids:
            if worker not in self.worker_ids:
                print(f"warning: worker {worker} connected to aggregator "
                      f"{self.agg_id}, which does not relay for it",
                      file=sys.stderr, flush=True)
            with self._stash_lock:
                rows = self._stash_rows.pop(worker, [])
                weights = self._stash_weights.pop(worker, None)
            for topic, payload in rows:
                self.downstream.forward_frame(topic, worker, payload)
            if weights is not None:
                self.downstream.forward_frame(T_WEIGHTS, worker, weights)

    # -- upstream (server) frames ------------------------------------------

    def _on_upstream_frame(self, topic: int, key: int,
                           payload: bytes) -> bool:
        if topic in (T_DATA, T_DATA_BATCH):
            self._forward_rows(topic, key, payload)
            return True
        if topic == T_WEIGHTS:
            self._forward_weights(key, payload)
            return True
        if topic == T_WEIGHTS_AGG:
            self._expand_group(payload)
            return True
        return False

    def _forward_rows(self, topic: int, worker: int, payload: bytes) -> None:
        if self.downstream.forward_frame(topic, worker, payload):
            return
        with self._stash_lock:
            if worker not in self.downstream._conn_of:
                # rows cannot be recovered (the producer counts them as
                # delivered): hold them for the late member
                self._stash_rows.setdefault(worker, []).append(
                    (topic, payload))
                return
        self.downstream.forward_frame(topic, worker, payload)

    def _forward_weights(self, worker: int, payload: bytes) -> None:
        if self.downstream.forward_frame(T_WEIGHTS, worker, payload):
            return
        with self._stash_lock:
            # weights can be recovered (the gate re-sends to a duplicate),
            # so only the latest undeliverable frame is kept
            self._stash_weights[worker] = payload

    def _expand_group(self, payload: bytes) -> None:
        """One T_WEIGHTS_AGG frame -> one T_WEIGHTS per member: the shared
        body with the member's clock written into its header."""
        (n,) = struct.unpack_from("<q", payload, 0)
        off = 8
        members = []
        for _ in range(n):
            members.append(net._AGG_MEMBER.unpack_from(payload, off))
            off += net._AGG_MEMBER.size
        body = payload[off:]
        for worker, clock in members:
            buf = bytearray(body)
            struct.pack_into("<q", buf, _CLOCK_OFFSET, clock)
            self._forward_weights(worker, bytes(buf))
        if FLIGHT.enabled:
            FLIGHT.record("agg.forward", agg=self.agg_id,
                          fan_out=len(members), grouped=True)

    # -- the combine and flush loop ------------------------------------------

    def run(self) -> None:
        """Forward loop: drain member gradients into the aggregator and
        flush one composite upstream per full round or per
        `flush_interval` of quiet, whichever comes first.  Ends when the
        server closes (the members get a GOODBYE) or on `close()`."""
        while not self._stop.is_set():
            self.upstream.raise_reader_error()
            self.downstream.raise_reader_error()
            if self.upstream.disconnected.is_set():
                # the run is over: tell the members so they stop at once
                # (a killed relay sends nothing, and its members wait for
                # its restart instead).  The members hang up on the
                # GOODBYE; closing first could reset a connection whose
                # GOODBYE is still unread, and the member would then
                # wait out its reconnect grace
                self.downstream.send_goodbye()
                self.downstream.wait_for_no_connections(GOODBYE_WAIT_S)
                break
            g = self.fabric.poll_blocking(fabric_mod.GRADIENTS_TOPIC, 0,
                                          timeout=self.flush_interval)
            if g is not None:
                self.agg.offer(g)
                if self.agg.pending_count < len(self.worker_ids):
                    continue        # a full round may be one poll away
            self.flush()

    def flush(self) -> None:
        comp = self.agg.combine()
        if comp is None:
            return
        payload = serde.to_bytes(comp)
        self.upstream.send_payload(0, payload)
        sent = len(payload) + net._FRAME.size
        direct = self._direct_cost(comp, len(payload))
        self.bytes_sent += sent
        self.direct_bytes += direct
        if direct > sent:
            self._m_bytes_saved.inc(direct - sent)
        self.fan_in[comp.fan_in] = self.fan_in.get(comp.fan_in, 0) + 1
        self._flushes += 1
        if self._ckpt and self._flushes % self._ckpt_every == 0:
            self._save_checkpoint()

    @staticmethod
    def _direct_cost(comp, payload_len: int) -> int:
        """Wire bytes the direct path would have spent on these members:
        their serde bodies (the composite's length less its own header
        and tables: nested bodies ride verbatim) plus one frame header
        each; a summed composite ships one body for k members."""
        k = comp.fan_in
        overhead = (serde._HEADER.size + serde._COMPOSITE_HEAD.size
                    + k * (serde._MEMBER.size + serde._TRACE.size)
                    + (1 + len(comp.deltas)) * serde._CHUNK.size)
        bodies = payload_len - overhead
        if comp.summed:
            return k * (bodies + net._FRAME.size)
        return bodies + k * net._FRAME.size

    def stats(self) -> dict:
        return {"agg_id": self.agg_id, "composites": self.agg.composites,
                "members": self.agg.members,
                "fan_in": {str(k): v for k, v in sorted(self.fan_in.items())},
                "duplicates": self.agg.duplicates,
                "bytes_upstream": self.bytes_sent,
                "direct_bytes": self.direct_bytes,
                "restored": self.restored,
                "upstream": self.upstream.stats(),
                "downstream": self.downstream.stats()}

    # -- the residual checkpoint (--compress) --------------------------------

    def _save_checkpoint(self) -> None:
        """The EF plane after the upstream send, written atomically: a
        restore's horizon then covers only composites the server has."""
        state = self.agg.ef_state()
        arrays = {
            "run_id": np.asarray([self.upstream.server_run_id or 0],
                                 dtype=np.int64),
            "workers": np.asarray(sorted(state), dtype=np.int64),
        }
        for w, (residual, clock, blob) in state.items():
            arrays[f"residual_{w}"] = residual
            arrays[f"clock_{w}"] = np.asarray([clock], dtype=np.int64)
            # pscheck: disable=PS204 (checkpoint stash of opaque message blobs via savez, not a wire-frame decode)
            arrays[f"msg_{w}"] = np.frombuffer(blob, dtype=np.uint8)
        tmp = self._ckpt + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, self._ckpt)

    def _restore_checkpoint(self) -> bool:
        if not self._ckpt or not os.path.exists(self._ckpt):
            return False
        with np.load(self._ckpt) as z:
            if int(z["run_id"][0]) != (self.upstream.server_run_id or 0):
                return False        # another run's leftovers
            state = {int(w): (z[f"residual_{w}"], int(z[f"clock_{w}"][0]),
                              z[f"msg_{w}"].tobytes())
                     for w in z["workers"].tolist()}
        self.agg.ef_restore(state)
        return True

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        self._stop.set()
        self.downstream.close()
        self.upstream.close()
        if self._reader is not threading.current_thread():
            self._reader.join(timeout=10.0)
