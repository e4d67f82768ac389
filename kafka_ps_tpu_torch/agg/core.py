"""The aggregator's combine and expand engine (counterpart of
kafka_ps_tpu/agg/core.py).

One `LocalAggregator` lives on each relay host, between that host's
workers and the server.  Workers send it plain per-worker
GradientMessages; each flush combines everything pending into one
`CompositeDelta`, and the server's gate advances every member's clock as
if the deltas had come one by one (runtime/server.py `process_composite`).

Two shapes (messages.CompositeDelta):

  * stacked (the default): members travel as their own deltas inside one
    frame and the server applies them in member order, so the aggregated
    path is bitwise the direct path under all three consistency models;
  * summed (`summed=True`): members of ONE clock are added into a single
    delta in worker-id order (exact by linearity under BSP, not bitwise):
    one server apply per host per clock.  A flush whose members span
    clocks goes stacked.

Compression: workers ship raw float32 to their relay, which owns each
member's error-feedback residual (compress/feedback.ErrorFeedback, on the
relay's device) and encodes at the relay-to-server edge: the same
compensate, encode, decode sequence the worker would have run, so the
compressed stacked path is bitwise the compressed direct path.

Combine order, member order and merge results are functions of the
offered messages alone (no clock, no hash order).

Telemetry (`telemetry=`, `tracer=`, null by default), the JAX engine's:
`agg_composites_total{mode}`, `agg_duplicate_offers_total`, `agg_fan_in`,
the `agg.combine` flight record, and a `delta.wire` flow step per traced
member through the hop.  The plain counters (`composites`, `members`,
`duplicates`) stay beside them.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict

import numpy as np

from kafka_ps_tpu_torch.runtime.messages import (CompositeDelta,
                                                 GradientMessage, KeyRange)
from kafka_ps_tpu_torch.telemetry import FLIGHT, NULL_TELEMETRY
from kafka_ps_tpu_torch.utils.trace import NULL_TRACER

# composite fan-in distribution buckets (workers per composite)
FAN_IN_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def merge_composites(a: CompositeDelta, b: CompositeDelta) -> CompositeDelta:
    """The vector-clock merge of two STACKED composites: the union of
    their members, deduplicated by (worker, clock), sorted.  A semilattice
    join (associative, commutative, idempotent): a redelivered (worker,
    clock) carries the identical delta, since workers resend from their
    redelivery cache and never recompute."""
    if a.summed or b.summed:
        raise ValueError("merge is defined on stacked composites only "
                         "(a summed composite has lost its members' "
                         "individual deltas)")
    by_member: dict[tuple[int, int], GradientMessage] = {}
    for comp in (a, b):
        for m, d in zip(comp.members, comp.deltas):
            by_member.setdefault(m, d)
    members = tuple(sorted(by_member))
    return CompositeDelta(agg_id=a.agg_id, members=members,
                          deltas=tuple(by_member[m] for m in members))


def split_composite(plan, composite: CompositeDelta) -> list[CompositeDelta]:
    """The shard split run once per composite: every member delta sliced
    to each shard's range, one composite per shard carrying the whole
    member map (each shard's gate still sees one message per host and
    clock)."""
    out = []
    for r in plan.ranges:
        deltas = []
        for d in composite.deltas:
            lo = r.start - d.key_range.start
            hi = r.end - d.key_range.start
            deltas.append(dataclasses.replace(
                d, key_range=KeyRange(r.start, r.end),
                values=d.values[lo:hi], encoded=None))
        out.append(CompositeDelta(agg_id=composite.agg_id,
                                  members=composite.members,
                                  deltas=tuple(deltas),
                                  summed=composite.summed))
    return out


def direct_equivalent(composite: CompositeDelta) -> list[GradientMessage]:
    """The per-member messages a stacked composite stands for, in member
    order: what the server's expansion applies."""
    if composite.summed:
        raise ValueError("a summed composite has no per-member "
                         "equivalent (pre-reduced by linearity)")
    return list(composite.deltas)


class LocalAggregator:
    """The combine engine of one relay host.

    `offer()` runs on the member connections' reader threads, `combine()`
    on the forwarding loop.  Pending deltas are keyed (worker, clock),
    first writer wins: a reconnecting worker's resend of a pending clock
    is dropped here, one of a forwarded clock by the server's gate.
    `device` is where the error-feedback residuals live (the card unless
    the caller asks for the CPU)."""

    def __init__(self, agg_id: int, num_params: int, codec_spec=None,
                 summed: bool = False, device=None, telemetry=None,
                 tracer=None):
        from kafka_ps_tpu_torch.utils.config import resolve_device
        self.agg_id = agg_id
        self.num_params = num_params
        self.summed = summed
        self.device = resolve_device(device)
        self._spec = codec_spec          # compress/wire.CodecSpec or None
        self._ef = {}                    # worker id -> ErrorFeedback
        self._ef_clock = {}              # worker id -> last encoded clock
        self._ef_last = {}               # worker id -> last encoded message
        self._pending: OrderedDict[tuple[int, int], GradientMessage] = \
            OrderedDict()
        self._lock = threading.Lock()
        # plain-integer counters: composites made, members in them, and
        # offers or resends dropped as duplicates
        self.composites = 0
        self.members = 0
        self.duplicates = 0
        self._telemetry = telemetry or NULL_TELEMETRY
        self._tracer = tracer or NULL_TRACER
        mode = "summed" if summed else "stacked"
        self._m_composites = self._telemetry.counter(
            "agg_composites_total", mode=mode)
        self._m_dropped_dups = self._telemetry.counter(
            "agg_duplicate_offers_total")
        self._m_fan_in = self._telemetry.histogram(
            "agg_fan_in", buckets=FAN_IN_BUCKETS)

    def _ef_for(self, worker: int):
        ef = self._ef.get(worker)
        if ef is None:
            from kafka_ps_tpu_torch.compress import ErrorFeedback, get_codec
            ef = ErrorFeedback(get_codec(self._spec, self.num_params),
                               self.device)
            self._ef[worker] = ef
        return ef

    # -- worker-facing side ------------------------------------------------

    def offer(self, msg: GradientMessage) -> bool:
        """Queue one worker delta for the next combine; False for a
        duplicate of a pending (worker, clock)."""
        key = (msg.worker_id, msg.vector_clock)
        with self._lock:
            if key in self._pending:
                self.duplicates += 1
                self._m_dropped_dups.inc()
                return False
            self._pending[key] = msg
        return True

    @property
    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- server-facing side ------------------------------------------------

    def combine(self) -> CompositeDelta | None:
        """Everything pending as one composite (None when idle).  Summed
        mode adds the members only when they share one clock; otherwise
        this flush goes stacked, so a mixed-progress moment (a reconnect
        backlog, eventual consistency) never stalls anyone."""
        with self._lock:
            if not self._pending:
                return None
            drained = list(self._pending.items())
            self._pending.clear()
        drained.sort(key=lambda kv: kv[0])
        members = tuple(k for k, _ in drained)
        deltas = [d for _, d in drained]
        clocks = {c for _, c in members}
        summed = self.summed and len(clocks) == 1 and len(deltas) > 1
        if summed:
            total = deltas[0].values
            for d in deltas[1:]:         # ascending worker id
                total = total + d.values.to(total.device)
            base = GradientMessage(
                vector_clock=members[0][1], key_range=deltas[0].key_range,
                values=total, worker_id=members[0][0])
            deltas = [self._encode(base) if self._spec is not None
                      else base]
        elif self._spec is not None:
            kept_members, kept = [], []
            for m, d in zip(members, deltas):
                out = self._encode(d)
                if out is None:
                    # below the EF horizon: its encode rode a composite
                    # already forwarded; advancing the residual again
                    # would desync every later encode
                    self.duplicates += 1
                    self._m_dropped_dups.inc()
                    continue
                kept_members.append(m)
                kept.append(out)
            if not kept:
                return None
            members, deltas = tuple(kept_members), kept
        self.composites += 1
        self.members += len(members)
        composite = CompositeDelta(agg_id=self.agg_id, members=members,
                                   deltas=tuple(deltas), summed=summed)
        self._m_composites.inc()
        self._m_fan_in.observe(len(members))
        if FLIGHT.enabled:
            FLIGHT.record("agg.combine", agg=self.agg_id,
                          fan_in=len(members), summed=summed,
                          clock=members[-1][1])
        if self._tracer.enabled:
            for m, d in zip(members, composite.deltas):
                fid = getattr(d, "trace", None)
                if fid:
                    # the member's delta.wire flow steps through the hop
                    self._tracer.flow_step("delta.wire", fid,
                                           agg=self.agg_id, worker=m[0])
        return composite

    def _encode(self, msg: GradientMessage) -> GradientMessage | None:
        """The relay-owned error feedback for one member: each clock
        advances the residual once.  A clock AT the member's horizon
        returns the cached encode (the server drops it as a duplicate),
        one BELOW it None (already forwarded)."""
        w, c = msg.worker_id, msg.vector_clock
        last = self._ef_clock.get(w, -1)
        if c < last:
            return None
        if c == last:
            return self._ef_last[w]
        decoded, enc = self._ef_for(w).step(msg.values)
        out = dataclasses.replace(msg, values=decoded, encoded=enc)
        fid = getattr(msg, "trace", None)
        if fid:
            object.__setattr__(out, "trace", fid)
        self._ef_clock[w] = c
        self._ef_last[w] = out
        return out

    # -- crash and restart -------------------------------------------------

    def reset(self) -> None:
        """Drop all state, as a killed relay does: pending deltas and the
        residuals.  Workers resend from their redelivery caches and the
        server's gate drops what had been forwarded."""
        with self._lock:
            self._pending.clear()
        self._ef.clear()
        self._ef_clock.clear()
        self._ef_last.clear()

    def ef_state(self) -> dict[int, tuple[np.ndarray, int, bytes]]:
        """The error-feedback plane for the relay checkpoint: worker ->
        (residual as a host copy, last encoded clock, last encoded
        message as serde bytes).  Saved after each upstream send, so a
        restore's horizon covers only composites the server has."""
        from kafka_ps_tpu_torch.runtime import serde
        return {w: (ef.state(), self._ef_clock.get(w, -1),
                    serde.to_bytes(self._ef_last[w]))
                for w, ef in self._ef.items()}

    def ef_restore(self, state: dict) -> None:
        """Take back `ef_state()` after a restart."""
        from kafka_ps_tpu_torch.runtime import serde
        for w, (residual, clock, last) in state.items():
            self._ef_for(int(w)).restore(np.asarray(residual))
            self._ef_clock[int(w)] = int(clock)
            self._ef_last[int(w)] = serde.from_bytes(last,
                                                     device=self.device)
