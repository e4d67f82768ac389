"""Immutable model snapshots with lock-free hot swap (counterpart of
kafka_ps_tpu/serving/snapshot.py).

The server publishes a snapshot at every consistency-gate release
(ServerNode.publish_snapshot): the exact theta the released workers were
sent, stamped with the stable vector clock at that moment.  A snapshot
aliases the server's tensor on the card, which is safe because the
server only ever REPLACES theta (`t + lr*d` out of place, a splice or a
sparse apply into a new tensor, a restore into a new tensor), never
writes it in place.

Readers (the prediction engine, any thread reading `latest`) take no
lock: a publication builds the complete Snapshot first and then swaps one
reference, which is atomic under the GIL, so a reader always sees a
whole (theta, clock, time) triple, never a mix of two publications.  The
publisher's lock only serialises concurrent publishers (the threaded
runtime's drive threads).

A bounded ring keeps the newest `capacity` snapshots for exact-clock
audit reads (`at_clock`); older ones fall off.
"""

from __future__ import annotations

import collections
import time
from typing import NamedTuple

from kafka_ps_tpu_torch.analysis.lockgraph import OrderedLock
from kafka_ps_tpu_torch.serving import policy


class Snapshot(NamedTuple):
    theta: object          # a tensor (or array); immutable by contract
    vector_clock: int      # stable clock: min active-worker clock at publish
    wall_time: float       # publication time (the registry's clock)
    seq: int               # publication number, increasing
    # trace context (a delta.wire flow id) of the gradient whose gate
    # release published this snapshot; None when tracing is off
    trace: object = None


class SnapshotRegistry:
    """Bounded ring of published snapshots with a lock-free `latest`."""

    def __init__(self, capacity: int = 8, now=time.time):
        self._ring: collections.deque[Snapshot] = collections.deque(
            maxlen=max(1, int(capacity)))
        self._latest: Snapshot | None = None
        self._seq = 0
        self._now = now
        self._publish_lock = OrderedLock("SnapshotRegistry.publish")

    def publish(self, theta, vector_clock: int,
                wall_time: float | None = None, trace=None) -> Snapshot:
        with self._publish_lock:
            self._seq += 1
            snap = Snapshot(
                theta, int(vector_clock),
                self._now() if wall_time is None else float(wall_time),
                self._seq, trace)
            self._ring.append(snap)
            # the hot-swap point: one reference store; readers of
            # `latest` never wait on the publish lock
            self._latest = snap
        return snap

    @property
    def latest(self) -> Snapshot | None:
        return self._latest

    def snapshots(self) -> tuple[Snapshot, ...]:
        """The retained ring, oldest first."""
        return tuple(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    def get(self, bound: policy.ReadBound | None = None, *,
            min_clock: int | None = None, max_age_s: float | None = None,
            at_clock: int | None = None, now: float | None = None) -> Snapshot:
        """Newest snapshot satisfying the bound, or raise StalenessError.
        Takes either a ReadBound or the individual fields, not both."""
        if bound is None:
            bound = policy.ReadBound(min_clock=min_clock,
                                     max_age_s=max_age_s, at_clock=at_clock)
        elif min_clock is not None or max_age_s is not None \
                or at_clock is not None:
            raise ValueError("pass either a ReadBound or keyword fields")
        now = self._now() if now is None else now
        if bound.at_clock is not None:
            snap = self._find_clock(bound.at_clock)
        else:
            snap = self._latest
        policy.check(snap, bound, now)
        return snap

    def _find_clock(self, clock: int) -> Snapshot | None:
        # newest first, so duplicate clocks (the cold-start publish and
        # the first release at the same clock) resolve to the later one
        for snap in reversed(tuple(self._ring)):
            if snap.vector_clock == clock:
                return snap
        raise policy.StalenessError(
            f"no retained snapshot at clock {clock} "
            f"(ring keeps the newest {self._ring.maxlen})",
            min_clock=clock,
            have_clock=None if self._latest is None
            else self._latest.vector_clock)


class MultiModelRegistry:
    """A SnapshotRegistry per model id: several model families serving
    from one process.  Routing only: each tenant keeps its own ring; the
    engine adds a per-tenant admission budget (serving/engine.py)."""

    def __init__(self):
        self._registries: dict[int, SnapshotRegistry] = {}
        self._lock = OrderedLock("MultiModelRegistry.register")

    def register(self, model_id: int,
                 registry: SnapshotRegistry | None = None,
                 capacity: int = 8) -> SnapshotRegistry:
        """Idempotent: returns the existing ring when `model_id` is
        registered already, and refuses to replace it with another."""
        with self._lock:
            have = self._registries.get(model_id)
            if have is not None:
                if registry is not None and registry is not have:
                    raise ValueError(
                        f"model {model_id} already registered")
                return have
            reg = registry if registry is not None \
                else SnapshotRegistry(capacity=capacity)
            self._registries[int(model_id)] = reg
            return reg

    def get(self, model_id: int) -> SnapshotRegistry | None:
        return self._registries.get(model_id)

    def model_ids(self) -> tuple[int, ...]:
        return tuple(sorted(self._registries))

    def __len__(self) -> int:
        return len(self._registries)


class FrontierCutPublisher:
    """Cross-shard consistent snapshots (runtime/sharding.py).

    Shard thetas advance independently, and a reader must never see a
    torn mix of shard states.  A publication here is a CUT: per shard
    (theta slice, stable clock), read at a quiescent point of the drive
    loop, published only when the common frontier (the minimum of the
    shards' clocks) has ADVANCED past the last published one.  The
    slices, concatenated in shard order, become one full-range snapshot
    stamped with the frontier clock, so every staleness rule keeps its
    meaning: a snapshot at clock c still guarantees that every shard has
    applied every round below c."""

    def __init__(self, registry: SnapshotRegistry):
        self.registry = registry
        self._last_frontier = -1

    def maybe_publish(self, cut, trace=None) -> Snapshot | None:
        """`cut`: [(theta_slice, clock), ...] in key order; a slice may be
        a zero-argument callable, read only when the cut publishes.
        Publishes the concatenation (a new tensor, on the slices' device)
        and returns the snapshot when the frontier advanced, else None:
        no torn and no duplicate publications."""
        import torch
        frontier = min(clock for _, clock in cut)
        if frontier <= self._last_frontier:
            return None
        theta = torch.cat([torch.as_tensor(s() if callable(s) else s)
                           for s, _ in cut])
        snap = self.registry.publish(theta, frontier, trace=trace)
        self._last_frontier = frontier
        return snap
