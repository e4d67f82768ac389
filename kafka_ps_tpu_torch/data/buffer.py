"""Dynamic sliding training-data buffer, one per logical worker
(counterpart of kafka_ps_tpu/data/buffer.py; the policy is the same,
decision for decision).

Each worker owns fixed-capacity dense numpy arrays plus a validity mask:
  * inter-arrival times are tracked over a 500-event window;
  * target size = clamp(round(coefficient * events_per_minute), min,
    max), events_per_minute = 60000 / mean_inter_arrival_ms, mean 1000 ms
    before any samples;
  * insertion: below target → fill the first empty slot; at target →
    overwrite the oldest; above target (target shrank) → delete the n
    oldest, then overwrite the next-oldest survivor;
  * insertion IDs: new ID = max ID in the buffer + 1 (1 when empty).

With telemetry on, `buffer_rows_ingested_total{worker}` counts the rows
inserted; with a drift monitor attached (`attach_drift`,
--model-health) every arrival also goes to its feature sketch, which
samples every Nth.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable

import numpy as np

from kafka_ps_tpu_torch.analysis.lockgraph import OrderedLock
from kafka_ps_tpu_torch.models.logreg import sparse_to_dense
from kafka_ps_tpu_torch.telemetry.registry import NULL_TELEMETRY
from kafka_ps_tpu_torch.utils.config import BufferConfig


def _default_clock_ms() -> float:
    return time.monotonic() * 1000.0


class SlidingBuffer:
    """Fixed-capacity masked ring buffer with a rate-adaptive target size."""

    def __init__(self, num_features: int, cfg: BufferConfig,
                 clock_ms: Callable[[], float] | None = None,
                 telemetry=None, worker: int | None = None):
        self.cfg = cfg
        self.num_features = num_features
        self._telemetry = telemetry or NULL_TELEMETRY
        self._m_rows = self._telemetry.counter(
            "buffer_rows_ingested_total",
            worker="all" if worker is None else str(worker))
        cap = cfg.max_size
        self.x = np.zeros((cap, num_features), dtype=np.float32)
        self.y = np.zeros((cap,), dtype=np.int32)
        # insertion_id[i] == 0 marks an empty slot (IDs start at 1)
        self.insertion_id = np.zeros((cap,), dtype=np.int64)
        self._clock_ms = clock_ms or _default_clock_ms
        self._inter_arrival_ms: deque[float] = deque(maxlen=cfg.arrival_window)
        self._last_arrival_ms: float | None = None
        # slots changed since the last drain/clearing snapshot — what the
        # incremental device slab (compress/slab.SlabStore.apply_rows)
        # uploads
        self._dirty: set[int] = set()
        # monotonic mutation counter: the worker's device-slab cache key
        self._version = 0
        # the producer thread adds while the training loop snapshots
        self._lock = OrderedLock("SlidingBuffer.state")
        # optional drift monitor (telemetry/drift.py): sampled arrivals
        # feed its per-feature Welford sketch; None leaves ingest as it is
        self._drift = None

    def attach_drift(self, monitor) -> None:
        """Feed sampled arrivals to a DriftMonitor's feature sketch
        (population-stability scoring, --model-health)."""
        self._drift = monitor

    # -- rate tracking ------------------------------------------------------

    def _record_arrival(self) -> None:
        now = self._clock_ms()
        if self._last_arrival_ms is not None:
            self._inter_arrival_ms.append(now - self._last_arrival_ms)
        self._last_arrival_ms = now

    def target_size(self) -> int:
        """clamp(round(coefficient * events_per_minute), min, max)."""
        if self._inter_arrival_ms:
            mean_ms = sum(self._inter_arrival_ms) / len(self._inter_arrival_ms)
        else:
            mean_ms = 1000.0
        if mean_ms <= 0:
            # burst arrivals within clock resolution: clamp to the cap
            return self.cfg.max_size
        calculated = round(self.cfg.coefficient * 60000.0 / mean_ms)
        return max(self.cfg.min_size, min(self.cfg.max_size, int(calculated)))

    # -- insertion policy ---------------------------------------------------

    def add(self, features, label: int) -> None:
        """Insert one sample, evicting per the dynamic-target policy."""
        with self._lock:
            self._add_locked(features, label)
        if self._telemetry.enabled:
            self._m_rows.inc()
        if self._drift is not None:
            # outside the buffer lock (never hold two); observe_row
            # itself samples every Nth arrival
            self._drift.observe_row(features)

    def add_many(self, rows) -> None:
        """Insert (features, label) samples under ONE lock acquisition,
        policy-identical to one add() per row: arrival recording and the
        dynamic-target eviction run per row."""
        n = 0
        # rows may be a one-shot iterable: keep the features while
        # inserting, sketch them after the lock is released
        sampled = [] if self._drift is not None else None
        with self._lock:
            for features, label in rows:
                self._add_locked(features, label)
                n += 1
                if sampled is not None:
                    sampled.append(features)
        if n and self._telemetry.enabled:
            self._m_rows.inc(n)
        if sampled:
            for features in sampled:
                self._drift.observe_row(features)

    def _add_locked(self, features, label: int) -> None:
        self._record_arrival()
        target = self.target_size()

        filled = np.flatnonzero(self.insertion_id > 0)
        count = len(filled)
        new_id = int(self.insertion_id.max()) + 1 if count else 1

        if count < target:
            # fill the first empty slot
            slot = int(np.flatnonzero(self.insertion_id == 0)[0])
        elif count == target:
            # overwrite the oldest
            slot = int(filled[np.argmin(self.insertion_id[filled])])
        else:
            # target shrank: drop the n oldest, overwrite the next-oldest
            n = count - target
            oldest_first = filled[np.argsort(self.insertion_id[filled])]
            self.insertion_id[oldest_first[:n]] = 0
            self._dirty.update(int(s) for s in oldest_first[:n])
            slot = int(oldest_first[n])

        if isinstance(features, dict):
            row = sparse_to_dense([features], self.num_features)[0]
        else:
            row = np.asarray(features, dtype=np.float32)
        self.x[slot] = row
        self.y[slot] = label
        self.insertion_id[slot] = new_id
        self._dirty.add(slot)
        self._version += 1

    # -- views for the training step ----------------------------------------

    @property
    def count(self) -> int:
        with self._lock:
            return int((self.insertion_id > 0).sum())

    @property
    def num_tuples_seen(self) -> int:
        """Worker log column: max insertion ID in the buffer."""
        with self._lock:
            return int(self.insertion_id.max())

    @property
    def version(self) -> int:
        """Monotonic mutation counter (bumps on every add and restore):
        unlike num_tuples_seen it never aliases across restore_state."""
        with self._lock:
            return self._version

    @property
    def dirty_slots(self) -> list[int]:
        """Sorted slots touched since the last drain (non-clearing)."""
        with self._lock:
            return sorted(self._dirty)

    def drain_dirty(self):
        """(slots, x_rows, y_rows, mask_rows) for every slot touched since
        the last drain, then forget them.  A slot deleted by a target
        shrink comes back with mask 0 and its stale x/y."""
        with self._lock:
            slots = np.asarray(sorted(self._dirty), dtype=np.int64)
            self._dirty.clear()
            mask = (self.insertion_id[slots] > 0).astype(np.float32)
            return slots, self.x[slots].copy(), self.y[slots].copy(), mask

    def snapshot(self, clear_dirty: bool = False
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(x, y, mask) — a consistent copy of the static-shape slab.
        clear_dirty=True marks the copy as the new device baseline."""
        with self._lock:
            mask = (self.insertion_id > 0).astype(np.float32)
            if clear_dirty:
                self._dirty.clear()
            return self.x.copy(), self.y.copy(), mask

    # -- durability (utils/checkpoint.py) -----------------------------------

    def state(self) -> dict[str, np.ndarray]:
        """Serializable durable state: slab contents, insertion IDs and
        the inter-arrival window behind the rate-adaptive target size
        (the JAX package's keys and dtypes: a checkpoint of either
        package restores into the other)."""
        with self._lock:
            return {"x": self.x.copy(), "y": self.y.copy(),
                    "ids": self.insertion_id.copy(),
                    "arrivals": np.asarray(self._inter_arrival_ms,
                                           dtype=np.float64)}

    def restore_state(self, st) -> None:
        """Inverse of state().  The arrival CLOCK does not survive a
        restart (monotonic time is process-local): the gap between the
        crash and the first post-restore arrival is not counted.  Every
        slot is marked dirty and the version bumps, so a worker's
        incremental device slab uploads the restored rows."""
        if st["x"].shape != self.x.shape:
            raise ValueError(
                f"buffer state shape {st['x'].shape} != slab "
                f"{self.x.shape} (capacity/features changed?)")
        with self._lock:
            self.x[:] = st["x"]
            self.y[:] = st["y"]
            self.insertion_id[:] = st["ids"]
            self._inter_arrival_ms.clear()
            self._inter_arrival_ms.extend(float(v) for v in st["arrivals"])
            self._last_arrival_ms = None
            self._dirty.update(range(self.x.shape[0]))
            self._version += 1
