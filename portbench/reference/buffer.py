"""The sliding training buffer's policy, decision for decision (the
reference's WorkerSamplingProcessor.java:115-122; a frozen copy of the
policy the program implements in data/buffer.py).

  * inter-arrival times over the last `arrival_window` arrivals;
  * target = clamp(round(coefficient * 60000 / mean gap ms), min, max),
    the mean taken as 1000 ms before any gap, and the target the maximum
    when the mean gap is 0 (a burst);
  * below the target the first empty slot is filled, at it the oldest
    row is overwritten, above it (the target shrank) the n oldest rows
    are dropped and the next-oldest overwritten;
  * a row's id is the largest id held plus one (1 when empty).

A row's record is one or more fixed-width arrays (a family's rows say
which: dense values, integer ids); the policy does not look into them.
"""

from __future__ import annotations

from collections import deque

import numpy as np


class Buffer:
    def __init__(self, fields, min_size: int, max_size: int,
                 coefficient: float, arrival_window: int):
        """`fields`: the (shape, dtype) of each array of a row's
        record."""
        self.min_size = min_size
        self.max_size = max_size
        self.coefficient = coefficient
        self.records = tuple(np.zeros((max_size, *shape), dtype=dtype)
                             for shape, dtype in fields)
        self.y = np.zeros((max_size,), dtype=np.int32)
        self.ids = np.zeros((max_size,), dtype=np.int64)
        self._gaps: deque[float] = deque(maxlen=arrival_window)
        self._last: float | None = None

    def target_size(self) -> int:
        mean_ms = (sum(self._gaps) / len(self._gaps)) if self._gaps \
            else 1000.0
        if mean_ms <= 0:
            return self.max_size
        calculated = round(self.coefficient * 60000.0 / mean_ms)
        return max(self.min_size, min(self.max_size, int(calculated)))

    def add(self, record: tuple, label: int, stamp_ms: float) -> None:
        if self._last is not None:
            self._gaps.append(stamp_ms - self._last)
        self._last = stamp_ms
        target = self.target_size()
        filled = np.flatnonzero(self.ids > 0)
        count = len(filled)
        new_id = int(self.ids.max()) + 1 if count else 1
        if count < target:
            slot = int(np.flatnonzero(self.ids == 0)[0])
        elif count == target:
            slot = int(filled[np.argmin(self.ids[filled])])
        else:
            n = count - target
            oldest_first = filled[np.argsort(self.ids[filled])]
            self.ids[oldest_first[:n]] = 0
            slot = int(oldest_first[n])
        for held, value in zip(self.records, record, strict=True):
            held[slot] = value
        self.y[slot] = label
        self.ids[slot] = new_id

    def slab(self) -> tuple[np.ndarray, ...]:
        """(the record's arrays..., y, mask) as a round trains on them."""
        return (*(a.copy() for a in self.records), self.y.copy(),
                (self.ids > 0).astype(np.float32))
