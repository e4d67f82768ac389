"""Device-resident training slab, f32 storage (counterpart of
kafka_ps_tpu/compress/slab.py:SlabStore).

The worker trains on its buffer slab ([cap, F] x, labels, validity mask)
every iteration.  `SlabStore` keeps that slab on the device and applies
only the rows `SlidingBuffer` marked dirty: O(changed rows) bytes per
arrival instead of the whole slab.

The changed-row count is padded to a power-of-two bucket (never below
MIN_BUCKET) with a sentinel slot == capacity, so host→device copies
keep a handful of shapes.  torch has no scatter mode that drops
out-of-range indices, so the device tensors carry one spare row at index
`capacity`: every sentinel lands there and `arrays()` slices it off.
Real slots are unique (a drained set), so the only repeated index is the
sentinel's, and index_copy_'s unordered writes touch nothing that is
read.  Incremental and full uploads give bitwise-equal slabs.
"""

from __future__ import annotations

import numpy as np
import torch

MIN_BUCKET = 4


class SlabStore:
    """One worker's device-resident training slab (f32).

    `upload_full` replaces the whole slab (bootstrap, mass-delete churn);
    `apply_rows` scatters a drained dirty set into it.  `bytes_uploaded`
    counts the host bytes each path shipped, as the reference does."""

    def __init__(self, capacity: int, num_features: int, device):
        self.capacity = capacity
        self.num_features = num_features
        self.device = torch.device(device)
        self._x = None
        self._y = None
        self._mask = None
        self.bytes_uploaded = 0
        self.full_uploads = 0
        self.incremental_applies = 0
        self.rows_applied = 0

    @property
    def ready(self) -> bool:
        return self._x is not None

    def upload_full(self, x, y, mask) -> None:
        """Host slab copy → device store (plus the zeroed spare row)."""
        x = np.ascontiguousarray(x, dtype=np.float32)
        y = np.ascontiguousarray(y, dtype=np.int32)
        mask = np.ascontiguousarray(mask, dtype=np.float32)
        self.bytes_uploaded += x.nbytes + y.nbytes + mask.nbytes
        self.full_uploads += 1
        cap, dev = self.capacity, self.device
        sx = torch.zeros((cap + 1, self.num_features), dtype=torch.float32,
                         device=dev)
        sy = torch.zeros((cap + 1,), dtype=torch.int32, device=dev)
        sm = torch.zeros((cap + 1,), dtype=torch.float32, device=dev)
        sx[:cap].copy_(torch.from_numpy(x))
        sy[:cap].copy_(torch.from_numpy(y))
        sm[:cap].copy_(torch.from_numpy(mask))
        self._x, self._y, self._mask = sx, sy, sm

    def apply_rows(self, slots, xr, yr, mr) -> None:
        """Scatter the changed rows into the device slab, the row count
        padded to a power-of-two bucket with sentinel slots."""
        n = int(len(slots))
        if n == 0:
            return
        if not self.ready:
            raise RuntimeError("apply_rows before the first upload_full")
        b = MIN_BUCKET
        while b < n:
            b *= 2
        pad = b - n
        slots_p = np.concatenate(
            [np.asarray(slots, np.int32),
             np.full((pad,), self.capacity, np.int32)])
        xr_p = np.concatenate(
            [np.asarray(xr, np.float32),
             np.zeros((pad, self.num_features), np.float32)])
        yr_p = np.concatenate(
            [np.asarray(yr, np.int32), np.zeros((pad,), np.int32)])
        mr_p = np.concatenate(
            [np.asarray(mr, np.float32), np.zeros((pad,), np.float32)])
        self.bytes_uploaded += (slots_p.nbytes + xr_p.nbytes
                                + yr_p.nbytes + mr_p.nbytes)
        self.incremental_applies += 1
        self.rows_applied += n
        dev = self.device
        idx = torch.from_numpy(slots_p).to(dev, dtype=torch.int64)
        # in place: a kernel already queued on this stream that reads the
        # slab runs before these copies, so no reader sees a torn slab
        self._x.index_copy_(0, idx, torch.from_numpy(xr_p).to(dev))
        self._y.index_copy_(0, idx, torch.from_numpy(yr_p).to(dev))
        self._mask.index_copy_(0, idx, torch.from_numpy(mr_p).to(dev))

    def arrays(self):
        """(x [cap, F] f32, y [cap] int32, mask [cap] f32) device views,
        contiguous, without the spare row."""
        if not self.ready:
            raise RuntimeError("slab store read before first upload")
        cap = self.capacity
        return self._x[:cap], self._y[:cap], self._mask[:cap]
