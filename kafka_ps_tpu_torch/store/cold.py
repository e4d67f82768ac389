"""Cold tier: parameter pages as CRC-framed records in a commit log
(counterpart of kafka_ps_tpu/store/cold.py).

The durable commit log (log/) is an offset-indexed record store:
`CommitLog.append` returns a stable offset and `CommitLog.read_at` is a
CRC-verified point read through the sparse index.  A demoted page is one
appended record and a fault is one point read, so cold pages share the
log's durability: a torn tail is truncated on recovery, and a damaged
record raises KeyError instead of returning wrong floats.  No consumer
group commits the `param-cold` partition, so retention never reaps it.

Record payload: a `<qqq>` header (page index, key start, key end) and
the page's raw little-endian float32 bytes, the JAX package's record:
each package reads the other's cold partition.  `get` checks the header
against what the caller expects and raises KeyError on a mismatch.

Demotions of one page accumulate records; only the offset the residency
table holds is live.  A checkpoint restore demotes recorded-cold pages
again with fresh appends (store/tiered.py `set_residency`), so a
checkpoint never refers to records written before it.

A point read holds the partition's lock, so it never interleaves with
the policy thread's append to the same file.
"""

from __future__ import annotations

import struct

import numpy as np

from kafka_ps_tpu_torch.log.log import CommitLog, LogConfig

_HDR = struct.Struct("<qqq")        # page index, key start, key end


class ColdStore:
    """Offset-addressed page storage over one CommitLog partition."""

    def __init__(self, log: CommitLog):
        self.log = log
        self._owned = False
        self.appends = 0
        self.reads = 0

    @classmethod
    def open(cls, directory: str, config: LogConfig | None = None
             ) -> "ColdStore":
        """A cold partition of its own (a run's `param-cold` directory,
        tests); `close()` then closes the log too."""
        store = cls(CommitLog(directory, config or LogConfig(fsync="none"),
                              name="param-cold"))
        store._owned = True
        return store

    def put(self, page: int, start: int, end: int,
            values: np.ndarray) -> int:
        """Append one page record; returns its log offset, the only
        handle the residency table keeps."""
        vals = np.ascontiguousarray(values, dtype=np.float32)
        if vals.shape != (end - start,):
            raise ValueError(
                f"page {page} [{start}, {end}) expects {end - start} "
                f"values, got shape {vals.shape}")
        self.appends += 1
        return self.log.append(_HDR.pack(page, start, end)
                               + vals.astype("<f4", copy=False).tobytes())

    def get(self, offset: int, page: int, start: int, end: int
            ) -> np.ndarray:
        """CRC-verified point read of the page record at `offset`; the
        stored header must match what the caller expects."""
        with self.log.lock:
            payload = self.log.read_at(offset)
        p, s, e = _HDR.unpack_from(payload, 0)
        if (p, s, e) != (page, start, end):
            raise KeyError(
                f"cold record at offset {offset} is page {p} "
                f"[{s}, {e}), wanted page {page} [{start}, {end})")
        self.reads += 1
        return np.frombuffer(payload, "<f4", count=e - s,
                             offset=_HDR.size).astype(np.float32)

    def close(self) -> None:
        if self._owned:
            self.log.close()
