"""CommitLog — one (topic, key) partition (counterpart of
kafka_ps_tpu/log/log.py): a directory of segments with monotonic offsets,
segment roll and retention, and an fsync policy.

Append path: write to the active segment, roll to a new segment once it
reaches `segment_bytes`, fsync per policy.  Read path: pick the segment
whose base offset floors the target, sparse-index seek inside it, scan
forward.

Fsync policy:
  * "none"     — leave durability to the OS page cache (a machine crash
                 can lose recent records, a process crash cannot);
  * "interval" — fsync at most once per `fsync_interval_s` seconds,
                 checked on append (the default);
  * "always"   — fsync every append.

Retention deletes only segments that are BOTH rolled (not the active
segment) AND fully consumed: every record's offset is below the minimum
committed offset the caller passes in.  Nothing is deleted by age or
size alone.

One partition has one writer at a time: `lock` (reentrant) is held
across each append, flush, retention pass and close.  The JAX CommitLog
has no lock, and threads appending to one partition there can write two
records under one offset; a caller that must order its own step with
the append (the durable fabric's enqueue) holds `lock` around both.

The counters are plain integers on the object: appends, bytes appended,
segment rolls, fsyncs with their total and largest milliseconds, and
segments deleted by retention.  Telemetry (tracer=, telemetry=; null by
default) adds the JAX log's: `log.*` counts on the tracer,
`log_appends_total` and `log_fsync_ms` in the registry, and the flight
recorder's `log.append` / `log.fsync` records; each fsync is bracketed by
`FLIGHT.enter/exit("log.fsync")`, which the fsync watchdog reads.
"""

from __future__ import annotations

import bisect
import dataclasses
import os
import time

from kafka_ps_tpu_torch.analysis.lockgraph import OrderedLock
from kafka_ps_tpu_torch.log.segment import LogSegment, segment_basename
from kafka_ps_tpu_torch.telemetry.flight import FLIGHT
from kafka_ps_tpu_torch.telemetry.registry import NULL_TELEMETRY
from kafka_ps_tpu_torch.utils.trace import NULL_TRACER


@dataclasses.dataclass(frozen=True)
class LogConfig:
    """Knobs of one partition log (shared by every partition under a
    LogManager)."""

    segment_bytes: int = 16 * 1024 * 1024   # roll threshold
    index_interval_bytes: int = 4096        # sparse-index granularity
    fsync: str = "interval"                 # none | interval | always
    fsync_interval_s: float = 1.0

    def __post_init__(self):
        if self.fsync not in ("none", "interval", "always"):
            raise ValueError(f"unknown fsync policy {self.fsync!r}")
        if self.segment_bytes <= 0:
            raise ValueError("segment_bytes must be positive")


class CommitLog:
    """Segmented append-only log for one partition."""

    def __init__(self, directory: str, config: LogConfig | None = None,
                 name: str = "", tracer=None, telemetry=None):
        self.directory = directory
        self.config = config or LogConfig()
        self.tracer = tracer or NULL_TRACER
        self.telemetry = telemetry or NULL_TELEMETRY
        self._m_appends = self.telemetry.counter("log_appends_total")
        self._m_fsync_ms = self.telemetry.histogram("log_fsync_ms")
        self.name = name or directory
        self.lock = OrderedLock("CommitLog.lock", reentrant=True)
        os.makedirs(directory, exist_ok=True)
        self.segments: list[LogSegment] = []
        self.truncated_bytes = 0
        self.appends = 0
        self.bytes_appended = 0
        self.rolls = 0
        self.fsyncs = 0
        self.fsync_ms = 0.0
        self.fsync_ms_max = 0.0
        self.segments_deleted = 0
        self._last_fsync = time.monotonic()
        self._open_existing()

    def _open_existing(self) -> None:
        bases = sorted(int(f[:-4]) for f in os.listdir(self.directory)
                       if f.endswith(".log"))
        if not bases:
            bases = [0]
        # only the LAST segment can have a torn tail (earlier ones were
        # completed by a roll), but recovering each is cheap and also
        # rebuilds any stale index
        for base in bases:
            seg = LogSegment(self.directory, base,
                             self.config.index_interval_bytes)
            self.truncated_bytes += seg.truncated_bytes
            self.segments.append(seg)
        if self.truncated_bytes:
            self.tracer.count("log.truncated_bytes", self.truncated_bytes)

    # -- append ------------------------------------------------------------

    @property
    def active(self) -> LogSegment:
        return self.segments[-1]

    @property
    def next_offset(self) -> int:
        return self.active.next_offset

    @property
    def start_offset(self) -> int:
        """Oldest retained offset (retention may have deleted earlier
        segments)."""
        return self.segments[0].base_offset

    def append(self, payload: bytes) -> int:
        with self.lock:
            if self.active.size >= self.config.segment_bytes:
                self._roll()
            offset = self.active.append(payload)
            self.appends += 1
            self.bytes_appended += len(payload)
            self.tracer.count("log.appends")
            if self.telemetry.enabled:
                self._m_appends.inc()
            if FLIGHT.enabled:
                FLIGHT.record("log.append", log=self.name, offset=offset,
                              bytes=len(payload))
            self._maybe_fsync()
            return offset

    def _roll(self) -> None:
        self.active.flush(sync=self.config.fsync != "none")
        seg = LogSegment(self.directory, self.next_offset,
                         self.config.index_interval_bytes)
        self.segments.append(seg)
        self.rolls += 1
        self.tracer.count("log.segment_rolls")

    def _maybe_fsync(self) -> None:
        policy = self.config.fsync
        if policy == "none":
            self.active.flush(sync=False)
            return
        now = time.monotonic()
        if policy == "always" or \
                now - self._last_fsync >= self.config.fsync_interval_s:
            self._timed_fsync()
            self._last_fsync = now
        else:
            self.active.flush(sync=False)

    def _timed_fsync(self) -> None:
        """The single sync-flush site: its latency is the durability tax
        the fsync policy buys."""
        FLIGHT.enter("log.fsync")      # the watchdog sees a wedged call
        t0 = time.perf_counter()
        self.active.flush(sync=True)
        dt_ms = (time.perf_counter() - t0) * 1e3
        FLIGHT.exit("log.fsync")
        self.fsyncs += 1
        self.fsync_ms += dt_ms
        self.fsync_ms_max = max(self.fsync_ms_max, dt_ms)
        self.tracer.count("log.fsyncs")
        if self.telemetry.enabled:
            self._m_fsync_ms.observe(dt_ms)
        if FLIGHT.enabled:
            FLIGHT.record("log.fsync", log=self.name, ms=round(dt_ms, 3))

    def flush(self) -> None:
        """Force an fsync of the active segment regardless of policy —
        called at clean shutdown and at commit points."""
        with self.lock:
            self._timed_fsync()
            self._last_fsync = time.monotonic()

    # -- read --------------------------------------------------------------

    def read_from(self, offset: int):
        """Yield (offset, payload) for every retained record with
        offset >= `offset`, across segments, in order."""
        for i, seg in enumerate(self.segments):
            nxt = self.segments[i + 1].base_offset \
                if i + 1 < len(self.segments) else None
            if nxt is not None and nxt <= offset:
                continue               # fully below the target
            yield from seg.read_from(offset)

    def read_at(self, offset: int) -> bytes:
        """CRC-verified point read of the single record at `offset`.
        Raises KeyError for offsets below retention, past the tail, or
        failing CRC."""
        bases = [seg.base_offset for seg in self.segments]
        i = bisect.bisect_right(bases, offset) - 1
        if i < 0:
            raise KeyError(offset)     # below the retained start offset
        return self.segments[i].read_at(offset)

    @property
    def retained_bytes(self) -> int:
        """Bytes of the retained segment files (records and headers)."""
        return sum(seg.size for seg in self.segments)

    # -- retention ---------------------------------------------------------

    def apply_retention(self, min_committed_offset: int) -> int:
        """Delete segments that are rolled AND fully consumed (every
        offset < `min_committed_offset`).  Returns segments deleted."""
        deleted = 0
        with self.lock:
            while len(self.segments) > 1 and \
                    self.segments[1].base_offset <= min_committed_offset:
                self.segments.pop(0).delete()
                deleted += 1
            self.segments_deleted += deleted
        if deleted:
            self.tracer.count("log.segments_deleted", deleted)
        return deleted

    def close(self) -> None:
        with self.lock:
            self.active.flush(sync=self.config.fsync != "none")
            for seg in self.segments:
                seg.close()


def partition_dirname(topic: str, key: int) -> str:
    return os.path.join(topic, str(key))


__all__ = ["CommitLog", "LogConfig", "partition_dirname",
           "segment_basename"]
