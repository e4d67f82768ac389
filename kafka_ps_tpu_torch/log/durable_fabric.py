"""DurableFabric — the in-process fabric backed by the commit log
(counterpart of kafka_ps_tpu/log/durable_fabric.py).

Same API as `runtime/fabric.Fabric` (send / poll / poll_blocking / purge
/ contains / pending), so every drive loop and node runs unchanged; each
send also appends the message's binary serde frame (runtime/serde.py) to
the partition's CommitLog, and each poll records the delivered offset.

Consumer groups (one per consuming role):

    gradients  -> "server"
    weights    -> "workers"  (one offset entry per worker key)
    input-data -> "ingest"   (rows are consumed into buffers at persist
                              time; the offset marks ingestion)

Offsets are committed at checkpoint boundaries (`snapshot_offsets` →
checkpoint → `commit`), not per message: the checkpoint and the
committed offsets describe the same instant, and recovery is "load the
checkpoint, replay the tail past its offsets".  Replay is at least once;
the server drops a gradient whose clock it already applied
(runtime/server.py), so each delta is applied exactly once.

A partition's append and its enqueue happen under the partition log's
lock, so its queue order is its offset order and a delivered offset
covers every record before it: `snapshot_offsets` is truthful with any
number of sending threads.  (The JAX fabric appends outside its lock,
so two threads can enqueue in one order and append in the other.)

Frames are encoded before the lock is taken: a CUDA tensor's copy to
the host waits for the kernel that produced it, on the sender's thread.
A gate release sends one θ to several workers: the frame of a weights
message whose values (and encoding) are the previous one's tensor, at
the same clock and range, is reused instead of copied again.

Replayed tensors land on `device` (utils.config.resolve_device: the card
unless the caller asks for the CPU).

Telemetry (tracer=, telemetry=; null by default): `send.<topic>` per
send, `log.replays.<topic>` and `log_replays_total{topic}` per replayed
message, and the partitions' CommitLogs get both (log/log.py).
"""

from __future__ import annotations

import os
import threading
import time

from kafka_ps_tpu_torch.log.log import LogConfig
from kafka_ps_tpu_torch.log.manager import LogManager, partition_key
from kafka_ps_tpu_torch.runtime import serde
from kafka_ps_tpu_torch.runtime.fabric import (GRADIENTS_TOPIC,
                                               INPUT_DATA_TOPIC,
                                               WEIGHTS_TOPIC, Fabric)
from kafka_ps_tpu_torch.runtime.messages import WeightsMessage
from kafka_ps_tpu_torch.telemetry.registry import NULL_TELEMETRY
from kafka_ps_tpu_torch.utils.config import resolve_device

# consuming role per topic (the consumer-group ids on disk)
GROUP_OF_TOPIC = {
    GRADIENTS_TOPIC: "server",
    WEIGHTS_TOPIC: "workers",
    INPUT_DATA_TOPIC: "ingest",
}

# Directory name reserved under the durable root for a tiered store's
# cold partition.  Not a fabric topic: its records are raw page bytes,
# no consumer group commits offsets for it, and recovery never replays
# it into the message queues.
COLD_PARTITION_DIR = "param-cold"


class DurableFabric(Fabric):
    """Keyed FIFO fabric whose every message is also a durable,
    offset-addressed log record."""

    durable = True

    def __init__(self, root: str, config: LogConfig | None = None,
                 device=None, tracer=None, telemetry=None):
        super().__init__(tracer)
        self.device = resolve_device(device)
        telemetry = telemetry or NULL_TELEMETRY
        self._telemetry = telemetry
        self._m_replays = {
            t: telemetry.counter("log_replays_total", topic=t)
            for t in (WEIGHTS_TOPIC, GRADIENTS_TOPIC)}
        self.manager = LogManager(root, config, tracer=self._tracer,
                                  telemetry=telemetry)
        # next undelivered offset per partition; starts at the replay
        # position set by recover() and advances on every poll
        self._delivered: dict[tuple[str, int], int] = {}
        self._recovered = False
        # held by a commit point (server.save_checkpoint_now) while it
        # snapshots offsets and state, and by the app's ingestion around
        # persist + buffer insert + mark_consumed: a checkpoint's buffers
        # and its ingest offsets then describe the same rows
        self.commit_lock = threading.Lock()
        # (msg, payload) of the newest weights frame
        self._last_weights = None
        self._stats_lock = threading.Lock()
        # per topic: frames encoded and host seconds in serde.to_bytes
        self.frames: dict[str, int] = {}
        self.serde_s: dict[str, float] = {}
        self.frames_shared = 0       # weights frames reused for a release
        self.commits = 0

    def cold_dir(self) -> str:
        """The reserved cold-partition directory under this fabric's
        root: one `--durable-log DIR` holds the message log and a tiered
        store's cold pages (store/cold.py)."""
        return os.path.join(self.manager.root, COLD_PARTITION_DIR)

    # -- producer side -----------------------------------------------------

    def _frame(self, topic: str, message) -> bytes:
        last = self._last_weights
        if (last is not None and type(message) is WeightsMessage
                and message.values is last[0].values
                and message.encoded is last[0].encoded
                and message.vector_clock == last[0].vector_clock
                and message.key_range == last[0].key_range):
            with self._stats_lock:
                self.frames_shared += 1
            return last[1]
        t0 = time.perf_counter()
        payload = serde.to_bytes(message)
        dt = time.perf_counter() - t0
        if type(message) is WeightsMessage:
            self._last_weights = (message, payload)
        with self._stats_lock:
            self.frames[topic] = self.frames.get(topic, 0) + 1
            self.serde_s[topic] = self.serde_s.get(topic, 0.0) + dt
        return payload

    def send(self, topic: str, key: int, message) -> None:
        payload = self._frame(topic, message)
        self._tracer.count(f"send.{topic}")
        log = self.manager.get(topic, key)
        with log.lock:
            offset = log.append(payload)
            with self._cond:
                self._q(topic, key).append((offset, message))
                self._cond.notify_all()

    def send_transient(self, topic: str, key: int, message) -> None:
        """Enqueue WITHOUT logging: advisory in-process traffic (gang
        notices) that has no serde frame and must not survive a restart —
        a replayed notice would promise weights messages whose delivery
        already happened.  Queued as (None, message); polls skip the
        offset bookkeeping for such entries."""
        self._tracer.count(f"send.{topic}")
        with self._cond:
            self._q(topic, key).append((None, message))
            self._cond.notify_all()

    def persist(self, topic: str, key: int, message) -> int:
        """Append to the log WITHOUT enqueueing — for traffic the caller
        consumes at send time (the INPUT_DATA hop: the producer sinks the
        row straight into a buffer).  The caller marks the offset
        consumed with `mark_consumed` once the row is applied."""
        offset = self.append_frame(topic, key, self._frame(topic, message))
        self._tracer.count(f"send.{topic}")
        return offset

    def append_frame(self, topic: str, key: int, frame: bytes) -> int:
        """`persist` of a message its caller already framed with
        `_frame` (a socket bridge that sends the same bytes)."""
        return self.manager.get(topic, key).append(frame)

    def mark_consumed(self, topic: str, key: int, offset: int) -> None:
        with self._cond:
            self._delivered[(topic, key)] = offset + 1

    # -- consumer side -----------------------------------------------------

    def _pop(self, topic: str, key: int, q):
        offset, msg = q.popleft()
        if offset is not None:           # transient entries have no offset
            self._delivered[(topic, key)] = offset + 1
        return msg

    def poll(self, topic: str, key: int = 0):
        with self._cond:
            q = self._q(topic, key)
            return self._pop(topic, key, q) if q else None

    def poll_blocking(self, topic: str, key: int = 0,
                      timeout: float | None = None):
        with self._cond:
            q = self._q(topic, key)
            if not q:
                self._cond.wait_for(lambda: bool(q), timeout=timeout)
            return self._pop(topic, key, q) if q else None

    def purge(self, topic: str, key: int, pred) -> int:
        return super().purge(topic, key, lambda e: pred(e[1]))

    def contains(self, topic: str, key: int, pred) -> bool:
        return super().contains(topic, key, lambda e: pred(e[1]))

    # -- offsets / recovery ------------------------------------------------

    def snapshot_offsets(self) -> dict[str, int]:
        """{"topic/key": next undelivered offset} — the instant a
        checkpoint covers, taken under the fabric lock."""
        with self._cond:
            return {partition_key(t, k): off
                    for (t, k), off in sorted(self._delivered.items())}

    def commit(self, offsets: dict[str, int] | None = None) -> None:
        """Durably commit consumer offsets (defaults to the current
        snapshot), fsync the logs up to them, and reap fully-consumed
        segments."""
        offsets = offsets if offsets is not None else self.snapshot_offsets()
        self.manager.flush()
        by_group: dict[str, dict[str, int]] = {}
        for pk, off in offsets.items():
            topic = pk.split("/", 1)[0]
            group = GROUP_OF_TOPIC.get(topic, topic)
            by_group.setdefault(group, {})[pk] = off
        for group, offs in by_group.items():
            self.manager.commit(group, offs)
        self.commits += 1

    def start_offset(self, topic: str, key: int,
                     checkpoint_offsets: dict[str, int] | None) -> int:
        """Where replay starts for a partition: the checkpoint's recorded
        offset when one is given (it matches the restored state), else
        the group's durably committed offset, else 0 (full replay)."""
        pk = partition_key(topic, key)
        if checkpoint_offsets is not None and pk in checkpoint_offsets:
            return int(checkpoint_offsets[pk])
        return self.manager.committed(GROUP_OF_TOPIC.get(topic, topic),
                                      topic, key)

    def replay(self, topic: str, key: int,
               checkpoint_offsets: dict[str, int] | None = None):
        """Yield (offset, message) for the unconsumed tail of a partition,
        decoded onto this fabric's device."""
        start = self.start_offset(topic, key, checkpoint_offsets)
        for offset, payload in self.manager.get(topic, key).read_from(start):
            yield offset, serde.from_bytes(payload, self.device)

    def latest_logged_weights(self):
        """The newest logged WeightsMessage (by vector clock) across all
        WEIGHTS partitions, or None when none was ever logged: what a
        restarting serving process publishes first when it is ahead of
        the restored checkpoint."""
        best = None
        for topic, key in self.manager.partitions(WEIGHTS_TOPIC):
            last_payload = None
            for _offset, payload in self.manager.get(topic,
                                                     key).read_from(0):
                last_payload = payload   # per-partition clocks ascend
            if last_payload is None:
                continue
            msg = serde.from_bytes(last_payload, self.device)
            if best is None or msg.vector_clock > best.vector_clock:
                best = msg
        return best

    def recover(self, checkpoint_offsets: dict[str, int] | None = None
                ) -> dict[str, int]:
        """Re-enqueue the unconsumed WEIGHTS / GRADIENTS tail into the
        in-memory queues (crash recovery: a restarted process sees the
        in-flight messages the dead one had).  INPUT_DATA is not
        enqueued — the app replays it into buffers itself
        (runtime/app.StreamingPSApp.recover_durable).  Returns replay
        counts per topic.

        A gate release aliases one θ into several workers' partitions;
        byte-identical weights payloads decode to ONE message, so the
        replay holds one device copy per release, not one per worker.
        The gang's kernels take a pointer per member, so results do not
        depend on that sharing."""
        if self._recovered:
            raise RuntimeError("recover() must run once, before the "
                               "drive loop")
        self._recovered = True
        counts = {WEIGHTS_TOPIC: 0, GRADIENTS_TOPIC: 0}
        weights_cache: dict[bytes, object] = {}
        with self._cond:
            for topic, key in self.manager.partitions():
                if topic == COLD_PARTITION_DIR:   # raw page bytes, not
                    continue                      # serde frames
                start = self.start_offset(topic, key, checkpoint_offsets)
                self._delivered[(topic, key)] = start
                if topic == INPUT_DATA_TOPIC:
                    continue
                q = self._q(topic, key)
                for offset, payload in \
                        self.manager.get(topic, key).read_from(start):
                    if topic == WEIGHTS_TOPIC:
                        msg = weights_cache.get(payload)
                        if msg is None:
                            msg = serde.from_bytes(payload, self.device)
                            weights_cache[payload] = msg
                    else:
                        msg = serde.from_bytes(payload, self.device)
                    q.append((offset, msg))
                    counts[topic] = counts.get(topic, 0) + 1
                    self._tracer.count(f"log.replays.{topic}")
                    if self._telemetry.enabled:
                        self._m_replays[topic].inc()
            self._cond.notify_all()
        return counts

    def stats(self) -> dict:
        """The log's counters: appends and bytes per topic, fsyncs and
        their milliseconds, segment rolls and segments reaped by
        retention, commit points, retained bytes on disk, and per topic
        the frames encoded and serde milliseconds per encoded frame."""
        appends: dict[str, int] = {}
        nbytes: dict[str, int] = {}
        logs = [log for _, log in self.manager.logs()]
        for (topic, _), log in self.manager.logs():
            appends[topic] = appends.get(topic, 0) + log.appends
            nbytes[topic] = nbytes.get(topic, 0) + log.bytes_appended
        return {"appends": appends, "bytes": nbytes,
                "fsyncs": sum(log.fsyncs for log in logs),
                "fsync_ms": sum(log.fsync_ms for log in logs),
                "fsync_ms_max": max((log.fsync_ms_max for log in logs),
                                    default=0.0),
                "rolls": sum(log.rolls for log in logs),
                "segments_reaped": sum(log.segments_deleted
                                       for log in logs),
                "commits": self.commits,
                "retained_bytes": sum(log.retained_bytes for log in logs),
                "frames": dict(self.frames),
                "frames_shared": self.frames_shared,
                "serde_ms_per_frame": {t: 1e3 * self.serde_s[t] / n
                                       for t, n in self.frames.items()}}

    def close(self) -> None:
        self.manager.close()
