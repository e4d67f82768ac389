"""Read-only commit-log tailing for log-following read replicas (a copy
of kafka_ps_tpu/log/tail.py; its reader is serving/replica.py).

A replica process follows a training deployment's durable log without
ever attaching to the live fabric — and, critically, without ever
OPENING the log for writing.  `CommitLog`/`LogSegment` are the writer's
view: `LogSegment._recover()` truncates a torn tail on open, which is
correct crash recovery for the owner but data loss if a *reader* does
it to a live writer's file.  This module therefore never constructs
any of those classes; it opens segment files read-only and walks them
with `records.scan`, which stops cleanly at the first invalid record.
A torn tail (the writer mid-append) is simply re-read on the next
poll once the writer finishes the record.

Byte positions are tracked per segment file, so a poll does O(new
bytes) work: sealed segments are skipped by size, and the active
segment is read from the last consumed record boundary.  Segment roll
needs no special case — a new `*.log` file shows up in the directory
listing and starts at position 0.
"""

from __future__ import annotations

import os

from kafka_ps_tpu_torch.log import records


class PartitionTailer:
    """Incremental reader over one partition directory's segment files.

    `poll()` returns every record appended since the previous poll as
    `(offset, payload)` pairs, in log order.  Single-threaded by
    contract (one tailer per follower thread); holds no file handles
    between polls so the writer's retention/rename activity can never
    deadlock against us.
    """

    def __init__(self, path: str):
        self.path = path
        # segment basename -> next unread byte position (always a
        # record boundary: scan() only yields whole valid records)
        self._positions: dict[str, int] = {}

    def poll(self) -> list[tuple[int, bytes]]:
        out: list[tuple[int, bytes]] = []
        try:
            names = sorted(n for n in os.listdir(self.path)
                           if n.endswith(".log"))
        except FileNotFoundError:
            return out                  # partition not created yet
        for name in names:
            pos = self._positions.get(name, 0)
            full = os.path.join(self.path, name)
            try:
                if os.path.getsize(full) <= pos:
                    continue            # sealed or idle segment
                with open(full, "rb") as fh:
                    if pos:
                        fh.seek(pos)
                    buf = fh.read()
            except OSError:
                continue                # raced retention; retry next poll
            consumed = 0
            for offset, payload, rec_pos in records.scan(buf):
                out.append((offset, payload))
                consumed = rec_pos + records.HEADER_SIZE + len(payload)
            # anything past `consumed` is a torn tail (writer
            # mid-append) — leave the position at the record boundary
            # and re-read it next poll
            self._positions[name] = pos + consumed
        return out


class TopicTailer:
    """Tail every partition of one topic under a durable-log root.

    The layout is `root/<topic>/<key>/<segment>.log` (log/manager.py);
    partitions appear as workers join, so the directory is re-listed on
    every poll.  Records come back as `(key, offset, payload)`.
    """

    def __init__(self, root: str, topic: str = "weights"):
        self.root = root
        self.topic = topic
        self._partitions: dict[int, PartitionTailer] = {}

    def keys(self) -> tuple[int, ...]:
        return tuple(sorted(self._partitions))

    def poll(self) -> list[tuple[int, int, bytes]]:
        topic_dir = os.path.join(self.root, self.topic)
        try:
            names = os.listdir(topic_dir)
        except FileNotFoundError:
            return []
        for name in names:
            if name.isdigit() and int(name) not in self._partitions:
                self._partitions[int(name)] = PartitionTailer(
                    os.path.join(topic_dir, name))
        out: list[tuple[int, int, bytes]] = []
        for key in sorted(self._partitions):
            for offset, payload in self._partitions[key].poll():
                out.append((key, offset, payload))
        return out
