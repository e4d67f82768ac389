"""LogManager — the broker-side registry (counterpart of
kafka_ps_tpu/log/manager.py): (topic, key) partitions on disk plus
consumer groups with durable committed offsets.

Directory layout under the root (`--durable-log DIR`), the JAX
package's:

    DIR/
      weights/0/00000000000000000000.log       one CommitLog per
      weights/0/00000000000000000000.index       (topic, key) partition
      gradients/0/...
      input-data/3/...
      offsets/server.json                       committed offsets per
      offsets/workers.json                        consumer group

A group's offset file maps "topic/key" -> next offset to consume, as an
atomically replaced JSON file.  Committing also drives retention:
segments below the minimum committed offset across ALL groups that track
a partition become deletable; partitions no group committed for are
never reaped.
"""

from __future__ import annotations

import json
import os
import threading

from kafka_ps_tpu_torch.log.log import CommitLog, LogConfig
from kafka_ps_tpu_torch.telemetry.registry import NULL_TELEMETRY
from kafka_ps_tpu_torch.utils.trace import NULL_TRACER


def partition_key(topic: str, key: int) -> str:
    return f"{topic}/{key}"


class LogManager:
    """Partition registry + consumer-group offset store over one root
    directory, for one process.  Partitions are created under a lock: the
    first sends of several worker threads to one partition must open one
    CommitLog, not one each.  `tracer` and `telemetry` (null by default)
    go to every partition's CommitLog."""

    def __init__(self, root: str, config: LogConfig | None = None,
                 tracer=None, telemetry=None):
        self.root = root
        self.config = config or LogConfig()
        self.tracer = tracer or NULL_TRACER
        self.telemetry = telemetry or NULL_TELEMETRY
        self._logs: dict[tuple[str, int], CommitLog] = {}
        self._lock = threading.Lock()
        self.commits = 0
        self._offsets_dir = os.path.join(root, "offsets")
        os.makedirs(self._offsets_dir, exist_ok=True)
        self._groups: dict[str, dict[str, int]] = {}
        for f in os.listdir(self._offsets_dir):
            if f.endswith(".json"):
                with open(os.path.join(self._offsets_dir, f)) as fh:
                    self._groups[f[:-5]] = {k: int(v) for k, v
                                            in json.load(fh).items()}
        # open every partition already on disk (recovery scans tails)
        for topic, key in self._discover():
            self.get(topic, key)

    def _discover(self):
        for topic in sorted(os.listdir(self.root)):
            tdir = os.path.join(self.root, topic)
            if topic == "offsets" or not os.path.isdir(tdir):
                continue
            for key in sorted(os.listdir(tdir)):
                if key.isdigit() and os.path.isdir(os.path.join(tdir, key)):
                    yield topic, int(key)

    # -- partitions --------------------------------------------------------

    def get(self, topic: str, key: int) -> CommitLog:
        log = self._logs.get((topic, key))
        if log is None:
            with self._lock:
                log = self._logs.get((topic, key))
                if log is None:
                    log = CommitLog(os.path.join(self.root, topic, str(key)),
                                    self.config,
                                    name=partition_key(topic, key),
                                    tracer=self.tracer,
                                    telemetry=self.telemetry)
                    self._logs[(topic, key)] = log
        return log

    def logs(self) -> list[tuple[tuple[str, int], CommitLog]]:
        """(topic, key) and log of every open partition, sorted."""
        with self._lock:
            return sorted(self._logs.items(), key=lambda kv: kv[0])

    def partitions(self, topic: str | None = None):
        """Known (topic, key) pairs, optionally filtered by topic."""
        return [tk for tk, _ in self.logs()
                if topic is None or tk[0] == topic]

    @property
    def truncated_bytes(self) -> int:
        """Corrupt tail bytes discarded across all partitions on open."""
        return sum(log.truncated_bytes for _, log in self.logs())

    # -- consumer groups ---------------------------------------------------

    def committed(self, group: str, topic: str, key: int) -> int:
        """Next offset `group` should consume for the partition (0 when
        the group never committed)."""
        return self._groups.get(group, {}).get(partition_key(topic, key), 0)

    def commit(self, group: str, offsets: dict[str, int]) -> None:
        """Durably record {"topic/key": next_offset} for `group` (atomic
        tmp+rename, like utils/checkpoint.py), then reap fully-consumed
        segments."""
        merged = self._groups.setdefault(group, {})
        merged.update({k: int(v) for k, v in offsets.items()})
        path = os.path.join(self._offsets_dir, f"{group}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(merged, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        self.commits += 1
        self.tracer.count("log.offset_commits")
        self.apply_retention()

    def apply_retention(self) -> int:
        """Delete segments every tracking group has fully consumed.
        Returns total segments deleted."""
        deleted = 0
        for (topic, key), log in self.logs():
            pk = partition_key(topic, key)
            tracked = [g[pk] for g in self._groups.values() if pk in g]
            if tracked:
                deleted += log.apply_retention(min(tracked))
        return deleted

    def flush(self) -> None:
        for _, log in self.logs():
            log.flush()

    def close(self) -> None:
        for _, log in self.logs():
            log.close()
