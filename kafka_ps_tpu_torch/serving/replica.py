"""Log-following read replicas (counterpart of
kafka_ps_tpu/serving/replica.py).

A replica is a serving process that never joins the training fabric: it
tails the durable commit log's WEIGHTS partitions (log/tail.py, strictly
read-only, never truncating a live writer's torn tail) and republishes
what it reads into a local `SnapshotRegistry`, which a stock
`PredictionEngine` serves from.  Read traffic scales by adding replica
processes; the training deployment never sees an extra syscall, the only
coupling being the filesystem the log lives on.  The weights it reads
are decoded onto the replica's device (`device`, resolved like every
entry point's: the card unless the caller asks for the CPU).

Two deployment shapes, told apart by the log directory's layout:

  * one server: `DIR/weights/<worker>/...`.  Every weights message
    carries the full theta, so the replica publishes the newest message
    by vector clock (the rule of `DurableFabric.latest_logged_weights`,
    kept incrementally);
  * range-sharded (`--shards N`): `DIR/shard<i>of<N>/weights/...`.  Each
    shard logs its own key range.  The replica keeps the newest slice per
    shard and publishes through `FrontierCutPublisher`, so a served
    snapshot is always a consistent CUT stamped with the frontier clock
    (the minimum per-shard clock), never a torn mix of shard states.  A
    shard process of the split deployment does not serve itself
    (cli/socket_mode.run_server_shard refuses --serve): the replica is
    how such a deployment answers reads.

A replica may start before the deployment has made its log directories:
until it has read a record it looks for shard directories at every poll.

Snapshots published here keep the staleness rules of serving/policy.py:
`min_clock` bounds at or below the frontier are satisfiable, `max_age_s`
runs off the replica's publication time, and `at_clock` reads hit the
replica's own ring.

Telemetry, the JAX follower's: the tracer's `replica.publications` count
(`tracer=`), a `replica.publish` flight record per publication, and a
`replica` beat on every poll of the tail thread, data or not (the replica
watchdog asks whether the loop turns, not whether the trainer produces).
"""

from __future__ import annotations

import os
import re
import threading

import torch

from kafka_ps_tpu_torch.log.tail import TopicTailer
from kafka_ps_tpu_torch.runtime import serde
from kafka_ps_tpu_torch.serving.snapshot import (FrontierCutPublisher,
                                                 SnapshotRegistry)
from kafka_ps_tpu_torch.telemetry.flight import FLIGHT
from kafka_ps_tpu_torch.utils.config import (canonical_device,
                                             resolve_device)

_SHARD_DIR = re.compile(r"^shard(\d+)of(\d+)$")


def discover_shards(root: str) -> list[tuple[int, str]]:
    """[(shard_id, shard_log_dir), ...] for a split deployment's log
    root, or [] when `root` is an unsharded (one-server) log."""
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return []
    out = []
    for name in names:
        m = _SHARD_DIR.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(root, name)))
    return sorted(out)


class ReplicaFollower:
    """Follow a durable log's weights partitions into a registry.

    `catch_up()` is the synchronous unit of work (poll every tailer once,
    publish what advanced); tests and cold starts call it directly.
    `start()` runs it on a background thread every `poll_interval_s`
    until `stop()`; an exception ends the thread and is kept in `error`
    (a replica that stopped following must not go on serving as if it
    did)."""

    def __init__(self, root: str, registry: SnapshotRegistry | None = None,
                 *, poll_interval_s: float = 0.05, device=None,
                 tracer=None):
        self.root = root
        self.tracer = tracer
        self.registry = registry if registry is not None \
            else SnapshotRegistry()
        self.poll_interval_s = poll_interval_s
        # the tail thread makes this card current: name it
        self.device = canonical_device(resolve_device(device))
        # one driver advances the follower: the tail thread, or a caller's
        # catch_up loop
        # pscheck: disable=PS201 (exactly one driver - the tail thread or a manual catch_up loop - advances the follower)
        self.records_read = 0
        # pscheck: disable=PS201 (exactly one driver - the tail thread or a manual catch_up loop - advances the follower)
        self.publications = 0
        # unsharded until `root` shows shard directories (_discover)
        # pscheck: disable=PS201 (exactly one driver - the tail thread or a manual catch_up loop - advances the follower)
        self.num_shards = 0
        # pscheck: disable=PS201 (exactly one driver - the tail thread or a manual catch_up loop - advances the follower)
        self._tailers = {0: TopicTailer(root)}
        # pscheck: disable=PS201 (exactly one driver - the tail thread or a manual catch_up loop - advances the follower)
        self._cut = None
        self._discover()
        # newest (values, clock, range start) per shard; a cut publishes
        # once every shard has reported
        # pscheck: disable=PS201 (exactly one driver - the tail thread or a manual catch_up loop - advances the follower)
        self._newest: dict[int, tuple] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # the exception that ended the tail thread, if one did
        self.error: BaseException | None = None
        # Callable[[int], None], called (on the follower's thread) with
        # the new clock after every publication: a replica started on an
        # empty log warms its engine when theta first appears
        self.on_publish = None

    def _discover(self) -> None:
        """Take the sharded layout when `root` holds `shard<i>of<N>`
        directories: one tailer for each of the N shards, a directory not
        made yet being an empty partition."""
        counts = {int(_SHARD_DIR.match(os.path.basename(path)).group(2))
                  for _sid, path in discover_shards(self.root)}
        if not counts:
            return
        if len(counts) > 1:
            raise ValueError(f"{self.root} holds the logs of deployments "
                             f"of {sorted(counts)} shards")
        n = counts.pop()
        self.num_shards = n
        self._tailers = {sid: TopicTailer(os.path.join(self.root,
                                                       f"shard{sid}of{n}"))
                         for sid in range(n)}
        self._cut = FrontierCutPublisher(self.registry)

    # -- synchronous follow --------------------------------------------------

    def catch_up(self) -> int:
        """Poll every partition once; publish when the log advanced.
        Returns the number of snapshots published (0 or 1)."""
        if self.num_shards == 0 and self.records_read == 0:
            # a replica may start before the deployment makes its log
            # directories: the layout is open until a record is read
            self._discover()
        advanced = False
        for sid, tailer in self._tailers.items():
            for _key, _offset, payload in tailer.poll():
                self.records_read += 1
                msg = serde.from_bytes(payload, device=self.device)
                have = self._newest.get(sid)
                if have is None or msg.vector_clock > have[1]:
                    self._newest[sid] = (msg.values, msg.vector_clock,
                                         msg.key_range.start)
                    advanced = True
        if not advanced:
            return 0
        published = 0
        if self._cut is not None:
            if len(self._newest) == self.num_shards:
                # the concatenation must tile the key space in order
                cut = [(values, clock) for values, clock, _start
                       in sorted(self._newest.values(),
                                 key=lambda t: t[2])]
                if self._cut.maybe_publish(cut) is not None:
                    published = 1
        else:
            values, clock, _start = self._newest[0]
            latest = self.registry.latest
            if latest is None or clock > latest.vector_clock:
                self.registry.publish(values, clock)
                published = 1
        if published:
            self.publications += 1
            if self.tracer is not None:
                self.tracer.count("replica.publications")
            if FLIGHT.enabled:
                FLIGHT.record("replica.publish",
                              clock=self.registry.latest.vector_clock)
            if self.on_publish is not None:
                self.on_publish(self.registry.latest.vector_clock)
        return published

    @property
    def clock(self) -> int | None:
        latest = self.registry.latest
        return None if latest is None else latest.vector_clock

    # -- background follow ---------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("replica follower already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._follow, daemon=True,
                                        name="kps-replica-tail")
        self._thread.start()

    def _follow(self) -> None:
        try:
            if self.device.type == "cuda":
                # decodes land on the replica's card from this thread
                torch.cuda.set_device(self.device)
            while not self._stop.is_set():
                self.catch_up()
                FLIGHT.beat("replica")
                self._stop.wait(self.poll_interval_s)
        except Exception as e:  # noqa: BLE001 — kept for the caller
            self.error = e

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=timeout)

