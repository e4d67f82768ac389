"""In-process message fabric (counterpart of kafka_ps_tpu/runtime/fabric.py):
keyed FIFO queues standing in for the reference's Kafka topics.

WEIGHTS is keyed by worker id (point to point), GRADIENTS by 0 (the
single server's many-to-one gather).  Per-key FIFO order and buffering
are what the consistency models rely on; tests drive `poll` directly
for deterministic scheduling.  INPUT_DATA names the stream rows' topic,
which only a durable fabric logs (log/durable_fabric.py).  GANG carries
the server's advisory gang notices (runtime/gang.py), sent with
`send_transient`: control traffic with no reference topic, never made
durable.  A tracer (null by default) counts the sends per topic,
`send.<topic>`: the message-flow view.
"""

from __future__ import annotations

from collections import deque
from typing import Any

from kafka_ps_tpu_torch.analysis.lockgraph import OrderedCondition
from kafka_ps_tpu_torch.utils.trace import NULL_TRACER

WEIGHTS_TOPIC = "weights"
GRADIENTS_TOPIC = "gradients"
INPUT_DATA_TOPIC = "input-data"
GANG_TOPIC = "gang"


class Fabric:
    """Keyed FIFO queues with blocking and non-blocking consumption."""

    durable = False              # log/durable_fabric.DurableFabric: True

    def __init__(self, tracer=None):
        self._queues: dict[tuple[str, int], deque] = {}
        self._cond = OrderedCondition(f"{type(self).__name__}.cond")
        self._tracer = tracer or NULL_TRACER

    def _q(self, topic: str, key: int) -> deque:
        return self._queues.setdefault((topic, key), deque())

    def send(self, topic: str, key: int, message: Any) -> None:
        self._tracer.count(f"send.{topic}")
        with self._cond:
            self._q(topic, key).append(message)
            self._cond.notify_all()

    def send_transient(self, topic: str, key: int, message: Any) -> None:
        """Enqueue advisory traffic (gang notices) that a durable fabric
        must neither log nor serialize.  Identical to `send` here."""
        self.send(topic, key, message)

    def poll(self, topic: str, key: int = 0) -> Any | None:
        """Non-blocking: next message for (topic, key) or None."""
        with self._cond:
            q = self._q(topic, key)
            return q.popleft() if q else None

    def poll_blocking(self, topic: str, key: int = 0,
                      timeout: float | None = None) -> Any | None:
        with self._cond:
            q = self._q(topic, key)
            if not q:
                self._cond.wait_for(lambda: bool(q), timeout=timeout)
            return q.popleft() if q else None

    def purge(self, topic: str, key: int, pred) -> int:
        """Remove queued messages matching pred; returns how many (an
        evicted worker's in-flight messages are drained on readmission)."""
        with self._cond:
            q = self._q(topic, key)
            kept = [m for m in q if not pred(m)]
            removed = len(q) - len(kept)
            q.clear()
            q.extend(kept)
            return removed

    def contains(self, topic: str, key: int, pred) -> bool:
        """True if any queued message matches pred (non-destructive)."""
        with self._cond:
            return any(pred(m) for m in self._q(topic, key))

    def pending(self, topic: str, key: int = 0) -> int:
        with self._cond:
            return len(self._q(topic, key))

    def total_pending(self, topic: str) -> int:
        """Queued messages of `topic` over all its keys (the status
        line's pending counts)."""
        with self._cond:
            return sum(len(q) for (t, _), q in self._queues.items()
                       if t == topic)
