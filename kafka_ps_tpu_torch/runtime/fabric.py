"""In-process message fabric (counterpart of kafka_ps_tpu/runtime/fabric.py):
keyed FIFO queues standing in for the reference's Kafka topics.

WEIGHTS is keyed by worker id (point to point), GRADIENTS by 0 (the
single server's many-to-one gather).  Per-key FIFO order and buffering
are what the consistency models rely on; tests drive `poll` directly
for deterministic scheduling.  GANG carries the server's advisory gang
notices (runtime/gang.py), sent with `send_transient`: control traffic
with no reference topic, never made durable.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any

WEIGHTS_TOPIC = "weights"
GRADIENTS_TOPIC = "gradients"
GANG_TOPIC = "gang"


class Fabric:
    """Keyed FIFO queues with blocking and non-blocking consumption."""

    def __init__(self):
        self._queues: dict[tuple[str, int], deque] = {}
        self._cond = threading.Condition()

    def _q(self, topic: str, key: int) -> deque:
        return self._queues.setdefault((topic, key), deque())

    def send(self, topic: str, key: int, message: Any) -> None:
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

    def contains(self, topic: str, key: int, pred) -> bool:
        """True if any queued message matches pred (non-destructive)."""
        with self._cond:
            return any(pred(m) for m in self._q(topic, key))

    def pending(self, topic: str, key: int = 0) -> int:
        with self._cond:
            return len(self._q(topic, key))
