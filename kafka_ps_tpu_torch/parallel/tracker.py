"""Vector-clock bookkeeping (counterpart of
kafka_ps_tpu/parallel/tracker.py): the reference's
MessageTracker/MessageStatus (processors/MessageTracker.java:10-88), with
the membership hooks (evict, readmit) and the duplicate filter.

This is the consistency-model gate of the whole system: per worker it
tracks (vector clock, was-the-weights-reply-sent) and answers the three
gating predicates the server dispatches on.  The protocol sanitizers
(clock-mismatch raises, MessageTracker.java:22-35) are preserved as
ValueError — they are the reference's substitute for a race detector.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class MessageStatus:
    """One worker's slot (MessageTracker.java:10-40).  Starts at clock 0
    with the bootstrap broadcast counted as already sent
    (MessageTracker.java:47-53).

    `active=False` removes the worker from every gating predicate — the
    failure-detection hook (the reference has no app-level equivalent;
    it relies on Kafka consumer-group rebalancing, SURVEY §5)."""

    vector_clock: int = 0
    weights_message_sent: bool = True
    active: bool = True

    def sent_message(self, vector_clock: int) -> None:
        if self.vector_clock != vector_clock:
            raise ValueError(
                f"Expected value {self.vector_clock}, actual value {vector_clock}")
        self.weights_message_sent = True

    def received_message(self, vector_clock: int) -> None:
        if self.vector_clock != vector_clock:
            raise ValueError(
                f"Expected value {self.vector_clock}, actual value {vector_clock}")
        self.vector_clock += 1
        self.weights_message_sent = False


class MessageTracker:
    """Per-worker vector clocks + reply-pending flags (MessageTracker.java:42-88)."""

    def __init__(self, num_workers: int):
        self.num_workers = num_workers
        self.tracker = [MessageStatus() for _ in range(num_workers)]

    def received_message(self, worker: int, vector_clock: int) -> None:
        self.tracker[worker].received_message(vector_clock)

    def is_duplicate(self, worker: int, vector_clock: int) -> bool:
        """True iff a gradient stamped (worker, vector_clock) was already
        counted: a worker's clock only advances when its gradient for the
        current clock is applied, so any message below it is a
        redelivery.  Clocks AHEAD of the tracker still raise in
        received_message (the protocol sanitizer)."""
        return vector_clock < self.tracker[worker].vector_clock

    def sent_message(self, worker: int, vector_clock: int) -> None:
        self.tracker[worker].sent_message(vector_clock)

    def get_all_sendable_messages(self, max_delay: int) -> list[tuple[int, int]]:
        """(worker, clock) pairs with a pending reply whose next iteration
        is within max_delay of the slowest worker
        (MessageTracker.java:69-79)."""
        return [
            (worker, status.vector_clock)
            for worker, status in enumerate(self.tracker)
            if status.active
            and not status.weights_message_sent
            and self.has_received_all_messages(status.vector_clock - max_delay - 1)
        ]

    def has_received_all_messages(self, vector_clock: int) -> bool:
        """True iff every ACTIVE worker's gradient for iteration
        `vector_clock` has arrived, i.e. min active clock >=
        vector_clock + 1 (MessageTracker.java:81-87)."""
        return min(s.vector_clock for s in self.tracker
                   if s.active) >= vector_clock + 1

    # -- membership (failure detection / elastic recovery) -------------------

    @property
    def active_workers(self) -> list[int]:
        return [w for w, s in enumerate(self.tracker) if s.active]

    def deactivate_worker(self, worker: int) -> None:
        """Remove a failed worker from every gate: the sequential and
        bounded-delay models stop waiting for its gradients.  At least
        one worker must survive; the check runs BEFORE the mutation, so
        a concurrent reader (the producer's reroute in data_sink) never
        sees an empty active set."""
        if not any(s.active for w, s in enumerate(self.tracker)
                   if w != worker):
            raise ValueError("cannot deactivate the last active worker")
        self.tracker[worker].active = False

    def reactivate_worker(self, worker: int) -> int:
        """Readmit a worker at the slowest active clock (so no gate can
        regress) with its reply pending.  Returns the join clock: the
        caller sends it a fresh WeightsMessage at that clock."""
        join_clock = min(s.vector_clock for s in self.tracker if s.active)
        status = self.tracker[worker]
        status.active = True
        status.vector_clock = join_clock
        status.weights_message_sent = False
        return join_clock

    @property
    def clocks(self) -> list[int]:
        return [s.vector_clock for s in self.tracker]
