"""Staleness-bounded reads for the serving plane (a copy of
kafka_ps_tpu/serving/policy.py).

Training offers three consistency models (utils/config.py): SEQUENTIAL
(BSP), bounded delay k (SSP) and EVENTUAL (ASP).  A prediction request
picks the read-side mirror of the same trade-off:

    read bound                      training analogue
    ------------------------------  --------------------------------
    no bound (EVENTUAL_READ)        EVENTUAL: newest snapshot, any age
    max_age_s=T                     bounded delay: tolerate staleness
                                    up to a wall-clock budget
    min_clock=c                     SEQUENTIAL-ish: refuse weights
                                    older than a known training clock

The registry always serves its NEWEST snapshot; a bound can only reject
it, never select an older one (an older snapshot satisfies strictly
weaker bounds, so if the newest fails nothing else can pass).  The one
exception is `at_clock`, an audit mode that pins an exact historical
clock from the snapshot ring.

No imports beyond the standard library: transport code (runtime/net.py)
and thin clients raise and catch these errors without torch.
"""

from __future__ import annotations

from dataclasses import dataclass


class StalenessError(RuntimeError):
    """No snapshot satisfies the request's read bound.  Carries the bound
    that failed and what was available, so callers and the wire protocol
    can report how stale the read was."""

    def __init__(self, message: str, *, min_clock=None, max_age_s=None,
                 have_clock=None, have_age_s=None):
        super().__init__(message)
        self.min_clock = min_clock
        self.max_age_s = max_age_s
        self.have_clock = have_clock
        self.have_age_s = have_age_s


class OverloadedError(RuntimeError):
    """The engine shed this request at admission instead of queueing it
    past any chance of meeting its deadline.  Typed (not a timeout, not a
    StalenessError), so transports map it to the OVERLOADED wire status
    and clients can tell "back off and retry elsewhere" from a staleness
    rejection or a failure.  Carries the admission queue's state."""

    def __init__(self, message: str, *, queue_depth=None, queue_limit=None,
                 model_id=None):
        super().__init__(message)
        self.queue_depth = queue_depth
        self.queue_limit = queue_limit
        self.model_id = model_id


@dataclass(frozen=True)
class ReadBound:
    """What a prediction request demands of the snapshot it reads.

    min_clock  the snapshot's vector clock must be >= this (None: any)
    max_age_s  the snapshot's wall-clock age must be <= this (None: any)
    at_clock   exact-clock audit read from the snapshot ring; the other
               two fields still apply to the pinned snapshot
    """

    min_clock: int | None = None
    max_age_s: float | None = None
    at_clock: int | None = None

    @property
    def unbounded(self) -> bool:
        return (self.min_clock is None and self.max_age_s is None
                and self.at_clock is None)


# the ASP-flavoured default: serve whatever is newest
EVENTUAL_READ = ReadBound()


def fresh(min_clock: int) -> ReadBound:
    """Refuse anything older than a known training clock."""
    return ReadBound(min_clock=min_clock)


def bounded(max_age_s: float) -> ReadBound:
    """Tolerate staleness up to a wall-clock budget."""
    return ReadBound(max_age_s=max_age_s)


def check(snapshot, bound: ReadBound | None, now: float) -> None:
    """Raise StalenessError unless `snapshot` satisfies `bound`.
    `snapshot` is a serving.snapshot.Snapshot, or None (nothing published
    yet: every bound, the empty one included, rejects that)."""
    if snapshot is None:
        raise StalenessError(
            "no snapshot published yet",
            min_clock=None if bound is None else bound.min_clock,
            max_age_s=None if bound is None else bound.max_age_s)
    b = bound or EVENTUAL_READ
    if b.min_clock is not None and snapshot.vector_clock < b.min_clock:
        raise StalenessError(
            f"snapshot clock {snapshot.vector_clock} < required "
            f"min_clock {b.min_clock}",
            min_clock=b.min_clock, have_clock=snapshot.vector_clock)
    if b.max_age_s is not None:
        age = now - snapshot.wall_time
        if age > b.max_age_s:
            raise StalenessError(
                f"snapshot age {age:.3f}s > allowed max_age_s "
                f"{b.max_age_s:.3f}s",
                max_age_s=b.max_age_s, have_age_s=age,
                have_clock=snapshot.vector_clock)
