"""Protocol conformance validation — the race/staleness auditor (a copy of
kafka_ps_tpu/evaluation/validate.py: host code over pandas, no torch).

The reference's only protocol safety nets are runtime assertions inside
MessageTracker (clock-mismatch throws, MessageTracker.java:22-35 — its
substitute for a race detector, SURVEY §5).  This module audits a
finished run's logs against the consistency contract itself:

  * per-worker vector clocks advance by exactly +1 (no lost or
    duplicated iterations);
  * the cross-worker staleness bound holds at every moment:
    log-visible spread ≤ consistency_model + 1 (eventual −1:
    unbounded, no check);
  * the server's evaluation clock never regresses.

Derivation of the bound: the gate releases weights clock c to a worker
iff every gradient for iteration c − k − 1 has arrived, i.e. the
slowest tracker clock m ≥ c − k (MessageTracker.java:69-87,
parallel/tracker.py).  A tracker clock of m means that worker's last
*logged* iteration is m − 1 (it logs c while processing weights c,
before its gradient advances the tracker), so the spread between log
lines is ≤ (c) − (m − 1) ≤ k + 1.  Sequential is k = 0 → spread ≤ 1.
Usage:

  python -m kafka_ps_tpu_torch.evaluation validate \\
      --worker logs-worker.csv --server logs-server.csv -c 10
"""

from __future__ import annotations

import dataclasses
import warnings

import pandas as pd

from kafka_ps_tpu_torch.utils.config import EVENTUAL


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    detail: str


#: (timestamp_ms, kind, worker) — kind is "evict" / "readmit" (worker
#: membership, ServerNode.remove_worker/readmit_worker) or "resume"
#: (checkpoint restore, worker = -1: every worker may re-log its last
#: clock once, the at-least-once redelivery of utils/checkpoint.py)
MembershipEvent = tuple[int, str, int]


def validate_worker_log(worker_df: pd.DataFrame,
                        consistency_model: int,
                        elastic: bool = False,
                        membership_events: list[MembershipEvent] | None = None
                        ) -> list[Violation]:
    """`elastic=True` validates a run with worker eviction/readmission
    (failure_policy=rebalance).

    With `membership_events` (the server's (timestamp_ms, "evict" |
    "readmit", worker) record — ServerNode.membership_events, or the
    logs-events.csv a split-mode server writes), the full contract is
    re-derived PER MEMBERSHIP EPOCH instead of being skipped:

      * per-worker clock step is exactly +1, except across that
        worker's own readmission, where any value is legal (rejoin is
        at the min ACTIVE clock, tracker.reactivate_worker — above,
        equal to, or below the worker's own frozen clock);
      * the k+1 staleness bound holds within every epoch over the
        workers active in that epoch (an eviction removes the dead
        worker's frozen clock from the spread; a readmission re-adds
        the worker at a gate-legal clock).

    Without events (legacy elastic call), only per-worker clock
    monotonicity is checked — membership changes void the static bound
    and nothing records where they happened."""
    out: list[Violation] = []
    if membership_events or (elastic and membership_events is not None):
        # membership events existing IS the elastic signal: a run whose
        # record carries evict/readmit/resume must be audited
        # epoch-aware, whatever the caller passed for `elastic` — the
        # static +1/spread contract is provably void across any of
        # those events (a resume rewinds clocks to the last periodic
        # checkpoint; an eviction freezes one).  `elastic` only matters
        # when the caller supplies NO events: True relaxes the static
        # +1 check to monotonicity (legacy eventless elastic runs).
        return _validate_elastic_epochs(worker_df, consistency_model,
                                        membership_events or [])
    # 1. per-worker clocks
    for w, g in worker_df.groupby("partition"):
        clocks = g["vectorClock"].tolist()
        for prev, cur in zip(clocks, clocks[1:]):
            bad = (cur < prev) if elastic else (cur != prev + 1)
            if bad:
                expect = "no regression" if elastic else f"{prev + 1}"
                out.append(Violation(
                    "clock-step",
                    f"worker {int(w)}: clock {prev} -> {cur} "
                    f"(expected {expect})"))
    # 2. staleness bound, evaluated at every log event in arrival order
    # (stable sort: ties keep file order — log files are written in
    # arrival order and millisecond timestamps collide)
    if consistency_model != EVENTUAL and not elastic:
        bound = consistency_model + 1   # see module docstring
        latest: dict[int, int] = {}
        ordered = worker_df.sort_values("timestamp", kind="stable")
        for _, row in ordered.iterrows():
            latest[int(row["partition"])] = int(row["vectorClock"])
            if len(latest) > 1:
                spread = max(latest.values()) - min(latest.values())
                if spread > bound:
                    out.append(Violation(
                        "staleness-bound",
                        f"spread {spread} > bound {bound} at "
                        f"timestamp {int(row['timestamp'])} "
                        f"(clocks {dict(sorted(latest.items()))})"))
    return out


# Membership-event timestamps come from the server's host clock; log
# rows from worker host clocks.  Ordering across that boundary is only
# trustworthy up to NTP-grade skew — interleavings wider than this are
# reported as suspicious rather than silently re-segmented.
CLOCK_SKEW_WARN_MS = 10_000


def _validate_elastic_epochs(worker_df: pd.DataFrame,
                             consistency_model: int,
                             membership_events: list[MembershipEvent]
                             ) -> list[Violation]:
    """Merge log rows and membership events into one timeline and audit
    each epoch (the interval between two membership changes) against
    the same contract a static run gets.  Events order before log rows
    on timestamp ties: the server records the change before the
    affected traffic flows.

    Cross-host clock skew (ADVICE r3): in split mode the events carry
    the SERVER host's clock and the rows each WORKER host's clock, so
    the merged order is only approximate.  Readmissions are therefore
    applied by PROTOCOL STATE, not wall clock: the rejoin row is the
    first row of an inactive worker that either follows its readmit
    event on the timeline or breaks its frozen +1 chain while an
    unconsumed readmit event for it exists nearby (within
    CLOCK_SKEW_WARN_MS) — a row skew-sorted before its own readmission
    is then still classified as the rejoin, counted into the spread,
    and the skew reported via `warnings`.  Evictions still segment on
    the merged timeline (a pre-evict row is indistinguishable from a
    legal last-gasp +1 continuation by content alone); last-gasp rows
    arriving implausibly long after the eviction are warned about."""
    out: list[Violation] = []
    bound = consistency_model + 1
    check_bound = consistency_model != EVENTUAL

    rows = worker_df.sort_values("timestamp", kind="stable")
    events_sorted = sorted(membership_events, key=lambda e: e[0])
    timeline: list[tuple[int, int, object]] = []   # (ts, order, item)
    for ev in events_sorted:
        timeline.append((int(ev[0]), 0, ev))
    for _, row in rows.iterrows():
        timeline.append((int(row["timestamp"]), 1,
                         (int(row["partition"]), int(row["vectorClock"]))))
    timeline.sort(key=lambda t: (t[0], t[1]))

    active = {int(w) for w in worker_df["partition"].unique()}
    active |= {int(w) for _, _, w in membership_events}
    latest: dict[int, int] = {}         # last logged clock per worker
    frozen: dict[int, int] = {}         # evicted workers' +1 chains
    evicted_at: dict[int, int] = {}     # worker -> evict event ts
    # per worker: timestamps of readmit events not yet consumed — either
    # reached on the timeline (-> pending) or claimed EARLY by a row
    # whose host clock sorts it before its own readmit event
    readmit_times: dict[int, list[int]] = {}
    evict_times: dict[int, list[int]] = {}
    for ts_, kind_, w_ in events_sorted:
        if kind_ == "readmit":
            readmit_times.setdefault(int(w_), []).append(int(ts_))
        else:
            evict_times.setdefault(int(w_), []).append(int(ts_))
    pending_readmit: dict[int, int] = {}
    early_claims: dict[int, int] = {}

    # Crash-truncation exemption: split-mode workers log through a
    # deferred sink (utils/asynclog.py), so a SIGKILL'd process loses
    # its final pending rows — its LOGGED clock then understates its
    # true protocol clock by however far it ran before dying, and the
    # apparent spread inflates without any real staleness.  In an epoch
    # that ends in a crash (marked by the following "resume" event), a
    # worker whose log has gone silent for the REST of that epoch
    # therefore stops constraining the spread from its last row onward
    # ("stalled" and "rows lost to the crash" are indistinguishable
    # from the log; bias to no false positives, like the rest of this
    # auditor).  Healthy epochs — no resume ahead — are unaffected.
    resume_ts = sorted(int(ts_) for ts_, kind_, _ in events_sorted
                       if kind_ == "resume")
    last_row_ts: dict[tuple[int, int], int] = {}
    for _, row in rows.iterrows():
        rts = int(row["timestamp"])
        epoch = sum(1 for r in resume_ts if r <= rts)
        key = (int(row["partition"]), epoch)
        last_row_ts[key] = max(last_row_ts.get(key, rts), rts)

    # workers already warned about per (worker, epoch): one exemption
    # warning per blind spot, not one per spread check
    warned_truncated: set[tuple[int, int]] = set()

    def spread_workers(ts: int) -> dict[int, int]:
        nxt = next((r for r in resume_ts if r > ts), None)
        if nxt is None:
            return latest
        epoch = sum(1 for r in resume_ts if r <= ts)
        kept = {w: c for w, c in latest.items()
                if last_row_ts.get((w, epoch), -1) >= ts}
        for w in latest:
            if w not in kept and (w, epoch) not in warned_truncated:
                warned_truncated.add((w, epoch))
                warnings.warn(
                    f"staleness audit: worker {w} exempted from the "
                    f"spread check from timestamp {ts} to the end of "
                    f"crash epoch {epoch} (its log went silent before "
                    "the crash — rows lost to the truncated deferred "
                    "sink and a genuine stall are indistinguishable, "
                    "so its clock no longer constrains the spread)")
        return kept

    def spread_check(ts: int) -> None:
        clocks = spread_workers(ts)
        if check_bound and len(clocks) > 1:
            spread = max(clocks.values()) - min(clocks.values())
            if spread > bound:
                out.append(Violation(
                    "staleness-bound",
                    f"spread {spread} > bound {bound} at timestamp "
                    f"{ts} (clocks {dict(sorted(clocks.items()))})"))

    # workers whose NEXT row follows a checkpoint resume: the crash
    # killed the in-flight messages and the restored server re-sends
    # each worker's CHECKPOINTED clock (at-least-once redelivery,
    # utils/checkpoint.py restore) — which a crash resume rewinds to
    # the last periodic save, below rows the surviving log already
    # holds.  That one row per worker may carry ANY clock, and the
    # pre-crash `latest` clocks are dead state (comparing rewound rows
    # against them would fake a staleness spread), so they leave the
    # spread until each worker's redelivered row re-enters it.
    resumed: set[int] = set()

    for ts, kind_order, item in timeline:
        if kind_order == 0:             # membership event
            _, kind, w = item
            w = int(w)
            if kind == "resume":
                # a crash resume rewinds the SERVER'S state — including
                # membership — to the last periodic save, which the
                # append-only events log cannot see.  All pre-resume
                # membership bookkeeping is void: a worker evicted
                # after that save is revived by the restore (its
                # checkpointed active flag) and legally logs again.
                # Bias to no false positives: treat every known worker
                # as active with one any-clock redelivery; post-resume
                # evict/readmit events re-segment from here.
                known = active | set(latest) | set(frozen)
                resumed |= known
                active |= known
                frozen.clear()
                latest.clear()
                pending_readmit.clear()
                early_claims.clear()
                for w_, times in readmit_times.items():
                    readmit_times[w_] = [t for t in times if t > ts]
                continue
            if kind == "evict":
                active.discard(w)
                if w in latest:         # frozen clock leaves the spread
                    frozen[w] = latest.pop(w)
                evicted_at[w] = ts
                # a readmission the worker never logged under is voided
                # by its re-eviction — without this, its next in-flight
                # row would be misread as a rejoin and its frozen clock
                # would re-enter the spread permanently
                for _ in range(pending_readmit.get(w, 0)):
                    if readmit_times.get(w):
                        readmit_times[w].pop(0)
                pending_readmit[w] = 0
            elif early_claims.get(w, 0) > 0:
                early_claims[w] -= 1    # a skew-sorted row already took it
            else:
                pending_readmit[w] = pending_readmit.get(w, 0) + 1
            continue
        w, clock = item
        if w not in active:
            prev = frozen.get(w)
            rejoin = False
            if pending_readmit.get(w, 0) > 0:
                pending_readmit[w] -= 1
                # guarded (ADVICE r4): a resume clears early_claims but
                # the early-claimed readmit event may still be ahead on
                # the timeline; when it re-increments pending_readmit its
                # timestamp was already popped, so the list can be empty
                # here — report via the normal paths, don't crash
                if readmit_times.get(w):
                    readmit_times[w].pop(0)
                rejoin = True
            elif (readmit_times.get(w)
                    # a truly broken +1 chain — `prev is None` is NOT a
                    # break: a worker evicted before its first row sends
                    # a perfectly legal in-flight first row, which must
                    # stay a last-gasp (the pending path classifies its
                    # real rejoin correctly)
                    and prev is not None and clock != prev + 1
                    and readmit_times[w][0] - ts <= CLOCK_SKEW_WARN_MS
                    # a claim must not reach ACROSS an evict for this
                    # worker: in a corrupted event log (e.g. double
                    # evict) that would swallow the readmit and push the
                    # worker's real rejoin rows out of the spread forever
                    and not any(ts < e <= readmit_times[w][0]
                                for e in evict_times.get(w, ()))):
                # protocol state says rejoin even though this row's host
                # clock sorts it before its own readmit event
                readmit_times[w].pop(0)
                early_claims[w] = early_claims.get(w, 0) + 1
                rejoin = True
                warnings.warn(
                    f"worker {w}: rejoin row at {ts} precedes its "
                    "readmit event — cross-host clock skew; ordered by "
                    "protocol state instead")
            if rejoin:
                active.add(w)
                frozen.pop(w, None)
                latest[w] = clock       # no +1 check on the rejoin row
                spread_check(ts)
            else:
                # last-gasp row in flight at the eviction: continues the
                # frozen chain but stays out of the spread
                if prev is not None and clock != prev + 1:
                    out.append(Violation(
                        "clock-step",
                        f"evicted worker {w}: clock {prev} -> {clock} "
                        f"(expected {prev + 1}) at timestamp {ts}"))
                frozen[w] = clock
                if ts - evicted_at.get(w, ts) > CLOCK_SKEW_WARN_MS:
                    warnings.warn(
                        f"worker {w}: row at {ts} arrived "
                        f"{ts - evicted_at[w]}ms after its eviction — "
                        "possible clock skew mis-segmenting this epoch "
                        "(epoch validation assumes NTP-synced hosts)")
            continue
        prev = latest.get(w)
        if w in resumed:
            # any clock is legal on the one redelivered row: a crash
            # resume restarts from the last PERIODIC save, so the clock
            # can regress below rows the surviving log already holds
            # (and then legitimately re-walk them, +1 from here)
            resumed.discard(w)
        elif prev is not None and clock != prev + 1:
            out.append(Violation(
                "clock-step",
                f"worker {w}: clock {prev} -> {clock} "
                f"(expected {prev + 1}) at timestamp {ts}"))
        latest[w] = clock
        spread_check(ts)
    return out


def validate_server_log(server_df: pd.DataFrame,
                        membership_events: list[MembershipEvent] | None = None
                        ) -> list[Violation]:
    """The server's eval clock never regresses — except across a
    checkpoint resume (a "resume" membership event), where a crash
    restart legitimately rewinds to the last periodic save and re-walks
    the lost iterations."""
    out: list[Violation] = []
    resume_ts = sorted(ts for ts, kind, _ in (membership_events or [])
                       if kind == "resume")
    ordered = server_df.sort_values("timestamp", kind="stable")
    prev_clock = prev_ts = None
    for ts, cur in zip(ordered["timestamp"].tolist(),
                       ordered["vectorClock"].tolist()):
        ts, cur = int(ts), int(cur)
        if prev_clock is not None and cur < prev_clock:
            crossed = any(prev_ts <= r <= ts for r in resume_ts)
            if crossed:
                resume_ts = [r for r in resume_ts
                             if not (prev_ts <= r <= ts)]
            else:
                out.append(Violation(
                    "server-clock-regression",
                    f"server eval clock {prev_clock} -> {cur}"))
        prev_clock, prev_ts = cur, ts
    return out


def validate_run(worker_df: pd.DataFrame | None,
                 server_df: pd.DataFrame | None,
                 consistency_model: int,
                 elastic: bool = False,
                 membership_events: list[MembershipEvent] | None = None
                 ) -> list[Violation]:
    out: list[Violation] = []
    if worker_df is not None and len(worker_df):
        out += validate_worker_log(worker_df, consistency_model,
                                   elastic=elastic,
                                   membership_events=membership_events)
    if server_df is not None and len(server_df):
        out += validate_server_log(server_df,
                                   membership_events=membership_events)
    return out


def load_membership_events(path: str) -> list[MembershipEvent]:
    """Parse a logs-events.csv (`timestamp;event;partition`, written
    incrementally by ServerNode.record_membership_event through the
    events CsvLogSink the CLIs install — csvlog.EVENTS_HEADER)."""
    df = pd.read_csv(path, sep=";")
    return [(int(r["timestamp"]), str(r["event"]), int(r["partition"]))
            for _, r in df.iterrows()]
