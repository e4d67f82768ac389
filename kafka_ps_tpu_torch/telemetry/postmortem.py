"""Postmortem analyzer — merge multi-process flight dumps and name the
culprit (counterpart of kafka_ps_tpu/telemetry/postmortem.py; either
package's dumps, mixed or not).

    python -m kafka_ps_tpu_torch.telemetry postmortem DIR

A SIGKILLed process writes no dump — that absence IS the finding.  The
survivors' dumps carry the evidence: every worker records a
`shard.weights` event per assembled slice (shard, worker, clock), every
server shard dumps under its own identity, and all dumps share the
wall-clock anchor convention (`wallClockT0`, utils/trace.Tracer), so
events from different processes land on one timeline.

The analysis is deliberately simple set arithmetic plus a max():

  * known shards   = identity of every server dump
                   ∪ `shards` lists workers declared in their meta
                   ∪ shard fields observed in any event
  * dead shards    = known − shards that produced a dump
  * last ack       = the max-clock `shard.weights` event naming the
                     dead shard across all surviving worker rings —
                     "the last (worker, clock) the dead shard served",
                     reported with its distance from the reporter's
                     death.

Watchdog trips and gate-stall evidence (waiting workers, clock lag)
from the surviving dumps are surfaced alongside, so a wedge (no death,
just a stall) reads the same way a kill does.
"""

from __future__ import annotations

import glob
import json
import os


def load_dumps_with_errors(directory: str) -> tuple[list[dict],
                                                    list[str]]:
    """(parseable dumps, unreadable paths) for every flightdump-*.json
    under `directory`, both sorted by filename for stable output.  A
    postmortem tool must not die on the evidence — but a torn or
    truncated dump is itself evidence (the process died mid-write, or
    the disk did), so unreadable files are *reported*, never silently
    dropped."""
    out = []
    unreadable = []
    for path in sorted(glob.glob(os.path.join(directory,
                                              "flightdump-*.json"))):
        try:
            with open(path) as f:
                d = json.load(f)
        except (OSError, ValueError):
            unreadable.append(path)
            continue
        if isinstance(d, dict) and d.get("schema", "").startswith(
                "kps-flightdump"):
            d["_path"] = path
            out.append(d)
        else:
            # valid JSON but not a flight dump: same finding — the file
            # claims the name, the contents don't back it up
            unreadable.append(path)
    return out, unreadable


def load_dumps(directory: str) -> list[dict]:
    """The parseable dumps only (compat shim; prefer
    `load_dumps_with_errors`, which also surfaces torn files)."""
    return load_dumps_with_errors(directory)[0]


def _last_event_t(dump: dict) -> float:
    events = dump.get("events") or []
    if events:
        return max(e.get("t", 0.0) for e in events)
    return dump.get("dumpedAt", 0.0)


def analyze(dumps: list[dict], unreadable: list[str] | None = None) -> dict:
    """Pure analysis over loaded dumps (tests drive this directly).
    `unreadable` paths ride through to the report as findings."""
    processes = []
    known_shards: set[int] = set()
    present_shards: set[int] = set()
    last_acks: dict[int, dict] = {}     # shard -> best ack event
    trips = []
    gate_stalls = []
    drift_events = []                   # drift.warn / drift.trip edges

    for d in dumps:
        role = d.get("role", "unknown")
        shard = d.get("shard")
        processes.append({
            "pid": d.get("pid"), "role": role, "shard": shard,
            "reason": d.get("reason", ""), "path": d.get("_path", ""),
            "dumpedAt": d.get("dumpedAt", 0.0),
            "lastEventAt": _last_event_t(d),
        })
        if role == "server" and shard is not None:
            known_shards.add(int(shard))
            present_shards.add(int(shard))
        for s in d.get("meta", {}).get("shards", []) or []:
            known_shards.add(int(s))
        for name, st in (d.get("watchdogs") or {}).items():
            if st.get("tripped") or st.get("trip_count", 0) > 0:
                trips.append({"pid": d.get("pid"), "role": role,
                              "shard": shard, "watchdog": name,
                              "reason": st.get("reason", "")})
        # a process that hosts the server ("run" in-process, "server"
        # split-mode) *is* every shard its own rings mention — without
        # this, an unsharded dump whose gate events carry shard=0 would
        # report itself as a dead shard
        hosts_server = role in ("run", "server")
        for e in d.get("events") or []:
            if "shard" in e:
                try:
                    known_shards.add(int(e["shard"]))
                    if hosts_server:
                        present_shards.add(int(e["shard"]))
                except (TypeError, ValueError):
                    continue
            if e.get("kind") == "shard.weights":
                s = int(e["shard"])
                best = last_acks.get(s)
                key = (e.get("clock", -1), e.get("t", 0.0))
                if best is None or key > (best.get("clock", -1),
                                          best.get("t", 0.0)):
                    last_acks[s] = {"shard": s,
                                    "worker": e.get("worker"),
                                    "clock": e.get("clock"),
                                    "t": e.get("t", 0.0),
                                    "reporter_pid": d.get("pid"),
                                    "reporter_death": _last_event_t(d)}
            if e.get("kind") == "watchdog.trip":
                trips.append({"pid": d.get("pid"), "role": role,
                              "shard": shard,
                              "watchdog": e.get("name", "?"),
                              "reason": e.get("reason", "")})
            if e.get("kind") == "gate.arrive" and e.get("lag", 0) >= 4:
                gate_stalls.append({"pid": d.get("pid"), "shard": shard,
                                    "worker": e.get("worker"),
                                    "clock": e.get("clock"),
                                    "lag": e.get("lag")})
            if e.get("kind") in ("drift.warn", "drift.trip"):
                drift_events.append({
                    "pid": d.get("pid"), "role": role, "shard": shard,
                    "event": e["kind"].split(".", 1)[1],
                    "detector": e.get("detector", "?"),
                    "signal": e.get("signal", "?"),
                    "statistic": e.get("statistic"),
                    "eval_row": e.get("eval_row")})

    dead = sorted(known_shards - present_shards)
    return {
        "dumps": len(dumps),
        "processes": processes,
        "knownShards": sorted(known_shards),
        "deadShards": dead,
        "lastAcks": {s: last_acks[s] for s in dead if s in last_acks},
        "watchdogTrips": trips,
        "gateStalls": gate_stalls[-10:],
        # model-health verdict: did any process see the model drifting
        # before it died?  (A trip here plus a gate stall elsewhere
        # often means "the data changed, not the system".)
        "driftEvents": drift_events[-10:],
        "unreadable": list(unreadable or ()),
    }


def format_report(report: dict) -> str:
    lines = []
    procs = report["processes"]
    lines.append(f"postmortem: {report['dumps']} dump(s) — "
                 + ", ".join(
                     f"pid {p['pid']} {p['role']}"
                     + (f" shard {p['shard']}"
                        if p["shard"] is not None else "")
                     + (f" ({p['reason']})" if p["reason"] else "")
                     for p in procs))
    if report["knownShards"]:
        lines.append(f"known shards: {report['knownShards']}")
    for path in report.get("unreadable", ()):
        lines.append(f"unreadable dump: {path} — torn/truncated "
                     "(a process died mid-write?) or not a flight dump")
    for s in report["deadShards"]:
        lines.append(f"dead shard {s}: no flight dump — killed, or its "
                     f"dump was lost")
        ack = report["lastAcks"].get(s)
        if ack is not None:
            before = ack["reporter_death"] - ack["t"]
            lines.append(
                f"  last ack from shard {s}: weights for worker "
                f"{ack['worker']} at clock {ack['clock']}, "
                f"{before:.1f}s before pid {ack['reporter_pid']}'s "
                f"last recorded event")
    if not report["deadShards"] and report["knownShards"]:
        lines.append("no dead shards: every known shard produced a dump")
    for t in report["watchdogTrips"]:
        where = (f"shard {t['shard']}" if t["shard"] is not None
                 else t["role"])
        lines.append(f"watchdog trip on pid {t['pid']} ({where}): "
                     f"{t['watchdog']} — {t['reason']}")
    for g in report["gateStalls"]:
        lines.append(f"gate evidence: pid {g['pid']} saw worker "
                     f"{g['worker']} at clock {g['clock']} "
                     f"(lag {g['lag']})")
    for e in report.get("driftEvents", ()):
        where = (f"shard {e['shard']}" if e["shard"] is not None
                 else e["role"])
        stat = (f", statistic {e['statistic']}"
                if e.get("statistic") is not None else "")
        row = (f" at eval row {e['eval_row']}"
               if e.get("eval_row") is not None else "")
        lines.append(f"drift {e['event']} on pid {e['pid']} ({where}): "
                     f"{e['detector']} over {e['signal']}{stat}{row}")
    return "\n".join(lines)


def main(directory: str) -> int:
    dumps, unreadable = load_dumps_with_errors(directory)
    if not dumps:
        for path in unreadable:
            print(f"unreadable dump: {path}")
        print(f"postmortem: no readable flight dumps under {directory}")
        return 1
    report = analyze(dumps, unreadable)
    print(format_report(report))
    return 0
