"""Stitch per-process Chrome trace files into one causal timeline
(counterpart of kafka_ps_tpu/telemetry/merge.py; either package's
traces, mixed or not).

A socket-mode run produces one trace file per process (`--trace PATH`
on the server and on every worker process).  Each file's `ts` values
are relative to that process's own Tracer epoch (perf_counter, not
comparable across processes), and each carries the process's pid.  The
merge:

  * shifts every file onto a common timeline using the `wallClockT0`
    anchor each Tracer dumps (files without one keep their own zero);
  * keeps pids distinct — when two files claim the same pid (e.g. two
    Tracers in one test process) the later file is renumbered — so
    Perfetto renders one track group per process;
  * names each track group after its source file (`process_name`
    metadata events);
  * preserves flow events (`ph: s/t/f`) untouched: their shared `id`
    is what draws the worker -> server -> serving arrows across pids.

Chrome flow-event binding is (id, cat, name)-scoped and pid-agnostic,
so no id rewriting is needed — the wire trace context already made ids
globally unique (utils/trace.Tracer.new_flow_id folds the pid in).
"""

from __future__ import annotations

import json


def _load(path: str) -> dict:
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, list):            # bare traceEvents array form
        data = {"traceEvents": data}
    if "traceEvents" not in data:
        raise ValueError(f"{path}: not a Chrome trace (no traceEvents)")
    return data


def merge_traces(paths: list[str], out_path: str) -> dict:
    """Merge trace files into `out_path`; returns stats:
    {files, events, pids, cross_process_flows}."""
    files = [(p, _load(p)) for p in paths]
    anchors = [d.get("wallClockT0") for _, d in files]
    known = [a for a in anchors if a is not None]
    base = min(known) if known else None

    merged: list[dict] = []
    used_pids: set[int] = set()
    flow_pids: dict[object, set[int]] = {}
    next_pid = 1
    for (path, data), anchor in zip(files, anchors):
        shift_us = 0.0
        if base is not None and anchor is not None:
            shift_us = (anchor - base) * 1e6
        events = data["traceEvents"]
        file_pids = {ev.get("pid", 0) for ev in events}
        remap: dict[int, int] = {}
        for pid in sorted(file_pids):
            if pid in used_pids:
                while next_pid in used_pids or next_pid in file_pids:
                    next_pid += 1
                remap[pid] = next_pid
                used_pids.add(next_pid)
            else:
                remap[pid] = pid
                used_pids.add(pid)
        for ev in events:
            ev = dict(ev)
            pid = remap[ev.get("pid", 0)]
            ev["pid"] = pid
            if "ts" in ev:
                ev["ts"] = ev["ts"] + shift_us
            merged.append(ev)
            if ev.get("ph") in ("s", "t", "f"):
                flow_pids.setdefault(ev.get("id"), set()).add(pid)
        for pid in sorted({remap[p] for p in file_pids}):
            merged.append({"name": "process_name", "ph": "M", "pid": pid,
                           "tid": 0, "args": {"name": path}})

    merged.sort(key=lambda ev: ev.get("ts", 0.0))
    with open(out_path, "w") as f:
        json.dump({"traceEvents": merged}, f)
    cross = sum(1 for pids in flow_pids.values() if len(pids) > 1)
    return {"files": len(files), "events": len(merged),
            "pids": sorted(used_pids), "cross_process_flows": cross}
