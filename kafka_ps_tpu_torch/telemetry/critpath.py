"""Critical-path decomposition — where did an update's end-to-end
latency actually go? (counterpart of kafka_ps_tpu/telemetry/critpath.py;
it reads either package's traces and gives the JAX tool's results).

The tracing plane already records *everything* this question needs:
each gradient's `delta.wire` flow walks send → recv → apply → publish →
first serving read across processes, `worker.local_update` spans carry
(worker, clock), `server.apply` spans carry (worker, clock, model), the
retroactive `gate.wait` spans (runtime/server.py:_observe_gate_release)
carry the consistency gate's hold time, and `weights.wire` flows mark
when fresh weights landed back at each worker.  What was missing is the
*join*: this module stitches those events into a per-update segment
decomposition

    buffer_wait   last weights arrival -> local_update start
    local_train   the worker.local_update span
    wire          local_update end -> server.apply start (serialize +
                  socket + recv queue)
    apply         the server.apply span (device apply + snapshot math)
    gate_wait     apply end -> weights release (the consistency gate's
                  hold; BSP withholds until the round completes)
    publish       apply end -> snapshot publish flow step
    serving_read  snapshot publish -> first serving read of it

and aggregates per consistency model: p50/p99 per segment over the raw
samples plus a "dominant segment" verdict (largest total milliseconds).
`gate_wait` runs parallel to `publish`/`serving_read` — the gate holds
the *weights release* back to workers while the serving path proceeds —
so the segments are a decomposition of the two branches an update fans
into, not one straight line.

Every segment is optional per flow: a merged trace from a short run has
flows whose publish step or serving read never happened (BSP publishes
once per round), and a flow missing pieces still contributes the
segments it has.

Two consumers:

  * `python -m kafka_ps_tpu_torch.telemetry critpath MERGED.json` — offline,
    on a `telemetry merge` output (or a single tracer dump); exits 0
    iff at least one flow decomposed, printing greppable
    `model=<m> flows=<n> dominant=<segment>` lines.
  * `RollingCritpath` — live, riding the `[status]` heartbeat: instead
    of trace events it diffs the metrics registry's histogram bucket
    counts between heartbeats and runs the same `interp_quantile` math
    over the deltas, so a long-lived server shows "what dominates *right
    now*" without retaining a trace in memory.

Stdlib-only, and clock-free by construction: offline analysis reads
timestamps out of the trace, never off a clock, and the rolling form
only ever subtracts registry snapshots.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

from kafka_ps_tpu_torch.telemetry.registry import interp_quantile

# Segment names in pipeline order (report ordering, not computation
# order; gate_wait/publish fork from the same point, see module doc).
SEGMENTS = ("buffer_wait", "local_train", "wire", "apply", "gate_wait",
            "publish", "serving_read")

# How far back the span-containment scan walks before giving up (spans
# are start-sorted; nesting depth in these traces is tiny).
_CONTAIN_SCAN = 128


class _SpanIndex:
    """Start-sorted spans per pid with innermost-containing lookup."""

    def __init__(self, spans):
        per_pid: dict[int, list[dict]] = defaultdict(list)
        for sp in spans:
            per_pid[sp.get("pid", 0)].append(sp)
        self._by_pid: dict[int, tuple[list[float], list[dict]]] = {}
        for pid, sps in per_pid.items():
            sps.sort(key=lambda s: s.get("ts", 0.0))
            self._by_pid[pid] = ([s.get("ts", 0.0) for s in sps], sps)

    def containing(self, pid: int, ts: float) -> dict | None:
        """The latest-starting span on `pid` whose [ts, ts+dur] covers
        `ts` — i.e. the innermost enclosing slice."""
        entry = self._by_pid.get(pid)
        if entry is None:
            return None
        starts, sps = entry
        i = bisect.bisect_right(starts, ts) - 1
        scanned = 0
        while i >= 0 and scanned < _CONTAIN_SCAN:
            sp = sps[i]
            t0 = sp.get("ts", 0.0)
            if t0 <= ts <= t0 + sp.get("dur", 0.0):
                return sp
            i -= 1
            scanned += 1
        return None


def load_events(path: str) -> list[dict]:
    """traceEvents from a tracer dump or a `telemetry merge` output."""
    with open(path) as f:
        payload = json.load(f)
    if isinstance(payload, dict):
        events = payload.get("traceEvents", [])
    else:
        events = payload                 # bare-list trace JSON
    return [e for e in events if isinstance(e, dict)]


def _span_key(ev: dict) -> tuple | None:
    """(pid, worker, clock) identity for spans that carry both args."""
    args = ev.get("args") or {}
    if "worker" not in args or "clock" not in args:
        return None
    try:
        return (ev.get("pid"), str(args["worker"]), int(args["clock"]))
    except (TypeError, ValueError):
        return None


def decompose(events: list[dict]) -> list[dict]:
    """Per-flow segment dicts: [{"model": str, "segments": {name: ms}}].
    A flow appears iff at least one segment could be computed."""
    spans = [e for e in events if e.get("ph") == "X"]
    flow_evs = [e for e in events
                if e.get("ph") in ("s", "t", "f") and e.get("cat") == "flow"]

    # -- indexes ------------------------------------------------------------
    local_spans: dict[tuple, dict] = {}
    gate_spans: dict[tuple, dict] = {}
    apply_idx = _SpanIndex([s for s in spans if s.get("name") == "server.apply"])
    send_idx = _SpanIndex(
        [s for s in spans if s.get("name") == "net.send"
         and (s.get("args") or {}).get("topic") == "gradients"])
    for sp in spans:
        name = sp.get("name")
        if name == "worker.local_update":
            key = _span_key(sp)
            if key is not None:
                local_spans[key] = sp
        elif name == "gate.wait":
            key = _span_key(sp)
            if key is not None:
                gate_spans[key] = sp

    # weights.wire flows: the server-side "s" carries worker=<id>; the
    # worker-side "f" marks arrival.  Build per-(worker pid, worker)
    # sorted arrival times so buffer_wait can find "the weights this
    # local step trained on".
    weights_worker: dict[int, str] = {}
    weights_f: dict[int, tuple[int, float]] = {}
    delta_flows: dict[int, list[dict]] = defaultdict(list)
    for ev in flow_evs:
        name, fid = ev.get("name"), ev.get("id")
        if fid is None:
            continue
        if name == "weights.wire":
            if ev["ph"] == "s":
                w = (ev.get("args") or {}).get("worker")
                if w is not None:
                    weights_worker[fid] = str(w)
            elif ev["ph"] == "f":
                weights_f[fid] = (ev.get("pid"), ev.get("ts", 0.0))
        elif name == "delta.wire":
            delta_flows[fid].append(ev)
    weights_arrivals: dict[tuple, list[float]] = defaultdict(list)
    for fid, (pid, ts) in weights_f.items():
        w = weights_worker.get(fid)
        if w is not None:
            weights_arrivals[(pid, w)].append(ts)
    for arr in weights_arrivals.values():
        arr.sort()

    # -- per-flow stitch ----------------------------------------------------
    out: list[dict] = []
    for fid, evs in delta_flows.items():
        evs.sort(key=lambda e: e.get("ts", 0.0))
        s_ev = next((e for e in evs if e["ph"] == "s"), None)
        apply_step = publish_step = None
        for e in evs:
            if e["ph"] != "t":
                continue
            args = e.get("args") or {}
            if args.get("step") == "publish":
                publish_step = publish_step or e
            elif "clock" in args:
                apply_step = apply_step or e
        f_ev = next((e for e in evs if e["ph"] == "f"), None)

        worker = clock = None
        if s_ev is not None:
            send_sp = send_idx.containing(s_ev.get("pid"),
                                          s_ev.get("ts", 0.0))
            if send_sp is not None:
                w = (send_sp.get("args") or {}).get("worker")
                worker = None if w is None else str(w)
        apply_sp = None
        if apply_step is not None:
            try:
                clock = int((apply_step.get("args") or {})["clock"])
            except (TypeError, ValueError, KeyError):
                clock = None
            apply_sp = apply_idx.containing(apply_step.get("pid"),
                                            apply_step.get("ts", 0.0))
            if worker is None and apply_sp is not None:
                w = (apply_sp.get("args") or {}).get("worker")
                worker = None if w is None else str(w)

        local_sp = gate_sp = None
        if worker is not None and clock is not None:
            if s_ev is not None:
                local_sp = local_spans.get(
                    (s_ev.get("pid"), worker, clock))
            if apply_step is not None:
                gate_sp = gate_spans.get(
                    (apply_step.get("pid"), worker, clock))

        model = "unknown"
        for sp in (apply_sp, gate_sp):
            m = (sp.get("args") or {}).get("model") if sp else None
            if m:
                model = str(m)
                break

        seg: dict[str, float] = {}
        apply_end = None
        if apply_sp is not None:
            seg["apply"] = apply_sp.get("dur", 0.0) / 1e3
            apply_end = apply_sp["ts"] + apply_sp.get("dur", 0.0)
        if local_sp is not None:
            seg["local_train"] = local_sp.get("dur", 0.0) / 1e3
            arr = weights_arrivals.get((local_sp["pid"], worker))
            if arr:
                i = bisect.bisect_left(arr, local_sp["ts"]) - 1
                if i >= 0:
                    seg["buffer_wait"] = (local_sp["ts"] - arr[i]) / 1e3
            local_end = local_sp["ts"] + local_sp.get("dur", 0.0)
            if apply_sp is not None:
                seg["wire"] = max(0.0, (apply_sp["ts"] - local_end) / 1e3)
        if "wire" not in seg and s_ev is not None and apply_step is not None:
            # no local span matched (gang path without worker identity):
            # fall back to send->apply-step, still "time on the wire"
            seg["wire"] = max(
                0.0, (apply_step["ts"] - s_ev.get("ts", 0.0)) / 1e3)
        if gate_sp is not None:
            gate_end = gate_sp["ts"] + gate_sp.get("dur", 0.0)
            base = apply_end if apply_end is not None else gate_sp["ts"]
            seg["gate_wait"] = max(0.0, (gate_end - base) / 1e3)
        if publish_step is not None and apply_end is not None:
            seg["publish"] = max(
                0.0, (publish_step["ts"] - apply_end) / 1e3)
        if f_ev is not None:
            ref = publish_step["ts"] if publish_step is not None \
                else apply_end
            if ref is not None:
                seg["serving_read"] = max(
                    0.0, (f_ev.get("ts", 0.0) - ref) / 1e3)

        if seg:
            out.append({"model": model, "segments": seg})
    return out


def _pctl(sorted_samples: list[float], q: float) -> float:
    """Nearest-rank percentile over raw (already sorted) samples."""
    if not sorted_samples:
        return 0.0
    idx = min(len(sorted_samples) - 1,
              max(0, int(round(q * (len(sorted_samples) - 1)))))
    return sorted_samples[idx]


def aggregate(flows: list[dict]) -> dict:
    """Per-model segment statistics + dominant verdict."""
    per_model: dict[str, dict[str, list[float]]] = defaultdict(
        lambda: defaultdict(list))
    counts: dict[str, int] = defaultdict(int)
    for fl in flows:
        counts[fl["model"]] += 1
        for name, ms in fl["segments"].items():
            per_model[fl["model"]][name].append(ms)
    models: dict[str, dict] = {}
    for model, segs in per_model.items():
        total_all = sum(sum(v) for v in segs.values())
        table: dict[str, dict] = {}
        dominant, dom_total = "", -1.0
        for name in SEGMENTS:
            samples = sorted(segs.get(name, []))
            if not samples:
                continue
            total = sum(samples)
            table[name] = {
                "n": len(samples),
                "p50_ms": round(_pctl(samples, 0.5), 3),
                "p99_ms": round(_pctl(samples, 0.99), 3),
                "total_ms": round(total, 3),
                "share": round(total / total_all, 4) if total_all else 0.0,
            }
            if total > dom_total:
                dominant, dom_total = name, total
        models[model] = {"flows": counts[model], "segments": table,
                         "dominant": dominant}
    return {"flows": len(flows), "models": models}


def analyze_trace(path: str) -> dict:
    """Load, decompose and aggregate one trace file."""
    return aggregate(decompose(load_events(path)))


def format_report(result: dict, path: str = "") -> str:
    lines = [f"critpath: decomposed {result['flows']} delta flows"
             + (f" from {path}" if path else "")]
    for model in sorted(result["models"]):
        info = result["models"][model]
        lines.append(f"model={model} flows={info['flows']} "
                     f"dominant={info['dominant']}")
        for name in SEGMENTS:
            st = info["segments"].get(name)
            if st is None:
                continue
            lines.append(
                f"  segment={name:<12} n={st['n']:<4} "
                f"p50={st['p50_ms']:.3f}ms p99={st['p99_ms']:.3f}ms "
                f"total={st['total_ms']:.3f}ms "
                f"share={100 * st['share']:.1f}%")
    return "\n".join(lines)


def critpath_main(trace: str) -> int:
    """CLI body for `python -m kafka_ps_tpu_torch.telemetry critpath TRACE`:
    0 iff at least one flow decomposed."""
    try:
        result = analyze_trace(trace)
    except (OSError, ValueError) as e:
        print(f"critpath: cannot read {trace}: {e}")
        return 2
    print(format_report(result, trace))
    if not result["flows"]:
        print("critpath: no delta.wire flows decomposed "
              "(was the run traced end to end?)")
        return 1
    return 0


class RollingCritpath:
    """The live form: segment verdicts from metrics-registry histogram
    *deltas* between heartbeats, riding `status()` (runtime/app.py,
    cli/socket_mode.py).

    Offline decomposition needs the whole trace; a long-lived server
    wants "what dominates right now" for free.  Each named histogram
    family below is the metrics-plane proxy for one segment — the gate's
    hold time, the worker's step time, snapshot staleness, serving
    latency.  Between calls we diff the summed bucket counts and run
    the same `interp_quantile` math over the difference, so the p50
    reported is the p50 *of the last window*, not since boot.  Dominant
    = largest delta in summed milliseconds.

    Pure reads of `Histogram.state()` — nothing here observes, so it
    adds no contention to the hot paths it reports on.
    """

    FAMILIES = (("gate_wait", "gate_wait_ms"),
                ("local_train", "worker_update_ms"),
                ("staleness", "snapshot_age_ms"),
                ("serving", "serving_latency_ms"))

    def __init__(self, telemetry):
        self._registry = telemetry.registry
        self._prev: dict[str, tuple[list[int], float, int]] = {}

    def sample(self) -> dict:
        fams = self._registry.families()
        report: dict[str, object] = {}
        dominant, dom_sum = "idle", 0.0
        for seg, fam_name in self.FAMILIES:
            fam = fams.get(fam_name)
            if fam is None or fam.kind != "histogram":
                continue
            bounds = None
            agg_counts: list[int] = []
            agg_sum, agg_total = 0.0, 0
            for child in fam.children().values():
                counts, csum, total = child.state()
                if bounds is None:
                    bounds = child.bounds
                    agg_counts = [0] * len(counts)
                if child.bounds != bounds or len(counts) != len(agg_counts):
                    continue            # mixed-bucket family: skip child
                agg_counts = [a + b for a, b in zip(agg_counts, counts)]
                agg_sum += csum
                agg_total += total
            if bounds is None:
                continue
            prev = self._prev.get(seg)
            self._prev[seg] = (agg_counts, agg_sum, agg_total)
            if prev is None or len(prev[0]) != len(agg_counts):
                d_counts, d_sum, d_total = agg_counts, agg_sum, agg_total
            else:
                d_counts = [a - b for a, b in zip(agg_counts, prev[0])]
                d_sum = agg_sum - prev[1]
                d_total = agg_total - prev[2]
            if d_total <= 0:
                continue
            p50 = interp_quantile(bounds, d_counts, d_total, 0.5)
            if p50 is not None:
                report[f"{seg}_p50"] = round(p50, 3)
            report[f"{seg}_n"] = d_total
            if d_sum > dom_sum:
                dominant, dom_sum = seg, d_sum
        report["dominant"] = dominant
        return report
