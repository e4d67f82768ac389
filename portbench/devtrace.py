"""The device trace of a traced run, read by the benchmark itself.

`torch.profiler` (CUPTI) records the window's device activity: kernels,
copies and sets, with their start and length.  The program's own trace
path has lost kernel events and once a whole trace, so this reads the
profiler's raw events and checks them: a trace with no device event is
taken again, up to TRIES times, and a run whose every trace is empty
fails rather than report a share of 0.

From the events: the union of device activity (busy), device time by
operation, the time of the program's own kernels (every kernel that is not PyTorch's, cuBLAS's or CUTLASS's:
a kernel renamed or split by a later change still counts), and the
longest idle gaps, each labelled by the shortest host operation (the
profiler's, or the harness's span around each call) open at its middle.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

import numpy as np

TRIES = 3
TOP = 10
# kernels of libraries, not of the program
LIBRARY = re.compile(r"at::|at_cuda_detail|c10::|cublas|cutlass|gemm|gemv|"
                     r"splitKreduce|cudnn|nvjet|xmma", re.IGNORECASE)


@dataclass
class HostSpan:
    name: str
    start_ns: int
    end_ns: int


@dataclass
class DeviceProfile:
    window_ns: int
    busy_ns: int
    by_op_ns: dict
    program_kernel_ns: int
    gaps: list = field(default_factory=list)     # (label, ns)

    @property
    def window_s(self) -> float:
        return self.window_ns / 1e9

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9

    def breakdown(self) -> dict:
        ops = sorted(self.by_op_ns.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, v / 1e9] for n, v in ops],
                "idle_gaps": [[n, v / 1e9] for n, v in self.gaps[:TOP]]}


def _is_cuda(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA")


def _union(intervals: np.ndarray) -> tuple[int, np.ndarray]:
    """(total covered ns, the merged [start, end] intervals)."""
    if len(intervals) == 0:
        return 0, intervals
    iv = intervals[np.argsort(intervals[:, 0])]
    merged = [iv[0].tolist()]
    for s, e in iv[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    m = np.asarray(merged, dtype=np.int64)
    return int((m[:, 1] - m[:, 0]).sum()), m


def summarize(events, t0_ns: int, t1_ns: int,
              spans: list[HostSpan]) -> DeviceProfile | None:
    """The profile of the window [t0_ns, t1_ns] (epoch ns), or None when
    the trace holds no device event in it."""
    dev, host = [], list(spans)
    for ev in events:
        start = int(ev.start_ns())
        end = start + int(ev.duration_ns())
        if end <= t0_ns or start >= t1_ns:
            continue
        if _is_cuda(ev):
            dev.append((ev.name(), max(start, t0_ns), min(end, t1_ns)))
        else:
            host.append(HostSpan(ev.name(), start, end))
    if not dev:
        return None
    by_op: dict[str, int] = {}
    prog = 0
    for name, s, e in dev:
        by_op[name] = by_op.get(name, 0) + (e - s)
        if not (name.startswith("Memcpy") or name.startswith("Memset")
                or LIBRARY.search(name)):
            prog += e - s
    busy, merged = _union(np.array([(s, e) for _, s, e in dev],
                                   dtype=np.int64))
    edges = np.concatenate([[t0_ns], merged.ravel(), [t1_ns]])
    gap_iv = edges.reshape(-1, 2)
    gap_len = gap_iv[:, 1] - gap_iv[:, 0]
    starts = np.array([h.start_ns for h in host], dtype=np.int64)
    ends = np.array([h.end_ns for h in host], dtype=np.int64)
    gaps = []
    for i in np.argsort(-gap_len)[:TOP]:
        if gap_len[i] <= 0:
            break
        mid = int(gap_iv[i].mean())
        open_ = np.flatnonzero((starts <= mid) & (mid < ends))
        label = (host[open_[np.argmin(ends[open_] - starts[open_])]].name
                 if len(open_) else "host: no operation")
        gaps.append((label, int(gap_len[i])))
    return DeviceProfile(t1_ns - t0_ns, busy, by_op, prog, gaps)


class Profiler:
    """torch.profiler over calls of the window: `start()`, then `stop()`
    → its events, for `summarize` over [t0_ns, t1_ns]."""

    def __init__(self):
        self._prof = None
        self.t0_ns = self.t1_ns = 0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self.t0_ns = time.time_ns()

    def stop(self):
        self.t1_ns = time.time_ns()
        self._prof.stop()
        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        return events


def warm_up() -> None:
    """Start and stop the profiler once, so that CUPTI's first start
    falls in the set-up and not in the window."""
    import torch
    p = Profiler()
    p.start()
    torch.zeros(1, device="cuda").add_(1)
    torch.cuda.synchronize()
    p.stop()
