"""One run of one cell: set-up, the measured window, the readings and
the check that decides `correct`.

Set-up builds one StreamingPSApp over the configuration (its kernels
built or loaded from kafka_ps_tpu_torch/_build/), hands it the burst of
rows that the configuration's model family reads (`rows/<name>.py`)
through `data_sink`, then drives `run_fused_bsp` through the rounds the
check follows (check.py: one call a round, then one call shaped as the
window's, the evals and the chunks' CUDA graph among them) and a timed
warm-up call.

The window drives the same entry.  The fused loop runs to an iteration
count and has no stop flag, so it is driven by repeated calls of about
CALL_S seconds, each a multiple of the eval period; each ends, as the
program's entries do, by waiting for the device to flush its log rows,
and the window closes after the call that crosses --seconds.  The window
ends with a device synchronise; the rate is all the updates over all of
that time.

With --trace 1 the window has two parts.  In the first, of PROFILE_S
seconds (at most half the window), the profiler records the device and
the program's tracer is off, so that the device readings do not hold the
synchronise a traced round makes; the kernel counters bracket it call by
call.  In the rest the tracer is on and the profiler off: the `bsp.step`
spans come from there.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench import check, devtrace, manifest
from portbench.peaks import peak as card_peak

CALL_S = 1.0
WARM_ROUNDS = 20          # to clock 50: calls end on eval clocks
PROFILE_S = 5.0
FORBIDDEN = ("jax", "jaxlib", "flax", "kafka_ps_tpu")


@dataclass
class Run:
    """What the metric readers read (metrics/<name>.py)."""
    cell: str
    config: dict
    traffic: dict
    device_kind: str
    peak: dict | None
    setup_s: float = math.nan
    window_s: float = math.nan
    updates: int = 0
    spans: dict = field(default_factory=dict)     # name -> [(ms, args)]
    profile: devtrace.DeviceProfile | None = None
    profiled_counts: dict = field(default_factory=dict)
    profiled_calls: list = field(default_factory=list)  # (rounds, s)
    calls: list = field(default_factory=list)     # (rounds, seconds)


class StampClock:
    """The buffers' arrival clock (ms): the harness's stamp, so that the
    stamps behind the buffer's target size are inputs both sides get."""
    stamp_ms = 0.0

    def __call__(self) -> float:
        return self.stamp_ms


def forbidden_modules(names=None) -> list[str]:
    """The top-level names among `names` (the loaded modules by default)
    that are jax, jaxlib, flax or the JAX package, compared whole:
    kafka_ps_tpu_torch is the program."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _ps_config(cfg: dict):
    from kafka_ps_tpu_torch.utils.config import (BufferConfig, ModelConfig,
                                                 PSConfig)
    b = cfg["buffer"]
    return PSConfig(
        num_workers=cfg["num_workers"],
        consistency_model=cfg["consistency_model"],
        task=cfg["task"],
        model=ModelConfig(**{f.name: cfg[f.name]
                             for f in dataclasses.fields(ModelConfig)
                             if f.name in cfg}),
        buffer=BufferConfig(min_size=b["min_size"], max_size=b["max_size"],
                            coefficient=b["coefficient"],
                            arrival_window=b["arrival_window"]),
        learning_rate=cfg.get("server_learning_rate"),
        eval_every=cfg["eval_every"])


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "?"
    except (OSError, subprocess.SubprocessError):
        return "?"


class CellRun:
    def __init__(self, cell: manifest.Cell, seed: int, seconds: float,
                 trace: bool, device: str, t_process: float):
        if cell.traffic["entry"] != "fused":
            raise ValueError(f"{cell.name}: the harness drives the fused "
                             f"path only, not {cell.traffic['entry']!r}")
        self.cfg = cell.config
        self.traffic = cell.traffic
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.t_process = t_process
        self.n = self.cfg["num_workers"]
        self.family = cell.family
        self.rows = manifest.rows(self.family.ROWS)
        kind = torch.cuda.get_device_name(0) if self.cuda else "cpu"
        self.run = Run(cell.name, self.cfg, self.traffic, kind,
                       card_peak(kind))
        self.server_rows: list[str] = []
        self.worker_rows: list[str] = []
        self.handed: list = []      # (worker, record, label, stamp ms)
        self.marks = [("imports and CUDA context", time.perf_counter())]

    # -- set-up -----------------------------------------------------------

    def build(self) -> None:
        from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
        from kafka_ps_tpu_torch.utils.trace import Tracer
        cfg, tr, rows = self.cfg, self.traffic, self.rows
        burst = tr["burst_per_worker"] * self.n
        records, labels = rows.make(cfg, self.seed,
                                    burst + tr["test_rows"])
        self.test = rows.test(tuple(a[burst:] for a in records),
                              labels[burst:])
        self.tracer = Tracer() if self.trace else None
        clock = StampClock()
        self.app = StreamingPSApp(
            _ps_config(cfg), *self.test,
            server_log=self.server_rows.append,
            worker_log=self.worker_rows.append, clock_ms=clock,
            device=self.device, tracer=self.tracer)
        self.app.build_kernels()
        self._mark("app and kernels")
        for i in range(burst):
            w = i % self.n
            self.handed.append((w, tuple(a[i] for a in records),
                                int(labels[i]), clock.stamp_ms))
            self.app.data_sink(w, rows.handed(records, i), int(labels[i]))
        self.follow = self.family.Model(
            cfg, [h[1] for h in self.handed]).follow
        self._mark("burst")

    def _mark(self, name: str) -> None:
        self.marks.append((name, time.perf_counter()))

    def call(self, rounds: int) -> float:
        t = time.perf_counter()
        self.app.run_fused_bsp(self.app.server.iterations + rounds * self.n)
        return time.perf_counter() - t

    def first_rounds(self) -> None:
        """The rounds the check follows (check.py), then the warm-up:
        every shape and path of the window has run once after them."""
        self.thetas = []
        for _ in range(check.SETUP_ROUNDS):
            self.call(1)
            self.thetas.append(self.follow.snapshot(self.app.server.theta))
        self.call(check.CALL_ROUNDS)
        self.theta_call = self.follow.snapshot(self.app.server.theta)
        self._mark("checked rounds")
        self.setup_worker_rows = list(self.worker_rows)
        self.setup_server_rows = list(self.server_rows)
        warm = self.call(WARM_ROUNDS)
        self.rounds_per_call = self._size(WARM_ROUNDS, warm)
        if self.trace and self.cuda:
            devtrace.warm_up()
        self._mark("warm-up")

    def _size(self, rounds: int, seconds: float) -> int:
        """Rounds for a call of about CALL_S, a multiple of the eval
        period so that every call ends on an eval clock."""
        period = self.cfg["eval_every"]
        want = rounds * CALL_S / max(seconds, 1e-6)
        return max(period, int(round(want / period)) * period)

    # -- the window -------------------------------------------------------

    def window(self) -> None:
        from kafka_ps_tpu_torch.ops import fused_update
        run = self.run
        profiler = devtrace.Profiler() if self.trace and self.cuda \
            else None
        if self.trace:
            self.tracer.clear()
            self.tracer.enabled = profiler is None
        profile_s = min(PROFILE_S, self.seconds / 2)
        tries = 0
        calls: list[devtrace.HostSpan] = []
        it0 = self.app.server.iterations
        t_start = time.perf_counter()
        run.setup_s = t_start - self.t_process
        if profiler is not None:
            profiler.start()
            counts0 = fused_update.counts()
            p_start, p_first = t_start, 0
        rounds = self.rounds_per_call
        while True:
            t_ns = time.time_ns()
            took = self.call(rounds)
            calls.append(devtrace.HostSpan("portbench.fused_call", t_ns,
                                           time.time_ns()))
            run.calls.append((rounds, took))
            now = time.perf_counter()
            if profiler is not None and now - p_start >= profile_s:
                torch.cuda.synchronize()
                events = profiler.stop()
                prof = devtrace.summarize(events, profiler.t0_ns,
                                          profiler.t1_ns, calls)
                tries += 1
                if prof is not None:
                    run.profile = prof
                    run.profiled_counts = {
                        k: v - counts0[k]
                        for k, v in fused_update.counts().items()}
                    run.profiled_calls = run.calls[p_first:]
                    profiler = None
                    self.tracer.enabled = True
                elif tries >= devtrace.TRIES:
                    raise RuntimeError(
                        f"{tries} device traces held no device event")
                else:
                    profiler.start()
                    counts0 = fused_update.counts()
                    p_start, p_first = time.perf_counter(), len(run.calls)
            elif now - t_start >= self.seconds:
                break
            rounds = self._size(rounds, took)
        if self.cuda:
            torch.cuda.synchronize()
        t_end = time.perf_counter()
        run.window_s = t_end - t_start
        run.updates = self.app.server.iterations - it0
        if self.trace:
            for e in self._tracer_events():
                if e.get("ph") == "X":
                    run.spans.setdefault(e["name"], []).append(
                        (e["dur"] / 1e3, e.get("args", {})))
        self.memory_peak = (torch.cuda.max_memory_allocated(self.device)
                            if self.cuda else 0)

    def _tracer_events(self) -> list[dict]:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.tracer.dump(path)
            with open(path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.unlink(path)

    # -- after the window ---------------------------------------------------

    def produced(self) -> check.Produced:
        """What the program produced for the check."""
        losses = {}
        for r in self.setup_worker_rows:
            f = r.split(";")
            losses[int(f[2])] = float(f[3])
        evals = {}
        for r in self.setup_server_rows:
            f = r.split(";")
            evals[int(f[2])] = (float(f[3]), float(f[4]), float(f[5]))
        buffers = [b.state() for b in self.app.buffers]
        return check.Produced(
            losses, self.thetas, self.theta_call, evals,
            [(self.rows.program(s), s["y"], s["ids"]) for s in buffers])

    def close(self) -> None:
        self.app.close_logs()
        self.app = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def reference(self, prec=None, half_batch: bool = False):
        """The reference on the inputs handed to the program; `prec` (the
        family's CONTROL) or `half_batch` make it a control or a fault."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return check.Reference(self.family, self.cfg,
                               self.rows.fields(self.cfg), self.handed,
                               self.test, self.device, prec, half_batch)


def result_line(cr: CellRun, values: dict, limits: dict, trace: bool,
                metrics: dict) -> tuple[dict, dict]:
    correct, checks = check.verdict(values, limits)
    run = cr.run
    device = {"platform": "gpu" if cr.cuda else "cpu",
              "kind": run.device_kind, "count": 1,
              "memory_peak_bytes": int(cr.memory_peak)}
    out = {"correct": correct, "attempted": int(run.updates), "failed": 0,
           "metrics": metrics, "device": device}
    if trace and run.profile is not None:
        device["busy_s"] = run.profile.busy_s
        device["window_s"] = run.profile.window_s
        out["breakdown"] = run.profile.breakdown()
    out["checks"] = checks
    return out, checks


def execute(cell_name: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t_process: float | None = None,
            cell: manifest.Cell | None = None,
            limits: dict | None = None) -> dict:
    """Run one cell and return its result object."""
    cell = cell or manifest.cell(cell_name)
    if t_process is None:
        t_process = time.perf_counter()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cr = CellRun(cell, seed, seconds, trace, device, t_process)
    cr.build()
    cr.first_rounds()
    cr.window()
    produced = cr.produced()
    cr.close()
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.read(cr.run)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    values = check.readings(produced, cr.reference())
    limits = limits if limits is not None else check.load_limits(cell.name)
    out, checks = result_line(cr, values, limits, trace, metrics)
    if cr.cuda and trace:
        print(f"card: {_power_limit()}", file=sys.stderr)
    t, parts = t_process, []
    for name, at in cr.marks:
        parts.append(f"{name} {at - t:.3f}")
        t = at
    print(f"setup: {', '.join(parts)} s", file=sys.stderr)
    rates = [r / s for r, s in cr.run.calls if s > 0]
    print(f"window: {len(rates)} calls, {cr.run.window_s:.3f} s, rounds/s "
          f"per call min {min(rates):.1f} median {np.median(rates):.1f} "
          f"max {max(rates):.1f}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules loaded that the benchmark must not "
                           f"load: {bad}")
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return out
