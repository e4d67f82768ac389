"""Role processes run with their telemetry flags, for the process-level
telemetry tests (tests/test_torch_role_telemetry_runs.py,
tests/test_torch_role_telemetry_scaleout.py) and chip_smoke.py's role
telemetry phase.  Imports no JAX.

`Role` starts one role runner of either package in its own directory
with `--trace`, `--metrics-file`, `--flight-dir` and `--health-port 0`,
follows its stderr (the port it announces, its `[status]` lines, its
stats line), polls `/healthz` from a thread while the process runs, and
reads back the trace, metrics file and flight dumps it wrote.
"""

from __future__ import annotations

import glob
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

TEL_FLAGS = ("--trace", "trace.json", "--metrics-file", "metrics.prom",
             "--metrics-every", "0.5", "--flight-dir", "flight",
             "--health-port", "0")
PORT_PKG, JAX_PKG = "kafka_ps_tpu_torch", "kafka_ps_tpu"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def healthz(port: int) -> tuple[int, dict] | None:
    """One GET of /healthz on `port`: (HTTP status, JSON body), or None
    while the plane is not up yet or going down."""
    url = f"http://127.0.0.1:{port}/healthz"
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    except (OSError, ValueError):
        return None


class HealthFiles:
    """/healthz of processes whose stderr goes to files (chip_smoke.py's
    deployments), polled from a thread every 0.2 s until finish(): each
    one's "health plane on port N" line is read from its file, and every
    answer is kept in `answers[file]`."""

    def __init__(self, errs):
        self.answers: dict = {e: [] for e in errs}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()

    def _poll(self) -> None:
        ports: dict = {}
        while not self._stop.is_set():
            for e in self.answers:
                if e not in ports and os.path.exists(e):
                    with open(e) as f:
                        m = re.search(r"health plane on port (\d+)",
                                      f.read())
                    if m:
                        ports[e] = int(m.group(1))
            for e, port in ports.items():
                answer = healthz(port)
                if answer is not None:
                    self.answers[e].append(answer)
            self._stop.wait(0.2)

    def finish(self) -> None:
        self._stop.set()
        self._thread.join(10)


class Role:
    """One role runner process (`python -m PKG.cli.RUNNER ARGS`, plus the
    telemetry flags unless `telemetry=False`) in `cwd`."""

    def __init__(self, pkg: str, runner: str, args, cwd, env: dict,
                 telemetry: bool = True):
        self.pkg, self.cwd = pkg, str(cwd)
        os.makedirs(self.cwd, exist_ok=True)
        argv = [sys.executable, "-m", f"{pkg}.cli.{runner}", *map(str, args),
                *(TEL_FLAGS if telemetry else ())]
        self.proc = subprocess.Popen(argv, cwd=self.cwd, env=env,
                                     stdout=subprocess.DEVNULL,
                                     stderr=subprocess.PIPE, text=True)
        self.lines: list[str] = []
        self.health: list[tuple[int, dict]] = []   # /healthz answers
        self._cond = threading.Condition()
        self._threads = [threading.Thread(target=self._drain, daemon=True)]
        self._threads[0].start()

    def _drain(self) -> None:
        for line in self.proc.stderr:
            with self._cond:
                self.lines.append(line)
                self._cond.notify_all()
            m = re.match(r"health plane on port (\d+)", line)
            if m:
                t = threading.Thread(target=self._poll_health,
                                     args=(int(m.group(1)),), daemon=True)
                self._threads.append(t)
                t.start()

    def _poll_health(self, port: int) -> None:
        """GET /healthz every 0.2 s until the process ends."""
        while self.proc.poll() is None:
            answer = healthz(port)
            if answer is not None:
                self.health.append(answer)
            time.sleep(0.2)

    def wait_for(self, pattern: str, timeout: float = 120.0) -> re.Match:
        """The first stderr line matching `pattern` (re.search)."""
        deadline = time.monotonic() + timeout
        rx = re.compile(pattern)
        seen = 0
        with self._cond:
            while True:
                for line in self.lines[seen:]:
                    m = rx.search(line)
                    if m:
                        return m
                seen = len(self.lines)
                left = deadline - time.monotonic()
                if left <= 0 or (self.proc.poll() is not None
                                 and not self._threads[0].is_alive()):
                    raise TimeoutError(
                        f"{self.cwd}: no line matching {pattern!r}:\n"
                        + "".join(self.lines[-30:]))
                self._cond.wait(min(left, 0.5))

    def wait(self, timeout: float = 150.0) -> int:
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            raise
        for t in self._threads:
            t.join(timeout=10.0)
        return rc

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()

    @property
    def err(self) -> str:
        return "".join(self.lines)

    def stats(self, role: str) -> dict:
        """The port's stats line `kafka_ps_tpu_torch ROLE: {json}`."""
        tag = f"{PORT_PKG} {role}: "
        found = [ln for ln in self.lines if ln.startswith(tag)]
        if not found:
            raise AssertionError(f"{self.cwd}: no stats line:\n"
                                 + self.err[-3000:])
        return json.loads(found[-1][len(tag):])

    def status_iters(self) -> list[int]:
        """The `iters=` of every `[status]` line, in order."""
        return [int(re.search(r"iters=(\d+)", ln).group(1))
                for ln in self.lines if ln.startswith("[status] ")]

    # -- what the process wrote ---------------------------------------------

    def path(self, name: str) -> str:
        return os.path.join(self.cwd, name)

    def trace(self) -> dict:
        with open(self.path("trace.json")) as f:
            return json.load(f)

    def metrics(self) -> dict:
        return prom_values(self.path("metrics.prom"))

    def metric_types(self) -> dict:
        return prom_types(self.path("metrics.prom"))

    def dumps(self) -> list[dict]:
        out = []
        for p in sorted(glob.glob(self.path("flight/flightdump-*.json"))):
            with open(p) as f:
                out.append(json.load(f))
        return out


def prom_types(path: str) -> dict:
    """{family: kind} of a Prometheus text file."""
    with open(path) as f:
        return dict(re.findall(r"^# TYPE (\S+) (\S+)", f.read(), re.M))


def prom_values(path: str) -> dict:
    """{sample name: {label string: value}} of a Prometheus text file
    (a label-less sample under "")."""
    out: dict = {}
    with open(path) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            m = re.match(r"^(\w+)(?:\{(.*)\})? (\S+)$", line.strip())
            out.setdefault(m.group(1), {})[m.group(2) or ""] = \
                float(m.group(3))
    return out


def flow_ids(trace: dict, name: str, ph: str) -> list:
    """The ids of `trace`'s flow events `name` of phase `ph` (s, t, f)."""
    return [e["id"] for e in trace["traceEvents"]
            if e.get("name") == name and e.get("ph") == ph]


def event_kinds(dumps: list[dict]) -> set:
    return {e["kind"] for d in dumps for e in d["events"]}
