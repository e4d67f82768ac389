"""Liveness watchdogs and the health/introspection HTTP plane
(counterpart of kafka_ps_tpu/telemetry/health.py).

Watchdog semantics — the JAX plane's, conservative because a false
positive here kills a healthy pod:

    a watchdog TRIPS iff demand has been continuously true AND no
    progress beat arrived for more than `threshold_s`:

        now - max(last_beat, demand_since) > threshold_s

  * `demand` is "is there work this subsystem owes progress on?" —
    workers waiting at the gate, requests queued for serving, an fsync
    in flight.  No demand, no trip: an idle gate is healthy forever.
  * a beat (FLIGHT.beat from the subsystem's hot path) restarts the
    window: a slow-but-alive BSP round keeps beating on every gradient
    arrival, so sleepy workers never trip it.
  * demand dropping clears the window AND the trip: watchdogs latch a
    one-time flight event + dump on the tripped edge but UN-trip on
    recovery — readiness comes back when the stall resolves.

The HTTP plane is stdlib-only (http.server on a named daemon thread):

    /healthz   200/503 JSON — watchdog-derived liveness/readiness,
               plus the SLO plane's burn-rate detail when armed
    /varz      Prometheus text exposition (telemetry registry)
    /flightz   recent flight-ring tail as JSON (?n=200)
    /profilez  collapsed-stack text from the sampling profiler
               (--profile; 404 when not armed)
    /modelz    model-health detail — per-worker contribution/divergence
               plus the drift verdict (--model-health; 404 when not
               armed)
    /evalz     async eval-engine detail — queue depth, clock lag,
               dispatch/coalesce counters (404 when the engine is not
               attached, e.g. --no-eval-async)

The 404 bodies are the JAX plane's, byte for byte.

`OpsPlane` bundles recorder + panel + server lifecycle for the CLI
roles (cli/run.py, cli/socket_mode.py): construct, add watchdogs,
start(), close() in the teardown path — close writes the final flight
dump before the process exits.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from kafka_ps_tpu_torch.telemetry.flight import FLIGHT

# Default stall thresholds (seconds).  Generous on purpose: tripping a
# healthy process is worse than diagnosing a wedged one 30 s late.
GATE_STALL_S = 30.0
FSYNC_STALL_S = 15.0
SERVING_STALL_S = 15.0
REPLICA_STALL_S = 30.0
# A fast-window burn over 1.0 must persist this long before the SLO
# watchdog trips a flight dump — one transiently slow batch is not an
# incident.
SLO_BURN_STALL_S = 60.0
# A latched DRIFT verdict (telemetry/drift.py) is continuous demand
# with no beat, so the armed watchdog trips — and ships the flight
# dump — this long after the trip.  Short on purpose: the drift
# monitor already debounced (warn level, calm decay) before latching.
DRIFT_DUMP_S = 1.0


class Liveness:
    """One subsystem's watchdog.  `beat_name` keys into the flight
    recorder's beat table; `demand` is a zero-arg callable returning
    truthy while the subsystem owes progress (None = always demanded).
    `check()` is driven by the panel thread (or directly by tests)."""

    def __init__(self, name: str, threshold_s: float, *,
                 beat_name: str | None = None, demand=None,
                 flight=None):
        self.name = name
        self.threshold_s = float(threshold_s)
        self.beat_name = beat_name or name
        self.demand = demand
        self.flight = flight if flight is not None else FLIGHT
        self.tripped = False
        self.trip_count = 0
        self.last_reason = ""
        self._demand_since: float | None = None
        self._armed_at = time.monotonic()

    def check(self, now: float | None = None) -> bool:
        """Evaluate; returns the (possibly new) tripped state."""
        now = time.monotonic() if now is None else now
        demanded = True if self.demand is None else bool(self.demand())
        if not demanded:
            self._demand_since = None
            self.tripped = False
            return False
        if self._demand_since is None:
            self._demand_since = now
        beat = self.flight.last_beat(self.beat_name)
        window_start = max(self._demand_since,
                           beat if beat is not None else self._armed_at)
        stalled_for = now - window_start
        if stalled_for > self.threshold_s:
            if not self.tripped:
                self.trip_count += 1
                self.last_reason = (
                    f"{self.name}: no progress for {stalled_for:.1f}s "
                    f"with demand (threshold {self.threshold_s:g}s)")
            self.tripped = True
        else:
            self.tripped = False
        return self.tripped

    def state(self) -> dict:
        return {"tripped": self.tripped, "threshold_s": self.threshold_s,
                "trip_count": self.trip_count, "reason": self.last_reason}


class WatchdogPanel:
    """Polls a set of Liveness watchdogs on a named daemon thread and
    latches a flight event + one dump per tripped edge.  `healthy()`
    is the /healthz verdict: True iff no watchdog is currently
    tripped."""

    def __init__(self, flight=None, poll_s: float = 0.5):
        self.flight = flight if flight is not None else FLIGHT
        self.poll_s = poll_s
        self.watchdogs: list[Liveness] = []
        # pscheck: disable=PS201 (watchdog-tick state; a racing manual check_now at worst duplicates one dump)
        self._dumped_trips: dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def add(self, dog: Liveness) -> Liveness:
        self.watchdogs.append(dog)
        return dog

    def check_now(self) -> bool:
        """One poll round (the thread's body; tests call it directly).
        Returns current overall health."""
        now = time.monotonic()
        for dog in self.watchdogs:
            was = dog.tripped
            dog.check(now)
            if dog.tripped and not was:
                self.flight.record("watchdog.trip", name=dog.name,
                                   reason=dog.last_reason)
                # one dump per trip edge: recovery re-arms it
                if self._dumped_trips.get(dog.name) != dog.trip_count \
                        and self.flight.enabled \
                        and self.flight.flight_dir is not None:
                    self._dumped_trips[dog.name] = dog.trip_count
                    try:
                        self.flight.dump(
                            reason=f"watchdog:{dog.name}")
                    except OSError:
                        pass
        return self.healthy()

    def healthy(self) -> bool:
        return not any(d.tripped for d in self.watchdogs)

    def states(self) -> dict:
        return {d.name: d.state() for d in self.watchdogs}

    def start(self) -> None:
        if self._thread is not None or not self.watchdogs:
            return
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.poll_s):
                self.check_now()

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="kps-watchdog")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=10.0)
        self._thread = None


class HealthServer:
    """The introspection HTTP plane.  Port 0 binds an ephemeral port
    (read `.port` after construction — printed by the CLI so smoke
    scripts can scrape it, like the serving plane does)."""

    def __init__(self, port: int, *, panel: WatchdogPanel | None = None,
                 flight=None, telemetry=None, slo=None, modelhealth=None,
                 eval_engine=None, host: str = "0.0.0.0"):
        self.panel = panel
        self.flight = flight if flight is not None else FLIGHT
        self.telemetry = telemetry
        self.slo = slo                  # SLOPlane (telemetry/slo.py)
        self.modelhealth = modelhealth  # ModelHealth (modelhealth.py)
        self.eval_engine = eval_engine  # EvalEngine (evaluation/engine.py)
        plane = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet: probes every few secs
                pass

            def do_GET(self):
                plane._respond(self)

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="kps-health")
        self._thread.start()

    def _respond(self, req: BaseHTTPRequestHandler) -> None:
        url = urlparse(req.path)
        try:
            if url.path == "/healthz":
                healthy = self.panel.healthy() if self.panel else True
                detail = {
                    "healthy": healthy,
                    "role": self.flight.role,
                    "shard": self.flight.shard,
                    "watchdogs": (self.panel.states()
                                  if self.panel else {}),
                }
                if self.slo is not None:
                    detail["slo"] = self.slo.detail()
                body = json.dumps(detail).encode()
                self._send(req, 200 if healthy else 503, body,
                           "application/json")
            elif url.path == "/varz":
                text = (self.telemetry.prometheus_text()
                        if self.telemetry is not None else "")
                self._send(req, 200, text.encode(),
                           "text/plain; version=0.0.4")
            elif url.path == "/flightz":
                q = parse_qs(url.query)
                n = int(q.get("n", ["200"])[0])
                body = json.dumps({
                    "enabled": self.flight.enabled,
                    "role": self.flight.role,
                    "shard": self.flight.shard,
                    "events": self.flight.tail(n),
                }).encode()
                self._send(req, 200, body, "application/json")
            elif url.path == "/profilez":
                prof = getattr(self.flight, "profiler", None)
                if prof is None:
                    self._send(req, 404,
                               b'{"error": "profiler not armed '
                               b'(--profile)"}',
                               "application/json")
                else:
                    stats = prof.stats()
                    header = "".join(f"# {k}: {v}\n"
                                     for k, v in sorted(stats.items()))
                    text = header + prof.collapsed() + "\n"
                    self._send(req, 200, text.encode(), "text/plain")
            elif url.path == "/modelz":
                plane_mh = self.modelhealth
                if plane_mh is None or not plane_mh.enabled:
                    self._send(req, 404,
                               b'{"error": "model health not armed '
                               b'(--model-health)"}',
                               "application/json")
                else:
                    body = json.dumps({
                        "role": self.flight.role,
                        "shard": self.flight.shard,
                        **plane_mh.detail(),
                    }).encode()
                    self._send(req, 200, body, "application/json")
            elif url.path == "/evalz":
                eng = self.eval_engine
                if eng is None:
                    self._send(req, 404,
                               b'{"error": "async eval engine not '
                               b'attached (--no-eval-async or no test '
                               b'set)"}',
                               "application/json")
                else:
                    body = json.dumps({
                        "role": self.flight.role,
                        "shard": self.flight.shard,
                        **eng.stats(),
                    }).encode()
                    self._send(req, 200, body, "application/json")
            else:
                self._send(req, 404, b'{"error": "unknown path"}',
                           "application/json")
        except (BrokenPipeError, ConnectionError):
            pass                        # probe hung up; not our problem

    @staticmethod
    def _send(req, status: int, body: bytes, ctype: str) -> None:
        req.send_response(status)
        req.send_header("Content-Type", ctype)
        req.send_header("Content-Length", str(len(body)))
        req.end_headers()
        req.wfile.write(body)

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=10.0)


class OpsPlane:
    """Recorder + watchdogs + health server + the analysis planes'
    samplers as one lifecycle object for the CLI roles.  Inert (a cheap
    no-op) when none of --flight-dir, --health-port, --profile, an SLO
    plane or a model-health plane was given, so wiring is
    unconditional."""

    def __init__(self, *, flight_dir: str | None = None,
                 health_port: int | None = None, telemetry=None,
                 role: str = "run", shard: int | None = None,
                 meta: dict | None = None, flight=None,
                 profile: bool = False, profile_hz: float = 100.0,
                 slo_plane=None, modelhealth=None):
        self.flight = flight if flight is not None else FLIGHT
        self.enabled = (flight_dir is not None or health_port is not None
                        or profile or slo_plane is not None
                        or modelhealth is not None)
        self.health: HealthServer | None = None
        self.panel: WatchdogPanel | None = None
        self.profiler = None
        self.slo = None                 # SLOPlane via add_slo_plane
        self.modelhealth = None         # ModelHealth via add_modelhealth
        self.eval_engine = None         # EvalEngine via add_eval_engine
        self._health_port = health_port
        self._telemetry = telemetry
        if not self.enabled:
            return
        self.flight.enable(role=role, shard=shard, flight_dir=flight_dir,
                           telemetry=telemetry, meta=meta)
        if flight_dir is not None:
            self.flight.install_death_hooks()
        self.panel = WatchdogPanel(flight=self.flight)
        self.flight.panel = self.panel
        if profile:
            # deferred import: the plane must construct without the
            # profiler module when --profile was not asked for
            from kafka_ps_tpu_torch.telemetry.profiler import SamplingProfiler
            self.profiler = SamplingProfiler(hz=profile_hz)
            self.flight.profiler = self.profiler
        if slo_plane is not None:
            self.add_slo_plane(slo_plane)
        if modelhealth is not None:
            self.add_modelhealth(modelhealth)

    def add_watchdog(self, name: str, threshold_s: float, *,
                     beat_name: str | None = None,
                     demand=None) -> Liveness | None:
        if self.panel is None:
            return None
        return self.panel.add(Liveness(name, threshold_s,
                                       beat_name=beat_name, demand=demand,
                                       flight=self.flight))

    def add_gate_watchdog(self, server,
                          threshold_s: float = GATE_STALL_S) -> None:
        """BSP/bounded gate stalled with workers parked at it."""
        self.add_watchdog("gate", threshold_s, beat_name="gate",
                          demand=lambda: server.gate_waiting() > 0)

    def add_fsync_watchdog(self,
                           threshold_s: float = FSYNC_STALL_S) -> None:
        """A sync flush entered (flight.enter) but never exited."""
        self.add_watchdog(
            "log.fsync", threshold_s, beat_name="log.fsync",
            demand=lambda: self.flight.inflight_age("log.fsync")
            is not None)

    def add_serving_watchdog(self, engine,
                             threshold_s: float = SERVING_STALL_S) -> None:
        """Requests queued but the batcher stopped draining."""
        self.add_watchdog("serving", threshold_s, beat_name="serving",
                          demand=lambda: engine.queue_depth() > 0)

    def add_replica_watchdog(self,
                             threshold_s: float = REPLICA_STALL_S) -> None:
        """The log tail poll loop stopped turning (beats every poll,
        even an empty one, so demand is unconditional)."""
        self.add_watchdog("replica", threshold_s, beat_name="replica")

    def add_slo_plane(self, slo,
                      threshold_s: float = SLO_BURN_STALL_S) -> None:
        """Adopt an SLOPlane (telemetry/slo.py): surface it on
        /healthz, run its sampler from start(), and arm the burn-rate
        watchdog — the plane beats `slo` while no fast window is
        burning, so sustained burn is exactly a demand-with-no-progress
        stall and trips one flight dump."""
        self.slo = slo
        self.add_watchdog("slo", threshold_s, beat_name="slo",
                          demand=slo.burning)

    def add_modelhealth(self, plane,
                        threshold_s: float = DRIFT_DUMP_S) -> None:
        """Adopt a ModelHealth plane (telemetry/modelhealth.py):
        surface it on /modelz, run its sampler from start(), and arm
        the drift watchdog — a latched DRIFT is continuous demand that
        nothing beats, so the dog trips once past `threshold_s` and
        the panel ships the flight dump with the `drift.trip` event
        still in the ring."""
        self.modelhealth = plane
        self.add_watchdog("drift", threshold_s, beat_name="drift",
                          demand=plane.in_drift)

    def add_eval_engine(self, engine) -> None:
        """Surface the async eval engine on /evalz (queue depth, clock
        lag, coalesce counters).  No watchdog: a lagging engine is a
        throughput observation, not a liveness failure — the lag gauge
        (`eval_lag_clocks`) is the alerting surface."""
        self.eval_engine = engine

    def start(self) -> None:
        if not self.enabled:
            return
        if self.profiler is not None:
            self.profiler.start()
        if self.slo is not None:
            self.slo.start()
        if self.modelhealth is not None:
            self.modelhealth.start()
        if self.panel is not None:
            self.panel.start()
        if self._health_port is not None:
            self.health = HealthServer(self._health_port, panel=self.panel,
                                       flight=self.flight,
                                       telemetry=self._telemetry,
                                       slo=self.slo,
                                       modelhealth=self.modelhealth,
                                       eval_engine=self.eval_engine)
            print(f"health plane on port {self.health.port}",
                  file=sys.stderr, flush=True)

    def close(self, reason: str = "shutdown") -> None:
        if not self.enabled:
            return
        if self.health is not None:
            self.health.close()
            self.health = None
        if self.slo is not None:
            self.slo.stop()
        if self.modelhealth is not None:
            # stop() drains the deferred queues, so the final flight
            # dump below sees the complete drift verdict
            self.modelhealth.stop()
        if self.profiler is not None:
            self.profiler.stop()
        if self.panel is not None:
            self.panel.stop()
        if self.flight.flight_dir is not None:
            try:
                self.flight.dump(reason=reason)
            except OSError:
                pass
        self.flight.disable()
        self.enabled = False
