"""Model-health plane (counterpart of kafka_ps_tpu/telemetry/modelhealth.py):
streaming training diagnostics and the drift wiring.

At the server's apply path it derives, per accepted gradient:

  * the delta's L2 norm                    -> `update_norm{model}`
  * cosine vs an EWMA aggregate direction  -> `update_cosine` gauge
  * per-worker contribution share and direction divergence
                                           -> `worker_contribution_share`
                                              / `worker_divergence{worker}`

and feeds every streaming eval row plus sampled buffer arrivals into a
`DriftMonitor` (telemetry/drift.py).

Hot paths hold `NULL_MODEL_HEALTH` by default and guard with
`if self.modelhealth.enabled:` — one attribute load when disarmed, and
theta stays bitwise-identical when armed because everything here reads
values the update already produced and writes none.

Two ingest speeds, decided by where the values came from, as in JAX:

  * **a host numpy array** (the socket and durable-log paths: serde
    decoded the frame into one before it went to the device, and hands
    it over as the message's `host_values`): diagnostics compute inline,
    O(num_params) numpy on bytes the transport already paid for;
  * **a torch tensor** (the in-process fabric — the kernels' outputs,
    on the card or on the CPU alike): the hot path only enqueues a
    reference into a small bounded deque, and the plane's sampler thread
    (`kps-modelhealth`, ~4 Hz) copies them to the host off-path.  Eval
    metrics likewise: the hot path enqueues the scalar tensors, the
    sampler floats them.  Overrun drops the oldest reference — sampling,
    not backpressure.

A deferred tensor is never written after it is observed: every kernel
call returns new tensors and the server replaces theta, never mutates
it.  All of them are produced on the device's default stream, which is
also the sampler thread's, so its copy is ordered after the kernel that
wrote the values and `observe_*` never synchronises.  The copy is
`.to("cpu", float32)`: `np.asarray` on a CUDA tensor raises, and a failed
resolution is not swallowed (it raises on the sampler thread and in
`stop()`'s final drain).

The plane is also the surfacing hub: `summary()` rides the `[status]`
heartbeat, `detail()` is the /modelz body (telemetry/health.py), and
`in_drift()` is the armed watchdog's demand predicate so a latched
DRIFT ships one flight dump.
"""

from __future__ import annotations

import threading
from collections import deque

import numpy as np
import torch

from kafka_ps_tpu_torch.analysis.lockgraph import OrderedLock
from kafka_ps_tpu_torch.telemetry.drift import DriftMonitor

# log-spaced like the latency buckets: delta norms span regimes from
# converged (1e-3) to exploding (1e2)
NORM_BUCKETS = (1e-4, 1e-3, 3e-3, 0.01, 0.03, 0.1, 0.3,
                1.0, 3.0, 10.0, 30.0, 100.0)
DEFAULT_SAMPLE_EVERY_S = 0.25
EWMA_ALPHA = 0.05
# bounded deferred queues: device-delta refs and pending eval futures
_PENDING_DELTAS = 64
_PENDING_EVALS = 256
_EPS = 1e-12


def _host_vector(values) -> np.ndarray:
    """A deferred delta as a host float32 array: a tensor (on the card or
    the CPU) by one copy, anything else through numpy."""
    if isinstance(values, torch.Tensor):
        return values.detach().to("cpu", torch.float32).numpy()
    return np.asarray(values, dtype=np.float32)


class _NullModelHealth:
    """The disarmed plane: every hot-path site guards on `.enabled`, so
    these bodies exist only for direct callers (status, tests)."""

    enabled = False

    def observe_update(self, worker, values) -> None:
        pass

    def observe_eval(self, loss, f1) -> None:
        pass

    def poll(self) -> dict:
        return {}

    def start(self) -> "_NullModelHealth":
        return self

    def stop(self) -> None:
        pass

    def in_drift(self) -> bool:
        return False

    def summary(self) -> dict:
        return {}

    def detail(self) -> dict:
        return {}


NULL_MODEL_HEALTH = _NullModelHealth()


class ModelHealth:
    """The armed plane: per-update diagnostics + the drift monitor +
    the sampler thread that resolves deferred device values."""

    enabled = True

    def __init__(self, telemetry, drift: DriftMonitor, *,
                 model: str = "sequential", shard: int | None = None,
                 ewma_alpha: float = EWMA_ALPHA,
                 sample_every_s: float = DEFAULT_SAMPLE_EVERY_S):
        self.telemetry = telemetry
        self.drift = drift
        self.shard = shard
        self._alpha = float(ewma_alpha)
        self.sample_every_s = float(sample_every_s)
        self._labels = {"shard": str(shard)} if shard is not None else {}
        # pre-resolved children (the worker/server construction idiom):
        # one leaf observe per update when armed
        self._m_norm = telemetry.histogram(
            "update_norm", buckets=NORM_BUCKETS,
            help_text="L2 norm of each applied delta",
            model=model, **self._labels)
        self._g_cosine = telemetry.gauge(
            "update_cosine",
            help_text="cosine of the latest delta vs the EWMA "
                      "aggregate direction", **self._labels)
        self._c_updates = telemetry.counter(
            "modelhealth_updates_total", **self._labels)
        self._c_deferred = telemetry.counter(
            "modelhealth_deferred_total",
            help_text="device deltas observed by reference (resolved "
                      "sampled, off the hot path)", **self._labels)
        # pscheck: disable=PS201 (gauge-child cache filled outside the lock by PS106 design; racers store registry-deduped children, GIL-atomic)
        self._per_worker: dict[int, tuple] = {}   # id -> (share, div)
        self._lock = OrderedLock("telemetry.modelhealth")
        # EWMA aggregate direction (unit host vector) + per-worker state
        self._dir: np.ndarray | None = None
        self._w_norm_ewma: dict[int, float] = {}
        self._w_divergence: dict[int, float] = {}
        self._w_updates: dict[int, int] = {}
        # guarded-by: _lock (ingest holds it; poll's lock-free read is a monotonic count)
        self.updates = 0
        self.last_norm = 0.0
        self.last_cosine = 1.0
        self._deltas: deque = deque(maxlen=_PENDING_DELTAS)
        self._evals: deque = deque(maxlen=_PENDING_EVALS)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- hot-path entry points (server/worker threads) ----------------------

    def observe_update(self, worker: int, values) -> None:
        """One accepted gradient.  Host arrays compute inline (the
        socket path already paid the transfer); tensors defer — the
        apply path must never wait on the device."""
        if isinstance(values, np.ndarray):
            self._ingest(worker, values)
            return
        with self._lock:
            self._deltas.append((worker, values))
        self._c_deferred.inc()

    def observe_eval(self, loss, f1) -> None:
        """One streaming eval row; fields may be scalar tensors still
        being computed — they resolve on the sampler thread, never
        here."""
        with self._lock:
            self._evals.append((loss, f1))

    # -- diagnostics math ---------------------------------------------------

    def _ingest(self, worker: int, vec: np.ndarray) -> None:
        vec = vec.reshape(-1)
        norm = float(np.linalg.norm(vec))
        with self._lock:
            self.updates += 1
            self.last_norm = norm
            if norm > _EPS:
                unit = (vec / norm).astype(np.float32)
                if self._dir is None:
                    self._dir = unit.copy()
                    cos = 1.0
                else:
                    cos = float(np.dot(unit, self._dir))
                    self._dir *= (1.0 - self._alpha)
                    self._dir += self._alpha * unit
                    dn = float(np.linalg.norm(self._dir))
                    if dn > _EPS:
                        self._dir /= dn
            else:
                cos = 1.0                # a zero delta diverges nowhere
            self.last_cosine = cos
            prev = self._w_norm_ewma.get(worker, norm)
            self._w_norm_ewma[worker] = \
                (1.0 - self._alpha) * prev + self._alpha * norm
            self._w_divergence[worker] = 1.0 - cos
            self._w_updates[worker] = self._w_updates.get(worker, 0) + 1
        # leaf metric writes outside the lock, pre-computed host
        # scalars only
        cos_r = round(cos, 4)
        self._m_norm.observe(norm)
        self._g_cosine.set(cos_r)
        self._c_updates.inc()
        self._worker_gauges(worker)[1].set(round(1.0 - cos, 4))

    def _worker_gauges(self, worker: int) -> tuple:
        """(share, divergence) gauge children for `worker`, created on
        first sight — membership is dynamic (elastic rejoin)."""
        pair = self._per_worker.get(worker)
        if pair is None:
            share = self.telemetry.gauge(
                "worker_contribution_share",
                help_text="this worker's EWMA delta-norm share of the "
                          "aggregate", worker=str(worker), **self._labels)
            div = self.telemetry.gauge(
                "worker_divergence",
                help_text="1 - cosine(latest delta, EWMA aggregate "
                          "direction)", worker=str(worker), **self._labels)
            pair = (share, div)
            self._per_worker[worker] = pair
        return pair

    # -- sampler (the kps-modelhealth thread body; tests call directly) -----

    def poll(self) -> dict:
        """Resolve deferred tensors, feed the drift monitor, refresh the
        contribution-share gauges.  Runs off the training path — a
        device-to-host copy or a `float()` here stalls nobody."""
        with self._lock:
            deltas = list(self._deltas)
            self._deltas.clear()
            evals = list(self._evals)
            self._evals.clear()
        for worker, values in deltas:
            self._ingest(worker, _host_vector(values))
        for loss, f1 in evals:
            # Python floats only reach the monitor (its `f1 >= 0.0`)
            self.drift.observe_eval(float(loss), float(f1))
        with self._lock:
            norms = dict(self._w_norm_ewma)
        total = sum(norms.values())
        if total > _EPS:
            for worker in sorted(norms):
                share = round(norms[worker] / total, 4)
                self._worker_gauges(worker)[0].set(share)
        return {"updates": self.updates,
                "resolved_deltas": len(deltas),
                "resolved_evals": len(evals),
                "drift": self.drift.state_name}

    def start(self) -> "ModelHealth":
        if self._thread is not None:
            return self
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.sample_every_s):
                self.poll()

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="kps-modelhealth")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=10.0)
        self._thread = None
        self.poll()     # drain: the final state reflects every update

    # -- surfacing ----------------------------------------------------------

    def in_drift(self) -> bool:
        return self.drift.in_drift()

    def summary(self) -> dict:
        """The [status]-heartbeat block (StatusReporter renders nested
        dicts one level deep inline)."""
        with self._lock:
            out = {"updates": self.updates,
                   "norm": round(self.last_norm, 4),
                   "cos": round(self.last_cosine, 4)}
        out["drift"] = self.drift.state_name
        trips = self.drift.trips
        if trips:
            out["trips"] = trips
        return out

    def detail(self) -> dict:
        """The /modelz body."""
        with self._lock:
            norms = dict(self._w_norm_ewma)
            total = sum(norms.values())
            workers = {
                str(w): {
                    "updates": self._w_updates.get(w, 0),
                    "norm_ewma": round(norms[w], 4),
                    "share": (round(norms[w] / total, 4)
                              if total > _EPS else 0.0),
                    "divergence": round(self._w_divergence.get(w, 0.0), 4),
                }
                for w in sorted(norms)}
            out = {
                "updates": self.updates,
                "last_norm": round(self.last_norm, 4),
                "last_cosine": round(self.last_cosine, 4),
                "pending_deltas": len(self._deltas),
                "pending_evals": len(self._evals),
                "shard": self.shard,
                "workers": workers,
            }
        out["drift"] = self.drift.detail()
        return out


def plane_from_args(args, telemetry, *, shard: int | None = None,
                    num_features: int | None = None,
                    model: str = "sequential",
                    log=None) -> ModelHealth | None:
    """CLI seam (cli/run.py, cli/socket_mode.py:_make_modelhealth): an
    armed ModelHealth when --model-health was given, else None — wiring
    can pass the result through unconditionally.  `log` is the wall-
    clock-stamping drift-CSV sink the CLI built (this module never reads
    a clock)."""
    if not getattr(args, "model_health", False):
        return None
    drift = DriftMonitor(
        telemetry,
        detector=getattr(args, "drift_detector", "ph") or "ph",
        threshold=getattr(args, "drift_threshold", None),
        num_features=num_features,
        shard=shard, log=log)
    return ModelHealth(telemetry, drift, model=model, shard=shard)
