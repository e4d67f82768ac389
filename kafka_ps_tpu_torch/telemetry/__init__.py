"""The telemetry plane (counterpart of kafka_ps_tpu/telemetry/): the
metrics registry (registry.py), the black-box flight recorder
(flight.py), the watchdogs and health plane (health.py), over the tracer
and status backends in utils/trace.py and utils/status.py; and the
analysis planes: the sampling profiler (profiler.py), SLO burn rates
(slo.py), model health and drift (modelhealth.py, drift.py), and the
offline tools `python -m kafka_ps_tpu_torch.telemetry merge|critpath|
postmortem` (merge.py, critpath.py, postmortem.py), which read either
package's traces and dumps."""

from kafka_ps_tpu_torch.telemetry.drift import DriftMonitor
from kafka_ps_tpu_torch.telemetry.flight import FLIGHT, FlightRecorder
from kafka_ps_tpu_torch.telemetry.modelhealth import (NULL_MODEL_HEALTH,
                                                      ModelHealth)
from kafka_ps_tpu_torch.telemetry.registry import (CLOCK_BUCKETS,
                                                   LATENCY_BUCKETS_MS,
                                                   NULL_TELEMETRY, Counter,
                                                   Gauge, Histogram,
                                                   MetricsRegistry,
                                                   Telemetry,
                                                   interp_quantile,
                                                   maybe_telemetry,
                                                   model_name)

__all__ = ["CLOCK_BUCKETS", "FLIGHT", "FlightRecorder",
           "LATENCY_BUCKETS_MS", "NULL_MODEL_HEALTH", "NULL_TELEMETRY",
           "Counter", "DriftMonitor", "Gauge", "Histogram",
           "MetricsRegistry", "ModelHealth", "Telemetry",
           "interp_quantile", "maybe_telemetry", "model_name"]
