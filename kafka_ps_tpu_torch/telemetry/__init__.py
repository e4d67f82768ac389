"""The telemetry base (counterpart of kafka_ps_tpu/telemetry/): the
metrics registry (registry.py), the black-box flight recorder
(flight.py) and the watchdogs and health plane (health.py), over the
tracer and status backends in utils/trace.py and utils/status.py.

The analysis planes of the JAX package (profiler, slo, critpath, merge,
postmortem, modelhealth, drift) are not ported yet; the JAX package's
merge and postmortem tools read this package's traces and dumps."""

from kafka_ps_tpu_torch.telemetry.flight import FLIGHT, FlightRecorder
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
           "LATENCY_BUCKETS_MS", "NULL_TELEMETRY", "Counter", "Gauge",
           "Histogram", "MetricsRegistry", "Telemetry", "interp_quantile",
           "maybe_telemetry", "model_name"]
