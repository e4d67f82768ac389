"""The port's metrics registry (kafka_ps_tpu_torch/telemetry/registry.py)
held against the JAX package's: the same sequence of updates gives the
same Prometheus text, byte for byte, the same snapshot and the same
summary; quantiles, bucket edges, the null objects and concurrent
writers behave as the JAX tests pin them (tests/test_telemetry.py)."""

from __future__ import annotations

import os
import threading

import numpy as np
import pytest

from kafka_ps_tpu import telemetry as jtel
from kafka_ps_tpu.utils.trace import Tracer as JTracer
from kafka_ps_tpu_torch import telemetry as ttel
from kafka_ps_tpu_torch.utils.trace import NULL_TRACER, Tracer

# families: (kind, name, label names, buckets, help)
FAMILIES = (
    ("counter", "frames_sent", ("topic",), None, "frames per topic"),
    ("counter", "gradients_applied_total", ("shard", "worker"), None, ""),
    ("counter", "plain_total", (), None, ""),
    ("gauge", "worker_clock_lag", ("worker",), None, ""),
    ("gauge", "serving_clock", (), None, "stable clock"),
    ("histogram", "gate_wait_ms", ("model",), None, ""),
    ("histogram", "clock_lag", ("model",), "clock", "lag in clocks"),
    ("histogram", "eval_coalesce_width", (), (1.0, 2.0, 4.0, 8.0), ""),
)
# label values a hostile peer or path can carry: quote, backslash,
# newline, both together, non-ASCII
LABEL_VALUES = ("0", "1", "gradients", 'a"b', "c\\d", "line\nbreak",
                '\\"\n', "größe", "", "127.0.0.1:8477")
VALUES = (0, 1, 2.5, 0.1, 0.25, 1e-3, 7, 32.0, 33.0, 4999.9, 5000.0,
          1e6, 12.0, 3)


def _ops(seed: int, n: int = 400):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        kind, name, labels, buckets, help_text = FAMILIES[
            rng.integers(len(FAMILIES))]
        lab = {k: LABEL_VALUES[rng.integers(len(LABEL_VALUES))]
               for k in labels}
        v = VALUES[rng.integers(len(VALUES))]
        op = {"counter": "inc", "gauge": ("set", "inc")[rng.integers(2)],
              "histogram": "observe"}[kind]
        ops.append((kind, name, lab, buckets, help_text, op, v))
    return ops


def _apply(mod, ops):
    tel = mod.Telemetry()
    for kind, name, lab, buckets, help_text, op, v in ops:
        if kind == "histogram":
            b = mod.CLOCK_BUCKETS if buckets == "clock" else buckets
            child = tel.histogram(name, b, help_text, **lab)
        else:
            child = getattr(tel, kind)(name, help_text, **lab)
        getattr(child, op)(v)
    return tel


@pytest.mark.parametrize("seed", range(4))
def test_exports_equal_the_jax_registry(seed):
    ops = _ops(seed)
    ours, ref = _apply(ttel, ops), _apply(jtel, ops)
    assert ours.prometheus_text() == ref.prometheus_text()
    assert ours.snapshot() == ref.snapshot()
    assert ours.summary() == ref.summary()


def test_hostile_label_values_are_escaped_as_jax_escapes_them():
    ops = [("counter", "frames_sent", {"topic": v}, None, "", "inc", 1)
           for v in LABEL_VALUES]
    text = _apply(ttel, ops).prometheus_text()
    assert text == _apply(jtel, ops).prometheus_text()
    assert 'frames_sent{topic="a\\"b"} 1' in text
    assert 'frames_sent{topic="line\\nbreak"} 1' in text
    assert 'frames_sent{topic="c\\\\d"} 1' in text


def test_constants_and_model_names_are_the_jax_ones():
    assert ttel.LATENCY_BUCKETS_MS == jtel.LATENCY_BUCKETS_MS
    assert ttel.CLOCK_BUCKETS == jtel.CLOCK_BUCKETS
    for c in (0, 1, 3, -1):
        assert ttel.model_name(c) == jtel.model_name(c)


@pytest.mark.parametrize("seed", range(3))
def test_quantiles_equal_the_jax_ones(seed):
    rng = np.random.default_rng(seed)
    bounds = tuple(np.cumsum(rng.uniform(0.1, 5.0, size=8)).tolist())
    counts = rng.integers(0, 5, size=9).tolist()
    total = sum(counts)
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert ttel.interp_quantile(bounds, counts, total, q) == \
            jtel.interp_quantile(bounds, counts, total, q)
    ours, ref = ttel.Histogram(bounds), jtel.Histogram(bounds)
    for v in rng.uniform(0.0, bounds[-1] * 1.2, size=50):
        ours.observe(float(v))
        ref.observe(float(v))
    for q in (0.5, 0.95):
        assert ours.quantile(q) == ref.quantile(q)
    assert ours.summary() == ref.summary()


def test_all_zero_windows_are_benign():
    for mod in (ttel, jtel):
        assert mod.interp_quantile((1.0, 2.0), [0, 0, 0], 0, 0.5) is None
        assert mod.Histogram().quantile(0.5) is None
        assert mod.Histogram().summary() == {"count": 0, "sum": 0.0}


def test_bucket_edges_are_inclusive_upper_bounds():
    h = ttel.Histogram((1.0, 2.0, 4.0))
    for v in (0.0, 1.0, 1.0000001, 2.0, 4.0, 4.5):
        h.observe(v)
    assert h.state()[0] == [2, 2, 1, 1]
    text = ttel.Telemetry()
    text.histogram("h", (1.0, 2.0, 4.0)).observe(2.0)
    assert 'h_bucket{le="1"} 0' in text.prometheus_text()
    assert 'h_bucket{le="2"} 1' in text.prometheus_text()
    with pytest.raises(ValueError):
        ttel.Histogram((2.0, 1.0))


def test_family_kind_and_labels_must_match():
    reg = ttel.MetricsRegistry()
    reg.counter("x_total", worker="0").inc()
    with pytest.raises(ValueError):
        reg.gauge("x_total", worker="0")
    with pytest.raises(ValueError):
        reg.counter("x_total", shard="0")


def test_maybe_telemetry_gates_on_its_inputs_and_null_objects_do_nothing():
    assert ttel.maybe_telemetry() is ttel.NULL_TELEMETRY
    assert ttel.maybe_telemetry(NULL_TRACER) is ttel.NULL_TELEMETRY
    assert ttel.maybe_telemetry(want_metrics=True).enabled
    tr = Tracer()
    tel = ttel.maybe_telemetry(tr)
    assert tel.enabled and tel.tracer is tr
    null = ttel.NULL_TELEMETRY
    assert not null.enabled
    for child in (null.counter("a", worker="0"), null.gauge("b"),
                  null.histogram("c", model="x")):
        child.inc()
        child.set(3)
        child.observe(1.0)
        assert child.value == 0 and child.count == 0
    assert null.snapshot() == {} and null.summary() == {}
    assert null.registry.families() == {}
    NULL_TRACER.count("x")
    with NULL_TRACER.span("s"):
        pass
    assert NULL_TRACER.counters() == {} and NULL_TRACER.span_stats() == {}


def test_concurrent_writers_give_exact_counts():
    tel = ttel.Telemetry()
    c = tel.counter("n_total", worker="0")
    h = tel.histogram("lat_ms", model="m")
    g = tel.gauge("g")

    def work():
        for i in range(2000):
            c.inc()
            h.observe(i % 7)
            g.inc()
            # families resolved concurrently resolve to one child
            tel.counter("n_total", worker="1").inc(2)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    snap = tel.snapshot()
    assert snap["n_total"] == {"worker=0": 16000, "worker=1": 32000}
    assert snap["lat_ms"]["model=m"]["count"] == 16000
    assert h.sum == 8 * sum(i % 7 for i in range(2000))
    assert g.value == 16000


def test_write_prometheus_and_the_dumper(tmp_path):
    tel = ttel.Telemetry(tracer=Tracer())
    tel.counter("frames_sent", topic="weights").inc(3)
    path = str(tmp_path / "m.prom")
    tel.start_dumper(path, 0.02)
    assert tel._dump_thread is not None
    tel.counter("frames_sent", topic="weights").inc(2)
    tel.stop_dumper(path)
    assert tel._dump_thread is None
    text = open(path).read()
    assert text == tel.prometheus_text()
    assert 'frames_sent{topic="weights"} 5' in text
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    # every <= 0 writes once and starts no thread
    tel.start_dumper(path, 0)
    assert tel._dump_thread is None


def test_summary_matches_jax_for_a_traced_telemetry():
    """The facade over a tracer: summary and snapshot as the JAX one's."""
    ops = _ops(7, 60)
    ours = ttel.Telemetry(tracer=Tracer())
    ref = jtel.Telemetry(tracer=JTracer())
    for tel, mod in ((ours, ttel), (ref, jtel)):
        for kind, name, lab, buckets, help_text, op, v in ops:
            if kind == "histogram":
                b = mod.CLOCK_BUCKETS if buckets == "clock" else buckets
                getattr(tel.histogram(name, b, help_text, **lab), op)(v)
            else:
                getattr(getattr(tel, kind)(name, help_text, **lab), op)(v)
    assert ours.summary() == ref.summary()
    assert ours.snapshot() == ref.snapshot()
