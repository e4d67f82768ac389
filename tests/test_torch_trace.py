"""The port's tracer (kafka_ps_tpu_torch/utils/trace.py): spans, counter
samples, flow events and the null tracer as the JAX tests pin them
(tests/test_trace.py); under one injected clock the same events dump the
same JSON as the JAX Tracer, and the JAX merge tool stitches a port dump
with a JAX one; runs emit the JAX span and counter names; device_trace
writes a torch.profiler trace."""

from __future__ import annotations

import json
import threading

import pytest

from kafka_ps_tpu.telemetry.merge import merge_traces
from kafka_ps_tpu.utils.trace import Tracer as JTracer
from kafka_ps_tpu_torch.utils import trace as trace_mod
from kafka_ps_tpu_torch.utils.trace import NULL_TRACER, Tracer


def test_span_and_counter_recording(tmp_path):
    # t0, span a (2), span a (2), count (1), count (1), dump (1)
    clock_vals = iter([0.0, 0.0, 1.0, 1.5, 2.0, 3.0, 4.0, 5.0])
    t = Tracer(clock=lambda: next(clock_vals), pid=7)
    with t.span("a", worker=0):
        pass
    with t.span("a"):
        pass
    t.count("send.weights")
    t.count("send.weights", 2)
    stats = t.span_stats()
    assert stats["a"]["count"] == 2
    assert stats["a"]["total_ms"] == 1500.0   # (1.0-0.0) + (2.0-1.5) s
    assert t.counters() == {"send.weights": 3}
    data = json.load(open(t.dump(str(tmp_path / "trace.json"))))
    spans = [e for e in data["traceEvents"] if e["ph"] == "X"]
    assert len(spans) == 2
    assert spans[0]["dur"] == 1e6 and spans[0]["args"] == {"worker": 0}
    assert spans[0]["pid"] == 7 and data["pid"] == 7
    assert "wallClockT0" in data


def test_span_at_counter_samples_and_flows(tmp_path):
    clock_vals = iter([0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0])
    t = Tracer(clock=lambda: next(clock_vals), pid=3, counter_sample_s=0.0)
    t.span_at("gate.wait", 0.5, 0.25, worker=1)     # clamps to 0
    t.span_at("gate.wait", 0.5, 2.5, worker=2)
    t.count("frames", 2)
    t.count("frames")
    fid = t.new_flow_id()
    assert fid >> 40 == 3
    t.flow_start("delta.wire", fid, worker=1)
    t.flow_step("delta.wire", fid)
    t.flow_end("delta.wire", fid)
    data = json.load(open(t.dump(str(tmp_path / "trace.json"))))
    spans = [e for e in data["traceEvents"] if e["ph"] == "X"]
    assert [e["dur"] for e in spans] == [0.0, 2e6]
    frames = [e["args"]["value"] for e in data["traceEvents"]
              if e["ph"] == "C" and e["name"] == "frames"]
    assert frames == [2, 3, 3]        # two samples + the closing one
    flows = [e for e in data["traceEvents"] if e.get("cat") == "flow"]
    assert [e["ph"] for e in flows] == ["s", "t", "f"]
    assert flows[2]["bp"] == "e" and flows[0]["args"] == {"worker": 1}
    t.clear()
    assert t.span_stats() == {} and t.counters() == {"frames": 3}
    assert t.new_flow_id() != fid


def test_span_records_on_exception_and_null_tracer_noops():
    clock_vals = iter([0.0, 1.0, 2.0])
    t = Tracer(clock=lambda: next(clock_vals))
    with pytest.raises(RuntimeError):
        with t.span("boom"):
            raise RuntimeError("x")
    assert t.span_stats()["boom"]["count"] == 1
    with NULL_TRACER.span("x"):
        pass
    NULL_TRACER.count("y")
    NULL_TRACER.span_at("z", 0.0, 1.0)
    NULL_TRACER.flow_start("f", 1)
    assert NULL_TRACER.span_stats() == {} and NULL_TRACER.counters() == {}


def test_thread_safety():
    t = Tracer()

    def work():
        for _ in range(200):
            with t.span("s"):
                t.count("c")

    threads = [threading.Thread(target=work) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert t.span_stats()["s"]["count"] == 800
    assert t.counters()["c"] == 800


def _script(t):
    with t.span("worker.local_update", worker=0, clock=3):
        t.count("dispatch.device")
    t.span_at("gate.wait", 0.5, 1.5, worker=1, clock=2)
    fid = t.new_flow_id()
    with t.span("server.apply", gang=2, workers=[0, 1]):
        t.flow_start("delta.wire", fid)
        t.flow_step("delta.wire", fid, clock=4)
        t.flow_end("delta.wire", fid)
    t.count("send.weights", 4)
    t.count("send.gang")


def test_dump_json_equals_the_jax_tracer(tmp_path):
    def clock():
        state["t"] += 0.125
        return state["t"]

    dumps = []
    for cls in (Tracer, JTracer):
        state = {"t": 0.0}
        t = cls(clock=clock, pid=11, counter_sample_s=0.0)
        t._wall0 = 1.7e9          # the one field a real clock sets
        _script(t)
        path = str(tmp_path / f"{cls.__module__}.json")
        dumps.append(json.load(open(t.dump(path))))
    assert dumps[0] == dumps[1]
    assert len(dumps[0]["traceEvents"]) == 12


def test_jax_merge_stitches_a_port_dump_with_a_jax_dump(tmp_path):
    clk = {"t": 100.0}
    ours = Tracer(clock=lambda: clk["t"], pid=1, counter_sample_s=0.0)
    ref = JTracer(clock=lambda: clk["t"], pid=2, counter_sample_s=0.0)
    ref._wall0 = ours._wall0 + 0.5
    fid = ours.new_flow_id()
    clk["t"] = 100.1
    with ours.span("worker.local_update", worker=0):
        ours.flow_start("delta.wire", fid)
    clk["t"] = 100.2
    with ref.span("server.apply"):
        ref.flow_step("delta.wire", fid)
    pa, pb = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    ours.dump(pa)
    ref.dump(pb)
    stats = merge_traces([pa, pb], str(tmp_path / "merged.json"))
    assert stats["files"] == 2 and sorted(stats["pids"]) == [1, 2]
    assert stats["cross_process_flows"] == 1
    evs = json.load(open(tmp_path / "merged.json"))["traceEvents"]
    flows = [e for e in evs if e.get("cat") == "flow"]
    start = next(e for e in flows if e["ph"] == "s")
    step = next(e for e in flows if e["ph"] == "t")
    assert step["ts"] > start["ts"] and {start["pid"], step["pid"]} == {1, 2}


def test_serial_run_emits_the_jax_span_and_counter_names():
    """-c 0 serial, gang and async eval on in both packages: the same
    span names and counter names, and the host-decision counts equal."""
    import dataclasses

    from kafka_ps_tpu.runtime.app import StreamingPSApp as JApp
    from kafka_ps_tpu.telemetry import Telemetry as JTelemetry
    from kafka_ps_tpu.utils import config as jconfig
    from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
    from kafka_ps_tpu_torch.telemetry import Telemetry
    from kafka_ps_tpu_torch.utils import config
    from tests.test_torch_slice import _configs, _data, _drive

    rows, tx, ty = _data()
    tracers = []
    for cls, mod, kw in ((JApp, jconfig, {}), (StreamingPSApp, config,
                                                {"device": "cpu"})):
        cfg = dataclasses.replace(_configs(mod, 0), use_gang=True,
                                  eval_async=True)
        tr = (JTracer if cls is JApp else Tracer)(counter_sample_s=0.0)
        tel = (JTelemetry if cls is JApp else Telemetry)(tracer=tr)
        _drive(cls, cfg, rows, tx, ty, 36, tracer=tr, telemetry=tel, **kw)
        tracers.append(tr)
    ref, ours = tracers
    assert set(ours.span_stats()) == set(ref.span_stats()) == {
        "worker.local_update", "server.apply", "server.eval", "gate.wait"}
    assert set(ours.counters()) == set(ref.counters())
    for name, n in ref.counters().items():
        if name != "eval.dispatch_async":     # coalescing: thread timing
            assert ours.counters()[name] == n, name
    for name in ("server.apply", "worker.local_update", "gate.wait"):
        assert ours.span_stats()[name]["count"] == \
            ref.span_stats()[name]["count"], name


def test_fused_run_emits_bsp_step_spans_and_counter():
    """As the JAX test_fused_path_emits_spans: one bsp.step span and one
    bsp.steps count per dispatch, single rounds and chunks alike."""
    from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
    from kafka_ps_tpu_torch.utils import config
    from tests.test_torch_slice import _configs, _data

    rows, tx, ty = _data()
    cfg = _configs(config, 0)
    cfg = type(cfg)(**{**cfg.__dict__, "eval_every": 10})
    tr = Tracer(counter_sample_s=0.0)
    app = StreamingPSApp(cfg, test_x=tx, test_y=ty, device="cpu", tracer=tr)
    for i, (feats, label) in enumerate(rows[:120]):
        app.data_sink(i % cfg.num_workers, feats, label)
    app.run_fused_bsp(max_server_iterations=cfg.num_workers * 25)
    fs = app.fused_stats
    dispatches = fs["chunks"] + fs["rounds"] - fs["chunk_rounds"]
    assert fs["rounds"] == 25 and fs["chunks"] >= 1
    assert tr.span_stats()["bsp.step"]["count"] == dispatches
    assert tr.counters()["bsp.steps"] == dispatches
    rounds = sorted(e["args"]["rounds"] for e in tr._events
                    if e["name"] == "bsp.step")
    assert sum(rounds) == 25 and rounds[-1] == app.FUSED_CHUNK_ROUNDS


def test_device_trace_none_is_a_noop_and_a_dir_gets_a_trace(tmp_path):
    import torch

    with trace_mod.device_trace(None):
        pass
    with trace_mod.device_trace(str(tmp_path / "dt"), "cpu"):
        (torch.ones(64) * 2).sum()
    path = trace_mod.device_trace_path(str(tmp_path / "dt"))
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert trace_mod.kernel_names(path) == set()     # no card here
    # a raising block still writes its trace
    with pytest.raises(RuntimeError):
        with trace_mod.device_trace(str(tmp_path / "dt2"), "cpu"):
            raise RuntimeError("x")
    assert json.load(open(trace_mod.device_trace_path(
        str(tmp_path / "dt2"))))["traceEvents"] is not None
