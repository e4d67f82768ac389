"""The transport, scale-out, serving and tier telemetry of the port
(runtime/wire.py, runtime/net.py, agg/, runtime/sharding.py, serving/,
store/tiered.py), in process on the CPU at small sizes:

  * telemetry off, null and on (tracers, registries, the flight recorder)
    give bitwise the same theta, gradients and CSV rows, stamps stripped:
    the bridge round, ShardedServerGroup at N=1 and 2, the stacked and
    summed aggregator, a capped serial tiered run and the gang-prefix
    serving snapshots;
  * trace context on the socket: an un-negotiated link's frames are byte
    for byte the untraced ones, a negotiated link's the JAX bridges'
    frames for the same flow id, and negotiation crosses the packages
    both ways (ON when both ends trace, OFF against an untraced or a
    legacy peer), the flow ids carrying the sender's pid;
  * against the JAX package on the same inputs: the bridges', the
    aggregator's, the tiered store's and the serving engine's families,
    kinds and label sets, their counters of host decisions exactly, and
    their timing histograms' observation counts;
  * the serving and replica watchdogs.
"""

from __future__ import annotations

import dataclasses
import json
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from kafka_ps_tpu.agg import LocalAggregator as JAggregator
from kafka_ps_tpu.runtime import fabric as jfabric
from kafka_ps_tpu.runtime import messages as jmsg
from kafka_ps_tpu.runtime import net as jnet
from kafka_ps_tpu.telemetry import Telemetry as JTelemetry
from kafka_ps_tpu.utils.trace import Tracer as JTracer
from kafka_ps_tpu_torch.agg import LocalAggregator
from kafka_ps_tpu_torch.compress import wire as cwire
from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime import net
from kafka_ps_tpu_torch.runtime.messages import (GradientMessage, KeyRange,
                                                 WeightsMessage)
from kafka_ps_tpu_torch.telemetry import FLIGHT, NULL_TELEMETRY, Telemetry
from kafka_ps_tpu_torch.telemetry.health import OpsPlane
from kafka_ps_tpu_torch.utils import config
from kafka_ps_tpu_torch.utils.trace import NULL_TRACER, Tracer
from tests import torch_scaleout_runs as so
from tests import torch_serving_runs as sr
from tests.test_torch_net_interop import (RUN_ID, _frames, _jax_gradient,
                                          _jax_weights, _port_message)
from tests.torch_split_round import bridge_round

MODES = ("off", "null", "on")
PIDS = {"server": 1001, "worker": 2002}


@pytest.fixture(autouse=True)
def _flight_reset():
    yield
    FLIGHT.disable()


def _obs(mode: str):
    """role -> (tracer, telemetry) of one arm: off (None), null (the
    null objects) or on (a tracer per role, pid-stamped, sampling every
    count; a registry; the flight recorder armed)."""
    if mode == "off":
        return lambda role: (None, None)
    if mode == "null":
        return lambda role: (NULL_TRACER, NULL_TELEMETRY)
    FLIGHT.enable(role="test")

    def make(role):
        tracer = Tracer(pid=PIDS.get(role, 3003), counter_sample_s=0.0)
        return tracer, Telemetry(tracer=tracer)
    return make


def _bits(t) -> bytes:
    return t.detach().cpu().numpy().tobytes()


def _strip(rows):
    return [r.split(";", 1)[1] for r in rows]


# -- bitwise with telemetry off, null and on --------------------------------


@pytest.mark.parametrize("task", ["logreg", "mlp"])
def test_bridge_round_bitwise_and_traced_frames_carry_the_suffix(task):
    runs = {}
    for mode in MODES:
        info = {}
        ref, got = bridge_round("cpu", task, obs=_obs(mode), info=info)
        FLIGHT.disable()
        assert _bits(got[1]) == _bits(ref[1])
        assert [_bits(g.values) for g in got[0]] == \
            [_bits(g.values) for g in ref[0]]
        runs[mode] = info
    assert [runs[m]["trace_negotiated"] for m in MODES] == \
        [False, False, True]
    for side, topic, direction in (("worker_wire", "gradients", "out"),
                                   ("server_wire", "weights", "out")):
        plain, traced = (runs[m][side][topic] for m in ("off", "on"))
        frames = traced[f"frames_{direction}"]
        assert frames == plain[f"frames_{direction}"] > 0
        assert (traced[f"bytes_{direction}"] - plain[f"bytes_{direction}"]
                == net._TRACE_CTX.size * frames)
        null = runs["null"][side][topic]
        assert {k: null[k] for k in ("frames_out", "bytes_out")} == \
            {k: plain[k] for k in ("frames_out", "bytes_out")}


@pytest.mark.parametrize("variant", ["group1", "group2", "stacked",
                                     "summed", "tier", "snapshots"])
def test_runs_are_bitwise_with_telemetry_off_null_and_on(variant,
                                                         tmp_path):
    out = []
    for mode in MODES:
        tracer, telemetry = _obs(mode)("server")
        out.append(_variant_run(variant, tracer, telemetry, tmp_path / mode))
        FLIGHT.disable()
    assert out[0] == out[1] == out[2]
    assert out[0][1], "the run produced no rows or snapshots"


def _variant_run(variant, tracer, telemetry, path):
    if variant.startswith("group"):
        cfg = so.config(0, "logreg", features=8, classes=2, workers=2)
        x, y = so.dataset(cfg, 64)
        group, rows = so.group_run("cpu", int(variant[-1]), cfg, 24, x, y,
                                   test=(x, y), tracer=tracer,
                                   telemetry=telemetry)
        return _bits(group.assembled_theta()), _strip(rows)
    if variant in ("stacked", "summed"):
        cfg = so.config(0, "logreg", features=8, classes=2, workers=4)
        x, y = so.dataset(cfg, 128)
        app = so.aggregated_run("cpu", cfg, 24, x, y, (x, y),
                                summed=variant == "summed", tracer=tracer,
                                telemetry=telemetry)
        return _bits(app.server.theta), _strip(app.rows)
    if variant == "tier":
        cfg = so.config(0, "logreg", features=8, classes=2, workers=2)
        cfg = dataclasses.replace(cfg, tier=config.TierConfig(
            hot_bytes=16, warm_bytes=24, page_params=2,
            rebalance_interval_s=0.002))
        x, y = so.dataset(cfg, 64)
        app = so._app("cpu", cfg, x, y, (x, y), tracer=tracer,
                      telemetry=telemetry)
        store = app.enable_tiering(str(path))
        app.run_serial(max_server_iterations=20)
        stats = store.stats()
        theta = _bits(app.server.theta)
        app.close_tiering()
        app.close_logs()
        assert stats["faults"] > 0 and stats["demotions"] > 0
        return theta, _strip(app.rows)
    cfg = sr.serve_config(0, use_gang=True, workers=4)
    return None, sr.snapshot_sequence(cfg, "cpu", 24, tracer=tracer,
                                      telemetry=telemetry)


# -- trace context on the socket: bytes ------------------------------------


def _serve_one(answer: int, codec: str, got: list):
    """A raw server answering a HELLO with CONFIG (trace `answer`); it
    keeps the HELLO, then a GRADIENTS frame and a READY."""
    spec = cwire.parse_codec(codec)
    srv = socket.create_server(("127.0.0.1", 0))

    def serve():
        conn, _ = srv.accept()
        got.extend(_frames(conn, 1))
        net.send_frame(conn, net.T_CONFIG, 0,
                       struct.pack("<dq", 0.0, RUN_ID)
                       + struct.pack("<Bf", spec.codec_id, spec.param)
                       + struct.pack("<B", answer))
        got.extend(_frames(conn, 2))
        conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return srv, t


def _worker_frames(make_worker, codec, gradient, answer):
    got: list = []
    srv, t = _serve_one(answer, codec, got)
    worker = make_worker(srv.getsockname()[1])
    negotiated = worker.trace_negotiated
    worker.send_gradients(0, gradient)
    worker.mark_ready(0)
    t.join(timeout=10.0)
    worker.close()
    srv.close()
    return negotiated, got


def _server_frames(bridge, fabric, codec, weights, offer):
    """CONFIG and one WEIGHTS frame, to a raw worker whose HELLO offers
    trace `offer`."""
    spec = cwire.parse_codec(codec)
    sock = socket.create_connection(("127.0.0.1", bridge.port))
    net.send_frame(sock, net.T_HELLO, 0,
                   struct.pack("<qq", 1, 0)
                   + struct.pack("<Bf", spec.codec_id, spec.param)
                   + struct.pack("<B", offer))
    got = _frames(sock, 1)
    bridge.wait_for_connected([0], timeout=10.0)
    fabric.send(fabric_mod.WEIGHTS_TOPIC, 0, weights)
    got += _frames(sock, 1)
    sock.close()
    bridge.close()
    return got


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_traced_frames_are_the_jax_frames_untraced_ones_todays(codec):
    spec = cwire.parse_codec(codec)
    suffix = net._TRACE_CTX.pack((7 << 40) | 1, 0)

    def port_worker(tracer):
        return lambda port: net.WorkerBridge(
            "127.0.0.1", port, [0], codec=spec, device="cpu", tracer=tracer)

    jg = _jax_gradient(codec)
    pg = _port_message(jg)
    plain = _worker_frames(port_worker(None), codec, pg, answer=0)
    unneg = _worker_frames(port_worker(Tracer(pid=7)), codec, pg, answer=0)
    assert plain[0] is unneg[0] is False
    # the offer byte is the HELLO's last; nothing else differs
    assert unneg[1][0][2][:-1] == plain[1][0][2][:-1]
    assert (plain[1][0][2][-1], unneg[1][0][2][-1]) == (0, 1)
    assert unneg[1][1:] == plain[1][1:]
    traced = _worker_frames(port_worker(Tracer(pid=7)), codec, pg, answer=1)
    jtraced = _worker_frames(lambda port: jnet.WorkerBridge(
        "127.0.0.1", port, [0], codec=jcwire_spec(codec),
        tracer=JTracer(pid=7)), codec, jg, answer=1)
    assert traced == jtraced and traced[0] is True
    assert traced[1][1][2] == plain[1][1][2] + suffix

    jw = _jax_weights(codec)
    pw = _port_message(jw)
    frames = {}
    for name, offer, tracer in (("plain", 0, None), ("unneg", 0, Tracer(
            pid=7)), ("traced", 1, Tracer(pid=7))):
        pb = net.ServerBridge(run_id=RUN_ID, codec=spec, device="cpu",
                              tracer=tracer)
        frames[name] = _server_frames(pb, pb.wrap(fabric_mod.Fabric()),
                                      codec, pw, offer)
    jb = jnet.ServerBridge(run_id=RUN_ID, codec=jcwire_spec(codec),
                           tracer=JTracer(pid=7))
    jframes = _server_frames(jb, jb.wrap(jfabric.Fabric()), codec, jw, 1)
    assert frames["unneg"] == frames["plain"]
    assert frames["traced"] == jframes
    assert frames["traced"][1][2] == frames["plain"][1][2] + suffix


def jcwire_spec(codec):
    from kafka_ps_tpu.compress import wire as jcwire
    return jcwire.parse_codec(codec)


# -- trace negotiation across the packages ---------------------------------

N = 64


def _bridges(server_pkg, worker_pkg, server_traced, worker_traced):
    """A server bridge of one package and a worker bridge of the other
    (ids [0]), with their tracers (pids 1001 and 2002) when traced."""
    if server_pkg == "port":
        st = Tracer(pid=1001) if server_traced else None
        sb = net.ServerBridge(run_id=RUN_ID, device="cpu", tracer=st)
        sfab = sb.wrap(fabric_mod.Fabric())
    else:
        st = JTracer(pid=1001) if server_traced else None
        sb = jnet.ServerBridge(run_id=RUN_ID, tracer=st)
        sfab = sb.wrap(jfabric.Fabric())
    if worker_pkg == "port":
        wt = Tracer(pid=2002) if worker_traced else None
        wb = net.WorkerBridge("127.0.0.1", sb.port, [0], device="cpu",
                              tracer=wt)
    else:
        wt = JTracer(pid=2002) if worker_traced else None
        wb = jnet.WorkerBridge("127.0.0.1", sb.port, [0], tracer=wt)
    return sb, sfab, st, wb, wb.make_fabric(), wt


def _message(pkg, kind):
    vals = np.random.default_rng(3).standard_normal(N).astype(np.float32)
    if pkg == "port":
        if kind == "weights":
            return WeightsMessage(vector_clock=1, key_range=KeyRange(0, N),
                                  values=torch.from_numpy(vals))
        return GradientMessage(vector_clock=1, key_range=KeyRange(0, N),
                               values=torch.from_numpy(vals), worker_id=0)
    if kind == "weights":
        return jmsg.WeightsMessage(vector_clock=1,
                                   key_range=jmsg.KeyRange(0, N), values=vals)
    return jmsg.GradientMessage(vector_clock=1, key_range=jmsg.KeyRange(0, N),
                                values=vals, worker_id=0)


def _flows(tracer, tmp_path, name):
    """{ph: [flow ids]} of `tracer`'s flow events named `name`."""
    path = tracer.dump(str(tmp_path / f"trace-{tracer.pid}.json"))
    out: dict = {}
    for e in json.load(open(path))["traceEvents"]:
        if e.get("name") == name and e["ph"] in "stf":
            out.setdefault(e["ph"], []).append(e["id"])
    return out


@pytest.mark.parametrize("server_pkg,worker_pkg,server_traced", [
    ("port", "jax", True), ("jax", "port", True),
    ("port", "jax", False), ("jax", "port", False)])
def test_trace_negotiation_crosses_the_packages(server_pkg, worker_pkg,
                                                server_traced, tmp_path):
    sb, sfab, st, wb, wfab, wt = _bridges(server_pkg, worker_pkg,
                                          server_traced, True)
    t = threading.Thread(target=wb.run_reader, args=({},), daemon=True)
    t.start()
    try:
        assert wb.trace_negotiated is server_traced
        sb.wait_for_connected([0], timeout=10.0)
        sfab.send(fabric_mod.WEIGHTS_TOPIC, 0, _message(server_pkg,
                                                        "weights"))
        w = wfab.poll_blocking(fabric_mod.WEIGHTS_TOPIC, 0, timeout=10.0)
        wfab.send(fabric_mod.GRADIENTS_TOPIC, 0, _message(worker_pkg,
                                                          "gradients"))
        g = sfab.poll_blocking(fabric_mod.GRADIENTS_TOPIC, 0, timeout=10.0)
        np.testing.assert_array_equal(np.asarray(w.values),
                                      _message("jax", "weights").values)
        np.testing.assert_array_equal(np.asarray(g.values),
                                      _message("jax", "gradients").values)
    finally:
        wb.close()
        sb.close()
        t.join(timeout=10.0)
    if not server_traced:
        assert getattr(w, "trace", None) is None
        assert getattr(g, "trace", None) is None
        return
    # the flow ids cross with the sender's pid in their top bits
    assert (w.trace >> 40, g.trace >> 40) == (1001, 2002)
    assert _flows(st, tmp_path, "weights.wire")["s"] == [w.trace]
    assert _flows(wt, tmp_path, "weights.wire")["f"] == [w.trace]
    assert _flows(wt, tmp_path, "delta.wire")["s"] == [g.trace]
    assert _flows(st, tmp_path, "delta.wire")["t"] == [g.trace]


def test_a_legacy_worker_against_a_traced_port_server_stays_untraced():
    sb = net.ServerBridge(run_id=RUN_ID, device="cpu",
                          tracer=Tracer(pid=1001))
    sfab = sb.wrap(fabric_mod.Fabric())
    sock = socket.create_connection(("127.0.0.1", sb.port))
    # a HELLO with the codec trailer and no trace byte
    net.send_frame(sock, net.T_HELLO, 0,
                   struct.pack("<qq", 1, 0) + struct.pack("<Bf", 0, 0.0))
    (_, _, config_payload), = _frames(sock, 1)
    assert struct.unpack_from("<B", config_payload, 21) == (0,)
    g = _message("port", "gradients")
    from kafka_ps_tpu_torch.runtime import serde
    net.send_frame(sock, net.T_GRADIENTS, 0, serde.to_bytes(g))
    got = sfab.poll_blocking(fabric_mod.GRADIENTS_TOPIC, 0, timeout=10.0)
    sock.close()
    sb.close()
    assert torch.equal(got.values, g.values)
    assert getattr(got, "trace", None) is None


# -- the families against the JAX package's --------------------------------


def _families(tel) -> dict:
    return {name: (fam.kind, tuple(fam.label_names))
            for name, fam in tel.registry.families().items()}


def _values(tel, names) -> dict:
    """{family: {labels: value, or a histogram's observation count}}."""
    snap = tel.snapshot()
    return {n: {k: (v["count"] if isinstance(v, dict) else v)
                for k, v in snap.get(n, {}).items()} for n in names}


def _rounds(pkg, rounds=3):
    """`rounds` exchanges over one bridge pair of `pkg` with telemetry on
    both ends: weights to workers 0 and 1, a gradient back from each.
    Returns (server telemetry, worker telemetry)."""
    stel, wtel = ((Telemetry(), Telemetry()) if pkg == "port"
                  else (JTelemetry(), JTelemetry()))
    if pkg == "port":
        sb = net.ServerBridge(run_id=RUN_ID, device="cpu", telemetry=stel)
        sfab = sb.wrap(fabric_mod.Fabric())
        wb = net.WorkerBridge("127.0.0.1", sb.port, [0, 1], device="cpu",
                              telemetry=wtel)
    else:
        sb = jnet.ServerBridge(run_id=RUN_ID, telemetry=stel)
        sfab = sb.wrap(jfabric.Fabric())
        wb = jnet.WorkerBridge("127.0.0.1", sb.port, [0, 1], telemetry=wtel)
    wfab = wb.make_fabric()
    t = threading.Thread(target=wb.run_reader, args=({},), daemon=True)
    t.start()
    try:
        sb.wait_for_connected([0, 1], timeout=10.0)
        for w in (0, 1):
            wb.mark_ready(w)
        sb.wait_for_workers([0, 1], timeout=10.0)
        for _ in range(rounds):
            for w in (0, 1):
                sfab.send(fabric_mod.WEIGHTS_TOPIC, w, _message(pkg,
                                                                "weights"))
            for w in (0, 1):
                wfab.poll_blocking(fabric_mod.WEIGHTS_TOPIC, w, timeout=10.0)
                wfab.send(fabric_mod.GRADIENTS_TOPIC, 0, _message(
                    pkg, "gradients"))
            for _ in (0, 1):
                assert sfab.poll_blocking(fabric_mod.GRADIENTS_TOPIC, 0,
                                          timeout=10.0) is not None
    finally:
        wb.close()
        sb.close()
        t.join(timeout=10.0)
    return stel, wtel


WIRE = ("frames_sent", "frames_received", "wire_bytes_total")


def test_bridge_families_and_frame_counters_equal_the_jax_bridges():
    port, jax = _rounds("port"), _rounds("jax")
    for p, j in zip(port, jax):
        assert _families(p) == _families(j)
        assert _values(p, WIRE) == _values(j, WIRE)
    server, worker = _values(port[0], WIRE), _values(port[1], WIRE)
    assert server["frames_sent"]["topic=weights"] == 6
    assert server["frames_received"]["topic=gradients"] == 6
    assert worker["frames_sent"]["topic=gradients"] == 6
    assert worker["frames_received"]["topic=weights"] == 6
    assert {"wire_frames_per_syscall", "wire_send_queue_depth",
            "wire_advisory_dropped"} <= set(_families(port[0]))


def _agg_sequence(pkg, summed, tel):
    """Offers of three rounds of four workers (a resend duplicate in the
    second), a combine per round; the composites' fan-ins."""
    agg = (LocalAggregator(0, N, summed=summed, device="cpu", telemetry=tel)
           if pkg == "port" else JAggregator(0, N, summed=summed,
                                             telemetry=tel))
    fan = []
    for clock in range(3):
        for w in range(4):
            m = _message(pkg, "gradients")
            m = m.__class__(vector_clock=clock, key_range=m.key_range,
                            values=m.values, worker_id=w)
            agg.offer(m)
            if clock == 1 and w == 2:
                agg.offer(m)
        fan.append(agg.combine().fan_in)
    return fan


AGG = ("agg_composites_total", "agg_fan_in", "agg_duplicate_offers_total")


@pytest.mark.parametrize("summed", [False, True])
def test_aggregator_counters_equal_the_jax_aggregator(summed):
    tel, jtel = Telemetry(), JTelemetry()
    assert _agg_sequence("port", summed, tel) == \
        _agg_sequence("jax", summed, jtel) == [4, 4, 4]
    assert _families(tel) == _families(jtel)
    assert _values(tel, AGG) == _values(jtel, AGG)
    mode = "summed" if summed else "stacked"
    assert _values(tel, AGG)["agg_composites_total"] == {f"mode={mode}": 3}
    assert _values(tel, AGG)["agg_duplicate_offers_total"] == {"_total": 1}


STORE = ("param_tier_pins_total", "param_tier_migrations_total",
         "param_tier_migration_ms", "param_tier_pages", "param_range_heat")


def test_tier_store_counters_equal_the_jax_store(tmp_path):
    from kafka_ps_tpu.store import ColdStore as JColdStore
    from kafka_ps_tpu.store import TieredParamStore as JStore
    from kafka_ps_tpu_torch.store import ColdStore, TieredParamStore
    vals = np.arange(40, dtype=np.float32)
    kw = dict(hot_bytes=16, warm_bytes=24, page_params=4)
    tel, jtel = Telemetry(), JTelemetry()
    port = TieredParamStore(vals, KeyRange(0, 40),
                            cold=ColdStore.open(str(tmp_path / "p")),
                            device="cpu", telemetry=tel, **kw)
    jax = JStore(vals, jmsg.KeyRange(0, 40),
                 cold=JColdStore.open(str(tmp_path / "j")), telemetry=jtel,
                 **kw)
    # the same pins (hot spots moving across the slice) and passes
    for store, rng in ((port, KeyRange), (jax, jmsg.KeyRange)):
        for lo, hi in ((0, 8), (0, 8), (30, 40), (12, 20), (30, 40),
                       (0, 40), (20, 28), (20, 28)):
            store.pin_pages(rng(lo, hi))
            if hi - lo == 10 or lo == 20:
                store.rebalance()
        store.rebalance()
    pstats, jstats = port.stats(), jax.stats()
    port.close()
    jax.close()
    assert _families(tel) == _families(jtel)
    assert _values(tel, STORE) == _values(jtel, STORE)
    got = _values(tel, STORE)
    assert sum(got["param_tier_pins_total"].values()) == \
        sum(pstats["pins"].values())
    assert got["param_tier_migrations_total"] == {
        "direction=promote": pstats["promotions"],
        "direction=demote": pstats["demotions"]}
    assert pstats["faults"] > 0 and pstats["demotions"] > 0
    assert pstats["pins"] == jstats["pins"]


SERVING = ("serving_requests_total", "serving_rejections_total",
           "serving_batch_size", "serving_latency_ms", "snapshot_age_ms",
           "serving_dispatch_mode", "serving_shed_total")


def test_serving_engine_counters_equal_the_jax_engine(tmp_path):
    from kafka_ps_tpu.models.task import get_task as jget_task
    from kafka_ps_tpu.serving.engine import PredictionEngine as JEngine
    from kafka_ps_tpu.serving.policy import StalenessError as JStale
    from kafka_ps_tpu.serving.snapshot import SnapshotRegistry as JRegistry
    from kafka_ps_tpu.utils import config as jconfig
    from kafka_ps_tpu_torch.models.task import get_task
    from kafka_ps_tpu_torch.serving.engine import PredictionEngine
    from kafka_ps_tpu_torch.serving.policy import StalenessError
    from kafka_ps_tpu_torch.serving.snapshot import SnapshotRegistry
    rng = np.random.default_rng(2)
    theta = (rng.normal(size=27) * 0.1).astype(np.float32)
    rows = rng.normal(size=(6, 8)).astype(np.float32)
    tracer = Tracer(pid=1001, counter_sample_s=0.0)
    tel, jtel = Telemetry(tracer=tracer), JTelemetry()
    reg, jreg = SnapshotRegistry(), JRegistry()
    reg.publish(torch.from_numpy(theta), 3, trace=(1001 << 40) | 5)
    jreg.publish(theta, 3)
    mcfg = dict(num_features=8, num_classes=2)
    engines = [
        (PredictionEngine(get_task("logreg", config.ModelConfig(**mcfg)),
                          reg, auto=False, tracer=tracer, telemetry=tel),
         StalenessError),
        (JEngine(jget_task("logreg", jconfig.ModelConfig(**mcfg)), jreg,
                 auto=False, telemetry=jtel), JStale)]
    preds = []
    for engine, stale in engines:
        try:
            out = [engine.predict(r).label for r in rows]
            with pytest.raises(stale):
                engine.predict(rows[0], min_clock=10 ** 9)
            preds.append(out)
        finally:
            engine.close()
    assert preds[0] == preds[1]
    assert _families(tel) == _families(jtel)
    assert _values(tel, SERVING) == _values(jtel, SERVING)
    got = _values(tel, SERVING)
    assert got["serving_requests_total"] == {"_total": 7}
    assert got["serving_rejections_total"] == {"_total": 1}
    assert got["serving_batch_size"] == {"_total": 6}
    # the snapshot's delta.wire flow ends once, at its first read
    assert _flows(tracer, tmp_path, "delta.wire") == {"f": [(1001 << 40) | 5]}


# -- the serving and replica watchdogs ---------------------------------------


class _Queue:
    depth = 0

    def queue_depth(self):
        return self.depth


def test_serving_and_replica_watchdogs(tmp_path):
    ops = OpsPlane(flight_dir=str(tmp_path), role="replica")
    engine = _Queue()
    ops.add_serving_watchdog(engine, threshold_s=0.05)
    ops.add_replica_watchdog(threshold_s=0.05)
    assert [d.name for d in ops.panel.watchdogs] == ["serving", "replica"]
    try:
        FLIGHT.beat("replica")
        ops.panel.check_now()        # the replica's demand window opens
        time.sleep(0.1)
        # no queued request: the serving dog is quiet however long it
        # waits; the replica loop stopped beating: that one trips
        ops.panel.check_now()
        states = ops.panel.states()
        assert not states["serving"]["tripped"]
        assert states["replica"]["tripped"]
        FLIGHT.beat("replica")
        engine.depth = 2
        ops.panel.check_now()        # and the serving one's
        assert not ops.panel.states()["replica"]["tripped"]
        time.sleep(0.1)
        ops.panel.check_now()
        assert ops.panel.states()["serving"]["tripped"]
        FLIGHT.beat("serving")
        ops.panel.check_now()
        assert not ops.panel.states()["serving"]["tripped"]
    finally:
        ops.close()
    (dump,) = [p for p in tmp_path.glob("flightdump-*.json")]
    kinds = {e["kind"] for e in json.loads(dump.read_text())["events"]}
    assert "watchdog.trip" in kinds
