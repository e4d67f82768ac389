"""The port's aggregation tier (kafka_ps_tpu_torch/agg/ and the server's
composite path) on the CPU: the cases of tests/test_agg.py on the port,
then the port against the JAX package.

  * the merge laws (a semilattice join), split_composite,
    direct_equivalent;
  * the aggregator's offer/combine, summed single-clock flushes, the
    error-feedback horizon and ef_state/ef_restore bitwise;
  * the N=1 stacked aggregator bitwise the direct path at -c 0/3/-1,
    under int8, and with a relay reset and restore; summed within rtol
    2e-5, atol 2e-6; the duplicate-liveness rule;
  * the relay over sockets (stashed rows, composites, grouped weights)
    and GOODBYE against a dropped connection;
  * against JAX: composite (tid 7), T_WEIGHTS_AGG and the aggregator HELLO
    byte for byte, each package decoding the other's; an aggregated run
    within rtol 1e-4 / atol 1e-5 (row keys exact); relay checkpoints
    crossing between the packages bitwise.
"""

import dataclasses
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from kafka_ps_tpu.agg import core as jcore
from kafka_ps_tpu.runtime import fabric as jfabric
from kafka_ps_tpu.runtime import net as jnet
from kafka_ps_tpu.runtime import serde as jserde
from kafka_ps_tpu.runtime.app import StreamingPSApp as JApp
from kafka_ps_tpu.runtime.messages import GradientMessage as JGrad
from kafka_ps_tpu.runtime.messages import KeyRange as JRange
from kafka_ps_tpu.runtime.messages import WeightsMessage as JWeights
from kafka_ps_tpu.utils import config as jconfig
from kafka_ps_tpu_torch.agg import (LocalAggregator, direct_equivalent,
                                    merge_composites, split_composite)
from kafka_ps_tpu_torch.agg.relay import AggregatorRelay
from kafka_ps_tpu_torch.compress import wire as cwire
from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime import net, serde
from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
from kafka_ps_tpu_torch.runtime.messages import (CompositeDelta,
                                                 GradientMessage, KeyRange,
                                                 WeightsMessage)
from kafka_ps_tpu_torch.runtime.sharding import ShardPlan
from kafka_ps_tpu_torch.utils import config

N = 6
RTOL, ATOL = 1e-4, 1e-5
EVENTUAL = -1


def _values(w, c, n=N):
    rng = np.random.default_rng(w * 1009 + c)
    return rng.standard_normal(n).astype(np.float32)


def gm(w, c, n=N, values=None):
    v = _values(w, c, n) if values is None else values
    return GradientMessage(vector_clock=c, key_range=KeyRange(0, n),
                           values=torch.from_numpy(v), worker_id=w)


def comp_of(*msgs, agg_id=0, summed=False):
    msgs = sorted(msgs, key=lambda m: (m.worker_id, m.vector_clock))
    return CompositeDelta(
        agg_id=agg_id,
        members=tuple((m.worker_id, m.vector_clock) for m in msgs),
        deltas=tuple(msgs) if not summed else (msgs[0],), summed=summed)


# -- merge algebra ---------------------------------------------------------


def test_merge_is_commutative():
    a = comp_of(gm(0, 0), gm(1, 0))
    b = comp_of(gm(2, 0), gm(3, 1))
    ab, ba = merge_composites(a, b), merge_composites(b, a)
    assert serde.to_bytes(ab) == serde.to_bytes(ba)
    assert ab.members == ((0, 0), (1, 0), (2, 0), (3, 1))


def test_merge_is_associative():
    a, b, c = comp_of(gm(0, 0)), comp_of(gm(1, 0)), comp_of(gm(0, 1))
    left = merge_composites(merge_composites(a, b), c)
    right = merge_composites(a, merge_composites(b, c))
    assert serde.to_bytes(left) == serde.to_bytes(right)


def test_merge_dedups_redelivered_members():
    d = gm(1, 3)
    a = comp_of(gm(0, 3), d)
    b = comp_of(dataclasses.replace(d), gm(2, 3))
    merged = merge_composites(a, b)
    assert merged.members == ((0, 3), (1, 3), (2, 3))
    assert merged.fan_in == 3
    assert torch.equal(merged.deltas[1].values, d.values)


def test_merge_is_idempotent():
    a = comp_of(gm(0, 0), gm(1, 0))
    assert serde.to_bytes(merge_composites(a, a)) == serde.to_bytes(a)


def test_merge_and_expansion_reject_summed():
    s = comp_of(gm(0, 0), gm(1, 0), summed=True)
    with pytest.raises(ValueError, match="stacked"):
        merge_composites(s, comp_of(gm(2, 0)))
    with pytest.raises(ValueError, match="summed"):
        direct_equivalent(s)
    c = comp_of(gm(0, 0), gm(1, 0))
    assert direct_equivalent(c) == list(c.deltas)


def test_split_composite_slices_every_member():
    plan = ShardPlan(N, 2)
    c = comp_of(gm(0, 0), gm(1, 0))
    parts = split_composite(plan, c)
    assert len(parts) == 2
    for part, r in zip(parts, plan.ranges):
        assert part.members == c.members
        for d in part.deltas:
            assert d.key_range == KeyRange(r.start, r.end)
    for i in range(2):
        whole = torch.cat([p.deltas[i].values for p in parts])
        assert torch.equal(whole, c.deltas[i].values)


# -- the aggregator ----------------------------------------------------------


def _int8():
    return cwire.parse_codec("int8")


def test_offer_dedups_pending_duplicates():
    agg = LocalAggregator(0, N, device="cpu")
    d = gm(0, 0)
    assert agg.offer(d) and not agg.offer(dataclasses.replace(d))
    assert agg.pending_count == 1 and agg.duplicates == 1


def test_combine_drains_sorted_and_idles():
    agg = LocalAggregator(0, N, device="cpu")
    for d in (gm(2, 0), gm(0, 1), gm(0, 0)):
        agg.offer(d)
    c = agg.combine()
    assert c.members == ((0, 0), (0, 1), (2, 0))
    assert agg.pending_count == 0 and agg.combine() is None


def test_summed_requires_single_clock_else_stacked():
    agg = LocalAggregator(0, N, summed=True, device="cpu")
    a, b = gm(0, 0), gm(1, 0)
    agg.offer(a), agg.offer(b)
    c = agg.combine()
    assert c.summed and len(c.deltas) == 1
    assert torch.equal(c.deltas[0].values, a.values + b.values)
    agg.offer(gm(0, 1)), agg.offer(gm(1, 2))
    c2 = agg.combine()
    assert not c2.summed and len(c2.deltas) == 2


def test_ef_horizon_makes_resends_bitwise_safe():
    from kafka_ps_tpu_torch import compress
    agg = LocalAggregator(0, N, codec_spec=_int8(), device="cpu")
    ref = compress.ErrorFeedback(compress.get_codec(_int8(), N), "cpu")
    d0, d1 = gm(0, 0), gm(0, 1)
    agg.offer(d0)
    first = agg.combine().deltas[0]
    agg.offer(dataclasses.replace(d0))           # at the horizon
    again = agg.combine().deltas[0]
    assert serde.to_bytes(again) == serde.to_bytes(first)
    agg.offer(d1)
    second = agg.combine().deltas[0]
    agg.offer(dataclasses.replace(d0))           # below the horizon
    assert agg.combine() is None
    ref0, _ = ref.step(d0.values)
    ref1, _ = ref.step(d1.values)
    assert torch.equal(first.values, ref0)
    assert torch.equal(second.values, ref1)


def test_ef_state_restore_is_bitwise():
    agg = LocalAggregator(0, N, codec_spec=_int8(), device="cpu")
    twin = LocalAggregator(0, N, codec_spec=_int8(), device="cpu")
    d0, d1 = gm(0, 0), gm(0, 1)
    for a in (agg, twin):
        a.offer(dataclasses.replace(d0))
        a.combine()
    state = agg.ef_state()
    agg.reset()
    assert agg.combine() is None
    agg.ef_restore(state)
    for d in (d0, d1):
        agg.offer(dataclasses.replace(d))
        twin.offer(dataclasses.replace(d))
        assert serde.to_bytes(agg.combine()) == serde.to_bytes(twin.combine())


# -- the server's gate on composites: the N=1 bitwise pin --------------------


def _small_cfg(mod, consistency, compress="none"):
    return mod.PSConfig(
        num_workers=4, consistency_model=consistency,
        model=mod.ModelConfig(num_features=8, num_classes=2,
                              local_learning_rate=0.5),
        buffer=mod.BufferConfig(min_size=8, max_size=32),
        stream=mod.StreamConfig(time_per_event_ms=1.0),
        use_gang=False, eval_async=False, compress=compress)


def _dataset(n=256, f=8, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(1, 3, size=n).astype(np.int32)
    centers = np.array([[0.0] * f, [2.5] * f, [-2.5] * f], np.float32)
    x = (centers[y] + rng.normal(scale=0.5, size=(n, f))).astype(np.float32)
    return x, y


def _make_app(consistency, compress="none", jax=False):
    x, y = _dataset()
    rows = []
    if jax:
        app = JApp(_small_cfg(jconfig, consistency, compress), test_x=x,
                   test_y=y, server_log=rows.append,
                   worker_log=[].append)
    else:
        app = StreamingPSApp(_small_cfg(config, consistency, compress),
                             test_x=x, test_y=y, server_log=rows.append,
                             worker_log=[].append, device="cpu")
    for i in range(len(x)):
        app.data_sink(i % 4, {j: float(v) for j, v in enumerate(x[i])
                              if v != 0}, int(y[i]))
    app.rows = rows
    return app


def _deliver_weights(app, delivered, topic):
    """Weights in worker-id order with the assembler's dedup (a clock at
    or below the last delivered one is dropped), as an --aggregate
    worker process sees them."""
    for worker in app.workers:
        w = worker.worker_id
        while True:
            msg = app.fabric.poll(topic, w)
            if msg is None:
                break
            if msg.vector_clock <= delivered.get(w, -1):
                continue
            delivered[w] = msg.vector_clock
            worker.on_weights(msg)


def _run_direct(consistency, iters, compress="none"):
    app = _make_app(consistency, compress)
    app.server.start_training_loop()
    delivered, stalled = {}, 0
    while app.server.iterations < iters:
        _deliver_weights(app, delivered, fabric_mod.WEIGHTS_TOPIC)
        progressed = False
        while app.server.iterations < iters:
            g = app.fabric.poll(fabric_mod.GRADIENTS_TOPIC, 0)
            if g is None:
                break
            app.server.process(g)
            progressed = True
        stalled = 0 if progressed else stalled + 1
        assert stalled < 100, "direct pump deadlocked"
    app.flush_logs()
    return app


def _run_aggregated(consistency, iters, compress="none", restart_at=None,
                    summed=False, jax=False):
    """One aggregator in front of all workers: raw deltas in, the
    aggregator owning the residuals when compressing, one composite per
    flush into the gate."""
    app = _make_app(consistency, "none", jax=jax)
    topics = jfabric if jax else fabric_mod
    spec = _int8() if compress != "none" else None
    if jax:
        from kafka_ps_tpu import compress as cmod
        from kafka_ps_tpu.compress.wire import parse_codec
        jspec = parse_codec(compress) if spec is not None else None
        if jspec is not None:
            app.server.compressor = cmod.WeightsCompressor(
                cmod.get_codec(jspec, app.server.task.num_params))
        agg = jcore.LocalAggregator(0, app.server.task.num_params,
                                    codec_spec=jspec, summed=summed)
    else:
        if spec is not None:
            from kafka_ps_tpu_torch import compress as cmod
            app.server.compressor = cmod.WeightsCompressor(
                cmod.get_codec(spec, app.server.task.num_params))
        agg = LocalAggregator(0, app.server.task.num_params,
                              codec_spec=spec, summed=summed, device="cpu")
    app.server.start_training_loop()
    delivered, last_sent, stalled, rounds = {}, {}, 0, 0
    while app.server.iterations < iters:
        _deliver_weights(app, delivered, topics.WEIGHTS_TOPIC)
        while True:
            g = app.fabric.poll(topics.GRADIENTS_TOPIC, 0)
            if g is None:
                break
            last_sent[g.worker_id] = g
            agg.offer(g)
        progressed = agg.pending_count > 0
        c = agg.combine()
        if c is not None:
            app.server.process(c)
        rounds += 1
        if restart_at is not None and rounds == restart_at:
            # a killed relay at a quiescent point: pending and residuals
            # die, the checkpoint restores the residuals, the workers
            # resend their caches
            state = agg.ef_state()
            agg.reset()
            agg.ef_restore(state)
            for g in last_sent.values():
                agg.offer(dataclasses.replace(g))
            dup = agg.combine()
            if dup is not None:
                app.server.process(dup)
        stalled = 0 if progressed else stalled + 1
        assert stalled < 100, "aggregated pump deadlocked"
    app.flush_logs()
    return app


def _theta(app) -> np.ndarray:
    return np.asarray(app.server.theta, dtype=np.float32)


@pytest.mark.parametrize("consistency", [0, 3, EVENTUAL])
def test_n1_aggregator_bitwise_matches_direct(consistency):
    direct = _run_direct(consistency, 24)
    agg = _run_aggregated(consistency, 24)
    assert _theta(direct).tobytes() == _theta(agg).tobytes()
    assert direct.server.iterations == agg.server.iterations
    strip = lambda rows: [r.split(";")[1:] for r in rows]
    assert strip(agg.rows) == strip(direct.rows) and agg.rows


def test_n1_aggregator_bitwise_under_int8():
    direct = _run_direct(0, 24, compress="int8")
    agg = _run_aggregated(0, 24, compress="int8")
    assert _theta(direct).tobytes() == _theta(agg).tobytes()


def test_n1_aggregator_bitwise_under_int8_with_restart():
    baseline = _run_aggregated(0, 24, compress="int8")
    restarted = _run_aggregated(0, 24, compress="int8", restart_at=3)
    assert _theta(baseline).tobytes() == _theta(restarted).tobytes()


def test_summed_composite_exact_for_bsp():
    direct = _run_direct(0, 24)
    summed = _run_aggregated(0, 24, summed=True)
    np.testing.assert_allclose(_theta(summed), _theta(direct),
                               rtol=2e-5, atol=2e-6)
    assert summed.server.composites_received < 24


def test_composite_duplicate_liveness_resends_weights_once():
    app = _run_direct(3, 12)
    server = app.server
    w = 0
    clock = server.tracker.tracker[w].vector_clock
    assert server.tracker.tracker[w].weights_message_sent
    n = server.task.num_params
    stale = [gm(w, clock - 2, n=n), gm(w, clock - 1, n=n)]
    before = app.fabric.pending(fabric_mod.WEIGHTS_TOPIC, w)
    iters = server.iterations
    server.process(comp_of(*stale))
    assert app.fabric.pending(fabric_mod.WEIGHTS_TOPIC, w) == before + 1
    assert server.iterations == iters


def test_bsp_order_direct_run_is_bitwise_the_aggregated_run():
    """--bsp-order: direct gradients join the round buffer, so a direct
    run in any arrival order applies what the stacked aggregated run
    applies."""
    direct = _make_app(0)
    direct.server.bsp_order = True
    direct.server.start_training_loop()
    delivered = {}
    while direct.server.iterations < 24:
        _deliver_weights(direct, delivered, fabric_mod.WEIGHTS_TOPIC)
        grads = []
        while True:
            g = direct.fabric.poll(fabric_mod.GRADIENTS_TOPIC, 0)
            if g is None:
                break
            grads.append(g)
        for g in reversed(grads):           # a scrambled arrival order
            direct.server.process(g)
    direct.flush_logs()
    agg = _run_aggregated(0, 24)
    assert _theta(direct).tobytes() == _theta(agg).tobytes()


def test_bsp_order_with_one_live_worker_applies_its_round():
    """A one-member round under bsp_order applies at once (the JAX
    ServerNode recurses here, ROADMAP C.11)."""
    from kafka_ps_tpu_torch.runtime.server import ServerNode
    cfg = dataclasses.replace(_small_cfg(config, 0), num_workers=1)
    server = ServerNode(cfg, fabric_mod.Fabric(), "cpu")
    server.bsp_order = True
    server.start_training_loop()
    n = server.task.num_params
    for clock in range(3):
        server.process(gm(0, clock, n=n))
        assert server.iterations == clock + 1
    assert server.fabric.pending(fabric_mod.WEIGHTS_TOPIC, 0) == 4


def test_summed_composite_completes_a_round_buffered_before_it():
    """Under BSP a relay in summed mode sends a one-member flush stacked
    (buffered for the round) and a later flush of the same clock summed:
    the summed apply completes the round (the JAX ServerNode leaves the
    buffered member behind, ROADMAP C.13)."""
    from kafka_ps_tpu_torch.runtime.server import ServerNode
    cfg = _small_cfg(config, 0)
    server = ServerNode(cfg, fabric_mod.Fabric(), "cpu")
    server.start_training_loop()
    n = server.task.num_params
    server.process(comp_of(gm(0, 0, n=n)))
    assert server.iterations == 0
    server.process(comp_of(gm(1, 0, n=n), gm(2, 0, n=n), gm(3, 0, n=n),
                           summed=True))
    assert server.iterations == 4 and not server._agg_pending
    assert server.tracker.clocks == [1, 1, 1, 1]
    assert [server.fabric.pending(fabric_mod.WEIGHTS_TOPIC, w)
            for w in range(4)] == [2, 2, 2, 2]


def test_eviction_releases_a_round_buffered_behind_the_evictee():
    app = _make_app(0)
    app.server.start_training_loop()
    for worker in app.workers:
        worker.on_weights(app.fabric.poll(fabric_mod.WEIGHTS_TOPIC,
                                          worker.worker_id))
    grads = [app.fabric.poll(fabric_mod.GRADIENTS_TOPIC, 0)
             for _ in range(4)]
    app.server.process(comp_of(*grads[:3]))       # worker 3 missing
    assert app.server.iterations == 0
    app.server.remove_worker(3)
    assert app.server.iterations == 3


# -- the relay over sockets ------------------------------------------------


class _Rows:
    def __init__(self):
        self.rows = []
        self.count = 0

    def add(self, features, label):
        self.rows.append((features, label))
        self.count += 1

    def add_many(self, rows):
        for f, lab in rows:
            self.add(f, lab)


def _wait(cond, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting: {what}"
        time.sleep(0.01)


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_relay_end_to_end_over_sockets(server_pkg):
    """Server <- relay <- two workers: a row produced before worker 0
    connected is delivered, the members' gradients reach the server as
    composites, and one grouped weights frame fans out per member with
    its clock.  The upstream server is the port's or the JAX package's."""
    if server_pkg == "port":
        server = net.ServerBridge(run_id=42, device="cpu")
        theta = torch.arange(N, dtype=torch.float32)
        weights = lambda clock: WeightsMessage(vector_clock=clock,
                                               key_range=KeyRange(0, N),
                                               values=theta)
    else:
        server = jnet.ServerBridge(run_id=42)
        theta = np.arange(N, dtype=np.float32)
        weights = lambda clock: JWeights(vector_clock=clock,
                                         key_range=JRange(0, N),
                                         values=theta)
    sfab = server.wrap((fabric_mod if server_pkg == "port"
                        else jfabric).Fabric())
    relay, bridges, threads = None, [], []
    try:
        relay = AggregatorRelay(7, "127.0.0.1", server.port, [0, 1], N,
                                device="cpu")
        loop = threading.Thread(target=relay.run, daemon=True)
        loop.start()
        threads.append(loop)
        server.wait_for_connected([0, 1], timeout=10.0)
        assert server.send_data(0, {1: 2.0}, 1)       # before worker 0
        buffers = {0: _Rows(), 1: _Rows()}
        for w in (0, 1):
            b = net.WorkerBridge("127.0.0.1", relay.port, [w], device="cpu")
            assert b.server_run_id == 42
            b.make_fabric()
            t = threading.Thread(target=b.run_reader,
                                 args=({w: buffers[w]},), daemon=True)
            t.start()
            bridges.append(b)
            threads.append(t)
        _wait(lambda: buffers[0].count == 1, what="stashed row delivery")
        for w, b in enumerate(bridges):
            b.mark_ready(w)
        server.wait_for_workers([0, 1], timeout=10.0)
        for w, b in enumerate(bridges):
            b.send_gradients(0, gm(w, 0))
        got = None
        deadline = time.monotonic() + 10.0
        while got is None or got.fan_in < 2:
            c = sfab.poll_blocking("gradients", 0, timeout=0.2)
            if c is not None:
                assert c.agg_id == 7 and c.fan_in >= 1
                got = (c if got is None else
                       (merge_composites(got, c) if server_pkg == "port"
                        else jcore.merge_composites(got, c)))
            assert time.monotonic() < deadline, "no composite arrived"
        assert got.members == ((0, 0), (1, 0))
        assert np.asarray(got.deltas[1].values).tobytes() == \
            _values(1, 0).tobytes()
        handled = server.send_weights_group([(0, 5), (1, 9)], weights)
        assert handled == {0, 1}
        for w, want_clock in ((0, 5), (1, 9)):
            msg = bridges[w].fabric.poll_blocking(
                fabric_mod.WEIGHTS_TOPIC, w, timeout=10.0)
            assert msg is not None and msg.vector_clock == want_clock
            assert msg.values.numpy().tobytes() == \
                np.arange(N, dtype=np.float32).tobytes()
    finally:
        for b in bridges:
            b.close()
        if relay is not None:
            relay.close()
        server.close()
        for t in threads:
            t.join(timeout=10.0)
    st = relay.stats()
    assert st["composites"] >= 1 and st["members"] == 2
    assert st["bytes_upstream"] > 0 and st["direct_bytes"] > 0


def test_relay_disconnect_evicts_no_member():
    server = net.ServerBridge(run_id=3, device="cpu")
    server.wrap(fabric_mod.Fabric())
    lost = []
    server.on_disconnect = lost.append
    up = net.WorkerBridge("127.0.0.1", server.port, [0, 1], device="cpu",
                          aggregator=True)
    t = threading.Thread(target=up.run_reader, args=({},), daemon=True)
    t.start()
    try:
        server.wait_for_connected([0, 1], timeout=10.0)
        assert server.stats()["aggregators"] == 1
        up.close()
        _wait(lambda: 0 not in server._conn_of, what="cleanup")
        assert lost == []
    finally:
        up.close()
        server.close()
        t.join(timeout=10.0)


def test_goodbye_marks_clean_close_but_crash_does_not():
    for clean in (True, False):
        server = net.ServerBridge(run_id=9, device="cpu")
        b = net.WorkerBridge("127.0.0.1", server.port, [0], device="cpu")
        t = threading.Thread(target=b.run_reader, args=({0: _Rows()},),
                             daemon=True)
        t.start()
        try:
            server.wait_for_connected([0], timeout=10.0)
            if clean:
                server.send_goodbye()
                _wait(lambda: b.run_over, what="goodbye delivery")
            server.close()
            _wait(b.disconnected.is_set, what="EOF after close")
            assert b.run_over is clean
        finally:
            b.close()
            server.close()
            t.join(timeout=10.0)


# -- against the JAX package -------------------------------------------------


def _jgm(w, c, n=N):
    return JGrad(vector_clock=c, key_range=JRange(0, n),
                 values=_values(w, c, n), worker_id=w)


@pytest.mark.parametrize("compressed", [False, True])
def test_composite_frames_are_the_jax_bytes(compressed):
    """A stacked composite (tid 7) from the two aggregators, members
    plain or int8-encoded by the aggregator, and a summed one: the same
    bytes, and each package decodes the other's."""
    from kafka_ps_tpu.compress.wire import parse_codec
    spec, jspec = (_int8(), parse_codec("int8")) if compressed else (None,
                                                                     None)
    agg = LocalAggregator(3, N, codec_spec=spec, device="cpu")
    jagg = jcore.LocalAggregator(3, N, codec_spec=jspec)
    for w, c in ((2, 0), (0, 0), (1, 1)):
        agg.offer(gm(w, c))
        jagg.offer(_jgm(w, c))
    ours, ref = agg.combine(), jagg.combine()
    b, jb = serde.to_bytes(ours), jserde.to_bytes(ref)
    if not compressed:
        assert b == jb
    else:
        # int8 scales may differ by one ulp (the JAX codec is jitted,
        # ROADMAP C.3): the frame layout and members are the same
        assert len(b) == len(jb) and b[:40] == jb[:40]
    assert jserde.to_bytes(jserde.from_bytes(b)) == b
    assert serde.to_bytes(serde.from_bytes(jb, device="cpu")) == jb
    summed = LocalAggregator(3, N, summed=True, device="cpu")
    jsummed = jcore.LocalAggregator(3, N, summed=True)
    for w in (1, 0):
        summed.offer(gm(w, 4))
        jsummed.offer(_jgm(w, 4))
    s, js = summed.combine(), jsummed.combine()
    assert s.summed and js.summed
    np.testing.assert_allclose(s.deltas[0].values.numpy(),
                               np.asarray(js.deltas[0].values),
                               rtol=0, atol=0)
    assert serde.to_bytes(s) == jserde.to_bytes(js)


def _hello_bytes(pkg, aggregator):
    """The HELLO payload a WorkerBridge of `pkg` sends, read off a plain
    listening socket that answers with a 16-byte CONFIG."""
    lsock = socket.create_server(("127.0.0.1", 0))
    port = lsock.getsockname()[1]
    got = {}

    def serve():
        conn, _ = lsock.accept()
        head = conn.recv(4)
        (length,) = struct.unpack("<I", head)
        body = b""
        while len(body) < length:
            body += conn.recv(length - len(body))
        got["payload"] = body[9:]
        jnet.send_frame(conn, jnet.T_CONFIG, 0, struct.pack("<dq", 0.0, 5))
        time.sleep(0.2)
        conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    if pkg == "port":
        b = net.WorkerBridge("127.0.0.1", port, [4, 7], device="cpu",
                             aggregator=aggregator)
    else:
        b = jnet.WorkerBridge("127.0.0.1", port, [4, 7],
                              aggregator=aggregator)
    t.join(timeout=10.0)
    b.close()
    lsock.close()
    return got["payload"]


@pytest.mark.parametrize("aggregator", [True, False])
def test_aggregator_hello_is_the_jax_bytes(aggregator):
    ours, ref = _hello_bytes("port", aggregator), _hello_bytes("jax",
                                                               aggregator)
    assert ours == ref
    assert (ours[-1:] == b"\x01") == aggregator


def test_grouped_weights_frame_is_the_jax_bytes():
    """T_WEIGHTS_AGG from each package's ServerBridge to a relay
    connection: the same frame bytes."""
    frames = {}
    for pkg in ("port", "jax"):
        if pkg == "port":
            server = net.ServerBridge(run_id=1, device="cpu")
            theta = torch.from_numpy(
                np.linspace(-1, 1, N).astype(np.float32))
            build = lambda clock: WeightsMessage(
                vector_clock=clock, key_range=KeyRange(0, N), values=theta)
        else:
            server = jnet.ServerBridge(run_id=1)
            theta = np.linspace(-1, 1, N).astype(np.float32)
            build = lambda clock: JWeights(
                vector_clock=clock, key_range=JRange(0, N), values=theta)
        server.wrap(jfabric.Fabric() if pkg == "jax"
                    else fabric_mod.Fabric())
        sock = socket.create_connection(("127.0.0.1", server.port))
        payload = (struct.pack("<q2q", 2, 0, 1)
                   + struct.pack("<Bf", 0, 0.0) + b"\x00\x00\x01")
        jnet.send_frame(sock, jnet.T_HELLO, 0, payload)
        assert jnet.recv_frame(sock)[0] == jnet.T_CONFIG
        server.wait_for_connected([0, 1], timeout=10.0)
        assert server.send_weights_group([(0, 3), (1, 4)], build) == {0, 1}
        sock.settimeout(10.0)
        while True:
            topic, key, body = jnet.recv_frame(sock)
            if topic == jnet.T_WEIGHTS_AGG:
                frames[pkg] = bytes(body)
                break
        sock.close()
        server.close()
    assert frames["port"] == frames["jax"]
    (n,) = struct.unpack_from("<q", frames["port"], 0)
    assert n == 2 and struct.unpack_from("<4q", frames["port"], 8) == \
        (0, 3, 1, 4)


def test_aggregated_run_matches_the_jax_aggregated_run():
    jax_run = _run_aggregated(0, 24, jax=True)
    ours = _run_aggregated(0, 24)
    np.testing.assert_allclose(_theta(ours), _theta(jax_run),
                               rtol=RTOL, atol=ATOL)
    rows = [r.split(";") for r in ours.rows]
    jrows = [r.split(";") for r in jax_run.rows]
    assert [r[1:3] for r in rows] == [r[1:3] for r in jrows] and rows
    for a, b in zip(rows, jrows):
        np.testing.assert_allclose(float(a[3]), float(b[3]), rtol=RTOL,
                                   atol=ATOL)
        assert abs(float(a[4]) - float(b[4])) <= 1 / 256
        assert abs(float(a[5]) - float(b[5])) <= 1 / 256


class _Up:
    def __init__(self, run_id):
        self.server_run_id = run_id


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_relay_checkpoints_cross_between_the_packages(tmp_path, direction):
    """The relay's residual checkpoint written by one package restores
    in the other: residuals, horizon clocks and the cached encodes'
    bytes the same."""
    from kafka_ps_tpu.agg.relay import AggregatorRelay as JRelay
    from kafka_ps_tpu.compress.wire import parse_codec
    path = str(tmp_path / "relay.npz")
    src_agg = (LocalAggregator(0, N, codec_spec=_int8(), device="cpu")
               if direction == "port_to_jax" else
               jcore.LocalAggregator(0, N, codec_spec=parse_codec("int8")))
    for w, c in ((0, 0), (1, 0), (0, 1)):
        src_agg.offer(gm(w, c) if direction == "port_to_jax"
                      else _jgm(w, c))
        src_agg.combine()
    src = object.__new__(AggregatorRelay if direction == "port_to_jax"
                         else JRelay)
    src.agg, src.upstream, src._ckpt = src_agg, _Up(77), path
    src._save_checkpoint()
    if direction == "port_to_jax":
        dst_agg = jcore.LocalAggregator(0, N, codec_spec=parse_codec("int8"))
        dst = object.__new__(JRelay)
    else:
        dst_agg = LocalAggregator(0, N, codec_spec=_int8(), device="cpu")
        dst = object.__new__(AggregatorRelay)
    dst.agg, dst.upstream, dst._ckpt = dst_agg, _Up(77), path
    assert dst._restore_checkpoint() is True
    want, got = src_agg.ef_state(), dst_agg.ef_state()
    assert sorted(want) == sorted(got) == [0, 1]
    for w in want:
        assert np.asarray(want[w][0]).tobytes() == \
            np.asarray(got[w][0]).tobytes()
        assert want[w][1] == got[w][1]
        assert want[w][2] == got[w][2]
    other = object.__new__(type(dst))
    other.agg, other.upstream, other._ckpt = dst_agg, _Up(78), path
    assert other._restore_checkpoint() is False      # another run's file
