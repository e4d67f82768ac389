"""The port's range-sharded runtime (kafka_ps_tpu_torch/runtime/sharding.py
and the shard-aware ServerNode/WorkerNode) on the CPU: the cases of
tests/test_sharding.py on the port, then the port against the JAX package
on the same seeded inputs.

  * ShardPlan covers the key space exactly and rejects bad shapes;
  * dense and sparse splits, reassembly, the router's cache and resend
    (the same tensors, never a recompute), the assembler;
  * the N=1 group is bitwise the unsharded app (theta and server rows) at
    -c 0/2/-1; N=2 and N=4 assemble bitwise the N=1 theta, for logreg and
    the MLP; a sparse slice apply is bitwise the dense apply of the same
    densified delta, in a node and over a whole top-k run;
  * per-shard checkpoints round-trip, and cross between the packages
    bitwise;
  * against JAX: the N=2 group's theta and rows within rtol 1e-4 /
    atol 1e-5 (row keys exact, F1 and accuracy within 1/len(test)), the
    router's tid-2 and tid-6 slices byte for byte, a worker's sub-range
    weights splice and a server's sub-range gradient splice.
"""

import numpy as np
import pytest
import torch

from kafka_ps_tpu.runtime import fabric as jfabric
from kafka_ps_tpu.runtime import serde as jserde
from kafka_ps_tpu.runtime import sharding as jsharding
from kafka_ps_tpu.runtime.messages import EncodedValues as JEnc
from kafka_ps_tpu.runtime.messages import GradientMessage as JGrad
from kafka_ps_tpu.runtime.messages import KeyRange as JRange
from kafka_ps_tpu.runtime.server import ServerNode as JServer
from kafka_ps_tpu.runtime.worker import WorkerNode as JWorker
from kafka_ps_tpu.data.buffer import SlidingBuffer as JBuffer
from kafka_ps_tpu.utils import checkpoint as jckpt
from kafka_ps_tpu.utils import config as jconfig
from kafka_ps_tpu_torch.compress.wire import CODEC_TOPK
from kafka_ps_tpu_torch.data.buffer import SlidingBuffer
from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime import serde
from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
from kafka_ps_tpu_torch.runtime.messages import (EncodedValues,
                                                 GradientMessage, KeyRange,
                                                 SparseDeltaMessage,
                                                 WeightsMessage)
from kafka_ps_tpu_torch.runtime.server import ServerNode
from kafka_ps_tpu_torch.runtime.sharding import (ShardedServerGroup,
                                                 ShardPlan, ShardRouter,
                                                 WeightsAssembler)
from kafka_ps_tpu_torch.runtime.worker import WorkerNode
from kafka_ps_tpu_torch.utils import checkpoint as ckpt
from kafka_ps_tpu_torch.utils import config
from kafka_ps_tpu_torch.weights import from_jax_params

RTOL, ATOL = 1e-4, 1e-5


class ListSink:
    def __init__(self):
        self.rows = []

    def __call__(self, line: str) -> None:
        self.rows.append(line)

    def close(self) -> None:
        pass


def _cfg(mod, consistency: int, num_workers: int = 4, task="logreg",
         **kw):
    return mod.PSConfig(num_workers=num_workers,
                        consistency_model=consistency, task=task,
                        model=mod.ModelConfig(num_features=8, num_classes=2,
                                              local_learning_rate=0.5,
                                              hidden_dim=6),
                        buffer=mod.BufferConfig(min_size=8, max_size=32),
                        stream=mod.StreamConfig(time_per_event_ms=1.0),
                        use_gang=False, eval_async=False, **kw)


def _data(n: int = 128, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32) + 1
    return x, y


def _group_run(n, consistency=0, iters=24, task="logreg", theta0=None,
               compress=None, test=True):
    """A port group of `n` shards and 4 workers, run serially."""
    sx, sy = _data()
    cfg = _cfg(config, consistency, task=task)
    fab = fabric_mod.Fabric()
    sink = ListSink()
    group = ShardedServerGroup(cfg, fab, n, device="cpu",
                               test_x=sx if test else None,
                               test_y=sy if test else None, log=sink)
    if theta0 is not None:
        for s, r in zip(group.shards, group.plan.ranges):
            s.theta = theta0[r.start:r.end].clone()
    buffers = {w: SlidingBuffer(8, cfg.buffer) for w in range(4)}
    nodes = [WorkerNode(w, cfg, fab, buffers[w], "cpu", sx, sy, ListSink())
             for w in range(4)]
    if compress is not None:
        from kafka_ps_tpu_torch import compress as cmod
        codec = cmod.get_codec(cmod.parse_codec(compress),
                               group.task.num_params)
        for nd in nodes:
            nd.compressor = cmod.ErrorFeedback(codec, "cpu")
    for i in range(128):
        buffers[i % 4].add(dict(enumerate(sx[i])), int(sy[i]))
    group.run_serial(nodes, iters)
    return group, sink


# -- ShardPlan -------------------------------------------------------------


@pytest.mark.parametrize("num_params,num_shards", [
    (10, 1), (10, 2), (10, 3), (10, 4), (10, 10), (6150, 4), (203, 8)])
def test_plan_covers_key_space_exactly(num_params, num_shards):
    plan = ShardPlan(num_params, num_shards)
    assert len(plan.ranges) == num_shards
    assert plan.ranges[0].start == 0
    assert plan.ranges[-1].end == num_params
    for a, b in zip(plan.ranges, plan.ranges[1:]):
        assert a.end == b.start
    for key in range(num_params):
        assert plan.ranges[plan.shard_of(key)].contains(key)
    assert sum(len(r) for r in plan.ranges) == num_params
    # the JAX package's plan, range for range
    jplan = jsharding.ShardPlan(num_params, num_shards)
    assert [(r.start, r.end) for r in plan.ranges] == \
        [(r.start, r.end) for r in jplan.ranges]


def test_plan_rejects_bad_shapes():
    with pytest.raises(ValueError, match="num_shards"):
        ShardPlan(10, 0)
    with pytest.raises(ValueError, match="num_shards"):
        ShardPlan(3, 4)
    plan = ShardPlan(10, 2)
    with pytest.raises(ValueError, match="outside"):
        plan.shard_of(10)
    with pytest.raises(ValueError, match="outside"):
        plan.shard_of(-1)


def test_split_dense_reassembles_bitwise():
    plan = ShardPlan(11, 3)         # spans 4,4,3: the last one clipped
    values = torch.arange(11, dtype=torch.float32) * 0.5
    msg = GradientMessage(vector_clock=7, key_range=KeyRange(0, 11),
                          values=values, worker_id=2)
    slices = plan.split_dense(msg)
    assert [s.key_range for s in slices] == list(plan.ranges)
    for s in slices:
        assert s.vector_clock == 7 and s.worker_id == 2
        assert len(s.values) == len(s.key_range)
    assert torch.equal(torch.cat([s.values for s in slices]), values)


def _topk_msg(n, idx, vals, clock=3, worker=1, param=0.4):
    return GradientMessage(
        vector_clock=clock, key_range=KeyRange(0, n),
        values=torch.zeros(n), worker_id=worker,
        encoded=EncodedValues(CODEC_TOPK, param,
                              (torch.tensor(idx, dtype=torch.int32),
                               torch.tensor(vals, dtype=torch.float32))))


def test_split_sparse_routes_by_range_with_local_offsets():
    plan = ShardPlan(10, 3)         # ranges [0,4) [4,8) [8,10)
    slices = plan.split_sparse(_topk_msg(10, [9, 1, 5, 3],
                                         [9.0, 1.0, 5.0, 3.0]))
    assert [s.key_range for s in slices] == list(plan.ranges)
    assert slices[0].indices.tolist() == [1, 3]
    assert slices[0].values.tolist() == [1.0, 3.0]
    assert slices[1].indices.tolist() == [1]
    assert slices[1].values.tolist() == [5.0]
    assert slices[2].indices.tolist() == [1]
    assert slices[2].values.tolist() == [9.0]
    for s in slices:
        assert s.indices.dtype == torch.int32
        assert s.vector_clock == 3 and s.worker_id == 1


def test_split_sparse_empty_slices_still_carry_protocol_fields():
    plan = ShardPlan(12, 4)
    slices = plan.split_sparse(_topk_msg(12, [0, 1], [0.5, -0.5], clock=11,
                                         worker=3, param=0.2))
    assert len(slices[0].indices) == 2
    for s in slices[1:]:
        assert len(s.indices) == 0 and len(s.values) == 0
        assert s.vector_clock == 11 and s.worker_id == 3
        frame = serde.to_bytes(s)       # the empty frame stays tiny
        assert len(frame) < 100


# -- sparse and splice applies on a shard ------------------------------------


def _shard_node(rng, num_workers=1):
    node = ServerNode(_cfg(config, 0, num_workers=num_workers),
                      fabric_mod.Fabric(), "cpu", key_range=rng,
                      shard_id=1, num_shards=2)
    node.start_training_loop()
    return node


def test_sparse_apply_matches_dense_slice():
    """theta[idx] + lr*vals on a shard equals, bit for bit, the dense
    apply of the densified slice."""
    plan = ShardPlan(config.ModelConfig(num_features=8,
                                        num_classes=2).num_params, 2)
    rng = plan.ranges[1]
    idx = torch.tensor([0, 3, len(rng) - 1], dtype=torch.int32)
    vals = torch.tensor([0.5, -1.5, 2.0])
    dense = torch.zeros(len(rng))
    dense[idx.long()] = vals
    a, b = _shard_node(rng), _shard_node(rng)
    before = a.theta
    a.process(SparseDeltaMessage(vector_clock=0, key_range=rng,
                                 indices=idx, values=vals, worker_id=0))
    b.process(GradientMessage(vector_clock=0, key_range=rng, values=dense,
                              worker_id=0))
    assert a.iterations == b.iterations == 1
    assert torch.equal(a.theta, b.theta)
    assert a.theta is not before and a.sparse_applies == 1
    # replace-only: the old tensor kept its values
    assert torch.equal(before, _shard_node(rng).theta)


def test_empty_sparse_slice_advances_gate_without_apply():
    plan = ShardPlan(config.ModelConfig(num_features=8,
                                        num_classes=2).num_params, 2)
    node = _shard_node(plan.ranges[0])
    before = node.theta
    node.process(SparseDeltaMessage(
        vector_clock=0, key_range=plan.ranges[0],
        indices=torch.empty(0, dtype=torch.int32),
        values=torch.empty(0), worker_id=0))
    assert node.iterations == 1
    assert node.tracker.tracker[0].vector_clock == 1
    assert node.theta is before and node.empty_slices == 1


def test_sub_range_gradient_splice_matches_jax():
    """A gradient over part of a node's range: spliced into a new tensor,
    the values of the JAX package's host splice."""
    n = config.ModelConfig(num_features=8, num_classes=2).num_params
    d = np.random.default_rng(3).normal(size=10).astype(np.float32)
    node = ServerNode(_cfg(config, -1, num_workers=1), fabric_mod.Fabric(),
                      "cpu")
    node.start_training_loop()
    jnode = JServer(_cfg(jconfig, -1, num_workers=1), jfabric.Fabric())
    jnode.start_training_loop()
    node.process(GradientMessage(vector_clock=0, key_range=KeyRange(5, 15),
                                 values=torch.from_numpy(d), worker_id=0))
    jnode.process(JGrad(vector_clock=0, key_range=JRange(5, 15), values=d,
                        worker_id=0))
    assert node.theta.numpy().tobytes() == \
        np.asarray(jnode.theta, np.float32).tobytes()
    with pytest.raises(ValueError, match="outside"):
        node.process(GradientMessage(vector_clock=1,
                                     key_range=KeyRange(n - 2, n + 1),
                                     values=torch.zeros(3), worker_id=0))


def test_worker_splices_partial_range_weights_like_jax():
    """A weights message over a sub-range replaces those keys of the
    worker's replica and keeps the others (the JAX worker's splice)."""
    sx, sy = _data()
    cfg, jcfg = _cfg(config, 0, num_workers=1), _cfg(jconfig, 0,
                                                     num_workers=1)
    buf, jbuf = SlidingBuffer(8, cfg.buffer), JBuffer(8, jcfg.buffer)
    for i in range(32):
        buf.add(dict(enumerate(sx[i])), int(sy[i]))
        jbuf.add(dict(enumerate(sx[i])), int(sy[i]))
    fab, jfab = fabric_mod.Fabric(), jfabric.Fabric()
    node = WorkerNode(0, cfg, fab, buf, "cpu")
    jnode = JWorker(0, jcfg, jfab, jbuf)
    part = np.linspace(-1, 1, 7).astype(np.float32)
    node.on_weights(WeightsMessage(vector_clock=0, key_range=KeyRange(4, 11),
                                   values=torch.from_numpy(part)))
    from kafka_ps_tpu.runtime.messages import WeightsMessage as JWeights
    jnode.on_weights(JWeights(vector_clock=0, key_range=JRange(4, 11),
                              values=part))
    assert node.theta.numpy().tobytes() == \
        np.asarray(jnode.theta, np.float32).tobytes()
    g = fab.poll(fabric_mod.GRADIENTS_TOPIC, 0)
    jg = jfab.poll(jfabric.GRADIENTS_TOPIC, 0)
    np.testing.assert_allclose(g.values.numpy(), np.asarray(jg.values),
                               rtol=RTOL, atol=ATOL)


# -- router / assembler redelivery -----------------------------------------


def test_router_caches_and_resends_the_same_tensors():
    plan = ShardPlan(8, 2)
    sent = []
    router = ShardRouter(plan, send=lambda sid, m: sent.append((sid, m)),
                         cache_clocks=4)
    routed = {}
    for clock in range(6):
        router.route(GradientMessage(
            vector_clock=clock, key_range=KeyRange(0, 8),
            values=torch.full((8,), float(clock)), worker_id=0))
        routed[clock] = [m for sid, m in sent[-2:]]
    assert len(sent) == 12
    sent.clear()
    assert router.resend(1, 3) is True
    assert [(sid, m.vector_clock) for sid, m in sent] == [
        (1, 3), (1, 4), (1, 5)]
    for sid, m in sent:
        assert m.key_range == plan.ranges[1]
        assert m is routed[m.vector_clock][1]      # cached, not rebuilt
    sent.clear()
    assert router.resend(0, 99) is False
    assert router.resend(0, 0) is True              # 0, 1 evicted
    assert [m.vector_clock for _, m in sent] == [2, 3, 4, 5]
    assert router.resent == 7


def test_router_rejects_partial_range_delta():
    router = ShardRouter(ShardPlan(8, 2), send=lambda sid, m: None)
    with pytest.raises(ValueError, match="full-range"):
        router.route(GradientMessage(vector_clock=0,
                                     key_range=KeyRange(0, 4),
                                     values=torch.zeros(4)))


def _slice_msg(plan, shard, clock, value=None):
    r = plan.ranges[shard]
    v = float(10 * clock + shard) if value is None else value
    return WeightsMessage(vector_clock=clock, key_range=r,
                          values=torch.full((len(r),), v))


def test_assembler_waits_for_common_clock_then_delivers_once():
    plan = ShardPlan(6, 2)
    delivered = []
    asm = WeightsAssembler(plan,
                           deliver=lambda w, m: delivered.append((w, m)))
    assert asm.offer(0, worker=1, msg=_slice_msg(plan, 0, 0)) is False
    assert delivered == []
    assert asm.offer(1, worker=1, msg=_slice_msg(plan, 1, 0)) is True
    (w, full), = delivered
    assert w == 1 and full.vector_clock == 0
    assert (full.key_range.start, full.key_range.end) == (0, 6)
    assert full.values.tolist() == [0.0] * 3 + [1.0] * 3
    delivered.clear()
    assert asm.offer(0, worker=1, msg=_slice_msg(plan, 0, 2)) is False
    assert asm.offer(1, worker=1, msg=_slice_msg(plan, 1, 1)) is False
    assert delivered == []
    assert asm.offer(1, worker=1, msg=_slice_msg(plan, 1, 2)) is True
    assert delivered[0][1].vector_clock == 2


def test_assembler_stale_slice_triggers_router_resend():
    plan = ShardPlan(6, 2)
    resends = []
    asm = WeightsAssembler(plan, deliver=lambda w, m: None,
                           resend=lambda sid, w, c:
                           resends.append((sid, w, c)) or True)
    asm.offer(0, worker=0, msg=_slice_msg(plan, 0, 3, 0.0))
    asm.offer(1, worker=0, msg=_slice_msg(plan, 1, 3, 0.0))   # delivered
    assert asm.offer(1, worker=0, msg=_slice_msg(plan, 1, 3, 0.0)) is False
    assert resends == [(1, 0, 3)] and asm.stale == 1
    asm.offer(0, worker=0, msg=_slice_msg(plan, 0, 4, 0.0))
    asm.drop(0)
    assert asm.offer(1, worker=0, msg=_slice_msg(plan, 1, 4, 0.0)) is False


# -- the group: N=1 is the unsharded app, N>1 assembles N=1 bitwise ----------


@pytest.mark.parametrize("consistency", [0, 2, -1],
                         ids=["sequential", "bounded", "eventual"])
def test_n1_group_bitwise_theta_and_csv_vs_unsharded(consistency):
    iters = 24
    sx, sy = _data()
    base_sink = ListSink()
    app = StreamingPSApp(_cfg(config, consistency), test_x=sx, test_y=sy,
                         server_log=base_sink, device="cpu")
    for i in range(128):
        app.buffers[i % 4].add(dict(enumerate(sx[i])), int(sy[i]))
    app.run_serial(iters)
    app.close_logs()
    group, sink = _group_run(1, consistency, iters)
    assert torch.equal(group.assembled_theta(), app.server.theta)
    strip = lambda rows: [r.split(";")[1:] for r in rows]
    assert strip(sink.rows) == strip(base_sink.rows)
    assert len(sink.rows) > 0


@pytest.mark.parametrize("task,n", [("logreg", 2), ("logreg", 4),
                                    ("mlp", 2), ("mlp", 4)])
def test_dense_groups_assemble_the_n1_theta(task, n):
    """Each shard applies exactly its slice of the same delta, so the
    assembled N>1 theta is the N=1 theta bit for bit."""
    one, _ = _group_run(1, 0, 24, task=task, test=False)
    many, _ = _group_run(n, 0, 24, task=task, test=False)
    assert many.iterations >= 24 and many.frontier_clock() >= 0
    assert torch.equal(many.assembled_theta(), one.assembled_theta())


@pytest.mark.parametrize("consistency", [0, -1])
def test_sparse_slices_match_the_dense_apply_over_a_topk_run(consistency):
    """Workers sparsify with top-k: at N=2 the router sends sparse slices
    (tid 6, empty ones too) and the shards apply them by index, at N=1 the
    server applies the densified delta; the thetas are equal."""
    one, _ = _group_run(1, consistency, 24, compress="topk:0.1", test=False)
    two, _ = _group_run(2, consistency, 24, compress="topk:0.1", test=False)
    assert torch.equal(two.assembled_theta(), one.assembled_theta())
    assert sum(s.sparse_applies for s in two.shards) > 0
    assert sum(s.empty_slices for s in two.shards) \
        + sum(s.sparse_applies for s in two.shards) >= 2 * 24


def test_group_frontier_eval_writes_server_rows():
    group, sink = _group_run(2, 0, 24)
    clocks = [int(r.split(";")[2]) for r in sink.rows]
    assert clocks == sorted(clocks) and len(clocks) >= 5
    assert all(r.split(";")[1] == "-1" for r in sink.rows)


def test_group_async_eval_rows_equal_inline():
    inline, isink = _group_run(2, 0, 24)
    sx, sy = _data()
    cfg = _cfg(config, 0)
    fab = fabric_mod.Fabric()
    sink = ListSink()
    group = ShardedServerGroup(cfg, fab, 2, device="cpu", test_x=sx,
                               test_y=sy, log=sink)
    assert group.enable_async_eval() is group.enable_async_eval()
    buffers = {w: SlidingBuffer(8, cfg.buffer) for w in range(4)}
    nodes = [WorkerNode(w, cfg, fab, buffers[w], "cpu", sx, sy, ListSink())
             for w in range(4)]
    for i in range(128):
        buffers[i % 4].add(dict(enumerate(sx[i])), int(sy[i]))
    group.run_serial(nodes, 24)
    group.close_eval()
    strip = lambda rows: [r.split(";")[1:] for r in rows]
    assert strip(sink.rows) == strip(isink.rows)


def test_group_refuses_what_is_not_ported():
    group = ShardedServerGroup(_cfg(config, 0), fabric_mod.Fabric(), 2,
                               device="cpu")
    # tiered residency per shard is ported: attaching gives each shard a
    # store over its own range, seeded with its slice (values unchanged)
    from kafka_ps_tpu_torch.store import TieredParamStore
    before = group.assembled_theta()
    group.attach_param_stores(lambda s: TieredParamStore(
        s.theta, s._range, hot_bytes=64, page_params=8, device=s.device))
    for s, r in zip(group.shards, group.plan.ranges):
        assert s.param_store.key_range == r
        assert s.param_store.tier_counts()["hot"] == 2
    assert torch.equal(group.assembled_theta(), before)
    # serving at the frontier is ported: attaching no longer raises, and
    # the start publishes the assembled theta at frontier clock 0
    from kafka_ps_tpu_torch.serving.snapshot import SnapshotRegistry
    registry = SnapshotRegistry()
    group.attach_serving(registry)
    group.start()
    assert registry.latest.vector_clock == 0
    assert torch.equal(registry.latest.theta, group.assembled_theta())


# -- per-shard checkpoints -------------------------------------------------


def test_group_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "state.npz")
    group, _ = _group_run(2, 0, 12, test=False)
    group.set_checkpoint(path, every=1000)
    theta = group.assembled_theta()
    cut = group.snapshot_cut()
    assert len(cut) == 2
    assert torch.equal(torch.cat([read() for read, _ in cut]), theta)
    group.save_checkpoint_now()
    for i in range(2):
        assert (tmp_path / ckpt.shard_state_path("state.npz", i, 2)).exists()
    restored = ShardedServerGroup(_cfg(config, 0), fabric_mod.Fabric(), 2,
                                  device="cpu")
    restored.set_checkpoint(path, every=1000)
    assert restored.maybe_restore() is True
    assert torch.equal(restored.assembled_theta(), theta)
    for orig, rest in zip(group.shards, restored.shards):
        assert rest.tracker.clocks == orig.tracker.clocks


def _jax_group_run(n, consistency=0, iters=24, task="logreg", test=True):
    sx, sy = _data()
    cfg = _cfg(jconfig, consistency, task=task)
    fab = jfabric.Fabric()
    sink = ListSink()
    group = jsharding.ShardedServerGroup(
        cfg, fab, n, test_x=sx if test else None,
        test_y=sy if test else None, log=sink)
    buffers = {w: JBuffer(8, cfg.buffer) for w in range(4)}
    nodes = [JWorker(w, cfg, fab, buffers[w], sx, sy, ListSink())
             for w in range(4)]
    for i in range(128):
        buffers[i % 4].add(dict(enumerate(sx[i])), int(sy[i]))
    group.run_serial(nodes, iters)
    return group, sink


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_shard_checkpoints_cross_between_the_packages(tmp_path, direction):
    path = str(tmp_path / "state.npz")
    if direction == "jax_to_port":
        src, _ = _jax_group_run(2, 0, 12, test=False)
        src.set_checkpoint(path, every=1000)
        src.save_checkpoint_now()
        dst = ShardedServerGroup(_cfg(config, 0), fabric_mod.Fabric(), 2,
                                 device="cpu")
        want = src.assembled_theta().astype(np.float32).tobytes()
    else:
        src, _ = _group_run(2, 0, 12, test=False)
        src.set_checkpoint(path, every=1000)
        src.save_checkpoint_now()
        dst = jsharding.ShardedServerGroup(_cfg(jconfig, 0),
                                           jfabric.Fabric(), 2)
        want = src.assembled_theta().numpy().tobytes()
    dst.set_checkpoint(path, every=1000)
    assert dst.maybe_restore() is True
    got = np.asarray(dst.assembled_theta(), np.float32).tobytes()
    assert got == want
    for a, b in zip(src.shards, dst.shards):
        assert list(a.tracker.clocks) == list(b.tracker.clocks)
        assert a.iterations == b.iterations
    assert ckpt.shard_state_path(path, 1, 2) == \
        jckpt.shard_state_path(path, 1, 2)


# -- against the JAX package -------------------------------------------------


@pytest.mark.parametrize("consistency", [0, 2, -1])
def test_n2_group_matches_the_jax_group(consistency):
    iters = 24
    jgroup, jsink = _jax_group_run(2, consistency, iters)
    group, sink = _group_run(2, consistency, iters)
    np.testing.assert_allclose(group.assembled_theta().numpy(),
                               np.asarray(jgroup.assembled_theta()),
                               rtol=RTOL, atol=ATOL)
    assert group.iterations == jgroup.iterations
    assert [s.tracker.clocks for s in group.shards] == \
        [list(s.tracker.clocks) for s in jgroup.shards]
    rows, jrows = ([r.split(";") for r in x.rows] for x in (sink, jsink))
    assert [r[1:3] for r in rows] == [r[1:3] for r in jrows]
    assert len(rows) > 0
    tol = 1.0 / 128
    for ours, ref in zip(rows, jrows):
        np.testing.assert_allclose(float(ours[3]), float(ref[3]),
                                   rtol=RTOL, atol=ATOL)
        assert abs(float(ours[4]) - float(ref[4])) <= tol
        assert abs(float(ours[5]) - float(ref[5])) <= tol


def test_n2_mlp_group_matches_the_jax_group():
    jgroup, _ = _jax_group_run(2, -1, 24, task="mlp", test=False)
    jcfg = _cfg(jconfig, -1, task="mlp")
    from kafka_ps_tpu.models.task import get_task as jget_task
    theta0 = from_jax_params(
        np.asarray(jget_task("mlp", jcfg.model).init_params(), np.float32),
        _cfg(config, -1, task="mlp").model, "cpu", task="mlp")
    group, _ = _group_run(2, -1, 24, task="mlp", theta0=theta0, test=False)
    np.testing.assert_allclose(group.assembled_theta().numpy(),
                               np.asarray(jgroup.assembled_theta()),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shards", [2, 3])
def test_router_slices_are_the_jax_frames(shards):
    """The router's dense (tid 2) and sparse (tid 6) slices serialize to
    the JAX package's bytes, and each package decodes the other's."""
    n = 40
    rng = np.random.default_rng(7)
    values = rng.normal(size=n).astype(np.float32)
    idx = np.array([37, 2, 19, 11, 30, 5], dtype=np.int32)
    vals = rng.normal(size=6).astype(np.float32)
    plan, jplan = ShardPlan(n, shards), jsharding.ShardPlan(n, shards)
    dense = plan.split_dense(GradientMessage(
        vector_clock=4, key_range=KeyRange(0, n),
        values=torch.from_numpy(values), worker_id=2))
    jdense = jplan.split_dense(JGrad(vector_clock=4, key_range=JRange(0, n),
                                     values=values, worker_id=2))
    sparse = plan.split_sparse(GradientMessage(
        vector_clock=5, key_range=KeyRange(0, n), values=torch.zeros(n),
        worker_id=1, encoded=EncodedValues(
            CODEC_TOPK, 0.15, (torch.from_numpy(idx),
                               torch.from_numpy(vals)))))
    jsparse = jplan.split_sparse(JGrad(
        vector_clock=5, key_range=JRange(0, n),
        values=np.zeros(n, np.float32), worker_id=1,
        encoded=JEnc(CODEC_TOPK, 0.15, (idx, vals))))
    for ours, ref in zip(dense + sparse, jdense + jsparse):
        b, jb = serde.to_bytes(ours), jserde.to_bytes(ref)
        assert b == jb
        assert jserde.to_bytes(jserde.from_bytes(b)) == b
        assert serde.to_bytes(serde.from_bytes(jb, device="cpu")) == jb
    # the type id after the 4-byte magic: tid 2 dense, tid 6 sparse
    assert [serde.to_bytes(s)[4] for s in dense] == [2] * shards
    assert [serde.to_bytes(s)[4] for s in sparse] == [6] * shards


# -- one sharded round through the bridges -----------------------------------


@pytest.mark.parametrize("task,slab,shards", [("logreg", "f32", 2),
                                              ("mlp", "f32", 2),
                                              ("logreg", "int8", 3)])
def test_sharded_bridge_round_is_bitwise_in_process(task, slab, shards):
    """One -c 0 round through shard servers behind localhost bridges, the
    weights assembled from their slices and each delta routed per shard:
    the deltas and the assembled theta are the unsharded in-process
    round's, bit for bit (tests/torch_scaleout_runs.py)."""
    from torch_scaleout_runs import sharded_bridge_round
    (ref_grads, ref_theta), (grads, theta) = sharded_bridge_round(
        "cpu", task, shards=shards, slab=slab)
    assert [(g.worker_id, g.vector_clock) for g in grads] == \
        [(g.worker_id, g.vector_clock) for g in ref_grads]
    for a, b in zip(ref_grads, grads):
        assert torch.equal(a.values, b.values)
    assert torch.equal(ref_theta, theta) and theta.abs().sum() > 0
