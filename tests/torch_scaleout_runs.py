"""Small drives of the port's scale-out paths, shared by the CPU tests,
the card tests (tests/test_torch_cuda.py) and chip_smoke.py.  Imports no
JAX.

  * `group_run`: a ShardedServerGroup of N shards and its workers, run
    serially (gang dispatch off, inline eval), optionally with top-k
    workers (sparse slices at N > 1);
  * `unsharded_run`: the app's serial run on the same rows, the N=1
    reference;
  * `direct_run` / `aggregated_run`: one app driven message by message,
    its gradients applied directly or through one LocalAggregator in
    front of all workers (stacked or summed, int8 at the aggregator, an
    optional reset and restore of the aggregator);
  * `sharded_bridge_round`: one -c 0 round through two localhost
    ServerBridges (one shard each) and per-shard WorkerBridges with the
    weights assembler, against the same round in process on one
    unsharded server.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from kafka_ps_tpu_torch.data.buffer import SlidingBuffer
from kafka_ps_tpu_torch.data.synth import generate
from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime import net
from kafka_ps_tpu_torch.runtime.server import ServerNode
from kafka_ps_tpu_torch.runtime.worker import WorkerNode
from kafka_ps_tpu_torch.utils.config import (BufferConfig, ModelConfig,
                                             PSConfig)


class ListSink:
    def __init__(self):
        self.rows = []

    def __call__(self, line: str) -> None:
        self.rows.append(line)

    def close(self) -> None:
        pass


def config(consistency=0, task="logreg", features=8, classes=2, hidden=6,
           workers=4, rows=32, compress="none", slab="f32"):
    return PSConfig(num_workers=workers, consistency_model=consistency,
                    task=task, slab_dtype=slab, compress=compress,
                    model=ModelConfig(num_features=features,
                                      num_classes=classes,
                                      local_learning_rate=0.5,
                                      hidden_dim=hidden),
                    buffer=BufferConfig(min_size=min(8, rows),
                                        max_size=rows),
                    use_gang=False, eval_async=False)


def dataset(cfg, n, seed=0):
    x, y = generate(n, cfg.model.num_features, cfg.model.num_classes,
                    seed=seed, center_scale=0.3)
    return x.astype(np.float32), y.astype(np.int32)


def _fill(buffers, cfg, x, y):
    w = cfg.num_workers
    for i in range(len(x)):
        buffers[i % w].add({int(k): float(x[i, k])
                            for k in np.flatnonzero(x[i])}, int(y[i]))


def group_run(device, n, cfg, iters, x, y, test=None, theta0=None,
              topk=None, tracer=None, telemetry=None):
    """(group, server rows) after `iters` serial iterations of an N-shard
    group over `cfg.num_workers` workers holding the rows of x, y; the
    group and the workers get `tracer` and `telemetry`."""
    from kafka_ps_tpu_torch.runtime.sharding import ShardedServerGroup
    fab = fabric_mod.Fabric()
    sink = ListSink()
    tx, ty = test if test is not None else (None, None)
    group = ShardedServerGroup(cfg, fab, n, device=device, test_x=tx,
                               test_y=ty, log=sink, tracer=tracer,
                               telemetry=telemetry)
    if theta0 is not None:
        for s, r in zip(group.shards, group.plan.ranges):
            s.theta = theta0[r.start:r.end].clone().to(device)
    buffers = {w: SlidingBuffer(cfg.model.num_features, cfg.buffer)
               for w in range(cfg.num_workers)}
    nodes = [WorkerNode(w, cfg, fab, buffers[w], device, tx, ty,
                        ListSink(), tracer=tracer, telemetry=telemetry)
             for w in range(cfg.num_workers)]
    if topk is not None:
        from kafka_ps_tpu_torch import compress
        codec = compress.get_codec(compress.parse_codec(topk),
                                   group.task.num_params)
        for nd in nodes:
            nd.compressor = compress.ErrorFeedback(codec, device)
    _fill(buffers, cfg, x, y)
    group.run_serial(nodes, iters)
    return group, sink.rows


def unsharded_run(device, cfg, iters, x, y, test, theta0=None):
    """(app, server rows): the app's serial run on the same rows."""
    from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
    sink = ListSink()
    app = StreamingPSApp(cfg, test_x=test[0], test_y=test[1],
                         server_log=sink, device=device)
    if theta0 is not None:
        app.server.theta = theta0.to(device)
    buffers = {w: app.buffers[w] for w in range(cfg.num_workers)}
    _fill(buffers, cfg, x, y)
    app.run_serial(iters)
    app.close_logs()
    return app, sink.rows


def _app(device, cfg, x, y, test, **kw):
    from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
    rows = ListSink()
    app = StreamingPSApp(cfg, test_x=test[0], test_y=test[1],
                         server_log=rows, device=device, **kw)
    _fill({w: app.buffers[w] for w in range(cfg.num_workers)}, cfg, x, y)
    app.rows = rows.rows
    return app


def _deliver(app, delivered):
    """Weights in worker-id order with the assembler's dedup, as an
    --aggregate worker process sees them."""
    for worker in app.workers:
        w = worker.worker_id
        while True:
            msg = app.fabric.poll(fabric_mod.WEIGHTS_TOPIC, w)
            if msg is None:
                break
            if msg.vector_clock <= delivered.get(w, -1):
                continue
            delivered[w] = msg.vector_clock
            worker.on_weights(msg)


def direct_run(device, cfg, iters, x, y, test):
    """The app pumped message by message, gradients applied directly."""
    app = _app(device, cfg, x, y, test)
    app.server.start_training_loop()
    delivered, stalled = {}, 0
    while app.server.iterations < iters:
        _deliver(app, delivered)
        progressed = False
        while app.server.iterations < iters:
            g = app.fabric.poll(fabric_mod.GRADIENTS_TOPIC, 0)
            if g is None:
                break
            app.server.process(g)
            progressed = True
        stalled = 0 if progressed else stalled + 1
        if stalled >= 100:
            raise RuntimeError("direct pump deadlocked")
    app.close_logs()
    return app


def aggregated_run(device, cfg, iters, x, y, test, codec=None,
                   summed=False, restart_at=None, tracer=None,
                   telemetry=None):
    """The same app with one LocalAggregator in front of all workers:
    raw deltas in, one composite per flush into the gate; `codec` (e.g.
    "int8") compresses at the aggregator, with the server's weights
    compressor; `restart_at`: the aggregator's state is reset and
    restored from ef_state() after that many flushes, and the workers'
    last deltas are offered again.  The app and the aggregator get
    `tracer` and `telemetry`."""
    from kafka_ps_tpu_torch.agg import LocalAggregator
    from kafka_ps_tpu_torch.compress import wire as cwire
    app = _app(device, dataclasses.replace(cfg, compress="none"), x, y,
               test, tracer=tracer, telemetry=telemetry)
    spec = None
    if codec is not None:
        from kafka_ps_tpu_torch import compress
        spec = cwire.parse_codec(codec)
        app.server.compressor = compress.WeightsCompressor(
            compress.get_codec(spec, app.server.task.num_params))
    agg = LocalAggregator(0, app.server.task.num_params, codec_spec=spec,
                          summed=summed, device=device, telemetry=telemetry,
                          tracer=tracer)
    app.server.start_training_loop()
    delivered, last_sent, stalled, rounds = {}, {}, 0, 0
    while app.server.iterations < iters:
        _deliver(app, delivered)
        while True:
            g = app.fabric.poll(fabric_mod.GRADIENTS_TOPIC, 0)
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
            state = agg.ef_state()
            agg.reset()
            agg.ef_restore(state)
            for g in last_sent.values():
                agg.offer(dataclasses.replace(g))
            dup = agg.combine()
            if dup is not None:
                app.server.process(dup)
        stalled = 0 if progressed else stalled + 1
        if stalled >= 100:
            raise RuntimeError("aggregated pump deadlocked")
    app.close_logs()
    app.aggregator = agg
    return app


def sharded_bridge_round(device, task: str, shards: int = 2,
                         features: int = 16, classes: int = 3,
                         hidden: int = 8, workers: int = 2, rows: int = 20,
                         slab: str = "f32", seed: int = 5):
    """((gradients, theta) of one -c 0 round in process on one unsharded
    server, (gradients, assembled theta) of the round through `shards`
    shard servers behind localhost bridges).  The gradients are the
    workers' full deltas (the router's input), in worker order."""
    from kafka_ps_tpu_torch.cli.socket_mode import _AssemblerSink
    from kafka_ps_tpu_torch.runtime.sharding import (ShardPlan, ShardRouter,
                                                     WeightsAssembler)
    device = torch.device(device)
    cfg = dataclasses.replace(
        config(0, task, features, classes, hidden, workers, rows,
               slab=slab),
        buffer=BufferConfig(min_size=rows, max_size=rows))
    x, y = generate(rows * workers, features, classes, seed=seed)
    data = [({int(k): float(x[i, k]) for k in np.flatnonzero(x[i])},
             int(y[i])) for i in range(len(x))]
    per_worker = {w: data[w::workers] for w in range(workers)}
    ids = list(range(workers))

    # in process, unsharded
    fab = fabric_mod.Fabric()
    server = ServerNode(cfg, fab, device)
    theta0 = torch.randn(server.task.num_params,
                         generator=torch.Generator().manual_seed(seed)
                         ).mul_(0.05).to(device)
    server.theta = theta0
    bufs = {w: SlidingBuffer(features, cfg.buffer) for w in ids}
    for w in ids:
        bufs[w].add_many(per_worker[w])
    nodes = {w: WorkerNode(w, cfg, fab, bufs[w], device) for w in ids}
    server.start_training_loop()
    for w, node in nodes.items():
        node.on_weights(fab.poll(fabric_mod.WEIGHTS_TOPIC, w))
    ref_grads = sorted((fab.poll(fabric_mod.GRADIENTS_TOPIC, 0)
                        for _ in ids), key=lambda g: g.worker_id)
    for g in ref_grads:
        server.process(g)
    ref = (ref_grads, server.theta)

    # through the bridges, one shard server each
    plan = ShardPlan(server.task.num_params, shards)
    sbs = [net.ServerBridge(device=device) for _ in range(shards)]
    sfabs = [sb.wrap(fabric_mod.Fabric()) for sb in sbs]
    snodes = [ServerNode(cfg, sfabs[i], device, key_range=r, shard_id=i,
                         num_shards=shards)
              for i, r in enumerate(plan.ranges)]
    for node, r in zip(snodes, plan.ranges):
        node.theta = theta0[r.start:r.end].clone()
    wbs = [net.WorkerBridge("127.0.0.1", sb.port, ids, device=device)
           for sb in sbs]
    local = fabric_mod.Fabric()
    asm = WeightsAssembler(plan, deliver=lambda w, m: local.send(
        fabric_mod.WEIGHTS_TOPIC, w, m))
    lock = threading.Lock()
    for i, wb in enumerate(wbs):
        wb.set_weights_sink(_AssemblerSink(i, asm, lock))
    bufs2 = {w: SlidingBuffer(features, cfg.buffer) for w in ids}
    routed = []
    wnodes = {}
    for w in ids:
        router = ShardRouter(plan, send=lambda sid, m: wbs[sid]
                             .send_gradients(0, m))
        route = router.route
        router.route = lambda m, route=route: (routed.append(m), route(m))
        wnodes[w] = WorkerNode(w, cfg, local, bufs2[w], device)
        wnodes[w].shard_router = router
    threads = [threading.Thread(target=wb.run_reader, args=(bufs2,),
                                daemon=True) for wb in wbs]
    for t in threads:
        t.start()
    try:
        for sb in sbs:
            sb.wait_for_connected(ids, timeout=30.0)
        for w in ids:
            assert sbs[0].send_data_batch(w, per_worker[w])
        deadline = time.monotonic() + 30.0
        while (any(bufs2[w].count < rows for w in ids)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        for node in snodes:
            node.start_training_loop()
        for w in ids:
            wnodes[w].on_weights(local.poll_blocking(
                fabric_mod.WEIGHTS_TOPIC, w, timeout=30.0))
        for i, node in enumerate(snodes):
            slices = sorted((sfabs[i].poll_blocking(
                fabric_mod.GRADIENTS_TOPIC, 0, timeout=30.0) for _ in ids),
                key=lambda g: g.worker_id)
            for g in slices:
                node.process(g)
    finally:
        for b in (*wbs, *sbs):
            b.close()
        for t in threads:
            t.join(timeout=10.0)
    for b in (*wbs, *sbs):
        b.raise_reader_error()
    grads = sorted(routed, key=lambda g: g.worker_id)
    return ref, (grads, torch.cat([n.theta for n in snodes]))
