"""One -c 0 round of the port's trainer two ways, for the split
deployment's bitwise check: in process (workers and server on one
in-memory fabric), and through a localhost ServerBridge/WorkerBridge
pair (kafka_ps_tpu_torch/runtime/net.py) with the buffer rows delivered
as DATA_BATCH frames.  Same theta, same rows, gang dispatch off, as in a
split worker process.  The bridged round may run with telemetry on either
side (`obs`), trace context then crossing the sockets.  Imports no JAX:
tests/test_torch_socket_mode.py and tests/test_torch_role_telemetry.py
run it on the CPU, tests/test_torch_cuda.py and chip_smoke.py on the
card.
"""

from __future__ import annotations

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


def _round(server, workers, wfab, sfab):
    """Broadcast, one iteration per worker, the gradients applied in
    worker order; returns ([GradientMessage], theta after the round)."""
    server.start_training_loop()
    for w, node in workers.items():
        node.on_weights(wfab.poll_blocking(fabric_mod.WEIGHTS_TOPIC, w,
                                           timeout=30.0))
    grads = sorted((sfab.poll_blocking(fabric_mod.GRADIENTS_TOPIC, 0,
                                       timeout=30.0) for _ in workers),
                   key=lambda g: g.worker_id)
    for g in grads:
        server.process(g)
    return grads, server.theta


def bridge_round(device, task: str, features: int = 16, classes: int = 3,
                 hidden: int = 8, workers: int = 2, rows: int = 20,
                 slab: str = "f32", seed: int = 5, obs=None, info=None):
    """((gradients, theta) in process, (gradients, theta) through the
    bridges) of one round.  `obs(role)` gives the (tracer, telemetry) of
    the bridged round's "server" and "worker" sides (bridges and nodes);
    `info`, a dict, receives whether the worker bridge negotiated trace
    context and each bridge's wire_stats()."""
    ts, ms = obs("server") if obs is not None else (None, None)
    tw, mw = obs("worker") if obs is not None else (None, None)
    device = torch.device(device)
    cfg = PSConfig(num_workers=workers, consistency_model=0, use_gang=False,
                   eval_async=False, task=task, slab_dtype=slab,
                   model=ModelConfig(num_features=features,
                                     num_classes=classes, hidden_dim=hidden),
                   buffer=BufferConfig(min_size=rows, max_size=rows))
    x, y = generate(rows * workers, features, classes, seed=seed)
    data = [({int(k): float(x[i, k]) for k in np.flatnonzero(x[i])},
             int(y[i])) for i in range(len(x))]
    per_worker = {w: data[w::workers] for w in range(workers)}

    def nodes(fab, bufs, tracer=None, telemetry=None):
        return {w: WorkerNode(w, cfg, fab, bufs[w], device, tracer=tracer,
                              telemetry=telemetry)
                for w in range(workers)}

    fab = fabric_mod.Fabric()
    server = ServerNode(cfg, fab, device)
    theta0 = torch.randn(server.task.num_params,
                         generator=torch.Generator().manual_seed(seed)
                         ).mul_(0.05).to(device)
    server.theta = theta0
    bufs = {w: SlidingBuffer(features, cfg.buffer) for w in range(workers)}
    for w in range(workers):
        bufs[w].add_many(per_worker[w])
    ref = _round(server, nodes(fab, bufs), fab, fab)

    sb = net.ServerBridge(device=device, tracer=ts, telemetry=ms)
    sfab = sb.wrap(fabric_mod.Fabric())
    server2 = ServerNode(cfg, sfab, device, tracer=ts, telemetry=ms)
    server2.theta = theta0
    wb = net.WorkerBridge("127.0.0.1", sb.port, list(range(workers)),
                          device=device, tracer=tw, telemetry=mw)
    wfab = wb.make_fabric()
    bufs2 = {w: SlidingBuffer(features, cfg.buffer) for w in range(workers)}
    t = threading.Thread(target=wb.run_reader, args=(bufs2,), daemon=True)
    t.start()
    try:
        sb.wait_for_connected(list(range(workers)), timeout=30.0)
        for w in range(workers):
            assert sb.send_data_batch(w, per_worker[w])
        deadline = time.monotonic() + 30.0
        while (any(bufs2[w].count < rows for w in range(workers))
               and time.monotonic() < deadline):
            time.sleep(0.01)
        got = _round(server2, nodes(wfab, bufs2, tw, mw), wfab, sfab)
    finally:
        wb.close()
        sb.close()
        t.join(timeout=10.0)
    if info is not None:
        info.update(trace_negotiated=wb.trace_negotiated,
                    server_wire=sb.wire_stats(), worker_wire=wb.wire_stats())
    wb.raise_reader_error()
    sb.raise_reader_error()
    return ref, got
