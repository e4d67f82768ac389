"""Small drives of the port's serving plane, shared by the CPU tests, the
card tests (tests/test_torch_cuda.py) and chip_smoke.py.  Imports no JAX.

  * `serve_config` / `build_app`: the app of the JAX package's serving
    tests (4 workers, blobs around three centres), its buffers filled
    through `data_sink`;
  * `read_load_run`: a run of the trainer with or without serving and a
    live read load on a predictor thread: the final theta, the rows and
    the predictions' clocks;
  * `snapshot_sequence`: the (clock, theta bytes) sequence a run
    publishes;
  * `bucket_outputs`: an engine's dispatch at every bucket size on fixed
    rows, the labels and confidences each row got;
  * `group_snapshots`: the snapshots of a ShardedServerGroup with
    `attach_serving`, beside the frontier clocks of its passes.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from kafka_ps_tpu_torch.serving.policy import StalenessError
from kafka_ps_tpu_torch.serving.snapshot import SnapshotRegistry
from kafka_ps_tpu_torch.utils.config import (BufferConfig, ModelConfig,
                                             PSConfig, ServingConfig,
                                             StreamConfig)


def serve_config(consistency=0, use_gang=True, task="logreg", features=8,
                 classes=2, hidden=16, workers=4, eval_async=True,
                 **serving_kw) -> PSConfig:
    return PSConfig(
        num_workers=workers, consistency_model=consistency, task=task,
        model=ModelConfig(num_features=features, num_classes=classes,
                          local_learning_rate=0.5, hidden_dim=hidden),
        buffer=BufferConfig(min_size=8, max_size=32),
        stream=StreamConfig(time_per_event_ms=1.0),
        use_gang=use_gang, eval_async=eval_async,
        serving=ServingConfig(enabled=True, **serving_kw))


def make_dataset(n=256, f=8, seed=0):
    """Labels 1..2 around three centres, as tests/test_serving.py."""
    rng = np.random.default_rng(seed)
    y = rng.integers(1, 3, size=n).astype(np.int32)
    centers = np.stack([np.zeros(f), np.full(f, 2.5), np.full(f, -2.5)]
                       ).astype(np.float32)
    x = (centers[y] + rng.normal(scale=0.5, size=(n, f))).astype(np.float32)
    return x, y


def build_app(cfg, device, n=256, **kw):
    """(app, x, y) with every row of the dataset in the buffers."""
    from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
    x, y = make_dataset(n, cfg.model.num_features)
    app = StreamingPSApp(cfg, test_x=x, test_y=y, device=device, **kw)
    for i in range(len(x)):
        app.data_sink(i % cfg.num_workers,
                      {j: float(v) for j, v in enumerate(x[i]) if v != 0},
                      int(y[i]))
    return app, x, y


def strip_ts(rows):
    return [r.split(";", 1)[1] for r in rows]


def read_load_run(cfg, device, serve: bool, iters: int = 40,
                  mode: str = "serial", fused: bool = False) -> dict:
    """One run of the trainer; with `serve`, a predictor thread reads
    through the engine for the whole run.  Returns the final theta on
    the CPU, the server and worker rows and the clocks the predictor
    saw, in order."""
    server_rows, worker_rows = [], []
    app, x, _ = build_app(cfg, device, server_log=server_rows.append,
                          worker_log=worker_rows.append)
    stop = threading.Event()
    clocks: list[int] = []
    errors: list[BaseException] = []
    predictor = None
    if serve:
        engine = app.enable_serving()

        def load():
            while not stop.is_set():
                try:
                    clocks.append(engine.predict(x[0],
                                                 timeout=10.0).vector_clock)
                except StalenessError:
                    pass               # before the first snapshot
                except BaseException as e:  # noqa: BLE001 — the test asks
                    errors.append(e)
                    return

        predictor = threading.Thread(target=load, daemon=True)
        predictor.start()
    try:
        if fused:
            app.run_fused_bsp(iters)
        elif mode == "serial":
            app.run_serial(iters)
        else:
            app.run_threaded(iters)
    finally:
        stop.set()
        if predictor is not None:
            predictor.join(timeout=30.0)
        app.close_serving()
        app.close_logs()
    if errors:
        raise errors[0]
    stats = app.serving_engine.stats() if serve else None
    return {"theta": app.server.theta.cpu(), "server": server_rows,
            "worker": worker_rows, "clocks": clocks, "stats": stats,
            "app": app}


def snapshot_sequence(cfg, device, iters: int = 40, **kw) -> list:
    """[(clock, theta bytes)] of every snapshot a serial run publishes
    (`kw`: the app's, e.g. tracer and telemetry)."""
    app, _, _ = build_app(cfg, device, **kw)
    registry = SnapshotRegistry(capacity=100000)
    app.server.serving = registry
    app.run_serial(iters)
    app.close_logs()
    return [(s.vector_clock, s.theta.cpu().numpy().tobytes())
            for s in registry.snapshots()]


def bucket_outputs(engine, rows: np.ndarray, sizes) -> list[np.ndarray]:
    """For each n in `sizes`, the engine's dispatch of rows[:n] against
    its newest snapshot: a [2, n] array of labels over confidences."""
    from kafka_ps_tpu_torch.serving.engine import _Request
    tenant = engine._tenants[0]
    snap = tenant.registry.latest
    out = []
    for n in sizes:
        reqs = [_Request(rows[i], None, lambda r: None, time.monotonic(), 0)
                for i in range(n)]
        out.append(np.asarray(engine._dispatch(tenant, snap, reqs))[:, :n])
    return out


def top_two_margin(logits: np.ndarray) -> np.ndarray:
    """Per row, the gap between the two largest logits (a label is only
    defined where it is wider than the float error)."""
    top = np.sort(logits, axis=1)
    return top[:, -1] - top[:, -2]


def group_snapshots(device, n: int, cfg, iters: int, x, y):
    """(registry, group) after a serial run of an n-shard group with
    `attach_serving`."""
    from kafka_ps_tpu_torch.data.buffer import SlidingBuffer
    from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
    from kafka_ps_tpu_torch.runtime.sharding import ShardedServerGroup
    from kafka_ps_tpu_torch.runtime.worker import WorkerNode
    fab = fabric_mod.Fabric()
    group = ShardedServerGroup(cfg, fab, n, device=device)
    registry = SnapshotRegistry(capacity=100000)
    group.attach_serving(registry)
    buffers = {w: SlidingBuffer(cfg.model.num_features, cfg.buffer)
               for w in range(cfg.num_workers)}
    nodes = [WorkerNode(w, cfg, fab, buffers[w], device, None, None,
                        lambda line: None)
             for w in range(cfg.num_workers)]
    for i in range(len(x)):
        buffers[i % cfg.num_workers].add(
            {j: float(v) for j, v in enumerate(x[i]) if v != 0}, int(y[i]))
    group.run_serial(nodes, iters)
    return registry, group




MARGIN = 1e-5                       # top-two logit gap defining a label
CONF_RTOL, CONF_ATOL = 1e-5, 1e-6   # confidences across devices/packages


def engine_card_vs_cpu(device, task="logreg", hidden=128, features=1024,
                       classes=5, max_batch=16, seed=4) -> dict:
    """The engine's predictions on `device` against the engine's own on
    the CPU from the same snapshot (a seeded float32 theta, at clock 6),
    at every bucket size 1..max_batch.  Returns the largest confidence
    difference, whether all are within CONF_RTOL/CONF_ATOL, the label
    mismatches where the CPU's top-two margin exceeds MARGIN, the rows
    compared and the device the card engine's snapshot lives on."""
    from kafka_ps_tpu_torch.models.task import get_task
    from kafka_ps_tpu_torch.serving.engine import PredictionEngine
    cfg = ModelConfig(num_features=features, num_classes=classes,
                      hidden_dim=hidden)
    t = get_task(task, cfg)
    rng = np.random.default_rng(seed)
    scale = 0.05 if task == "logreg" else (2.0 / features) ** 0.5
    theta = torch.from_numpy(
        (rng.normal(size=t.num_params) * scale).astype(np.float32))
    rows = rng.normal(size=(max_batch, features)).astype(np.float32)
    engines = []
    for dev in (device, "cpu"):
        reg = SnapshotRegistry()
        reg.publish(theta.to(dev), vector_clock=6)
        engines.append(PredictionEngine(t, reg, max_batch=max_batch))
    try:
        sizes = range(1, max_batch + 1)
        card = bucket_outputs(engines[0], rows, sizes)
        cpu = bucket_outputs(engines[1], rows, sizes)
        p = engines[0].predict(rows[0])
    finally:
        for e in engines:
            e.close()
    logits = t.predict_logits(theta, torch.from_numpy(rows)).numpy()
    defined = top_two_margin(logits) > MARGIN
    err, within, mismatches, n = 0.0, True, 0, 0
    for a, b in zip(card, cpu):
        k = a.shape[1]
        err = max(err, float(np.abs(a[1] - b[1]).max()))
        within &= bool(np.allclose(a[1], b[1], rtol=CONF_RTOL,
                                   atol=CONF_ATOL))
        mismatches += int((a[0][defined[:k]] != b[0][defined[:k]]).sum())
        n += k
    return {"max_abs_err": err, "within": within,
            "label_mismatches": mismatches, "rows": n,
            "defined": int(defined.sum()),
            "snapshot_device": engines[0].registry.latest.theta.device.type,
            "clock": p.vector_clock}


def unsharded_snapshots(device, cfg, iters: int, x, y) -> list:
    """[(clock, theta bytes)] the app's unsharded server publishes in a
    serial run on the rows of x, y (the registry only, no engine)."""
    from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
    app = StreamingPSApp(cfg, device=device)
    for i in range(len(x)):
        app.data_sink(i % cfg.num_workers,
                      {j: float(v) for j, v in enumerate(x[i]) if v != 0},
                      int(y[i]))
    registry = SnapshotRegistry(capacity=100000)
    app.server.serving = registry
    app.run_serial(iters)
    app.close_logs()
    return [(s.vector_clock, s.theta.cpu().numpy().tobytes())
            for s in registry.snapshots()]


def frontier_check(device, cfg, iters: int = 40, rows: int = 128) -> dict:
    """ShardedServerGroup.attach_serving on `device`: whether N=1 publishes
    the unsharded server's snapshot sequence bitwise, and whether N=2
    publishes strictly increasing frontier clocks, the last one the
    group's frontier, each cut bitwise N=1's last theta at its clock."""
    x, y = make_dataset(rows, cfg.model.num_features)
    reg1, _ = group_snapshots(device, 1, cfg, iters, x, y)
    seq1 = [(s.vector_clock, s.theta.cpu().numpy().tobytes())
            for s in reg1.snapshots()]
    reg2, group = group_snapshots(device, 2, cfg, iters, x, y)
    cuts = reg2.snapshots()
    clocks = [s.vector_clock for s in cuts]
    last = dict(seq1)
    return {"n1_bitwise": seq1 == unsharded_snapshots(device, cfg, iters,
                                                      x, y),
            "n1_snapshots": len(seq1), "cuts": len(cuts),
            "cuts_increasing": clocks == sorted(set(clocks)),
            "last_is_frontier": clocks[-1] == group.frontier_clock(),
            "cuts_bitwise": all(s.theta.cpu().numpy().tobytes()
                                == last.get(s.vector_clock) for s in cuts),
            "device": cuts[-1].theta.device.type}
