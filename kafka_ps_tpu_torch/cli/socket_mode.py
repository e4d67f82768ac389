"""Split server/worker deployment over the socket transport (counterpart
of kafka_ps_tpu/cli/socket_mode.py): the reference's process topology,
one server process and N worker processes coupled through the wire
(runtime/net.py) instead of the broker.

    # host A — aggregator + consistency gate + stream producer
    python -m kafka_ps_tpu_torch.cli.server_runner --listen 8477 \\
        -c 10 -training train.csv -test test.csv --max_iterations 400 -l

    # host B (and C, ...) — the workers named by --worker_ids
    python -m kafka_ps_tpu_torch.cli.worker_runner --connect hostA:8477 \\
        --worker_ids 0,1,2,3 -test test.csv -l

WEIGHTS / GRADIENTS / INPUT_DATA cross the wire as binary serde frames,
byte for byte the JAX package's, so either role may run either package.
A worker process trains on its device with no gang: each iteration is
one call of the family's kernel (K1/K3 for logreg, K4/K5 for the MLP, by
slab form), and its gradient crosses the socket as serde bytes.  Both
roles run on the CUDA card unless KPS_PLATFORM=cpu.

Kept from the JAX roles: checkpoint and run-id continuity, the
per-run worker log marker, worker state files (`--checkpoint`,
`--state_every`), `--ready-rows`, rerouting of rows under halt and
rebalance, readmission and the liveness reissue, and `--compress`
negotiation.

The scale-out topologies (runtime/sharding.py, agg/):

    # N shard servers, each owning a key range of theta; shard 0 hosts
    # the producer; each has its own checkpoint and durable log
    python -m kafka_ps_tpu_torch.cli.server_runner --listen 8477 \
        --shards 2 --shard-id 0 ...        # and --shard-id 1 on 8478
    python -m kafka_ps_tpu_torch.cli.worker_runner \
        --connect hostA:8477,hostA:8478 --worker_ids 0,1 ...

    # a per-host relay between the server and its host's workers
    python -m kafka_ps_tpu_torch.cli.agg_runner --connect hostA:8477 \
        --listen 8479 --worker_ids 0,1,2,3
    python -m kafka_ps_tpu_torch.cli.worker_runner \
        --aggregate hostB:8479 --worker_ids 0,1 ...

A sharded worker process keeps one bridge per shard, splits each delta
per shard (`--compress topk:R` is then its local sparsifier and the
slices are sparse) and reassembles the weights slices; a dead shard is
not fatal (it reconnects and the router resends what the shard missed).
With `--aggregate` the same worker dials the relay, which compresses for
it; after a relay restart it resends its whole cache.

Telemetry, the JAX roles': every role takes `--trace PATH` (its own
tracer, pid-stamped, dumped at exit), `--metrics-file PATH`
(`--metrics-every S`), `--flight-dir DIR`, `--health-port P`,
`--profile` and `--slo-serving-p99-ms` / `--slo-freshness-ms`
(`_make_telemetry`, `_make_ops`, `_dump_telemetry`); the unsharded
server also takes `--status_every S` (its `[status]` line with the
rolling critical path).  `--model-health` (`--drift-detector`,
`--drift-threshold`) arms a model-health plane on the split server and
each shard (their applies, and the split server's stream rows) and on
each worker process (its rows' evals and buffer arrivals), with a drift
CSV per process under -l (`cli/run.make_model_health`).  The watchdogs
are the JAX roles': the gate on a server or shard, the fsync on a
durable shard, the serving one on a serving server, the replica and
serving ones on a replica, and the slo and drift ones with their
planes.  Trace context crosses the sockets when both ends trace
(runtime/net.py), so the merge tool joins the processes' traces into one
`delta.wire` chain per delta:

    python -m kafka_ps_tpu_torch.telemetry merge -o merged.json \
        server/trace.json w0/trace.json w1/trace.json
    python -m kafka_ps_tpu_torch.telemetry critpath merged.json

Tiered residency (store/): `--tier-hot-bytes`, `--tier-warm-bytes` and
`--tier-page-params` give a server's (or a shard's) slice to a tiered
store before its checkpoint restore; a warm cap needs `--durable-log`,
under which a shard's cold pages live in `DIR/shard<I>of<N>/param-cold`.

Serving (serving/):

    # the unsharded server answers PREDICT on its own port, from worker
    # connections and plain clients, by socket and (--serve-shm) by
    # shared memory
    python -m kafka_ps_tpu_torch.cli.server_runner --listen 8477 --serve ...

    # a read replica following a durable log (one server's, or the
    # per-shard logs of a --shards N deployment) read-only
    python -m kafka_ps_tpu_torch.cli.server_runner --serve-replica \
        --durable-log DIR --serve_port 8480 --num_features 1024 ...

A shard process refuses --serve: it holds one slice of theta, so a
sharded deployment's reads go through a replica, which serves the
assembled theta at the frontier clock.

At exit each role prints one line of run statistics on stderr,
`kafka_ps_tpu_torch server: {json}` or `kafka_ps_tpu_torch worker:
{json}`: the role and device; server iterations, membership, rows sent
and the eval engine's state, with the wall-clock ms at which the server's
logs were flushed (`end_ms`) and the gradients it read but never applied
(`gradients_pending`), or a worker's rows; the bridge's frames,
bytes and serde milliseconds per frame by topic and its dropped sends;
and for a worker its kernel calls by family and form
(ops/fused_update.counts).
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import sys
import threading
import time

from kafka_ps_tpu_torch.analysis.lockgraph import OrderedLock
from kafka_ps_tpu_torch.cli import run as run_mod
from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime import net


def _make_cfg(args):
    from kafka_ps_tpu_torch.utils.config import (BufferConfig, ModelConfig,
                                                 PSConfig, StreamConfig,
                                                 TierConfig)
    if getattr(args, "eval_every", 1) < 1:
        raise SystemExit("--eval_every must be >= 1")
    if getattr(args, "tier_warm_bytes", 0) \
            and not getattr(args, "durable_log", None):
        raise SystemExit(
            "--tier-warm-bytes demotes pages to commit-log records; "
            "run with --durable-log DIR so the cold partition has a "
            "home (docs/TIERING.md)")
    return PSConfig(
        num_workers=args.num_workers,
        consistency_model=getattr(args, "consistency_model", 0),
        task=args.task,
        model=ModelConfig(num_features=args.num_features,
                          num_classes=args.num_classes,
                          num_max_iter=args.local_iterations,
                          local_learning_rate=args.local_learning_rate,
                          hidden_dim=args.hidden_dim),
        buffer=BufferConfig(
            min_size=getattr(args, "min_buffer_size", 128),
            max_size=getattr(args, "max_buffer_size", 1024),
            coefficient=getattr(args, "buffer_size_coefficient", 0.3)),
        stream=StreamConfig(time_per_event_ms=getattr(
            args, "producer_time_per_event", 200)),
        eval_every=getattr(args, "eval_every", 1),
        eval_async=getattr(args, "eval_async", True),
        # the wire protocol has no gang-notice frame, and a notice
        # crossing a socket could promise nothing about remote queue
        # contents anyway: split mode stays per-message
        use_gang=False,
        slab_dtype=getattr(args, "slab_dtype", "f32") or "f32",
        slab_incremental=not getattr(args, "full_slab_upload", False),
        compress=getattr(args, "compress", "none") or "none",
        serving=run_mod.serving_config(args),
        tier=TierConfig(
            hot_bytes=getattr(args, "tier_hot_bytes", 0),
            warm_bytes=getattr(args, "tier_warm_bytes", 0),
            page_params=getattr(args, "tier_page_params", 1024)))


def _attach_tier_store(server, cfg, key_range, cold_dir):
    """Attach tiered residency per cfg.tier (store/) and start its policy
    thread; None when both caps are 0.  Called before the checkpoint
    restore, so that the restore applies the recorded residency; the
    caller closes the store after the final save, which may still read
    cold pages."""
    from kafka_ps_tpu_torch.store import attach_tiered_store
    store = attach_tiered_store(server, cfg.tier, key_range, cold_dir)
    if store is None:
        return None
    t = cfg.tier
    caps = {k: v for k, v in (("hot", t.hot_bytes),
                              ("warm", t.warm_bytes)) if v}
    print(f"tiered residency: caps {caps}, "
          f"{store.num_pages} pages of {t.page_params} keys",
          file=sys.stderr, flush=True)
    return store


def _codec_spec(args):
    """Validate and parse --compress."""
    from kafka_ps_tpu_torch.compress import wire as cwire
    try:
        return cwire.parse_codec(getattr(args, "compress", "none") or "none")
    except ValueError as e:
        raise SystemExit(f"--compress: {e}") from None


def _print_stats(role: str, stats: dict) -> None:
    print(f"kafka_ps_tpu_torch {role}: " + json.dumps(stats),
          file=sys.stderr, flush=True)


def _make_telemetry(args):
    """One process's tracer (None without --trace; its events carry
    this pid, so the merge tool stitches the processes' dumps) and its
    metrics registry (armed as cli/run.wants_metrics says), with the
    periodic --metrics-every dump started."""
    from kafka_ps_tpu_torch.telemetry import maybe_telemetry
    tracer = None
    if getattr(args, "trace", None):
        from kafka_ps_tpu_torch.utils.trace import Tracer
        tracer = Tracer()
    telemetry = maybe_telemetry(tracer,
                                want_metrics=run_mod.wants_metrics(args))
    if getattr(args, "metrics_file", None) \
            and getattr(args, "metrics_every", 0.0) > 0:
        telemetry.start_dumper(args.metrics_file, args.metrics_every)
    return tracer, telemetry


def _make_ops(args, telemetry, *, role, shard=None, meta=None,
              modelhealth=None):
    """The flight recorder, watchdogs and health plane of one role
    process (telemetry/health.OpsPlane), not yet started, with the
    sampling profiler (--profile), the SLO plane (--slo-*,
    --model-health) and `modelhealth`.  Inert without any of those, so
    every role wires it; with --flight-dir the process also dumps its
    rings on SIGTERM/SIGABRT, the postmortem's material."""
    from kafka_ps_tpu_torch.telemetry.health import OpsPlane
    from kafka_ps_tpu_torch.telemetry.slo import plane_from_args
    return OpsPlane(flight_dir=getattr(args, "flight_dir", None),
                    health_port=getattr(args, "health_port", None),
                    telemetry=telemetry, role=role, shard=shard, meta=meta,
                    profile=getattr(args, "profile", False),
                    slo_plane=plane_from_args(args, telemetry),
                    modelhealth=modelhealth)


def _dump_telemetry(args, tracer, telemetry) -> None:
    """The exit path of _make_telemetry: the final metrics file and the
    trace, whose path is printed."""
    if getattr(args, "metrics_file", None):
        telemetry.stop_dumper()
        telemetry.write_prometheus(args.metrics_file)
    if getattr(args, "trace", None) and tracer is not None:
        print(tracer.dump(args.trace), file=sys.stderr, flush=True)


class _BatchingSink:
    """Producer sink that coalesces stream rows into T_DATA_BATCH frames.

    Per-worker row buffers flush on size (one frame per `batch` rows) or
    age (`flush_aged`, called from the server main loop's poll tick, so
    a trickling stream never strands rows).  Delivery goes through
    ServerBridge.send_data_batch — one frame, one syscall, one receiver
    lock for the whole batch — and falls back to the per-row sink (which
    owns the reroute/eviction policy) whenever the batch path can't
    deliver.  Thread-safe: the producer thread adds while the main loop
    flushes; a size-flush racing an age-flush can reorder rows between
    frames, which the reroute path already permits."""

    def __init__(self, bridge, fallback, deliverable,
                 batch: int = 32, max_age: float = 0.05):
        self._bridge = bridge
        self._fallback = fallback      # per-row sink with reroute logic
        self._deliverable = deliverable
        self._batch = batch
        self._max_age = max_age
        self._rows: dict[int, list] = {}
        self._oldest: dict[int, float] = {}   # worker -> first-row time
        self._lock = OrderedLock("BatchingIngest.rows")

    def __call__(self, worker: int, features, label: int) -> None:
        with self._lock:
            rows = self._rows.setdefault(worker, [])
            if not rows:
                self._oldest[worker] = time.monotonic()
            rows.append((features, label))
            if len(rows) < self._batch:
                return
            del self._rows[worker]
            self._oldest.pop(worker, None)
        self._deliver(worker, rows)

    def flush_aged(self) -> None:
        """Flush every batch whose FIRST row has waited >= max_age."""
        now = time.monotonic()
        due = []
        with self._lock:
            for w, t0 in list(self._oldest.items()):
                if now - t0 >= self._max_age:
                    due.append((w, self._rows.pop(w)))
                    del self._oldest[w]
        for w, rows in due:
            self._deliver(w, rows)

    def flush_all(self) -> None:
        with self._lock:
            pending = [(w, self._rows.pop(w)) for w in list(self._rows)]
            self._oldest.clear()
        for w, rows in pending:
            self._deliver(w, rows)

    def _deliver(self, worker: int, rows) -> None:
        if self._deliverable(worker) and self._bridge.send_data_batch(
                worker, rows):
            return
        for features, label in rows:
            self._fallback(worker, features, label)


def run_server(args) -> int:
    """Server role: ServerNode + producer, all workers remote.

    Failure handling mirrors the in-process supervisor across the wire:
      * failure_policy=halt (default): a worker-connection loss stops
        the run with an error instead of deadlocking the gate;
      * failure_policy=rebalance: the dead connection's workers are
        evicted (gates stop waiting, their stream rows reroute to the
        survivors) and a reconnecting worker process is readmitted at
        the slowest active clock once its buffer holds data (READY).
    A reader's exception that is not a connection error ends the run
    with that error (runtime/net.py), evicting nobody."""
    from kafka_ps_tpu_torch.cli.run import load_test_csv
    from kafka_ps_tpu_torch.data.stream import CsvStreamProducer
    from kafka_ps_tpu_torch.runtime.server import ServerNode
    from kafka_ps_tpu_torch.utils import checkpoint as ckpt
    from kafka_ps_tpu_torch.utils.asynclog import DeferredSink
    from kafka_ps_tpu_torch.utils.config import resolve_device
    from kafka_ps_tpu_torch.utils.csvlog import (EVENTS_HEADER, SERVER_HEADER,
                                                 CsvLogSink, NullLogSink)

    cfg = _make_cfg(args)
    codec_spec = _codec_spec(args)
    device = resolve_device()       # CUDA, or KPS_PLATFORM's choice
    failure_policy = getattr(args, "failure_policy", "halt")
    hb_timeout = getattr(args, "heartbeat_timeout", None)
    test_x, test_y = load_test_csv(args.test_data_file_path,
                                   args.num_features)
    # a resumed run CONTINUES the prior run's logs
    checkpoint_path = getattr(args, "checkpoint", None)
    resuming = bool(checkpoint_path) and os.path.exists(checkpoint_path)
    log = CsvLogSink("./logs-server.csv" if args.logging else None,
                     SERVER_HEADER, append=resuming)
    # events persist incrementally — an end-of-run dump would lose the
    # auditor's eviction/readmission record on a crash
    events_log = (CsvLogSink("./logs-events.csv", EVENTS_HEADER,
                             append=resuming)
                  if args.logging else NullLogSink())
    # the logical-run id the bridge advertises (T_CONFIG): a resume
    # continues the checkpointed run, a fresh start mints a new one —
    # worker processes match their local state files against it
    run_id = ckpt.peek_run_id(checkpoint_path) if resuming else None
    if run_id is None:
        run_id = time.time_ns()
    tracer, telemetry = _make_telemetry(args)
    # the ops plane (its flight recorder armed) before the port listens: a
    # worker's HELLO can arrive at once.  The model-health plane: the
    # apply path feeds it, and the producer's row sink its feature sketch
    # below (the buffers live in the worker processes, but every stream
    # row passes through here)
    modelhealth, drift_sink = run_mod.make_model_health(
        args, telemetry, cfg, log_name="./logs-drift.csv")
    ops = _make_ops(args, telemetry, role="server", modelhealth=modelhealth)
    # the serving plane on the workers' port: the engine is there before
    # the port listens (a read before the first snapshot is STALE), and a
    # prediction client sends no HELLO, so the bridge routes it nothing
    # but its own replies
    engine = registry = None
    if cfg.serving.enabled:
        from kafka_ps_tpu_torch.models.task import get_task
        from kafka_ps_tpu_torch.serving.engine import make_engine
        from kafka_ps_tpu_torch.serving.snapshot import SnapshotRegistry
        registry = SnapshotRegistry(capacity=cfg.serving.ring_capacity)
        engine = make_engine(get_task(cfg.task, cfg.model), registry,
                             cfg.serving, tracer=tracer, telemetry=telemetry)
    bridge = net.ServerBridge(
        port=args.listen,
        heartbeat_interval=min(1.0, hb_timeout / 3) if hb_timeout else 1.0,
        heartbeat_timeout=hb_timeout, run_id=run_id, codec=codec_spec,
        coalesce=getattr(args, "wire_coalesce", True), device=device,
        shm=cfg.serving.shm, engine=engine, tracer=tracer,
        telemetry=telemetry)
    print(f"listening on port {bridge.port}", file=sys.stderr, flush=True)
    fabric = bridge.wrap(fabric_mod.Fabric())
    server = ServerNode(cfg, fabric, device, test_x, test_y,
                        DeferredSink(log), tracer=tracer, telemetry=telemetry)
    if codec_spec.codec_id != net.CODEC_NONE:
        # weights leave this process quantize-dequantized so both sides
        # train against the SAME decoded theta; a peer that negotiated
        # NONE gets plain frames (ServerBridge._send)
        from kafka_ps_tpu_torch import compress
        server.compressor = compress.WeightsCompressor(compress.get_codec(
            codec_spec, server.task.num_params))
        print(f"compression: {codec_spec.spec_str()}", file=sys.stderr,
              flush=True)
    server.run_id = run_id
    server.membership_log = events_log   # before restore: it logs "resume"
    # releases to workers behind a relay go as one T_WEIGHTS_AGG frame
    # per relay (no effect while none is connected)
    server.weights_group_send = bridge.send_weights_group
    if getattr(args, "bsp_order", False):
        # each BSP round applied in worker-id order, so an aggregated run
        # is bitwise comparable with a direct one
        server.bsp_order = True
        print("bsp-order: buffering rounds for worker-id-ordered applies",
              file=sys.stderr, flush=True)
    eval_engine = None
    if cfg.eval_async:
        from kafka_ps_tpu_torch.evaluation.engine import EvalEngine
        eval_engine = server.attach_eval_engine(EvalEngine(
            server.task, server.test_x, server.test_y, server._emit_eval,
            telemetry=telemetry, tracer=tracer))
    from kafka_ps_tpu_torch.log.durable_fabric import COLD_PARTITION_DIR
    from kafka_ps_tpu_torch.runtime.messages import KeyRange
    tier_store = _attach_tier_store(
        server, cfg, KeyRange(0, server.task.num_params),
        cold_dir=(os.path.join(args.durable_log, COLD_PARTITION_DIR)
                  if getattr(args, "durable_log", None) else None))
    if checkpoint_path:
        ckpt.maybe_restore(checkpoint_path, server)
        server.checkpoint_path = checkpoint_path
        server.checkpoint_every = getattr(args, "checkpoint_every", 50)
        if resuming:
            print(f"restored checkpoint at iteration {server.iterations}",
                  file=sys.stderr, flush=True)

    if engine is not None:
        server.serving = registry
        server.publish_snapshot()    # cold start: restored or fresh theta
        # every bucket shape dispatched and the cost model calibrated
        # now, not in some client's p99
        engine.warmup()
        print(f"serving predictions on port {bridge.port}",
              file=sys.stderr, flush=True)

    if modelhealth is not None:
        server.attach_model_health(modelhealth)
    ops.add_gate_watchdog(server)
    if eval_engine is not None:
        ops.add_eval_engine(eval_engine)    # /evalz
    if engine is not None:
        ops.add_serving_watchdog(engine)
    ops.start()

    # membership events cross threads (bridge readers -> main loop):
    # ServerNode is single-threaded by design, so evictions/readmissions
    # are applied only between gradient polls
    events: queue.Queue = queue.Queue()
    bridge.on_disconnect = lambda ids: events.put(("disconnect", ids))
    bridge.on_ready = lambda w: events.put(("ready", w))

    workers = server.tracker.active_workers   # a checkpoint may carry evictions
    bridge.wait_for_connected(workers, timeout=args.connect_timeout)

    reroute = {"rr": 0, "rerouted": 0, "dropped": 0}

    def sink(worker: int, features: dict[int, float], label: int) -> None:
        # Rows flow to whoever holds the worker's connection — including
        # (under rebalance) a reconnected-but-not-yet-readmitted process,
        # whose buffer must fill before READY triggers readmission.
        # Under halt an inactive worker can never be readmitted, so a
        # reconnected-evicted target (checkpoint carrying evictions)
        # would swallow its partition's rows forever — reroute instead.
        # A dead target reroutes round-robin to the survivors; with
        # nobody left the row is counted, not silently discarded.
        deliverable = (failure_policy == "rebalance"
                       or server.tracker.tracker[worker].active)
        if deliverable and bridge.send_data(worker, features, label):
            return
        active = server.tracker.active_workers
        for _ in range(len(active)):
            alt = active[reroute["rr"] % len(active)]
            reroute["rr"] += 1
            if alt != worker and bridge.send_data(alt, features, label):
                reroute["rerouted"] += 1
                return
        reroute["dropped"] += 1

    batch_sink = _BatchingSink(
        bridge, sink,
        deliverable=lambda w: (failure_policy == "rebalance"
                               or server.tracker.tracker[w].active))
    row_sink = batch_sink
    if modelhealth is not None:
        def row_sink(worker: int, features, label: int) -> None:
            # the sampled feature sketch on the producer thread, before
            # the row fans out to whichever worker holds the connection
            modelhealth.drift.observe_row(features)
            batch_sink(worker, features, label)
    producer = CsvStreamProducer(
        args.training_data_file_path, cfg.num_workers, row_sink,
        time_per_event_ms=cfg.stream.time_per_event_ms,
        prefill_per_worker=cfg.stream.prefill_per_worker,
        num_features=cfg.model.num_features)
    producer.run_in_background()
    bridge.wait_for_workers(workers, timeout=args.connect_timeout)

    # one entry per worker that has announced READY this server
    # lifetime: a SECOND ready from a still-ACTIVE worker is a restarted
    # process whose in-flight weights assignment died with it
    seen_ready: set = set()
    readmissions: list[tuple[int, int]] = []

    def apply_events() -> None:
        while True:
            try:
                kind, val = events.get_nowait()
            except queue.Empty:
                return
            if kind == "disconnect":
                live = [w for w in val
                        if server.tracker.tracker[w].active]
                if not live:
                    continue
                if failure_policy == "halt":
                    raise RuntimeError(
                        f"worker connection lost for {sorted(live)} "
                        "(failure_policy=halt; use "
                        "--failure_policy rebalance to continue on "
                        "the survivors)")
                for w in live:
                    try:
                        server.remove_worker(w)
                    except ValueError:
                        raise RuntimeError(
                            "all worker connections lost") from None
                    print(f"evicted worker {w} (connection lost)",
                          file=sys.stderr, flush=True)
            elif kind == "ready":
                w = int(val)
                status = server.tracker.tracker[w]
                if (failure_policy == "rebalance"
                        and not status.active):
                    clock = server.readmit_worker(w)
                    seen_ready.add(w)
                    readmissions.append((w, clock))
                    print(f"readmitted worker {w} at clock {clock}",
                          file=sys.stderr, flush=True)
                elif (w in seen_ready and status.active
                        and status.weights_message_sent):
                    # liveness reissue: the worker process restarted
                    # (durable state restored, so it READYs again at
                    # once) while its round assignment was lost mid-
                    # flight — re-send the current weights so the
                    # stalled gate completes.  Idempotent for theta: a
                    # recompute yields a duplicate gradient the clock
                    # filter drops.
                    server.send_weights(w, status.vector_clock)
                    print(f"reissued weights to restarted worker {w} "
                          f"at clock {status.vector_clock}",
                          file=sys.stderr, flush=True)
                else:
                    seen_ready.add(w)

    # the live pulse (utils/status.py), the split face of --status_every
    from kafka_ps_tpu_torch.utils.status import StatusReporter

    rolling_critpath = None
    if telemetry.enabled:
        from kafka_ps_tpu_torch.telemetry.critpath import RollingCritpath
        rolling_critpath = RollingCritpath(telemetry)

    def status() -> dict:
        tr = server.tracker
        active = tr.active_workers
        out = {
            "iters": server.iterations,
            "clocks": [f"{w}:{tr.tracker[w].vector_clock}"
                       for w in range(cfg.num_workers)],
            "active": f"{len(active)}/{cfg.num_workers}",
            "pending": {"gradients": fabric.total_pending(
                fabric_mod.GRADIENTS_TOPIC)},
            "rows_sent": producer.rows_sent,
        }
        if engine is not None:
            s = engine.stats()
            out["predictions_per_s"] = s["requests"]
            out["serving"] = {"occ": s["occupancy"],
                              "p50_ms": s["p50_ms"], "p99_ms": s["p99_ms"],
                              "stale": s["rejections"]}
        if telemetry.enabled:
            out["metrics"] = telemetry.summary()
        if rolling_critpath is not None:
            # the segment dominating this window, from the histograms'
            # deltas since the last line (telemetry/critpath.py)
            out["critpath"] = rolling_critpath.sample()
        if modelhealth is not None:
            # update norms, direction cosine, drift verdict
            out["modelhealth"] = modelhealth.summary()
        return out

    reporter = StatusReporter(getattr(args, "status_every", 0.0) or 0.0,
                              status).start()

    server.start_training_loop()
    max_iters = args.max_iterations or sys.maxsize
    try:
        while server.iterations < max_iters:
            bridge.raise_reader_error()
            apply_events()
            batch_sink.flush_aged()   # age-bound the batched ingest path
            g = fabric.poll_blocking(fabric_mod.GRADIENTS_TOPIC, 0,
                                     timeout=0.2)
            if g is not None:
                server.process(g)
    except KeyboardInterrupt:
        # Ctrl-C is an orderly shutdown — the finally block still
        # checkpoints and flushes logs/events
        print("interrupted — shutting down", file=sys.stderr, flush=True)
    finally:
        reporter.stop()
        producer.stop()      # join the pump before teardown
        batch_sink.flush_all()   # after the pump join: no concurrent adds
        bridge.close()       # workers see EOF and shut down; joins the
                             # accept/heartbeat/reader threads
        if engine is not None:
            engine.close()   # after the bridge: no reader submits now
        try:
            if eval_engine is not None:
                eval_engine.close()   # drains pending evals into server.log
            if checkpoint_path:
                if tier_store is not None:
                    tier_store.rebalance()   # no apply races it now
                server.save_checkpoint_now()
        finally:
            if tier_store is not None:
                tier_store.close()   # after the save: it may read cold pages
            if reroute["dropped"] or bridge.dropped_sends:
                print(f"dropped rows: {reroute['dropped']}, dropped sends: "
                      f"{bridge.dropped_sends}", file=sys.stderr, flush=True)
            server.log.close()           # joins drain thread + closes sink
            events_log.close()
            end_ms = int(time.time() * 1000)     # the logs are flushed
            ops.close()                  # the final flight dump
            if drift_sink is not None:
                # after ops.close(): the plane's final drain may still
                # emit a verdict row
                drift_sink.close()
            _dump_telemetry(args, tracer, telemetry)
            _print_stats("server", {
                "role": "server", "device": str(device),
                "server_iterations": server.iterations,
                # read but never applied (in the fabric at the stop)
                "gradients_pending": fabric.total_pending(
                    fabric_mod.GRADIENTS_TOPIC),
                "end_ms": end_ms,
                "codec": codec_spec.spec_str(),
                "membership": {
                    "active": server.tracker.active_workers,
                    "evictions": [w for _, kind, w in
                                  server.membership_events
                                  if kind == "evict"],
                    "readmissions": readmissions,
                    "zombie_gradients_dropped":
                        server.zombie_gradients_dropped,
                    "duplicate_gradients_dropped":
                        server.duplicate_gradients_dropped},
                "rows": {"sent": producer.rows_sent,
                         "rerouted": reroute["rerouted"],
                         "dropped": reroute["dropped"]},
                "eval": (None if eval_engine is None
                         else eval_engine.stats()),
                "serving": (None if engine is None
                            else run_mod.serving_stats(engine, server)),
                "tier": (None if tier_store is None
                         else tier_store.stats()),
                **bridge.stats()})
    return 0


def run_worker(args) -> int:
    """Worker role: the logical workers in --worker_ids, server remote.

    The kernels of the configured family and slab form are built and
    loaded before the connection, so a first build (nvcc) is never
    taken for a hung worker by the server's heartbeat.  A reader
    exception that is not a connection error, or a worker loop's
    exception (a CUDA error), makes the process exit 1.

    A comma-separated `--connect` is the range-sharded worker, one
    address per shard in shard-id order; `--aggregate HOST:PORT` dials a
    relay through the same path (_run_worker_sharded)."""
    if getattr(args, "aggregate", None):
        return _run_worker_sharded(args, [args.aggregate], aggregate=True)
    if "," in args.connect:
        return _run_worker_sharded(
            args, [a for a in args.connect.split(",") if a])
    from kafka_ps_tpu_torch.cli.run import load_test_csv
    from kafka_ps_tpu_torch.data.buffer import SlidingBuffer
    from kafka_ps_tpu_torch.ops import fused_update
    from kafka_ps_tpu_torch.runtime.worker import WorkerNode
    from kafka_ps_tpu_torch.utils import checkpoint as ckpt
    from kafka_ps_tpu_torch.utils.asynclog import DeferredSink
    from kafka_ps_tpu_torch.utils.config import resolve_device
    from kafka_ps_tpu_torch.utils.csvlog import WORKER_HEADER, CsvLogSink

    host, _, port = args.connect.rpartition(":")
    ids = [int(w) for w in args.worker_ids.split(",")]
    cfg = _make_cfg(args)
    codec_spec = _codec_spec(args)
    state_every = getattr(args, "state_every", 1.0)
    if getattr(args, "checkpoint", None) and (state_every is None
                                              or state_every <= 0):
        raise SystemExit("--state_every must be > 0 (seconds between "
                         "durable buffer snapshots)")
    device = resolve_device()
    import torch
    test_x, test_y = load_test_csv(args.test_data_file_path,
                                   args.num_features)
    # one device copy of the test set for every logical worker here
    test_x = torch.as_tensor(test_x, dtype=torch.float32, device=device)
    test_y = torch.as_tensor(test_y, dtype=torch.int32, device=device)
    if device.type == "cuda":
        fused_update.load(cfg.task, cfg.slab_dtype)

    # connect FIRST: the handshake (net.T_CONFIG) carries the server's
    # logical-run id, which decides whether local state is valid below,
    # and the NEGOTIATED codec — compression runs at what the server
    # agreed to, not at what this process asked for
    tracer, telemetry = _make_telemetry(args)
    bridge = net.WorkerBridge(
        host or "127.0.0.1", int(port), ids,
        heartbeat_timeout=getattr(args, "heartbeat_timeout", None),
        codec=codec_spec, coalesce=getattr(args, "wire_coalesce", True),
        device=device, tracer=tracer, telemetry=telemetry)
    fabric = bridge.make_fabric()
    # this process's model-health plane over its own training stream:
    # the rows' eval fields and the sampled buffer arrivals
    modelhealth, drift_sink = run_mod.make_model_health(
        args, telemetry, cfg, log_name="./logs-drift-worker.csv")
    # the death hooks armed before training: a SIGTERM'd worker leaves
    # its flight dump even mid-iteration
    ops = _make_ops(args, telemetry, role="worker", modelhealth=modelhealth)
    ops.start()

    compressors = None
    if bridge.negotiated.codec_id != net.CODEC_NONE:
        from kafka_ps_tpu_torch import compress
        from kafka_ps_tpu_torch.models.task import get_task
        codec = compress.get_codec(
            bridge.negotiated, get_task(cfg.task, cfg.model).num_params)
        compressors = {w: compress.ErrorFeedback(codec, device) for w in ids}
        print(f"compression: {bridge.negotiated.spec_str()} (negotiated)",
              file=sys.stderr, flush=True)

    # worker-local durable state: a worker process restarted WITHIN a
    # run recovers its training window instead of cold-starting an empty
    # buffer.  State written under a different run (the server started
    # fresh since) is stale and removed.
    state_path = None
    restoring = False
    if getattr(args, "checkpoint", None):
        state_path = ckpt.worker_state_path(args.checkpoint, ids)
        stored = ckpt.peek_run_id(state_path)
        restoring = stored is not None and stored == bridge.server_run_id
        if not restoring and os.path.exists(state_path):
            print(f"discarding stale worker state {state_path} "
                  f"(run {stored} != server run {bridge.server_run_id})",
                  file=sys.stderr, flush=True)
            os.remove(state_path)
    # Log continuity is decided by RUN continuity, not by whether buffer
    # state restored: a worker killed before its first state snapshot
    # has no state file, but its pre-crash rows still belong to this run
    log = _open_worker_log(args, bridge.server_run_id, restoring,
                           CsvLogSink, WORKER_HEADER)

    buffers = {w: SlidingBuffer(cfg.model.num_features, cfg.buffer,
                                telemetry=telemetry, worker=w)
               for w in ids}
    restored = False
    if restoring and ckpt.maybe_restore_worker(
            state_path, buffers, run_id=bridge.server_run_id,
            residuals=compressors):
        restored = True
        print("restored worker buffers: " + ", ".join(
            f"{w}:{buffers[w].count} rows (seen "
            f"{buffers[w].num_tuples_seen})" for w in ids),
            file=sys.stderr, flush=True)
    worker_log = DeferredSink(log)
    nodes = {w: WorkerNode(w, cfg, fabric, buffers[w], device, test_x,
                           test_y, worker_log, tracer=tracer,
                           telemetry=telemetry)
             for w in ids}
    if compressors is not None:
        for w in ids:
            nodes[w].compressor = compressors[w]
    if modelhealth is not None:
        # the process's logical workers share its one plane; the reader
        # thread's buffer inserts feed the feature sketch
        for w in ids:
            nodes[w].modelhealth = modelhealth
            buffers[w].attach_drift(modelhealth.drift)

    saver = (None if state_path is None else _StateSaver(
        state_path, buffers, nodes, bridge.server_run_id, compressors,
        state_every))

    reader_thread = threading.Thread(target=bridge.run_reader,
                                     args=(buffers,), daemon=True,
                                     name="kps-worker-reader")
    reader_thread.start()

    # READY per worker once its buffer has `--ready-rows` rows (the
    # server gates the training-loop bootstrap on it)
    ready_stop = threading.Event()
    ready_rows = max(1, int(getattr(args, "ready_rows", 1) or 1))

    def announce_ready():
        pending = set(ids)
        try:
            while (pending and not bridge.disconnected.is_set()
                   and not ready_stop.is_set()):
                for w in list(pending):
                    if buffers[w].count >= ready_rows:
                        bridge.mark_ready(w)
                        pending.discard(w)
                time.sleep(0.01)
        except (ConnectionError, OSError):
            pass                      # server hung up: the reader ends

    ready_thread = threading.Thread(target=announce_ready, daemon=True,
                                    name="kps-worker-ready")
    ready_thread.start()

    stop = threading.Event()
    errors: list[Exception] = []

    def worker_loop(node: WorkerNode):
        try:
            if device.type == "cuda":
                # a thread's first cuBLAS call needs a current device
                torch.cuda.set_device(test_x.device)
            while not stop.is_set():
                msg = fabric.poll_blocking(fabric_mod.WEIGHTS_TOPIC,
                                           node.worker_id, timeout=0.1)
                if msg is not None:
                    node.on_weights(msg)
        except (ConnectionError, OSError):
            pass                      # server hung up mid-send
        except Exception as e:
            errors.append(e)
            stop.set()
            bridge.close()            # the reader ends: shut down

    threads = [threading.Thread(target=worker_loop, args=(nodes[w],),
                                daemon=True, name=f"worker-{w}")
               for w in ids]
    for t in threads:
        t.start()
    bridge.disconnected.wait()        # run until the server closes
    stop.set()
    ready_stop.set()
    # every thread that can touch the device or numpy native code is
    # joined before the interpreter finalizes; a worker loop is bounded
    # (poll timeout 0.1 s + one local update)
    leftover = []
    for t in threads:
        t.join(timeout=120.0)
        if t.is_alive():
            leftover.append(t.name)
    if bridge.reader_error is not None:
        errors.insert(0, bridge.reader_error)
    if saver is not None:
        saver.close(leftover)
    try:
        worker_log.close()    # joins the drain thread, flushes, closes log
    except Exception as e:   # a device error surfacing in the rows
        errors.append(e)
    bridge.close()
    reader_thread.join(timeout=10.0)  # EOF/closed socket ends it
    ready_thread.join(timeout=10.0)
    for t in (reader_thread, ready_thread):
        if t.is_alive():
            leftover.append(t.name)
    # before any os._exit below: a wedged thread must not cost the
    # process its flight dump, trace and metrics file
    ops.close()
    if drift_sink is not None:
        drift_sink.close()
    _dump_telemetry(args, tracer, telemetry)
    _print_stats("worker", {
        "role": "worker", "device": str(device), "worker_ids": ids,
        "rows": {str(w): nodes[w].iterations for w in ids},
        "rows_received": {str(w): buffers[w].num_tuples_seen for w in ids},
        "restored": restored, "codec": bridge.negotiated.spec_str(),
        "kernels": fused_update.counts(), **bridge.stats()})
    rc = 0
    if errors:
        print(f"worker failed: {errors[0]!r}", file=sys.stderr, flush=True)
        rc = 1
    if leftover:
        # a thread survived its join and may be inside native code:
        # skip interpreter finalization rather than risk the teardown
        # abort (this is a CLI process, nothing else to run)
        print(f"warning: threads still alive at exit: {leftover}; "
              "exiting without finalization", file=sys.stderr, flush=True)
        sys.stdout.flush()
        os._exit(rc)
    if errors:
        raise RuntimeError("worker failed") from errors[0]
    return 0


# -- range-sharded servers and aggregation relays --------------------------


def run_server_shard(args) -> int:
    """One shard server of a `--shards N` deployment: owns
    `ShardPlan.ranges[shard_id]` of theta with its own vector clocks and
    gate, its own checkpoint (utils/checkpoint.shard_state_path) and,
    with `--durable-log DIR`, its own commit log under
    `DIR/shard<I>of<N>`, so a killed shard recovers from checkpoint plus
    log replay while the others keep serving.  Shard 0 hosts the stream
    producer; no shard evaluates (each holds a slice).  The shards'
    weights slices are uncompressed; a worker's `--compress topk:R` is
    what shrinks the gradient slices."""
    from kafka_ps_tpu_torch.data.stream import CsvStreamProducer
    from kafka_ps_tpu_torch.models.task import get_task
    from kafka_ps_tpu_torch.runtime.server import ServerNode
    from kafka_ps_tpu_torch.runtime.sharding import ShardPlan
    from kafka_ps_tpu_torch.utils import checkpoint as ckpt
    from kafka_ps_tpu_torch.utils.config import resolve_device

    if getattr(args, "serve", False):
        raise SystemExit(
            "--serve is unsharded-only in split mode: a shard process "
            "holds one slice of theta; serve a --shards N deployment "
            "through a read replica (--serve-replica --durable-log DIR), "
            "which assembles the slices at the frontier clock")
    cfg = _make_cfg(args)
    num_shards, shard_id = args.shards, args.shard_id
    plan = ShardPlan(get_task(cfg.task, cfg.model).num_params, num_shards)
    key_range = plan.ranges[shard_id]
    device = resolve_device()
    failure_policy = getattr(args, "failure_policy", "halt")
    hb_timeout = getattr(args, "heartbeat_timeout", None)
    checkpoint_path = None
    if getattr(args, "checkpoint", None):
        checkpoint_path = ckpt.shard_state_path(args.checkpoint, shard_id,
                                                num_shards)
    resuming = bool(checkpoint_path) and os.path.exists(checkpoint_path)
    run_id = ckpt.peek_run_id(checkpoint_path) if resuming else None
    if run_id is None:
        run_id = time.time_ns()
    tracer, telemetry = _make_telemetry(args)
    inner = fabric_mod.Fabric()
    if getattr(args, "durable_log", None):
        # one log per shard, under a shard-suffixed root: N shard
        # processes never share a segment file
        from kafka_ps_tpu_torch.log import DurableFabric, LogConfig
        inner = DurableFabric(
            os.path.join(args.durable_log, f"shard{shard_id}of{num_shards}"),
            LogConfig(fsync=getattr(args, "fsync", "interval")),
            device=device, tracer=tracer, telemetry=telemetry)
    # the shard's model-health plane: its families carry shard=<I>, so a
    # fleet's dashboards tell which slice went sour.  The ops plane (its
    # flight recorder armed) before the port listens: a worker's HELLO
    # can arrive at once; its dump carries the shard's identity and the
    # roster, so the postmortem can tell which shard of the fleet wedged
    # or died
    modelhealth, drift_sink = run_mod.make_model_health(
        args, telemetry, cfg, shard=shard_id,
        log_name=f"./logs-drift-shard{shard_id}.csv")
    ops = _make_ops(args, telemetry, role="server", shard=shard_id,
                    meta={"shards": list(range(num_shards))},
                    modelhealth=modelhealth)
    bridge = net.ServerBridge(
        port=args.listen,
        heartbeat_interval=min(1.0, hb_timeout / 3) if hb_timeout else 1.0,
        heartbeat_timeout=hb_timeout, run_id=run_id,
        coalesce=getattr(args, "wire_coalesce", True), device=device,
        tracer=tracer, telemetry=telemetry)
    print(f"shard {shard_id}/{num_shards} range [{key_range.start}, "
          f"{key_range.end}) listening on port {bridge.port}",
          file=sys.stderr, flush=True)
    fabric = bridge.wrap(inner)     # keeps DurableFabric's class
    server = ServerNode(cfg, fabric, device, key_range=key_range,
                        shard_id=shard_id, num_shards=num_shards,
                        tracer=tracer, telemetry=telemetry)
    server.run_id = run_id
    server.weights_group_send = bridge.send_weights_group
    if getattr(args, "bsp_order", False):
        server.bsp_order = True
    # a shard's cold pages live under its own shard-suffixed log root
    tier_store = _attach_tier_store(
        server, cfg, key_range,
        cold_dir=inner.cold_dir() if inner.durable else None)
    if checkpoint_path:
        ckpt.maybe_restore(checkpoint_path, server)
        server.checkpoint_path = checkpoint_path
        server.checkpoint_every = getattr(args, "checkpoint_every", 50)
        if resuming:
            print(f"shard {shard_id}: restored checkpoint at iteration "
                  f"{server.iterations}", file=sys.stderr, flush=True)
    replay = None
    if inner.durable:
        # re-enqueue the gradient slices past the checkpoint's offsets;
        # the tracker drops what the checkpoint covers
        t0 = time.perf_counter()
        replay = inner.recover(server.restored_log_offsets)
        # the weights the workers were sent are logged for read replicas,
        # not for replay: start_training_loop re-sends each its current
        # weights over its new connection
        for w in range(cfg.num_workers):
            inner.purge(fabric_mod.WEIGHTS_TOPIC, w, lambda m: True)
        replay[fabric_mod.WEIGHTS_TOPIC] = 0
        replay_s = time.perf_counter() - t0
        if any(replay.values()):
            print(f"shard {shard_id}: durable-log replay {replay} in "
                  f"{replay_s:.3f} s", file=sys.stderr, flush=True)

    if modelhealth is not None:
        server.attach_model_health(modelhealth)
    ops.add_gate_watchdog(server)
    if inner.durable:
        ops.add_fsync_watchdog()
    ops.start()

    events: queue.Queue = queue.Queue()
    bridge.on_disconnect = lambda ids: events.put(("disconnect", ids))
    bridge.on_ready = lambda w: events.put(("ready", w))
    workers = server.tracker.active_workers
    bridge.wait_for_connected(workers, timeout=args.connect_timeout)

    producer = batch_sink = None
    reroute = {"rr": 0, "rerouted": 0, "dropped": 0}
    if shard_id == 0:
        # the data plane is on shard 0 only: run_server's sink and
        # reroute policy
        def sink(worker: int, features: dict[int, float],
                 label: int) -> None:
            deliverable = (failure_policy == "rebalance"
                           or server.tracker.tracker[worker].active)
            if deliverable and bridge.send_data(worker, features, label):
                return
            active = server.tracker.active_workers
            for _ in range(len(active)):
                alt = active[reroute["rr"] % len(active)]
                reroute["rr"] += 1
                if alt != worker and bridge.send_data(alt, features, label):
                    reroute["rerouted"] += 1
                    return
            reroute["dropped"] += 1

        batch_sink = _BatchingSink(
            bridge, sink,
            deliverable=lambda w: (failure_policy == "rebalance"
                                   or server.tracker.tracker[w].active))
        producer = CsvStreamProducer(
            args.training_data_file_path, cfg.num_workers, batch_sink,
            time_per_event_ms=cfg.stream.time_per_event_ms,
            prefill_per_worker=cfg.stream.prefill_per_worker,
            num_features=cfg.model.num_features)
        producer.run_in_background()
    bridge.wait_for_workers(workers, timeout=args.connect_timeout)

    def apply_events() -> None:
        while True:
            try:
                kind, val = events.get_nowait()
            except queue.Empty:
                return
            if kind == "disconnect":
                live = [w for w in val if server.tracker.tracker[w].active]
                if not live:
                    continue
                if failure_policy == "halt":
                    raise RuntimeError(
                        f"shard {shard_id}: worker connection lost for "
                        f"{sorted(live)} (failure_policy=halt)")
                for w in live:
                    try:
                        server.remove_worker(w)
                    except ValueError:
                        raise RuntimeError(
                            "all worker connections lost") from None
            elif kind == "ready" and failure_policy == "rebalance":
                w = int(val)
                if not server.tracker.tracker[w].active:
                    server.readmit_worker(w)

    server.start_training_loop()
    max_iters = args.max_iterations or sys.maxsize
    t_first = None
    try:
        while server.iterations < max_iters:
            bridge.raise_reader_error()
            apply_events()
            if batch_sink is not None:
                batch_sink.flush_aged()
            g = fabric.poll_blocking(fabric_mod.GRADIENTS_TOPIC, 0,
                                     timeout=0.2)
            if g is not None:
                if t_first is None:
                    t_first = time.time()
                server.process(g)
    except KeyboardInterrupt:
        print(f"shard {shard_id}: interrupted — shutting down",
              file=sys.stderr, flush=True)
    finally:
        if producer is not None:
            producer.stop()
        if batch_sink is not None:
            batch_sink.flush_all()
        bridge.close()
        try:
            if checkpoint_path:
                if tier_store is not None:
                    tier_store.rebalance()   # no apply races it now
                # a commit point: the checkpoint and the committed log
                # offsets describe one instant
                server.save_checkpoint_now()
        finally:
            if tier_store is not None:
                tier_store.close()   # after the save: it may read cold pages
            if inner.durable:
                inner.close()
            end_ms = int(time.time() * 1000)
            ops.close()
            if drift_sink is not None:
                drift_sink.close()
            _dump_telemetry(args, tracer, telemetry)
            _print_stats("server", {
                "role": "server", "device": str(device),
                "shard_id": shard_id, "num_shards": num_shards,
                "key_range": [key_range.start, key_range.end],
                "server_iterations": server.iterations,
                "final_clocks": server.tracker.clocks,
                "first_gradient_ms": (None if t_first is None
                                      else int(t_first * 1000)),
                "end_ms": end_ms,
                "restored": resuming, "replay": replay,
                "sparse_applies": server.sparse_applies,
                "empty_slices": server.empty_slices,
                "composites": server.composites_received,
                "membership": {
                    "active": server.tracker.active_workers,
                    "evictions": [w for _, kind, w in
                                  server.membership_events
                                  if kind == "evict"],
                    "zombie_gradients_dropped":
                        server.zombie_gradients_dropped,
                    "duplicate_gradients_dropped":
                        server.duplicate_gradients_dropped},
                "rows": {"sent": (producer.rows_sent if producer
                                  else 0), **reroute},
                "durable": inner.stats() if inner.durable else None,
                "tier": (None if tier_store is None
                         else tier_store.stats()),
                **bridge.stats()})
    return 0


def run_aggregator(args) -> int:
    """The aggregator relay role (agg/relay.py), one per host:

        python -m kafka_ps_tpu_torch.cli.agg_runner --connect hostA:8477 \\
            --listen 8478 --agg-id 0 --worker_ids 0,1,2,3
        python -m kafka_ps_tpu_torch.cli.worker_runner --aggregate \\
            hostB:8478 --worker_ids 0,1 -test test.csv

    The server sees one connection, one composite gradient frame per
    flush and one grouped weights frame per release set.  With
    `--compress` the relay owns the error-feedback residuals, saved to
    `--checkpoint` after each upstream send.  Runs on the card unless
    KPS_PLATFORM=cpu; prints `kafka_ps_tpu_torch aggregator: {json}` at
    exit (relay.stats())."""
    from kafka_ps_tpu_torch.agg.relay import AggregatorRelay
    from kafka_ps_tpu_torch.models.task import get_task
    from kafka_ps_tpu_torch.utils.config import resolve_device

    host, _, port = args.connect.rpartition(":")
    ids = [int(w) for w in args.worker_ids.split(",")]
    cfg = _make_cfg(args)
    device = resolve_device()
    tracer, telemetry = _make_telemetry(args)
    ops = _make_ops(args, telemetry, role="aggregator")
    ops.start()
    spec = _codec_spec(args)
    relay = AggregatorRelay(
        int(args.agg_id), host or "127.0.0.1", int(port), ids,
        get_task(cfg.task, cfg.model).num_params,
        listen_port=int(args.listen or 0),
        codec_spec=spec if spec.codec_id != net.CODEC_NONE else None,
        summed=bool(args.summed),
        checkpoint_path=getattr(args, "checkpoint", None),
        flush_interval=float(args.flush_interval or 0.002),
        heartbeat_interval=1.0,
        heartbeat_timeout=getattr(args, "heartbeat_timeout", None),
        coalesce=getattr(args, "wire_coalesce", True), device=device,
        tracer=tracer, telemetry=telemetry)
    if relay.restored:
        print("restored aggregator error-feedback residuals",
              file=sys.stderr, flush=True)
    print(f"aggregator {relay.agg_id} listening on port {relay.port} "
          f"(members {','.join(map(str, ids))}, upstream {args.connect}, "
          f"codec {relay.upstream.negotiated.spec_str()})",
          file=sys.stderr, flush=True)
    try:
        relay.run()               # until the server closes the run
    except KeyboardInterrupt:
        pass
    finally:
        relay.close()
        ops.close()
        _dump_telemetry(args, tracer, telemetry)
        _print_stats("aggregator", {"role": "aggregator",
                                    "device": str(device),
                                    "codec":
                                        relay.upstream.negotiated.spec_str(),
                                    **relay.stats()})
    return 0


class _AssemblerSink:
    """One bridge's weights sink (WorkerBridge.set_weights_sink): its
    shard's slices into the shared WeightsAssembler, under one lock (the
    bridges' readers offer concurrently)."""

    def __init__(self, shard_id: int, assembler, lock):
        self._shard_id = shard_id
        self._assembler = assembler
        self._lock = lock

    def send(self, topic: str, key: int, message) -> None:
        with self._lock:
            self._assembler.offer(self._shard_id, key, message)


def _run_worker_sharded(args, addrs: list[str],
                        aggregate: bool = False) -> int:
    """The worker role against a `--shards N` fleet: one bridge per shard
    address (shard-id order), a ShardRouter per logical worker and one
    WeightsAssembler.  A dead shard is not fatal while another lives: the
    supervisor reconnects to the restarted shard and its stale weights
    slices make the routers resend from their caches.  The run ends when
    every shard has closed.

    `aggregate=True` points the one address at a relay: compression is
    the relay's (raw float32 goes to it), a reconnect resends the whole
    cache (nothing on a restarted relay asks for it), and a relay that
    drops without a GOODBYE is waited for (AGG_RECONNECT_GRACE)."""
    from kafka_ps_tpu_torch.cli.run import load_test_csv
    from kafka_ps_tpu_torch.data.buffer import SlidingBuffer
    from kafka_ps_tpu_torch.models.task import get_task
    from kafka_ps_tpu_torch.ops import fused_update
    from kafka_ps_tpu_torch.runtime.sharding import (ShardPlan, ShardRouter,
                                                     WeightsAssembler)
    from kafka_ps_tpu_torch.runtime.worker import WorkerNode
    from kafka_ps_tpu_torch.utils import checkpoint as ckpt
    from kafka_ps_tpu_torch.utils.asynclog import DeferredSink
    from kafka_ps_tpu_torch.utils.config import resolve_device
    from kafka_ps_tpu_torch.utils.csvlog import WORKER_HEADER, CsvLogSink

    ids = [int(w) for w in args.worker_ids.split(",")]
    cfg = _make_cfg(args)
    spec = _codec_spec(args)
    state_every = getattr(args, "state_every", 1.0)
    if getattr(args, "checkpoint", None) and (state_every is None
                                              or state_every <= 0):
        raise SystemExit("--state_every must be > 0 (seconds between "
                         "durable buffer snapshots)")
    device = resolve_device()
    import torch
    test_x, test_y = load_test_csv(args.test_data_file_path,
                                   args.num_features)
    test_x = torch.as_tensor(test_x, dtype=torch.float32, device=device)
    test_y = torch.as_tensor(test_y, dtype=torch.int32, device=device)
    if device.type == "cuda":
        fused_update.load(cfg.task, cfg.slab_dtype)
    num_params = get_task(cfg.task, cfg.model).num_params
    plan = ShardPlan(num_params, len(addrs))
    tracer, telemetry = _make_telemetry(args)
    # the process's model-health plane over its training stream, as in
    # run_worker
    modelhealth, drift_sink = run_mod.make_model_health(
        args, telemetry, cfg, log_name="./logs-drift-worker.csv")
    # meta names the whole shard roster: the postmortem's dead shards are
    # the known ones less those that dumped, and a worker's dump is what
    # survives a killed shard
    ops = _make_ops(args, telemetry, role="worker",
                    meta={"shards": list(range(len(addrs)))},
                    modelhealth=modelhealth)
    ops.start()

    def connect(addr: str, timeout: float = 30.0):
        host, _, port = addr.rpartition(":")
        return net.WorkerBridge(
            host or "127.0.0.1", int(port), ids, connect_timeout=timeout,
            heartbeat_timeout=getattr(args, "heartbeat_timeout", None),
            coalesce=getattr(args, "wire_coalesce", True), device=device,
            tracer=tracer, telemetry=telemetry)

    slots: list = [connect(a) for a in addrs]
    retired: list = []                 # bridges replaced by a reconnect
    fabric = fabric_mod.Fabric()       # local: assembled WEIGHTS only
    assemble_lock = OrderedLock("ShardedWorker.assemble")
    routers: dict[int, ShardRouter] = {}

    def resend_cb(shard_id: int, worker: int, clock: int) -> bool:
        router = routers.get(worker)
        return router.resend(shard_id, clock) if router else False

    assembler = WeightsAssembler(
        plan, deliver=lambda w, m: fabric.send(fabric_mod.WEIGHTS_TOPIC, w,
                                               m),
        resend=resend_cb)
    sinks = [_AssemblerSink(i, assembler, assemble_lock)
             for i in range(len(addrs))]
    for i, b in enumerate(slots):
        b.set_weights_sink(sinks[i])

    def safe_send(shard_id: int, message) -> None:
        # a slice to a dead shard is dropped here; the router's cache
        # has it, and the restarted shard's stale slice asks for it
        try:
            slots[shard_id].send_gradients(0, message)
        except (ConnectionError, OSError):
            pass

    for w in ids:
        routers[w] = ShardRouter(plan, send=safe_send)

    compressors = None
    if spec.codec_id != net.CODEC_NONE:
        if aggregate:
            # the relay encodes once, at its upstream edge
            print(f"compression: {spec.spec_str()} (delegated to the "
                  "aggregator)", file=sys.stderr, flush=True)
        else:
            # no negotiation in the sharded fleet: slices cross decoded
            # (dense tid 1, sparse tid 6), --compress is the local
            # sparsifier that makes a delta touch few shards
            from kafka_ps_tpu_torch import compress
            codec = compress.get_codec(spec, num_params)
            compressors = {w: compress.ErrorFeedback(codec, device)
                           for w in ids}
            print(f"compression: {spec.spec_str()} (local sparsifier)",
                  file=sys.stderr, flush=True)

    buffers = {w: SlidingBuffer(cfg.model.num_features, cfg.buffer,
                                telemetry=telemetry, worker=w)
               for w in ids}
    # run continuity keys on slots[0]'s run id: the relay's (it advertises
    # the server's), or shard 0's
    run_id = slots[0].server_run_id
    state_path = None
    restoring = False
    if getattr(args, "checkpoint", None):
        state_path = ckpt.worker_state_path(args.checkpoint, ids)
        stored = ckpt.peek_run_id(state_path)
        restoring = stored is not None and stored == run_id
        if not restoring and os.path.exists(state_path):
            print(f"discarding stale worker state {state_path} (run "
                  f"{stored} != server run {run_id})", file=sys.stderr,
                  flush=True)
            os.remove(state_path)
    restored = False
    if restoring and ckpt.maybe_restore_worker(
            state_path, buffers, run_id=run_id, residuals=compressors):
        restored = True
        print("restored worker buffers: " + ", ".join(
            f"{w}:{buffers[w].count} rows (seen "
            f"{buffers[w].num_tuples_seen})" for w in ids),
            file=sys.stderr, flush=True)
    log = _open_worker_log(args, run_id, restoring, CsvLogSink,
                           WORKER_HEADER)
    worker_log = DeferredSink(log)
    nodes = {w: WorkerNode(w, cfg, fabric, buffers[w], device, test_x,
                           test_y, worker_log, tracer=tracer,
                           telemetry=telemetry)
             for w in ids}
    for w in ids:
        nodes[w].shard_router = routers[w]
        if compressors is not None:
            nodes[w].compressor = compressors[w]
        if modelhealth is not None:
            nodes[w].modelhealth = modelhealth
            buffers[w].attach_drift(modelhealth.drift)

    saver = (None if state_path is None else _StateSaver(
        state_path, buffers, nodes, run_id, compressors, state_every))

    reader_threads: list[threading.Thread] = []

    def start_reader(bridge) -> None:
        t = threading.Thread(target=bridge.run_reader, args=(buffers,),
                             daemon=True, name="kps-worker-reader")
        t.start()
        reader_threads.append(t)

    for b in slots:
        start_reader(b)

    stop = threading.Event()
    errors: list[BaseException] = []
    ready_rows = max(1, int(getattr(args, "ready_rows", 1) or 1))

    def announce_ready() -> None:
        pending = [(i, w) for i in range(len(slots)) for w in ids]
        while pending and not stop.is_set():
            for i, w in list(pending):
                if buffers[w].count >= ready_rows:
                    try:
                        slots[i].mark_ready(w)
                    except (ConnectionError, OSError):
                        continue
                    pending.remove((i, w))
            time.sleep(0.01)

    ready_thread = threading.Thread(target=announce_ready, daemon=True,
                                    name="kps-worker-ready")
    ready_thread.start()

    # a killed relay and the end of the run look alike on the socket; a
    # relay that closes on purpose sends the GOODBYE first, so a drop
    # without it is waited for this long.  Shards end the run when all
    # have closed (a restarted shard recovers from its own log)
    AGG_RECONNECT_GRACE = 30.0
    down_since = [None]
    reconnects = [0]

    def fleet_is_done() -> bool:
        if aggregate and any(s.run_over for s in slots):
            return True     # the relay's GOODBYE: hang up, it waits
        if not all(s.disconnected.is_set() for s in slots):
            down_since[0] = None
            return False
        if not aggregate or any(s.run_over for s in slots):
            return True
        if down_since[0] is None:
            down_since[0] = time.monotonic()
        return time.monotonic() - down_since[0] > AGG_RECONNECT_GRACE

    def supervise() -> None:
        while not stop.is_set():
            for s in slots:
                if s.reader_error is not None:
                    # a decode or device error is not a disconnect: end
                    # the process with it instead of reconnecting
                    errors.append(s.reader_error)
                    stop.set()
                    return
            if fleet_is_done():
                stop.set()
                return
            for i in range(len(slots)):
                if not slots[i].disconnected.is_set() or slots[i].run_over:
                    continue
                try:
                    nb = connect(addrs[i], timeout=3.0)
                except (ConnectionError, OSError):
                    continue        # still down; retry next sweep
                nb.set_weights_sink(sinks[i])
                start_reader(nb)
                retired.append(slots[i])
                slots[i] = nb
                reconnects[0] += 1
                for w in ids:
                    if buffers[w].count >= ready_rows:
                        try:
                            nb.mark_ready(w)
                        except (ConnectionError, OSError):
                            pass
                if aggregate:
                    # the deltas a relay held died with it, and nothing
                    # on the restarted one asks for them: resend the
                    # whole cache (the server drops what it applied)
                    for w in ids:
                        routers[w].resend(i, 0)
                print(("reconnected to aggregator" if aggregate else
                       f"reconnected to shard {i}") + f" ({addrs[i]})",
                      file=sys.stderr, flush=True)
            time.sleep(0.2)

    supervisor = threading.Thread(target=supervise, daemon=True,
                                  name="kps-worker-supervisor")
    supervisor.start()

    def worker_loop(node: WorkerNode) -> None:
        try:
            if device.type == "cuda":
                # a thread's first cuBLAS call needs a current device
                torch.cuda.set_device(test_x.device)
            while not stop.is_set():
                msg = fabric.poll_blocking(fabric_mod.WEIGHTS_TOPIC,
                                           node.worker_id, timeout=0.1)
                if msg is not None:
                    node.on_weights(msg)
        except Exception as e:
            errors.append(e)
            stop.set()

    threads = [threading.Thread(target=worker_loop, args=(nodes[w],),
                                daemon=True, name=f"worker-{w}")
               for w in ids]
    for t in threads:
        t.start()
    stop.wait()                       # the supervisor ends the run
    leftover = []
    for t in threads:
        t.join(timeout=120.0)
        if t.is_alive():
            leftover.append(t.name)
    if saver is not None:
        saver.close(leftover)
    try:
        worker_log.close()
    except Exception as e:   # a device error surfacing in the rows
        errors.append(e)
    for b in slots:
        b.close()
    supervisor.join(timeout=10.0)
    ready_thread.join(timeout=10.0)
    for t in reader_threads:
        t.join(timeout=10.0)
    for t in [supervisor, ready_thread, *reader_threads]:
        if t.is_alive():
            leftover.append(t.name)
    ops.close()                  # before any os._exit: the flight dump
    if drift_sink is not None:
        drift_sink.close()
    _dump_telemetry(args, tracer, telemetry)
    bridges = retired + slots
    _print_stats("worker", {
        "role": "worker", "device": str(device), "worker_ids": ids,
        "shards": len(addrs), "aggregate": aggregate,
        "rows": {str(w): nodes[w].iterations for w in ids},
        "rows_received": {str(w): buffers[w].num_tuples_seen for w in ids},
        "restored": restored, "codec": spec.spec_str(),
        "reconnects": reconnects[0],
        "router_resent": sum(r.resent for r in routers.values()),
        "stale_slices": assembler.stale,
        "kernels": fused_update.counts(),
        "wire": _sum_wire([b.wire_stats() for b in bridges]),
        "wire_per_shard": [b.wire_stats() for b in slots],
        "writers": net._writer_stats(
            [b._writer for b in bridges if b._writer is not None])})
    rc = 0
    if errors:
        print(f"worker failed: {errors[0]!r}", file=sys.stderr, flush=True)
        rc = 1
    if leftover:
        print(f"warning: threads still alive at exit: {leftover}; "
              "exiting without finalization", file=sys.stderr, flush=True)
        sys.stdout.flush()
        os._exit(rc)
    if errors:
        raise RuntimeError("worker failed") from errors[0]
    return 0


class _StateSaver:
    """A worker process's durable buffer state (the changelog analogue):
    a snapshot every `every` seconds in which rows or iterations moved (a
    killed process loses at most one interval of rows; under compression
    the residuals advance on every iteration even when no row arrived),
    and a last one at `close`."""

    def __init__(self, path, buffers, nodes, run_id, residuals, every):
        self._args = (path, buffers)
        self._kw = {"run_id": run_id, "residuals": residuals}
        self._fingerprint = lambda: (
            tuple(b.num_tuples_seen for b in buffers.values()),
            tuple(n.iterations for n in nodes.values()))
        self._every = every
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="kps-worker-state")
        self._thread.start()

    def _save(self) -> None:
        from kafka_ps_tpu_torch.utils import checkpoint as ckpt
        ckpt.save_worker(*self._args, **self._kw)

    def _loop(self) -> None:
        last = None
        while not self._stop.wait(self._every):
            fp = self._fingerprint()
            if fp != last:
                self._save()
                last = fp

    def close(self, leftover: list) -> None:
        """Stop, join, then the final snapshot: joined first, since two
        concurrent saves share one tmp path.  A thread wedged in a
        stalled write goes into `leftover` and no final snapshot is
        taken."""
        self._stop.set()
        self._thread.join(timeout=60.0)
        if self._thread.is_alive():
            print("warning: state saver still writing; skipping final "
                  "snapshot", file=sys.stderr, flush=True)
            leftover.append(self._thread.name)
        else:
            self._save()


def _open_worker_log(args, run_id, restoring: bool, sink_cls, header):
    """The worker CSV sink, appending when the log on disk belongs to
    this run (its `.runid` marker): log continuity follows the run, not
    whether a state file restored."""
    log_path = "./logs-worker.csv" if args.logging else None
    append_log = restoring
    if log_path is not None:
        marker = log_path + ".runid"
        try:
            with open(marker) as fh:
                append_log = append_log or int(fh.read().strip()) == run_id
        except (OSError, ValueError):
            pass
        with open(marker, "w") as fh:
            fh.write(str(run_id))
    return sink_cls(log_path, header, append=append_log)


def _sum_wire(stats: list[dict]) -> dict:
    """Several bridges' wire_stats() as one: frames, bytes and serde
    seconds added per topic."""
    out: dict = {}
    for st in stats:
        for topic, t in st.items():
            o = out.setdefault(topic, {})
            for k, v in t.items():
                if k == "serde_ms_per_frame":
                    o["_serde_ms"] = (o.get("_serde_ms", 0.0)
                                      + v * t["serde_frames"])
                else:
                    o[k] = o.get(k, 0) + v
    for o in out.values():
        ms = o.pop("_serde_ms", None)
        if ms is not None:
            o["serde_ms_per_frame"] = ms / o["serde_frames"]
    return out


# -- log-following read replicas ---------------------------------------------

def run_replica(args) -> int:
    """A read-replica serving process: follow `--durable-log DIR` and
    answer PREDICT frames on `--serve_port`, never touching the training
    deployment.

    The replica tails the log read-only (log/tail.py), so it can follow a
    live trainer's directory: reads scale by starting more replicas and
    training is unperturbed.  For a `--shards N` deployment it assembles
    the per-shard slices through FrontierCutPublisher and serves the
    full-range theta stamped with the frontier clock.  It serves until
    SIGINT, or until its follower fails (exit non-zero); at exit it
    prints `kafka_ps_tpu_torch replica: {json}`."""
    from kafka_ps_tpu_torch.models.task import get_task
    from kafka_ps_tpu_torch.serving.engine import make_engine
    from kafka_ps_tpu_torch.serving.replica import ReplicaFollower
    from kafka_ps_tpu_torch.serving.snapshot import SnapshotRegistry
    from kafka_ps_tpu_torch.utils.config import resolve_device

    root = getattr(args, "durable_log", None)
    if not root:
        raise SystemExit("--serve-replica requires --durable-log DIR (the "
                         "training deployment's commit log to follow)")
    cfg = _make_cfg(args)
    device = resolve_device()       # CUDA, or KPS_PLATFORM's choice
    tracer, telemetry = _make_telemetry(args)
    task = get_task(cfg.task, cfg.model)
    registry = SnapshotRegistry(capacity=cfg.serving.ring_capacity)
    follower = ReplicaFollower(root, registry, device=device, tracer=tracer)
    engine = make_engine(task, registry, cfg.serving, tracer=tracer,
                         telemetry=telemetry)
    follower.catch_up()              # cold start: serve what is logged
    ops = _make_ops(args, telemetry, role="replica")
    ops.add_replica_watchdog()
    ops.add_serving_watchdog(engine)
    ops.start()
    port = cfg.serving.port
    bridge = net.ServerBridge(port=0 if port is None else port,
                              run_id=time.time_ns(),
                              coalesce=getattr(args, "wire_coalesce", True),
                              device=device,
                              shm=cfg.serving.shm, engine=engine,
                              tracer=tracer, telemetry=telemetry)
    follower.start()
    mode = (f"{follower.num_shards}-shard assembled" if follower.num_shards
            else "single-server" if follower.records_read
            else "layout not made yet:")
    print(f"replica serving on port {bridge.port} ({mode} log {root}, "
          f"clock {follower.clock})", file=sys.stderr, flush=True)
    warmed = threading.Event()

    def warm(clock) -> None:
        if not warmed.is_set() and engine.warmup():
            warmed.set()
            print(f"replica warm at clock {clock}", file=sys.stderr,
                  flush=True)

    if follower.clock is not None:
        warm(follower.clock)
    else:
        # started on an empty log: warm the moment theta appears
        follower.on_publish = warm
    try:
        while follower.error is None:
            time.sleep(0.2)
        if follower.error is not None:
            raise RuntimeError("the replica stopped following its log"
                               ) from follower.error
    except KeyboardInterrupt:
        pass
    finally:
        follower.stop()
        bridge.close()
        engine.close()
        ops.close()
        _dump_telemetry(args, tracer, telemetry)
        latest = registry.latest
        _print_stats("replica", {
            "role": "replica", "device": str(device), "log": root,
            "shards": follower.num_shards, "clock": follower.clock,
            "records_read": follower.records_read,
            "publications": follower.publications,
            # the newest snapshot's digest: an audit can match it to the
            # log's weights without the replica's memory
            "snapshot_sha256": (None if latest is None else hashlib.sha256(
                latest.theta.cpu().numpy().tobytes()).hexdigest()),
            "serving": run_mod.serving_stats(engine), **bridge.stats()})
    return 0
