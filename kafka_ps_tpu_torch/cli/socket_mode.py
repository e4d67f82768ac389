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
negotiation.  Not ported yet, each refused with the ROADMAP item that
brings it: the range-sharded worker (a comma-separated `--connect`, item
20), aggregator relays (`--aggregate`, item 23); the tier store (22),
serving (21) and the telemetry planes (24) have no flags here.

At exit each role prints one line of run statistics on stderr,
`kafka_ps_tpu_torch server: {json}` or `kafka_ps_tpu_torch worker:
{json}`: the role and device; server iterations, membership, rows sent
and the eval engine's state, with the wall-clock ms at which the server's
logs were flushed (`end_ms`), or a worker's rows; the bridge's frames,
bytes and serde milliseconds per frame by topic and its dropped sends;
and for a worker its kernel calls by family and form
(ops/fused_update.counts).
"""

from __future__ import annotations

import json
import os
import queue
import sys
import threading
import time

from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime import net


def _make_cfg(args):
    from kafka_ps_tpu_torch.utils.config import (BufferConfig, ModelConfig,
                                                 PSConfig, StreamConfig)
    if getattr(args, "eval_every", 1) < 1:
        raise SystemExit("--eval_every must be >= 1")
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
        compress=getattr(args, "compress", "none") or "none")


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
        self._lock = threading.Lock()

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
    bridge = net.ServerBridge(
        port=args.listen,
        heartbeat_interval=min(1.0, hb_timeout / 3) if hb_timeout else 1.0,
        heartbeat_timeout=hb_timeout, run_id=run_id, codec=codec_spec,
        coalesce=getattr(args, "wire_coalesce", True), device=device)
    print(f"listening on port {bridge.port}", file=sys.stderr, flush=True)
    fabric = bridge.wrap(fabric_mod.Fabric())
    server = ServerNode(cfg, fabric, device, test_x, test_y,
                        DeferredSink(log))
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
    eval_engine = None
    if cfg.eval_async:
        from kafka_ps_tpu_torch.evaluation.engine import EvalEngine
        eval_engine = server.attach_eval_engine(EvalEngine(
            server.task, server.test_x, server.test_y, server._emit_eval))
    if checkpoint_path:
        ckpt.maybe_restore(checkpoint_path, server)
        server.checkpoint_path = checkpoint_path
        server.checkpoint_every = getattr(args, "checkpoint_every", 50)
        if resuming:
            print(f"restored checkpoint at iteration {server.iterations}",
                  file=sys.stderr, flush=True)

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
    producer = CsvStreamProducer(
        args.training_data_file_path, cfg.num_workers, batch_sink,
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
        producer.stop()      # join the pump before teardown
        batch_sink.flush_all()   # after the pump join: no concurrent adds
        bridge.close()       # workers see EOF and shut down; joins the
                             # accept/heartbeat/reader threads
        try:
            if eval_engine is not None:
                eval_engine.close()   # drains pending evals into server.log
            if checkpoint_path:
                server.save_checkpoint_now()
        finally:
            if reroute["dropped"] or bridge.dropped_sends:
                print(f"dropped rows: {reroute['dropped']}, dropped sends: "
                      f"{bridge.dropped_sends}", file=sys.stderr, flush=True)
            server.log.close()           # joins drain thread + closes sink
            events_log.close()
            _print_stats("server", {
                "role": "server", "device": str(device),
                "server_iterations": server.iterations,
                "end_ms": int(time.time() * 1000),
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
                **bridge.stats()})
    return 0


def run_worker(args) -> int:
    """Worker role: the logical workers in --worker_ids, server remote.

    The kernels of the configured family and slab form are built and
    loaded before the connection, so a first build (nvcc) is never
    taken for a hung worker by the server's heartbeat.  A reader
    exception that is not a connection error, or a worker loop's
    exception (a CUDA error), makes the process exit 1."""
    if getattr(args, "aggregate", None):
        raise SystemExit("--aggregate: aggregator relays are not ported "
                         "yet (ROADMAP item 23); --connect to the server")
    if "," in args.connect:
        raise SystemExit("--connect with several addresses is the "
                         "range-sharded worker, not ported yet (ROADMAP "
                         "item 20); give one HOST:PORT")
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
    bridge = net.WorkerBridge(
        host or "127.0.0.1", int(port), ids,
        heartbeat_timeout=getattr(args, "heartbeat_timeout", None),
        codec=codec_spec, coalesce=getattr(args, "wire_coalesce", True),
        device=device)
    fabric = bridge.make_fabric()

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
    # has no state file, but its pre-crash rows still belong to this
    # run.  A sidecar marker records which run the log belongs to.
    log_path = "./logs-worker.csv" if args.logging else None
    append_log = restoring
    if log_path is not None:
        marker = log_path + ".runid"
        try:
            with open(marker) as fh:
                append_log = append_log or (
                    int(fh.read().strip()) == bridge.server_run_id)
        except (OSError, ValueError):
            pass
        with open(marker, "w") as fh:
            fh.write(str(bridge.server_run_id))
    log = CsvLogSink(log_path, WORKER_HEADER, append=append_log)

    buffers = {w: SlidingBuffer(cfg.model.num_features, cfg.buffer)
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
                           test_y, worker_log)
             for w in ids}
    if compressors is not None:
        for w in ids:
            nodes[w].compressor = compressors[w]

    if state_path is not None:
        state_stop = threading.Event()

        def state_saver():
            # the changelog analogue: snapshot on a cadence so a killed
            # process loses at most one interval of rows; skip idle
            # intervals.  The fingerprint covers insertions AND
            # iteration counts: under compression the residuals advance
            # on every iteration even when no new rows arrived.
            last = None
            while not state_stop.wait(state_every):
                fp = (tuple(buffers[w].num_tuples_seen for w in ids),
                      tuple(nodes[w].iterations for w in ids))
                if fp != last:
                    ckpt.save_worker(state_path, buffers,
                                     run_id=bridge.server_run_id,
                                     residuals=compressors)
                    last = fp

        state_saver_thread = threading.Thread(
            target=state_saver, daemon=True, name="kps-worker-state")
        state_saver_thread.start()

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
    if state_path is not None:
        state_stop.set()
        # join BEFORE the final save: two concurrent save_worker calls
        # share one tmp path and would corrupt the state file
        state_saver_thread.join(timeout=60.0)
        if state_saver_thread.is_alive():   # wedged in a stalled write
            print("warning: state saver still writing; skipping final "
                  "snapshot", file=sys.stderr, flush=True)
            leftover.append(state_saver_thread.name)
        else:
            ckpt.save_worker(state_path, buffers,   # final snapshot
                             run_id=bridge.server_run_id,
                             residuals=compressors)
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
