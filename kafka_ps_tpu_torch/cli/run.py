"""The trainer's command line (counterpart of kafka_ps_tpu/cli/run.py):
producer + server + N logical workers in one process.

    python -m kafka_ps_tpu_torch.cli.run -training train.csv -test test.csv \\
        -c 0 -p 0 -l --max_iterations 400

Flags are the reference's subset this package implements, same names
and defaults: gang dispatch and the async eval engine are on
(`--no-gang`, `--no-eval-async` turn them off), `--task mlp` trains the
one-hidden-layer MLP (`--hidden_dim`), `--slab-dtype bf16|int8` keeps the
workers' device slabs reduced (`--full-slab-upload` re-uploads them whole
on every change), `--fused` runs the sequential model as fused BSP rounds
(runtime/app.run_fused_bsp), `--compress` compresses weights and deltas
(compress/), `--checkpoint` saves every `--checkpoint_every` server
iterations and at exit and resumes from the file when it exists, and
`--failure_policy rebalance` evicts a crashed or hung worker (threaded
mode), `--durable-log DIR` (`--fsync`) logs every message and stream
row and, on a restart, replays the tail past the checkpoint (log/),
`--serve` answers predictions while training (serving/): a snapshot at
every gate release, in process or, with `--serve_port P`, over a socket
(0 = ephemeral, printed as "serving on port N"), and `--tier-hot-bytes`
/ `--tier-warm-bytes` / `--tier-page-params` cap the server's parameter
vector on the card and in host memory, the rest as records under
`--durable-log DIR/param-cold` (store/; the same bits either way).  Runs on the CUDA card;
KPS_PLATFORM=cpu runs it on the CPU.  At exit it prints one line of run
statistics on stderr: `kafka_ps_tpu_torch run: {json}`.

Telemetry (telemetry/, utils/trace.py, utils/status.py), the JAX
trainer's flags: `--status_every S` prints a `[status]` line every S
seconds, `--trace PATH` writes the tracer's Chrome trace JSON at exit
and prints its span stats, `--metrics-file PATH` (`--metrics-every S`)
writes the metrics registry in Prometheus text, `--flight-dir DIR`
arms the flight recorder (DIR/flightdump-<pid>.json at exit, on
SIGTERM/SIGABRT and on a watchdog trip), `--health-port P` serves
/healthz, /varz, /flightz and /evalz (0 = ephemeral, printed as "health
plane on port N"), and `--device_trace DIR` records the run with
torch.profiler into DIR/devicetrace-<pid>.json (utils/trace.device_trace).
The role runners take the first six (cli/socket_mode.py; `--status_every`
acts on the unsharded split server only, as in the JAX package) and
refuse `--device_trace` (`refuse_telemetry_flags`): the JAX roles parse
it and record nothing.

`build_parser` also serves the role runners (cli/server_runner.py,
cli/worker_runner.py), which leave out the other role's flags and run
`run_with_args` when not split; `--wire-coalesce` / `--no-wire-coalesce`
pick the split deployment's send path (cli/socket_mode.py).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser(include_server_flags: bool = True,
                 include_worker_flags: bool = True,
                 prog: str = "kafka_ps_tpu_torch") -> argparse.ArgumentParser:
    """The trainer's flags; the role runners (cli/server_runner.py,
    cli/worker_runner.py) leave out the other role's own flags, as the
    reference's two runners do."""
    p = argparse.ArgumentParser(
        prog=prog, description="streaming parameter server on an NVIDIA GPU")
    if include_server_flags:
        p.add_argument("-training", "--training_data_file_path",
                       default="./data/train.csv",
                       help="path to the training-data CSV")
        p.add_argument("-c", "--consistency_model", type=int, default=0,
                       help="0 sequential, k>0 bounded delay, -1 eventual")
        p.add_argument("-p", "--producer_time_per_event", type=int,
                       default=200,
                       help="ms per produced event (0 = unpaced)")
    if include_worker_flags:
        p.add_argument("-min", "--min_buffer_size", type=int, default=128)
        p.add_argument("-max", "--max_buffer_size", type=int, default=1024)
        p.add_argument("-bc", "--buffer_size_coefficient", type=float,
                       default=0.3)
    p.add_argument("-test", "--test_data_file_path",
                   default="./data/test.csv",
                   help="path to the test-data CSV")
    p.add_argument("-l", "--logging", action="store_true",
                   help="write performance logs to ./logs-server.csv / "
                        "./logs-worker.csv (and membership events to "
                        "./logs-events.csv) instead of stdout")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="print the parameters used and the checkpoint "
                        "restore")
    p.add_argument("--mode", choices=["threaded", "serial"],
                   default="threaded")
    p.add_argument("--failure_policy", choices=["halt", "rebalance"],
                   default="halt",
                   help="threaded mode: evict crashed/hung workers and "
                        "continue on the survivors (rebalance), or stop "
                        "the run (halt)")
    p.add_argument("--heartbeat_timeout", type=float, default=None,
                   help="threaded+rebalance: seconds without worker "
                        "progress (with work pending) before eviction")
    p.add_argument("--checkpoint", default=None,
                   help="path to save/restore the server's state, the "
                        "workers' buffers and error-feedback residuals")
    p.add_argument("--checkpoint_every", type=int, default=50,
                   help="server iterations between checkpoint saves")
    p.add_argument("--durable-log", dest="durable_log", default=None,
                   metavar="DIR",
                   help="persist every weights, gradients and input-data "
                        "message to a segmented commit log under DIR "
                        "(log/); on restart the run replays the "
                        "unconsumed tail past the last checkpoint's "
                        "committed offsets")
    p.add_argument("--fsync", choices=["none", "interval", "always"],
                   default="interval",
                   help="--durable-log fsync policy: page cache only / at "
                        "most once per second / every append (log/log.py)")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--num_features", type=int, default=1024)
    p.add_argument("--num_classes", type=int, default=5)
    p.add_argument("--task", choices=["logreg", "mlp"], default="logreg",
                   help="model family; logreg is the reference's")
    p.add_argument("--hidden_dim", type=int, default=128,
                   help="hidden width of the mlp task")
    p.add_argument("--local_iterations", type=int, default=2,
                   help="k local solver steps per iteration")
    p.add_argument("--local_learning_rate", type=float, default=0.5)
    p.add_argument("--max_iterations", type=int, default=0,
                   help="stop after this many server iterations "
                        "(0 = run until Ctrl-C)")
    p.add_argument("--fused", action="store_true",
                   help="sequential model as fused BSP rounds: one gang "
                        "kernel call per round, chunks of rounds as one "
                        "CUDA graph (parallel/bsp.py)")
    p.add_argument("--eval_every", type=int, default=1,
                   help="evaluate test metrics every Nth vector clock")
    p.add_argument("--pallas", action="store_true",
                   help="accepted for parity with kafka_ps_tpu: on the "
                        "card the local update is the CUDA kernel either "
                        "way")
    p.add_argument("--no-gang", action="store_true", dest="no_gang",
                   help="strict per-message dispatch instead of gang "
                        "dispatch (bitwise the same results)")
    p.add_argument("--eval-async", dest="eval_async", action="store_true",
                   default=True,
                   help="async eval engine (default): the server's test-"
                        "set evaluation runs on its own thread and emits "
                        "the same rows in clock order")
    p.add_argument("--no-eval-async", dest="eval_async",
                   action="store_false",
                   help="evaluate inside the server's apply instead")
    p.add_argument("--slab-dtype", dest="slab_dtype",
                   choices=["f32", "bf16", "int8"], default="f32",
                   help="storage of each worker's device-resident "
                        "training slab: bf16 halves and int8 (per-row "
                        "max-abs scales) about quarters the bytes the "
                        "solver reads; the kernel decodes it (K3, K5)")
    p.add_argument("--compress", default="none", metavar="CODEC",
                   help="compressed delta transport (compress/): none | "
                        "bf16 | int8 | topk:<ratio>.  Applied "
                        "symmetrically: server->worker weights are "
                        "quantize-dequantized, worker->server deltas go "
                        "through per-worker error-feedback residuals.  "
                        "Incompatible with --fused")
    p.add_argument("--full-slab-upload", action="store_true",
                   dest="full_slab_upload",
                   help="re-upload the whole slab whenever the buffer "
                        "changes instead of scattering only the dirty "
                        "rows (bitwise the same slab)")
    # -- tiered parameter residency (store/) --
    p.add_argument("--tier-hot-bytes", dest="tier_hot_bytes", type=int,
                   default=0, metavar="BYTES",
                   help="tiered parameter residency (store/): cap the "
                        "device-resident (hot) tier of the server's "
                        "parameter vector at BYTES; overflow pages live "
                        "in host RAM (warm).  0 = unbounded, fully "
                        "resident.  Capped runs compute the same bits; "
                        "they only bound resident bytes.  Per process.  "
                        "Incompatible with --fused")
    p.add_argument("--tier-warm-bytes", dest="tier_warm_bytes", type=int,
                   default=0, metavar="BYTES",
                   help="cap the host-RAM (warm) tier at BYTES; overflow "
                        "pages demote to CRC-framed records in the commit "
                        "log and fault back in on demand; requires "
                        "--durable-log (the cold partition lives under "
                        "it).  0 = unbounded")
    p.add_argument("--tier-page-params", dest="tier_page_params", type=int,
                   default=1024, metavar="KEYS",
                   help="keys per residency page (the promotion/demotion "
                        "unit; must match across checkpoint resumes)")
    # -- the online serving plane (serving/) --
    p.add_argument("--serve", action="store_true",
                   help="serve predictions while training: the server "
                        "publishes a weights snapshot at every gate "
                        "release and a micro-batching engine answers "
                        "staleness-bounded reads against the newest one")
    p.add_argument("--serve_port", type=int, default=None, metavar="PORT",
                   help="with --serve: also accept PREDICT frames on this "
                        "TCP port (0 = ephemeral; the bound port is "
                        "printed to stderr)")
    p.add_argument("--serve_batch", type=int, default=16,
                   help="serving micro-batch size cap")
    p.add_argument("--serve_deadline_ms", type=float, default=2.0,
                   help="max milliseconds a prediction waits for its "
                        "micro-batch to fill")
    p.add_argument("--serve_snapshots", type=int, default=8,
                   help="snapshot ring capacity (exact-clock reads)")
    p.add_argument("--serve-queue", dest="serve_queue", type=int, default=0,
                   metavar="N",
                   help="admission control: max outstanding requests per "
                        "model before the engine sheds with a typed "
                        "OVERLOADED answer (0 = unbounded)")
    p.add_argument("--serve-shed", dest="serve_shed_ms", type=float,
                   default=0.0, metavar="MS",
                   help="predictive shedding: refuse a request whose "
                        "estimated queueing delay exceeds MS milliseconds "
                        "(0 = off)")
    p.add_argument("--serve-auto", dest="serve_auto", action="store_true",
                   default=True,
                   help="adaptive dispatch (default): the engine learns "
                        "the dispatch cost per batch size, serves inline "
                        "below the break-even occupancy and sizes the "
                        "batch window from the arrival rate")
    p.add_argument("--no-serve-auto", dest="serve_auto",
                   action="store_false",
                   help="always micro-batch with the full window")
    p.add_argument("--serve-shm", dest="serve_shm", action="store_true",
                   help="offer co-located PredictClients a shared-memory "
                        "channel; other clients stay on the socket")
    # -- telemetry (telemetry/, utils/trace.py, utils/status.py) --
    p.add_argument("--status_every", type=float, default=0.0,
                   metavar="SECONDS",
                   help="emit a [status] line to stderr every N seconds "
                        "(iters/s, per-worker clocks, membership, queue "
                        "depths, buffer fill) (utils/status.py; 0 = off)")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="write a Chrome trace-event JSON (spans + message "
                        "counters) on exit and print span stats")
    p.add_argument("--metrics-file", dest="metrics_file", default=None,
                   metavar="PATH",
                   help="enable the metrics registry (telemetry/) and "
                        "write a Prometheus-style text dump of every "
                        "counter/gauge/histogram family to PATH at exit "
                        "(and every --metrics-every seconds); also folds a "
                        "flat metrics summary into each [status] line")
    p.add_argument("--metrics-every", dest="metrics_every", type=float,
                   default=0.0, metavar="SECONDS",
                   help="with --metrics-file: rewrite the dump every N "
                        "seconds (atomic replace; 0 = only at exit)")
    p.add_argument("--flight-dir", dest="flight_dir", default=None,
                   metavar="DIR",
                   help="enable the always-on flight recorder "
                        "(telemetry/flight.py): per-thread rings of "
                        "structured events (gate decisions, fsyncs, "
                        "snapshot publishes, eval dispatches) dumped "
                        "atomically to DIR/flightdump-<pid>.json on "
                        "SIGTERM/SIGABRT/fatal signals, on watchdog trips, "
                        "and at clean exit")
    p.add_argument("--health-port", dest="health_port", type=int,
                   default=None, metavar="PORT",
                   help="serve the health/introspection plane on this "
                        "port (0 = ephemeral, printed to stderr): "
                        "/healthz watchdog-derived liveness/readiness, "
                        "/varz Prometheus metrics snapshot, /flightz "
                        "recent flight-ring tail, /evalz the async eval "
                        "engine")
    p.add_argument("--device_trace", default=None, metavar="LOGDIR",
                   help="capture a torch.profiler device trace (Chrome "
                        "trace JSON, LOGDIR/devicetrace-<pid>.json) for "
                        "the whole run")
    p.add_argument("--wire-coalesce", dest="wire_coalesce",
                   action="store_true", default=True,
                   help="split deployment (cli/socket_mode.py): frame "
                        "coalescing on the socket bridges (default): sends "
                        "queue behind a per-connection writer thread that "
                        "ships every queued frame in one scatter-gather "
                        "sendmsg")
    p.add_argument("--no-wire-coalesce", dest="wire_coalesce",
                   action="store_false",
                   help="one sendall per frame under the connection lock "
                        "(the byte stream is the same either way)")
    return p


def load_test_csv(path: str, num_features: int):
    """Test set: dense CSV with header, label in the last column."""
    from kafka_ps_tpu_torch.data.stream import load_csv_dataset
    x, y = load_csv_dataset(path)
    if x.shape[1] != num_features:
        raise SystemExit(
            f"test CSV has {x.shape[1] + 1} columns, expected "
            f"{num_features + 1} (features + label)")
    return x, y


def make_app_from_args(args, device=None, resuming: bool = False):
    from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
    from kafka_ps_tpu_torch.utils.config import (BufferConfig, ModelConfig,
                                                 PSConfig, StreamConfig,
                                                 TierConfig)
    from kafka_ps_tpu_torch.utils.csvlog import (SERVER_HEADER,
                                                 WORKER_HEADER, CsvLogSink)
    cfg = PSConfig(
        num_workers=args.num_workers,
        consistency_model=args.consistency_model,
        task=args.task,
        model=ModelConfig(num_features=args.num_features,
                          num_classes=args.num_classes,
                          num_max_iter=args.local_iterations,
                          local_learning_rate=args.local_learning_rate,
                          hidden_dim=args.hidden_dim),
        buffer=BufferConfig(min_size=args.min_buffer_size,
                            max_size=args.max_buffer_size,
                            coefficient=args.buffer_size_coefficient),
        stream=StreamConfig(time_per_event_ms=args.producer_time_per_event),
        eval_every=args.eval_every,
        eval_async=args.eval_async,
        use_gang=not args.no_gang,
        slab_dtype=args.slab_dtype,
        slab_incremental=not args.full_slab_upload,
        compress=args.compress,
        serving=serving_config(args),
        tier=TierConfig(hot_bytes=args.tier_hot_bytes,
                        warm_bytes=args.tier_warm_bytes,
                        page_params=args.tier_page_params))
    test_x, test_y = load_test_csv(args.test_data_file_path,
                                   args.num_features)
    # a resumed run continues its logs
    server_log = CsvLogSink("./logs-server.csv" if args.logging else None,
                            SERVER_HEADER, append=resuming)
    worker_log = CsvLogSink("./logs-worker.csv" if args.logging else None,
                            WORKER_HEADER, append=resuming)
    tracer = None
    if args.trace:
        from kafka_ps_tpu_torch.utils.trace import Tracer
        tracer = Tracer()
    from kafka_ps_tpu_torch.telemetry import maybe_telemetry
    # /varz serves this same registry, so a health plane arms metrics even
    # without a --metrics-file dump target
    telemetry = maybe_telemetry(
        tracer, want_metrics=bool(args.metrics_file)
        or args.health_port is not None)
    fabric = None
    if args.durable_log:
        from kafka_ps_tpu_torch.log import DurableFabric, LogConfig
        fabric = DurableFabric(args.durable_log,
                               LogConfig(fsync=args.fsync), device=device,
                               tracer=tracer, telemetry=telemetry)
    app = StreamingPSApp(cfg, test_x=test_x, test_y=test_y,
                         server_log=server_log, worker_log=worker_log,
                         device=device, fabric=fabric, tracer=tracer,
                         telemetry=telemetry)
    return app, (server_log, worker_log)


def main(argv=None) -> int:
    return run_with_args(build_parser().parse_args(argv))


def refuse_telemetry_flags(args) -> None:
    """The role runners share this parser; of its telemetry flags they
    take all but `--device_trace`, which the JAX roles parse and never
    use: a runner given it exits instead of ignoring it."""
    if getattr(args, "device_trace", None) is not None:
        raise SystemExit(
            "--device_trace: the role runners take no device trace, as in "
            "the JAX package; python -m kafka_ps_tpu_torch.cli.run takes it")


def run_with_args(args) -> int:
    """The in-process trainer on parsed flags (the role runners' path
    when they are given neither --listen nor --connect)."""
    if args.eval_every < 1:
        raise SystemExit("--eval_every must be >= 1")
    if args.fused and args.pallas:
        raise SystemExit(
            "--pallas applies to the per-node worker path only; the "
            "--fused BSP path runs its own fused program "
            "(parallel/bsp.py) — drop one of the two flags")
    if args.slab_dtype != "f32" and args.fused:
        # the fused BSP path keeps its own whole-slab device cache outside
        # the worker SlabStore: ignoring the dtype would misreport what ran
        raise SystemExit(
            "--slab-dtype applies to the per-node worker slab "
            "(compress/slab.py); the --fused BSP path keeps its own "
            "slab cache — drop one of the two flags")
    check_tier_flags(args)
    if args.serve_port is not None and not args.serve:
        raise SystemExit("--serve_port requires --serve")
    if args.compress != "none":
        from kafka_ps_tpu_torch.compress.wire import parse_codec
        try:
            parse_codec(args.compress)
        except ValueError as e:
            raise SystemExit(f"--compress: {e}") from None
        if args.fused:
            # the fused BSP rounds send no messages: there is no wire to
            # compress, and ignoring the flag would misreport what ran
            raise SystemExit(
                "--compress applies to the message transport; the --fused "
                "rounds never cross a serde boundary — drop one of the "
                "two flags")
    if args.verbose:
        print("\nUsed parameter:")
        for k, v in sorted(vars(args).items()):
            print(f"    {k}: {v}")
    from kafka_ps_tpu_torch.utils.config import resolve_device
    from kafka_ps_tpu_torch.utils.csvlog import (EVENTS_HEADER, CsvLogSink,
                                                 NullLogSink)
    device = resolve_device()       # CUDA, or KPS_PLATFORM's choice
    resuming = bool(args.checkpoint and os.path.exists(args.checkpoint))
    app, logs = make_app_from_args(args, device, resuming=resuming)
    # membership and resume events are written as they happen
    events_log = (CsvLogSink("./logs-events.csv", EVENTS_HEADER,
                             append=resuming)
                  if args.logging else NullLogSink())
    app.server.membership_log = events_log
    logs = [*logs, events_log]
    if app.cfg.tier.enabled:
        # before the checkpoint restore, which applies the recorded
        # residency (utils/checkpoint.py)
        from kafka_ps_tpu_torch.log.durable_fabric import COLD_PARTITION_DIR
        app.enable_tiering(os.path.join(args.durable_log, COLD_PARTITION_DIR)
                           if args.durable_log else None)
    if args.checkpoint:
        restored = app.restore_checkpoint(args.checkpoint)
        if restored and args.verbose:
            print(f"    restored checkpoint at iteration "
                  f"{app.server.iterations}")
            if app.server.param_store is not None:
                print(f"    restored tier residency "
                      f"{app.server.param_store.tier_counts()}")
        app.server.checkpoint_path = args.checkpoint
        app.server.checkpoint_every = args.checkpoint_every
        app.server.checkpoint_buffers = app.buffers
    if args.durable_log:
        # replay the unconsumed tail past the restored checkpoint's
        # offsets (or the committed ones) BEFORE the producer starts
        counts = app.recover_durable()
        if args.verbose:
            print(f"    durable-log replay: {counts}")
    producer = app.make_producer(args.training_data_file_path)
    serve_bridge = start_serving(app, args) if args.serve else None
    ops = start_ops(app, args)
    if args.metrics_file and args.metrics_every > 0:
        # the periodic dump (atomic replace); the exit path writes the
        # final state either way
        app.telemetry.start_dumper(args.metrics_file, args.metrics_every)
    from kafka_ps_tpu_torch.utils.trace import device_trace
    try:
        producer.run_in_background()
        app.wait_for_prefill(min_per_worker=1, timeout=120.0)
        app.wait_for_stream_settle(producer)
        max_iters = args.max_iterations or sys.maxsize
        with device_trace(args.device_trace, app.device):
            if args.fused:
                app.run_fused_bsp(max_server_iterations=max_iters,
                                  status_every=args.status_every)
            elif args.mode == "serial":
                app.run_serial(max_server_iterations=max_iters,
                               pump=lambda: None,
                               status_every=args.status_every)
            else:
                app.run_threaded(max_server_iterations=max_iters,
                                 failure_policy=args.failure_policy,
                                 heartbeat_timeout=args.heartbeat_timeout,
                                 status_every=args.status_every)
    except KeyboardInterrupt:
        print("interrupted — shutting down", file=sys.stderr)
        app.stop()
    finally:
        # join every thread before the interpreter finalizes
        producer.stop()
        # serving: the socket first (no new requests), then the engine's
        # batcher thread
        if serve_bridge is not None:
            serve_bridge.close()
        app.close_serving()
        # the ops plane after serving, before the logs: the final flight
        # dump still sees live telemetry and a coherent ring
        ops.close()
        if args.checkpoint:
            # on a durable fabric the final save is a commit point too
            app.server.save_checkpoint_now()
        # after the save, which may still read cold pages
        app.close_tiering()
        if args.durable_log:
            app.fabric.close()
        app.close_logs()
        for log in logs:
            log.close()
        if args.metrics_file:
            app.telemetry.stop_dumper()
            app.telemetry.write_prometheus(args.metrics_file)
        if args.trace:
            print(app.tracer.dump(args.trace), file=sys.stderr)
            print(json.dumps({"spans": app.tracer.span_stats(),
                              "counters": app.tracer.counters()},
                             indent=2), file=sys.stderr)
    print("kafka_ps_tpu_torch run: "
          + json.dumps(run_stats(app, producer)), file=sys.stderr)
    return 0


def start_ops(app, args):
    """The flight recorder, watchdogs and health plane
    (telemetry/health.OpsPlane), started: the gate watchdog, the fsync
    watchdog on a durable log, the serving watchdog under --serve, the
    eval engine on /evalz.  Inert without --flight-dir and
    --health-port."""
    from kafka_ps_tpu_torch.telemetry.health import OpsPlane
    ops = OpsPlane(flight_dir=args.flight_dir, health_port=args.health_port,
                   telemetry=app.telemetry, role="run")
    ops.add_gate_watchdog(app.server)
    if args.durable_log:
        ops.add_fsync_watchdog()
    if app.serving_engine is not None:
        ops.add_serving_watchdog(app.serving_engine)
    if app.eval_engine is not None:
        ops.add_eval_engine(app.eval_engine)
    ops.start()
    return ops


def check_tier_flags(args) -> None:
    """The JAX trainer's checks of the --tier-* flags."""
    tier_hot, tier_warm = args.tier_hot_bytes, args.tier_warm_bytes
    if tier_hot < 0 or tier_warm < 0:
        raise SystemExit("--tier-*-bytes caps must be >= 0")
    if (tier_hot or tier_warm) and args.fused:
        # the fused rounds keep theta inside their own program: ignoring
        # the caps would misreport what ran
        raise SystemExit(
            "--tier-hot-bytes/--tier-warm-bytes apply to the per-node "
            "server (kafka_ps_tpu/store/); the --fused BSP path keeps "
            "theta inside its mesh program — drop one of the two flags")
    if tier_warm and not args.durable_log:
        raise SystemExit(
            "--tier-warm-bytes demotes pages to commit-log records; "
            "run with --durable-log DIR so the cold partition has a "
            "home (docs/TIERING.md)")
    if args.tier_page_params < 1:
        raise SystemExit("--tier-page-params must be >= 1")


def serving_config(args):
    """The --serve flags as a utils.config.ServingConfig; a namespace from
    a parser that does not add them gets the defaults."""
    from kafka_ps_tpu_torch.utils.config import ServingConfig
    if not hasattr(args, "serve"):
        return ServingConfig()
    return ServingConfig(
        enabled=args.serve, port=args.serve_port, max_batch=args.serve_batch,
        deadline_ms=args.serve_deadline_ms,
        ring_capacity=args.serve_snapshots, queue_limit=args.serve_queue,
        shed_deadline_ms=args.serve_shed_ms, auto=args.serve_auto,
        shm=args.serve_shm)


def serving_stats(engine, server=None) -> dict:
    """A stats line's `serving` block: the engine's stats and, with the
    server, the snapshots it published, the last one's clock and its
    stable clock now."""
    out = dict(engine.stats())
    if server is not None:
        out.update(snapshots_published=server.snapshots_published,
                   last_published_clock=server.last_published_clock,
                   stable_clock=server.serving_clock())
    return out


def start_serving(app, args):
    """The serving plane's cold start: the engine, the restored (or
    fresh) theta published, then the durable log's newest released
    weights when they are ahead of the stable clock (a restarted process
    serves at once what the dead one had promised a worker), then the
    socket when `--serve_port` is given.  Returns the bridge or None."""
    engine = app.enable_serving()
    app.server.publish_snapshot()
    if args.durable_log:
        latest = app.fabric.latest_logged_weights()
        if (latest is not None
                and latest.vector_clock > app.server.serving_clock()):
            app.server.publish_snapshot(latest.values, latest.vector_clock)
    if args.serve_port is None:
        return None
    from kafka_ps_tpu_torch.runtime import net
    bridge = net.ServerBridge(port=args.serve_port, run_id=app.server.run_id,
                              device=app.device, shm=args.serve_shm,
                              engine=engine, tracer=app.tracer,
                              telemetry=app.telemetry)
    print(f"serving on port {bridge.port}", file=sys.stderr, flush=True)
    return bridge


def run_stats(app, producer) -> dict:
    """Host counters of a finished run: server iterations, membership
    (active workers, dropped gradients, rerouted rows, evictions), gang
    dispatches and their members, the eval engine's dispatches, widths
    and final lag, the workers' device slabs (storage form, bytes on
    the device, host bytes uploaded), the fused rounds (all, in chunks,
    chunk dispatches, CUDA graphs captured), the producer's parser,
    rows and the seconds of its native one-pass parse, and on a durable
    log its counters (log/durable_fabric.DurableFabric.stats) with the
    replay's counts and seconds and the re-ingested rows skipped, with
    --serve the engine's stats and the snapshots published, and with a
    tiered store its stats (store/tiered.TieredParamStore.stats)."""
    stores = [w._slab_store for w in app.workers]
    server = app.server
    out = {"server_iterations": server.iterations,
           "server_batched_applies": server.batched_applies,
           "membership": {
               "active": server.tracker.active_workers,
               "zombie_gradients_dropped": server.zombie_gradients_dropped,
               "duplicate_gradients_dropped":
                   server.duplicate_gradients_dropped,
               "rerouted_rows": app.rerouted_rows,
               "evictions": [w for w, _ in app.worker_failures]},
           "slab": {"dtype": app.cfg.slab_dtype,
                    "device_bytes": sum(s.device_bytes() for s in stores),
                    "bytes_uploaded": sum(s.bytes_uploaded
                                          for s in stores)}}
    if app.fused_stats["rounds"]:
        out["fused"] = dict(app.fused_stats, graph_captures=sum(
            multi.captures for _, multi in app._fused_programs.values()))
    out["producer"] = {"parser": producer.parser,
                       "rows": producer.rows_sent,
                       "parse_s": producer.parse_s}
    if app.gang is not None:
        out["gang"] = {"dispatches": app.gang.dispatches,
                       "members": app.gang.members}
    if app.eval_engine is not None:
        out["eval"] = app.eval_engine.stats()
    if server.compressor is not None:
        out["compress"] = compress_stats(app)
    if app.fabric.durable:
        out["durable"] = dict(app.fabric.stats(),
                              replayed=app.replay_counts,
                              replay_s=app.replay_s,
                              skipped_rows=app.skipped_rows)
    if app.serving_engine is not None:
        out["serving"] = serving_stats(app.serving_engine, server)
    if server.param_store is not None:
        out["tier"] = server.param_store.stats()
    if server.checkpoint_path:
        out["checkpoint"] = {"restored_at": app.restored_at,
                             "restore_s": app.restore_s,
                             "saves": server.checkpoint_saves,
                             "save_s": server.checkpoint_save_s}
    return out


def compress_stats(app) -> dict:
    """The codec, the bytes of every message's packed payload before the
    zlib stage beside the 4n bytes of plain float32, and the redelivered
    weights clocks the workers answered from cache."""
    codec = app.server.compressor.codec
    return {"codec": codec.spec.spec_str(), "raw_bytes": 4 * codec.n,
            "message_bytes": codec.message_bytes,
            "redelivered_weights": sum(w.redelivered for w in app.workers)}


if __name__ == "__main__":
    raise SystemExit(main())
