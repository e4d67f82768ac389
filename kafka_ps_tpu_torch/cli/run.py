"""The trainer's command line (counterpart of kafka_ps_tpu/cli/run.py):
producer + server + N logical workers in one process.

    python -m kafka_ps_tpu_torch.cli.run -training train.csv -test test.csv \\
        -c 0 -p 0 -l --max_iterations 400

Flags are the reference's subset this package implements, same names
and defaults: gang dispatch and the async eval engine are on
(`--no-gang`, `--no-eval-async` turn them off), `--task mlp` trains the
one-hidden-layer MLP (`--hidden_dim`).  Runs on the CUDA card;
KPS_PLATFORM=cpu runs it on the CPU.  At exit it prints one line of run
statistics on stderr: `kafka_ps_tpu_torch run: {json}`.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kafka_ps_tpu_torch",
        description="streaming parameter server on an NVIDIA GPU")
    p.add_argument("-training", "--training_data_file_path",
                   default="./data/train.csv",
                   help="path to the training-data CSV")
    p.add_argument("-test", "--test_data_file_path",
                   default="./data/test.csv",
                   help="path to the test-data CSV")
    p.add_argument("-c", "--consistency_model", type=int, default=0,
                   help="0 sequential, k>0 bounded delay, -1 eventual")
    p.add_argument("-p", "--producer_time_per_event", type=int,
                   default=200, help="ms per produced event (0 = unpaced)")
    p.add_argument("-min", "--min_buffer_size", type=int, default=128)
    p.add_argument("-max", "--max_buffer_size", type=int, default=1024)
    p.add_argument("-bc", "--buffer_size_coefficient", type=float,
                   default=0.3)
    p.add_argument("-l", "--logging", action="store_true",
                   help="write performance logs to ./logs-server.csv / "
                        "./logs-worker.csv instead of stdout")
    p.add_argument("--mode", choices=["threaded", "serial"],
                   default="threaded")
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


def make_app_from_args(args, device=None):
    from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
    from kafka_ps_tpu_torch.utils.config import (BufferConfig, ModelConfig,
                                                 PSConfig, StreamConfig)
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
        use_gang=not args.no_gang)
    test_x, test_y = load_test_csv(args.test_data_file_path,
                                   args.num_features)
    server_log = CsvLogSink("./logs-server.csv" if args.logging else None,
                            SERVER_HEADER)
    worker_log = CsvLogSink("./logs-worker.csv" if args.logging else None,
                            WORKER_HEADER)
    app = StreamingPSApp(cfg, test_x=test_x, test_y=test_y,
                         server_log=server_log, worker_log=worker_log,
                         device=device)
    return app, (server_log, worker_log)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.eval_every < 1:
        raise SystemExit("--eval_every must be >= 1")
    from kafka_ps_tpu_torch.utils.config import resolve_device
    device = resolve_device()       # CUDA, or KPS_PLATFORM's choice
    app, logs = make_app_from_args(args, device)
    producer = app.make_producer(args.training_data_file_path)
    try:
        producer.run_in_background()
        app.wait_for_prefill(min_per_worker=1, timeout=120.0)
        app.wait_for_stream_settle(producer)
        max_iters = args.max_iterations or sys.maxsize
        if args.mode == "serial":
            app.run_serial(max_server_iterations=max_iters,
                           pump=lambda: None)
        else:
            app.run_threaded(max_server_iterations=max_iters)
    except KeyboardInterrupt:
        print("interrupted — shutting down", file=sys.stderr)
        app.stop()
    finally:
        # join every thread before the interpreter finalizes
        producer.stop()
        app.close_logs()
        for log in logs:
            log.close()
    print("kafka_ps_tpu_torch run: " + json.dumps(run_stats(app)),
          file=sys.stderr)
    return 0


def run_stats(app) -> dict:
    """Host counters of a finished run: server iterations, gang
    dispatches and their members, the eval engine's dispatches, widths
    and final lag."""
    out = {"server_iterations": app.server.iterations,
           "server_batched_applies": app.server.batched_applies}
    if app.gang is not None:
        out["gang"] = {"dispatches": app.gang.dispatches,
                       "members": app.gang.members}
    if app.eval_engine is not None:
        out["eval"] = app.eval_engine.stats()
    return out


if __name__ == "__main__":
    raise SystemExit(main())
