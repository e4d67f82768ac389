"""Worker-role entry point (counterpart of kafka_ps_tpu/cli/worker_runner.py):
the reference's WorkerAppRunner flags, same names and defaults.

With `--connect HOST:PORT` the process hosts ONLY the logical workers in
`--worker_ids` against a remote `--listen` server (cli/socket_mode.py).
Without it, it hosts the whole system in process (cli/run.py's trainer)
with the server-side knobs at their reference defaults (consistency 0,
producer 200 ms/event).  Runs on the CUDA card unless KPS_PLATFORM=cpu.
A comma-separated `--connect` dials a `--shards N` server group, one
address per shard in shard-id order; `--aggregate HOST:PORT` dials the
host's aggregator relay (cli/agg_runner.py) instead of the server.

    python -m kafka_ps_tpu_torch.cli.worker_runner --connect 127.0.0.1:8477 \\
        --worker_ids 0,1 -test test.csv -l
"""

from __future__ import annotations

import argparse

from kafka_ps_tpu_torch.cli import run as run_mod


def build_parser() -> argparse.ArgumentParser:
    """The worker-role flag surface: the JAX runner's flags."""
    parser = run_mod.build_parser(include_server_flags=False,
                                  include_worker_flags=True,
                                  prog="WorkerAppRunner")
    parser.add_argument(
        "--connect", default=None, metavar="HOST:PORT[,HOST:PORT...]",
        help="split deployment: host ONLY the logical workers in "
             "--worker_ids against a remote --listen server "
             "(cli/socket_mode.py); a comma-separated list dials a "
             "--shards N group, one address per shard in shard-id order")
    parser.add_argument("--worker_ids", default="0",
                        help="--connect: comma-separated logical worker "
                             "ids this process hosts")
    parser.add_argument(
        "--aggregate", default=None, metavar="HOST:PORT",
        help="dial a per-host aggregator relay (cli/agg_runner.py) "
             "instead of the server: deltas are combined per host before "
             "the server sees them, and compression is the relay's")
    parser.add_argument(
        "--ready-rows", dest="ready_rows", type=int, default=1,
        metavar="N",
        help="rows a worker's buffer must hold before it announces READY "
             "(default 1)")
    parser.add_argument("--state_every", type=float, default=1.0,
                        metavar="SECONDS",
                        help="--connect + --checkpoint: cadence of the "
                             "durable buffer-state snapshots — a killed "
                             "process loses at most one interval of rows")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    run_mod.refuse_telemetry_flags(args)
    # server-side defaults (ServerAppRunner.java:59-63, BaseKafkaApp.java:35)
    args = argparse.Namespace(training_data_file_path="./data/train.csv",
                              consistency_model=0,
                              producer_time_per_event=200, **vars(args))
    if args.connect is not None and args.aggregate is not None:
        raise SystemExit("--connect and --aggregate are exclusive: a "
                         "worker dials its server or its host's relay")
    if args.connect is not None or args.aggregate is not None:
        if args.durable_log:
            # same gate as server_runner: the split deployment's
            # durability is --checkpoint + worker-local state files
            raise SystemExit(
                "--durable-log applies to the in-process fabric; in "
                "--connect split mode use --checkpoint instead")
        from kafka_ps_tpu_torch.cli import socket_mode
        return socket_mode.run_worker(args)
    return run_mod.run_with_args(args)


if __name__ == "__main__":
    raise SystemExit(main())
