"""Server-role entry point (counterpart of kafka_ps_tpu/cli/server_runner.py):
the reference's ServerAppRunner flags, same names and defaults.

With `--listen PORT` the process hosts ONLY the server (aggregator +
consistency gate + producer) and serves remote worker processes over
the socket transport (cli/socket_mode.py).  Without it, it hosts the
whole system in process (cli/run.py's trainer) with the worker-side
knobs at their reference defaults.  Runs on the CUDA card unless
KPS_PLATFORM=cpu.

    python -m kafka_ps_tpu_torch.cli.server_runner --listen 0 \\
        -training train.csv -test test.csv -c 2 --max_iterations 400 -l

`--shards N --shard-id I` makes a `--listen` server shard I of a
range-sharded group (cli/socket_mode.run_server_shard, one process per
shard; workers --connect to all N).  `--bsp-order` applies each -c 0
round in worker-id order, as an aggregation relay's composites are.
`--listen P --serve` also answers predictions on P (not on a shard);
`--serve-replica --durable-log DIR` is a read replica
(cli/socket_mode.run_replica) that answers them on `--serve_port`.
"""

from __future__ import annotations

import argparse

from kafka_ps_tpu_torch.cli import run as run_mod


def build_parser() -> argparse.ArgumentParser:
    """The server-role flag surface: the JAX runner's flags."""
    parser = run_mod.build_parser(include_server_flags=True,
                                  include_worker_flags=False,
                                  prog="ServerAppRunner")
    parser.add_argument(
        "--listen", type=int, default=None, metavar="PORT",
        help="split deployment: host ONLY the server and serve remote "
             "worker processes over the socket transport "
             "(cli/socket_mode.py; 0 = ephemeral port, printed to stderr)")
    parser.add_argument("--connect_timeout", type=float, default=60.0,
                        help="--listen: seconds to wait for all workers")
    parser.add_argument(
        "--shards", type=int, default=1, metavar="N",
        help="--listen: total server shards of a range-sharded deployment: "
             "run N of these processes, one per --shard-id, each owning a "
             "contiguous key range of theta with its own gate, checkpoint "
             "file and durable-log directory; workers --connect to all N")
    parser.add_argument(
        "--shard-id", dest="shard_id", type=int, default=0, metavar="I",
        help="--shards: this process's shard index in [0, N); shard 0 "
             "also hosts the stream producer")
    parser.add_argument(
        "--bsp-order", dest="bsp_order", action="store_true",
        help="--listen + -c 0: buffer each BSP round and apply it in "
             "worker-id order, which makes an aggregated run bitwise "
             "comparable with a direct one")
    parser.add_argument(
        "--serve-replica", dest="serve_replica", action="store_true",
        help="read-replica serving process: follow --durable-log DIR "
             "read-only and answer PREDICT frames on --serve_port, never "
             "joining the training fabric; against a --shards N "
             "deployment's per-shard logs it serves the assembled theta "
             "stamped with the frontier clock")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    run_mod.refuse_telemetry_flags(args)
    # worker-side defaults (WorkerAppRunner.java:55-58)
    args = argparse.Namespace(min_buffer_size=128, max_buffer_size=1024,
                              buffer_size_coefficient=0.3, **vars(args))
    if args.shards < 1 or not 0 <= args.shard_id < args.shards:
        raise SystemExit(
            f"--shard-id {args.shard_id} must be in [0, --shards "
            f"{args.shards}) and --shards must be >= 1")
    if args.shards > 1 and args.listen is None:
        raise SystemExit("--shards N > 1 requires --listen (one shard "
                         "server process per port); in process, sharding "
                         "is the runtime.sharding.ShardedServerGroup API")
    if args.serve_replica:
        if args.listen is not None:
            raise SystemExit("--serve-replica is a standalone serving "
                             "process; drop --listen (the replica only "
                             "follows --durable-log, it never hosts the "
                             "training fabric)")
        from kafka_ps_tpu_torch.cli import socket_mode
        return socket_mode.run_replica(args)
    if args.listen is not None:
        if args.shards > 1:
            # each shard process owns a durable-log directory, replayed
            # on restart
            from kafka_ps_tpu_torch.cli import socket_mode
            return socket_mode.run_server_shard(args)
        if args.durable_log:
            # the socket split has its own durability story (--checkpoint
            # + per-worker state files); the commit log is the
            # in-process fabric's
            raise SystemExit(
                "--durable-log applies to the in-process fabric; in "
                "--listen split mode use --checkpoint instead (or "
                "--shards N > 1, whose shard processes each own a "
                "durable-log directory)")
        from kafka_ps_tpu_torch.cli import socket_mode
        return socket_mode.run_server(args)
    return run_mod.run_with_args(args)


if __name__ == "__main__":
    raise SystemExit(main())
