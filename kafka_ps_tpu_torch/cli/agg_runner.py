"""Aggregator-relay entry point (counterpart of
kafka_ps_tpu/cli/agg_runner.py): one relay per host pre-reduces that
host's workers, so the server's gate sees one connection per host.

    python -m kafka_ps_tpu_torch.cli.agg_runner --connect hostA:8477 \\
        --listen 8478 --agg-id 0 --worker_ids 0,1,2,3

Member worker processes then dial THIS process with
`worker_runner --aggregate host:8478`.  Runs on the CUDA card unless
KPS_PLATFORM=cpu (agg/relay.py, cli/socket_mode.run_aggregator).
"""

from __future__ import annotations

import argparse

from kafka_ps_tpu_torch.cli import run as run_mod


def build_parser() -> argparse.ArgumentParser:
    """The aggregator-role flags, the JAX runner's."""
    parser = run_mod.build_parser(include_server_flags=False,
                                  include_worker_flags=False,
                                  prog="AggregatorRunner")
    parser.add_argument(
        "--connect", required=True, metavar="HOST:PORT",
        help="the upstream server this relay forwards composites to; the "
             "relay HELLOs there as an aggregator for --worker_ids")
    parser.add_argument(
        "--listen", type=int, default=0, metavar="PORT",
        help="the port the member worker processes dial (--aggregate "
             "host:PORT); 0 = ephemeral, printed to stderr")
    parser.add_argument(
        "--agg-id", dest="agg_id", type=int, default=0, metavar="I",
        help="this relay's id, stamped on its composites")
    parser.add_argument("--worker_ids", default="0",
                        help="comma-separated logical worker ids this "
                             "relay aggregates for (its members)")
    parser.add_argument(
        "--summed", action="store_true",
        help="add the members of a single-clock flush into ONE delta per "
             "composite (exact by linearity under BSP, not bitwise the "
             "direct path; the default stacked mode is)")
    parser.add_argument(
        "--flush-interval", dest="flush_interval", type=float,
        default=0.002, metavar="SECONDS",
        help="most quiet time before a partial round goes upstream (a "
             "full round, every member pending, goes at once)")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    run_mod.refuse_telemetry_flags(args)
    from kafka_ps_tpu_torch.cli import socket_mode
    return socket_mode.run_aggregator(args)


if __name__ == "__main__":
    raise SystemExit(main())
