"""`python -m kafka_ps_tpu_torch.telemetry` — telemetry CLI.

Subcommands:
  merge -o OUT in1.json in2.json ...
      Stitch per-process --trace files from a socket-mode run into one
      Chrome/Perfetto trace.
  postmortem DIR
      Merge the flight dumps (flightdump-<pid>.json, --flight-dir) a
      multi-process run left behind and name the culprit: dead shards,
      the last (worker, clock) each dead shard acknowledged, watchdog
      trips, gate-stall evidence.
  critpath TRACE
      Decompose each delta's end-to-end latency into named segments
      (buffer wait / local train / wire / apply / gate wait / publish /
      serving read) and report p50/p99 + the dominant segment per
      consistency model.  TRACE is a `merge` output or a single --trace dump.
"""

from __future__ import annotations

import argparse
import sys

from kafka_ps_tpu_torch.telemetry.critpath import critpath_main
from kafka_ps_tpu_torch.telemetry.merge import merge_traces
from kafka_ps_tpu_torch.telemetry.postmortem import main as postmortem_main


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="kafka_ps_tpu_torch.telemetry")
    sub = parser.add_subparsers(dest="cmd", required=True)
    merge = sub.add_parser(
        "merge", help="stitch per-process trace files into one timeline")
    merge.add_argument("-o", "--out", required=True,
                       help="merged Chrome trace output path")
    merge.add_argument("inputs", nargs="+",
                       help="per-process trace files (Tracer.dump output)")
    post = sub.add_parser(
        "postmortem",
        help="analyze a directory of flight dumps and name the culprit")
    post.add_argument("dir", help="directory holding flightdump-*.json "
                                  "(the run's --flight-dir)")
    crit = sub.add_parser(
        "critpath",
        help="per-flow latency decomposition with a dominant-segment "
             "verdict per consistency model")
    crit.add_argument("trace", help="merged trace (telemetry merge "
                                    "output) or a single --trace dump")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "merge":
        stats = merge_traces(args.inputs, args.out)
        print(f"merged {stats['files']} files / {stats['events']} events "
              f"-> {args.out} (pids {stats['pids']}, "
              f"{stats['cross_process_flows']} cross-process flows)")
        return 0
    if args.cmd == "postmortem":
        return postmortem_main(args.dir)
    if args.cmd == "critpath":
        return critpath_main(args.trace)
    return 2


if __name__ == "__main__":
    sys.exit(main())
