"""CLI for the offline evaluation subsystem (counterpart of
kafka_ps_tpu/evaluation/__main__.py: the same commands, flags, output and
exit codes).

  python -m kafka_ps_tpu_torch.evaluation summarize --server logs-server.csv
      [--worker logs-worker.csv]
  python -m kafka_ps_tpu_torch.evaluation plot      --server logs-server.csv [--worker ...] --out run.png
  python -m kafka_ps_tpu_torch.evaluation compare   --runs name=path [name=path ...] --out cmp.png
  python -m kafka_ps_tpu_torch.evaluation validate  --worker logs-worker.csv
      [--server ...] -c K [--elastic]
  python -m kafka_ps_tpu_torch.evaluation ground-truth --train train.csv --test test.csv

Replaces the reference's three Jupyter notebooks with scriptable
equivalents over the same CSV log schema.  Every command needs pandas;
`plot` and `compare --out` need matplotlib, `ground-truth` sklearn (its
fit runs on the card unless KPS_PLATFORM=cpu).
"""

from __future__ import annotations

import argparse
import json
import sys


def _parse_runs(pairs: list[str]) -> dict[str, str]:
    out = {}
    for p in pairs:
        name, _, path = p.partition("=")
        if not path:
            raise SystemExit(f"--runs entries must be name=path, got {p!r}")
        out[name] = path
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kafka_ps_tpu_torch.evaluation")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("summarize")
    s.add_argument("--server", required=True)
    s.add_argument("--worker")

    s = sub.add_parser("plot")
    s.add_argument("--server", required=True)
    s.add_argument("--worker")
    s.add_argument("--out", required=True)
    s.add_argument("--spread-out", help="also plot worker clock spread")

    s = sub.add_parser("compare")
    s.add_argument("--runs", nargs="+", required=True, metavar="name=path")
    s.add_argument("--out")
    s.add_argument("--x", default="seconds", choices=["seconds", "vectorClock"])

    s = sub.add_parser("validate")
    s.add_argument("--worker")
    s.add_argument("--server")
    s.add_argument("-c", "--consistency_model", type=int, default=0)
    s.add_argument("--elastic", action="store_true",
                   help="run used failure_policy=rebalance; with "
                        "--events the full contract is re-derived per "
                        "membership epoch, without it only clock "
                        "monotonicity is checked")
    s.add_argument("--events", metavar="logs-events.csv",
                   help="the server's membership-change record "
                        "(timestamp;event;partition) — written by split-"
                        "mode runs with -l (cli/socket_mode.py)")

    s = sub.add_parser("ground-truth")
    s.add_argument("--train", required=True)
    s.add_argument("--test", required=True)
    s.add_argument("--steps", type=int, default=500)
    s.add_argument("--lr", type=float, default=0.5)
    s.add_argument("--num_classes", type=int,
                   help="default: inferred as max label in the data")

    args = ap.parse_args(argv)

    from kafka_ps_tpu_torch.evaluation import logs as logs_mod

    if args.cmd == "summarize":
        sdf = logs_mod.load_server_log(args.server)
        wdf = logs_mod.load_worker_log(args.worker) if args.worker else None
        print(json.dumps(logs_mod.summarize_run(sdf, wdf).row(), indent=2))
    elif args.cmd == "plot":
        from kafka_ps_tpu_torch.evaluation import plots
        if args.spread_out and not args.worker:
            raise SystemExit("--spread-out requires --worker")
        print(plots.plot_run(args.server, args.worker, args.out))
        if args.spread_out:
            print(plots.plot_clock_spread(args.worker, args.spread_out))
    elif args.cmd == "compare":
        from kafka_ps_tpu_torch.evaluation import plots
        runs = _parse_runs(args.runs)
        table = plots.comparison_table(runs)
        print(table.to_string(index=False))
        if args.out:
            print(plots.plot_comparison(runs, args.out, x=args.x))
    elif args.cmd == "validate":
        from kafka_ps_tpu_torch.evaluation import validate
        if not args.worker and not args.server:
            raise SystemExit("validate needs --worker and/or --server")
        wdf = logs_mod.load_worker_log(args.worker) if args.worker else None
        sdf = logs_mod.load_server_log(args.server) if args.server else None
        events = (validate.load_membership_events(args.events)
                  if args.events else None)
        violations = validate.validate_run(wdf, sdf, args.consistency_model,
                                           elastic=args.elastic or
                                           bool(events),
                                           membership_events=events)
        for v in violations:
            print(f"VIOLATION [{v.rule}] {v.detail}")
        print(f"{len(violations)} violation(s)")
        return 1 if violations else 0
    elif args.cmd == "ground-truth":
        from kafka_ps_tpu_torch.data.stream import load_csv_dataset
        from kafka_ps_tpu_torch.evaluation import ground_truth
        from kafka_ps_tpu_torch.utils.config import ModelConfig
        train_x, train_y = load_csv_dataset(args.train)
        test_x, test_y = load_csv_dataset(args.test)
        # rows span 0..max_label (the reference's Spark sizing,
        # LogisticRegressionTaskSpark.java:98-104), so num_classes must
        # cover the data or out-of-range labels silently NaN the loss
        num_classes = args.num_classes or int(max(train_y.max(),
                                                  test_y.max()))
        cfg = ModelConfig(num_features=train_x.shape[1],
                          num_classes=num_classes)
        gt = ground_truth.compute(train_x, train_y, test_x, test_y, cfg,
                                  steps=args.steps, learning_rate=args.lr)
        print(json.dumps({"f1": round(gt.f1, 4),
                          "accuracy": round(gt.accuracy, 4),
                          "loss": round(gt.loss, 4)}, indent=2))
        print(gt.report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
