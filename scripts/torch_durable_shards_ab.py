"""Same-call A/B of a `--shards 2 --durable-log` deployment across checkouts
of the repo, on one NVIDIA card: what logging the weights a shard sends
costs its training rate.

    python3 scripts/torch_durable_shards_ab.py TREE [TREE ...]

Each TREE is the root of a checkout that holds kafka_ps_tpu_torch/ (for
example a `git archive` of a commit unpacked under an ignored directory).
First every tree's kernels are built, one process per tree, all started
together.  Then the trees are measured one after another, each in a
process of its own, in the order given: list them as A B B A so that drift
of the card cancels.

Per tree, four runs of chip_smoke.py's `scaleout_run` (this checkout's
driver; the tree's server_runner and worker_runner processes, two shards
and two worker processes of two workers, F=1024, C=5, buffer 1024, k=2):
  * `kill`: logreg -c 2, 200 iterations, shard 1 killed by SIGKILL and
    restarted, its log replayed (chip_smoke.py's scale-out kill run);
  * `durable logreg`: logreg -c 0, 200 iterations, --durable-log (the
    serving phase's shards run, without its replica);
  * `durable mlp H=128`: the MLP at H=128, -c -1, 100 iterations;
  * `durable mlp H=4096`: the MLP at H=4096, -c -1, 40 iterations.
Each prints one JSON line: the slower shard's iterations/s from the first
worker row (`rate`), the workers' iterations/s past the first round
(`steady`), and per shard its log's bytes by topic, fsyncs, fsync ms (total
and the longest) and serde ms per encoded frame by topic (`shard_logs`,
from the shard's stats line; a killed shard's from its restart).  The
runs' own output goes to chiprun_out/durable_ab/, and their logs are
deleted after each run.  Last, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "chiprun_out", "durable_ab")


def build_one(tree: str) -> None:
    sys.path.insert(0, tree)
    from kafka_ps_tpu_torch.ops import _build
    _build.build(_build.sources())


def measure_one(tree: str, label: str) -> None:
    # the tree's package in this process (the in-process checks of
    # scaleout_run) and in the processes it starts
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, tree)
    cs.REPO = tree
    cs.OUT = os.path.join(OUT, "work")
    shutil.rmtree(cs.OUT, ignore_errors=True)
    cs.write_data()
    runs = [("kill", dict(topology="shards", task="logreg", c=2,
                          iters=cs.SCALE_ITERS, kill=True)),
            ("durable logreg", dict(topology="shards", task="logreg", c=0,
                                    iters=cs.SCALE_ITERS, durable=True)),
            ("durable mlp H=128", dict(topology="shards", task="mlp", c=-1,
                                       iters=cs.SCALE_SHORT, durable=True)),
            ("durable mlp H=4096", dict(topology="shards", task="mlp", c=-1,
                                        iters=cs.SCALE_WIDE,
                                        hidden=cs.WIDE_H, durable=True))]
    keys = ("bytes", "fsyncs", "fsync_ms", "fsync_ms_max",
            "serde_ms_per_frame")
    for name, kw in runs:
        r = cs.scaleout_run(**kw)
        logs = []
        for entry in sorted(os.listdir(cs.OUT)):
            if not entry.startswith("scale-"):
                continue
            base = os.path.join(cs.OUT, entry)
            for shard in ("s0", "s1"):
                err = os.path.join(base, shard, "err-restart.txt")
                if not os.path.exists(err):
                    err = os.path.join(base, shard, "err.txt")
                durable = cs._role_stats(err, "server")["durable"]
                logs.append({k: durable[k] for k in keys})
            # the logs and checkpoints of a run (1.3 GB at H=4096)
            shutil.rmtree(base)
        print(json.dumps({"tree": label, "run": name, "rate": r["rate"],
                          "steady": r["steady"], "shard_logs": logs}),
              flush=True)
    shutil.rmtree(cs.OUT, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--build-one", help=argparse.SUPPRESS)
    ap.add_argument("--measure-one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.build_one:
        build_one(args.build_one)
        return 0
    if args.measure_one:
        measure_one(args.measure_one, args.trees[0])
        return 0
    me = os.path.abspath(__file__)
    trees = [os.path.abspath(t) for t in args.trees]
    builds = [subprocess.Popen([sys.executable, me, "-", "--build-one", t])
              for t in dict.fromkeys(trees)]
    if any(p.wait() != 0 for p in builds):
        raise SystemExit("a tree's kernels failed to build")
    os.makedirs(OUT, exist_ok=True)
    for i, (label, tree) in enumerate(zip(args.trees, trees)):
        log = os.path.join(OUT, f"{i}-{os.path.basename(tree)}.txt")
        with open(log, "w") as f:
            proc = subprocess.run(
                [sys.executable, me, label, "--measure-one", tree],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                timeout=900)
            f.write(proc.stdout)
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
        if proc.returncode:
            print(proc.stdout[-3000:])
            raise SystemExit(f"{label}: exited {proc.returncode} ({log})")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
