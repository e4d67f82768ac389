"""Same-call A/B of the threaded trainer's rate across checkouts of the
repo, on one NVIDIA card: what the lock-order recorder's OrderedLock costs
at the port's lock sites when no recorder is installed.

    python3 scripts/torch_lock_ab.py TREE [TREE ...] [--repeats N]

Each TREE is the root of a checkout that holds kafka_ps_tpu_torch/ (for
example a `git archive` of a commit unpacked under an ignored directory).
First every tree's kernels are built, one process per tree, all started
together.  Then the trees are measured one after another, each in a
process of its own, in the order given: list them as A B B A so that drift
of the card cancels.

Per tree, `--repeats` rounds (3 by default) of three runs through
chip_smoke.py's `main_path_run` (this checkout's driver, the tree's
cli.run in the measuring process: F=1024, C=5, 4 workers, buffer 1024,
k=2, the default flags, so gang dispatch and async eval on):
  * `threaded -c 2`: logreg, threaded -c 2, 400 server iterations;
  * `threaded -c -1`: logreg, threaded -c -1, 400 server iterations;
  * `threaded -c 2 durable`: the first with --durable-log and
    --checkpoint (the log's locks on the path: the commit lock, CommitLog
    and LogManager; the checkpoint's commit points), both made anew for
    each run.
Each prints one JSON line: the tree's label, the run, and its server
iterations per second from the first worker CSV row to the return of the
CLI (after the logs are flushed, so the window holds the run's device
work).  The runs' own output goes to chiprun_out/lock_ab/.  Last, the
card's name and power limit.

    python3 scripts/torch_lock_ab.py --micro

prices the locks on this checkout instead: the host microseconds of one
`with lock: pass` for `threading.Lock`, `threading.RLock` and the
recorder's `OrderedLock` (plain and reentrant), with no recorder and with
one installed (median of 7 rounds of 200,000), and the lock acquisitions
per server iteration of the first run above (`threaded -c 2`, 400
iterations) under an installed recorder, with its edges and cycles.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "chiprun_out", "lock_ab")
ITERS = 400
RUNS = (("threaded -c 2", 2, ()),
        ("threaded -c -1", -1, ()),
        ("threaded -c 2 durable", 2, ("--checkpoint", "ck-ab.npz",
                                      "--durable-log", "wal-ab")))


def build_one(tree: str) -> None:
    sys.path.insert(0, tree)
    from kafka_ps_tpu_torch.ops import _build
    _build.build(_build.sources())


def measure_one(tree: str, label: str, repeats: int) -> None:
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, tree)
    cs.REPO = tree
    cs.OUT = os.path.join(OUT, "work")
    shutil.rmtree(cs.OUT, ignore_errors=True)
    cs.write_data()
    for rnd in range(repeats):
        for name, c, flags in RUNS:
            # a fresh log and checkpoint: a run must not resume the last
            shutil.rmtree(os.path.join(cs.OUT, "wal-ab"),
                          ignore_errors=True)
            for stale in ("ck-ab.npz", "ck-ab.npz.tmp.npz"):
                if os.path.exists(os.path.join(cs.OUT, stale)):
                    os.remove(os.path.join(cs.OUT, stale))
            r = cs.main_path_run("logreg", "threaded", c, ITERS, flags)
            print(json.dumps({"tree": label, "round": rnd, "run": name,
                              "rate": r["rate"]}), flush=True)
    shutil.rmtree(cs.OUT, ignore_errors=True)


def micro() -> None:
    import statistics
    import threading
    import time

    sys.path.insert(0, HERE)
    from kafka_ps_tpu_torch.analysis import lockgraph

    def per_with(lock, n=200_000):
        t0 = time.perf_counter()
        for _ in range(n):
            with lock:
                pass
        return (time.perf_counter() - t0) / n * 1e6

    locks = (("threading.Lock", threading.Lock()),
             ("threading.RLock", threading.RLock()),
             ("OrderedLock", lockgraph.OrderedLock("micro.lock")),
             ("OrderedLock reentrant",
              lockgraph.OrderedLock("micro.rlock", reentrant=True)))
    for armed in (False, True):
        with lockgraph.isolated() if armed else _disarmed(lockgraph):
            for name, lock in locks:
                us = statistics.median(per_with(lock) for _ in range(7))
                print(json.dumps({"lock": name, "recorder": armed,
                                  "us_per_with": us}), flush=True)
    import chip_smoke as cs
    cs.OUT = os.path.join(OUT, "work")
    shutil.rmtree(cs.OUT, ignore_errors=True)
    cs.write_data()
    name, c, flags = RUNS[0]
    with lockgraph.isolated() as g:
        r = cs.main_path_run("logreg", "threaded", c, ITERS, flags)
    print(json.dumps({"run": name, "rate_armed": r["rate"],
                      "acquisitions": g.acquisitions,
                      "acquisitions_per_iteration": g.acquisitions / ITERS,
                      "edges": sorted(f"{a} -> {b}" for a, b in g.edges),
                      "cycles": len(g.cycles())}), flush=True)
    shutil.rmtree(cs.OUT, ignore_errors=True)


class _disarmed:
    """No recorder for the block (the one installed, if any, after)."""

    def __init__(self, lockgraph):
        self.lockgraph = lockgraph

    def __enter__(self):
        self.saved = self.lockgraph.current()
        self.lockgraph.disable()

    def __exit__(self, *exc):
        if self.saved is not None:
            self.lockgraph.enable()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--micro", action="store_true")
    ap.add_argument("--build-one", help=argparse.SUPPRESS)
    ap.add_argument("--measure-one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.micro:
        micro()
        return 0
    if args.build_one:
        build_one(args.build_one)
        return 0
    if args.measure_one:
        measure_one(args.measure_one, args.trees[0], args.repeats)
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
                [sys.executable, me, label, "--measure-one", tree,
                 "--repeats", str(args.repeats)],
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
