"""Same-call A/B of the port's f32 kernels K1 and K2 (and K4 and K6 where
a tree has them) across checkouts of the repo, on one NVIDIA card.

    python3 scripts/torch_kernel_ab.py TREE [TREE ...]

Each TREE is the root of a checkout that holds kafka_ps_tpu_torch/ (for
example a `git archive` of a commit unpacked under an ignored directory).
First every tree's kernels are built, one process per tree, all started
together.  Then the trees are measured one after another, each in a
process of its own (they hold packages of the same name), in the order
given: list them as A B B A so that drift of the card cancels.

Per tree and kernel, at the main path's shape (F=1024, B=1024 with 100
masked rows and one out-of-range label, C=5, k=2; the MLP at H=128; K2
and K6 on a gang of 4), on inputs made from one seed per member:
  * `digest`: sha256 of the outputs' bytes (delta and loss) — trees with
    the same arithmetic agree bit for bit;
  * `ms`: median of 200 calls, each between a pair of CUDA events (with
    the card idle, this is mostly the host's time to launch);
  * `host_us`: mean host time of one wrapper call, 200 calls queued
    without a sync;
  * `device_ms` and `per_kernel`: the kernels' device time per call from
    torch.profiler, in total and by kernel;
  * `sass`: per kernel of the C=5 f32 instance, the count of
    instructions and of global loads by kind (LDG.E.CONSTANT is the
    read-only path), from `cuobjdump -sass` of the tree's built library
    (a tree whose kernels are templated on the slab's storage form
    reports its f32 instances).
One JSON line per tree and kernel, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

F, C, B, K, H, MASKED = 1024, 5, 1024, 2, 128, 100
KERNEL_RE = re.compile(r"(row_pass|apply_pass|loss_pass|loss_reduce|"
                       r"dw1_pass|tail_apply)")
# the class count R of a pass's template arguments, mangled or demangled,
# with or without the f32 storage form ahead of it
TEMPLATE_R = re.compile(r"<(?:kps::SlabF32, )?(\d+)>|"
                        r"I(?:N3kps7SlabF32E)?Li(\d+)E")
OTHER_FORM = re.compile(r"SlabBf16|SlabQ|MembersBf16|MembersQ")


def short_name(name: str) -> str | None:
    """`row_pass<6>` for a mangled or demangled kernel name of the C=5
    f32 instance or a pass without a class count; None for other
    instances and storage forms."""
    m = KERNEL_RE.search(name)
    if m is None:
        return None
    rest = name[m.end():]
    if OTHER_FORM.search(rest):
        return None
    t = TEMPLATE_R.match(rest)
    r = t and (t.group(1) or t.group(2))
    if r and r != str(C + 1):
        return None
    return m.group(1) + (f"<{r}>" if r else "")


def sass_counts(lib: str) -> dict | None:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    counts: dict[str, dict[str, int]] = {}
    cur = None
    for line in out.splitlines():
        if "Function :" in line:
            cur = short_name(line.split("Function :", 1)[1].strip())
            if cur is not None:
                counts[cur] = {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if cur is None or m is None:
            continue
        op = m.group(1)
        c = counts[cur]
        c["instructions"] = c.get("instructions", 0) + 1
        if op.startswith(("LDG", "LDC", "LDL", "STL")):
            c[op] = c.get(op, 0) + 1
    return counts


def inputs(torch, dev, num_params, seed, base=None):
    import numpy as np
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, F)).astype(np.float32)
    y = rng.integers(0, C, size=B).astype(np.int32)
    y[3] = C + 2
    mask = (np.arange(B) < B - MASKED).astype(np.float32)
    theta = rng.normal(scale=0.01, size=num_params).astype(np.float32)
    if base is not None:
        theta = (theta + base).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (theta, x, y, mask)]


def measure(torch, fn, lib, reps=200) -> dict:
    from torch.profiler import ProfilerActivity, profile
    delta, loss = fn()
    torch.cuda.synchronize()
    digest = hashlib.sha256(delta.cpu().numpy().tobytes()
                            + loss.reshape(-1).cpu().numpy().tobytes())
    for _ in range(20):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            key = short_name(e.key) or e.key[:40]
            per[key] = per.get(key, 0.0) + us / 50 / 1e3
    return {"digest": digest.hexdigest()[:16],
            "ms": statistics.median(times), "host_us": host_us,
            "device_ms": sum(per.values()), "per_kernel": per,
            "sass": sass_counts(lib)}


def build_one(tree: str) -> None:
    sys.path.insert(0, tree)
    from kafka_ps_tpu_torch.ops import _build
    _build.build(_build.sources())


def measure_one(tree: str, label: str) -> None:
    sys.path.insert(0, tree)
    import torch

    from kafka_ps_tpu_torch.ops import _build
    from kafka_ps_tpu_torch.ops import fused_update as fu
    from kafka_ps_tpu_torch.utils.config import ModelConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = ModelConfig(num_features=F, num_classes=C, num_max_iter=K,
                      local_learning_rate=0.5)
    lib = _build._target("local_update.cu")[1]
    gang = [inputs(torch, dev, cfg.num_params, 7 + i) for i in range(4)]
    members = [list(a) for a in zip(*gang)]
    runs = [("K1 local_update", lib,
             lambda: fu.local_update(*gang[0], cfg=cfg))]
    if hasattr(fu, "local_update_batched"):
        runs.append(("K2 local_update_batched", lib,
                     lambda: fu.local_update_batched(*members, cfg=cfg)))
    if "mlp_update.cu" in _build.sources():
        from kafka_ps_tpu_torch.models import mlp
        mcfg = ModelConfig(num_features=F, num_classes=C, num_max_iter=K,
                           local_learning_rate=0.5, hidden_dim=H)
        base = mlp.init_params(mcfg, "cpu").numpy()
        mgang = [inputs(torch, dev, mlp.num_params(mcfg), 17 + i, base)
                 for i in range(4)]
        mmembers = [list(a) for a in zip(*mgang)]
        mlib = _build._target("mlp_update.cu")[1]
        runs += [("K4 mlp_local_update", mlib,
                  lambda: fu.mlp_local_update(*mgang[0], cfg=mcfg)),
                 ("K6 mlp_local_update_batched", mlib,
                  lambda: fu.mlp_local_update_batched(*mmembers, cfg=mcfg))]
    for kernel, path, fn in runs:
        print(json.dumps({"tree": label, "kernel": kernel,
                          **measure(torch, fn, path)}))


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
    for label, tree in zip(args.trees, trees):
        subprocess.run([sys.executable, me, label, "--measure-one", tree],
                       check=True, timeout=600)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
