"""Same-call A/B of the port's kernels across checkouts of the repo, on one
NVIDIA card: K1 and K2 (logreg, f32), K3 (logreg, bf16 and int8 slabs),
K4 and K6 (MLP, f32) and K5 (MLP, bf16 and int8 slabs), each where a tree
has it, and K4 and K6 again at the wide MLP's width (H=4096).

    python3 scripts/torch_kernel_ab.py TREE [TREE ...] [--wide-hidden H ...]

Each TREE is the root of a checkout that holds kafka_ps_tpu_torch/ (for
example a `git archive` of a commit unpacked under an ignored directory).
First every tree's kernels are built, one process per tree, all started
together.  Then the trees are measured one after another, each in a
process of its own (they hold packages of the same name), in the order
given: list them as A B B A so that drift of the card cancels.

Per tree and kernel, at the main path's shape (F=1024, B=1024 with 100
masked rows and one out-of-range label, C=5, k=2; the MLP at H=128; K2
and K6 on a gang of 4; then K4 and K6 at H=4096, K6's 4 members sharing
one theta as in a fused round, and at each other width `--wide-hidden`
names, such as H=1024, where a K4 update pass has one tile an SM), on
inputs made from one seed per member:
  * `digest`: sha256 of the outputs' bytes (delta and loss) — trees with
    the same arithmetic agree bit for bit;
  * `max_abs_vs_plain`: the largest difference of the outputs from the
    plain version's on the same inputs (TF32 off), for trees whose
    arithmetic differs by design (every kernel reports it);
  * `ms`: median of 200 calls, each between a pair of CUDA events (with
    the card idle, this is mostly the host's time to launch);
  * `host_us`: mean host time of one wrapper call, 200 calls queued
    without a sync;
  * `device_ms` and `per_kernel`: the kernels' device time per call from
    torch.profiler, in total and by pass;
  * `sass`: per pass the call ran, the count of instructions, of
    tensor-core instructions (HMMA from mma.sync, HGMMA from wgmma), of
    scalar f32 FMAs (FFMA) and of loads by kind (LDG.E.CONSTANT is the
    read-only path, LDGSTS is cp.async), from `cuobjdump -sass` of the
    tree's built library.
A pass is named `name[form,R,loss]`: its storage form (f32, bf16, int8)
and, where it is templated on them, the class count R and the row pass's
loss flag; only the C=5 (R=6) instances are reported.
One JSON line per tree and kernel, a summary line per tree and kernel
(device ms, host us, ms per call, launches per call), then one line per
kernel saying whether every tree gave it the same digest, then the card's
name and power limit.
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
WIDE_H = 4096                      # the fused MLP path's hidden width
# the wide passes' names first: "hidden_pass" is in "wide_hidden_pass"
KERNEL_RE = re.compile(r"(logreg_update|wide_hidden_pass|wide_update_pass|"
                       r"grad_rows|grad_cols|split_pass|transpose_pass|"
                       r"row_pass|apply_pass|loss_pass|loss_reduce|"
                       r"hidden_pass|update_pass)")
# storage forms as they appear in a pass's template arguments, mangled or
# demangled; the longer names first ("Members" is in "MembersQ")
FORMS = (("SlabBf16", "bf16"), ("MembersBf16", "bf16"), ("SlabQ", "int8"),
         ("MembersQ", "int8"), ("SlabF32", "f32"), ("Members", "f32"))
CLASSES = re.compile(r"Li(\d+)E|[<,] ?(\d+)[,>]")
LOSS = re.compile(r"Lb([01])E|, (true|false)>")
COUNTED = ("HMMA", "HGMMA", "FFMA", "F2F", "I2F", "LDG", "LDS", "LDGSTS")


def short_name(name: str) -> str | None:
    """`row_pass[f32,6,loss]` for a mangled or demangled kernel name; None
    for a name that is not a pass or an instance of another class count
    than C+1."""
    m = KERNEL_RE.search(name)
    if m is None:
        return None
    rest = name[m.end():]
    form = next((f for key, f in FORMS if key in rest), None)
    r = CLASSES.search(rest)
    r = r and (r.group(1) or r.group(2))
    if r and r != str(C + 1):
        return None
    loss = LOSS.search(rest)
    tags = [form, r, loss and ("loss" if loss.group(1) == "1"
                               or loss.group(2) == "true" else None)]
    tags = [t for t in tags if t]
    return m.group(1) + (f"[{','.join(tags)}]" if tags else "")


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
        for kind in COUNTED:
            if op.split(".")[0] == kind or (kind == "LDG"
                                            and op.startswith("LDG.")):
                key = op if kind == "LDG" else kind
                c[key] = c.get(key, 0) + 1
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


def measure(torch, fn, plain, sass, reps=200) -> dict:
    from torch.profiler import ProfilerActivity, profile
    delta, loss = fn()
    torch.cuda.synchronize()
    digest = hashlib.sha256(delta.cpu().numpy().tobytes()
                            + loss.reshape(-1).cpu().numpy().tobytes())
    ref = plain()
    err = max(float((delta - ref[0]).abs().max()),
              float((loss - ref[1]).abs().max()))
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
    per, launches = {}, 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            key = short_name(e.key) or e.key[:40]
            per[key] = per.get(key, 0.0) + us / 50 / 1e3
            launches += e.count
    out = {"digest": digest.hexdigest()[:16], "ms": statistics.median(times),
           "host_us": host_us, "device_ms": sum(per.values()),
           "launches_per_call": launches / 50, "max_abs_vs_plain": err,
           "per_kernel": per,
           "sass": sass and {k: v for k, v in sass.items() if k in per}}
    return out


def build_one(tree: str) -> None:
    sys.path.insert(0, tree)
    from kafka_ps_tpu_torch.ops import _build
    _build.build(_build.sources())


def measure_one(tree: str, label: str, widths=(WIDE_H,)) -> None:
    sys.path.insert(0, tree)
    import torch

    from kafka_ps_tpu_torch.ops import _build
    from kafka_ps_tpu_torch.ops import fused_update as fu
    from kafka_ps_tpu_torch.utils.config import ModelConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = ModelConfig(num_features=F, num_classes=C, num_max_iter=K,
                      local_learning_rate=0.5)
    lib = sass_counts(_build._target("local_update.cu")[1])
    gang = [inputs(torch, dev, cfg.num_params, 7 + i) for i in range(4)]
    members = [list(a) for a in zip(*gang)]
    runs = [("K1 local_update", lib,
             lambda: fu.local_update(*gang[0], cfg=cfg),
             lambda: fu.local_update_plain(*gang[0], cfg=cfg))]
    if hasattr(fu, "local_update_batched"):
        runs.append(("K2 local_update_batched", lib,
                     lambda: fu.local_update_batched(*members, cfg=cfg),
                     lambda: fu.local_update_batched_plain(*members,
                                                           cfg=cfg)))
    try:
        from kafka_ps_tpu_torch.compress.slab import encode_x
    except ImportError:            # a tree from before the slab dtypes
        encode_x = None
    for kind in ("bf16", "int8") if encode_x else ():
        a = [gang[0][0], encode_x(kind, gang[0][1]), *gang[0][2:]]
        runs.append((f"K3 stream_update {kind}", lib,
                     lambda a=a: fu.local_update(*a, cfg=cfg),
                     lambda a=a: fu.local_update_plain(*a, cfg=cfg)))
    if "mlp_update.cu" in _build.sources():
        from kafka_ps_tpu_torch.models import mlp
        mcfg = ModelConfig(num_features=F, num_classes=C, num_max_iter=K,
                           local_learning_rate=0.5, hidden_dim=H)
        base = mlp.init_params(mcfg, "cpu").numpy()
        mgang = [inputs(torch, dev, mlp.num_params(mcfg), 17 + i, base)
                 for i in range(4)]
        mm = [list(a) for a in zip(*mgang)]
        mlib = sass_counts(_build._target("mlp_update.cu")[1])
        runs += [("K4 mlp_local_update", mlib,
                  lambda: fu.mlp_local_update(*mgang[0], cfg=mcfg),
                  lambda: fu.mlp_local_update_plain(*mgang[0], cfg=mcfg)),
                 ("K6 mlp_local_update_batched", mlib,
                  lambda: fu.mlp_local_update_batched(*mm, cfg=mcfg),
                  lambda: fu.mlp_local_update_batched_plain(*mm, cfg=mcfg))]
        for kind in ("bf16", "int8") if encode_x else ():
            a = [mgang[0][0], encode_x(kind, mgang[0][1]), *mgang[0][2:]]
            runs.append((f"K5 mlp_stream_update {kind}", mlib,
                         lambda a=a: fu.mlp_local_update(*a, cfg=mcfg),
                         lambda a=a: fu.mlp_local_update_plain(*a,
                                                               cfg=mcfg)))
        for wh in widths:
            wcfg = ModelConfig(num_features=F, num_classes=C,
                               num_max_iter=K, local_learning_rate=0.5,
                               hidden_dim=wh)
            wbase = mlp.init_params(wcfg, "cpu").numpy()
            wgang = [inputs(torch, dev, mlp.num_params(wcfg), 51 + i,
                            wbase) for i in range(4)]
            wm = [[wgang[0][0]] * 4] + [[g[i] for g in wgang]
                                        for i in (1, 2, 3)]
            runs += [(f"K4 mlp_local_update H={wh}", mlib,
                      lambda g=wgang[0], c=wcfg: fu.mlp_local_update(
                          *g, cfg=c),
                      lambda g=wgang[0], c=wcfg: fu.mlp_local_update_plain(
                          *g, cfg=c)),
                     (f"K6 mlp_local_update_batched H={wh} (one theta)",
                      mlib, lambda m=wm, c=wcfg:
                      fu.mlp_local_update_batched(*m, cfg=c),
                      lambda m=wm, c=wcfg:
                      fu.mlp_local_update_batched_plain(*m, cfg=c))]
    for kernel, sass, fn, plain in runs:
        m = measure(torch, fn, plain, sass)
        print(json.dumps({"tree": label, "kernel": kernel, **m}))
        print(f"summary {label} {kernel}: device_ms={m['device_ms']:.5f} "
              f"host_us={m['host_us']:.1f} ms={m['ms']:.5f} launches="
              f"{m['launches_per_call']:g} digest={m['digest']} "
              f"max_abs_vs_plain={m['max_abs_vs_plain']:.3e}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--build-one", help=argparse.SUPPRESS)
    ap.add_argument("--measure-one", help=argparse.SUPPRESS)
    ap.add_argument("--wide-hidden", type=int, nargs="+", default=[WIDE_H],
                    help="the hidden widths of the wide K4 and K6 runs")
    args = ap.parse_args(argv)
    if args.build_one:
        build_one(args.build_one)
        return 0
    if args.measure_one:
        measure_one(args.measure_one, args.trees[0], args.wide_hidden)
        return 0
    widths = ["--wide-hidden", *map(str, args.wide_hidden)]
    me = os.path.abspath(__file__)
    trees = [os.path.abspath(t) for t in args.trees]
    builds = [subprocess.Popen([sys.executable, me, "-", "--build-one", t])
              for t in dict.fromkeys(trees)]
    if any(p.wait() != 0 for p in builds):
        raise SystemExit("a tree's kernels failed to build")
    digests: dict[str, set] = {}
    for label, tree in zip(args.trees, trees):
        out = subprocess.run([sys.executable, me, label, "--measure-one",
                              tree, *widths], check=True, timeout=900,
                             capture_output=True, text=True).stdout
        print(out, end="", flush=True)
        for line in out.splitlines():
            if line.startswith("{"):
                row = json.loads(line)
                digests.setdefault(row["kernel"], set()).add(row["digest"])
    for kernel, seen in digests.items():
        print(f"digest {kernel}: the same in every tree: {len(seen) == 1}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
