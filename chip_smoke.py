"""Smoke run of kafka_ps_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

1. Setup: the card's name and power limit, torch and CUDA versions, and
   the build of every CUDA kernel from the sources in the checkout.
2. Kernel phase, at the reference's shapes (F=1024, B=1024 with masked
   rows and one out-of-range label, C=5, k=2): each kernel against its
   plain PyTorch version on the card (TF32 off), two launches bitwise
   equal, and the kernel's median time over CUDA events beside the plain
   version's and the card's bound for the same work.
3. Reference check: a small serial run of the trainer on the card against
   the same run on the CPU (row keys exact, theta within tolerance).
4. Main path, through the real entry point kafka_ps_tpu_torch.cli.run:
   4 workers, buffer max 1024, a synthetic 1024-feature CSV, serial -c 0,
   threaded -c 2 and threaded -c -1.  Launch counters are zeroed before
   each run and read after it; every run must have gone through K1 at
   least once per worker iteration.
5. The `kernels` JSON line, the card line, and last the result line.

Any failed phase raises: the script exits non-zero and prints no result.
It also exits non-zero without a card, and when the package is absent.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out", "smoke")

# NVIDIA H100 SXM data sheet: HBM3 rate and float32 rate outside the
# tensor cores (the kernel does scalar f32 FMA)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
RTOL, ATOL = 1e-4, 1e-6

F, C, B, K = 1024, 5, 1024, 2
WORKERS, MAX_BUFFER, TRAIN_ROWS, TEST_ROWS, ITERS = 4, 1024, 6000, 2000, 400


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def ptxas_summary(log: str) -> str:
    """The ptxas -v lines of the kernels the reference shape runs (R=6
    template instances and the untemplated passes)."""
    keep, out = False, []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = any(k in line for k in ("ILi6E", "apply_pass",
                                           "loss_reduce"))
        if keep:
            out.append(line.strip())
    return "\n".join(out)


def time_ms(fn, warmup=10, reps=100) -> float:
    """Median ms of one call, each call timed with a pair of CUDA
    events."""
    for _ in range(warmup):
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
    return statistics.median(times)


def device_ms(fn, reps=20) -> tuple[float, dict]:
    """Device time per call of the kernels `fn` launches, from a
    torch.profiler trace: (total ms, {kernel name: ms})."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            per[e.key[:60]] = us / reps / 1e3
    return sum(per.values()), per


def kernel_phase(dev):
    from kafka_ps_tpu_torch.data.synth import generate
    from kafka_ps_tpu_torch.ops import fused_update
    from kafka_ps_tpu_torch.utils.config import ModelConfig

    cfg = ModelConfig(num_features=F, num_classes=C, num_max_iter=K,
                      local_learning_rate=0.5)
    x, y = generate(B, F, C, seed=7)
    y[3] = C + 2                                   # out-of-range label
    mask = (np.arange(B) < B - 100).astype(np.float32)
    theta = np.random.default_rng(7).normal(
        scale=0.01, size=cfg.num_params).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (theta, x, y, mask)]

    d, loss = fused_update.local_update(*args, cfg=cfg)
    d2, loss2 = fused_update.local_update(*args, cfg=cfg)
    torch.cuda.synchronize()
    d_ref, loss_ref = fused_update.local_update_plain(*args, cfg=cfg)
    torch.cuda.synchronize()
    out = torch.cat([d, loss.reshape(1)])
    ref = torch.cat([d_ref, loss_ref.reshape(1)])
    err = (out - ref).abs()
    max_abs = float(err.max())
    big = ref.abs() > ATOL                 # relative error off near-zeros
    max_rel = float((err[big] / ref.abs()[big]).max())
    print(f"K1 local_update vs plain on the card: max_abs={max_abs:.3e} "
          f"max_rel={max_rel:.3e} (tolerance rtol={RTOL}, atol={ATOL}); "
          f"loss {float(loss):.7f} vs {float(loss_ref):.7f}")
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
    if not (torch.isfinite(out).all() and torch.equal(d, d2)
            and torch.equal(loss, loss2)):
        raise RuntimeError("K1: non-finite output or two launches differ")
    print("K1 two launches bitwise equal: True")

    ms = time_ms(lambda: fused_update.local_update(*args, cfg=cfg))
    plain_ms = time_ms(
        lambda: fused_update.local_update_plain(*args, cfg=cfg))
    dev_ms, per_kernel = device_ms(
        lambda: fused_update.local_update(*args, cfg=cfg))
    print(f"K1 device time per call (torch.profiler, kernels only): "
          f"{dev_ms:.4f} ms; " + "; ".join(
              f"{k} {v:.4f}" for k, v in sorted(per_kernel.items())))
    R, P = cfg.num_rows, cfg.num_params
    nbytes = 4 * (B * F + 2 * B + 2 * P + 1)  # x, y, mask, theta, delta, loss
    flops = (4 * K + 2) * B * F * R            # 2k+1 passes of 2 B*F*R
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    op_ms = flops / PEAK_F32_FLOPS * 1e3
    bound_ms = max(byte_ms, op_ms)
    print(f"K1 ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.6f} "
          f"(bytes {nbytes} -> {byte_ms:.6f} ms at 3.35 TB/s; "
          f"{flops} f32 FLOP -> {op_ms:.6f} ms at 67 TFLOP/s); "
          f"CUDA launches per call {2 * K + 2}")
    return {"name": "local_update", "route": "cuda",
            "source": "kafka_ps_tpu_torch/ops/csrc/local_update.cu",
            "replaces": "kafka_ps_tpu/ops/fused_update.py:86",
            "launches": 0, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": None}


def reference_check(dev):
    """The trainer on the card against the same serial run on the CPU."""
    from kafka_ps_tpu_torch.data.synth import generate
    from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
    from kafka_ps_tpu_torch.utils.config import (BufferConfig, ModelConfig,
                                                 PSConfig)

    def run(device, c):
        cfg = PSConfig(num_workers=3, consistency_model=c,
                       model=ModelConfig(num_features=64, num_classes=5),
                       buffer=BufferConfig(min_size=8, max_size=32))
        x, y = generate(200, 64, 5, seed=2, center_scale=0.3)
        server, worker = [], []
        app = StreamingPSApp(cfg, test_x=x[150:], test_y=y[150:],
                             server_log=server.append,
                             worker_log=worker.append,
                             clock_ms=iter(range(0, 10 ** 9, 40)).__next__,
                             device=device)
        for i in range(150):
            app.data_sink(i % 3, x[i], int(y[i]))
        app.run_serial(30)
        app.close_logs()
        keys = [r.split(";")[1:3] for r in server] + [
            r.split(";")[1:3] + r.split(";")[6:] for r in worker]
        return app.server.theta.cpu(), keys

    for c in (0, 2, -1):
        t_gpu, k_gpu = run(dev, c)
        t_cpu, k_cpu = run("cpu", c)
        if k_gpu != k_cpu:
            raise RuntimeError(f"-c {c}: row keys differ card vs CPU")
        torch.testing.assert_close(t_gpu, t_cpu, rtol=1e-4, atol=1e-5)
        print(f"reference check -c {c}: card vs CPU rows equal, theta "
              f"max_abs={float((t_gpu - t_cpu).abs().max()):.3e}")


def write_data():
    from kafka_ps_tpu_torch.data.synth import generate, write_csv
    os.makedirs(OUT, exist_ok=True)
    x, y = generate(TRAIN_ROWS + TEST_ROWS, F, C, seed=0)
    write_csv(os.path.join(OUT, "train.csv"), x[:TRAIN_ROWS],
              y[:TRAIN_ROWS])
    write_csv(os.path.join(OUT, "test.csv"), x[TRAIN_ROWS:],
              y[TRAIN_ROWS:])


def main_path_run(mode: str, c: int) -> dict:
    from kafka_ps_tpu_torch.cli import run as cli_run
    from kafka_ps_tpu_torch.ops import fused_update

    here = os.getcwd()
    os.chdir(OUT)
    try:
        fused_update.launches = 0
        t0 = time.perf_counter()
        rc = cli_run.main([
            "-training", "train.csv", "-test", "test.csv",
            "--num_workers", str(WORKERS), "--num_features", str(F),
            "--num_classes", str(C), "-max", str(MAX_BUFFER), "-p", "0",
            "-l", "--mode", mode, "-c", str(c), "--max_iterations",
            str(ITERS), "--pallas", "--no-gang", "--no-eval-async"])
        # main() returns after the drive loop's flush_logs, which waits on
        # the card: the window from the first worker row to here holds
        # all the device work of the run
        end_ms = time.time() * 1000
        wall = time.perf_counter() - t0
        launches = fused_update.launches
        server = [r.split(";") for r in
                  open("logs-server.csv").read().splitlines()[1:]]
        worker = [r.split(";") for r in
                  open("logs-worker.csv").read().splitlines()[1:]]
        shutil.copy("logs-server.csv", f"server-{mode}-c{c}.csv")
        shutil.copy("logs-worker.csv", f"worker-{mode}-c{c}.csv")
    finally:
        os.chdir(here)
    values = np.array([[float(v) for v in r[3:6]] for r in server + worker])
    stamps = [int(r[0]) for r in worker]
    # server iterations over the window up to the synchronised flush
    window_s = (end_ms - min(stamps)) / 1e3
    rate = ITERS / window_s
    # per-layer: worker rows over their host submit stamps (ms), which
    # precede their device work
    span_s = (max(stamps) - min(stamps)) / 1e3
    submit_rate = (len(worker) - 1) / span_s if span_s > 0 else float("nan")
    f1 = float(server[-1][4])
    print(f"main path --mode {mode} -c {c}: rc={rc} server_rows="
          f"{len(server)} worker_rows={len(worker)} K1_launches={launches} "
          f"iters_per_s={rate:.1f} ({ITERS} server iterations over "
          f"{window_s:.3f} s, first worker row to flushed logs) "
          f"worker_rows_per_s_host_submit={submit_rate:.1f} "
          f"final_f1={f1:.4f} wall_s={wall:.1f}")
    if rc != 0 or len(worker) < ITERS or not server:
        raise RuntimeError(f"{mode} -c {c}: short run")
    if launches < len(worker):
        raise RuntimeError(f"{mode} -c {c}: {len(worker)} worker iterations "
                           f"but K1 launched {launches} times")
    if not np.isfinite(values).all() or not 0.5 < f1 <= 1.0:
        raise RuntimeError(f"{mode} -c {c}: bad metrics (final F1 {f1})")
    for w in range(WORKERS):
        clocks = [int(r[2]) for r in worker if int(r[1]) == w]
        if clocks != list(range(len(clocks))):
            raise RuntimeError(f"{mode} -c {c}: worker {w} clocks skip")
    return {"launches": launches, "iters_per_s": rate,
            "worker_rows_per_s_host_submit": submit_rate, "final_f1": f1}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from kafka_ps_tpu_torch.ops import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build(_build.sources())
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(_build.sources())})")
    os.makedirs(OUT, exist_ok=True)
    for name, log in _build.build_logs.items():
        with open(os.path.join(OUT, f"nvcc-{name}.log"), "w") as f:
            f.write(log)
        print(f"nvcc {name}, ptxas report for the C=5 instances:")
        print(ptxas_summary(log))

    k1 = kernel_phase(dev)
    reference_check(dev)
    write_data()
    try:
        runs = [main_path_run("serial", 0), main_path_run("threaded", 2),
                main_path_run("threaded", -1)]
    finally:
        for name in ("train.csv", "test.csv"):   # ~70 MB, made anew each run
            os.remove(os.path.join(OUT, name))
    k1["launches"] = sum(r["launches"] for r in runs)
    print(json.dumps({"kernels": [k1]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
