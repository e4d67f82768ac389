"""Smoke run of kafka_ps_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

1. Setup: the card's name and power limit, torch and CUDA versions, and
   the build of every CUDA kernel from the sources in the checkout (one
   nvcc per source, all started together).
2. Kernel phase, at the main path's shapes (F=1024, B=1024 with masked
   rows and one out-of-range label, C=5, k=2; the MLP at H=128): K1
   (logreg), K2 (logreg, a gang of 4), K4 (MLP) and K6 (MLP, a gang of
   4), each against its plain PyTorch version on the card (TF32 off), two
   launches bitwise equal, K2 bitwise equal to 4 K1 calls and K6 to 4 K4
   calls, K4 also at H=100, B=1000; then each kernel's median time over
   CUDA events, its device time from torch.profiler, the plain version's
   time and the card's bound for the same work.
3. Reference check: small serial runs of the trainer on the card against
   the same runs on the CPU (row keys exact, theta within tolerance), for
   logreg at -c 0/2/-1 and the MLP at -c 0; on the card, gang dispatch on
   and off give the same theta bits, async and fused eval the same server
   rows.
4. Main path, through the real entry point kafka_ps_tpu_torch.cli.run:
   4 workers, buffer max 1024, a synthetic 1024-feature CSV.  logreg with
   the default flags (gang dispatch and async eval): serial -c 0,
   threaded -c 2, threaded -c -1; the MLP with the default flags: serial
   -c 0, threaded -c -1; logreg with --no-gang --no-eval-async: serial
   -c 0, threaded -c 2, threaded -c -1.  Launch counters are zeroed just
   before each run and read just after it: the single and gang-member
   kernel calls must cover every worker iteration, serial -c 0 must have
   run the gang kernel, metrics must be finite and the final eval lag 0.
5. Profile: one more default serial -c 0 run per family (200
   iterations) under torch.profiler (CUDA activity only) and cProfile:
   device busy time by kernel against the run's wall window, i.e. the
   device's idle share on the main path, and the host's time by Python
   function.
6. The `kernels` JSON line, the card line, and last the result line.

Any failed phase raises: the script exits non-zero and prints no result.
It also exits non-zero without a card, and when the package is absent.
"""

from __future__ import annotations

import contextlib
import io
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
# tensor cores (the kernels do scalar f32 FMA)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
RTOL, ATOL = 1e-4, 1e-6            # K1, K2
MLP_RTOL, MLP_ATOL = 1e-4, 1e-5    # K4, K6

F, C, B, K, H, GANG = 1024, 5, 1024, 2, 128, 4
WORKERS, MAX_BUFFER, TRAIN_ROWS, TEST_ROWS = 4, 1024, 6000, 2000
ITERS, SLICE1_ITERS = 400, 200
NO_LIBRARY = ("no single PyTorch call computes the k-step update; the "
              "plain version is a chain of eager ops")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def ptxas_summary(log: str) -> str:
    """The ptxas -v lines of the kernels the main path runs (R=6 template
    instances and the untemplated passes)."""
    keep, out = False, []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = any(k in line for k in ("ILi6E", "apply_pass", "dw1_pass",
                                           "tail_apply", "loss_reduce"))
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


def bound(nbytes: int, flops: int) -> tuple[float, str, str]:
    """The least time for the work: the larger of bytes over the memory
    rate and f32 operations over the f32 rate."""
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    op_ms = flops / PEAK_F32_FLOPS * 1e3
    by = "bytes" if byte_ms >= op_ms else "operations"
    return max(byte_ms, op_ms), by, (
        f"bytes {nbytes} -> {byte_ms:.6f} ms at 3.35 TB/s; {flops} f32 "
        f"FLOP -> {op_ms:.6f} ms at 67 TFLOP/s")


def member_inputs(dev, num_params, seed, mlp_theta=None, batch=B):
    """One worker's inputs at the main path's shapes: the buffer with 100
    masked rows and one out-of-range label, and a theta (logreg: small
    normal; MLP: the package's init plus small noise)."""
    from kafka_ps_tpu_torch.data.synth import generate
    x, y = generate(batch, F, C, seed=seed)
    y[3] = C + 2
    mask = (np.arange(batch) < batch - 100).astype(np.float32)
    rng = np.random.default_rng(seed)
    theta = rng.normal(scale=0.01, size=num_params).astype(np.float32)
    if mlp_theta is not None:
        theta = (mlp_theta + theta).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (theta, x, y, mask)]


def compare(name, out, ref, rtol, atol) -> float:
    """Kernel outputs (delta(s), loss(es)) against the plain version's."""
    o = torch.cat([out[0].reshape(-1), out[1].reshape(-1)])
    r = torch.cat([ref[0].reshape(-1), ref[1].reshape(-1)])
    err = (o - r).abs()
    max_abs = float(err.max())
    big = r.abs() > atol                 # relative error off near-zeros
    max_rel = float((err[big] / r.abs()[big]).max())
    print(f"{name} vs plain on the card: max_abs={max_abs:.3e} "
          f"max_rel={max_rel:.3e} (tolerance rtol={rtol}, atol={atol}); "
          f"loss {out[1].reshape(-1).tolist()} vs "
          f"{ref[1].reshape(-1).tolist()}")
    torch.testing.assert_close(o, r, rtol=rtol, atol=atol)
    if not torch.isfinite(o).all():
        raise RuntimeError(f"{name}: non-finite output")
    return max_abs


def kernel_entry(name, source, replaces, call, plain, nbytes, flops,
                 max_abs, cuda_launches) -> dict:
    ms = time_ms(call)
    plain_ms = time_ms(plain)
    dev_ms, per_kernel = device_ms(call)
    bound_ms, by, detail = bound(nbytes, flops)
    print(f"{name} device time per call (torch.profiler, kernels only): "
          f"{dev_ms:.4f} ms; " + "; ".join(
              f"{k} {v:.4f}" for k, v in sorted(per_kernel.items())))
    print(f"{name} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.6f} ({detail}); CUDA launches per call "
          f"{cuda_launches}; library_ms=null ({NO_LIBRARY})")
    return {"name": name, "route": "cuda",
            "source": f"kafka_ps_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "launches": 0, "max_abs_err": max_abs,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": None}


def kernel_phase(dev) -> dict:
    from kafka_ps_tpu_torch.models import mlp
    from kafka_ps_tpu_torch.ops import fused_update as fu
    from kafka_ps_tpu_torch.utils.config import ModelConfig

    out = {}
    # -- K1 / K2: logreg ------------------------------------------------------
    cfg = ModelConfig(num_features=F, num_classes=C, num_max_iter=K,
                      local_learning_rate=0.5)
    R, P = cfg.num_rows, cfg.num_params
    gang = [member_inputs(dev, P, 7 + i) for i in range(GANG)]
    args = gang[0]
    r1, r2 = fu.local_update(*args, cfg=cfg), fu.local_update(*args, cfg=cfg)
    torch.cuda.synchronize()
    k1_err = compare("K1 local_update", r1,
                     fu.local_update_plain(*args, cfg=cfg), RTOL, ATOL)
    if not (torch.equal(r1[0], r2[0]) and torch.equal(r1[1], r2[1])):
        raise RuntimeError("K1: two launches differ")
    print("K1 two launches bitwise equal: True")
    members = [list(a) for a in zip(*gang)]
    b1 = fu.local_update_batched(*members, cfg=cfg)
    b2 = fu.local_update_batched(*members, cfg=cfg)
    torch.cuda.synchronize()
    k2_err = compare("K2 local_update_batched", b1,
                     fu.local_update_batched_plain(*members, cfg=cfg),
                     RTOL, ATOL)
    singles = [fu.local_update(*g, cfg=cfg) for g in gang]
    same = all(torch.equal(b1[0][i], d) and torch.equal(b1[1][i], loss)
               for i, (d, loss) in enumerate(singles))
    if not (same and torch.equal(b1[0], b2[0]) and torch.equal(b1[1], b2[1])):
        raise RuntimeError("K2: not bitwise equal to 4 K1 calls, or two "
                           "launches differ")
    print(f"K2 ({GANG} members) bitwise equal to {GANG} K1 calls and "
          "across two launches: True")
    nbytes = 4 * (B * F + 2 * B + 2 * P + 1)   # x, y, mask, theta, delta, loss
    flops = (4 * K + 2) * B * F * R            # 2k+1 passes of 2 B*F*R
    out["local_update"] = kernel_entry(
        "local_update", "local_update.cu",
        "kafka_ps_tpu/ops/fused_update.py:86",
        lambda: fu.local_update(*args, cfg=cfg),
        lambda: fu.local_update_plain(*args, cfg=cfg),
        nbytes, flops, k1_err, 2 * K + 2)
    out["local_update_batched"] = kernel_entry(
        "local_update_batched", "local_update.cu",
        "kafka_ps_tpu/ops/fused_update.py:845",
        lambda: fu.local_update_batched(*members, cfg=cfg),
        lambda: fu.local_update_batched_plain(*members, cfg=cfg),
        GANG * nbytes, GANG * flops, k2_err, 2 * K + 2)

    # -- K4 / K6: MLP ---------------------------------------------------------
    mcfg = ModelConfig(num_features=F, num_classes=C, num_max_iter=K,
                       local_learning_rate=0.5, hidden_dim=H)
    MP = mlp.num_params(mcfg)
    theta0 = mlp.init_params(mcfg, "cpu").numpy()
    gang = [member_inputs(dev, MP, 17 + i, theta0) for i in range(GANG)]
    args = gang[0]
    r1 = fu.mlp_local_update(*args, cfg=mcfg)
    r2 = fu.mlp_local_update(*args, cfg=mcfg)
    torch.cuda.synchronize()
    k4_err = compare("K4 mlp_local_update (H=128, B=1024)", r1,
                     fu.mlp_local_update_plain(*args, cfg=mcfg),
                     MLP_RTOL, MLP_ATOL)
    if not (torch.equal(r1[0], r2[0]) and torch.equal(r1[1], r2[1])):
        raise RuntimeError("K4: two launches differ")
    print("K4 two launches bitwise equal: True")
    odd = ModelConfig(num_features=F, num_classes=C, num_max_iter=K,
                      local_learning_rate=0.5, hidden_dim=100)
    odd_args = member_inputs(dev, mlp.num_params(odd), 31,
                             mlp.init_params(odd, "cpu").numpy(), batch=1000)
    compare("K4 mlp_local_update (H=100, B=1000)",
            fu.mlp_local_update(*odd_args, cfg=odd),
            fu.mlp_local_update_plain(*odd_args, cfg=odd),
            MLP_RTOL, MLP_ATOL)
    members = [list(a) for a in zip(*gang)]
    b1 = fu.mlp_local_update_batched(*members, cfg=mcfg)
    b2 = fu.mlp_local_update_batched(*members, cfg=mcfg)
    torch.cuda.synchronize()
    k6_err = compare("K6 mlp_local_update_batched", b1,
                     fu.mlp_local_update_batched_plain(*members, cfg=mcfg),
                     MLP_RTOL, MLP_ATOL)
    singles = [fu.mlp_local_update(*g, cfg=mcfg) for g in gang]
    same = all(torch.equal(b1[0][i], d) and torch.equal(b1[1][i], loss)
               for i, (d, loss) in enumerate(singles))
    if not (same and torch.equal(b1[0], b2[0]) and torch.equal(b1[1], b2[1])):
        raise RuntimeError("K6: not bitwise equal to 4 K4 calls, or two "
                           "launches differ")
    print(f"K6 ({GANG} members) bitwise equal to {GANG} K4 calls and "
          "across two launches: True")
    nbytes = 4 * (B * F + 2 * B + 2 * MP + 1)
    flops = (4 * K + 2) * B * F * H + (6 * K + 2) * B * H * R
    out["mlp_local_update"] = kernel_entry(
        "mlp_local_update", "mlp_update.cu",
        "kafka_ps_tpu/ops/fused_update.py:248",
        lambda: fu.mlp_local_update(*args, cfg=mcfg),
        lambda: fu.mlp_local_update_plain(*args, cfg=mcfg),
        nbytes, flops, k4_err, 3 * K + 2)
    out["mlp_local_update_batched"] = kernel_entry(
        "mlp_local_update_batched", "mlp_update.cu",
        "kafka_ps_tpu/ops/fused_update.py:939",
        lambda: fu.mlp_local_update_batched(*members, cfg=mcfg),
        lambda: fu.mlp_local_update_batched_plain(*members, cfg=mcfg),
        GANG * nbytes, GANG * flops, k6_err, 3 * K + 2)
    return out


def reference_check(dev) -> None:
    """The trainer on the card against the same serial run on the CPU,
    and the gang and async-eval levers on the card."""
    from kafka_ps_tpu_torch.data.synth import generate
    from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
    from kafka_ps_tpu_torch.utils.config import (BufferConfig, ModelConfig,
                                                 PSConfig)

    def run(device, c, task="logreg", **kw):
        cfg = PSConfig(num_workers=3, consistency_model=c, task=task,
                       model=ModelConfig(num_features=64, num_classes=5,
                                         hidden_dim=32),
                       buffer=BufferConfig(min_size=8, max_size=32), **kw)
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
        return app.server.theta, server, worker

    def keys(server, worker):
        return [r.split(";")[1:3] for r in server] + [
            r.split(";")[1:3] + r.split(";")[6:] for r in worker]

    def strip(rows):
        return [r.split(";", 1)[1] for r in rows]

    for task, cs in (("logreg", (0, 2, -1)), ("mlp", (0,))):
        for c in cs:
            t_gpu, s_gpu, w_gpu = run(dev, c, task)
            t_cpu, s_cpu, w_cpu = run("cpu", c, task)
            if keys(s_gpu, w_gpu) != keys(s_cpu, w_cpu):
                raise RuntimeError(f"{task} -c {c}: row keys differ card "
                                   "vs CPU")
            torch.testing.assert_close(t_gpu.cpu(), t_cpu, rtol=1e-4,
                                       atol=1e-5)
            print(f"reference check {task} -c {c} (gang, async eval): card "
                  f"vs CPU rows equal, theta max_abs="
                  f"{float((t_gpu.cpu() - t_cpu).abs().max()):.3e}")
            t_off, s_off, w_off = run(dev, c, task, use_gang=False)
            if not (torch.equal(t_gpu, t_off)
                    and strip(w_gpu) == strip(w_off)):
                raise RuntimeError(f"{task} -c {c}: gang on/off differ on "
                                   "the card")
            t_fused, s_fused, _ = run(dev, c, task, eval_async=False)
            if not (torch.equal(t_gpu, t_fused)
                    and strip(s_gpu) == strip(s_fused)):
                raise RuntimeError(f"{task} -c {c}: async/fused eval rows "
                                   "differ on the card")
            print(f"reference check {task} -c {c} on the card: gang on/off "
                  f"theta bitwise equal, async/fused server rows identical "
                  f"({len(s_gpu)} rows)")


def write_data():
    from kafka_ps_tpu_torch.data.synth import generate, write_csv
    os.makedirs(OUT, exist_ok=True)
    x, y = generate(TRAIN_ROWS + TEST_ROWS, F, C, seed=0)
    write_csv(os.path.join(OUT, "train.csv"), x[:TRAIN_ROWS],
              y[:TRAIN_ROWS])
    write_csv(os.path.join(OUT, "test.csv"), x[TRAIN_ROWS:],
              y[TRAIN_ROWS:])


def main_path_run(task: str, mode: str, c: int, iters: int,
                  flags: tuple = ()) -> dict:
    from kafka_ps_tpu_torch.cli import run as cli_run
    from kafka_ps_tpu_torch.ops import fused_update

    tag = f"{task}-{mode}-c{c}" + ("-slice1" if flags else "")
    here = os.getcwd()
    os.chdir(OUT)
    err = io.StringIO()
    try:
        fused_update.reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli_run.main([
                "-training", "train.csv", "-test", "test.csv",
                "--num_workers", str(WORKERS), "--num_features", str(F),
                "--num_classes", str(C), "--task", task, "--hidden_dim",
                str(H), "-max", str(MAX_BUFFER), "-p", "0", "-l", "--mode",
                mode, "-c", str(c), "--max_iterations", str(iters),
                *flags])
        # main() returns after the drive loop's flush_logs, which waits on
        # the card: the window from the first worker row to here holds
        # all the device work of the run
        end_ms = time.time() * 1000
        wall = time.perf_counter() - t0
        n = fused_update.counts()
        server = [r.split(";") for r in
                  open("logs-server.csv").read().splitlines()[1:]]
        worker = [r.split(";") for r in
                  open("logs-worker.csv").read().splitlines()[1:]]
        shutil.copy("logs-server.csv", f"server-{tag}.csv")
        shutil.copy("logs-worker.csv", f"worker-{tag}.csv")
    finally:
        os.chdir(here)
    sys.stderr.write(err.getvalue())
    stats = [json.loads(line.split(": ", 1)[1])
             for line in err.getvalue().splitlines()
             if line.startswith("kafka_ps_tpu_torch run: ")][-1]
    prefix = "" if task == "logreg" else "mlp_"
    single, gang_calls, members = (n[f"{prefix}launches"],
                                   n[f"{prefix}batched_launches"],
                                   n[f"{prefix}batched_members"])
    values = np.array([[float(v) for v in r[3:6]] for r in server + worker])
    stamps = [int(r[0]) for r in worker]
    # server iterations over the window up to the synchronised flush
    window_s = (end_ms - min(stamps)) / 1e3
    rate = iters / window_s
    # per-layer: worker rows over their host submit stamps (ms), which
    # precede their device work
    span_s = (max(stamps) - min(stamps)) / 1e3
    submit_rate = (len(worker) - 1) / span_s if span_s > 0 else float("nan")
    f1 = float(server[-1][4])
    g = stats.get("gang", {"dispatches": 0, "members": 0})
    ev = stats.get("eval")
    per = g["members"] / g["dispatches"] if g["dispatches"] else 0.0
    print(f"main path {tag}: rc={rc} server_rows={len(server)} "
          f"worker_rows={len(worker)} single_calls={single} "
          f"gang_calls={gang_calls} gang_members={members} "
          f"iters_per_s={rate:.1f} ({iters} server iterations over "
          f"{window_s:.3f} s, first worker row to flushed logs) "
          f"worker_rows_per_s_host_submit={submit_rate:.1f} "
          f"final_f1={f1:.4f} wall_s={wall:.1f}")
    print(f"  gang dispatches={g['dispatches']} members per dispatch="
          f"{per:.2f}; server batched applies="
          f"{stats['server_batched_applies']}; eval engine: "
          + ("off" if ev is None else
             f"dispatches={ev['dispatches']} evals={ev['evals']} widths="
             f"{ev['widths']} final lag={ev['lag_clocks']}"))
    if rc != 0 or len(worker) < iters or not server:
        raise RuntimeError(f"{tag}: short run")
    if single + members < len(worker):
        raise RuntimeError(f"{tag}: {len(worker)} worker iterations but "
                           f"{single} single and {members} gang-member "
                           "kernel calls")
    if not flags and mode == "serial" and c == 0 and gang_calls < 1:
        raise RuntimeError(f"{tag}: the gang kernel never ran")
    if ev is not None and ev["lag_clocks"] != 0:
        raise RuntimeError(f"{tag}: final eval lag {ev['lag_clocks']}")
    if not np.isfinite(values).all() or not 0.5 < f1 <= 1.0:
        raise RuntimeError(f"{tag}: bad metrics (final F1 {f1})")
    for w in range(WORKERS):
        clocks = [int(r[2]) for r in worker if int(r[1]) == w]
        if clocks != list(range(len(clocks))):
            raise RuntimeError(f"{tag}: worker {w} clocks skip")
    return {"task": task, "single": single, "gang_calls": gang_calls}


def profile_run(task: str, iters: int = 200) -> None:
    """One default serial -c 0 run through cli.run.main under
    torch.profiler and cProfile: device time by kernel, the device's busy
    share of the window from the profiler's start to the flushed logs,
    and the host's own time by Python function (cProfile on Python 3.12
    sees every thread, adds its own cost to every Python call, and its
    cumulative times overlap across threads)."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    from kafka_ps_tpu_torch.cli import run as cli_run
    here = os.getcwd()
    os.chdir(OUT)
    try:
        host = cProfile.Profile()
        with contextlib.redirect_stderr(io.StringIO()):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                host.enable()
                cli_run.main([
                    "-training", "train.csv", "-test", "test.csv",
                    "--num_workers", str(WORKERS), "--num_features",
                    str(F), "--num_classes", str(C), "--task", task,
                    "--hidden_dim", str(H), "-max", str(MAX_BUFFER), "-p",
                    "0", "-l", "--mode", "serial", "-c", "0",
                    "--max_iterations", str(iters)])
                torch.cuda.synchronize()
                host.disable()
                wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        os.chdir(here)
    per = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            per[e.key[:70]] = us / 1e3
    busy = sum(per.values())
    print(f"profile {task} serial -c 0 ({iters} server iterations, CSV "
          f"parsing included): wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {1 - busy / wall_ms:.4f}; device ms "
          f"per server iteration {busy / iters:.4f}; top kernels (ms):")
    for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {v:9.3f}  {k}")
    stats = pstats.Stats(host)
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])
    print(f"profile {task} host by own time (cProfile; own ms, cumulative "
          "ms, calls):")
    for (path, line, fn), (_, calls, own, cum, _) in rows[:25]:
        where = f"{os.path.basename(path)}:{line}({fn})"
        print(f"  {own * 1e3:9.1f} {cum * 1e3:9.1f} {calls:7d}  {where}")


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

    kernels = kernel_phase(dev)
    reference_check(dev)
    write_data()
    logreg_default = [("serial", 0), ("threaded", 2), ("threaded", -1)]
    try:
        runs = [main_path_run("logreg", m, c, ITERS)
                for m, c in logreg_default]
        runs += [main_path_run("mlp", m, c, ITERS)
                 for m, c in (("serial", 0), ("threaded", -1))]
        runs += [main_path_run("logreg", m, c, SLICE1_ITERS,
                               ("--no-gang", "--no-eval-async"))
                 for m, c in logreg_default]
        profile_run("logreg")
        profile_run("mlp")
    finally:
        for name in ("train.csv", "test.csv"):   # ~70 MB, made anew each run
            os.remove(os.path.join(OUT, name))
    for name, task, key in (
            ("local_update", "logreg", "single"),
            ("local_update_batched", "logreg", "gang_calls"),
            ("mlp_local_update", "mlp", "single"),
            ("mlp_local_update_batched", "mlp", "gang_calls")):
        kernels[name]["launches"] = sum(r[key] for r in runs
                                        if r["task"] == task)
        if kernels[name]["launches"] < 1:
            raise RuntimeError(f"{name} never ran on the main path")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
