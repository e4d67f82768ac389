"""Smoke run of kafka_ps_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

1. Setup: the card's name and power limit, torch and CUDA versions, and
   the build of every CUDA kernel from the sources in the checkout (one
   nvcc per source, all started together, each compiling on threads),
   every process the script starts sharing one bytecode cache
   (.pycache/ in the checkout), with ptxas's register and
   shared-memory report and the MLP tensor passes' dynamic shared memory.
2. Kernel phase, at the main path's shapes (F=1024, B=1024 with masked
   rows and one out-of-range label, C=5, k=2; the MLP at H=128): K1
   (logreg), K2 (logreg, a gang of 4), K4 (MLP) and K6 (MLP, a gang of
   4), and K3 (logreg) and K5 (MLP) on bf16 and on int8 slabs, each
   against its plain PyTorch version on the card (TF32 off), two launches
   bitwise equal, K2 bitwise equal to 4 K1 calls, K6 to 4 K4 calls and a
   gang of 4 stored slabs to 4 K3 (K5) calls, K4 and K5 also at H=100,
   B=1000, K1 also at B=16384 (more x than the card's shared memory holds,
   re-staged at each step); the logreg kernels' cooperative launch (grid,
   tiles per CTA, dynamic shared memory per CTA, x resident or not); then
   each kernel's median time over CUDA events, its device time and CUDA
   launches per call from torch.profiler, the plain version's time and the
   card's
   bound for the same work (operations at the TF32 tensor-core rate, the
   f32 rate printed beside it), with x counted at its stored width; the
   device time of a K5 gang of 4 per storage form; and one cuBLAS f32
   x @ W1.T beside K4's hidden_pass, as a yardstick for one product.
   Then the MLP at the fused path's width, H=4096, where K4 and K6 take
   the wide passes (wgmma fed by TMA): K4 and K6 (4 members sharing one
   theta) against their plain versions at the MLP's tolerance, with the
   median |delta| printed beside it, K6 bitwise 4 K4 calls and two
   launches bitwise equal, the wide-launch counter against the wrapper
   calls, K6's times and bound, the device ms of each pass of K4 and K6,
   the cuBLAS yardsticks at H=4096 (x @ W1.T beside each wide hidden
   pass, dh.T @ x beside each wide update pass), K4's time, and K4 on
   four members whose float32 update is well conditioned (three) or not
   (one), against the plain version at the MLP's tolerance, on the last
   on all but a bounded few elements (OUTLIER_SHARE, OUTLIER_ABS).
3. Reference check: small serial runs of the trainer on the card against
   the same runs on the CPU (row keys exact, theta within tolerance), for
   logreg at -c 0/2/-1 and the MLP at -c 0, with f32, bf16 and int8
   slabs; on the card, gang dispatch on and off give the same theta bits
   (f32 and int8), async and fused eval the same server rows (f32).  The
   fused BSP step against one message-driven -c 0 round of the trainer
   on the card, and a chunk of 8 rounds (one CUDA graph replay) bitwise
   equal to 8 single rounds, for logreg and the MLP at H=4096, the
   kernels of two replays traced by torch.profiler and held to the launch
   counters, and the chunk's time as one graph replay beside 8 eager
   rounds.  The codecs of --compress (bf16, int8, topk:0.01) at the
   three model sizes (6,150, 131,974 and 4,222,982 parameters): parts on
   the card bitwise the CPU's, decode after pack/unpack bitwise, error
   feedback over 50 steps keeping the sum of the deltas and continuing
   bitwise after a restore, ms per ef_step and per weights encode, packed
   bytes against 4n.  Compressed serial runs on the card against the CPU
   (logreg under each codec, the MLP under int8; row keys exact, theta
   within one step of its codec), gang on/off bitwise under int8; a
   checkpoint resume bitwise the uninterrupted run (f32, int8); through
   the app API a threaded -c 2 rebalance run in which worker 1 raises at
   its 20th iteration with that iteration's gradient still in flight
   (evicted, its late gradient dropped and counted as a zombie, survivors
   finish, rows rerouted, then readmitted at the slowest clock and
   contributing), a threaded -c 0 rebalance run with gang dispatch in
   which one member fails on its leader's thread (evicted alone, the run
   finishes), and the same crash under halt raising.  The durable log's
   threaded order check (threaded -c 2, 4 workers, the log on the card)
   runs under the port's lock-order recorder (analysis/lockgraph.py,
   `isolated()`): it must see no cycle and at least one edge; its edges
   go to lockgraph-edges.json, and `python -m kafka_ps_tpu_torch.analysis
   kafka_ps_tpu_torch/ --lock-coverage` (the static checks, exit 0)
   counts the static edges the card run covered.
4. Main path, through the real entry point kafka_ps_tpu_torch.cli.run:
   4 workers, buffer max 1024, a synthetic 1024-feature CSV, 100 server
   iterations a run unless noted (400 until the telemetry phase came, 200
   until the role telemetry phase came, each time for the script's time
   limit).  logreg with
   the default flags (gang dispatch and async eval): serial -c 0,
   threaded -c 2, threaded -c -1; the MLP with the default flags: serial
   -c 0, threaded -c -1; logreg with --no-gang --no-eval-async: serial
   -c 0, threaded -c 2, threaded -c -1; and with --slab-dtype: logreg
   bf16 serial -c 0, logreg int8 threaded -c 2, the MLP int8 serial -c 0
   and bf16 threaded -c -1; then the fused BSP path (--fused): logreg at
   --eval_every 1 and 10, the MLP at --hidden_dim 4096
   --eval_every 10 (40 rounds); then logreg --compress int8 serial -c 0,
   logreg --compress topk:0.01 threaded -c 2 --failure_policy rebalance
   --heartbeat_timeout 30, the MLP --compress bf16 serial -c 0, the MLP
   at --hidden_dim 4096 --compress int8 serial -c 0 (40 iterations), and
   two resume pairs, logreg serial -c 0 --checkpoint --checkpoint_every
   50 -v for 100 iterations and then to 200, plain and --compress int8
   (the restore printed, a resume event, the server rows continuing, the
   residuals in the file).  Launch counters are zeroed just before each
   run and read just after it: the single and gang-member kernel calls
   must equal the run's worker iterations (K3/K5 alone on a bf16/int8
   run, the f32 kernels' counters 0), serial -c 0 must have run the gang
   kernel, a fused run exactly one K2 (K6) call per round and no single
   call, metrics must be finite and the final eval lag 0.  Every run must
   have parsed its CSV with the port's native parser (its parse time is
   printed).
5. Split phase: one bridge round on the card (tests/torch_split_round.py:
   4 workers, F=1024, rows as DATA_BATCH frames; logreg and the MLP, f32
   and stored slabs) bitwise the in-process round; then the port's split
   deployment, server_runner --listen and two worker_runner processes of
   2 workers, on the same CSV: logreg at -c 0, -c 2 and -c -1, the MLP
   at -c -1, logreg --slab-dtype int8 at -c 2, the MLP --slab-dtype bf16
   at -c -1, logreg --compress int8 at -c 2 (100 iterations each), the
   MLP at H=4096 -c -1 (40), two deployments at a time (their rates
   are under that shared load, and every line they print says so), each
   beside the in-process trainer with the same flags (threaded,
   --no-gang); and logreg -c 10
   with one worker process killed by SIGKILL and restarted
   (--checkpoint, --failure_policy rebalance).  Each worker process's
   kernel calls must equal its worker CSV rows, of the run's family and
   slab form only, on cuda; the log-visible clock spread stays within
   k + 1 under -c k; F1 in (0.5, 1], eval lag 0.  Per run: server
   iterations/s against the in-process run, frames, bytes per message
   and serde ms per frame by topic on each side.
6. Scale-out phase: in process on the card (tests/torch_scaleout_runs.py,
   4 workers of 256 rows, F=1024), a ShardedServerGroup of one shard
   bitwise the unsharded app (theta and server rows) at -c 0/2/-1, two
   and four shards' assembled theta bitwise one shard's (logreg, the MLP
   at H=128), top-k workers' sparse slices bitwise the dense apply, one
   stacked aggregator bitwise the direct path at -c 0/3/-1 and under int8
   (also after a reset and restore), the summed composite within rtol
   2e-5, atol 2e-6; then through the entry points, on the same CSV: two
   shard servers (server_runner --listen --shards 2 --shard-id 0|1) with
   two worker_runner processes of 2 workers dialing both, logreg at -c 0
   and -c 2, logreg --slab-dtype int8 -c 2, logreg --compress topk:0.01
   -c 2 (sparse slices; 100 iterations each), the MLP at H=128 and
   H=4096 -c -1 (100, 40), and logreg -c 2 (200) with --durable-log in which
   shard 1 is killed by SIGKILL and restarted (its log replayed serially
   afterwards must end bitwise at its final checkpoint); then agg_runner
   between a server_runner --listen and two worker_runner --aggregate
   processes: logreg -c 0 and -c -1, --summed -c 0, --compress int8 -c 2
   (100 each) and the MLP at H=4096 -c -1 (40); the MLP --slab-dtype bf16
   -c -1 relay runs in phase 10, with the telemetry flags.  Each worker
   process's kernel calls must equal its CSV rows, of the run's family
   and form only, on cuda; shards reach the iterations,
   their final clocks per worker differ by at most one (none at -c 0),
   the theta assembled from their checkpoints gives F1 in (0.5, 1]; a
   relayed server's eval lag is 0 and its F1 in (0.5, 1].  Per run:
   iterations/s per shard (or of the relayed server) against the split
   run of the same flags from phase 5, bytes per message and serde ms per
   frame by topic each way, and the relay's fan-in, composites and bytes
   against the direct path's; a shards run and a relay run go at once
   (the killed-shard run alone), so their rates are under that load, and
   every line they print says so.
7. Serving phase (serving/, tests/torch_serving_runs.py): in process on
   the card, the engine's answers against its own answers on the CPU from
   the same snapshot at every bucket size 1..16 (logreg, the MLP at H=128
   and 4096; confidences within rtol 1e-5, atol 1e-6, labels equal where
   the top-two logit margin exceeds 1e-5), the gang's prefix snapshots
   bitwise the per-message sequence (-c 0, 3, -1), and a two-shard
   ShardedServerGroup with attach_serving (N=1 bitwise the unsharded
   registry, N=2 publishing only at frontier advances, each cut bitwise
   N=1's theta at its clock); then under closed loads of PredictClients
   (serving/loadgen.py): cli.run --serve --serve_port at serial -c 0 on
   a 512-row CSV (every row buffered before the first iteration) beside
   the same run without --serve, theta and the rows bitwise; threaded
   -c 2; --fused --task mlp --hidden_dim 4096 (40 rounds);
   server_runner --serve-replica following a cli.run --durable-log -c 0
   run while it trains, its last snapshot bitwise the log's newest
   weights (the split server's socket and shm clients and the replica of
   a --shards 2 deployment's per-shard logs run in phase 10, with the
   telemetry flags).  Every answer PREDICT_OK (STALE only before a
   client's first answer), each client's clocks never going back, no
   FAILED; every run's kernel calls checked as the main path's.  Per run:
   p50/p99 ms, answered QPS, shed and stale shares, dispatches, rows per
   dispatch, bypass share, the served clock's lag behind the stable clock
   at the end, and iterations/s with and without the read load.
8. Tier phase (store/): a TieredParamStore on the card over the MLP's
   theta at H=4096 in 65 pages of 65,536 keys, 32 hot, 16 warm and 17
   cold under the caps, pins shifting the heat so that pages move between
   every pair of tiers, `assembled()` bitwise after every rebalance, the
   hot bytes under the hot cap and a per-page apply bitwise the whole
   apply; then cli.run under --tier-hot-bytes / --tier-warm-bytes /
   --tier-page-params with --durable-log beside the same run without
   the caps on a 512-row CSV, theta (SHA-256 of the exit checkpoint) and
   the rows bitwise, every tier occupied at exit, faults and migrations:
   the MLP at H=4096 serial -c 0 (40 iterations) and logreg serial at
   -c 0, 2 and -1 (200, the crash checks' depth); a threaded -c 2
   capped run (eval lag 0, the policy thread migrating); a capped run
   killed after a checkpoint and resumed, the recorded residency applied
   and the final checkpoint bitwise the uninterrupted capped run's; then
   server_runner --listen with a hot cap and two worker processes (-c 2),
   and --shards 2 --durable-log with per-shard caps at H=128, dense and
   with --compress topk:0.01 (these four deployments two at a time, under
   that shared load), each shard's cold pages under its own shard<I>of2
   directory, each run's final F1 within 1/len(test) of its uncapped
   twin's.  Per run: the store's stats (tiers, pins, faults, migrations,
   bytes on the card, bytes uploaded and fetched) and iterations/s capped
   and resident.
9. Telemetry phase (telemetry/, utils/trace.py, utils/status.py):
   cli.run with --trace, --metrics-file (--metrics-every 0.5),
   --flight-dir, --health-port 0, --status_every 0.1 and the analysis
   planes' --profile, --model-health, --slo-serving-p99-ms 50 and
   --slo-freshness-ms 1000: logreg serial -c 0 (400 iterations on the
   512-row CSV) beside the same run without them, theta (SHA-256 of the
   exit checkpoint), the rows and the kernel counters bitwise;
   threaded -c 2 beside its untraced twin (eval lag 0, one clock_lag
   observation per gradient, the gate watchdog quiet); in both,
   /healthz answering 200 mid-run, /profilez 200 with samples and a
   stack of a port training loop, /modelz 200 with resolved updates
   (polled from a thread of this script); --fused --eval_every 10 with
   --trace bitwise its twin, one bsp.step span per dispatch.
   Each traced run: gradients_applied_total equal to the server
   iterations, one worker.local_update span per kernel call and one
   dispatch.device per kernel call and server apply, rising [status]
   iters with critpath and modelhealth blocks, an exit flight dump with
   gate events and the profile's stacks, modelhealth_deferred_total
   equal to the server iterations (every in-process delta observed by
   reference) and update_norm observed, one slo_burn_rate child per
   objective and window.  The drift pair: cli.run logreg serial -c 0
   --eval_every 1 --model-health -l -max 256 -p 1 (960 iterations) on a
   CSV whose rows past the first 1000 are label-flipped and mean-shifted
   (injected: DRIFT latched, drift_trip_total >= 1, a trip row in
   logs-drift.csv, a drift.trip flight record, the detection delay in
   eval rows printed) and on clean rows (control: STABLE, no trip).  The
   model-health sampler's largest poll at H=4096 (64 deferred deltas) on
   the host clock.  Then --device_trace runs (logreg and the MLP, serial
   -c 0, 100 iterations) whose trace must hold the hand kernels' CUDA
   events, and a threaded run with --flight-dir killed by SIGTERM (its
   dump read back).  Prints iterations/s with every flag over without,
   beside the card line.
10. Role telemetry phase (cli/socket_mode.py's telemetry flags, 100
   server iterations a run, 300 for the split runs, every process with
   --trace, --metrics-file,
   --flight-dir and --health-port 0, a split server --status_every; the
   processes' /healthz polled from a thread of this script while they
   run): the bridge round on the card with tracers and registries on both
   sides bitwise the untraced round, trace context negotiated and every
   gradients and weights frame 16 bytes longer (logreg and the MLP, f32
   and stored slabs); server_runner --listen with two worker processes,
   logreg -c 2, untraced, traced, traced and untraced back to back and
   alone on the card, the first traced run checked (the gradients frames the
   server read are its iterations plus its drops and its queue at the
   stop, every worker's delta.wire flow steps at the server but for
   frames in flight at its stop, rising [status] lines, exit dumps with
   net.* records; the port's `python -m kafka_ps_tpu_torch.telemetry`
   merge of its traces, critpath of the merged trace naming the wire
   segment and postmortem of its dumps, each exiting 0; iterations/s
   traced over untraced, each pair's and their median); --shards 2
   --slab-dtype int8 -c 2 with shard 1 killed by SIGKILL after its first
   checkpoint and shard 0 stopped by SIGTERM (the workers' dumps hold
   both shards' shard.weights records; the postmortem's rule names shard
   1 dead and its last acknowledged (worker, clock); shard 0's families
   carry its shard label); agg_runner between a server and two
   --aggregate workers, the MLP bf16 -c -1 (agg_composites_total and the
   agg_fan_in observations equal the relay's composites, the members'
   delta.wire flows step through the relay); server_runner --listen
   --serve --serve-shm, the MLP -c -1, under a socket and a shm client,
   the server with the analysis planes' flags and the workers with
   --model-health (serving_requests_total and
   serving_dispatch_mode{mode="shm"} equal the engine's and the bridge's
   counts, the serving watchdog quiet, a delta.wire flow ending at a
   serving read; modelhealth_updates_total equal to the gradients
   applied and modelhealth_deferred_total 0, every delta off the socket
   computed inline; slo_burn_rate{slo="serving_latency"} present;
   [status] lines with critpath); --shards 2 --durable-log
   with per-shard hot and warm caps, logreg -c 0, followed by a
   --serve-replica from the start (the tier families equal each store's
   counters, store.* records; replica.publish records, the replica and
   serving watchdogs quiet, its last snapshot bitwise the logs' newest
   weights); the relay, serving, killed-shard and capped replica runs run
   at once (their rates and latencies are under that shared load, and
   every line they print says so).  Every
   run's kernel calls checked as the main path's.
11. Multi-device phase (parallel/{mesh,multihost,range_sharded}.py, the
   fused path's mesh branch, cli.run -r and --param_shards; every job's
   ranks are processes of tests/torch_multidevice_runs.py or cli.run):
   in one child process, the bsp step and an 8-round chunk at the main
   path's shapes (4 workers x 1024 rows, F=1024, C=5) and
   run_fused_bsp (100 iterations, eval every 10, on 1024 rows a worker
   fed before the loop) without a job and then in a 1-rank NCCL job,
   theta, losses and rows (stamps aside) bitwise; the same run_fused_bsp
   over 2 ranks sharing the card (gloo: NCCL refuses two ranks on one
   card), the bsp branch and --param_shards 2's range-sharded server (a
   1 x 2 mesh, the pad clean at every round) within rtol 1e-4, atol 1e-5
   of each other and every rank's theta bitwise the others', and a gloo
   all_reduce of the H=4096 MLP's round (4,222,983 float32) timed;
   cli.run's refusals of --param_shards 2 outside a job and of -r
   without --fused and with --durable-log in a 1-rank job, with the JAX
   texts; evaluation/ground_truth.train_offline, 100 full-batch steps on
   the card against the CPU (rtol 1e-4, atol 1e-5; F1 and accuracy
   within 1/len(test)); then `cli.run -r --fused -l --checkpoint` jobs of
   2 ranks on the card, the three at once: logreg and logreg
   --param_shards 2 (100 iterations), the MLP at --hidden_dim 4096 (10
   rounds), each with rank 0 alone writing the server, events and worker
   logs and the checkpoint (no buffers in it), rank 1
   logs-worker.p1.csv, workers {0,1} and
   {2,3}, the clocks in lockstep, the loss falling, the port's
   `python -m kafka_ps_tpu_torch.evaluation validate -c 0` clean on the
   ranks' rows (in a process of its own: this script imports no pandas,
   matplotlib or sklearn), and each rank one gang call a round, counted
   in the `kernels` line.  Prints iterations/s of each job and of the
   1-rank job beside no job.
12. Profile: one more default serial -c 0 run per family, one of logreg
   with int8 slabs, one of logreg --compress int8 and one of logreg
   --fused --eval_every 10 (200
   iterations each), under torch.profiler (CUDA activity only) and
   cProfile: device busy time by kernel against the run's wall window,
   i.e. the device's idle share on the main path, and the host's time by
   Python function, with the rank of the CSV parse's functions in it.
   In the fused run, whose chunks replay CUDA graphs, the K2 kernels the
   profiler traced must equal the launch counter.
13. The `kernels` JSON line (the split, scale-out, serving, tier,
   telemetry, role telemetry and multi-device runs' worker and rank calls
   counted in the launches), the phase times, the card line, and last
   the result line.

Any failed phase raises: the script exits non-zero and prints no result.
It also exits non-zero without a card, and when the package is absent.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out", "smoke")

# NVIDIA H100 SXM data sheet: HBM3 rate, the TF32 tensor-core rate (dense)
# that bounds every kernel's operations (a product's FLOP counted once,
# whatever split of its operands a kernel runs), and the float32 rate
# outside the tensor cores, printed beside it
PEAK_BYTES_PER_S = 3.35e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
RTOL, ATOL = 1e-4, 1e-6            # K1, K2, K3
MLP_RTOL, MLP_ATOL = 1e-4, 1e-5    # K4, K5, K6 (H=4096 too)
# K4 at H=4096 on data whose float32 update is ill-conditioned (data
# seeds 5-8): after the first step at lr 0.5 the logits reach ~100, where
# a relu gate or a softmax near-tie flips with the summation order, and
# every float32 version, the JAX function on the CPU too, strays from
# float64 on a few hundred of the 4.2M elements (tests/
# test_torch_mlp_wide.py).  There the kernel holds the MLP tolerance on
# all but at most this share of delta's elements, each within this bound
OUTLIER_SHARE, OUTLIER_ABS = 5e-4, 5e-4

F, C, B, K, H, GANG = 1024, 5, 1024, 2, 128, 4
WIDE_H = 4096                      # the fused MLP path's hidden width
FUSED_MLP_ROUNDS = 40
BIG_B = 16384                      # K1's re-staged case: 64 MiB of x
WORKERS, MAX_BUFFER, TRAIN_ROWS, TEST_ROWS = 4, 1024, 6000, 2000
ITERS, SLICE1_ITERS = 100, 100
# the codecs of --compress at logreg's, the MLP's (H=128) and the wide
# MLP's (H=4096) parameter counts
CODEC_NAMES = ("bf16", "int8", "topk:0.01")
CODEC_SIZES = (6150, 131974, 4222982)
EF_STEPS, CRASH_AT = 50, 20
# the durable log's checks: the in-process crash and its restart, the
# CLI crash (512 rows = 4 workers x the default 128 prefill) and the
# main-path runs on the log
DURABLE_ITERS, DURABLE_CRASH_AT = 200, 120
CLI_CRASH_ROWS, CLI_KILL_AT, CRASH_ITERS = 512, 130, 200
COMPRESSED_WIDE_ITERS, RESUME_ITERS = 40, 100
# the split phase: server iterations of its runs
SPLIT_ITERS, SPLIT_SHORT, SPLIT_WIDE = 100, 100, 40
# the scale-out phase: server iterations of its runs, and of its in-process
# reference checks
SCALE_ITERS, SCALE_SHORT, SCALE_WIDE, SCALE_REF_ITERS = 200, 100, 40, 40
# the serving phase: the CSV of the bitwise pair (4 workers x the default
# 128-row prefill), the closed load's clients, the engine's batch cap
SERVE_TRAIN_ROWS, SERVE_CLIENTS, SERVE_BATCH = 512, 4, 16
# the tier phase: keys per page and the hot and warm caps in bytes, for the
# store and the run at H=4096 (65 pages: 32 hot, 16 warm, 17 cold), for
# logreg (25 pages: 2 hot, 4 warm) and a shard at H=128 (17 pages: 1 hot,
# 2 warm); server iterations of the wide run
TIER_WIDE_PAGE, TIER_WIDE_HOT, TIER_WIDE_WARM = 65536, 8388608, 4194304
TIER_PAGE, TIER_HOT, TIER_WARM = 256, 2048, 4096
TIER_SHARD_PAGE, TIER_SHARD_HOT, TIER_SHARD_WARM = 4096, 16384, 32768
TIER_WIDE_ITERS = 40
# the telemetry phase: server iterations of its runs, and of its
# --device_trace runs
TEL_ITERS, TEL_TRACE_ITERS = 400, 100
# the role telemetry phase: server iterations of its runs, and the shard
# checkpoint cadence of its killed-shard run
ROLE_ITERS, ROLE_CK_EVERY = 100, 10
# the role telemetry phase's traced and untraced split runs, alternated
ROLE_PAIR_ITERS = 300
# the drift pair: the clean rows before the injection, the rows after it,
# the server iterations of each run, and its buffer cap (the JAX drift
# block's, so that the injected rows replace the clean ones)
DRIFT_CLEAN, DRIFT_INJECTED, DRIFT_ITERS, DRIFT_BUFFER = 1000, 1000, 960, 256
# the multi-device phase: server iterations of its logreg runs, rounds of
# its H=4096 job, and the ground-truth fit's full-batch steps
MD_ITERS, MD_WIDE_ROUNDS, GT_STEPS = 100, 10, 100
# the [status] cadence of the telemetry phases' runs: a run of a few
# hundred iterations can end within half a second, and a reporter prints
# no line at its stop
STATUS_EVERY = "0.1"
SLAB_KINDS = ("bf16", "int8")
X_BYTES = {"bf16": 2, "int8": 1}
# the Pallas body each storage form of K3 and K5 replaces
K3_REPLACES = {"bf16": "kafka_ps_tpu/ops/fused_update.py:512",
               "int8": "kafka_ps_tpu/ops/fused_update.py:522"}
K5_REPLACES = {"bf16": "kafka_ps_tpu/ops/fused_update.py:719",
               "int8": "kafka_ps_tpu/ops/fused_update.py:725"}
NO_LIBRARY = ("no single PyTorch call computes the k-step update; the "
              "plain version is a chain of eager ops")
NO_TRACE = "(no device trace: CUDA events)"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def ptxas_summary(log: str) -> str:
    """The ptxas -v lines of the kernels the main path runs (R=6 template
    instances and the passes not templated on R, the wide MLP passes
    among them)."""
    keep, out = False, []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = any(k in line for k in ("Li6E", "hidden_pass",
                                           "update_pass", "loss_reduce",
                                           "split_pass", "transpose_pass",
                                           "tail_pass"))
        if keep:
            out.append(line.strip())
    return "\n".join(out)


WIDE = "mlp_wide_launches"
WIDE_TILES = ("mlp_wide_update_tiles", "mlp_wide_overlapped_tiles")


def other_kernels(n: dict, mine: tuple, task: str, kind: str, hidden: int,
                  calls: int, tag: str) -> dict:
    """The counters of `n` outside `mine` that are not 0.  The wide MLP
    passes' counters are no other kernel: `mlp_wide_launches` must equal
    `calls` (the run's MLP kernel calls) where an MLP call of this shape
    and form takes the wide passes, and be 0 elsewhere; its update-pass
    tiles are more than 0 exactly where it is, and at least the tiles
    that overlapped."""
    from kafka_ps_tpu_torch.ops import fused_update as fu
    wide = task == "mlp" and fu.mlp_wide_path(B, F, hidden, kind)
    if n.get(WIDE, 0) != (calls if wide else 0):
        raise RuntimeError(f"{tag}: {n.get(WIDE, 0)} wide MLP kernel calls "
                           f"of {calls} (the wide passes "
                           f"{'should' if wide else 'should not'} run)")
    tiles, overlapped = (n.get(k, 0) for k in WIDE_TILES)
    if (tiles > 0) != (n.get(WIDE, 0) > 0) or not 0 <= overlapped <= tiles:
        raise RuntimeError(f"{tag}: {tiles} wide update-pass tiles, "
                           f"{overlapped} overlapped, over "
                           f"{n.get(WIDE, 0)} wide MLP kernel calls")
    return {k: v for k, v in n.items()
            if k not in mine and k not in (WIDE, *WIDE_TILES) and v}


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


def device_trace(fn, reps=20, tries=3) -> list:
    """(kernel name, device us over `reps` calls, launches) of each kernel
    `fn` launches, from a torch.profiler trace.  A trace that holds no
    device time is taken again, up to `tries` traces in all: on the card
    a trace of a few short launches has come back empty."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us > 0:
                rows.append((e.key, us, e.count))
        if rows:
            return rows
    return []


def device_ms(fn, reps=20) -> tuple[float, dict, float]:
    """Device time per call of the kernels `fn` launches, from a
    torch.profiler trace: (total ms, {kernel name: ms}, CUDA launches per
    call).  Where every trace came back empty, the median CUDA-event time
    of a call stands in for the total, under the one name NO_TRACE, and
    the launches are nan."""
    rows = device_trace(fn, reps)
    if not rows:
        ms = time_ms(fn)
        print(f"torch.profiler traced no device time in 3 traces; CUDA "
              f"events instead: {ms:.4f} ms per call")
        return ms, {NO_TRACE: ms}, float("nan")
    per = {key: us / reps / 1e3 for key, us, _ in rows}
    return sum(per.values()), per, sum(n for _, _, n in rows) / reps


def bound(nbytes: int, flops: int) -> tuple[float, str, str]:
    """The least time for the work: the larger of bytes over the memory
    rate and operations over the TF32 tensor-core rate (the old f32-rate
    figure is printed beside it, not used)."""
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    op_ms = flops / PEAK_TF32_FLOPS * 1e3
    by = "bytes" if byte_ms >= op_ms else "operations"
    return max(byte_ms, op_ms), by, (
        f"bytes {nbytes} -> {byte_ms:.6f} ms at 3.35 TB/s; {flops} "
        f"FLOP -> {op_ms:.6f} ms at 495 TFLOP/s TF32 (at the f32 rate of "
        f"67 TFLOP/s: {flops / PEAK_F32_FLOPS * 1e3:.6f} ms)")


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


def compare_outliers(name, out, ref) -> float:
    """compare() at the MLP's tolerance for the losses, and for all but
    OUTLIER_SHARE of delta's elements, each of those within OUTLIER_ABS."""
    d, r = out[0].reshape(-1), ref[0].reshape(-1)
    err = (d - r).abs()
    outside = int((err > MLP_ATOL + MLP_RTOL * r.abs()).sum())
    max_abs, allowed = float(err.max()), int(OUTLIER_SHARE * d.numel())
    print(f"{name} vs plain on the card: {outside} of {d.numel()} delta "
          f"elements outside rtol={MLP_RTOL}, atol={MLP_ATOL} (at most "
          f"{allowed}), max_abs={max_abs:.3e} (at most {OUTLIER_ABS}); "
          f"median |delta| {float(r.abs().median()):.3e}; loss "
          f"{float(out[1])} vs {float(ref[1])}")
    if outside > allowed or max_abs > OUTLIER_ABS:
        raise RuntimeError(f"{name}: {outside} elements outside the MLP "
                           f"tolerance, max_abs {max_abs:.3e}")
    torch.testing.assert_close(out[1], ref[1], rtol=MLP_RTOL, atol=MLP_ATOL)
    if not torch.isfinite(d).all():
        raise RuntimeError(f"{name}: non-finite output")
    return max_abs


def kernel_entry(name, source, replaces, call, plain, nbytes, flops,
                 max_abs) -> dict:
    ms = time_ms(call)
    plain_ms = time_ms(plain)
    dev_ms, per_kernel, cuda_launches = device_ms(call)
    bound_ms, by, detail = bound(nbytes, flops)
    print(f"{name} device time per call (torch.profiler, kernels only): "
          f"{dev_ms:.4f} ms; " + "; ".join(
              f"{k[:60]} {v:.4f}" for k, v in sorted(per_kernel.items())))
    print(f"{name} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.6f} ({detail}); CUDA launches per call "
          f"{cuda_launches:g} (torch.profiler); library_ms=null "
          f"({NO_LIBRARY})")
    return {"name": name, "route": "cuda",
            "source": f"kafka_ps_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "launches": 0, "max_abs_err": max_abs,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": None}


def stored_x_bytes(kind: str) -> int:
    """Bytes of one [B, F] slab x stored as `kind` (int8: q and the B row
    scales)."""
    return B * F * X_BYTES[kind] + (4 * B if kind == "int8" else 0)


def check_stored(name, single, batched, plain, gang, kind, cfg, rtol,
                 atol) -> tuple[float, list]:
    """K3 or K5 on `kind` slabs (x encoded on the card): against the plain
    version, two launches bitwise equal, and a gang of the stored slabs
    bitwise equal to single calls.  Returns (max abs error, the stored
    gang)."""
    from kafka_ps_tpu_torch.compress.slab import encode_x
    stored = [[t, encode_x(kind, x), y, m] for t, x, y, m in gang]
    args = stored[0]
    r1, r2 = single(*args, cfg=cfg), single(*args, cfg=cfg)
    torch.cuda.synchronize()
    err = compare(f"{name} {kind}", r1, plain(*args, cfg=cfg), rtol, atol)
    if not (torch.equal(r1[0], r2[0]) and torch.equal(r1[1], r2[1])):
        raise RuntimeError(f"{name} {kind}: two launches differ")
    members = [list(a) for a in zip(*stored)]
    b = batched(*members, cfg=cfg)
    singles = [single(*g, cfg=cfg) for g in stored]
    if not all(torch.equal(b[0][i], d) and torch.equal(b[1][i], loss)
               for i, (d, loss) in enumerate(singles)):
        raise RuntimeError(f"{name} {kind}: a gang of {len(stored)} is not "
                           "bitwise the single calls")
    print(f"{name} {kind}: two launches bitwise equal, a gang of "
          f"{len(stored)} bitwise equal to {len(stored)} single calls: True")
    return err, stored


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
    big = member_inputs(dev, P, 41, batch=BIG_B)
    compare(f"K1 local_update (B={BIG_B}, x re-staged)",
            fu.local_update(*big, cfg=cfg),
            fu.local_update_plain(*big, cfg=cfg), RTOL, ATOL)
    for kind, count, batch in (("f32", 1, B), ("f32", GANG, B),
                               ("f32", 1, BIG_B), ("bf16", 1, B),
                               ("int8", 1, B)):
        print(f"logreg cooperative launch ({kind}, {count} member(s), "
              f"B={batch}): {fu.logreg_plan(batch, F, R, count, kind)}")
    nbytes = 4 * (B * F + 2 * B + 2 * P + 1)   # x, y, mask, theta, delta, loss
    flops = (4 * K + 2) * B * F * R            # 2k+1 passes of 2 B*F*R
    out["local_update"] = kernel_entry(
        "local_update", "local_update.cu",
        "kafka_ps_tpu/ops/fused_update.py:86",
        lambda: fu.local_update(*args, cfg=cfg),
        lambda: fu.local_update_plain(*args, cfg=cfg),
        nbytes, flops, k1_err)
    out["local_update_batched"] = kernel_entry(
        "local_update_batched", "local_update.cu",
        "kafka_ps_tpu/ops/fused_update.py:845",
        lambda: fu.local_update_batched(*members, cfg=cfg),
        lambda: fu.local_update_batched_plain(*members, cfg=cfg),
        GANG * nbytes, GANG * flops, k2_err)
    for kind in SLAB_KINDS:
        err, stored = check_stored("K3 stream_update", fu.stream_update,
                                   fu.local_update_batched,
                                   fu.local_update_plain, gang, kind, cfg,
                                   RTOL, ATOL)
        sargs = stored[0]
        out[f"stream_update_{kind}"] = kernel_entry(
            f"stream_update_{kind}", "local_update.cu", K3_REPLACES[kind],
            lambda a=sargs: fu.stream_update(*a, cfg=cfg),
            lambda a=sargs: fu.local_update_plain(*a, cfg=cfg),
            stored_x_bytes(kind) + 4 * (2 * B + 2 * P + 1), flops, err)

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
    from kafka_ps_tpu_torch.compress.slab import encode_x
    for kind in SLAB_KINDS:
        odd_stored = [odd_args[0], encode_x(kind, odd_args[1]),
                      *odd_args[2:]]
        compare(f"K5 mlp_stream_update {kind} (H=100, B=1000)",
                fu.mlp_stream_update(*odd_stored, cfg=odd),
                fu.mlp_local_update_plain(*odd_stored, cfg=odd),
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
        nbytes, flops, k4_err)
    cublas_yardstick(args, mcfg)
    out["mlp_local_update_batched"] = kernel_entry(
        "mlp_local_update_batched", "mlp_update.cu",
        "kafka_ps_tpu/ops/fused_update.py:939",
        lambda: fu.mlp_local_update_batched(*members, cfg=mcfg),
        lambda: fu.mlp_local_update_batched_plain(*members, cfg=mcfg),
        GANG * nbytes, GANG * flops, k6_err)
    for kind in SLAB_KINDS:
        err, stored = check_stored("K5 mlp_stream_update",
                                   fu.mlp_stream_update,
                                   fu.mlp_local_update_batched,
                                   fu.mlp_local_update_plain, gang, kind,
                                   mcfg, MLP_RTOL, MLP_ATOL)
        sargs = stored[0]
        out[f"mlp_stream_update_{kind}"] = kernel_entry(
            f"mlp_stream_update_{kind}", "mlp_update.cu", K5_REPLACES[kind],
            lambda a=sargs: fu.mlp_stream_update(*a, cfg=mcfg),
            lambda a=sargs: fu.mlp_local_update_plain(*a, cfg=mcfg),
            stored_x_bytes(kind) + 4 * (2 * B + 2 * MP + 1), flops, err)
        smembers = [list(a) for a in zip(*stored)]
        dev_ms, _, _ = device_ms(
            lambda m=smembers: fu.mlp_local_update_batched(*m, cfg=mcfg))
        print(f"K5 {kind} gang of {GANG} stored slabs, device time per "
              f"call (torch.profiler): {dev_ms:.4f} ms")
    return out


def cublas_yardstick(args, cfg) -> None:
    """One x @ W1.T at the call's shape through cuBLAS in f32 (TF32
    off), beside the device time of one hidden pass launch of K4 (k+1 of
    them per call; `wide_hidden_pass` on the wide passes), which computes
    the same product (plus bias and relu), and one dh.T @ x beside one
    update pass launch (k per call), which computes dW1 and applies it:
    yardsticks for a single product, not library times of the kernel."""
    from kafka_ps_tpu_torch.models import mlp
    from kafka_ps_tpu_torch.ops import fused_update as fu
    x, w1 = args[1], mlp.unflatten(args[0], cfg).w1
    dh = torch.randn(B, cfg.hidden_dim, device=x.device,
                     generator=torch.Generator(x.device).manual_seed(3))
    pre_ms, _, _ = device_ms(lambda: torch.matmul(x, w1.t()))
    dw1_ms, _, _ = device_ms(lambda: torch.matmul(dh.t(), x))
    _, per, _ = device_ms(lambda: fu.mlp_local_update(*args, cfg=cfg))
    wide = fu.mlp_wide_path(B, F, cfg.hidden_dim, "f32")
    names = (("wide_hidden_pass", "wide_update_pass") if wide
             else ("hidden_pass", "update_pass"))
    hidden = sum(v for key, v in per.items() if names[0] in key) / (K + 1)
    update = sum(v for key, v in per.items() if names[1] in key) / K
    print(f"yardstick x @ W1.T [{B},{F}]x[{F},{cfg.hidden_dim}]: cuBLAS f32 "
          f"(TF32 off) {pre_ms:.4f} ms device; K4 {names[0]} "
          f"{hidden:.4f} ms device per launch ({times(hidden, pre_ms)} "
          f"cuBLAS)")
    print(f"yardstick dh.T @ x [{cfg.hidden_dim},{B}]x[{B},{F}]: cuBLAS f32 "
          f"(TF32 off) {dw1_ms:.4f} ms device; K4 {names[1]} "
          f"{update:.4f} ms device per launch ({times(update, dw1_ms)} "
          f"cuBLAS)")


def times(ms: float, base: float) -> str:
    """`ms` as a multiple of `base`, or "n/a x" where either is 0 (no
    device time traced)."""
    return f"{ms / base:.3f}x" if ms > 0 and base > 0 else "n/a x"


def pass_breakdown(label, fn, reps=20) -> None:
    """The device ms per call of each pass `fn` launches, from a
    torch.profiler trace, by kernel name and template arguments."""
    rows = []
    for key, us, count in device_trace(fn, reps):
        m = re.search(r"(\w+)(<[^()]*>)?\(", key)
        rows.append((m.group(1) + (m.group(2) or "") if m else key[:60],
                     us / reps / 1e3, count / reps))
    print(f"{label} device ms per call by pass (torch.profiler): "
          + ("; ".join(f"{name} {ms:.4f} ({n:g} launches)"
                       for name, ms, n in rows) or "no device time traced")
          + f"; total {sum(ms for _, ms, _ in rows):.4f}")


def wide_mlp_phase(dev) -> dict:
    """K4 and K6 at the fused MLP path's width (H=4096, 4,222,982
    parameters), K6's members sharing one theta as in a fused round."""
    from kafka_ps_tpu_torch.data.synth import generate
    from kafka_ps_tpu_torch.models import mlp
    from kafka_ps_tpu_torch.ops import fused_update as fu
    from kafka_ps_tpu_torch.utils.config import ModelConfig

    cfg = ModelConfig(num_features=F, num_classes=C, num_max_iter=K,
                      local_learning_rate=0.5, hidden_dim=WIDE_H)
    R, MP = cfg.num_rows, mlp.num_params(cfg)
    theta0 = mlp.init_params(cfg, "cpu").numpy()
    gang = [member_inputs(dev, MP, 51 + i, theta0) for i in range(GANG)]
    theta = gang[0][0]
    members = [[theta] * GANG] + [[g[i] for g in gang] for i in (1, 2, 3)]
    args = [m[0] for m in members]
    k4 = fu.mlp_local_update(*args, cfg=cfg)
    k4_ref = fu.mlp_local_update_plain(*args, cfg=cfg)
    torch.cuda.synchronize()
    k4_err = compare(f"K4 mlp_local_update (H={WIDE_H})", k4, k4_ref,
                     MLP_RTOL, MLP_ATOL)
    b1 = fu.mlp_local_update_batched(*members, cfg=cfg)
    b2 = fu.mlp_local_update_batched(*members, cfg=cfg)
    ref = fu.mlp_local_update_batched_plain(*members, cfg=cfg)
    torch.cuda.synchronize()
    k6_err = compare(f"K6 mlp_local_update_batched (H={WIDE_H}, one "
                     "theta)", b1, ref, MLP_RTOL, MLP_ATOL)
    print(f"K6 (H={WIDE_H}) median |delta| per member (plain version): "
          + ", ".join(f"{float(d.abs().median()):.3e}" for d in ref[0])
          + "; max |delta| " + ", ".join(f"{float(d.abs().max()):.3e}"
                                         for d in ref[0]))
    singles = [fu.mlp_local_update(*m, cfg=cfg) for m in zip(*members)]
    same = all(torch.equal(b1[0][i], d) and torch.equal(b1[1][i], loss)
               for i, (d, loss) in enumerate(singles))
    if not (same and torch.equal(b1[0], b2[0]) and torch.equal(b1[1], b2[1])
            and torch.equal(singles[0][0], k4[0])):
        raise RuntimeError(f"K6 (H={WIDE_H}): not bitwise equal to {GANG} "
                           "K4 calls, or two launches differ")
    print(f"K6 (H={WIDE_H}, {GANG} members, one theta) bitwise equal to "
          f"{GANG} K4 calls and across two launches: True")
    fu.reset_counts()
    fu.mlp_local_update(*args, cfg=cfg)
    fu.mlp_local_update_batched(*members, cfg=cfg)
    n = fu.counts()
    calls = n["mlp_launches"] + n["mlp_batched_launches"]
    print(f"K4 and K6 (H={WIDE_H}): {n[WIDE]} of {calls} wrapper calls took "
          "the wide passes (mlp_wide_launches)")
    if calls != 2 or n[WIDE] != calls:
        raise RuntimeError(f"H={WIDE_H}: {n[WIDE]} wide launches of {calls} "
                           "K4 and K6 calls")
    pass_breakdown(f"K4 (H={WIDE_H})",
                   lambda: fu.mlp_local_update(*args, cfg=cfg))
    pass_breakdown(f"K6 (H={WIDE_H}, {GANG} members)",
                   lambda: fu.mlp_local_update_batched(*members, cfg=cfg))
    # x, y, mask of each member, theta once; deltas and losses out
    nbytes = 4 * (GANG * (B * F + 2 * B + MP + 1) + MP)
    flops = GANG * ((4 * K + 2) * B * F * WIDE_H
                    + (6 * K + 2) * B * WIDE_H * R)
    entry = kernel_entry(
        f"mlp_local_update_batched_h{WIDE_H}", "mlp_update.cu",
        "kafka_ps_tpu/ops/fused_update.py:939",
        lambda: fu.mlp_local_update_batched(*members, cfg=cfg),
        lambda: fu.mlp_local_update_batched_plain(*members, cfg=cfg),
        nbytes, flops, k6_err)
    cublas_yardstick(args, cfg)
    # K4 alone at this width: the split phase's wide run calls it.  On the
    # TPU a single call at this width is the streamed kernel's
    # (mlp_fits_in_vmem is false), and the gang falls back to XLA
    k4_entry = kernel_entry(
        f"mlp_local_update_h{WIDE_H}", "mlp_update.cu",
        "kafka_ps_tpu/ops/fused_update.py:784",
        lambda: fu.mlp_local_update(*args, cfg=cfg),
        lambda: fu.mlp_local_update_plain(*args, cfg=cfg),
        4 * (B * F + 2 * B + 2 * MP + 1),
        (4 * K + 2) * B * F * WIDE_H + (6 * K + 2) * B * WIDE_H * R, k4_err)
    # the members of tests/test_torch_mlp_wide.py: on data seed 8 the
    # float32 update is ill-conditioned (a relu gate or softmax near-tie
    # at logits of ~100), and only there are outliers allowed
    rng = np.random.default_rng(5)
    theta = torch.from_numpy((theta0 + rng.normal(scale=0.01, size=MP))
                             .astype(np.float32)).to(dev)
    mask = (torch.arange(B, device=dev) < B - 100).float()
    for seed in (5, 6, 7, 8):
        x, y = generate(B, F, C, seed=seed)
        member = (theta, torch.from_numpy(x).to(dev),
                  torch.from_numpy(y).to(dev), mask)
        out = fu.mlp_local_update(*member, cfg=cfg)
        ref = fu.mlp_local_update_plain(*member, cfg=cfg)
        name = f"K4 (H={WIDE_H}, data seed {seed})"
        if seed == 8:
            compare_outliers(name, out, ref)
        else:
            compare(name, out, ref, MLP_RTOL, MLP_ATOL)
    return {entry["name"]: entry, k4_entry["name"]: k4_entry}


def small_app(device, c, task="logreg", workers=3, logs=None, fabric=None,
              rows=150, **kw):
    """The reference checks' trainer: 64 features, 5 classes, buffers of
    8-32 rows prefilled with `rows` of 150 seeded rows, a fixed arrival
    clock; on `fabric` when one is given (a durable log)."""
    from kafka_ps_tpu_torch.data.synth import generate
    from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
    from kafka_ps_tpu_torch.utils.config import (BufferConfig, ModelConfig,
                                                 PSConfig)
    cfg = PSConfig(num_workers=workers, consistency_model=c, task=task,
                   model=ModelConfig(num_features=64, num_classes=5,
                                     hidden_dim=32),
                   buffer=BufferConfig(min_size=8, max_size=32), **kw)
    x, y = generate(200, 64, 5, seed=2, center_scale=0.3)
    logs = logs if logs is not None else ([], [])
    app = StreamingPSApp(cfg, test_x=x[150:], test_y=y[150:],
                         server_log=logs[0].append, worker_log=logs[1].append,
                         clock_ms=iter(range(0, 10 ** 9, 40)).__next__,
                         device=device, fabric=fabric)
    for i in range(rows):
        app.data_sink(i % workers, x[i], int(y[i]))
    return app


def small_run(device, c, task="logreg", iters=30, **kw):
    """(theta, server rows, worker rows) of a small serial run."""
    server, worker = [], []
    app = small_app(device, c, task, logs=(server, worker), **kw)
    app.run_serial(iters)
    app.close_logs()
    return app.server.theta, server, worker


def row_keys(server, worker):
    return [r.split(";")[1:3] for r in server] + [
        r.split(";")[1:3] + r.split(";")[6:] for r in worker]


def strip_stamps(rows):
    return [r.split(";", 1)[1] for r in rows]


def reference_check(dev) -> None:
    """The trainer on the card against the same serial run on the CPU,
    and the gang and async-eval levers on the card."""
    run = small_run
    keys, strip = row_keys, strip_stamps
    for task, cs in (("logreg", (0, 2, -1)), ("mlp", (0,))):
        for c in cs:
            on_card = {}
            for kind in ("f32", *SLAB_KINDS):
                t_gpu, s_gpu, w_gpu = on_card[kind] = run(dev, c, task,
                                                          slab_dtype=kind)
                t_cpu, s_cpu, w_cpu = run("cpu", c, task, slab_dtype=kind)
                if keys(s_gpu, w_gpu) != keys(s_cpu, w_cpu):
                    raise RuntimeError(f"{task} -c {c} {kind}: row keys "
                                       "differ card vs CPU")
                torch.testing.assert_close(t_gpu.cpu(), t_cpu, rtol=1e-4,
                                           atol=1e-5)
                print(f"reference check {task} -c {c} {kind} slab (gang, "
                      f"async eval): card vs CPU rows equal, theta max_abs="
                      f"{float((t_gpu.cpu() - t_cpu).abs().max()):.3e}")
                if kind == "bf16":
                    continue
                t_off, s_off, w_off = run(dev, c, task, use_gang=False,
                                          slab_dtype=kind)
                if not (torch.equal(t_gpu, t_off)
                        and strip(w_gpu) == strip(w_off)):
                    raise RuntimeError(f"{task} -c {c} {kind}: gang on/off "
                                       "differ on the card")
                print(f"reference check {task} -c {c} {kind} on the card: "
                      "gang on/off theta bitwise equal")
            t_gpu, s_gpu, _ = on_card["f32"]
            t_fused, s_fused, _ = run(dev, c, task, eval_async=False)
            if not (torch.equal(t_gpu, t_fused)
                    and strip(s_gpu) == strip(s_fused)):
                raise RuntimeError(f"{task} -c {c}: async/fused eval rows "
                                   "differ on the card")
            print(f"reference check {task} -c {c} on the card: async/fused "
                  f"server rows identical ({len(s_gpu)} rows)")


def codec_phase(dev) -> None:
    """The codecs of --compress on the card at the three model sizes:
    parts bitwise the CPU's, decode(unpack(pack(parts))) bitwise
    decode(parts), error feedback over EF_STEPS steps keeping the sum of
    the true deltas (sent + residual, float64, within 1e-3) and a
    restored ErrorFeedback continuing bitwise; median ms per ef_step and
    per WeightsCompressor.encode, and the packed bytes against 4n."""
    from kafka_ps_tpu_torch import compress
    from kafka_ps_tpu_torch.compress import wire
    from kafka_ps_tpu_torch.compress.codecs import Codec
    for n in CODEC_SIZES:
        rng = np.random.default_rng(n)
        v_cpu = torch.from_numpy(
            (rng.standard_normal(n) * 0.1).astype(np.float32))
        v = v_cpu.to(dev)
        for name in CODEC_NAMES:
            spec = wire.parse_codec(name)
            codec = compress.get_codec(spec, n)
            parts = codec.encode(v)
            host = Codec.host_parts(parts)
            if not all(a.dtype == b.dtype and np.array_equal(a, b) for a, b
                       in zip(host, Codec.host_parts(codec.encode(v_cpu)))):
                raise RuntimeError(f"codec {name} n={n}: parts on the card "
                                   "differ from the CPU's")
            flags, aux, blob = wire.pack_parts(spec.codec_id, host, n)
            back = wire.unpack_parts(spec.codec_id, flags, aux, blob, n)
            if not torch.equal(codec.decode(*parts),
                               codec.decode(*back, device=dev)):
                raise RuntimeError(f"codec {name} n={n}: decode after "
                                   "pack/unpack differs")
            gen = torch.Generator(device=dev).manual_seed(7)
            ef = compress.ErrorFeedback(codec, dev)
            true = torch.zeros(n, dtype=torch.float64, device=dev)
            sent = torch.zeros(n, dtype=torch.float64, device=dev)
            restored, continued = None, True
            for i in range(EF_STEPS):
                delta = torch.randn(n, generator=gen, device=dev) * 0.1
                decoded, _ = ef.step(delta)
                if restored is not None:
                    again, _ = restored.step(delta)
                    continued = continued and torch.equal(
                        again, decoded) and torch.equal(restored.residual,
                                                        ef.residual)
                true += delta.double()
                sent += decoded.double()
                if i == EF_STEPS // 2:
                    restored = compress.ErrorFeedback(codec, dev)
                    restored.restore(ef.state())
            drift = float((sent + ef.residual.double() - true).abs().max())
            delta = torch.randn(n, generator=gen, device=dev) * 0.1
            ef_ms = time_ms(lambda: ef.step(delta), reps=50)
            wc = compress.WeightsCompressor(codec)

            def encode():
                wc._cache = None         # a new theta each call
                return wc.encode(v)
            enc_ms = time_ms(encode, reps=50)
            print(f"codec {name} n={n}: parts card == CPU, decode after "
                  f"pack/unpack bitwise; error feedback over {EF_STEPS} "
                  f"steps: |sent + residual - sum of deltas| max "
                  f"{drift:.3e} (at most 1e-3), restored at step "
                  f"{EF_STEPS // 2 + 1} continues bitwise: {continued}; "
                  f"ef_step {ef_ms:.4f} ms, WeightsCompressor.encode "
                  f"{enc_ms:.4f} ms (CUDA events, median of 50); packed "
                  f"{len(blob)} bytes of {4 * n} ({4 * n / len(blob):.2f}x)")
            if drift >= 1e-3 or not continued:
                raise RuntimeError(f"codec {name} n={n}: error feedback "
                                   "lost the signal or did not continue "
                                   "after a restore")


def codec_step(codec: str, theta: torch.Tensor) -> float:
    """The most one flipped code changes a decoded element of theta: a
    bf16 rounding step of the largest element, an int8 quantization step
    of the coarsest chunk, for top-k the k-th largest magnitude (an
    element kept or dropped at the boundary)."""
    mags = theta.abs()
    if codec == "bf16":
        return float(mags.max()) * 2.0 ** -8
    if codec == "int8":
        return float(mags.max()) / 127.0
    k = max(1, round(float(codec.split(":")[1]) * theta.numel()))
    return float(mags.topk(k).values[-1])


def compress_reference_check(dev) -> None:
    """--compress on the card: logreg -c 0 under each codec and the MLP
    -c 0 under int8 against the CPU (row keys exact; theta within one
    step of its codec at theta's scale, the most one flipped code moves a
    decoded element: a last-bit difference of the kernel can flip a code,
    tests/test_torch_compress_runs.py), and gang on/off bitwise under
    int8."""
    for task, codec in (("logreg", "bf16"), ("logreg", "int8"),
                        ("logreg", "topk:0.01"), ("mlp", "int8")):
        t_gpu, s_gpu, w_gpu = small_run(dev, 0, task, compress=codec)
        t_cpu, s_cpu, w_cpu = small_run("cpu", 0, task, compress=codec)
        if row_keys(s_gpu, w_gpu) != row_keys(s_cpu, w_cpu):
            raise RuntimeError(f"{task} --compress {codec}: row keys differ "
                               "card vs CPU")
        step = codec_step(codec, t_cpu)
        err = float((t_gpu.cpu() - t_cpu).abs().max())
        print(f"reference check {task} -c 0 --compress {codec}: card vs CPU "
              f"rows equal, theta max_abs={err:.3e} (at most {step:.3e})")
        if err > step:
            raise RuntimeError(f"{task} --compress {codec}: theta off by "
                               f"{err:.3e}")
    for c in (0, 2):
        t_on, _, w_on = small_run(dev, c, compress="int8")
        t_off, _, w_off = small_run(dev, c, compress="int8", use_gang=False)
        if not (torch.equal(t_on, t_off)
                and strip_stamps(w_on) == strip_stamps(w_off)):
            raise RuntimeError(f"--compress int8 -c {c}: gang on/off differ "
                               "on the card")
        print(f"reference check logreg -c {c} --compress int8 on the card: "
              "gang on/off theta and worker rows bitwise equal")


def resume_check(dev) -> None:
    """On static data, on the card: 100 iterations, a checkpoint, a fresh
    app restored from it and 100 more equal a 200-iteration run bitwise
    (theta, the residuals, the second half's rows), f32 and int8."""
    import tempfile

    from kafka_ps_tpu_torch.utils import checkpoint as ckpt
    for codec in ("none", "int8"):
        whole_logs = ([], [])
        whole = small_app(dev, 0, workers=4, logs=whole_logs, compress=codec)
        whole.run_serial(100)
        whole.flush_logs()
        cut = [len(rows) for rows in whole_logs]
        whole.run_serial(200)
        whole.close_logs()
        first = small_app(dev, 0, workers=4, compress=codec)
        first.run_serial(100)
        first.close_logs()
        with tempfile.TemporaryDirectory(dir=OUT) as tmp:
            path = os.path.join(tmp, "ck.npz")
            ckpt.save(path, first.server, buffers=first.buffers,
                      residuals=first.compressors or None)
            resumed_logs = ([], [])
            resumed = small_app(dev, 0, workers=4, logs=resumed_logs,
                                compress=codec)
            if not resumed.restore_checkpoint(path):
                raise RuntimeError("checkpoint not found")
        resumed.run_serial(200)
        resumed.close_logs()
        same = (torch.equal(resumed.server.theta, whole.server.theta)
                and all(strip_stamps(r) == strip_stamps(w[k:]) for r, w, k
                        in zip(resumed_logs, whole_logs, cut))
                and all(torch.equal(a.residual, b.residual) for a, b in zip(
                    resumed.compressors.values(),
                    whole.compressors.values())))
        print(f"resume check --compress {codec} on the card: 100 + 100 "
              f"iterations through a checkpoint bitwise equal to 200: {same}"
              f" (theta, residuals, {len(resumed_logs[0])} server and "
              f"{len(resumed_logs[1])} worker rows)")
        if not same:
            raise RuntimeError(f"--compress {codec}: the resumed run differs "
                               "from the uninterrupted one")


def serde_ms(stats: dict) -> str:
    """A durable log's serde milliseconds per encoded frame, by topic."""
    return ", ".join(f"{t} {ms:.4f}" for t, ms in
                     sorted(stats["serde_ms_per_frame"].items()))


def remove(path: str) -> None:
    """Delete a file or a directory tree, if there."""
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.remove(path)


def rows_from(rows, clocks):
    """Stamp-stripped rows whose clock is at least its worker's clock in
    `clocks` (server rows are worker 0's eval clocks)."""
    out = []
    for r in strip_stamps(rows):
        part, clock = (int(v) for v in r.split(";")[:2])
        if clock >= clocks[max(part, 0)]:
            out.append(r)
    return out


def first_of_each_clock(rows):
    """Stamp-stripped worker rows, one per (worker, clock), sorted: a plain
    worker trains again on a replayed weights clock, and that row must be
    bitwise its first."""
    seen = {}
    for r in strip_stamps(rows):
        if seen.setdefault(tuple(r.split(";")[:2]), r) != r:
            raise RuntimeError(f"a replayed clock's row differs: {r}")
    return sorted(seen.values())


def durable_reference_check(dev) -> None:
    """On the card, logreg serial -c 0, 4 workers, gang on, static data:
    200 iterations on the volatile fabric against a run on the durable
    log (checkpoint every 50) abandoned at iteration 120 — no close, no
    final save — whose log and checkpoint a fresh app restores, replays
    and runs to 200.  θ, clocks, the restarted run's server and worker
    rows (stamps stripped) and under int8 the residuals are bitwise the
    uninterrupted run's; weights and gradients were replayed and at least
    one redelivered gradient dropped.  --compress none and int8."""
    import tempfile

    from kafka_ps_tpu_torch.log import DurableFabric, LogConfig
    for codec in ("none", "int8"):
        whole_logs = ([], [])
        whole = small_app(dev, 0, workers=4, logs=whole_logs, compress=codec)
        whole.run_serial(DURABLE_ITERS)
        whole.close_logs()
        with tempfile.TemporaryDirectory(dir=OUT) as tmp:
            ck = os.path.join(tmp, "ck.npz")
            first = small_app(dev, 0, workers=4, compress=codec,
                              fabric=DurableFabric(os.path.join(tmp, "wal"),
                                                   LogConfig(fsync="none")))
            first.server.checkpoint_path = ck
            first.server.checkpoint_every = 50
            first.server.checkpoint_buffers = first.buffers
            first.run_serial(DURABLE_CRASH_AT)
            first.close_logs()         # abandoned: no close, no final save
            logs = ([], [])
            again = small_app(dev, 0, workers=4, compress=codec, logs=logs,
                              fabric=DurableFabric(os.path.join(tmp, "wal"),
                                                   LogConfig(fsync="none")),
                              rows=0)
            if not again.restore_checkpoint(ck):
                raise RuntimeError("durable check: no checkpoint")
            restored = again.server.iterations
            clocks = list(again.server.tracker.clocks)
            t0 = time.perf_counter()
            counts = again.recover_durable()
            replay_s = time.perf_counter() - t0
            again.run_serial(DURABLE_ITERS)
            again.close_logs()
            stats = again.fabric.stats()
            again.fabric.close()
        same = (torch.equal(again.server.theta, whole.server.theta)
                and again.server.tracker.clocks == whole.server.tracker.clocks
                and strip_stamps(logs[0]) == rows_from(whole_logs[0], clocks)
                and first_of_each_clock(logs[1])
                == sorted(rows_from(whole_logs[1], clocks))
                and all(torch.equal(a.residual, b.residual) for a, b in zip(
                    again.compressors.values(), whole.compressors.values())))
        dropped = again.server.duplicate_gradients_dropped
        print(f"durable check --compress {codec} on the card: crash at "
              f"{DURABLE_CRASH_AT}, restored at {restored}, replayed {counts}"
              f" in {replay_s:.4f} s, duplicates dropped {dropped}, "
              f"redelivered weights answered from cache "
              f"{sum(w.redelivered for w in again.workers)}; restart to "
              f"{DURABLE_ITERS} bitwise the uninterrupted run: {same} "
              f"(theta, clocks, {len(logs[0])} server and {len(logs[1])} "
              f"worker rows, residuals); serde ms per frame "
              f"{serde_ms(stats)}")
        if not same:
            raise RuntimeError(f"durable --compress {codec}: the restarted "
                               "run differs from the uninterrupted one")
        if (counts["weights"] < 1 or counts["gradients"] < 1
                or dropped < 1 or not 0 < restored < DURABLE_CRASH_AT):
            raise RuntimeError(f"durable --compress {codec}: nothing was "
                               "replayed, or no duplicate dropped")


def threaded_order_check(dev) -> None:
    """Threaded -c 2 on the durable log on the card, 200 iterations: every
    partition's offsets on disk are 0..n-1, none repeated, and the server
    applied the gradients in the log's offset order.  The run's locks are
    recorded (lockgraph.isolated): no cycle, some edges, and the static
    checks pass with those edges as their coverage input."""
    import tempfile

    from kafka_ps_tpu_torch.analysis import lockgraph
    from kafka_ps_tpu_torch.log import DurableFabric, LogConfig
    from kafka_ps_tpu_torch.runtime import serde
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=OUT) as tmp, \
            lockgraph.isolated() as graph:
        wal = os.path.join(tmp, "wal")
        app = small_app(dev, 2, workers=4,
                        fabric=DurableFabric(wal, LogConfig(fsync="none")))
        applied = []
        received = app.server.tracker.received_message

        def record(worker, clock):
            applied.append((worker, clock))
            return received(worker, clock)

        app.server.tracker.received_message = record
        app.run_threaded(DURABLE_ITERS, poll_timeout=0.02)
        app.close_logs()
        app.fabric.close()
        reopened = DurableFabric(wal, LogConfig(fsync="none"))
        offsets = {f"{t}/{k}": [o for o, _ in
                                reopened.manager.get(t, k).read_from(0)]
                   for t, k in reopened.manager.partitions()}
        order = [(m.worker_id, m.vector_clock) for m in (
            serde.from_bytes(p, "cpu") for _, p in reopened.manager.get(
                "gradients", 0).read_from(0))]
        reopened.close()
    contiguous = all(o == list(range(len(o))) for o in offsets.values())
    in_order = applied == order[:len(applied)]
    print(f"threaded order check on the card (-c 2, durable log): "
          f"{len(applied)} gradients applied, records per partition "
          f"{ {k: len(o) for k, o in offsets.items()} }; offsets 0..n-1 in "
          f"every partition: {contiguous}; applied in offset order: "
          f"{in_order}")
    if not (contiguous and in_order and len(applied) >= DURABLE_ITERS):
        raise RuntimeError("threaded durable run: offsets repeat or skip, "
                           "or the server's order is not the log's")
    lock_order_check(graph, t_phase)


def lock_order_check(graph, t_phase: float) -> None:
    """The recorded lock order of the threaded durable run: no cycle and
    at least one edge; then the port's static checks over the checkout
    with those edges as --lock-coverage, which must exit 0."""
    cycles = graph.cycles()
    print(f"lockgraph: {graph.acquisitions} acquisitions, "
          f"{len(graph.edges)} edges, {len(cycles)} cycles "
          f"({graph.summary()})")
    for cyc in cycles:
        print("  cycle: " + " -> ".join([e.src for e in cyc] + [cyc[0].src]))
    if cycles or not graph.edges:
        raise RuntimeError("lockgraph: the threaded durable run's locks "
                           "form a cycle, or it recorded no edge")
    edges = graph.export_edges()
    path = os.path.join(OUT, "lockgraph-edges.json")
    with open(path, "w") as f:
        json.dump({"edges": edges}, f, indent=1)
    cmd = [sys.executable, "-m", "kafka_ps_tpu_torch.analysis",
           "kafka_ps_tpu_torch/", "--lock-coverage", path, "--json"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    t_static = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"static checks exited {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}{proc.stderr[-2000:]}")
    rep = json.loads(proc.stdout)
    cov = rep["lock_coverage"]
    print(f"static checks with the card run's edges: exit 0 in "
          f"{t_static:.1f} s, "
          f"{rep['files']} files, {rep['counts']['unsuppressed']} "
          f"unsuppressed of {rep['counts']['total']} findings; the card "
          f"run covered {cov['common']} of {cov['static_edges']} static "
          f"edges between recorder-named locks, "
          f"{len(cov['runtime_only'])} edges only the run saw: "
          + ", ".join(f"{e['src']} -> {e['dst']}"
                      for e in cov["runtime_only"]))
    print(f"lock-order phase: {time.perf_counter() - t_phase:.1f} s "
          "(the threaded durable run included)")


def cli_crash_check() -> None:
    """The CLI on the card, 512 rows at F=1024, C=5 (4 workers x the
    default 128 prefill: the whole stream is buffered before the first
    iteration): an uninterrupted serial -c 0 run to CRASH_ITERS iterations
    with
    --checkpoint, against a run with --durable-log --fsync interval
    --checkpoint_every 50 that kills itself with SIGKILL right after
    iteration CLI_KILL_AT (scripts/torch_kill_at.py), past its second
    commit point, and the same command again, which restores and replays.
    The final checkpoints hold the same θ and clocks."""
    from kafka_ps_tpu_torch.data.synth import generate, write_csv
    x, y = generate(CLI_CRASH_ROWS, F, C, seed=4)
    write_csv(os.path.join(OUT, "crash-train.csv"), x, y)
    env = dict(os.environ, PYTHONPATH=REPO)
    args = ["-training", "crash-train.csv", "-test", "test.csv",
            "--num_workers", str(WORKERS), "--num_features", str(F),
            "--num_classes", str(C), "--mode", "serial", "-c", "0",
            "-p", "2", "--eval_every", "10", "--max_iterations",
            str(CRASH_ITERS), "--checkpoint_every", "50", "-v"]
    cli = [sys.executable, "-m", "kafka_ps_tpu_torch.cli.run"]
    kill = [sys.executable, os.path.join(REPO, "scripts", "torch_kill_at.py"),
            str(CLI_KILL_AT), "--"]
    wal = ["--checkpoint", "ck-crash.npz", "--durable-log", "wal-crash",
           "--fsync", "interval"]
    for stale in ("ck-base.npz", "ck-crash.npz", "wal-crash"):
        remove(os.path.join(OUT, stale))

    def run(cmd):
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=OUT, env=env, capture_output=True,
                           text=True, timeout=300)
        return r, time.perf_counter() - t0

    base, base_s = run(cli + args + ["--checkpoint", "ck-base.npz"])
    killed, killed_s = run(kill + args + wal)
    again, again_s = run(cli + args + wal)
    if base.returncode != 0 or again.returncode != 0:
        raise RuntimeError("CLI crash check: a run failed:\n"
                           + base.stderr[-2000:] + again.stderr[-2000:])
    if killed.returncode != -9:
        raise RuntimeError(f"CLI crash check: the killed run ended with "
                           f"{killed.returncode}:\n{killed.stderr[-2000:]}")
    stats = [json.loads(line.split(": ", 1)[1])
             for line in again.stderr.splitlines()
             if line.startswith("kafka_ps_tpu_torch run: ")][-1]
    restored = [ln.strip() for ln in again.stdout.splitlines()
                if "restored checkpoint at iteration" in ln
                or "durable-log replay" in ln]
    with np.load(os.path.join(OUT, "ck-base.npz")) as a, \
            np.load(os.path.join(OUT, "ck-crash.npz")) as b:
        same = (np.array_equal(a["theta"], b["theta"])
                and np.array_equal(a["clocks"], b["clocks"])
                and int(a["iterations"]) == int(b["iterations"])
                == CRASH_ITERS)
    d = stats["durable"]
    print(f"CLI crash check on the card: uninterrupted {base_s:.1f} s, "
          f"killed at {CLI_KILL_AT} after {killed_s:.1f} s (rc "
          f"{killed.returncode}), restart {again_s:.1f} s: {restored}; "
          f"restore {stats['checkpoint']['restore_s']:.4f} s, replay "
          f"{d['replay_s']:.4f} s ({d['replayed']}), re-ingested rows "
          f"skipped {d['skipped_rows']}, duplicates dropped "
          f"{stats['membership']['duplicate_gradients_dropped']}; final "
          f"checkpoints equal (theta, clocks, {CRASH_ITERS} iterations): "
          f"{same}")
    if not same or len(restored) != 2:
        raise RuntimeError("CLI crash check: the restarted run differs from "
                           "the uninterrupted one, or did not restore and "
                           "replay:\n" + base.stderr[-1500:]
                           + again.stderr[-1500:])
    for stale in ("ck-base.npz", "ck-crash.npz", "wal-crash",
                  "crash-train.csv"):
        remove(os.path.join(OUT, stale))


def membership_check(dev) -> None:
    """Through the app API on the card: threaded -c 2 under rebalance, one
    worker raising at its 20th iteration while that iteration's gradient
    is still in flight (it is sent only once the worker is evicted, as a
    delayed network send would arrive): the worker is evicted, its late
    gradient is dropped and counted as a zombie, the survivors finish,
    its rows reroute; readmitted, it rejoins at the slowest active clock
    and contributes.  With gang dispatch, a member failing on its leader's
    thread is evicted alone.  The same crash under halt raises."""
    from kafka_ps_tpu_torch.data.synth import generate

    def crash_at_20(app, wid, late_send=False):
        worker = app.workers[wid]
        calls = [0]
        orig = worker.on_weights
        late = []

        def send_after_eviction(msg):
            deadline = time.monotonic() + 30.0
            while (app.server.tracker.tracker[wid].active
                   and time.monotonic() < deadline):
                time.sleep(0.001)
            orig(msg)

        def on_weights(msg):
            calls[0] += 1
            if calls[0] == CRASH_AT:
                if late_send:
                    late.append(threading.Thread(
                        target=send_after_eviction, args=(msg,),
                        daemon=True))
                    late[0].start()
                raise RuntimeError("injected worker fault")
            return orig(msg)
        worker.on_weights = on_weights
        return late

    app = small_app(dev, 2)
    late = crash_at_20(app, 1, late_send=True)
    app.run_threaded(150, poll_timeout=0.02, failure_policy="rebalance",
                     heartbeat_timeout=30.0)
    late[0].join(60.0)
    s = app.server
    x, y = generate(30, 64, 5, seed=3, center_scale=0.3)
    for i in range(30):
        app.data_sink(1, x[i], int(y[i]))
    evicted = [w for w, _ in app.worker_failures]
    print(f"membership check on the card: evicted {evicted}, active "
          f"{s.tracker.active_workers}, {s.iterations} server iterations, "
          f"zombie gradients dropped {s.zombie_gradients_dropped}, rows "
          f"rerouted {app.rerouted_rows}, worker iterations "
          f"{[w.iterations for w in app.workers]}")
    if (evicted != [1] or s.iterations < 150 or app.rerouted_rows != 30
            or app.workers[1].iterations != CRASH_AT
            or late[0].is_alive()):
        raise RuntimeError("rebalance: the crashed worker was not evicted "
                           "alone, or the survivors did not finish")
    if s.zombie_gradients_dropped != 1:
        raise RuntimeError("rebalance: the evicted worker's late gradient "
                           "was not dropped as a zombie")
    del app.workers[1].on_weights
    slowest = min(s.tracker.clocks[w] for w in s.tracker.active_workers)
    before = app.workers[1].iterations
    clock = app.readmit_worker(1)
    app.run_threaded(220, poll_timeout=0.02, failure_policy="rebalance",
                     heartbeat_timeout=30.0)
    gained = app.workers[1].iterations - before
    print(f"membership check on the card: readmitted at clock {clock} "
          f"(slowest active {slowest}), then {gained} iterations; events "
          f"{[e[1:] for e in s.membership_events]}")
    if clock != slowest or gained < 1:
        raise RuntimeError("readmission: wrong join clock or no "
                           "contribution")
    # gang dispatch on: a member failing on its leader's thread is
    # evicted alone, and the leader's thread runs on
    from kafka_ps_tpu_torch.runtime.gang import GangMemberError
    ganged = small_app(dev, 0, workers=4)
    bad = ganged.workers[2]
    orig_prepare = bad._prepare

    def prepare(msg):
        if threading.current_thread().name != "worker-2":
            raise RuntimeError("injected gang member fault")
        return orig_prepare(msg)
    bad._prepare = prepare
    ganged.run_threaded(120, poll_timeout=0.02, failure_policy="rebalance")
    reasons = [(w, type(r).__name__) for w, r in ganged.worker_failures]
    print(f"membership check on the card: a gang member failing on its "
          f"leader's thread: evictions {reasons}, active "
          f"{ganged.server.tracker.active_workers}, "
          f"{ganged.server.iterations} server iterations, gang dispatches "
          f"{ganged.gang.dispatches}")
    if ([w for w, _ in reasons] != [2] or ganged.server.iterations < 120
            or not isinstance(ganged.worker_failures[0][1],
                              GangMemberError)):
        raise RuntimeError("rebalance with gangs: the failed member was "
                           "not evicted alone through the gang path")
    halted = small_app(dev, 2)
    crash_at_20(halted, 1)
    try:
        halted.run_threaded(90, poll_timeout=0.02)
    except RuntimeError as e:
        print(f"membership check on the card: the same crash under halt "
              f"raises: {e!r} from {e.__cause__!r}")
    else:
        raise RuntimeError("halt: the crash did not stop the run")


def fused_reference_check(dev) -> None:
    """The fused BSP path on the card: one fused step against one
    message-driven -c 0 round of the trainer (atol 2e-5, the parity
    tolerance of the CPU tests), and at the main path's shapes a chunk of
    8 rounds (one CUDA graph replay) bitwise equal to 8 single rounds,
    for logreg and the MLP at H=4096, with the graph's kernel calls
    counted at each replay and a slab written in place copied in again."""
    from kafka_ps_tpu_torch.data.synth import generate
    from kafka_ps_tpu_torch.models import mlp
    from kafka_ps_tpu_torch.models.task import get_task
    from kafka_ps_tpu_torch.ops import fused_update as fu
    from kafka_ps_tpu_torch.parallel import bsp
    from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
    from kafka_ps_tpu_torch.utils.config import (BufferConfig, ModelConfig,
                                                 PSConfig)

    for task in ("logreg", "mlp"):
        cfg = PSConfig(num_workers=4, consistency_model=0, task=task,
                       model=ModelConfig(num_features=64, num_classes=5,
                                         hidden_dim=32),
                       buffer=BufferConfig(min_size=8, max_size=32))
        x, y = generate(200, 64, 5, seed=2, center_scale=0.3)
        apps = []
        for _ in range(2):
            app = StreamingPSApp(cfg, test_x=x[150:], test_y=y[150:],
                                 clock_ms=iter(range(0, 10 ** 9,
                                                     40)).__next__,
                                 device=dev)
            for i in range(150):
                app.data_sink(i % 4, x[i], int(y[i]))
            apps.append(app)
        msg, fused = apps
        theta0 = fused.server.theta
        msg.run_serial(4)
        msg.close_logs()
        snaps = [b.snapshot() for b in fused.buffers]
        slab = [torch.from_numpy(np.stack([s[i] for s in snaps])).to(dev)
                for i in range(3)]
        theta, _ = bsp.make_bsp_step(cfg.model, 4, cfg.server_lr,
                                     task=fused.server.task)(theta0, *slab)
        err = float((theta - msg.server.theta).abs().max())
        print(f"fused check {task}: one fused step vs one message-driven "
              f"-c 0 round on the card: max_abs={err:.3e} (atol 2e-5)")
        torch.testing.assert_close(theta, msg.server.theta, rtol=0,
                                   atol=2e-5)
        fused.close_logs()

    rounds = 8
    from torch.profiler import ProfilerActivity, profile
    for task, hidden in (("logreg", H), ("mlp", WIDE_H)):
        cfg = ModelConfig(num_features=F, num_classes=C, num_max_iter=K,
                          local_learning_rate=0.5, hidden_dim=hidden)
        t = get_task(task, cfg)
        n = t.num_params
        init = (mlp.init_params(cfg, "cpu").numpy() if task == "mlp"
                else None)
        gang = [member_inputs(dev, n, 61 + i, init) for i in range(GANG)]
        theta = gang[0][0]
        slab = [torch.stack([g[i] for g in gang]) for i in (1, 2, 3)]
        step = bsp.make_bsp_step(cfg, GANG, 1.0 / GANG, task=t)
        multi = bsp.make_bsp_multi_step(cfg, GANG, 1.0 / GANG, rounds,
                                        task=t)

        def singles(th):
            losses = []
            for _ in range(rounds):
                th, loss = step(th, *slab)
                losses.append(loss)
            return th, torch.stack(losses)

        # the counter, and a kernel launched once per gang call
        key, kernel = (("batched_launches", "logreg_update")
                       if task == "logreg"
                       else ("mlp_batched_launches", "loss_reduce"))
        fu.reset_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            g1 = multi(theta, *slab)
            g2 = multi(g1[0], *slab)
            torch.cuda.synchronize()
        replayed = fu.counts()[key]
        traced = sum(e.count for e in prof.key_averages()
                     if kernel in e.key)
        e1 = singles(theta)
        e2 = singles(e1[0])
        slab[0].mul_(0.5)                # written in place: copied again
        g3, e3 = multi(theta, *slab), singles(theta)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in
                   zip((*g1, *g2, *g3), (*e1, *e2, *e3)))
        print(f"fused check {task} (H={hidden} where MLP, F={F}, "
              f"{GANG} workers of {B} rows): a chunk of {rounds} rounds "
              f"(CUDA graph, {multi.captures} captured) bitwise equal to "
              f"{rounds} single rounds: {same}; kernel calls counted for 2 "
              f"replays: {replayed}, {kernel} kernels traced by "
              f"torch.profiler: {traced}")
        if (not same or replayed != 2 * rounds or traced != replayed
                or multi.captures != 1):
            raise RuntimeError(f"fused {task}: the graph chunk differs "
                               "from its single rounds, or its kernel "
                               "calls counted at the replays are not the "
                               "kernels that ran")
        reps = 100 if task == "logreg" else 10
        chunk_ms = time_ms(lambda: multi(theta, *slab), warmup=2, reps=reps)
        eager_ms = time_ms(lambda: singles(theta), warmup=2, reps=reps)
        print(f"fused {task} (H={hidden} where MLP): {rounds} rounds as one "
              f"graph replay {chunk_ms:.4f} ms, as {rounds} eager rounds "
              f"{eager_ms:.4f} ms (CUDA events, median of {reps})")


def write_data():
    from kafka_ps_tpu_torch.data.synth import generate, write_csv
    os.makedirs(OUT, exist_ok=True)
    x, y = generate(TRAIN_ROWS + TEST_ROWS, F, C, seed=0)
    write_csv(os.path.join(OUT, "train.csv"), x[:TRAIN_ROWS],
              y[:TRAIN_ROWS])
    write_csv(os.path.join(OUT, "test.csv"), x[TRAIN_ROWS:],
              y[TRAIN_ROWS:])


def main_path_run(task: str, mode: str, c: int, iters: int,
                  flags: tuple = (), hidden: int = H,
                  train: str = "train.csv", watch=None) -> dict:
    """One cli.run in this process.  `watch(err)`, when given, is
    called with the run's stderr buffer just before the run and returns
    a callable that is called just after it (a poller of the health
    plane)."""
    from kafka_ps_tpu_torch.cli import run as cli_run
    from kafka_ps_tpu_torch.ops import fused_update

    checkpoint = (flags[flags.index("--checkpoint") + 1]
                  if "--checkpoint" in flags else None)
    tag = "-".join([task, mode, f"c{c}", *(f.lstrip("-") for f in flags)]
                   + ([f"H{hidden}"] if hidden != H else [])
                   + ([str(iters)] if checkpoint else []))
    if len(tag) > 120:
        # a file name holds the tag: keep its head, hash the whole
        import hashlib
        tag = f"{tag[:96]}-{hashlib.sha1(tag.encode()).hexdigest()[:12]}"
    kind = flags[flags.index("--slab-dtype") + 1] \
        if "--slab-dtype" in flags else "f32"
    fused = "--fused" in flags
    eval_every = int(flags[flags.index("--eval_every") + 1]) \
        if "--eval_every" in flags else 1
    here = os.getcwd()
    os.chdir(OUT)
    err, out = io.StringIO(), io.StringIO()
    try:
        # a resumed run appends to the logs of the run it continues
        resuming = checkpoint is not None and os.path.exists(checkpoint)
        before = ([len(open(f).read().splitlines()) - 1 for f in
                   ("logs-server.csv", "logs-worker.csv")] if resuming
                  else [0, 0])
        fused_update.reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
            done = watch(err) if watch is not None else None
            try:
                rc = cli_run.main([
                    "-training", train, "-test", "test.csv",
                    "--num_workers", str(WORKERS), "--num_features", str(F),
                    "--num_classes", str(C), "--task", task, "--hidden_dim",
                    str(hidden), "-max", str(MAX_BUFFER), "-p", "0", "-l",
                    "--mode", mode, "-c", str(c), "--max_iterations",
                    str(iters), *flags])
            finally:
                if done is not None:
                    done()
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
        events = open("logs-events.csv").read().splitlines()[1:]
        residuals = []
        if checkpoint:
            with np.load(checkpoint) as z:
                residuals = sorted(k for k in z.files if k.startswith("ef"))
        shutil.copy("logs-server.csv", f"server-{tag}.csv")
        shutil.copy("logs-worker.csv", f"worker-{tag}.csv")
    finally:
        os.chdir(here)
    sys.stderr.write(err.getvalue())
    restored = [ln.strip() for ln in out.getvalue().splitlines()
                if "restored checkpoint" in ln]
    stats = [json.loads(line.split(": ", 1)[1])
             for line in err.getvalue().splitlines()
             if line.startswith("kafka_ps_tpu_torch run: ")][-1]
    # K1/K2 (K4/K6) on an f32 slab, K3 (K5) single and batched on a
    # stored one; every other kernel's counters must stay 0
    prefix = ("" if task == "logreg" else "mlp_") + (
        "" if kind == "f32" else "stream_")
    mine = [f"{prefix}{k}" for k in ("launches", "batched_launches",
                                     "batched_members")]
    single, gang_calls, members = (n[k] for k in mine)
    others = other_kernels(n, tuple(mine), task, kind, hidden,
                           single + gang_calls, tag)
    values = np.array([[float(v) for v in r[3:6]] for r in server + worker])
    # this run's rows and server iterations (a resumed run continues the
    # logs and the iteration count of the run it restores)
    new_worker = worker[before[1]:]
    start = int(restored[0].rsplit(" ", 1)[1]) if restored else 0
    iters_run = stats["server_iterations"] - start
    stamps = [int(r[0]) for r in new_worker]
    comp = stats.get("compress")
    # server iterations over the window up to the synchronised flush
    window_s = (end_ms - min(stamps)) / 1e3
    rate = iters_run / window_s
    # per-layer: worker rows over their host submit stamps (ms), which
    # precede their device work
    span_s = (max(stamps) - min(stamps)) / 1e3
    submit_rate = (len(new_worker) - 1) / span_s if span_s > 0 \
        else float("nan")
    f1 = float(server[-1][4])
    g = stats.get("gang", {"dispatches": 0, "members": 0})
    ev = stats.get("eval")
    per = g["members"] / g["dispatches"] if g["dispatches"] else 0.0
    print(f"main path {tag}: rc={rc} server_rows={len(server)} "
          f"worker_rows={len(new_worker)} single_calls={single} "
          f"gang_calls={gang_calls} gang_members={members} "
          f"iters_per_s={rate:.1f} ({iters_run} server iterations over "
          f"{window_s:.3f} s, first worker row to flushed logs) "
          f"worker_rows_per_s_host_submit={submit_rate:.1f} "
          f"final_f1={f1:.4f} wall_s={wall:.1f}")
    slab = stats["slab"]
    print(f"  slab {slab['dtype']}: device_bytes={slab['device_bytes']} "
          f"(4 workers, the spare row left out) "
          f"bytes_uploaded={slab['bytes_uploaded']}; iters_per_s="
          f"{rate:.1f}; other kernel counters: {others or 'all 0'}; "
          f"wide MLP calls {n.get(WIDE, 0)}")
    print(f"  gang dispatches={g['dispatches']} members per dispatch="
          f"{per:.2f}; server batched applies="
          f"{stats['server_batched_applies']}; eval engine: "
          + ("off" if ev is None else
             f"dispatches={ev['dispatches']} evals={ev['evals']} widths="
             f"{ev['widths']} final lag={ev['lag_clocks']}"))
    prod = stats["producer"]
    print(f"  ingestion: parser={prod['parser']} rows={prod['rows']} "
          f"parse_s={prod['parse_s']:.3f} (the native one-pass parse of "
          "the whole CSV; the row replay runs in the producer's loop)")
    if prod["parser"] != "native":
        raise RuntimeError(f"{tag}: the CSV was parsed by the "
                           f"{prod['parser']} parser, not the native one")
    mem = stats["membership"]
    print(f"  membership: active {mem['active']}, evictions "
          f"{mem['evictions']}, zombie gradients dropped "
          f"{mem['zombie_gradients_dropped']}, duplicates dropped "
          f"{mem['duplicate_gradients_dropped']}, rows rerouted "
          f"{mem['rerouted_rows']}")
    redelivered = 0
    if comp is not None:
        redelivered = comp["redelivered_weights"]
        print(f"  compress {comp['codec']}: bytes per message (weights "
              f"and gradients, packed before zlib) {comp['message_bytes']} "
              f"of {comp['raw_bytes']} as float32 "
              f"({comp['raw_bytes'] / comp['message_bytes']:.2f}x); "
              f"redelivered weights clocks answered from cache "
              f"{redelivered}; iters_per_s={rate:.1f}")
    if checkpoint:
        start_line = restored[0] if restored else "a fresh start"
        ck = stats["checkpoint"]
        print(f"  checkpoint {checkpoint}: {start_line}; restore "
              f"{ck['restore_s']:.4f} s; {ck['saves']} saves, "
              f"{ck['save_s']:.4f} s in all (host clock); logs-events.csv "
              f"{events}; residuals in the file {residuals}")
        want = [f"ef{w}_residual" for w in range(WORKERS)] \
            if "--compress" in flags and flags[flags.index(
                "--compress") + 1] != "none" else []
        if resuming and (not restored or not any(
                e.split(";")[1] == "resume" for e in events)):
            raise RuntimeError(f"{tag}: no restore, or no resume event")
        if residuals != want:
            raise RuntimeError(f"{tag}: residuals {residuals}, want {want}")
        clocks = [int(r[2]) for r in server]
        if clocks != sorted(set(clocks)):
            raise RuntimeError(f"{tag}: the server rows do not continue")
    dur = stats.get("durable")
    if dur is not None:
        wal = os.path.join(OUT, flags[flags.index("--durable-log") + 1])
        on_disk = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, files in os.walk(wal) for f in files)
        fsync = flags[flags.index("--fsync") + 1] if "--fsync" in flags \
            else "interval"
        print(f"  durable log (--fsync {fsync}): appends {dur['appends']}, "
              f"bytes {dur['bytes']}; fsyncs {dur['fsyncs']}, "
              f"{dur['fsync_ms']:.1f} ms in all, max "
              f"{dur['fsync_ms_max']:.3f} ms; segment rolls {dur['rolls']}, "
              f"segments reaped {dur['segments_reaped']}, commits "
              f"{dur['commits']}; serde ms per frame {serde_ms(dur)} over "
              f"{dur['frames']} frames ({dur['frames_shared']} weights "
              f"frames shared); bytes on "
              f"disk at exit {on_disk} (log records {dur['retained_bytes']})"
              f"; iters_per_s={rate:.1f}")
        if not dur["commits"] or not sum(dur["appends"].values()):
            raise RuntimeError(f"{tag}: the log took no appends or commits")
    tier = stats.get("tier")
    if tier is not None:
        print(f"  tier: {tier_line(tier)}; iters_per_s={rate:.1f}")
    if rc != 0 or len(new_worker) < iters_run or not server:
        raise RuntimeError(f"{tag}: short run")
    # every worker iteration logs one worker row and runs one kernel
    # call, single or as a gang member; a compressed worker answers a
    # redelivered weights clock from its cache, with no row and no call
    # (counted in `redelivered`; a resumed app starts with empty caches)
    if single + members != len(new_worker):
        raise RuntimeError(f"{tag}: {len(new_worker)} worker iterations but "
                           f"{single} single and {members} gang-member "
                           f"kernel calls ({redelivered} redelivered)")
    if others:
        raise RuntimeError(f"{tag}: kernels of another slab form or family "
                           f"ran: {others}")
    if slab["dtype"] != kind:
        raise RuntimeError(f"{tag}: slab {slab['dtype']}, asked {kind}")
    if ("--no-gang" not in flags and mode == "serial" and c == 0
            and gang_calls < 1):
        raise RuntimeError(f"{tag}: the gang kernel never ran")
    if ev is not None and ev["lag_clocks"] != 0:
        raise RuntimeError(f"{tag}: final eval lag {ev['lag_clocks']}")
    if not np.isfinite(values).all() or not 0.5 < f1 <= 1.0:
        raise RuntimeError(f"{tag}: bad metrics (final F1 {f1})")
    # a fused run logs the clock each round reached (1, 2, ...), the
    # message path the clock each iteration started from (0, 1, ...)
    first = 1 if fused else 0
    for w in range(WORKERS):
        clocks = [int(r[2]) for r in worker if int(r[1]) == w]
        if clocks != list(range(first, first + len(clocks))):
            raise RuntimeError(f"{tag}: worker {w} clocks skip")
    if fused:
        fs = stats["fused"]
        rounds = iters // WORKERS
        print(f"  fused: rounds={fs['rounds']} in chunks={fs['chunk_rounds']}"
              f" chunk dispatches={fs['chunks']} CUDA graphs captured="
              f"{fs['graph_captures']}; rounds_per_s="
              f"{rounds / window_s:.2f} server_iters_per_s={rate:.1f}")
        want = [eval_every * i for i in range(1, rounds // eval_every + 1)]
        if fs["rounds"] != rounds or len(new_worker) != iters:
            raise RuntimeError(f"{tag}: {fs['rounds']} rounds and "
                               f"{len(new_worker)} worker rows for {iters} "
                               "iterations")
        if single or gang_calls != rounds or members != iters:
            raise RuntimeError(f"{tag}: {single} single and {gang_calls} "
                               f"gang calls ({members} members) for "
                               f"{rounds} rounds")
        if [int(r[2]) for r in server] != want:
            raise RuntimeError(f"{tag}: server rows off the eval cadence")
        if fs["chunks"] and fs["graph_captures"] != 1:
            raise RuntimeError(f"{tag}: {fs['graph_captures']} CUDA graphs "
                               "captured, expected 1")
    return {"task": task, "kind": kind, "single": single,
            "gang_calls": gang_calls, "hidden": hidden, "fused": fused,
            "rate": rate, "durable": dur, "serving": stats.get("serving"),
            "tag": tag, "tier": tier, "eval": ev, "counts": n,
            "submit_rate": submit_rate,
            "stats": stats, "stderr": err.getvalue()}


def durable_runs() -> list[dict]:
    """Main-path runs through the CLI on the durable log, each with
    --checkpoint (every commit point runs retention), beside the same
    flags without the log in this script run: logreg serial -c 0 at
    --fsync interval, none and always; logreg threaded -c 2; the MLP
    serial -c 0; the MLP at H=4096 --compress int8 (40 iterations);
    logreg --fused --eval_every 10."""
    runs = []
    specs = [("logreg", "serial", 0, DURABLE_ITERS, (), H,
              ("interval", "none", "always")),
             ("logreg", "threaded", 2, DURABLE_ITERS, (), H, ("interval",)),
             ("mlp", "serial", 0, DURABLE_ITERS, (), H, ("interval",)),
             ("mlp", "serial", 0, COMPRESSED_WIDE_ITERS,
              ("--compress", "int8", "--checkpoint_every", "20"), WIDE_H,
              ("interval",)),
             ("logreg", "serial", 0, DURABLE_ITERS,
              ("--fused", "--eval_every", "10"), H, ("interval",))]
    for i, (task, mode, c, iters, extra, hidden, fsyncs) in enumerate(specs):
        for stale in (f"ck-d{i}.npz", f"ck-p{i}.npz"):
            remove(os.path.join(OUT, stale))
        plain = main_path_run(task, mode, c, iters,
                              ("--checkpoint", f"ck-p{i}.npz", *extra),
                              hidden)
        runs.append(plain)
        for fs in fsyncs:
            wal = f"wal-{i}-{fs}"
            for stale in (wal, f"ck-d{i}.npz"):
                remove(os.path.join(OUT, stale))
            logged = main_path_run(task, mode, c, iters,
                                   ("--checkpoint", f"ck-d{i}.npz",
                                    "--durable-log", wal, "--fsync", fs,
                                    *extra), hidden)
            runs.append(logged)
            print(f"durable log against none: {task} {mode} -c {c} "
                  f"{' '.join(extra)} H={hidden} --fsync {fs}: iters_per_s "
                  f"{logged['rate']:.1f} against {plain['rate']:.1f} "
                  f"({logged['rate'] / plain['rate']:.3f}x); fsync "
                  f"{logged['durable']['fsync_ms']:.1f} ms in "
                  f"{logged['durable']['fsyncs']} fsyncs; serde ms per "
                  f"frame {serde_ms(logged['durable'])}")
            remove(os.path.join(OUT, wal))
    return runs


SPLIT_IDS = ("0,1", "2,3")          # two worker processes of 2


def split_reference_check(dev) -> None:
    """One -c 0 round of 4 workers through a localhost ServerBridge/
    WorkerBridge pair on the card, rows delivered as DATA_BATCH frames,
    against the same round in process (tests/torch_split_round.py): the
    gradients decode onto the card and they and the applied theta are
    bitwise the in-process ones, logreg and the MLP, f32 and stored
    slabs."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_split_round import bridge_round
    for task, slab in (("logreg", "f32"), ("mlp", "f32"),
                       ("logreg", "int8"), ("mlp", "bf16")):
        (ref, ref_theta), (got, theta) = bridge_round(
            dev, task, features=F, classes=C, hidden=H, workers=WORKERS,
            rows=256, slab=slab)
        same = (all(a.values.device.type == b.values.device.type == "cuda"
                    and torch.equal(a.values, b.values)
                    for a, b in zip(ref, got))
                and torch.equal(ref_theta, theta))
        print(f"split reference check on the card ({task}, {slab} slab, "
              f"{WORKERS} workers, F={F}): gradients through the bridges "
              f"and the applied theta bitwise the in-process round: {same}")
        if not same:
            raise RuntimeError(f"split reference check {task} {slab}: the "
                               "bridged round differs from the in-process "
                               "one")


_PORTS_GIVEN: set = set()
_PORTS_LOCK = threading.Lock()


def _free_port() -> int:
    """A free port never handed out before in this script: runs started
    together (the role telemetry phase) cannot draw the same port before
    its process binds it."""
    import socket
    with _PORTS_LOCK:
        while True:
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            if port not in _PORTS_GIVEN:
                _PORTS_GIVEN.add(port)
                return port


def _role_stats(path: str, role: str) -> dict:
    tag = f"kafka_ps_tpu_torch {role}: "
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.startswith(tag)]
    if not lines:
        raise RuntimeError(f"no {role} stats line in {path}")
    return json.loads(lines[-1][len(tag):])


def _csv_rows(path: str) -> list[list[str]]:
    with open(path) as f:
        return [r.split(";") for r in f.read().splitlines()[1:]]


def steady_rate(rows) -> float:
    """Worker iterations per second past the first round: the rows of
    clocks >= 1 over the window from the first of them to the last row
    (worker CSV timestamps).  The first round waits for every worker
    process's first kernel call and the server's first eval, seconds that
    swamp a run of 100 iterations."""
    stamps = sorted(int(r[0]) for r in rows if int(r[2]) >= 1)
    return (len(stamps) - 1) / max((stamps[-1] - stamps[0]) / 1e3, 1e-3)


def clock_spread(rows) -> int:
    """The largest log-visible clock spread between the workers over a
    run's worker rows (timestamp order; at one millisecond the lower clock
    first, since it enabled the higher).  Under -c k the gate keeps it
    within k + 1: a worker logs clock c only once the slowest worker's
    gradient for c - k - 1 arrived, which it sent after logging that
    clock (kafka_ps_tpu/evaluation/validate.py derives the same bound)."""
    last: dict[int, int] = {}
    worst = 0
    for _, w, clock in sorted((int(r[0]), int(r[1]), int(r[2]))
                              for r in rows):
        last[w] = clock
        if len(last) == WORKERS:
            worst = max(worst, max(last.values()) - min(last.values()))
    return worst


def _wire_line(side: str, stats: dict) -> str:
    """Frames, bytes per message and serde ms per frame by topic."""
    parts = []
    for topic, t in sorted(stats["wire"].items()):
        for way in ("out", "in"):
            n = t.get(f"frames_{way}")
            if n:
                parts.append(f"{topic} {way} {n} frames "
                             f"{t[f'bytes_{way}']} B "
                             f"({t[f'bytes_{way}'] / n:.0f} B/frame)")
        if "serde_ms_per_frame" in t:
            parts.append(f"{topic} serde {t['serde_ms_per_frame']:.4f} "
                         f"ms/frame over {t['serde_frames']}")
    w = stats["writers"]
    fps = w["frames_per_syscall"]
    return (f"  {side}: " + "; ".join(parts)
            + f"; writer flushes {w['flushes']}, frames per syscall "
            + ("n/a" if fps is None else f"{fps:.2f}"))


def split_run(task: str, c: int, iters: int, flags: tuple = (),
              hidden: int = H, kill: bool = False, during=None,
              server_flags: tuple = (), tel: bool = False) -> dict:
    """The port's split deployment on the card: server_runner --listen 0
    and two worker_runner processes of 2 workers (F=1024, C=5, buffer max
    1024, k=2, lr 0.5) on write_data()'s CSV, each process in its own
    directory under OUT.  Each worker process's kernel calls (its stats
    line) must equal its worker CSV rows and be of the run's family and
    slab form only, on cuda; under -c k the log-visible clock spread stays
    within k + 1; the final F1 is in (0.5, 1] and the eval lag at exit 0.
    `kill`: the second worker process is killed with SIGKILL once it has
    logged 20 rows and saved its state (--checkpoint, --state_every 0.2),
    restarted with the same command, and the server (--failure_policy
    rebalance --heartbeat_timeout 10, no iteration cap) is interrupted
    with SIGINT once both of its workers are readmitted and the restarted
    process has logged 50 rows; its restored buffers and readmission are
    checked.  `during(port, server_err_path)`, when given, is called once
    the processes are started and returns a callable that is called once
    they have ended (a serving load, serving_runs).  `server_flags` go
    to the server process only (the tier caps).  `tel`: every process
    also gets the role telemetry flags (tests/torch_role_runs.TEL_FLAGS,
    its files in its own directory), the server `--status_every
    STATUS_EVERY`."""
    import signal
    tag = "-".join(["split", task, f"c{c}",
                    *(f.lstrip("-") for f in flags + server_flags)]
                   + ([f"H{hidden}"] if hidden != H else [])
                   + (["kill"] if kill else []) + (["tel"] if tel else []))
    tel_flags = role_tel_flags() if tel else ()
    base = os.path.join(OUT, tag)
    remove(base)
    dirs = {n: os.path.join(base, n) for n in ("server", "w0", "w1")}
    for d in dirs.values():
        os.makedirs(d)
    kind = flags[flags.index("--slab-dtype") + 1] \
        if "--slab-dtype" in flags else "f32"
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("KPS_PLATFORM", None)
    common = ["-test", "../../test.csv", "--num_workers", str(WORKERS),
              "--num_features", str(F), "--num_classes", str(C), "--task",
              task, "--hidden_dim", str(hidden), "-l", *flags]
    server_cmd = [sys.executable, "-m", "kafka_ps_tpu_torch.cli."
                  "server_runner", "--listen", str(port), "-training",
                  "../../train.csv", "-p", "0", "-c", str(c),
                  "--max_iterations", str(0 if kill else iters), *common,
                  *server_flags, *tel_flags]
    if tel:
        server_cmd += ["--status_every", STATUS_EVERY]
    if kill:
        server_cmd += ["--failure_policy", "rebalance",
                       "--heartbeat_timeout", "10"]

    def worker_cmd(i):
        cmd = [sys.executable, "-m", "kafka_ps_tpu_torch.cli."
               "worker_runner", "--connect", f"127.0.0.1:{port}",
               "--worker_ids", SPLIT_IDS[i], "-max", str(MAX_BUFFER),
               *common, *tel_flags]
        return cmd + (["--checkpoint", "job.npz", "--state_every", "0.2"]
                      if kill else [])

    def start(name, cmd, suffix=""):
        d = dirs[name]
        return subprocess.Popen(
            cmd, cwd=d, env=env,
            stdout=open(os.path.join(d, f"out{suffix}.txt"), "w"),
            stderr=open(os.path.join(d, f"err{suffix}.txt"), "w"))

    t0 = time.perf_counter()
    procs = {"server": start("server", server_cmd),
             "w0": start("w0", worker_cmd(0)),
             "w1": start("w1", worker_cmd(1))}
    pre_rows = 0
    finish = (during(port, os.path.join(dirs["server"], "err.txt"))
              if during is not None else None)
    try:
        if kill:
            w1_log = os.path.join(dirs["w1"], "logs-worker.csv")
            state = os.path.join(dirs["w1"], "job.npz.workers-2-3.npz")

            def wait_for(pred, what, limit=240.0):
                deadline = time.monotonic() + limit
                while not pred():
                    for name, p in procs.items():
                        if p.poll() is not None:
                            raise RuntimeError(f"{tag}: {name} exited "
                                               f"({p.returncode}) while "
                                               f"waiting for {what}")
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"{tag}: no {what}")
                    time.sleep(0.05)

            def rows_of(path):
                return (len(_csv_rows(path)) if os.path.exists(path)
                        else 0)

            wait_for(lambda: rows_of(w1_log) >= 20
                     and os.path.exists(state), "20 rows and a state file")
            procs["w1"].send_signal(signal.SIGKILL)
            procs["w1"].wait(timeout=60)
            pre_rows = rows_of(w1_log)
            procs["w1"] = start("w1", worker_cmd(1), "-restart")
            server_err = os.path.join(dirs["server"], "err.txt")

            def readmitted():
                with open(server_err) as f:
                    return f.read().count("readmitted worker") == 2

            wait_for(lambda: readmitted()
                     and rows_of(w1_log) >= pre_rows + 50,
                     "readmission and 50 rows after the restart")
            procs["server"].send_signal(signal.SIGINT)
        for name, p in procs.items():
            p.wait(timeout=300)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        if finish is not None:
            finish()
    wall = time.perf_counter() - t0
    rcs = {n: p.returncode for n, p in procs.items()}
    errs = {n: os.path.join(d, "err-restart.txt" if kill and n == "w1"
                            else "err.txt") for n, d in dirs.items()}
    if any(rcs.values()):
        tails = {n: open(e).read()[-2000:] for n, e in errs.items()}
        raise RuntimeError(f"{tag}: exit codes {rcs}:\n{tails}")
    server = _role_stats(errs["server"], "server")
    workers = [_role_stats(errs[f"w{i}"], "worker") for i in (0, 1)]
    server_rows = _csv_rows(os.path.join(dirs["server"], "logs-server.csv"))
    worker_rows = [_csv_rows(os.path.join(dirs[f"w{i}"], "logs-worker.csv"))
                   for i in (0, 1)]
    prefix = ("" if task == "logreg" else "mlp_") + (
        "" if kind == "f32" else "stream_")
    mine = f"{prefix}launches"
    calls = []
    for i, (st, rows) in enumerate(zip(workers, worker_rows)):
        own = len(rows) - (pre_rows if kill and i == 1 else 0)
        n = st["kernels"]
        others = other_kernels(n, (mine,), task, kind, hidden, n[mine], tag)
        calls.append(n[mine])
        print(f"  worker process {i} ({SPLIT_IDS[i]}): device "
              f"{st['device']}, {own} worker CSV rows in this process, "
              f"kernel calls {mine}={n[mine]}, others "
              f"{others or 'all 0'}; rows received "
              f"{st['rows_received']}; codec {st['codec']}"
              + (f"; restored {st['restored']}" if kill and i == 1
                 else ""))
        if not st["device"].startswith("cuda"):
            raise RuntimeError(f"{tag}: worker {i} ran on {st['device']}")
        if n[mine] != own or sum(st["rows"].values()) != own:
            raise RuntimeError(f"{tag}: worker process {i} made {n[mine]} "
                               f"{mine} calls and {st['rows']} iterations "
                               f"for {own} CSV rows")
        if others:
            raise RuntimeError(f"{tag}: kernels of another family or form "
                               f"ran in worker process {i}: {others}")
    all_rows = worker_rows[0] + worker_rows[1]
    spread = clock_spread(all_rows)
    values = np.array([[float(v) for v in r[3:6]]
                       for r in server_rows + all_rows])
    f1 = float(server_rows[-1][4])
    lag = server["eval"]["lag_clocks"]
    iters_run = server["server_iterations"]
    first_ms = min(int(r[0]) for r in all_rows)
    rate = iters_run / ((server["end_ms"] - first_ms) / 1e3)
    print(f"split {tag}: rc={rcs} server_rows={len(server_rows)} "
          f"server_iterations={iters_run} iters_per_s={rate:.1f} (first "
          f"worker row to the server's flushed logs) final_f1={f1:.4f} "
          f"final eval lag {lag} clock spread {spread}"
          + (f" (bound {c + 1})" if c >= 0 else "")
          + f" wall_s={wall:.1f}; server on {server['device']}, codec "
          f"{server['codec']}, dropped sends {server['dropped_sends']}, "
          f"rows sent {server['rows']}")
    print(_wire_line("server", server))
    for i, st in enumerate(workers):
        print(_wire_line(f"worker process {i}", st))
    for i in (0, 1):      # the worker state files: 8 MB a process
        remove(os.path.join(dirs[f"w{i}"],
                            f"job.npz.workers-{SPLIT_IDS[i].replace(',', '-')}"
                            ".npz"))
    if kill:
        st = workers[1]
        readm = server["membership"]["readmissions"]
        print(f"  kill and restart: {pre_rows} rows on disk at the kill, "
              f"restored buffers {st['restored']}, readmissions {readm}, "
              f"evictions {server['membership']['evictions']}")
        if not st["restored"] or sorted(w for w, _ in readm) != [2, 3]:
            raise RuntimeError(f"{tag}: the restarted worker process did "
                               "not restore, or was not readmitted")
    if not kill and c >= 0 and spread > c + 1:
        raise RuntimeError(f"{tag}: clock spread {spread} over -c {c}")
    if not np.isfinite(values).all() or not 0.5 < f1 <= 1.0:
        raise RuntimeError(f"{tag}: bad metrics (final F1 {f1})")
    if lag != 0:
        raise RuntimeError(f"{tag}: final eval lag {lag}")
    if not kill and iters_run != iters:
        raise RuntimeError(f"{tag}: {iters_run} server iterations")
    if "--compress" in flags:
        want = flags[flags.index("--compress") + 1]
        if server["codec"] != want or any(w["codec"] != want
                                          for w in workers):
            raise RuntimeError(f"{tag}: codec not negotiated as {want}")
    return {"task": task, "kind": kind, "single": sum(calls),
            "gang_calls": 0, "hidden": hidden, "fused": False,
            "rate": rate, "steady": steady_rate(all_rows), "server": server,
            "f1": f1, "topology": "split", "c": c, "flags": flags,
            "server_flags": server_flags, "kill": kill, "dirs": dirs,
            "workers": workers}


def split_runs(direct: dict) -> list[dict]:
    """The split phase: each run of the port's split deployment beside
    the in-process trainer with the same flags (threaded, --no-gang: a
    split worker process runs no gang) in this script run.  Each split
    run's iterations/s goes into `direct`, keyed (task, c, flags, H),
    for the scale-out runs to stand beside.  The split runs go two at a
    time (_at_once; the killed-worker run alone), so their rates are
    taken under two runs' load."""
    runs = []
    specs = [("logreg", c, SPLIT_ITERS, (), H) for c in (0, 2, -1)]
    specs += [("mlp", -1, SPLIT_SHORT, (), H),
              ("logreg", 2, SPLIT_SHORT, ("--slab-dtype", "int8"), H),
              ("mlp", -1, SPLIT_SHORT, ("--slab-dtype", "bf16"), H),
              ("logreg", 2, SPLIT_SHORT, ("--compress", "int8"), H),
              ("mlp", -1, SPLIT_WIDE, (), WIDE_H)]
    # two deployments at a time share the card and the host: the checks
    # are of function, and their rates are taken under that load (the
    # role telemetry phase times the split run alone)
    splits = []
    for k in range(0, len(specs), 2):
        splits += _at_once([functools.partial(split_run, *spec)
                            for spec in specs[k:k + 2]])
    for (task, c, iters, flags, hidden), split in zip(specs, splits):
        direct[(task, c, flags, hidden)] = split["steady"]
        inproc = main_path_run(task, "threaded", c, iters,
                               ("--no-gang", *flags), hidden)
        runs += [split, inproc]
        print(f"split against in-process: {task} -c {c} {' '.join(flags)} "
              f"H={hidden}: iters_per_s {split['rate']:.1f} (under shared "
              f"load) against {inproc['rate']:.1f} alone "
              f"({split['rate'] / inproc['rate']:.3f}x)")
    runs.append(split_run("logreg", 10, SPLIT_SHORT, kill=True))
    return runs


def scaleout_reference_check(dev) -> None:
    """The scale-out paths in process on the card (tests/
    torch_scaleout_runs.py), F=1024, C=5, 4 workers of 256 rows: a
    ShardedServerGroup of one shard bitwise the unsharded app (theta and
    server rows) at -c 0/2/-1; two and four shards assembling the one-shard
    theta bitwise, logreg and the MLP at H=128; top-k workers' sparse
    slices at two shards bitwise the dense apply at one; one stacked
    LocalAggregator in front of all workers bitwise the direct path at
    -c 0/3/-1, under int8 (also after a reset and restore of the
    aggregator); the summed composite within rtol 2e-5, atol 2e-6."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_scaleout_runs import (aggregated_run, config, dataset,
                                     direct_run, group_run, unsharded_run)
    rows, iters = 256, SCALE_REF_ITERS

    def check(ok, what):
        print(f"scale-out reference check on the card: {what}: {ok}")
        if not ok:
            raise RuntimeError(f"scale-out reference check: {what}")

    def same_rows(a, b):
        return strip_stamps(a) == strip_stamps(b) and len(a) > 0

    for c in (0, 2, -1):
        cfg = config(c, "logreg", F, C, H, WORKERS, rows)
        x, y = dataset(cfg, rows * WORKERS)
        test = dataset(cfg, 512, seed=1)
        app, app_rows = unsharded_run(dev, cfg, iters, x, y, test)
        group, group_rows = group_run(dev, 1, cfg, iters, x, y, test)
        check(torch.equal(group.assembled_theta(), app.server.theta)
              and same_rows(group_rows, app_rows),
              f"one-shard group bitwise the unsharded app at -c {c} "
              f"(theta and {len(app_rows)} server rows)")
    for task in ("logreg", "mlp"):
        cfg = config(0, task, F, C, H, WORKERS, rows)
        x, y = dataset(cfg, rows * WORKERS)
        one, _ = group_run(dev, 1, cfg, iters, x, y)
        for n in (2, 4):
            many, _ = group_run(dev, n, cfg, iters, x, y)
            check(torch.equal(many.assembled_theta(), one.assembled_theta())
                  and many.assembled_theta().device.type == "cuda",
                  f"{task} H={H}: {n} shards' assembled theta bitwise one "
                  f"shard's ({one.task.num_params} parameters)")
    cfg = config(-1, "logreg", F, C, H, WORKERS, rows)
    x, y = dataset(cfg, rows * WORKERS)
    one, _ = group_run(dev, 1, cfg, iters, x, y, topk="topk:0.01")
    two, _ = group_run(dev, 2, cfg, iters, x, y, topk="topk:0.01")
    sparse = sum(sh.sparse_applies for sh in two.shards)
    empty = sum(sh.empty_slices for sh in two.shards)
    check(torch.equal(two.assembled_theta(), one.assembled_theta())
          and sparse > 0,
          f"top-k 0.01 workers: sparse slices at two shards ({sparse} "
          f"applied, {empty} empty) bitwise the dense apply at one")
    test = dataset(cfg, 512, seed=1)
    for c in (0, 3, -1):
        cfg = config(c, "logreg", F, C, H, WORKERS, rows)
        direct = direct_run(dev, cfg, iters, x, y, test)
        agg = aggregated_run(dev, cfg, iters, x, y, test)
        check(torch.equal(agg.server.theta, direct.server.theta)
              and same_rows(agg.rows, direct.rows),
              f"one stacked aggregator bitwise the direct path at -c {c} "
              f"({agg.server.composites_received} composites, theta and "
              "server rows)")
    cfg = config(0, "logreg", F, C, H, WORKERS, rows)
    direct8 = direct_run(dev, dataclasses.replace(cfg, compress="int8"),
                         iters, x, y, test)
    agg8 = aggregated_run(dev, cfg, iters, x, y, test, codec="int8")
    again8 = aggregated_run(dev, cfg, iters, x, y, test, codec="int8",
                            restart_at=3)
    check(torch.equal(agg8.server.theta, direct8.server.theta)
          and torch.equal(again8.server.theta, direct8.server.theta),
          "int8 at the aggregator bitwise int8 at the workers, also after "
          "a reset and restore of the aggregator")
    direct = direct_run(dev, cfg, iters, x, y, test)
    summed = aggregated_run(dev, cfg, iters, x, y, test, summed=True)
    err = float((summed.server.theta - direct.server.theta).abs().max())
    check(torch.allclose(summed.server.theta, direct.server.theta,
                         rtol=2e-5, atol=2e-6),
          f"summed composites within rtol 2e-5, atol 2e-6 of the direct "
          f"path (max abs err {err:.3e}, "
          f"{summed.server.composites_received} composites)")


def _shard_f1(dirs, test_path: str, task: str, hidden: int) -> float:
    """F1 on the test set of the theta concatenated from the shards'
    final checkpoints, on the card."""
    from kafka_ps_tpu_torch.cli.run import load_test_csv
    from kafka_ps_tpu_torch.models.task import get_task
    from kafka_ps_tpu_torch.utils.config import ModelConfig
    parts = []
    for i, d in enumerate(dirs):
        with np.load(os.path.join(d, f"job.npz.shard{i}of2.npz")) as z:
            parts.append(torch.from_numpy(z["theta"].astype(np.float32)))
    dev = torch.device("cuda")
    tx, ty = load_test_csv(test_path, F)
    task_ = get_task(task, ModelConfig(num_features=F, num_classes=C,
                                       hidden_dim=hidden))
    m = task_.evaluate(torch.cat(parts).to(dev), torch.from_numpy(tx).to(dev),
                       torch.from_numpy(ty).to(dev, torch.int32))
    return float(m.f1)


def _replay_is_bitwise(dirs, wal: str, task: str, hidden: int,
                       c: int) -> list[int]:
    """Each shard's whole gradient log replayed serially through a fresh
    ServerNode on the card; returns the records replayed per shard, and
    raises unless each ends bitwise at the shard's final checkpoint."""
    from kafka_ps_tpu_torch.log import LogConfig
    from kafka_ps_tpu_torch.log.manager import LogManager
    from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
    from kafka_ps_tpu_torch.runtime import serde
    from kafka_ps_tpu_torch.runtime.server import ServerNode
    from kafka_ps_tpu_torch.runtime.sharding import ShardPlan
    from kafka_ps_tpu_torch.utils.config import ModelConfig, PSConfig
    dev = torch.device("cuda")
    cfg = PSConfig(num_workers=WORKERS, consistency_model=c, task=task,
                   model=ModelConfig(num_features=F, num_classes=C,
                                     hidden_dim=hidden), use_gang=False)
    plan = None
    counts = []
    for i, d in enumerate(dirs):
        with np.load(os.path.join(d, f"job.npz.shard{i}of2.npz")) as z:
            end = json.loads(str(z["log_offsets"]))["gradients/0"]
            want = torch.from_numpy(z["theta"].astype(np.float32)).to(dev)
        if plan is None:
            plan = ShardPlan(ServerNode(cfg, fabric_mod.Fabric(),
                                        dev).task.num_params, 2)
        node = ServerNode(cfg, fabric_mod.Fabric(), dev,
                          key_range=plan.ranges[i], shard_id=i,
                          num_shards=2)
        node.start_training_loop()
        mgr = LogManager(os.path.join(wal, f"shard{i}of2"), LogConfig())
        n = 0
        for off, payload in mgr.get("gradients", 0).read_from(0):
            if off >= end:
                break
            node.process(serde.from_bytes(payload, device=dev))
            n += 1
        mgr.close()
        if not torch.equal(node.theta, want):
            raise RuntimeError(f"shard {i}: the replayed log does not end "
                               "at its final checkpoint")
        counts.append(n)
    return counts


def scaleout_run(topology: str, task: str, c: int, iters: int,
                 flags: tuple = (), hidden: int = H,
                 relay_flags: tuple = (), kill: bool = False,
                 direct_rate: float | None = None, durable: bool = False,
                 during=None, server_flags: tuple = (),
                 tel: bool = False) -> dict:
    """One run of a scale-out topology on the card, every process in its
    own directory under OUT, on write_data()'s CSV (F=1024, C=5, 4
    workers, buffer max 1024, k=2): "shards" is server_runner --listen
    --shards 2 --shard-id 0|1 (with --checkpoint) and two worker_runner
    processes of 2 workers dialing both; "relay" is server_runner
    --listen, agg_runner and two worker_runner --aggregate processes.
    Each worker process's kernel calls must equal its worker CSV rows, of
    the run's family and slab form only, on cuda; the log-visible clock
    spread stays within k + 1 under -c k; shards: both reach the
    iterations, a worker's final clocks on them differ by at most one
    (none under -c 0), the theta assembled from their checkpoints gives
    F1 in (0.5, 1]; relay: the server's eval lag 0, its final F1 in
    (0.5, 1], its iterations at least the run's and under it plus the
    workers (a composite's members apply together).  `kill` (shards):
    --durable-log and --checkpoint_every 25; shard 1 is killed by SIGKILL
    once its gradient log holds about 40 slices, restarted with the same
    command, and must restore, replay its log and get resends from the
    workers' routers; then each shard's
    whole log replayed serially must end bitwise at its checkpoint.
    `durable` (shards): --durable-log without the kill.  `during(wal)`,
    when given, is called once the processes are started and returns a
    callable that is called once they have ended (a replica following
    the shards' logs, serving_runs).  `server_flags` go to the shard or
    server processes only (the tier caps).  `tel`: every process also
    gets the role telemetry flags (files in its own directory)."""
    import signal
    tag = "-".join(["scale", topology, task, f"c{c}",
                    *(f.lstrip("-") for f in flags + relay_flags
                      + server_flags)]
                   + ([f"H{hidden}"] if hidden != H else [])
                   + (["kill"] if kill else []) + (["tel"] if tel else []))
    base = os.path.join(OUT, tag)
    remove(base)
    names = (("s0", "s1") if topology == "shards"
             else ("server", "relay")) + ("w0", "w1")
    dirs = {n: os.path.join(base, n) for n in names}
    for d in dirs.values():
        os.makedirs(d)
    kind = flags[flags.index("--slab-dtype") + 1] \
        if "--slab-dtype" in flags else "f32"
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("KPS_PLATFORM", None)
    common = ["-test", "../../test.csv", "--num_workers", str(WORKERS),
              "--num_features", str(F), "--num_classes", str(C), "--task",
              task, "--hidden_dim", str(hidden), "-l", *flags]
    mod = [sys.executable, "-m"]
    ports = [_free_port(), _free_port()]
    wal = os.path.join(base, "wal")
    cmds = {}
    if topology == "shards":
        for i in (0, 1):
            cmds[f"s{i}"] = mod + [
                "kafka_ps_tpu_torch.cli.server_runner", "--listen",
                str(ports[i]), "--shards", "2", "--shard-id", str(i),
                "-training", "../../train.csv", "-p", "0", "-c", str(c),
                "--max_iterations", str(iters), "--checkpoint", "job.npz",
                "--checkpoint_every", "25" if kill else "1000000",
                *common, *server_flags] + (["--durable-log", wal]
                                           if kill or durable else [])
        dial = ["--connect", ",".join(f"127.0.0.1:{p}" for p in ports)]
    else:
        cmds["server"] = mod + [
            "kafka_ps_tpu_torch.cli.server_runner", "--listen",
            str(ports[0]), "-training", "../../train.csv", "-p", "0", "-c",
            str(c), "--max_iterations", str(iters), *common,
            *server_flags]
        cmds["relay"] = mod + [
            "kafka_ps_tpu_torch.cli.agg_runner", "--connect",
            f"127.0.0.1:{ports[0]}", "--listen", str(ports[1]),
            "--agg-id", "0", "--worker_ids", ",".join(SPLIT_IDS),
            "--checkpoint", "relay.npz", *common, *relay_flags]
        dial = ["--aggregate", f"127.0.0.1:{ports[1]}"]
    for i in (0, 1):
        cmds[f"w{i}"] = mod + ["kafka_ps_tpu_torch.cli.worker_runner",
                               *dial, "--worker_ids", SPLIT_IDS[i], "-max",
                               str(MAX_BUFFER), *common]
    if tel:
        for cmd in cmds.values():
            cmd += role_tel_flags()

    def start(name, suffix=""):
        d = dirs[name]
        return subprocess.Popen(
            cmds[name], cwd=d, env=env,
            stdout=open(os.path.join(d, f"out{suffix}.txt"), "w"),
            stderr=open(os.path.join(d, f"err{suffix}.txt"), "w"))

    t0 = time.perf_counter()
    procs = {n: start(n) for n in names}
    finish = during(wal) if during is not None else None
    try:
        if kill:
            logs = os.path.join(wal, "shard1of2", "gradients")
            deadline = time.monotonic() + 240.0

            def logged():
                return sum(os.path.getsize(os.path.join(dp, f))
                           for dp, _, fs in os.walk(logs) for f in fs
                           if f.endswith(".log"))

            from kafka_ps_tpu_torch.models.task import get_task
            from kafka_ps_tpu_torch.utils.config import ModelConfig
            n_params = get_task(task, ModelConfig(
                num_features=F, num_classes=C,
                hidden_dim=hidden)).num_params
            slice_bytes = 4 * -(-n_params // 2) + 100
            while logged() < 40 * slice_bytes:
                for n, p in procs.items():
                    if p.poll() is not None:
                        raise RuntimeError(f"{tag}: {n} exited "
                                           f"({p.returncode}) before the "
                                           "kill")
                if time.monotonic() > deadline:
                    raise RuntimeError(f"{tag}: shard 1 logged too little")
                time.sleep(0.05)
            procs["s1"].send_signal(signal.SIGKILL)
            procs["s1"].wait(timeout=60)
            time.sleep(0.5)
            procs["s1"] = start("s1", "-restart")
        for p in procs.values():
            p.wait(timeout=400)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        if finish is not None:
            finish()
    wall = time.perf_counter() - t0
    rcs = {n: p.returncode for n, p in procs.items()}
    errs = {n: os.path.join(d, "err-restart.txt" if kill and n == "s1"
                            else "err.txt") for n, d in dirs.items()}
    if any(rcs.values()):
        tails = {n: open(e).read()[-2000:] for n, e in errs.items()}
        raise RuntimeError(f"{tag}: exit codes {rcs}:\n{tails}")
    workers = [_role_stats(errs[f"w{i}"], "worker") for i in (0, 1)]
    worker_rows = [_csv_rows(os.path.join(dirs[f"w{i}"], "logs-worker.csv"))
                   for i in (0, 1)]
    prefix = ("" if task == "logreg" else "mlp_") + (
        "" if kind == "f32" else "stream_")
    mine = f"{prefix}launches"
    calls = []
    for i, (st, rows) in enumerate(zip(workers, worker_rows)):
        n = st["kernels"]
        others = other_kernels(n, (mine,), task, kind, hidden, n[mine], tag)
        calls.append(n[mine])
        print(f"  worker process {i} ({SPLIT_IDS[i]}): device "
              f"{st['device']}, {len(rows)} worker CSV rows, kernel calls "
              f"{mine}={n[mine]}, others {others or 'all 0'}; codec "
              f"{st['codec']}, reconnects {st['reconnects']}, router "
              f"resends {st['router_resent']}, stale slices "
              f"{st['stale_slices']}")
        if not st["device"].startswith("cuda"):
            raise RuntimeError(f"{tag}: worker {i} ran on {st['device']}")
        if n[mine] != len(rows) or sum(st["rows"].values()) != len(rows):
            raise RuntimeError(f"{tag}: worker process {i} made {n[mine]} "
                               f"{mine} calls and {st['rows']} iterations "
                               f"for {len(rows)} CSV rows")
        if others:
            raise RuntimeError(f"{tag}: kernels of another family or form "
                               f"ran in worker process {i}: {others}")
    all_rows = worker_rows[0] + worker_rows[1]
    spread = clock_spread(all_rows)
    first_ms = min(int(r[0]) for r in all_rows)
    values = np.array([[float(v) for v in r[3:6]] for r in all_rows])
    if not np.isfinite(values).all():
        raise RuntimeError(f"{tag}: non-finite worker metrics")
    if c >= 0 and spread > c + 1:
        raise RuntimeError(f"{tag}: clock spread {spread} over -c {c}")
    steady = steady_rate(all_rows)
    rates = []
    if topology == "shards":
        shards = [_role_stats(errs[f"s{i}"], "server") for i in (0, 1)]
        a, b = (st["final_clocks"] for st in shards)
        for i, st in enumerate(shards):
            rate = st["server_iterations"] / ((st["end_ms"] - first_ms)
                                              / 1e3)
            rates.append(rate)
            print(f"  shard {i} {st['key_range']}: {st['server_iterations']}"
                  f" iterations, {rate:.1f} iterations/s from the first "
                  f"worker row, final clocks {st['final_clocks']}, sparse applies "
                  f"{st['sparse_applies']}, empty slices "
                  f"{st['empty_slices']}, duplicates dropped "
                  f"{st['membership']['duplicate_gradients_dropped']}, "
                  f"replay {st['replay']}")
            print(_wire_line(f"shard {i}", st))
            if st["server_iterations"] != iters:
                raise RuntimeError(f"{tag}: shard {i} ran "
                                   f"{st['server_iterations']} iterations")
        print(f"  past the first round: {steady:.1f} worker iterations/s"
              + (f" ({steady / direct_rate:.3f}x the unsharded split run's "
                 f"{direct_rate:.1f})" if direct_rate else ""))
        if (any(abs(x - y) > 1 for x, y in zip(a, b))
                or (c == 0 and a != b)):
            raise RuntimeError(f"{tag}: final clocks {a} and {b} disagree")
        f1 = _shard_f1([dirs["s0"], dirs["s1"]],
                       os.path.join(OUT, "test.csv"), task, hidden)
        print(f"  the theta assembled from the shard checkpoints: F1 "
              f"{f1:.4f} on the test set")
        if kill:
            st = shards[1]
            resent = sum(w["router_resent"] for w in workers)
            if not (st["restored"] and st["replay"]["gradients"] > 0
                    and resent > 0):
                raise RuntimeError(f"{tag}: restored {st['restored']}, "
                                   f"replay {st['replay']}, router resends "
                                   f"{resent}")
            replayed = _replay_is_bitwise([dirs["s0"], dirs["s1"]], wal,
                                          task, hidden, c)
            print(f"  kill and restart: shard 1 restored its checkpoint, "
                  f"replayed {st['replay']} from its log; the workers' "
                  f"routers resent {resent} slices; each shard's whole "
                  f"gradient log ({replayed} records) replayed serially "
                  "ends bitwise at its final checkpoint: True")
            remove(wal)
        for i in (0, 1):      # 8.4 MB a shard at H=4096
            remove(os.path.join(dirs[f"s{i}"], f"job.npz.shard{i}of2.npz"))
    else:
        server = _role_stats(errs["server"], "server")
        relay = _role_stats(errs["relay"], "aggregator")
        server_rows = _csv_rows(os.path.join(dirs["server"],
                                             "logs-server.csv"))
        f1 = float(server_rows[-1][4])
        lag = server["eval"]["lag_clocks"]
        rate = server["server_iterations"] / ((server["end_ms"] - first_ms)
                                              / 1e3)
        rates.append(rate)
        print(f"  server: {server['server_iterations']} iterations, "
              f"{rate:.1f} iterations/s from the first worker row, past the "
              f"first round {steady:.1f} worker iterations/s"
              + (f" ({steady / direct_rate:.3f}x the direct split run's "
                 f"{direct_rate:.1f})" if direct_rate else "")
              + f", final F1 {f1:.4f}, eval lag {lag}, aggregators "
              f"{server['aggregators']}, codec {server['codec']}")
        print(_wire_line("server", server))
        print(f"  relay: {relay['composites']} composites of "
              f"{relay['members']} members, fan-in {relay['fan_in']}, "
              f"{relay['bytes_upstream']} B upstream against "
              f"{relay['direct_bytes']} B the direct path would send "
              f"({relay['bytes_upstream'] / relay['direct_bytes']:.4f}x), "
              f"codec {relay['codec']}, duplicates {relay['duplicates']}")
        print(_wire_line("relay upstream", relay["upstream"]))
        print(_wire_line("relay downstream", relay["downstream"]))
        # a composite's members apply together: the last one may carry
        # the server past --max_iterations by up to its fan-in less one
        if not iters <= server["server_iterations"] < iters + WORKERS \
                or lag != 0:
            raise RuntimeError(f"{tag}: {server['server_iterations']} "
                               f"iterations, eval lag {lag}")
        if server["aggregators"] != 1 or relay["composites"] < 1:
            raise RuntimeError(f"{tag}: no relay traffic")
    for i, st in enumerate(workers):
        print(_wire_line(f"worker process {i}", st))
    print(f"scale-out {tag}: rc={rcs} clock spread {spread}"
          + (f" (bound {c + 1})" if c >= 0 else "")
          + f" wall_s={wall:.1f}")
    if not 0.5 < f1 <= 1.0:
        raise RuntimeError(f"{tag}: bad final F1 {f1}")
    return {"task": task, "kind": kind, "single": sum(calls),
            "gang_calls": 0, "hidden": hidden, "fused": False,
            "rate": min(rates), "steady": steady, "f1": f1, "dir": base,
            "dirs": dirs, "shards": shards if topology == "shards" else None,
            "relay": relay if topology == "relay" else None,
            "topology": topology, "c": c, "flags": flags + relay_flags,
            "server_flags": server_flags, "kill": kill}


def scaleout_runs(direct: dict) -> list[dict]:
    """The scale-out phase through the entry points: two shards with two
    sharded worker processes (logreg -c 0 and -c 2, logreg int8 slabs and
    top-k 0.01 workers at -c 2, the MLP at H=128 and H=4096 -c -1, and
    logreg -c 2 with shard 1 killed and restarted), then a relay between
    the server and two worker processes (logreg -c 0 and -c -1, --summed
    -c 0, --compress int8 -c 2 and the MLP at H=4096 -c -1; the MLP bf16
    slabs run in the role telemetry phase), each beside the split run of
    the same flags from the split
    phase (`direct`: its worker iterations/s past the first round; the
    top-k workers beside the plain -c 2 run: the shard servers send dense
    weights, a direct --compress topk run top-k ones).  A shards run and
    a relay run go at once (the killed-shard run alone), so the rates are
    taken under two runs' load."""
    runs = []
    topk = ("--compress", "topk:0.01")
    specs = [("shards", "logreg", 0, SCALE_SHORT, (), H, ()),
             ("shards", "logreg", 2, SCALE_SHORT, (), H, ()),
             ("shards", "logreg", 2, SCALE_SHORT, ("--slab-dtype", "int8"),
              H, ()),
             ("shards", "logreg", 2, SCALE_SHORT, topk, H, ()),
             ("shards", "mlp", -1, SCALE_SHORT, (), H, ()),
             ("shards", "mlp", -1, SCALE_WIDE, (), WIDE_H, ()),
             ("relay", "logreg", 0, SCALE_SHORT, (), H, ()),
             ("relay", "logreg", -1, SCALE_SHORT, (), H, ()),
             ("relay", "logreg", 0, SCALE_SHORT, (), H, ("--summed",)),
             ("relay", "logreg", 2, SCALE_SHORT, ("--compress", "int8"), H,
              ()),
             ("relay", "mlp", -1, SCALE_WIDE, (), WIDE_H, ())]
    # the relay with the MLP's bf16 slabs at -c -1 runs once, with the
    # telemetry flags, in the role telemetry phase (role_relay_check)
    calls = []
    for topology, task, c, iters, flags, hidden, rflags in specs:
        twin = direct.get((task, c, flags, hidden),
                          direct.get((task, c, (), hidden)))
        calls.append(functools.partial(
            scaleout_run, topology, task, c, iters, flags, hidden, rflags,
            direct_rate=twin))
    # a shards run and a relay run at a time share the card: the checks
    # are of function, and the rates are taken under that load
    shards, relays = calls[:6], calls[6:]
    for k, call in enumerate(shards):
        runs += _at_once([call] + relays[k:k + 1])
    runs.append(scaleout_run("shards", "logreg", 2, SCALE_ITERS, kill=True,
                             direct_rate=direct.get(("logreg", 2, (), H))))
    return runs


_LOAD = threading.local()


class _TaggedLines(io.TextIOBase):
    """This script's stdout: a thread of _at_once, which runs beside
    other deployments, has each whole line it prints marked with that
    load, so that no rate, ratio or latency taken under another run's
    load reads as one taken alone."""

    def __init__(self, out):
        self.out = out
        self._lock = threading.Lock()

    def write(self, s: str) -> int:
        tag = getattr(_LOAD, "tag", None)
        if tag is None:
            with self._lock:
                self.out.write(s)
            return len(s)
        *lines, _LOAD.rest = (_LOAD.rest + s).split("\n")
        if lines:
            with self._lock:
                self.out.write("".join(f"{tag} {ln}\n" for ln in lines))
        return len(s)

    def flush(self) -> None:
        self.out.flush()


def _at_once(calls) -> list:
    """Run the callables at once, each on a thread of this script; their
    results in order, the first failure re-raised.  Every line a call
    prints starts with "[shared load i/n]" (_TaggedLines): its rates and
    latencies were taken beside the other n - 1 runs, on one card and
    the host's cores, and are no baseline."""
    done: dict = {}

    def run(i, call):
        _LOAD.tag, _LOAD.rest = f"[shared load {i + 1}/{len(calls)}]", ""
        try:
            done[i] = (True, call())
        except BaseException as e:      # re-raised on this thread
            done[i] = (False, e)
        finally:
            if _LOAD.rest:
                print()
            _LOAD.tag = None

    threads = [threading.Thread(target=run, args=(i, call), daemon=True)
               for i, call in enumerate(calls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    out = []
    for i in range(len(calls)):
        ok, got = done.get(i, (False, None))
        if not ok:
            raise RuntimeError(f"run {i} of {len(calls)} at once failed"
                               ) from got
        out.append(got)
    return out


# -- the serving phase (serving/, tests/torch_serving_runs.py) ---------------

class ServeLoad:
    """A closed load of `concurrency` PredictClients (serving/loadgen.py's
    SocketTarget, over shared memory when `shm`) on a port that may not be
    up yet: it starts once `ready()` holds and the port accepts, and runs
    until `finish()`.  Every answer is recorded per client, in order:
    (status, clock, monotonic time) with status ok, stale, shed, failed
    (PREDICT_FAILED) or closed (the server went away)."""

    def __init__(self, port: int, concurrency: int = SERVE_CLIENTS,
                 shm: bool = False, ready=None):
        from kafka_ps_tpu_torch.serving import loadgen
        self.port, self.concurrency, self.shm = port, concurrency, shm
        self.ready = ready
        self.target = loadgen.SocketTarget("127.0.0.1", port, shm=shm)
        self.clients: list[list] = []
        self.shm_active: list[bool] = []
        self.result = None
        self.stop = threading.Event()
        self._lock = threading.Lock()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _accepts(self) -> bool:
        import socket
        try:
            socket.create_connection(("127.0.0.1", self.port),
                                     timeout=1.0).close()
            return True
        except OSError:
            return False

    def _run(self) -> None:
        from kafka_ps_tpu_torch.serving import loadgen
        deadline = time.monotonic() + 300.0
        while not ((self.ready is None or self.ready()) and self._accepts()):
            if self.stop.is_set() or time.monotonic() > deadline:
                return
            time.sleep(0.02)
        self.result = loadgen.run_closed_loop(
            self, F, concurrency=self.concurrency, duration_s=3600.0,
            stop=self.stop)

    def make_issue(self):
        """The loadgen target protocol: SocketTarget's client, recorded."""
        from kafka_ps_tpu_torch.serving import OverloadedError, StalenessError
        rec: list = []
        with self._lock:     # held across the dial: the last client is ours
            issue = self.target.make_issue()
            self.clients.append(rec)
            self.shm_active.append(self.target._clients[-1].shm_active)

        def _issue(x):
            try:
                p = issue(x)
            except StalenessError:
                rec.append(("stale", None, time.monotonic()))
                raise
            except OverloadedError:
                rec.append(("shed", None, time.monotonic()))
                raise
            except (ConnectionError, OSError):
                rec.append(("closed", None, time.monotonic()))
                time.sleep(0.05)
                raise
            except RuntimeError:
                rec.append(("failed", None, time.monotonic()))
                raise
            rec.append(("ok", p.vector_clock, time.monotonic()))
            return p

        return _issue

    def close(self) -> None:
        self.target.close()

    def last_clock(self) -> int:
        clocks = [c for rec in list(self.clients) for s, c, _ in rec[-5:]
                  if s == "ok"]
        return max(clocks, default=-1)

    def finish(self) -> dict:
        """Stop the load; per-client checks and the summary: answers by
        status, accepted p50/p99 ms, answered QPS over the window of
        accepted answers, each client's clocks non-decreasing."""
        self.stop.set()
        self.thread.join(timeout=120.0)
        self.target.close()
        if self.thread.is_alive():
            raise RuntimeError("serving load: the clients did not stop")
        counts = {k: 0 for k in ("ok", "stale", "shed", "failed", "closed")}
        monotone, stale_after_ok = True, 0
        stamps, last = [], []
        for rec in self.clients:
            clocks = [c for s, c, _ in rec if s == "ok"]
            monotone &= clocks == sorted(clocks)
            seen_ok = False
            for s, c, t in rec:
                counts[s] += 1
                if s == "ok":
                    seen_ok = True
                    stamps.append(t)
                elif s == "stale" and seen_ok:
                    stale_after_ok += 1
            if clocks:
                last.append(clocks[-1])
        answered = sum(v for k, v in counts.items() if k != "closed")
        span = max(stamps) - min(stamps) if len(stamps) > 1 else 0.0
        res = self.result
        return {"counts": counts, "answered": answered,
                "monotone": monotone, "stale_after_ok": stale_after_ok,
                "qps": (len(stamps) - 1) / span if span > 0 else 0.0,
                "p50_ms": None if res is None else res.p50_ms,
                "p99_ms": None if res is None else res.p99_ms,
                "last_clocks": last, "clients": len(self.clients),
                "shm_active": list(self.shm_active)}


def _file_has(path: str, text: str):
    def check() -> bool:
        try:
            with open(path) as f:
                return text in f.read()
        except FileNotFoundError:
            return False
    return check


def serve_report(name: str, load: dict, stats: dict | None,
                 stable_clock: int | None = None) -> None:
    """One line of serving metrics beside the card: latency, QPS, shed and
    stale shares, dispatches, rows per dispatch, bypass share and the
    served clock's lag behind the server's stable clock at the end."""
    n = max(load["answered"], 1)
    c = load["counts"]
    line = (f"serving {name} [{card_line()}]: p50_ms={load['p50_ms']} "
            f"p99_ms={load['p99_ms']} answered_qps={load['qps']:.1f} "
            f"({load['clients']} clients, answers {c}) shed_share="
            f"{c['shed'] / n:.4f} stale_share={c['stale'] / n:.4f}")
    if stats is not None:
        reqs = max(stats["requests"], 1)
        line += (f"; engine: requests {stats['requests']} dispatches "
                 f"{stats['batches']} rows_per_dispatch "
                 f"{stats['occupancy']} bypass_share "
                 f"{stats['bypasses'] / reqs:.4f} mode {stats['mode']} "
                 f"errors {stats['errors']}")
    if stable_clock is not None and load["last_clocks"]:
        line += (f"; served clock lag at the end "
                 f"{stable_clock - max(load['last_clocks'])}"
                 f"..{stable_clock - min(load['last_clocks'])} clocks "
                 f"(stable clock {stable_clock})")
    print(line)


def check_answers(name: str, load: dict, *, stale_ok: bool = True) -> None:
    """No PREDICT_FAILED and no shed, STALE only before a client's first
    accepted answer (`stale_ok`: at all), clocks never going back."""
    c = load["counts"]
    if not c["ok"] or c["failed"] or c["shed"] or not load["monotone"]:
        raise RuntimeError(f"serving {name}: answers {c}, clocks monotone "
                           f"{load['monotone']}")
    if load["stale_after_ok"] or (c["stale"] and not stale_ok):
        raise RuntimeError(f"serving {name}: {c['stale']} STALE answers, "
                           f"{load['stale_after_ok']} after an accepted one")


def serving_reference_check(dev) -> None:
    """In process on the card: the engine against its own answers on the
    CPU from the same snapshot at every bucket size (logreg, the MLP at
    H=128 and 4096; F=1024, C=5); the gang's prefix snapshots bitwise the
    per-message sequence (-c 0, 3, -1, F=1024); a two-shard
    ShardedServerGroup with attach_serving: N=1 bitwise the unsharded
    registry, N=2 publishing only at frontier advances, each cut bitwise
    N=1's theta at its clock."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_serving_runs import (engine_card_vs_cpu, frontier_check,
                                    serve_config, snapshot_sequence)
    for task, hidden in (("logreg", H), ("mlp", H), ("mlp", WIDE_H)):
        out = engine_card_vs_cpu(dev, task, hidden, F, C, SERVE_BATCH)
        print(f"serving engine on the card against the CPU ({task}, H="
              f"{hidden}, buckets 1..{SERVE_BATCH}, {out['rows']} rows): "
              f"confidences max abs {out['max_abs_err']:.3e} within rtol "
              f"1e-5 atol 1e-6 {out['within']}; labels equal where the "
              f"top-two margin > 1e-5 ({out['defined']} of {SERVE_BATCH} "
              f"rows): mismatches {out['label_mismatches']}; snapshot on "
              f"{out['snapshot_device']}")
        if (not out["within"] or out["label_mismatches"]
                or out["snapshot_device"] != "cuda" or out["clock"] != 6):
            raise RuntimeError(f"serving engine {task} H={hidden}: {out}")
    for c in (0, 3, -1):
        seqs = [snapshot_sequence(serve_config(c, use_gang=g, features=F,
                                               classes=C), dev)
                for g in (True, False)]
        print(f"serving: gang prefix snapshots at -c {c} (F={F}): "
              f"{len(seqs[0])} snapshots, bitwise the per-message "
              f"sequence: {seqs[0] == seqs[1]}")
        if seqs[0] != seqs[1] or len(seqs[0]) < 2:
            raise RuntimeError(f"serving: gang snapshots differ at -c {c}")
    out = frontier_check(dev, serve_config(0, use_gang=False,
                                           eval_async=False, features=F,
                                           classes=C))
    print(f"serving: ShardedServerGroup.attach_serving on the card: N=1 "
          f"bitwise the unsharded registry ({out['n1_snapshots']} "
          f"snapshots) {out['n1_bitwise']}; N=2 {out['cuts']} cuts, "
          f"increasing {out['cuts_increasing']}, the last at the frontier "
          f"{out['last_is_frontier']}, each bitwise N=1's theta at its "
          f"clock {out['cuts_bitwise']}, on {out['device']}")
    if not (out["n1_bitwise"] and out["cuts_increasing"] and out["cuts"] > 3
            and out["last_is_frontier"] and out["cuts_bitwise"]
            and out["device"] == "cuda"):
        raise RuntimeError(f"serving: frontier check failed: {out}")


def _newest_weights(root: str) -> tuple[int, bytes]:
    """(clock, float32 bytes) of the newest logged weights under a
    durable-log root, read by the log's own reader
    (DurableFabric.latest_logged_weights); a sharded root's slices
    concatenated in key order, at the minimum of their clocks."""
    from kafka_ps_tpu_torch.log import DurableFabric, LogConfig
    dirs = sorted(d for d in os.listdir(root) if d.startswith("shard"))
    parts = []
    for d in (dirs or ["."]):
        fab = DurableFabric(os.path.join(root, d), LogConfig(fsync="none"))
        try:
            msg = fab.latest_logged_weights()
        finally:
            fab.close()
        parts.append((msg.key_range.start, msg.vector_clock, msg.values))
    parts.sort(key=lambda p: p[0])
    theta = torch.cat([v for _, _, v in parts]).cpu().numpy()
    return min(c for _, c, _ in parts), theta.tobytes()


def _replica(root: str, err: str, cwd: str = OUT, flags: tuple = ()):
    """server_runner --serve-replica on `root`, on the card, in `cwd` with
    `flags`, its stderr to `err`: (process, port)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("KPS_PLATFORM", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kafka_ps_tpu_torch.cli.server_runner",
         "--serve-replica", "--durable-log", root, "--serve_port", str(port),
         "--num_features", str(F), "--num_classes", str(C), "--task",
         "logreg", *flags], cwd=cwd, env=env, stdout=subprocess.DEVNULL,
        stderr=open(err, "w"))
    return proc, port


def _end_replica(name: str, proc, err: str, load: ServeLoad, root: str):
    """Let the replica reach the log's newest weights (its load's answers
    carry their clock), stop the load and the replica (SIGINT), and hold
    its last snapshot bitwise to them.  Returns the load summary."""
    import hashlib
    import signal
    clock, theta = _newest_weights(root)
    deadline = time.monotonic() + 60.0
    while load.last_clock() < clock and time.monotonic() < deadline:
        time.sleep(0.05)
    got = load.finish()
    proc.send_signal(signal.SIGINT)
    try:
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    stats = _role_stats(err, "replica")
    same = (stats["clock"] == clock and stats["snapshot_sha256"]
            == hashlib.sha256(theta).hexdigest())
    print(f"serving {name}: {stats['shards']} shard logs, "
          f"{stats['records_read']} records read, "
          f"{stats['publications']} publications, on "
          f"{stats['device']}; its last snapshot at clock {stats['clock']} "
          f"bitwise the log's newest weights at clock {clock}: {same}")
    serve_report(name, got, stats["serving"], clock)
    check_answers(name, got)
    if (proc.returncode != 0 or not same
            or not stats["device"].startswith("cuda")
            or stats["serving"]["errors"]):
        raise RuntimeError(f"serving {name}: rc {proc.returncode}, {stats}")
    return got


def serving_runs(threaded_rate: float) -> list[dict]:
    """Through the entry points, under closed loads of PredictClients
    (serving/loadgen.py): cli.run --serve --serve_port at serial -c 0 on
    a 512-row CSV (4 workers x the 128-row prefill: every row buffered
    before the first iteration) beside the same run without --serve,
    theta (the exit checkpoint) and the rows bitwise; threaded -c 2 (its
    iterations/s against the main path's run without serving,
    `threaded_rate`); --fused --task mlp --hidden_dim 4096 (40 rounds);
    a read replica following a cli.run --durable-log run while it trains
    (the split server's socket and shm clients and a replica of a
    --shards 2 deployment run in the role telemetry phase).  Every run's
    kernel calls are checked as the main path's are (main_path_run,
    split_run, scaleout_run)."""
    runs = []
    with open(os.path.join(OUT, "train.csv")) as f:
        head = [next(f) for _ in range(SERVE_TRAIN_ROWS + 1)]
    with open(os.path.join(OUT, "serve-train.csv"), "w") as f:
        f.writelines(head)
    # serial -c 0 with and without a read load: bitwise
    ck = ("--checkpoint_every", "1000000")
    for name in ("ck-serve-on.npz", "ck-serve-off.npz"):
        remove(os.path.join(OUT, name))
    port = _free_port()
    load = ServeLoad(port)
    on = main_path_run("logreg", "serial", 0, ITERS,
                       ("--serve", "--serve_port", str(port),
                        "--checkpoint", "ck-serve-on.npz", *ck),
                       train="serve-train.csv")
    got = load.finish()
    off = main_path_run("logreg", "serial", 0, ITERS,
                        ("--checkpoint", "ck-serve-off.npz", *ck),
                        train="serve-train.csv")
    with np.load(os.path.join(OUT, "ck-serve-on.npz")) as a, \
            np.load(os.path.join(OUT, "ck-serve-off.npz")) as b:
        theta_same = a["theta"].tobytes() == b["theta"].tobytes()
    rows_same = all(
        strip_stamps(open(os.path.join(OUT, f"{k}-{on['tag']}.csv"))
                     .read().splitlines()[1:])
        == strip_stamps(open(os.path.join(OUT, f"{k}-{off['tag']}.csv"))
                        .read().splitlines()[1:])
        for k in ("server", "worker"))
    st = on["serving"]
    serve_report("cli.run serial -c 0", got, st, st["stable_clock"])
    print(f"serving cli.run serial -c 0 under load against the same run "
          f"without --serve: theta bitwise {theta_same}, rows (less "
          f"stamps) bitwise {rows_same}; iterations/s {on['rate']:.1f} "
          f"against {off['rate']:.1f} "
          f"({on['rate'] / off['rate']:.3f}x) [{card_line()}]")
    check_answers("cli.run serial", got, stale_ok=False)
    if not theta_same or not rows_same or st["errors"]:
        raise RuntimeError("serving: the served serial run differs from "
                           "the run without --serve")
    runs += [on, off]
    # threaded -c 2 under the same load
    port = _free_port()
    load = ServeLoad(port)
    run = main_path_run("logreg", "threaded", 2, ITERS,
                        ("--serve", "--serve_port", str(port)))
    got = load.finish()
    st = run["serving"]
    serve_report("cli.run threaded -c 2", got, st, st["stable_clock"])
    print(f"serving cli.run threaded -c 2: iterations/s {run['rate']:.1f} "
          f"under the read load against {threaded_rate:.1f} without "
          f"({run['rate'] / threaded_rate:.3f}x) [{card_line()}]")
    check_answers("cli.run threaded", got)
    runs.append(run)
    # the fused MLP at H=4096
    port = _free_port()
    load = ServeLoad(port)
    run = main_path_run("mlp", "serial", 0, FUSED_MLP_ROUNDS * WORKERS,
                        ("--fused", "--eval_every", "10", "--serve",
                         "--serve_port", str(port)), hidden=WIDE_H)
    got = load.finish()
    st = run["serving"]
    serve_report("cli.run --fused --task mlp H=4096", got, st,
                 st["stable_clock"])
    check_answers("cli.run fused", got)
    if max(got["last_clocks"]) > st["stable_clock"]:
        raise RuntimeError("serving fused: an answer's clock is past the "
                           "server's stable clock")
    runs.append(run)
    # the split server by socket and by shm, and a replica of a --shards 2
    # deployment's logs, run in the role telemetry phase with the
    # telemetry flags (role_serve_check, role_tier_replica_check)
    # a replica following a trainer's log while it trains
    root = os.path.join(OUT, "wal-serve")
    remove(root)
    remove(os.path.join(OUT, "ck-wal-serve.npz"))
    err = os.path.join(OUT, "replica-err.txt")
    proc, port = _replica(root, err)
    ready = _file_has(err, "replica serving on")
    deadline = time.monotonic() + 120.0
    while not ready():          # the replica follows from the first record
        if proc.poll() is not None or time.monotonic() > deadline:
            raise RuntimeError("serving: the replica did not start:\n"
                               + open(err).read()[-2000:])
        time.sleep(0.05)
    load = ServeLoad(port, 2, ready=ready)
    try:
        run = main_path_run("logreg", "threaded", 0, SLICE1_ITERS,
                            ("--durable-log", "wal-serve", "--checkpoint",
                             "ck-wal-serve.npz"))
    except BaseException:
        load.finish()
        proc.kill()
        raise
    _end_replica("replica of cli.run --durable-log", proc, err, load, root)
    runs.append(run)
    remove(root)
    return runs


# -- the tier phase (store/: tiered parameter residency) ---------------------

def tier_flags(page: int, hot: int, warm: int) -> tuple:
    return (("--tier-hot-bytes", str(hot))
            + (("--tier-warm-bytes", str(warm)) if warm else ())
            + ("--tier-page-params", str(page)))


def tier_line(st: dict) -> str:
    """A store's stats (store/tiered.TieredParamStore.stats) in one line."""
    return (f"{st['pages']} pages of {st['page_params']} keys, tiers "
            f"{st['tiers']} (after the last rebalance "
            f"{st['settled_tiers']}), pins {st['pins']}, faults "
            f"{st['faults']}, "
            f"promotions {st['promotions']}, demotions {st['demotions']}, "
            f"rebalances {st['rebalances']}, device_bytes "
            f"{st['device_bytes']}, upload_bytes {st['upload_bytes']}, "
            f"host_upload_bytes {st['host_upload_bytes']}, "
            f"host_fetch_bytes {st['host_fetch_bytes']}, cold appends "
            f"{st['cold_appends']} reads {st['cold_reads']}")


def _sha(path: str):
    """(SHA-256 of a checkpoint's theta, its recorded residency or None)."""
    import hashlib
    with np.load(path) as z:
        theta = z["theta"]
        residency = (z["tier_residency"].copy()
                     if "tier_residency" in z.files else None)
    return hashlib.sha256(theta.tobytes()).hexdigest(), residency


def _stripped(run: dict) -> list:
    return [strip_stamps(open(os.path.join(OUT, f"{k}-{run['tag']}.csv"))
                         .read().splitlines()[1:])
            for k in ("server", "worker")]


def tier_store_check(dev) -> None:
    """A TieredParamStore on the card over the MLP's initial theta at
    H=4096 (4,222,982 parameters) in pages of TIER_WIDE_PAGE keys: 65
    pages (64 full, one of 28,678), 32 hot, 16 warm and 17 cold in a
    ColdStore under the caps.  Pins shift the heat twice, so that pages
    move hot -> warm -> cold and back; after every rebalance the tier
    counts hold, the hot pages' bytes on the card stay under the hot cap,
    `assembled()` is bitwise the values written, and a per-page apply
    (t + lr*d per page, on the card, as the server's) is bitwise the
    whole-vector apply."""
    from kafka_ps_tpu_torch.models.task import get_task
    from kafka_ps_tpu_torch.runtime.messages import KeyRange
    from kafka_ps_tpu_torch.store import (TIER_NAMES, ColdStore,
                                          TieredParamStore)
    from kafka_ps_tpu_torch.utils.config import ModelConfig
    cfg = ModelConfig(num_features=F, num_classes=C, hidden_dim=WIDE_H)
    theta = get_task("mlp", cfg).init_params(dev)
    n = theta.numel()
    wal = os.path.join(OUT, "wal-tier-store")
    remove(wal)
    store = TieredParamStore(theta, KeyRange(0, n), hot_bytes=TIER_WIDE_HOT,
                             warm_bytes=TIER_WIDE_WARM,
                             page_params=TIER_WIDE_PAGE,
                             cold=ColdStore.open(wal), device=dev)
    last = store.page_range(store.num_pages - 1)
    print(f"tier store on the card: {n} parameters, {store.num_pages} pages "
          f"of {TIER_WIDE_PAGE} keys (the last {last.end - last.start}), "
          f"caps hot {TIER_WIDE_HOT} B warm {TIER_WIDE_WARM} B")
    if (store.num_pages != -(-n // TIER_WIDE_PAGE)
            or last.end - last.start != n - (n - 1) // TIER_WIDE_PAGE
            * TIER_WIDE_PAGE):
        raise RuntimeError("tier store: page geometry")
    # the caps hold whole full pages; the short last page starts cold
    hot = TIER_WIDE_HOT // (4 * TIER_WIDE_PAGE)
    warm = TIER_WIDE_WARM // (4 * TIER_WIDE_PAGE)
    want_counts = {"hot": hot, "warm": warm,
                   "cold": store.num_pages - hot - warm}
    gen = torch.Generator(device=dev).manual_seed(12)
    lr = 1.0 / WORKERS
    state = {"theta": theta, "residency": store.residency_vector()}
    moves: dict = {}

    def settle(step: str) -> None:
        t0 = time.perf_counter()
        moved = store.rebalance()
        ms = (time.perf_counter() - t0) * 1e3
        now = store.residency_vector()
        for a, b in zip(state["residency"], now):
            if a != b:
                key = f"{TIER_NAMES[a]}->{TIER_NAMES[b]}"
                moves[key] = moves.get(key, 0) + 1
        state["residency"] = now
        counts = store.tier_counts()
        dbytes = store.stats()["device_bytes"]
        current = state["theta"]
        same = store.assembled().tobytes() == current.cpu().numpy().tobytes()
        # a per-page apply against the whole-vector apply, on the card
        delta = torch.randn(n, generator=gen, device=dev)
        full = current + lr * delta
        for i, kr, value in store.pin_pages(KeyRange(0, n)):
            store.update_page(i, store.to_device(value)
                              + lr * delta[kr.start:kr.end])
        paged = torch.equal(store.assembled_tensor(), full)
        state["theta"] = full
        print(f"  {step}: rebalance {ms:.1f} ms (host clock), moved "
              f"{moved['moved']} pages, tiers {counts}, device_bytes "
              f"{dbytes} (cap {TIER_WIDE_HOT}), assembled() bitwise {same},"
              f" per-page apply bitwise the whole apply {paged}")
        if counts != want_counts or dbytes > TIER_WIDE_HOT or not same \
                or not paged:
            raise RuntimeError(f"tier store: {step} failed")

    settle("initial residency")
    # heat on the last `hot` pages (warm and cold), then back on the first
    top = store.num_pages - hot
    for i in range(top, store.num_pages):
        for _ in range(8):
            store.pin(store.page_range(i))
    settle(f"heat on pages {top}-{store.num_pages - 1}")
    for i in range(hot):
        for _ in range(16):
            store.pin(store.page_range(i))
    settle(f"heat back on pages 0-{hot - 1}")
    st = store.stats()
    store.close()
    remove(wal)
    print(f"  moves by rebalance {moves}; {tier_line(st)}")
    for key in ("hot->warm", "warm->cold", "cold->hot", "hot->cold",
                "warm->hot"):
        if not moves.get(key):
            raise RuntimeError(f"tier store: no {key} move")
    if not st["faults"]:
        raise RuntimeError("tier store: no cold fault")


def tier_cli_pair(task: str, mode: str, c: int, iters: int, tier: tuple,
                  hidden: int = H, name: str = "") -> list[dict]:
    """`cli.run` on the 512-row CSV with --durable-log and an exit
    checkpoint, under the tier caps and without them: the final theta's
    SHA-256 and the rows (less their stamps) equal (the capped run's
    checkpoint stays, as `ck-tier-<name>-capped.npz`); the capped store's
    last rebalance, the one its close runs after the final save, left
    pages in every tier; and pages were faulted in from the log and
    migrated."""
    runs = []
    for arm, flags in (("capped", tier), ("plain", ())):
        wal, ck = f"wal-tier-{name}-{arm}", f"ck-tier-{name}-{arm}.npz"
        for stale in (wal, ck):
            remove(os.path.join(OUT, stale))
        runs.append(main_path_run(
            task, mode, c, iters, ("--durable-log", wal, "--checkpoint", ck,
                                   "--checkpoint_every", "1000000", *flags),
            hidden, train="tier-train.csv"))
        remove(os.path.join(OUT, wal))
    capped, plain = runs
    (a, residency), (b, _) = (
        _sha(os.path.join(OUT, f"ck-tier-{name}-{arm}.npz"))
        for arm in ("capped", "plain"))
    rows = _stripped(capped) == _stripped(plain)
    st = capped["tier"]
    counts = np.bincount(residency, minlength=3).tolist()
    settled = [st["settled_tiers"][t] for t in ("hot", "warm", "cold")]
    print(f"tier {name}: {task} {mode} -c {c} H={hidden} {' '.join(tier)}: "
          f"theta SHA-256 {a[:16]}.. against {b[:16]}.. equal {a == b}, "
          f"rows (less stamps) equal {rows}; (hot, warm, cold) pages after "
          f"the last rebalance {settled}, in the checkpoint {counts}; "
          f"iterations/s "
          f"{capped['rate']:.1f} "
          f"capped against {plain['rate']:.1f} resident "
          f"({capped['rate'] / plain['rate']:.3f}x) [{card_line()}]")
    if a != b or not rows:
        raise RuntimeError(f"tier {name}: the capped run differs from the "
                           "resident run")
    if min(settled) < 1 or not st["faults"] or not (st["promotions"]
                                                    and st["demotions"]):
        raise RuntimeError(f"tier {name}: tiers {settled}, faults "
                           f"{st['faults']}, promotions {st['promotions']},"
                           f" demotions {st['demotions']}")
    remove(os.path.join(OUT, f"ck-tier-{name}-plain.npz"))
    return runs


def tier_crash_check(base: str) -> None:
    """A capped serial -c 0 run (logreg, the 512-row CSV, --durable-log,
    --checkpoint_every 50, --eval_every 10) killed with SIGKILL right after
    iteration CLI_KILL_AT (scripts/torch_kill_at.py), then the same
    command again, which restores into a tiered store (`-v` prints its
    tier counts after the restore) and replays: the final checkpoint
    equals `base`, the exit checkpoint of the uninterrupted capped run of
    tier_cli_pair (theta, clocks, iterations; its other eval cadence and
    checkpoint period change no value).  The residency the killed run's
    checkpoint recorded is printed beside the restored store's: they may
    differ, because the policy thread runs from the store's attach on and
    moves pages by heat at once (a dense run's checkpoint records its cold
    pages faulted warm); `tests/test_torch_store.py` and
    `tests/test_torch_tier_runs.py` hold `set_residency` and the
    checkpoint's residency to the JAX package's without that thread."""
    env = dict(os.environ, PYTHONPATH=REPO)
    args = ["-training", "tier-train.csv", "-test", "test.csv",
            "--num_workers", str(WORKERS), "--num_features", str(F),
            "--num_classes", str(C), "--mode", "serial", "-c", "0",
            "-p", "2", "--eval_every", "10", "--max_iterations",
            str(CRASH_ITERS), "--checkpoint_every", "50", "-v",
            *tier_flags(TIER_PAGE, TIER_HOT, TIER_WARM)]
    cli = [sys.executable, "-m", "kafka_ps_tpu_torch.cli.run"]
    kill = [sys.executable, os.path.join(REPO, "scripts", "torch_kill_at.py"),
            str(CLI_KILL_AT), "--"]
    names = ("ck-tier-crash.npz", "ck-tier-killed.npz", "wal-tier-crash")
    for stale in names:
        remove(os.path.join(OUT, stale))

    def run(cmd):
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=OUT, env=env, capture_output=True,
                           text=True, timeout=300)
        return r, time.perf_counter() - t0

    wal = ["--checkpoint", "ck-tier-crash.npz", "--durable-log",
           "wal-tier-crash"]
    killed, killed_s = run(kill + args + wal)
    if killed.returncode != -9:
        raise RuntimeError(f"tier crash check: the killed run ended with "
                           f"{killed.returncode}:\n{killed.stderr[-2000:]}")
    shutil.copy(os.path.join(OUT, "ck-tier-crash.npz"),
                os.path.join(OUT, "ck-tier-killed.npz"))
    again, again_s = run(cli + args + wal)
    if again.returncode != 0:
        raise RuntimeError("tier crash check: the restart failed:\n"
                           + again.stderr[-2000:])
    _, recorded = _sha(os.path.join(OUT, "ck-tier-killed.npz"))
    want = dict(zip(("hot", "warm", "cold"),
                    np.bincount(recorded, minlength=3).tolist()))
    restored = [ln.strip() for ln in again.stdout.splitlines()
                if "restored tier residency" in ln]
    stats = [json.loads(line.split(": ", 1)[1])
             for line in again.stderr.splitlines()
             if line.startswith("kafka_ps_tpu_torch run: ")][-1]
    with np.load(os.path.join(OUT, base)) as a, \
            np.load(os.path.join(OUT, "ck-tier-crash.npz")) as b:
        same = (a["theta"].tobytes() == b["theta"].tobytes()
                and np.array_equal(a["clocks"], b["clocks"])
                and int(a["iterations"]) == int(b["iterations"])
                == CRASH_ITERS)
    print(f"tier crash check on the card: killed at {CLI_KILL_AT} after "
          f"{killed_s:.1f} s, restart "
          f"{again_s:.1f} s: {restored} (the killed run's last checkpoint "
          f"recorded {want}); restore {stats['checkpoint']['restore_s']:.4f}"
          f" s, replay {stats['durable']['replay_s']:.4f} s "
          f"({stats['durable']['replayed']}); restarted store: "
          f"{tier_line(stats['tier'])}; final checkpoint equal to the "
          f"uninterrupted capped run's (theta, clocks, {CRASH_ITERS} "
          f"iterations): "
          f"{same}")
    if not same or len(restored) != 1:
        raise RuntimeError("tier crash check: the resumed run differs from "
                           "the uninterrupted capped run, or it did not "
                           "restore into a tiered store:\n"
                           + again.stdout[-1500:] + again.stderr[-1500:])
    for stale in names:
        remove(os.path.join(OUT, stale))


def tier_runs(dev, twins: dict) -> list[dict]:
    """The tier phase: the store on the card (tier_store_check); cli.run
    under the caps beside the same run without them on a 512-row CSV (4
    workers x the 128-row prefill: every row buffered before the first
    iteration, so the pair is deterministic), bitwise: the MLP at H=4096
    serial -c 0 (TIER_WIDE_ITERS iterations, 65 pages) and logreg serial
    at -c 0, 2 and -1 (25 pages of TIER_PAGE keys); a threaded -c 2
    capped logreg run on the whole CSV (the policy thread racing real
    applies: eval lag 0, rebalances and migrations); the crash and resume
    (tier_crash_check); then, held to completion and to F1 within
    1/len(test) of the uncapped twin (arrival order makes these runs
    differ run to run): server_runner --listen with a hot cap (a split
    server refuses --durable-log, so it has no cold tier) and two worker
    processes at -c 2 (SPLIT_ITERS), and --shards 2 --durable-log with
    per-shard caps for the MLP at H=128 -c -1 (17 pages of
    TIER_SHARD_PAGE keys a shard), dense and with --compress topk:0.01
    (the tiered sparse apply), each shard's cold partition under its
    shard<I>of2 directory.  `twins` holds the uncapped runs of the split
    and scale-out phases with the same flags ("split": logreg -c 2,
    "shards": the MLP at H=128 -c -1); the top-k twin runs here.  These
    four deployments go two at a time (_at_once)."""
    runs = []
    with open(os.path.join(OUT, "train.csv")) as f:
        head = [next(f) for _ in range(SERVE_TRAIN_ROWS + 1)]
    with open(os.path.join(OUT, "tier-train.csv"), "w") as f:
        f.writelines(head)
    tier_store_check(dev)
    wide = tier_flags(TIER_WIDE_PAGE, TIER_WIDE_HOT, TIER_WIDE_WARM)
    runs += tier_cli_pair("mlp", "serial", 0, TIER_WIDE_ITERS, wide,
                          hidden=WIDE_H, name="wide")
    small = tier_flags(TIER_PAGE, TIER_HOT, TIER_WARM)
    for c in (0, 2, -1):
        runs += tier_cli_pair("logreg", "serial", c, CRASH_ITERS, small,
                              name=f"logreg-c{c}")
    tier_crash_check("ck-tier-logreg-c0-capped.npz")
    wal, ck = "wal-tier-threaded", "ck-tier-threaded.npz"
    for stale in (wal, ck):
        remove(os.path.join(OUT, stale))
    run = main_path_run("logreg", "threaded", 2, ITERS,
                        ("--durable-log", wal, "--checkpoint", ck,
                         "--checkpoint_every", "1000000", *small))
    for stale in (wal, ck):
        remove(os.path.join(OUT, stale))
    st = run["tier"]
    print(f"tier threaded -c 2: eval lag {run['eval']['lag_clocks']}, "
          f"rebalances {st['rebalances']}, migrations "
          f"{st['promotions'] + st['demotions']}, iterations/s "
          f"{run['rate']:.1f}")
    if run["eval"]["lag_clocks"] != 0 or not st["rebalances"] \
            or not st["promotions"] + st["demotions"]:
        raise RuntimeError("tier threaded -c 2: the policy thread did not "
                           "race the applies")
    runs.append(run)
    # within one test row: a flipped row moves the weighted F1 of this
    # test set by 1/len(test) +- 3e-8, so the bound has 1e-6 of room
    tol = 1.0 / TEST_ROWS + 1e-6
    split_tier = tier_flags(TIER_PAGE, TIER_HOT, 0)
    shard_tier = tier_flags(TIER_SHARD_PAGE, TIER_SHARD_HOT, TIER_SHARD_WARM)
    topk = ("--compress", "topk:0.01")
    # two deployments at a time (_at_once): their rates are taken under
    # that load
    split_capped, dense = _at_once([
        functools.partial(split_run, "logreg", 2, SPLIT_ITERS,
                          server_flags=split_tier),
        functools.partial(scaleout_run, "shards", "mlp", -1, SCALE_SHORT,
                          durable=True, server_flags=shard_tier)])
    sparse, sparse_plain = _at_once([
        functools.partial(scaleout_run, "shards", "mlp", -1, SCALE_SHORT,
                          topk, durable=True, server_flags=shard_tier),
        functools.partial(scaleout_run, "shards", "mlp", -1, SCALE_SHORT,
                          topk)])
    pairs = [("split", split_capped, twins["split"])]
    print(f"  tier split server: {tier_line(split_capped['server']['tier'])}")
    for flags, capped, plain in (((), dense, twins["shards"]),
                                 (topk, sparse, sparse_plain)):
        for i, st in enumerate(capped["shards"]):
            cold = os.path.join(capped["dir"], "wal", f"shard{i}of2",
                                "param-cold")
            print(f"  tier shard {i}: {tier_line(st['tier'])}; cold "
                  f"partition {os.path.relpath(cold, OUT)} present "
                  f"{os.path.isdir(cold)}")
            if not os.path.isdir(cold) or os.path.exists(os.path.join(
                    capped["dir"], "wal", "param-cold")):
                raise RuntimeError(f"tier shards: shard {i}'s cold pages "
                                   "are not under its own directory")
            lo, hi = st["key_range"]
            if st["tier"]["pages"] != -(-(hi - lo) // TIER_SHARD_PAGE):
                raise RuntimeError(f"tier shards: {st['tier']['pages']} "
                                   "pages a shard")
        if flags and not all(st["sparse_applies"]
                             for st in capped["shards"]):
            raise RuntimeError("tier shards: no tiered sparse apply")
        remove(os.path.join(capped["dir"], "wal"))
        pairs.append(("shards " + " ".join(flags or ("dense",)), capped,
                      plain))
        runs.append(capped)
        if flags:
            runs.append(plain)
    for name, capped, plain in pairs:
        print(f"tier {name}: final F1 {capped['f1']:.6f} capped against "
              f"{plain['f1']:.6f} uncapped (tolerance {tol}); iterations/s "
              f"{capped['rate']:.1f} against {plain['rate']:.1f} (both "
              "under shared load)")
        if abs(capped["f1"] - plain["f1"]) > tol:
            raise RuntimeError(f"tier {name}: F1 off the uncapped twin's")
    runs.append(pairs[0][1])
    remove(os.path.join(OUT, "ck-tier-logreg-c0-capped.npz"))
    return runs


# the analysis planes' flags (--profile, the SLO objectives,
# --model-health), on the telemetry phase's runs and the role serve run
PLANE_FLAGS = ("--profile", "--model-health", "--slo-serving-p99-ms", "50",
               "--slo-freshness-ms", "1000")
# the SLO objectives PLANE_FLAGS arm (availability rides along with any)
SLO_NAMES = ("serving_availability", "serving_latency",
             "snapshot_freshness", "model_health")
# frames of the port's training loops in a /profilez stack
LOOP_FRAMES = ("app.run_serial", "app.run_threaded", "app.worker_loop")


def tel_flags(name: str) -> tuple:
    """Every telemetry flag of cli.run but --device_trace, with file
    names under `name`."""
    return ("--trace", f"{name}-trace.json", "--metrics-file",
            f"{name}.prom", "--metrics-every", "0.5", "--flight-dir",
            f"{name}-flight", "--health-port", "0", "--status_every",
            STATUS_EVERY, *PLANE_FLAGS)


class HealthPoller:
    """Polls a run's health plane from a thread of this script: it reads
    the port from the run's "health plane on port N" line and keeps the
    first /healthz answer (status, JSON) and the flight events recorded
    then; the first /profilez answer whose stacks name a training loop
    of the port (status, the text) and the first /modelz answer with
    resolved updates (status, JSON)."""

    def __init__(self):
        self.answer = self.profilez = self.modelz = None
        self._stop = threading.Event()

    def _done(self) -> bool:
        return None not in (self.answer, self.profilez, self.modelz)

    def __call__(self, err):
        import urllib.error
        import urllib.request
        from kafka_ps_tpu_torch.telemetry import FLIGHT

        def get(port, path):
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}{path}", timeout=5) as r:
                    return r.status, r.read().decode()
            except urllib.error.HTTPError as e:
                return e.code, e.read().decode()

        def poll():
            while not self._stop.is_set() and not self._done():
                m = re.search(r"health plane on port (\d+)", err.getvalue())
                if m:
                    try:
                        if self.answer is None:
                            code, body = get(m.group(1), "/healthz")
                            self.answer = (code, json.loads(body),
                                           FLIGHT.total_events())
                        code, body = get(m.group(1), "/profilez")
                        if self.profilez is None and (code != 200 or any(
                                f in body for f in LOOP_FRAMES)):
                            self.profilez = (code, body)
                        code, body = get(m.group(1), "/modelz")
                        if self.modelz is None and (
                                code != 200 or json.loads(body)["updates"]):
                            self.modelz = (code, json.loads(body))
                    except OSError:
                        pass
                # fast until /healthz answers, then backed off: the
                # poller shares the run's process and its GIL
                time.sleep(0.01 if self.answer is None else 0.1)

        t = threading.Thread(target=poll, daemon=True)
        t.start()

        def done():
            self._stop.set()
            t.join(10)
        return done


def _prom(path: str) -> dict:
    """{family: {labels: value}} of a Prometheus text file."""
    out: dict = {}
    for line in open(path).read().splitlines():
        if line.startswith("#") or not line:
            continue
        key, value = line.rsplit(" ", 1)
        name, _, labels = key.partition("{")
        out.setdefault(name, {})[labels.rstrip("}")] = float(value)
    return out


def _status_iters(stderr: str) -> list[int]:
    return [int(m) for m in re.findall(r"^\[status\] iters=(\d+)", stderr,
                                       re.M)]


def telemetry_checks(name: str, run: dict) -> dict:
    """The files and lines of one run with tel_flags(name): the counting
    rules, rising [status] iters, the exit flight dump; returns the
    metrics and the flight dump."""
    from kafka_ps_tpu_torch.telemetry.flight import DUMP_SCHEMA
    trace = json.load(open(os.path.join(OUT, f"{name}-trace.json")))
    prom = _prom(os.path.join(OUT, f"{name}.prom"))
    (dump_path,) = [os.path.join(OUT, f"{name}-flight", f) for f in
                    os.listdir(os.path.join(OUT, f"{name}-flight"))]
    dump = json.load(open(dump_path))
    spans: dict = {}
    for e in trace["traceEvents"]:
        if e["ph"] == "X":
            spans[e["name"]] = spans.get(e["name"], 0) + 1
    counters = trace["counters"]
    applied = sum(prom["gradients_applied_total"].values())
    iters = run["stats"]["server_iterations"]
    calls = run["single"] + run["gang_calls"]
    status = _status_iters(run["stderr"])
    kinds = {e["kind"] for e in dump["events"]}
    print(f"  telemetry {name}: spans {dict(sorted(spans.items()))}; "
          f"dispatch.device {counters.get('dispatch.device')} (kernel calls "
          f"{calls} + server applies {spans.get('server.apply', 0)}); "
          f"gradients_applied_total {applied:.0f} of {iters} iterations; "
          f"[status] iters {status}; flight dump {os.path.basename(dump_path)}"
          f" ({dump['reason']}, {len(dump['events'])} events, kinds "
          f"{sorted(kinds)}, watchdogs {dump['watchdogs']})")
    if applied != iters or counters.get("server.gradients_applied") != iters:
        raise RuntimeError(f"{name}: {applied} gradients counted for "
                           f"{iters} server iterations")
    # the rule tests/test_torch_trace.py pins against the JAX package: one
    # worker.local_update span and one dispatch.device per kernel call, one
    # dispatch.device per server apply
    if spans.get("worker.local_update") != calls or \
            counters.get("dispatch.device") != calls + spans.get(
                "server.apply", 0):
        raise RuntimeError(f"{name}: spans and dispatch.device off the "
                           f"counting rule ({calls} kernel calls)")
    if not status or status != sorted(status) or status[-1] <= 0:
        raise RuntimeError(f"{name}: [status] iters {status}")
    if dump["schema"] != DUMP_SCHEMA or dump["reason"] != "shutdown" or \
            not {"gate.arrive", "gate.release"} <= kinds:
        raise RuntimeError(f"{name}: flight dump {dump['schema']} "
                           f"{dump['reason']} {sorted(kinds)}")
    plane_checks(name, run, prom, dump)
    return {"prom": prom, "dump": dump, "spans": spans,
            "counters": counters}


def plane_checks(name: str, run: dict, prom: dict, dump: dict) -> None:
    """The analysis planes of one in-process run with PLANE_FLAGS: every
    delta of the in-process fabric observed by reference and resolved by
    the sampler (modelhealth_deferred_total the server iterations, the
    update_norm histogram observed), one slo_burn_rate child per armed
    objective and window, the exit dump's profile, and [status] lines
    with their critpath and modelhealth blocks."""
    iters = run["stats"]["server_iterations"]
    deferred = prom["modelhealth_deferred_total"][""]
    updates = prom["modelhealth_updates_total"][""]
    norms = sum(prom["update_norm_count"].values())
    burn = sorted(prom["slo_burn_rate"])
    want = sorted(f'slo="{s}",window="{w}"' for s in SLO_NAMES
                  for w in ("fast", "slow"))
    status = [ln for ln in run["stderr"].splitlines()
              if ln.startswith("[status] ")]
    blocks = all(" critpath " in ln and " modelhealth " in ln
                 for ln in status)
    print(f"  planes {name}: modelhealth_deferred_total {deferred:.0f} for "
          f"{iters} server iterations, resolved {updates:.0f} (the "
          f"sampler's queue keeps the last 64), update_norm observations "
          f"{norms:.0f}; drift_state {prom['drift_state']['']:.0f}; "
          f"slo_burn_rate children {len(burn)}; exit dump profile "
          f"{len(dump['profile'])} stacks, the hottest "
          f"{dump['profile'][0] if dump['profile'] else None!r}; "
          f"[status] lines with critpath and modelhealth {blocks} "
          f"({status[-1].split(' critpath ', 1)[-1] if status else ''})")
    if deferred != iters or norms < 1 or updates < 1 or burn != want \
            or not dump["profile"] or not status or not blocks:
        raise RuntimeError(f"{name}: the analysis planes' checks")


def poller_checks(name: str, poller: HealthPoller) -> None:
    """The health plane mid-run: /healthz 200 and healthy, /profilez 200
    with samples and a stack of a port training loop, /modelz 200 with
    resolved updates."""
    prof, mz = poller.profilez, poller.modelz
    samples = (re.search(r"^# samples: (\d+)$", prof[1], re.M)
               if prof else None)
    loop = ([ln for ln in prof[1].splitlines()
             if any(f in ln for f in LOOP_FRAMES)][:1] if prof else [])
    print(f"  telemetry {name}: /healthz mid-run {poller.answer}; "
          f"/profilez {prof[0] if prof else None}, samples "
          f"{samples.group(1) if samples else None}, a training loop's "
          f"stack {loop}; /modelz {mz[0] if mz else None}, updates "
          f"{mz[1].get('updates') if mz else None}, drift "
          f"{mz[1].get('drift', {}).get('state') if mz else None}")
    if poller.answer is None or poller.answer[0] != 200 or \
            not poller.answer[1]["healthy"]:
        raise RuntimeError(f"/healthz did not answer 200: {poller.answer}")
    if not prof or prof[0] != 200 or not samples or \
            int(samples.group(1)) < 1 or not loop:
        raise RuntimeError(f"{name}: /profilez {prof and prof[0]}")
    if not mz or mz[0] != 200 or not mz[1]["updates"]:
        raise RuntimeError(f"{name}: /modelz {mz}")


def _theta_sha(path: str) -> str:
    import hashlib
    with np.load(path) as z:
        return hashlib.sha256(z["theta"].tobytes()).hexdigest()


def _bitwise_pair(name: str, on: dict, off: dict) -> None:
    a, b = (_theta_sha(os.path.join(OUT, f"ck-{name}-{arm}.npz"))
            for arm in ("on", "off"))
    rows = _stripped(on) == _stripped(off)
    counts = on["counts"] == off["counts"]
    print(f"  telemetry {name}: theta SHA-256 {a[:16]}.. against "
          f"{b[:16]}.. equal {a == b}; rows (less stamps) equal {rows}; "
          f"kernel counters equal {counts} ({on['counts']})")
    if a != b or not rows or not counts:
        raise RuntimeError(f"{name}: the traced run differs from its "
                           "untraced twin")
    for arm in ("on", "off"):
        remove(os.path.join(OUT, f"ck-{name}-{arm}.npz"))


def sigterm_check() -> None:
    """A threaded cli.run with --flight-dir on the card, killed by
    SIGTERM once two of its [status] lines show rising iterations: the
    process dies by the signal and leaves flightdump-<pid>.json, read
    here."""
    import signal
    from kafka_ps_tpu_torch.telemetry.flight import DUMP_SCHEMA
    d = os.path.join(OUT, "tel-sigterm")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("KPS_PLATFORM", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kafka_ps_tpu_torch.cli.run", "-training",
         os.path.join(OUT, "train.csv"), "-test",
         os.path.join(OUT, "test.csv"), "--num_workers", str(WORKERS),
         "--num_features", str(F), "--num_classes", str(C), "-max",
         str(MAX_BUFFER), "-p", "0", "--mode", "threaded", "-c", "2",
         "--max_iterations", "1000000", "--flight-dir", d,
         "--status_every", "0.5"],
        cwd=d, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    seen: list[int] = []
    try:
        for line in proc.stderr:
            m = re.match(r"\[status\] iters=(\d+)", line)
            if m and int(m.group(1)) > 0:
                seen.append(int(m.group(1)))
            if len(seen) == 2:
                proc.send_signal(signal.SIGTERM)
                break
        proc.wait(timeout=120)
    finally:
        proc.kill()
        proc.stderr.close()
    path = os.path.join(d, f"flightdump-{proc.pid}.json")
    if proc.returncode != -signal.SIGTERM or not os.path.exists(path) \
            or len(seen) != 2 or seen[1] <= seen[0]:
        raise RuntimeError(f"SIGTERM run: rc {proc.returncode}, dump "
                           f"{os.path.exists(path)}, [status] iters {seen}")
    dump = json.load(open(path))
    kinds = {e["kind"] for e in dump["events"]}
    threads = [t for t in dump["threads"] if t.startswith("worker-")]
    print(f"  telemetry sigterm: rc {proc.returncode} after [status] iters "
          f"{seen}; {os.path.basename(path)}: schema {dump['schema']}, "
          f"reason {dump['reason']}, role {dump['role']}, "
          f"{len(dump['events'])} events of kinds {sorted(kinds)}, worker "
          f"threads {threads}, watchdogs {dump['watchdogs']}")
    if dump["schema"] != DUMP_SCHEMA or dump["reason"] != "signal:SIGTERM" \
            or dump["role"] != "run" or "gate" not in dump["watchdogs"] \
            or not {"gate.arrive", "gate.release"} <= kinds \
            or len(threads) != WORKERS:
        raise RuntimeError("SIGTERM run: the flight dump is incomplete")
    shutil.rmtree(d, ignore_errors=True)


def _drift_run(arm: str, csv: str) -> dict:
    """One run of the drift pair: cli.run logreg serial -c 0 --eval_every
    1 --model-health -l, with --metrics-file and --flight-dir, in this
    process, its kernel counters zeroed just before it."""
    from kafka_ps_tpu_torch.cli import run as cli_run
    from kafka_ps_tpu_torch.ops import fused_update
    d = os.path.join(OUT, f"drift-{arm}")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    here = os.getcwd()
    os.chdir(d)
    err = io.StringIO()
    try:
        fused_update.reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err), \
                contextlib.redirect_stdout(io.StringIO()):
            rc = cli_run.main([
                "-training", csv, "-test", os.path.join(OUT, "test.csv"),
                "--num_workers", str(WORKERS), "--num_features", str(F),
                "--num_classes", str(C), "-max", str(DRIFT_BUFFER), "-p",
                "1", "-l", "--mode", "serial", "-c", "0", "--eval_every",
                "1", "--max_iterations", str(DRIFT_ITERS),
                "--model-health", "--metrics-file", "drift.prom",
                "--flight-dir", "flight"])
        wall = time.perf_counter() - t0
        n = fused_update.counts()
        server = _csv_rows("logs-server.csv")
        worker = _csv_rows("logs-worker.csv")
        drift = open("logs-drift.csv").read().splitlines()
        prom = _prom("drift.prom")
        (dump,) = [json.load(open(os.path.join("flight", f)))
                   for f in os.listdir("flight")]
    finally:
        os.chdir(here)
    if rc != 0 or n["launches"] + n["batched_members"] != len(worker) or \
            any(v for k, v in n.items() if k not in (
                "launches", "batched_launches", "batched_members")):
        raise RuntimeError(f"drift {arm}: rc {rc}, {len(worker)} worker "
                           f"rows against kernel counters {n}")
    trips = [e for e in dump["events"] if e["kind"] == "drift.trip"]
    return {"task": "logreg", "kind": "f32", "hidden": H,
            "single": n["launches"], "gang_calls": n["batched_launches"],
            "server": server, "worker": worker, "drift": drift,
            "prom": prom, "trips": trips, "dump": dump, "wall": wall,
            "stderr": err.getvalue()}


def drift_pair_check() -> list[dict]:
    """The drift pair (the JAX package's drift-detection block through
    the CLI, on the card): two runs of _drift_run on CSVs of
    DRIFT_CLEAN + DRIFT_INJECTED rows streamed at -p 1 (the 512-row
    prefill and the rest of the first 1000 rows at once, then 1000 rows a
    second).  Injected: the rows past the clean ones are label-flipped
    (data/synth's label_noise=0.95, another seed) and mean-shifted by
    +1.0; control: the main CSV's clean rows.  The injected run must
    latch DRIFT (drift_trip_total >= 1, a trip row in logs-drift.csv, a
    drift.trip flight record), the control run end STABLE with no trip:
    the card's proof that the plane resolves its deferred deltas and eval
    scalars.  Prints the detection delay in eval rows: from the first
    server eval row at a clock whose worker-0 row saw injected rows to
    the eval row of the trip."""
    from kafka_ps_tpu_torch.data.synth import generate, write_csv
    with open(os.path.join(OUT, "train.csv")) as f:
        head = [next(f) for _ in range(DRIFT_CLEAN + DRIFT_INJECTED + 1)]
    control = os.path.join(OUT, "drift-control.csv")
    with open(control, "w") as f:
        f.writelines(head)
    dx, dy = generate(DRIFT_INJECTED, F, C, seed=37, label_noise=0.95)
    injected = os.path.join(OUT, "drift-injected.csv")
    write_csv(injected, dx + 1.0, dy)
    with open(injected) as f:
        poisoned = f.readlines()[1:]
    with open(injected, "w") as f:
        f.writelines(head[:DRIFT_CLEAN + 1] + poisoned)
    runs = {arm: _drift_run(arm, path) for arm, path in
            (("injected", injected), ("control", control))}
    card = card_line()
    for arm, r in runs.items():
        state = {0: "STABLE", 1: "WARNING", 2: "DRIFT"}[
            int(r["prom"]["drift_state"][""])]
        trip_total = r["prom"]["drift_trip_total"][""]
        rows = [ln for ln in r["drift"][1:] if ln.split(";")[1] == "trip"]
        # worker 0's rows carry numTuplesSeen: the first clock at which
        # its buffer held an injected row, and the server's eval rows
        seen = [(int(w[2]), int(w[6])) for w in r["worker"] if w[1] == "0"]
        first = min((c for c, n in seen if n > DRIFT_CLEAN // WORKERS),
                    default=None)
        clocks = [int(s[2]) for s in r["server"]]
        start = (next((i for i, c in enumerate(clocks) if c >= first),
                      None) if first is not None else None)
        delay = (r["trips"][0]["eval_row"] - 1 - start
                 if r["trips"] and start is not None else None)
        dog = r["dump"]["watchdogs"].get("drift")
        print(f"drift pair {arm}: final state {state}, drift_trip_total "
              f"{trip_total:.0f}, drift_warn_total "
              f"{r['prom']['drift_warn_total']['']:.0f}; logs-drift.csv "
              f"rows {r['drift'][1:]}; drift.trip records {r['trips']}; "
              f"the drift watchdog {dog}; {len(clocks)} eval rows, the "
              f"first at a clock whose worker-0 buffer held a row past "
              f"the first {DRIFT_CLEAN}: {start}; detection delay {delay} "
              f"eval rows; "
              f"modelhealth_deferred_total "
              f"{r['prom']['modelhealth_deferred_total']['']:.0f}, resolved "
              f"{r['prom']['modelhealth_updates_total']['']:.0f}, evals "
              f"{r['prom']['modelhealth_evals_total']['']:.0f}; "
              f"{DRIFT_ITERS} iterations in {r['wall']:.1f} s [{card}]")
        if arm == "injected" and (state != "DRIFT" or trip_total < 1
                                  or not rows or not r["trips"]):
            raise RuntimeError("drift pair: the injected run did not trip")
        if arm == "control" and (state != "STABLE" or trip_total
                                 or rows or r["trips"]):
            raise RuntimeError("drift pair: the control run tripped")
        if not r["prom"]["modelhealth_updates_total"][""] or \
                r["prom"]["modelhealth_evals_total"][""] != len(clocks):
            raise RuntimeError(f"drift pair {arm}: deltas or evals "
                               "unresolved")
    for path in (injected, control):
        remove(path)
    return list(runs.values())


def modelhealth_poll_cost(dev) -> None:
    """The model-health sampler's largest poll at the fused MLP's width:
    its queue's cap of deferred deltas (64) at H=4096 (4,222,982 floats
    each, 1.08 GB on the card) observed, then resolved by one poll() —
    64 copies to the host and the numpy diagnostics of each — on the host
    clock; the 64 copies alone beside it."""
    from argparse import Namespace
    from kafka_ps_tpu_torch.models import mlp
    from kafka_ps_tpu_torch.telemetry import Telemetry
    from kafka_ps_tpu_torch.telemetry.modelhealth import (_PENDING_DELTAS,
                                                          plane_from_args)
    from kafka_ps_tpu_torch.utils.config import ModelConfig
    n = mlp.num_params(ModelConfig(num_features=F, num_classes=C,
                                   hidden_dim=WIDE_H))
    gen = torch.Generator(device=dev).manual_seed(3)
    deltas = [torch.randn(n, device=dev, generator=gen) * 0.01
              for _ in range(_PENDING_DELTAS)]
    plane = plane_from_args(Namespace(model_health=True,
                                      drift_detector="ph",
                                      drift_threshold=None), Telemetry())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, d in enumerate(deltas):
        plane.observe_update(i % WORKERS, d)
    observe_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    polled = plane.poll()
    poll_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    hosts = [d.to("cpu") for d in deltas]
    copy_ms = (time.perf_counter() - t0) * 1e3
    nbytes = 4 * n * len(deltas)
    print(f"model health at H={WIDE_H}: {len(deltas)} deferred deltas of "
          f"{n} floats ({nbytes / 1e9:.3f} GB on the card) observed in "
          f"{observe_ms:.3f} ms; one poll resolved {polled['resolved_deltas']}"
          f" in {poll_ms:.1f} ms; the {len(deltas)} device-to-host copies "
          f"alone {copy_ms:.1f} ms ({nbytes / copy_ms / 1e6:.2f} GB/s) "
          f"[{card_line()}]")
    if polled["resolved_deltas"] != len(deltas) or \
            plane.updates != len(deltas):
        raise RuntimeError("model health: the deferred deltas unresolved")
    del deltas, hosts
    torch.cuda.empty_cache()


def device_trace_check(task: str, symbols: tuple) -> dict:
    """cli.run --device_trace DIR (serial -c 0, TEL_TRACE_ITERS): the
    trace holds CUDA kernel events of the hand kernels' symbols (presence
    only: torch.profiler loses events now and then)."""
    from kafka_ps_tpu_torch.utils.trace import device_trace_path, kernel_names
    d = os.path.join(OUT, f"tel-dtrace-{task}")
    shutil.rmtree(d, ignore_errors=True)
    run = main_path_run(task, "serial", 0, TEL_TRACE_ITERS,
                        ("--device_trace", f"tel-dtrace-{task}"))
    path = device_trace_path(d)
    names = kernel_names(path)
    found = {s: sorted(n for n in names if s in n)[:2] for s in symbols}
    print(f"  telemetry device trace {task}: {os.path.basename(path)} "
          f"{os.path.getsize(path)} bytes, {len(names)} kernel names; "
          f"hand kernels {found}")
    if not all(found.values()):
        raise RuntimeError(f"device trace {task}: no event of {symbols}")
    shutil.rmtree(d, ignore_errors=True)
    return run


def telemetry_phase() -> list[dict]:
    """cli.run with the telemetry flags on the card: logreg serial -c 0
    (TEL_ITERS, 512-row CSV) and --fused --eval_every 10 with --trace,
    each bitwise its untraced twin with the same kernel counters; threaded
    -c 2 on the whole CSV (eval lag 0, one clock_lag observation per
    gradient, the gate watchdog quiet); /healthz answered mid-run; the
    overhead of telemetry as iterations/s on over off; --device_trace
    runs; a SIGTERM dump."""
    with open(os.path.join(OUT, "train.csv")) as f:
        head = [next(f) for _ in range(SERVE_TRAIN_ROWS + 1)]
    with open(os.path.join(OUT, "tel-train.csv"), "w") as f:
        f.writelines(head)
    ck = ("--checkpoint_every", "1000000")
    for name in os.listdir(OUT):
        if name.startswith("tel-") and not name.endswith(".csv"):
            shutil.rmtree(os.path.join(OUT, name), ignore_errors=True)
    runs = []
    # 1. serial -c 0 with every flag, beside its untraced twin
    off = main_path_run("logreg", "serial", 0, TEL_ITERS,
                        ("--checkpoint", "ck-tel-serial-off.npz", *ck),
                        train="tel-train.csv")
    poller = HealthPoller()
    on = main_path_run("logreg", "serial", 0, TEL_ITERS,
                       ("--checkpoint", "ck-tel-serial-on.npz", *ck,
                        *tel_flags("tel-serial")),
                       train="tel-train.csv", watch=poller)
    runs += [off, on]
    _bitwise_pair("tel-serial", on, off)
    telemetry_checks("tel-serial", on)
    poller_checks("tel-serial", poller)
    # 2. threaded -c 2, beside its untraced twin
    t_off = main_path_run("logreg", "threaded", 2, TEL_ITERS)
    poller = HealthPoller()
    t_on = main_path_run("logreg", "threaded", 2, TEL_ITERS,
                         tel_flags("tel-threaded"), watch=poller)
    runs += [t_off, t_on]
    got = telemetry_checks("tel-threaded", t_on)
    poller_checks("tel-threaded", poller)
    lag_n = got["prom"]["clock_lag_count"]['model="bounded"']
    gate = got["dump"]["watchdogs"]["gate"]
    print(f"  telemetry tel-threaded: final eval lag "
          f"{t_on['eval']['lag_clocks']}; clock_lag observations {lag_n:.0f}"
          f" for {t_on['stats']['server_iterations']} gradients; gate "
          f"watchdog {gate}")
    if lag_n != t_on["stats"]["server_iterations"] or gate["trip_count"]:
        raise RuntimeError("tel-threaded: clock_lag observations or the "
                           "gate watchdog")
    # 2b. the drift pair, and the model-health sampler's largest poll
    runs += drift_pair_check()
    modelhealth_poll_cost(torch.device("cuda"))
    # 3. --fused --eval_every 10 with --trace, beside its untraced twin
    fused = ("--fused", "--eval_every", "10")
    f_off = main_path_run("logreg", "serial", 0, TEL_ITERS,
                          (*fused, "--checkpoint", "ck-tel-fused-off.npz",
                           *ck), train="tel-train.csv")
    f_on = main_path_run("logreg", "serial", 0, TEL_ITERS,
                         (*fused, "--checkpoint", "ck-tel-fused-on.npz",
                          *ck, "--trace", "tel-fused-trace.json"),
                         train="tel-train.csv")
    runs += [f_off, f_on]
    _bitwise_pair("tel-fused", f_on, f_off)
    trace = json.load(open(os.path.join(OUT, "tel-fused-trace.json")))
    steps = sum(1 for e in trace["traceEvents"]
                if e["ph"] == "X" and e["name"] == "bsp.step")
    fs = f_on["stats"]["fused"]
    dispatches = fs["chunks"] + fs["rounds"] - fs["chunk_rounds"]
    print(f"  telemetry tel-fused: bsp.step spans {steps}, dispatches "
          f"{dispatches} ({fs['chunks']} chunks, "
          f"{fs['rounds'] - fs['chunk_rounds']} single rounds); "
          f"iterations/s {f_on['rate']:.1f} traced against "
          f"{f_off['rate']:.1f}")
    if steps != dispatches:
        raise RuntimeError("tel-fused: bsp.step spans off the dispatches")
    # 4. --device_trace on each family
    runs.append(device_trace_check("logreg", ("logreg_update",)))
    runs.append(device_trace_check("mlp", ("hidden_pass", "update_pass")))
    # 5. SIGTERM
    sigterm_check()
    # 6. the overhead of telemetry
    # iterations/s runs to the CLI's return, so it holds the teardown too
    # (the health server's shutdown waits up to its 0.5 s poll, the trace
    # and metrics are written); worker rows/s on their host submit stamps
    # is the drive loop alone
    card = card_line()
    for name, a, b in (("serial -c 0", on, off),
                       ("threaded -c 2", t_on, t_off)):
        print(f"telemetry overhead, logreg {name}: iterations/s "
              f"{a['rate']:.1f} with every flag against {b['rate']:.1f} "
              f"without ({a['rate'] / b['rate']:.3f}x); worker rows/s on "
              f"host submit stamps {a['submit_rate']:.1f} against "
              f"{b['submit_rate']:.1f} "
              f"({a['submit_rate'] / b['submit_rate']:.3f}x) [{card}]")
    remove(os.path.join(OUT, "tel-train.csv"))
    return runs


# -- the role telemetry phase (cli/socket_mode.py's telemetry flags) ---------

def role_tel_flags() -> tuple:
    """The role runners' telemetry flags (tests/torch_role_runs.py): each
    process writes trace.json, metrics.prom and flight/ in its own
    directory and serves /healthz on a port it announces."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_role_runs import TEL_FLAGS
    return TEL_FLAGS


def role_health(errs):
    """/healthz of the processes whose stderr files are `errs`, polled
    while they run (tests/torch_role_runs.HealthFiles)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_role_runs import HealthFiles
    return HealthFiles(errs)


def check_health(name: str, health) -> dict:
    """Every process of `health` answered, always 200 and healthy:
    {stderr file: its last answer}."""
    for e, got in health.answers.items():
        if not got or any(code != 200 or not j["healthy"]
                          for code, j in got):
            raise RuntimeError(f"{name}: /healthz of {e}: "
                               f"{got[-3:] if got else 'no answer'}")
    return {e: got[-1][1] for e, got in health.answers.items()}


def _watch(base: str, names, holder: list):
    """Poll the /healthz of the processes `names` of a run under `base`
    (role_health, kept in `holder`); returns its finish."""
    health = role_health([os.path.join(base, n, "err.txt") for n in names])
    holder.append(health)
    return health.finish


def role_files(name: str, d: str, exit_reason: str = "shutdown") -> dict:
    """One role process's telemetry files: its trace (wall-clock anchored,
    events present), metrics file and flight dumps (the last with
    `exit_reason`, holding records of the socket bridges).  A process
    ended by a signal writes its dump from the signal's hook and no trace,
    as in the JAX package (its "trace" is then None)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_role_runs import event_kinds, prom_values
    from kafka_ps_tpu_torch.telemetry.flight import DUMP_SCHEMA
    trace = None
    if not exit_reason.startswith("signal:"):
        trace = json.load(open(os.path.join(d, "trace.json")))
        if "wallClockT0" not in trace or not trace["traceEvents"]:
            raise RuntimeError(f"{name}: an empty trace")
    prom = prom_values(os.path.join(d, "metrics.prom"))
    dumps = [json.load(open(os.path.join(d, "flight", f)))
             for f in sorted(os.listdir(os.path.join(d, "flight")))]
    kinds = event_kinds(dumps)
    if (not dumps or dumps[-1]["schema"] != DUMP_SCHEMA
            or dumps[-1]["reason"] != exit_reason
            or not any(k.startswith("net.") for k in kinds)):
        raise RuntimeError(f"{name}: flight dumps "
                           f"{[x['reason'] for x in dumps]}, kinds "
                           f"{sorted(kinds)}")
    return {"trace": trace, "prom": prom, "dumps": dumps, "kinds": kinds}


def traced_bridge_check(dev) -> None:
    """The bridge round on the card (tests/torch_split_round.py) with a
    tracer and a registry on both sides, against the same round without:
    trace context negotiated, every gradients and weights frame 16 bytes
    longer, and the gradients and theta bitwise."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_split_round import bridge_round
    from kafka_ps_tpu_torch.telemetry import Telemetry
    from kafka_ps_tpu_torch.utils.trace import Tracer

    def obs(role):
        tracer = Tracer()
        return tracer, Telemetry(tracer=tracer)

    for task, slab in (("logreg", "f32"), ("mlp", "f32"),
                       ("logreg", "int8"), ("mlp", "bf16")):
        kw = dict(features=F, classes=C, hidden=H, workers=WORKERS,
                  rows=256, slab=slab)
        plain, traced = {}, {}
        (_, ref_theta), (grads, theta) = bridge_round(dev, task, info=plain,
                                                      **kw)
        (_, ref2), (tgrads, ttheta) = bridge_round(dev, task, obs=obs,
                                                   info=traced, **kw)
        same = (torch.equal(theta, ttheta) and torch.equal(ref_theta, ref2)
                and torch.equal(ref_theta, ttheta)
                and all(torch.equal(a.values, b.values)
                        for a, b in zip(grads, tgrads)))
        suffix = []
        for side, topic in (("worker_wire", "gradients"),
                            ("server_wire", "weights")):
            a, b = plain[side][topic], traced[side][topic]
            suffix.append(a["frames_out"] == b["frames_out"] > 0 and
                          b["bytes_out"] - a["bytes_out"]
                          == 16 * b["frames_out"])
        print(f"role telemetry: traced bridge round ({task}, {slab} slab, "
              f"{WORKERS} workers, F={F}) bitwise the untraced: {same}; "
              f"trace negotiated {traced['trace_negotiated']} (untraced "
              f"{plain['trace_negotiated']}); gradients and weights frames "
              f"16 bytes longer: {all(suffix)}")
        if not same or not all(suffix) or not traced["trace_negotiated"] \
                or plain["trace_negotiated"]:
            raise RuntimeError(f"traced bridge round {task} {slab}")


def _flows(trace: dict, ph: str) -> set:
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_role_runs import flow_ids
    return set(flow_ids(trace, "delta.wire", ph))


def _gradient_frames(name: str, server: dict, sprom: dict,
                     wproms: list) -> tuple[float, float]:
    """The server's gradients frames read are its iterations plus what it
    dropped or left queued at the stop; the workers sent at least that."""
    got = sprom["frames_received"]['topic="gradients"']
    members = server["membership"]
    applied = (server["server_iterations"] + server["gradients_pending"]
               + members["zombie_gradients_dropped"]
               + members["duplicate_gradients_dropped"])
    sent = sum(p["frames_sent"]['topic="gradients"'] for p in wproms)
    print(f"  {name}: gradients frames sent by the workers {sent:.0f}, "
          f"read by the server {got:.0f} = {server['server_iterations']} "
          f"applied + {server['gradients_pending']} queued at the stop + "
          f"{members['zombie_gradients_dropped']} zombie + "
          f"{members['duplicate_gradients_dropped']} duplicate drops")
    if got != applied or sent < got:
        raise RuntimeError(f"{name}: gradients frames {sent} sent, {got} "
                           f"read, {applied} accounted for")
    return sent, got


def _status_lines(name: str, err: str) -> list[int]:
    """The [status] iters of a server's stderr file: at least one line,
    rising, the last past iteration 0."""
    status = _status_iters(open(err).read())
    if not status or status != sorted(status) or status[-1] <= 0:
        raise RuntimeError(f"{name}: [status] iters {status}")
    return status


def role_split_check() -> list[dict]:
    """server_runner --listen with two worker_runner processes, logreg
    -c 2 (ROLE_PAIR_ITERS), four times back to back and alone on the
    card: untraced, traced, traced, untraced (traced: every process with
    the telemetry flags, the server --status_every too).  The first
    traced run is checked: the gradients frames accounted for, every
    worker's delta.wire flow stepped at the server but for frames in
    flight at its stop, /healthz 200 while they run, exit dumps with
    net.* records, rising [status] lines; F1 in (0.5, 1] and eval lag 0
    (split_run).  Prints iterations/s traced over untraced, each pair's
    and their median."""
    holder: list = []
    names = ("server", "w0", "w1")
    first = split_run("logreg", 2, ROLE_PAIR_ITERS)
    traced = split_run("logreg", 2, ROLE_PAIR_ITERS, tel=True,
                       during=lambda port, err: _watch(
                           os.path.dirname(os.path.dirname(err)), names,
                           holder))
    check_health("role split", holder[0])
    d = traced["dirs"]
    files = {n: role_files(f"role split {n}", d[n]) for n in names}
    sent, got = _gradient_frames(
        "role split", traced["server"], files["server"]["prom"],
        [files["w0"]["prom"], files["w1"]["prom"]])
    starts = _flows(files["w0"]["trace"], "s") | _flows(files["w1"]["trace"],
                                                        "s")
    steps = _flows(files["server"]["trace"], "t")
    status = _status_lines("role split", os.path.join(d["server"],
                                                      "err.txt"))
    print(f"  role split: delta.wire flows started by the workers "
          f"{len(starts)}, stepped at the server {len(starts & steps)}; "
          f"[status] iters {status[0]}..{status[-1]} over {len(status)} "
          f"lines; exit dumps' kinds {sorted(files['server']['kinds'])}")
    if len(starts) != sent or len(starts - steps) > sent - got:
        raise RuntimeError("role split: delta.wire flows lost")
    telemetry_tools_check("role split", d)
    again = split_run("logreg", 2, ROLE_PAIR_ITERS, tel=True)
    last = split_run("logreg", 2, ROLE_PAIR_ITERS)
    pairs = ((traced, first), (again, last))
    for key, what in (("rate", "iterations/s from the first worker row"),
                      ("steady", "worker iterations/s past the first "
                                 "round")):
        ratios = [on[key] / off[key] for on, off in pairs]
        print(f"role telemetry split logreg -c 2 ({ROLE_PAIR_ITERS} "
              f"iterations, untraced, traced, traced, untraced): {what} "
              f"with every flag on every process "
              f"{', '.join(f'{on[key]:.1f}' for on, _ in pairs)} against "
              f"{', '.join(f'{off[key]:.1f}' for _, off in pairs)} "
              f"untraced; traced over untraced "
              f"{', '.join(f'{r:.3f}' for r in ratios)}x, median "
              f"{statistics.median(ratios):.3f}x [{card_line()}]")
    return [first, traced, again, last]


def telemetry_tools_check(name: str, dirs: dict) -> None:
    """`python -m kafka_ps_tpu_torch.telemetry` on a traced deployment's
    files (`dirs`: process name -> its directory): merge of the
    processes' traces (exit 0, cross-process flows), critpath of the
    merged trace (exit 0, the wire segment named), and postmortem of
    their flight dumps gathered in one directory (exit 0, what the JAX
    tool gives on a directory of readable dumps, every process named and
    no dead shard)."""
    base = os.path.dirname(next(iter(dirs.values())))
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("KPS_PLATFORM", None)

    def tool(*args):
        p = subprocess.run([sys.executable, "-m",
                            "kafka_ps_tpu_torch.telemetry", *args],
                           cwd=base, env=env, capture_output=True,
                           text=True, timeout=300)
        return p.returncode, p.stdout.strip()
    merged = os.path.join(base, "merged.json")
    traces = [os.path.join(d, "trace.json") for d in dirs.values()]
    m_rc, m_out = tool("merge", "-o", merged, *traces)
    c_rc, c_out = tool("critpath", merged)
    dumps = os.path.join(base, "dumps")
    os.makedirs(dumps, exist_ok=True)
    for n, d in dirs.items():
        for f in os.listdir(os.path.join(d, "flight")):
            shutil.copy(os.path.join(d, "flight", f),
                        os.path.join(dumps, f))
    p_rc, p_out = tool("postmortem", dumps)
    models = [ln for ln in c_out.splitlines() if ln.startswith("model=")]
    wire = [ln.strip() for ln in c_out.splitlines()
            if "segment=wire" in ln]
    print(f"  {name}: telemetry merge rc {m_rc}: {m_out}; critpath rc "
          f"{c_rc}: {models} {wire}; postmortem rc {p_rc}: "
          f"{p_out.splitlines()[:2]}")
    flows = re.search(r"(\d+) cross-process flows", m_out)
    if m_rc or not flows or not int(flows.group(1)) or c_rc or not wire \
            or p_rc or f"{len(dirs)} dump(s)" not in p_out \
            or re.search(r"^dead shard", p_out, re.M):
        raise RuntimeError(f"{name}: the port's telemetry tools")


def role_shard_kill_check() -> dict:
    """--shards 2 --slab-dtype int8 -c 2 with two sharded worker
    processes, every process with the telemetry flags: shard 1 killed by
    SIGKILL after its first checkpoint (it writes no dump: that absence
    is what names it dead), shard 0 stopped by SIGTERM a second later
    (its dump says so), the workers ending when both shards are gone.  The
    workers' exit dumps hold the shard.weights records of both shards;
    the postmortem's rule (dead = shards known from the dumps less those
    that dumped; last ack = the newest shard.weights record of a dead
    shard) names shard 1 and its last acknowledged (worker, clock); every
    family of shard 0's server node carries its shard label."""
    import signal
    base = os.path.join(OUT, "role-shards-kill")
    remove(base)
    names = ("s0", "s1", "w0", "w1")
    dirs = {n: os.path.join(base, n) for n in names}
    for p in dirs.values():
        os.makedirs(p)
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("KPS_PLATFORM", None)
    common = ["-test", "../../test.csv", "--num_workers", str(WORKERS),
              "--num_features", str(F), "--num_classes", str(C), "-l",
              "--slab-dtype", "int8", *role_tel_flags()]
    ports = [_free_port(), _free_port()]
    mod = [sys.executable, "-m"]
    cmds = {f"s{i}": mod + [
        "kafka_ps_tpu_torch.cli.server_runner", "--listen", str(ports[i]),
        "--shards", "2", "--shard-id", str(i), "-training",
        "../../train.csv", "-p", "0", "-c", "2", "--max_iterations",
        "1000000", "--checkpoint", "job.npz", "--checkpoint_every",
        str(ROLE_CK_EVERY), *common] for i in (0, 1)}
    for i in (0, 1):
        cmds[f"w{i}"] = mod + [
            "kafka_ps_tpu_torch.cli.worker_runner", "--connect",
            ",".join(f"127.0.0.1:{p}" for p in ports), "--worker_ids",
            SPLIT_IDS[i], "-max", str(MAX_BUFFER), *common]
    procs = {n: subprocess.Popen(
        cmds[n], cwd=dirs[n], env=env,
        stdout=open(os.path.join(dirs[n], "out.txt"), "w"),
        stderr=open(os.path.join(dirs[n], "err.txt"), "w")) for n in names}
    holder: list = []
    health = _watch(base, names, holder)
    try:
        ck = os.path.join(dirs["s1"], "job.npz.shard1of2.npz")
        deadline = time.monotonic() + 240.0
        while not os.path.exists(ck):
            for n, p in procs.items():
                if p.poll() is not None:
                    raise RuntimeError(f"role shards: {n} exited "
                                       f"({p.returncode}) before the kill")
            if time.monotonic() > deadline:
                raise RuntimeError("role shards: no shard 1 checkpoint")
            time.sleep(0.05)
        procs["s1"].send_signal(signal.SIGKILL)
        procs["s1"].wait(timeout=60)
        time.sleep(1.0)
        procs["s0"].send_signal(signal.SIGTERM)
        for p in procs.values():
            p.wait(timeout=120)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        health()
    rcs = {n: p.returncode for n, p in procs.items()}
    if rcs != {"s0": -signal.SIGTERM, "s1": -signal.SIGKILL, "w0": 0,
               "w1": 0}:
        tails = {n: open(os.path.join(d, "err.txt")).read()[-2000:]
                 for n, d in dirs.items()}
        raise RuntimeError(f"role shards: exit codes {rcs}:\n{tails}")
    for n in ("s0", "w0", "w1"):
        if not holder[0].answers[os.path.join(dirs[n], "err.txt")]:
            raise RuntimeError(f"role shards: {n} never answered /healthz")
    s0 = role_files("role shards s0", dirs["s0"], "signal:SIGTERM")
    workers = [role_files(f"role shards w{i}", dirs[f"w{i}"])
               for i in (0, 1)]
    killed = os.path.join(dirs["s1"], "flight")
    if os.path.isdir(killed) and os.listdir(killed):
        raise RuntimeError("role shards: the killed shard wrote a dump")
    dumps = s0["dumps"] + workers[0]["dumps"] + workers[1]["dumps"]
    known, present, acks = set(), set(), {}
    for dump in dumps:
        if dump["role"] == "server" and dump["shard"] is not None:
            known.add(dump["shard"])
            present.add(dump["shard"])
        known.update(dump.get("meta", {}).get("shards", []))
        for e in dump["events"]:
            if e["kind"] == "shard.weights":
                best = acks.get(e["shard"])
                if best is None or (e["clock"], e["t"]) > (best["clock"],
                                                           best["t"]):
                    acks[e["shard"]] = e
    dead = sorted(known - present)
    last = acks.get(1)
    print(f"  role shards: exit codes {rcs}; dumps of s0 "
          f"({s0['dumps'][-1]['reason']}) and the workers; shards with "
          f"shard.weights records {sorted(acks)}; dead shards {dead}; the "
          f"last ack from shard 1: weights for worker "
          f"{last and last['worker']} at clock {last and last['clock']}")
    if dead != [1] or sorted(acks) != [0, 1]:
        raise RuntimeError(f"role shards: dead {dead}, acks {sorted(acks)}")
    node = [labels for name, samples in s0["prom"].items()
            if name.startswith(("gate_wait_ms", "clock_lag", "worker_lag",
                                "gradients_applied_total"))
            for labels in samples]
    if not node or any('shard="0"' not in labels for labels in node):
        raise RuntimeError(f"role shards: unlabelled families {node}")
    calls = []
    for i in (0, 1):
        st = _role_stats(os.path.join(dirs[f"w{i}"], "err.txt"), "worker")
        n = st["kernels"]
        own = len(_csv_rows(os.path.join(dirs[f"w{i}"], "logs-worker.csv")))
        others = {k: v for k, v in n.items() if k != "stream_launches" and v}
        if n["stream_launches"] != own or others \
                or not st["device"].startswith("cuda"):
            raise RuntimeError(f"role shards: worker {i} kernels {n} for "
                               f"{own} rows on {st['device']}")
        calls.append(own)
    print(f"  role shards: K3 int8 calls {calls} (= the workers' CSV rows); "
          f"shard 0's node families labelled shard=\"0\" ({len(node)} "
          "samples)")
    for i in (0, 1):
        remove(os.path.join(dirs[f"s{i}"], f"job.npz.shard{i}of2.npz"))
    return {"task": "logreg", "kind": "int8", "single": sum(calls),
            "gang_calls": 0, "hidden": H, "fused": False,
            "topology": "shards", "c": 2, "flags": ("--slab-dtype", "int8"),
            "server_flags": (), "kill": True}


def role_relay_check() -> dict:
    """agg_runner between server_runner --listen and two --aggregate
    worker processes, the MLP with bf16 slabs at -c -1 (the scale-out
    phase's relay of these flags, run here once with the telemetry flags
    on every process): agg_composites_total and the agg_fan_in
    observations are the relay's composites, and the workers' delta.wire
    flows step through the relay."""
    holder: list = []
    names = ("server", "relay", "w0", "w1")
    run = scaleout_run("relay", "mlp", -1, ROLE_ITERS, ("--slab-dtype",
                                                        "bf16"),
                       tel=True,
                       during=lambda wal: _watch(os.path.dirname(wal),
                                                 names, holder))
    check_health("role relay", holder[0])
    d = run["dirs"]
    files = {n: role_files(f"role relay {n}", d[n]) for n in names}
    relay, prom = run["relay"], files["relay"]["prom"]
    comp = prom["agg_composites_total"]['mode="stacked"']
    fan_n = prom["agg_fan_in_count"][""]
    starts = _flows(files["w0"]["trace"], "s") | _flows(files["w1"]["trace"],
                                                        "s")
    hop = [e for e in files["relay"]["trace"]["traceEvents"]
           if e.get("name") == "delta.wire" and e.get("ph") == "t"
           and "agg" in e.get("args", {})]
    through = {e["id"] for e in hop} & starts
    upstream = _flows(files["relay"]["trace"], "s") & _flows(
        files["server"]["trace"], "t")
    print(f"  role relay: agg_composites_total {comp:.0f}, agg_fan_in "
          f"observations {fan_n:.0f} over {prom['agg_fan_in_sum']['']:.0f} "
          f"members, the relay's stats {relay['composites']} composites of "
          f"{relay['members']}; member flows stepped through the relay "
          f"{len(through)} of {len(starts)}; composite flows stepped at the "
          f"server {len(upstream)}")
    if comp != relay["composites"] or fan_n != relay["composites"] \
            or not through or not upstream:
        raise RuntimeError("role relay: agg families or flows")
    return run


def role_serve_check() -> dict:
    """server_runner --listen --serve --serve-shm with two worker
    processes, the MLP at -c -1, under closed loads of two PredictClients
    by socket and two by shared memory (the serving phase's checks:
    every answer's status and clocks, each client on its transport, shm
    predictions counted, no engine error), every process with the
    telemetry flags: serving_requests_total and serving_dispatch_mode
    {mode="shm"} agree with the engine's and the bridge's counts, the
    serving watchdog is armed and quiet, and a delta.wire flow ends at a
    serving read in the server's trace."""
    holder: list = []
    names = ("server", "w0", "w1")
    loads: list = []

    def during(port, err):
        ready = _file_has(err, "serving predictions on port")
        loads.extend([ServeLoad(port, 2, ready=ready),
                      ServeLoad(port, 2, shm=True, ready=ready)])
        done = _watch(os.path.dirname(os.path.dirname(err)), names, holder)

        def finish():
            loads.extend([ld.finish() for ld in loads[:2]])
            done()
        return finish

    run = split_run("mlp", -1, ROLE_ITERS, flags=("--model-health",),
                    server_flags=("--serve", "--serve-shm", "--profile",
                                  "--slo-serving-p99-ms", "50",
                                  "--slo-freshness-ms", "1000"),
                    tel=True, during=during)
    server = run["server"]
    st = server["serving"]
    for name, got, shm in (("split --listen --serve (socket)", loads[2],
                            False),
                           ("split --listen --serve (shm)", loads[3], True)):
        serve_report(name, got, st, st["stable_clock"])
        check_answers(name, got)
        if any(a != shm for a in got["shm_active"]):
            raise RuntimeError(f"serving {name}: shm active "
                               f"{got['shm_active']}")
    print(f"serving split: the server answered {st['requests']} requests, "
          f"{server['shm_predictions']} over shared memory; errors "
          f"{st['errors']}")
    if (not server["shm_predictions"] or st["errors"]
            or not server["device"].startswith("cuda")):
        raise RuntimeError(f"serving split: shm predictions "
                           f"{server['shm_predictions']}, errors "
                           f"{st['errors']}, server on {server['device']}")
    answers = check_health("role serve", holder[0])
    d = run["dirs"]
    files = {n: role_files(f"role serve {n}", d[n]) for n in names}
    prom = files["server"]["prom"]
    req = prom["serving_requests_total"][""]
    shm = prom["serving_dispatch_mode"]['mode="shm"']
    dog = answers[os.path.join(d["server"], "err.txt")]["watchdogs"].get(
        "serving")
    ends = _flows(files["server"]["trace"], "f")
    print(f"  role serve: serving_requests_total {req:.0f} (engine "
          f"{st['requests']}), serving_dispatch_mode{{mode=\"shm\"}} "
          f"{shm:.0f} (bridge {server['shm_predictions']}); serving "
          f"watchdog {dog}; delta.wire flows ended at a serving read "
          f"{len(ends)}")
    if req != st["requests"] or shm != server["shm_predictions"] \
            or not shm or dog is None or dog["tripped"] \
            or dog["trip_count"] or not ends:
        raise RuntimeError("role serve: serving families, watchdog or flows")
    # the analysis planes on the server: every delta off the socket
    # computed inline on the host array its frame was decoded from
    updates = prom["modelhealth_updates_total"][""]
    deferred = prom["modelhealth_deferred_total"][""]
    iters = server["server_iterations"]
    burn = sorted(k for k in prom["slo_burn_rate"]
                  if 'slo="serving_latency"' in k)
    status = [ln for ln in open(os.path.join(d["server"], "err.txt"))
              if ln.startswith("[status] ")]
    crit = [ln.split(" critpath ", 1)[1].split(" modelhealth ")[0]
            for ln in status if " critpath " in ln]
    wevals = [files[w]["prom"]["modelhealth_evals_total"][""]
              for w in ("w0", "w1")]
    print(f"  role serve: modelhealth_updates_total {updates:.0f} for "
          f"{iters} gradients applied, modelhealth_deferred_total "
          f"{deferred:.0f}; slo_burn_rate {burn}; [status] lines with "
          f"critpath {len(crit)} of {len(status)} (the last: "
          f"{crit[-1] if crit else None}); the workers' "
          f"modelhealth_evals_total {wevals}; the server's exit dump "
          f"profile {len(files['server']['dumps'][-1]['profile'])} stacks")
    if updates != iters or deferred or not burn or not status \
            or len(crit) != len(status) or not all(wevals) \
            or not files["server"]["dumps"][-1]["profile"]:
        raise RuntimeError("role serve: the analysis planes' counts")
    return run


def role_tier_replica_check() -> dict:
    """--shards 2 --durable-log with per-shard hot and warm caps, logreg
    -c 0 (the shards end at one clock, so the logs' newest weights are one
    cut), every process with the telemetry flags, and a --serve-replica
    following its logs from the start (with the flags too; the serving
    phase's replica of a --shards 2 deployment, run here):
    param_tier_pins_total and param_tier_migrations_total agree with each
    shard's store counters and its dump holds store.* records; the
    replica records replica.publish per publication, its replica and
    serving watchdogs are armed and quiet, and its last snapshot is
    bitwise the logs' newest weights (_end_replica)."""
    holder: list = []
    names = ("s0", "s1", "w0", "w1")
    replica: dict = {}

    def during(wal):
        base = os.path.dirname(wal)
        rdir = os.path.join(base, "replica")
        os.makedirs(rdir)
        err = os.path.join(rdir, "err.txt")
        proc, port = _replica(wal, err, cwd=rdir, flags=role_tel_flags())
        load = ServeLoad(port, 2, ready=_file_has(err, "replica serving"))
        rhealth = role_health([err])
        done = _watch(base, names, holder)

        def finish():
            _end_replica("replica of the capped --shards 2", proc, err,
                         load, wal)
            rhealth.finish()
            done()
            replica.update(dir=rdir, err=err, health=rhealth)
        return finish

    run = scaleout_run("shards", "logreg", 0, ROLE_ITERS, durable=True,
                       server_flags=tier_flags(TIER_PAGE, TIER_HOT,
                                               TIER_WARM),
                       tel=True, during=during)
    check_health("role tier", holder[0])
    d = run["dirs"]
    for i in (0, 1):
        files = role_files(f"role tier s{i}", d[f"s{i}"])
        tier = run["shards"][i]["tier"]
        prom = files["prom"]
        pins = sum(prom["param_tier_pins_total"].values())
        mig = prom["param_tier_migrations_total"]
        up = mig.get('direction="promote"', 0)
        down = mig.get('direction="demote"', 0)
        store = sorted(k for k in files["kinds"] if k.startswith("store."))
        # a demand fault lost to a racing write is a promotion attempted
        # (the family, as in the JAX store) but not made (the counter)
        print(f"  role tier s{i}: param_tier_pins_total {pins:.0f} (store "
              f"{sum(tier['pins'].values())}), migrations promote "
              f"{up:.0f} / demote {down:.0f} (store {tier['promotions']} / "
              f"{tier['demotions']}); records {store}")
        if pins != sum(tier["pins"].values()) or down != tier["demotions"] \
                or up < tier["promotions"] or not store:
            raise RuntimeError(f"role tier s{i}: tier families or records")
    rfiles = role_files("role replica", replica["dir"])
    published = [e for dump in rfiles["dumps"] for e in dump["events"]
                 if e["kind"] == "replica.publish"]
    st = _role_stats(replica["err"], "replica")
    answers = check_health("role replica",
                           replica["health"])[replica["err"]]
    dogs = {k: answers["watchdogs"].get(k) for k in ("replica", "serving")}
    print(f"  role replica: {len(published)} replica.publish records for "
          f"{st['publications']} publications (the last at clock "
          f"{published[-1]['clock'] if published else None}); watchdogs "
          f"{dogs}")
    if not published or len(published) != st["publications"] or any(
            v is None or v["tripped"] or v["trip_count"]
            for v in dogs.values()):
        raise RuntimeError("role replica: records or watchdogs")
    return run


def role_telemetry_phase(dev) -> list[dict]:
    """The role runners with their telemetry flags on the card (the main
    path's width; ROLE_ITERS server iterations a run, the split runs
    ROLE_PAIR_ITERS): the traced bridge round, the split deployment traced
    and untraced in turn (role_split_check), two shards with one killed,
    a relay, a serving server, and capped durable shards with a replica
    following their logs (these four at once)."""
    t0 = time.perf_counter()
    traced_bridge_check(dev)
    runs = role_split_check()
    # the relay, the serving server, the killed shard and the capped shards
    # with their replica are checks of function: they share the card, and
    # their rates and latencies are taken under that load
    print("role telemetry: the relay, serving, killed-shard and capped "
          "replica runs run at once from here")
    runs += _at_once([role_relay_check, role_serve_check,
                      role_shard_kill_check, role_tier_replica_check])
    print(f"role telemetry phase: {time.perf_counter() - t0:.1f} s "
          f"[{card_line()}]")
    return runs


# the multi-device phase (parallel/{mesh,multihost,range_sharded}.py, the
# fused path's mesh branch, cli.run -r and --param_shards) and the
# ground-truth fit on the card


def _md_csv(path: str, tag: str) -> list[list[str]]:
    """A log's rows (header dropped), or [] when `path` is absent."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [r.split(";") for r in f.read().splitlines()[1:]]


def md_protocol_check(name: str, d: str, server, worker, rounds: int,
                      eval_every: int) -> None:
    """The sequential contract of a fused job's logs in `d`: each
    worker's clocks 1..rounds, the server's on the eval cadence, the loss
    falling, and the port's validate_run(..., 0) on the ranks' rows."""
    for w in range(WORKERS):
        clocks = [int(r[2]) for r in worker if int(r[1]) == w]
        if clocks != list(range(1, rounds + 1)):
            raise RuntimeError(f"{name}: worker {w} clocks {clocks[:5]}...")
    want = [c for c in range(1, rounds + 1) if c % eval_every == 0]
    if [int(r[2]) for r in server] != want:
        raise RuntimeError(f"{name}: server clocks "
                           f"{[int(r[2]) for r in server]}")
    if not float(server[-1][3]) < float(server[0][3]):
        raise RuntimeError(f"{name}: the loss did not fall")
    # the ranks' worker rows in one file, in stamp order, the lower clock
    # first at one millisecond (it enabled the higher; the auditor orders
    # ties by row order), audited by the port's evaluation CLI in a
    # process of its own: this one imports no pandas
    merged = os.path.join(d, "logs-worker-job.csv")
    with open(merged, "w") as f:
        f.write("timestamp;partition;vectorClock;loss;fMeasure;accuracy;"
                "numTuplesSeen\n")
        f.writelines(";".join(r) + "\n" for r in sorted(
            worker, key=lambda r: (int(r[0]), int(r[2]))))
    out = subprocess.run(
        [sys.executable, "-m", "kafka_ps_tpu_torch.evaluation", "validate",
         "--worker", merged, "--server", os.path.join(d, "logs-server.csv"),
         "-c", "0"], cwd=REPO, capture_output=True, text=True, timeout=120)
    if out.returncode != 0 or out.stdout.strip() != "0 violation(s)":
        raise RuntimeError(f"{name}: validate_run: {out.stdout[-2000:]}"
                           f"{out.stderr[-2000:]}")


def md_cli_job(name: str, world: int, flags: tuple, iters: int,
               eval_every: int, task: str = "logreg",
               hidden: int = H) -> list[dict]:
    """A `cli.run -r --fused -l --checkpoint` job of `world` ranks sharing
    this card (gloo: NCCL refuses two ranks on one card), on the main
    path's CSV: rank 0 alone writes the server, events and worker logs
    and the checkpoint, rank r the worker log .p<r>; each rank feeds and
    trains its block of workers, one gang call per round; the logs keep
    the sequential contract.  Returns each rank's kernel calls as runs of
    the `kernels` line."""
    from torch_multidevice_runs import cli_job
    d = os.path.join(OUT, f"md-{name}")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    rounds = iters // WORKERS
    t0 = time.perf_counter()
    done = cli_job(d, world, [
        "-training", os.path.join(OUT, "train.csv"), "-test",
        os.path.join(OUT, "test.csv"), "--num_workers", str(WORKERS),
        "--num_features", str(F), "--num_classes", str(C), "--task", task,
        "--hidden_dim", str(hidden), "-max", str(MAX_BUFFER), "-p", "0",
        "-l", "-r", "--fused", "--eval_every", str(eval_every),
        "--max_iterations", str(iters), "--checkpoint", "ck.npz",
        "--checkpoint_every", str(iters // 2), *flags], timeout=300)
    wall = time.perf_counter() - t0
    for r, (rc, _, err) in enumerate(done):
        if rc != 0:
            raise RuntimeError(f"{name}: rank {r} exited {rc}\n"
                               f"{err[-3000:]}")
    stats = [json.loads([ln for ln in err.splitlines() if ln.startswith(
        "kafka_ps_tpu_torch run: ")][-1].split(": ", 1)[1])
        for _, _, err in done]
    server = _md_csv(os.path.join(d, "logs-server.csv"), name)
    logs = [_md_csv(os.path.join(d, "logs-worker.csv" if r == 0 else
                                 f"logs-worker.p{r}.csv"), name)
            for r in range(world)]
    names = sorted(f for f in os.listdir(d)
                   if f.startswith(("logs-", "ck")))
    want = sorted(["logs-server.csv", "logs-events.csv", "logs-worker.csv",
                   "ck.npz"] + [f"logs-worker.p{r}.csv"
                                for r in range(1, world)])
    if names != want:
        raise RuntimeError(f"{name}: files {names}, want {want}")
    per = WORKERS // world
    blocks = [sorted({int(row[1]) for row in rows}) for rows in logs]
    if blocks != [list(range(r * per, (r + 1) * per))
                  for r in range(world)]:
        raise RuntimeError(f"{name}: the ranks' workers {blocks}")
    worker = [row for rows in logs for row in rows]
    md_protocol_check(name, d, server, worker, rounds, eval_every)
    with np.load(os.path.join(d, "ck.npz")) as z:
        if z["iterations"] != iters or any(k.startswith("buf")
                                           for k in z.files):
            raise RuntimeError(f"{name}: checkpoint at {z['iterations']} "
                               f"with {z.files}")
    remove(os.path.join(d, "ck.npz"))     # 17 MB at H=4096
    prefix = "" if task == "logreg" else "mlp_"
    out = []
    for r, st in enumerate(stats):
        k, job = st["kernels"], st["job"]
        gang, members = k[f"{prefix}batched_launches"], \
            k[f"{prefix}batched_members"]
        if (job["rank"], job["world"]) != (r, world) or gang != rounds \
                or members != per * rounds or k[f"{prefix}launches"]:
            raise RuntimeError(f"{name} rank {r}: {job}, kernel calls {k}")
        out.append({"task": task, "kind": "f32", "hidden": hidden,
                    "single": 0, "gang_calls": gang})
    stamps = [int(row[0]) for row in worker]
    rate = iters / ((max(stamps) - min(stamps)) / 1e3 or 1e-3)
    print(f"multidevice {name}: {world} ranks on one card, backend "
          f"{stats[0]['job']['backend']}; {rounds} rounds, each rank one "
          f"gang call a round over {per} workers ({gang} calls, {members} "
          f"members); server rows {len(server)}, final loss "
          f"{float(server[-1][3]):.4f}, F1 {float(server[-1][4]):.4f}; "
          f"{rate:.1f} server iterations/s over the worker rows' stamps; "
          f"job wall {wall:.1f} s (the ranks' start and kernel loads "
          f"included) [{card_line()}]")
    return out


def md_close(name: str, out: np.ndarray, ref: np.ndarray) -> float:
    """`out` within rtol 1e-4, atol 1e-5 of `ref` (float32 sums in other
    orders): the largest absolute difference."""
    torch.testing.assert_close(torch.from_numpy(out), torch.from_numpy(ref),
                               rtol=RTOL, atol=MLP_ATOL, msg=name)
    return float(np.abs(out - ref).max())


def md_app_spec(**kw) -> dict:
    """A run_fused_bsp(mesh=) run of tests/torch_multidevice_runs.py at
    the main path's shapes, on 1024 rows a worker fed before the loop."""
    return dict({"task": "logreg", "F": F, "C": C, "H": H, "lr": 0.5,
                 "workers": WORKERS, "buffer": MAX_BUFFER,
                 "n_train": WORKERS * MAX_BUFFER, "n_test": TEST_ROWS,
                 "seed": 0, "iters": MD_ITERS, "eval_every": 10,
                 "param_shards": 1}, **kw)


def md_refusals() -> None:
    """cli.run's refusals on the card, with the JAX CLI's texts: the
    --param_shards 2 of a run outside a job (device count 1), and in a
    1-rank NCCL job -r without --fused and --durable-log."""
    from kafka_ps_tpu_torch.cli import run as cli_run
    from torch_multidevice_runs import free_port
    base = ["-training", os.path.join(OUT, "train.csv"), "-test",
            os.path.join(OUT, "test.csv"), "--num_features", str(F),
            "--num_classes", str(C), "--max_iterations", "8"]
    cases = [
        ((), ("--fused", "--param_shards", "2"),
         "--param_shards 2 must divide the device count 1"),
        (("-r",), (), "-r joined a multi-host job but only --fused runs "
         "over the global mesh; add --fused (or run the async consistency "
         "modes single-host)"),
        (("-r",), ("--fused", "--durable-log", "md-wal"),
         "--durable-log is single-process; a multi-host job must run "
         "without it (use --checkpoint for resume)")]
    for job, flags, text in cases:
        env = {"KPS_COORDINATOR": f"127.0.0.1:{free_port()}",
               "KPS_NUM_PROCESSES": "1", "KPS_PROCESS_ID": "0"} if job \
            else {}
        os.environ.update(env)
        try:
            cli_run.main([*base, *job, *flags])
        except SystemExit as e:
            got = str(e)
        else:
            got = None
        finally:
            for var in env:
                os.environ.pop(var)
        if got != text or torch.distributed.is_initialized():
            raise RuntimeError(f"refusal {job + flags}: {got!r}")
        print(f"multidevice refusal {' '.join(job + flags)}: {got}")


def md_ground_truth(dev) -> None:
    """evaluation/ground_truth.train_offline on the card against the CPU,
    100 full-batch steps on the main path's data shapes (6000 rows of
    F=1024, C=5): theta within rtol 1e-4, atol 1e-5 (float32 products
    summed in other orders; TF32 off), F1 and accuracy within
    1/len(test)."""
    from kafka_ps_tpu_torch.data.synth import generate
    from kafka_ps_tpu_torch.evaluation import ground_truth
    from kafka_ps_tpu_torch.models import metrics
    from kafka_ps_tpu_torch.utils.config import ModelConfig
    cfg = ModelConfig(num_features=F, num_classes=C)
    x, y = generate(TRAIN_ROWS + TEST_ROWS, F, C, seed=0)
    tx, ty, vx, vy = x[:TRAIN_ROWS], y[:TRAIN_ROWS], x[TRAIN_ROWS:], \
        y[TRAIN_ROWS:]
    got = {}
    for where in (dev.type, "cpu"):
        t0 = time.perf_counter()
        theta = ground_truth.train_offline(tx, ty, cfg, steps=GT_STEPS,
                                           device=where)
        seconds = time.perf_counter() - t0
        m = metrics.evaluate(torch.from_numpy(theta), torch.from_numpy(vx),
                             torch.from_numpy(vy), cfg=cfg)
        got[where] = (theta, float(m.f1), float(m.accuracy), seconds)
    (tc, fc, ac, sc), (tp, fp, ap, sp) = got[dev.type], got["cpu"]
    err = md_close("ground truth theta (card vs CPU)", tc, tp)
    if abs(fc - fp) > 1 / TEST_ROWS or abs(ac - ap) > 1 / TEST_ROWS:
        raise RuntimeError(f"ground truth: F1 {fc} / {fp}, accuracy {ac} "
                           f"/ {ap}")
    print(f"multidevice ground truth: {GT_STEPS} steps on the card "
          f"{sc:.2f} s, on the CPU {sp:.2f} s (host clock, transfers "
          f"included); theta max |diff| {err:.3g}; F1 {fc:.4f} / {fp:.4f}, "
          f"accuracy {ac:.4f} / {ap:.4f} [{card_line()}]")


def multidevice_phase(dev) -> list[dict]:
    """Phase 11: the multi-device fused path on one card (see the module
    docstring).  Returns the runs whose kernel calls the `kernels` line
    counts: the app runs of the 1-rank job and its no-job twin, the
    2-rank app runs and every rank of the CLI jobs."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from kafka_ps_tpu_torch.data.synth import generate
    from kafka_ps_tpu_torch.models.task import get_task
    from kafka_ps_tpu_torch.utils.config import ModelConfig
    from torch_multidevice_runs import run_job
    t0 = time.perf_counter()
    d = os.path.join(OUT, "md-jobs")
    shutil.rmtree(d, ignore_errors=True)
    runs = []

    def app_runs(name: str, results: list) -> None:
        for res in results:
            n = res["counts"]
            runs.append({"task": "logreg", "kind": "f32", "hidden": H,
                         "single": n["launches"],
                         "gang_calls": n["batched_launches"]})
            if n["launches"] or n["batched_launches"] != MD_ITERS // WORKERS:
                raise RuntimeError(f"{name}: kernel calls {n}")

    # 1. a 1-rank NCCL job against no job, in one child process
    x, y = generate(WORKERS * MAX_BUFFER, F, C, noise=1.0, seed=7)
    rng = np.random.default_rng(7)
    steps = {"task": "logreg", "F": F, "C": C, "H": H, "lr": 0.5,
             "theta": rng.normal(scale=0.01, size=ModelConfig(
                 num_features=F, num_classes=C).num_params)
             .astype(np.float32),
             "x": x.reshape(WORKERS, MAX_BUFFER, F),
             "y": y.reshape(WORKERS, MAX_BUFFER),
             "mask": (rng.random((WORKERS, MAX_BUFFER)) < 0.9)
             .astype(np.float32),
             "server_lr": 1.0 / WORKERS, "rounds": 8}
    one = run_job("one_rank_bitwise", 1,
                  {"steps": steps, "app": md_app_spec()},
                  os.path.join(d, "one"), timeout=300)[0]
    none, job = one["none"], one["job"]
    for key in ("bsp", "bsp_multi"):
        for a, b in zip(none["steps"][key], job["steps"][key]):
            if not np.array_equal(a, b):
                raise RuntimeError(f"1-rank job: {key} not bitwise no job")
    strip = (lambda rows: [r.split(";", 1)[1] for r in rows])
    if not (np.array_equal(none["app"]["theta"], job["app"]["theta"])
            and strip(none["app"]["server"]) == strip(job["app"]["server"])
            and strip(none["app"]["worker"]) == strip(job["app"]["worker"])):
        raise RuntimeError("1-rank job: run_fused_bsp not bitwise no job")
    app_runs("1-rank app", [none["app"], job["app"]])
    rate = {k: MD_ITERS / v["app"]["seconds"] for k, v in one.items()}
    print(f"multidevice 1-rank NCCL job: the bsp step, the 8-round chunk "
          f"(eager in the job, a CUDA graph without) and run_fused_bsp "
          f"({MD_ITERS} iterations, eval every 10, after one untimed run "
          f"without a job) bitwise no job; "
          f"run_fused_bsp {rate['job']:.1f} server iterations/s in the job, "
          f"{rate['none']:.1f} without (chunks "
          f"{none['app']['fused']['chunks']} / {job['app']['fused']['chunks']}"
          f") [{card_line()}]")
    # 2. the app over 2 ranks sharing the card (gloo): the bsp branch and
    # --param_shards 2's range-sharded server (a 1 x 2 mesh) on the same
    # fed rows, then the all_reduce of the H=4096 MLP's round
    wide = get_task("mlp", ModelConfig(num_features=F, num_classes=C,
                                       hidden_dim=WIDE_H)).num_params
    # (a first, untimed bsp run: loads and first calls)
    jobs = run_job("job", 2, {"runs": [md_app_spec(), md_app_spec(),
                                       md_app_spec(param_shards=2)],
                              "allreduce_numel": wide + 1},
                   os.path.join(d, "two"), timeout=300)
    for r, res in enumerate(jobs):
        app_runs(f"2-rank app rank {r}", res["app"])
    two = [res["app"][1:] for res in jobs]
    bsp_theta, range_theta = two[0][0]["theta"], two[0][1]["theta"]
    if not all(np.array_equal(res[0]["theta"], bsp_theta)
               and np.array_equal(res[1]["theta"], range_theta)
               for res in two):
        raise RuntimeError("2-rank app: the ranks' thetas differ")
    err = md_close("2-rank --param_shards 2 theta vs the bsp branch",
                   range_theta, bsp_theta)
    ar = [ms for res in jobs for ms in res["allreduce_ms"]]
    print(f"multidevice 2-rank app (gloo on one card): run_fused_bsp "
          f"{MD_ITERS / two[0][0]['seconds']:.1f} server iterations/s "
          f"(bsp), {MD_ITERS / two[0][1]['seconds']:.1f} (range 1 x 2, "
          f"the pad clean at every round); range theta max |diff| {err:.3g} "
          f"from the bsp run's; gloo all_reduce of {wide + 1} float32 (the "
          f"H={WIDE_H} MLP's delta and loss sums) median "
          f"{statistics.median(ar):.2f} ms, min {min(ar):.2f}, max "
          f"{max(ar):.2f} over {len(ar)} [{card_line()}]")
    # 3. refusals and the ground-truth fit, in this process
    md_refusals()
    md_ground_truth(dev)
    # 4. the CLI jobs, 2 ranks on the card
    print("multidevice: the three CLI jobs run at once from here")
    for got in _at_once([
            lambda: md_cli_job("logreg", 2, (), MD_ITERS, 1),
            lambda: md_cli_job("logreg-param-shards", 2,
                               ("--param_shards", "2"), MD_ITERS, 1),
            lambda: md_cli_job(f"mlp-h{WIDE_H}", 2, (),
                               MD_WIDE_ROUNDS * WORKERS, 1, task="mlp",
                               hidden=WIDE_H)]):
        runs += got
    shutil.rmtree(d, ignore_errors=True)
    print(f"multidevice phase: {time.perf_counter() - t0:.1f} s "
          f"[{card_line()}]")
    return runs


@contextlib.contextmanager
def observed_graphs():
    """(graphs, added): every CUDA graph made inside, its captured graph
    kept after its instantiation (`keep_graph`, which instantiates at the
    first replay) so that its nodes can be read, with its replays
    counted; and the batched_launches that the fused path's replays add
    to the launch counter (`parallel/bsp.py`'s positive `add_counts`)."""
    from kafka_ps_tpu_torch.ops import fused_update
    base, base_add = torch.cuda.CUDAGraph, fused_update.add_counts
    made: list = []
    added = {"batched_launches": 0}

    class Observed(base):
        def __new__(cls, keep_graph=False):
            return super().__new__(cls, True)

        def __init__(self, keep_graph=False):
            super().__init__(True)
            self.replays = 0
            made.append(self)

        def replay(self):
            self.replays += 1
            super().replay()

    def add_counts(delta):
        added["batched_launches"] += max(delta.get("batched_launches", 0), 0)
        base_add(delta)

    torch.cuda.CUDAGraph, fused_update.add_counts = Observed, add_counts
    try:
        yield made, added
    finally:
        torch.cuda.CUDAGraph, fused_update.add_counts = base, base_add


def graph_k2_launches(graphs: list) -> tuple[int, int]:
    """(K2 kernels the graphs ran, replays): the K2 kernel nodes of each
    graph, read from its DOT dump, times the graph's replays."""
    ran = 0
    for i, g in enumerate(graphs):
        path = os.path.join(OUT, f"graph-{i}.dot")
        g.debug_dump(path)
        with open(path) as f:
            text = f.read()
        os.remove(path)
        starts = [m.start() for m in
                  re.finditer(r'^"[^"]+"\s*\[', text, re.M)] + [len(text)]
        nodes = sum("logreg_update" in text[a:b]
                    for a, b in zip(starts, starts[1:]))
        if not nodes:
            raise RuntimeError(f"CUDA graph {i} holds no K2 kernel node")
        ran += nodes * g.replays
    return ran, sum(g.replays for g in graphs)


def profile_run(task: str, iters: int = 200, flags: tuple = ()) -> None:
    """One default serial -c 0 run (plus `flags`) through cli.run.main under
    torch.profiler and cProfile: device time by kernel, the device's busy
    share of the window from the profiler's start to the flushed logs,
    and the host's own time by Python function (cProfile on Python 3.12
    sees every thread, adds its own cost to every Python call, and its
    cumulative times overlap across threads).  A --fused run must have
    replayed chunks, with no single launch, and the K2 kernels that the
    replays ran must equal what they added to the launch counter (the
    replays' counts are added, not launched, by the wrapper): they are
    read from the CUDA graphs themselves, the K2 nodes of each captured
    graph times its replays (`graph_k2_launches`).  The rounds outside
    a chunk launch K2 through the wrapper, which counts them there.
    torch.profiler's count of all K2 kernels is printed beside the
    counter and may only fall short of it: its trace loses kernel events
    now and then (45–46 of 50 in three runs), even with the discarded
    warm-up step that opens it."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile, schedule

    from kafka_ps_tpu_torch.cli import run as cli_run
    from kafka_ps_tpu_torch.ops import fused_update
    here = os.getcwd()
    os.chdir(OUT)
    err = io.StringIO()
    trace = {}
    try:
        host = cProfile.Profile()
        fused_update.reset_counts()
        with contextlib.redirect_stderr(err), \
                observed_graphs() as (graphs, added):
            # one warm-up step first, whose events are discarded: without
            # it the trace lost the first events of its window more often
            with profile(activities=[ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1,
                                           repeat=1),
                         on_trace_ready=lambda p: trace.setdefault(
                             "events", p.key_averages())) as prof:
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()
                prof.step()
                t0 = time.perf_counter()
                host.enable()
                cli_run.main([
                    "-training", "train.csv", "-test", "test.csv",
                    "--num_workers", str(WORKERS), "--num_features",
                    str(F), "--num_classes", str(C), "--task", task,
                    "--hidden_dim", str(H), "-max", str(MAX_BUFFER), "-p",
                    "0", "-l", "--mode", "serial", "-c", "0",
                    "--max_iterations", str(iters), *flags])
                torch.cuda.synchronize()
                host.disable()
                wall_ms = (time.perf_counter() - t0) * 1e3
                prof.step()
    finally:
        os.chdir(here)
    n = fused_update.counts()
    per, traced = {}, 0
    for e in trace["events"]:
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            per[e.key[:70]] = us / 1e3
        if "logreg_update" in e.key:
            traced += e.count
    busy = sum(per.values())
    name = " ".join([task, *flags])
    print(f"profile {name} serial -c 0 ({iters} server iterations, CSV "
          f"parsing included): wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {1 - busy / wall_ms:.4f}; device ms "
          f"per server iteration {busy / iters:.4f}; top kernels (ms):")
    for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {v:9.3f}  {k}")
    if "--fused" in flags:
        fs = [json.loads(line.split(": ", 1)[1])
              for line in err.getvalue().splitlines()
              if line.startswith("kafka_ps_tpu_torch run: ")][-1]["fused"]
        ran, replays = graph_k2_launches(graphs)
        total = n["batched_launches"]
        print(f"profile {name}: {fs['chunks']} chunk dispatches (CUDA "
              f"graph replays) of {fs['rounds']} rounds; {len(graphs)} "
              f"graphs captured, replayed {replays} times, their K2 nodes "
              f"ran {ran} kernels, the replays added "
              f"{added['batched_launches']} to the counter; "
              f"batched_launches counter {total} ("
              f"{total - added['batched_launches']} launched outside the "
              f"graphs), single launches {n['launches']}; K2 kernels "
              f"traced by torch.profiler {traced}")
        if (not fs["chunks"] or replays != fs["chunks"]
                or ran != added["batched_launches"] or n["launches"]):
            raise RuntimeError(f"profile {name}: the launch counter does "
                               "not match the K2 kernels that ran")
        if traced > total:
            raise RuntimeError(f"profile {name}: torch.profiler traced more "
                               "K2 kernels than the counter counted")
    stats = pstats.Stats(host)
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])
    print(f"profile {name} host by own time (cProfile; own ms, cumulative "
          "ms, calls):")
    for (path, line, fn), (_, calls, own, cum, _) in rows[:25]:
        where = f"{os.path.basename(path)}:{line}({fn})"
        print(f"  {own * 1e3:9.1f} {cum * 1e3:9.1f} {calls:7d}  {where}")
    parse = [(rank, fn, own) for rank, ((path, _, fn), (_, _, own, _, _))
             in enumerate(rows, 1)
             if path.endswith(os.path.join("data", "stream.py"))
             or path.endswith(os.path.join("native", "binding.py"))]
    print(f"profile {name}: the CSV parse's functions by own-time rank: "
          + ", ".join(f"#{rank} {fn} {own * 1e3:.1f} ms"
                      for rank, fn, own in parse[:6]))
    if "--durable-log" in flags:
        # the log's host costs: serde (the device-to-host copy), the CRC,
        # the writes and the fsyncs
        logged = [(rank, f"{os.path.basename(path)}:{fn}", own)
                  for rank, ((path, _, fn), (_, _, own, _, _))
                  in enumerate(rows, 1)
                  if os.sep + "log" + os.sep in path
                  or path.endswith("serde.py")
                  or any(k in fn for k in ("crc32", "BufferedWriter",
                                           "fsync", "method 'cpu'"))]
        print(f"profile {name}: the durable log's functions by own-time "
              "rank: " + ", ".join(f"#{rank} {fn} {own * 1e3:.1f} ms"
                                   for rank, fn, own in logged[:10]))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from kafka_ps_tpu_torch.ops import _build

    sys.stdout = _TaggedLines(sys.stdout)
    # every process this script starts imports torch; where its bytecode
    # is not installed, each compiles torch from source (about 2.5 s of
    # its start): they share one bytecode cache in the checkout
    os.environ["PYTHONPYCACHEPREFIX"] = os.path.join(REPO, ".pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    t_script = time.perf_counter()
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
    smem = (ctypes.c_int * 8)()
    _build.load("mlp_update.cu").kps_mlp_smem(smem)
    print("mlp_update.cu dynamic shared memory per CTA, hidden_pass / "
          "update_pass (bytes): " + "; ".join(
              f"{form} {smem[2 * i]} / {smem[2 * i + 1]}"
              for i, form in enumerate(("f32", "bf16", "int8", "wide"))))

    from kafka_ps_tpu_torch.native import binding
    t0 = time.perf_counter()
    if not binding.is_available():
        raise RuntimeError("the native CSV parser is unavailable (no g++)")
    print(f"native CSV parser: {binding.library_path()} loaded in "
          f"{time.perf_counter() - t0:.1f} s (built from "
          "kafka_ps_tpu_torch/native/csvparse.cpp where absent)")

    kernels = kernel_phase(dev)
    kernels.update(wide_mlp_phase(dev))
    reference_check(dev)
    fused_reference_check(dev)
    codec_phase(dev)
    compress_reference_check(dev)
    resume_check(dev)
    durable_reference_check(dev)
    threaded_order_check(dev)
    membership_check(dev)
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
        runs += [main_path_run(task, m, c, ITERS, ("--slab-dtype", kind))
                 for task, kind, m, c in (
                     ("logreg", "bf16", "serial", 0),
                     ("logreg", "int8", "threaded", 2),
                     ("mlp", "int8", "serial", 0),
                     ("mlp", "bf16", "threaded", -1))]
        runs += [main_path_run("logreg", "serial", 0, ITERS,
                               ("--fused", "--eval_every", str(e)))
                 for e in (1, 10)]
        runs.append(main_path_run("mlp", "serial", 0,
                                  FUSED_MLP_ROUNDS * WORKERS,
                                  ("--fused", "--eval_every", "10"),
                                  hidden=WIDE_H))
        runs += [main_path_run(task, m, c, ITERS, ("--compress", codec,
                                                   *extra))
                 for task, codec, m, c, extra in (
                     ("logreg", "int8", "serial", 0, ()),
                     ("logreg", "topk:0.01", "threaded", 2,
                      ("--failure_policy", "rebalance",
                       "--heartbeat_timeout", "30")),
                     ("mlp", "bf16", "serial", 0, ()))]
        runs.append(main_path_run("mlp", "serial", 0, COMPRESSED_WIDE_ITERS,
                                  ("--compress", "int8"), hidden=WIDE_H))
        # a checkpointed run of 200 iterations, then the same command to
        # 400: it restores at 200 and continues the logs
        for codec in ("none", "int8"):
            ck = f"ck-{codec}.npz"
            for stale in (ck, ck + ".tmp.npz"):
                if os.path.exists(os.path.join(OUT, stale)):
                    os.remove(os.path.join(OUT, stale))
            flags = ("--checkpoint", ck, "--checkpoint_every", "50", "-v",
                     "--compress", codec)
            runs += [main_path_run("logreg", "serial", 0, it, flags)
                     for it in (RESUME_ITERS, 2 * RESUME_ITERS)]
        runs += durable_runs()
        cli_crash_check()
        split_reference_check(dev)
        direct: dict = {}
        t_split = time.perf_counter()
        runs += split_runs(direct)
        t_scale = time.perf_counter()
        scaleout_reference_check(dev)
        t_runs = time.perf_counter()
        runs += scaleout_runs(direct)
        t_end = time.perf_counter()
        serving_reference_check(dev)
        t_serve_runs = time.perf_counter()
        runs += serving_runs(runs[1]["rate"])
        t_serve = time.perf_counter()
        # the uncapped runs the tier phase's split and shard runs stand
        # beside: the same topology, task, H, -c and flags
        twins = {name: next(
            r for r in runs if r.get("topology") == top
            and (r["task"], r["hidden"], r["c"], r["flags"]) == key
            and not r["kill"] and not r["server_flags"])
            for name, top, key in (("split", "split", ("logreg", H, 2, ())),
                                   ("shards", "shards", ("mlp", H, -1, ())))}
        runs += tier_runs(dev, twins)
        t_tier = time.perf_counter()
        runs += telemetry_phase()
        t_tel = time.perf_counter()
        runs += role_telemetry_phase(dev)
        t_role = time.perf_counter()
        runs += multidevice_phase(dev)
        t_md = time.perf_counter()
        print(f"phase times: split {t_scale - t_split:.1f} s; scale-out "
              f"{t_end - t_scale:.1f} s (in-process checks "
              f"{t_runs - t_scale:.1f} s, runs {t_end - t_runs:.1f} s); "
              f"serving {t_serve - t_end:.1f} s (in-process checks "
              f"{t_serve_runs - t_end:.1f} s, runs "
              f"{t_serve - t_serve_runs:.1f} s); tier "
              f"{t_tier - t_serve:.1f} s; telemetry {t_tel - t_tier:.1f} s; "
              f"role telemetry {t_role - t_tel:.1f} s; multi-device "
              f"{t_md - t_role:.1f} s")
        profile_run("logreg")
        profile_run("logreg", flags=("--durable-log", "wal-profile"))
        profile_run("mlp")
        profile_run("logreg", flags=("--slab-dtype", "int8"))
        profile_run("logreg", flags=("--compress", "int8"))
        profile_run("logreg", flags=("--fused", "--eval_every", "10"))
    finally:
        # ~70 MB of CSV, and the durable logs, made anew each run
        for name in os.listdir(OUT):
            if name.endswith((".csv", ".npz")) and not name.startswith(
                    ("server-", "worker-")) or name.startswith("wal-"):
                remove(os.path.join(OUT, name))
    # K3 and K5 count their single and batched calls (one kernel each)
    entries = [("local_update", "logreg", "f32", ("single",)),
               ("local_update_batched", "logreg", "f32", ("gang_calls",)),
               ("mlp_local_update", "mlp", "f32", ("single",)),
               ("mlp_local_update_batched", "mlp", "f32", ("gang_calls",))]
    entries += [(f"{pre}stream_update_{kind}", task, kind,
                 ("single", "gang_calls"))
                for pre, task in (("", "logreg"), ("mlp_", "mlp"))
                for kind in SLAB_KINDS]
    entries += [(f"mlp_local_update_batched_h{WIDE_H}", "mlp", "f32",
                 ("gang_calls",)),
                (f"mlp_local_update_h{WIDE_H}", "mlp", "f32", ("single",))]
    for name, task, kind, keys in entries:
        # the H=4096 entries count the wide runs' calls, the others the
        # runs at the main path's H; the split and scale-out runs count
        # as main-path runs (their worker processes' calls)
        wide = name.endswith(f"_h{WIDE_H}")
        kernels[name]["launches"] = sum(
            r[k] for r in runs if (r["task"], r["kind"]) == (task, kind)
            and (r["hidden"] == WIDE_H) == wide for k in keys)
        if kernels[name]["launches"] < 1:
            raise RuntimeError(f"{name} never ran on the main path")
    print(f"whole script: {time.perf_counter() - t_script:.1f} s")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
