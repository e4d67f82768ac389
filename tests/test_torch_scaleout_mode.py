"""The port's scale-out topologies as real processes on the CPU:
`server_runner --listen --shards 2 --shard-id 0|1` with sharded
`worker_runner` processes (a comma-separated `--connect`), and
`agg_runner` between a `server_runner --listen` and `worker_runner
--aggregate` processes, at the JAX tests' sizes (F=16, C=3, 4 workers),
each process under its own timeout.

  * two port shards and two port sharded worker processes at -c 0 and
    -c -1 (and topk:0.1 as the workers' sparsifier, sparse slices on the
    wire): every shard reaches the iterations, a worker's final clocks on
    the two shards differ by at most one (none under BSP),
    the worker logs pass the JAX package's validate_run, the theta
    assembled from the shards' checkpoints gives F1 > 0.5;
  * both cross-package pairings: a JAX sharded worker against port
    shards, and a port sharded worker against JAX shards;
  * a relay of one package between the other package's server and
    workers, and the port's own relay (stacked, --summed, --compress
    int8) beside the server's eval rows;
  * shard 1 killed by SIGKILL mid-run and restarted from its checkpoint
    and durable log: the run finishes, the restarted shard replayed its
    log, and each shard's whole gradient log replayed serially through a
    fresh port ServerNode ends bitwise at the shard's final checkpoint.
"""

from __future__ import annotations

import glob
import json
import os
import signal
import sys
import time

import numpy as np
import pandas as pd
import pytest
import torch

from kafka_ps_tpu.evaluation import validate
from test_torch_socket_mode import (COMMON, _finish, _free_port, _module,
                                    _start, _stats, _write_csvs)

PORT_PKG, JAX_PKG = "kafka_ps_tpu_torch", "kafka_ps_tpu"
SPLIT_IDS = ("0,1", "2,3")


def _shard_cmd(pkg, port, shard, c, iters, flags=(), every=1000):
    return _module(pkg, "server") + [
        "--listen", str(port), "--shards", "2", "--shard-id", str(shard),
        "-training", "../train.csv", "-c", str(c), "-p", "1",
        "--max_iterations", str(iters), "--checkpoint", "job.npz",
        "--checkpoint_every", str(every), *COMMON, *flags]


def _worker_cmd(pkg, addrs, ids, flags=()):
    return _module(pkg, "worker") + [
        "--worker_ids", ids, *addrs, "-min", "8", "-max", "32", *COMMON,
        *flags]


def _sharded(tmp_path, c, iters, shard_pkg=PORT_PKG, worker_pkg=PORT_PKG,
             worker_flags=()):
    names = ["s0", "s1", "w0", "w1"]
    _write_csvs(tmp_path, names)
    ports = [_free_port(), _free_port()]
    procs = {f"s{i}": _start(_shard_cmd(shard_pkg, ports[i], i, c, iters),
                             tmp_path / f"s{i}") for i in (0, 1)}
    connect = ["--connect", ",".join(f"127.0.0.1:{p}" for p in ports)]
    for i, ids in enumerate(SPLIT_IDS):
        procs[f"w{i}"] = _start(
            _worker_cmd(worker_pkg, connect, ids, worker_flags),
            tmp_path / f"w{i}")
    return _finish(procs)


def _worker_logs(tmp_path):
    return pd.concat([pd.read_csv(tmp_path / f"w{i}" / "logs-worker.csv",
                                  sep=";") for i in (0, 1)])


def _assembled_f1(tmp_path, shard_dirs=("s0", "s1")) -> float:
    """The theta concatenated from the shards' final checkpoints,
    evaluated on the test set with the port's task."""
    from kafka_ps_tpu_torch.cli.run import load_test_csv
    from kafka_ps_tpu_torch.models.task import get_task
    from kafka_ps_tpu_torch.utils.config import ModelConfig
    parts = []
    for i, d in enumerate(shard_dirs):
        with np.load(tmp_path / d / f"job.npz.shard{i}of2.npz") as z:
            parts.append(z["theta"].astype(np.float32))
    theta = torch.from_numpy(np.concatenate(parts))
    tx, ty = load_test_csv(str(tmp_path / "test.csv"), 16)
    task = get_task("logreg", ModelConfig(num_features=16, num_classes=3))
    m = task.evaluate(theta, torch.from_numpy(tx),
                      torch.from_numpy(ty).to(torch.int32))
    return float(m.f1)


def _check_sharded(tmp_path, results, c, iters, port_shards=True,
                   port_workers=True):
    for name, (rc, _, err) in results.items():
        assert rc == 0, f"{name} failed (rc={rc}):\n{err[-3000:]}"
    wdf = _worker_logs(tmp_path)
    assert set(wdf["partition"]) == {0, 1, 2, 3}
    assert validate.validate_run(wdf, None, consistency_model=c) == []
    assert _assembled_f1(tmp_path) > 0.5
    shards = []
    if port_shards:
        shards = [_stats(results[f"s{i}"][2], "server") for i in (0, 1)]
        assert [s["server_iterations"] for s in shards] == [iters, iters]
        a, b = (s["final_clocks"] for s in shards)
        # a worker trains clock c + 1 only once both shards applied its
        # clock c: the shards' clocks of a worker differ by at most one,
        # and under BSP they stop at one round
        assert all(abs(x - y) <= 1 for x, y in zip(a, b))
        assert a == b or c != 0
        assert [s["key_range"] for s in shards] == [[0, 34], [34, 68]]
        assert all(s["device"] == "cpu" for s in shards)
    workers = []
    if port_workers:
        for i in (0, 1):
            st = _stats(results[f"w{i}"][2], "worker")
            rows = pd.read_csv(tmp_path / f"w{i}" / "logs-worker.csv",
                               sep=";")
            assert st["shards"] == 2 and st["device"] == "cpu"
            assert sum(st["rows"].values()) == len(rows)
            assert not any(st["kernels"].values())   # plain versions
            workers.append(st)
    return shards, workers


@pytest.mark.parametrize("c", [0, -1])
def test_port_shards_with_port_sharded_workers(tmp_path, c):
    shards, workers = _check_sharded(tmp_path, _sharded(tmp_path, c, 60),
                                     c, 60)
    for s in shards:
        assert s["wire"]["gradients"]["frames_in"] >= 60
        assert s["sparse_applies"] == 0
    assert shards[0]["rows"]["sent"] > 0 and shards[1]["rows"]["sent"] == 0


def test_topk_workers_send_sparse_slices(tmp_path):
    shards, workers = _check_sharded(
        tmp_path, _sharded(tmp_path, 2, 60,
                           worker_flags=("--compress", "topk:0.1")), 2, 60)
    assert all(s["sparse_applies"] + s["empty_slices"] >= 60
               for s in shards)
    assert sum(s["sparse_applies"] for s in shards) > 0
    grads = [s["wire"]["gradients"] for s in shards]
    # a sparse slice of the 7 survivors is far under a dense one of 34
    assert all(g["bytes_in"] / g["frames_in"] < 120 for g in grads)
    assert all(w["codec"] == "topk:0.1" for w in workers)


@pytest.mark.parametrize("shard_pkg,worker_pkg", [(PORT_PKG, JAX_PKG),
                                                  (JAX_PKG, PORT_PKG)])
def test_sharded_runs_across_packages(tmp_path, shard_pkg, worker_pkg):
    results = _sharded(tmp_path, 0, 40, shard_pkg=shard_pkg,
                       worker_pkg=worker_pkg)
    _check_sharded(tmp_path, results, 0, 40,
                   port_shards=shard_pkg == PORT_PKG,
                   port_workers=worker_pkg == PORT_PKG)


# -- aggregation relays -----------------------------------------------------


def _relayed(tmp_path, c, iters, server_pkg=PORT_PKG, relay_pkg=PORT_PKG,
             worker_pkg=PORT_PKG, flags=(), relay_flags=()):
    names = ["server", "relay", "w0", "w1"]
    _write_csvs(tmp_path, names)
    sport, rport = _free_port(), _free_port()
    procs = {"server": _start(_module(server_pkg, "server") + [
        "--listen", str(sport), "-training", "../train.csv", "-c", str(c),
        "-p", "1", "--max_iterations", str(iters), *COMMON, *flags],
        tmp_path / "server")}
    procs["relay"] = _start(
        [sys.executable, "-m", f"{relay_pkg}.cli.agg_runner", "--connect",
         f"127.0.0.1:{sport}", "--listen", str(rport), "--agg-id", "3",
         "--worker_ids", "0,1,2,3", *COMMON, *flags, *relay_flags],
        tmp_path / "relay")
    for i, ids in enumerate(SPLIT_IDS):
        procs[f"w{i}"] = _start(_worker_cmd(
            worker_pkg, ["--aggregate", f"127.0.0.1:{rport}"], ids, flags),
            tmp_path / f"w{i}")
    return _finish(procs)


def _check_relayed(tmp_path, results, c, iters, port_server=True,
                   port_relay=True):
    for name, (rc, _, err) in results.items():
        assert rc == 0, f"{name} failed (rc={rc}):\n{err[-3000:]}"
    sdf = pd.read_csv(tmp_path / "server" / "logs-server.csv", sep=";")
    wdf = _worker_logs(tmp_path)
    assert validate.validate_run(wdf, sdf, consistency_model=c) == []
    assert sdf["fMeasure"].max() > 0.5
    relay = None
    if port_server:
        server = _stats(results["server"][2], "server")
        # a composite's members apply together: the last may carry the
        # server past --max_iterations by up to its fan-in less one
        assert iters <= server["server_iterations"] < iters + 4
        assert server["aggregators"] == 1
        assert server["membership"]["evictions"] == []
        assert server["eval"]["lag_clocks"] == 0
    if port_relay:
        relay = _stats(results["relay"][2], "aggregator")
        assert relay["composites"] >= 1 and relay["members"] >= iters
        assert relay["device"] == "cpu"
    return relay


@pytest.mark.parametrize("c", [0, -1])
def test_port_relay_between_port_server_and_workers(tmp_path, c):
    results = _relayed(tmp_path, c, 60)
    relay = _check_relayed(tmp_path, results, c, 60)
    assert relay["direct_bytes"] > 0 and relay["bytes_upstream"] > 0
    for i in (0, 1):
        st = _stats(results[f"w{i}"][2], "worker")
        assert st["aggregate"] is True and st["shards"] == 1


def test_port_relay_summed_and_compressed(tmp_path):
    (tmp_path / "summed").mkdir()
    results = _relayed(tmp_path / "summed", 0, 40,
                       relay_flags=("--summed",))
    relay = _check_relayed(tmp_path / "summed", results, 0, 40)
    assert max(int(k) for k in relay["fan_in"]) >= 2
    (tmp_path / "int8").mkdir()
    results = _relayed(tmp_path / "int8", 2, 40,
                       flags=("--compress", "int8"))
    relay = _check_relayed(tmp_path / "int8", results, 2, 40)
    assert relay["codec"] == "int8"
    assert "delegated to the aggregator" in results["w0"][2]
    assert _stats(results["server"][2], "server")["codec"] == "int8"


@pytest.mark.parametrize("server_pkg,relay_pkg,worker_pkg", [
    (JAX_PKG, PORT_PKG, JAX_PKG), (PORT_PKG, JAX_PKG, PORT_PKG)])
def test_relay_of_one_package_between_the_others(tmp_path, server_pkg,
                                                 relay_pkg, worker_pkg):
    results = _relayed(tmp_path, 0, 40, server_pkg=server_pkg,
                       relay_pkg=relay_pkg, worker_pkg=worker_pkg)
    _check_relayed(tmp_path, results, 0, 40,
                   port_server=server_pkg == PORT_PKG,
                   port_relay=relay_pkg == PORT_PKG)


# -- a shard killed and restarted --------------------------------------------


def test_shard_sigkill_restart_replays_its_log_bitwise(tmp_path):
    from kafka_ps_tpu_torch.log import LogConfig
    from kafka_ps_tpu_torch.log.manager import LogManager
    from kafka_ps_tpu_torch.models.task import get_task
    from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
    from kafka_ps_tpu_torch.runtime import serde
    from kafka_ps_tpu_torch.runtime.server import ServerNode
    from kafka_ps_tpu_torch.runtime.sharding import ShardPlan
    from kafka_ps_tpu_torch.utils import config

    iters = 400
    _write_csvs(tmp_path, ("s0", "s1", "w0"))
    ports = [_free_port(), _free_port()]
    wal = str(tmp_path / "wal")

    def shard(i):
        return _start(_shard_cmd(PORT_PKG, ports[i], i, 0, iters,
                                 ("--durable-log", wal), every=25),
                      tmp_path / f"s{i}")

    procs = {"s0": shard(0), "s1": shard(1)}
    procs["w0"] = _start(_worker_cmd(
        PORT_PKG, ["--connect", ",".join(f"127.0.0.1:{p}" for p in ports)],
        "0,1,2,3"), tmp_path / "w0")
    grads = os.path.join(wal, "shard1of2", "gradients", "*", "*.log")
    try:
        deadline = time.monotonic() + 120
        while sum(os.path.getsize(s) for s in glob.glob(grads)) < 30000:
            assert time.monotonic() < deadline, "shard 1 logged too little"
            for name, p in procs.items():
                assert p.poll() is None, \
                    f"{name} exited: {p.communicate()[1][-3000:]}"
            time.sleep(0.05)
        procs["s1"].send_signal(signal.SIGKILL)
        procs["s1"].wait(timeout=30)
        procs["s1"] = shard(1)
        results = _finish(procs)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    for name, (rc, _, err) in results.items():
        assert rc == 0, f"{name} failed (rc={rc}):\n{err[-3000:]}"
    restarted = _stats(results["s1"][2], "server")
    assert restarted["restored"] is True
    assert restarted["replay"]["gradients"] > 0
    assert "restored checkpoint at iteration" in results["s1"][2]
    worker = _stats(results["w0"][2], "worker")
    assert worker["reconnects"] >= 1 and worker["router_resent"] > 0
    assert worker["stale_slices"] > 0
    assert _assembled_f1(tmp_path) > 0.5

    # each shard's whole gradient log, replayed serially, is the shard's
    # final checkpoint bit for bit
    cfg = config.PSConfig(
        num_workers=4, consistency_model=0, task="logreg",
        model=config.ModelConfig(num_features=16, num_classes=3),
        use_gang=False)
    plan = ShardPlan(get_task("logreg", cfg.model).num_params, 2)
    for i in (0, 1):
        with np.load(tmp_path / f"s{i}" / f"job.npz.shard{i}of2.npz") as z:
            end = json.loads(str(z["log_offsets"]))["gradients/0"]
            want = z["theta"].astype(np.float32)
        node = ServerNode(cfg, fabric_mod.Fabric(), "cpu",
                          key_range=plan.ranges[i], shard_id=i,
                          num_shards=2)
        node.start_training_loop()
        mgr = LogManager(os.path.join(wal, f"shard{i}of2"), LogConfig())
        for off, payload in mgr.get("gradients", 0).read_from(0):
            if off >= end:
                break
            node.process(serde.from_bytes(payload, device="cpu"))
        mgr.close()
        assert node.iterations >= iters
        assert node.theta.numpy().tobytes() == want.tobytes(), i
