"""The port's split deployment (kafka_ps_tpu_torch/cli/socket_mode.py,
cli/server_runner.py, cli/worker_runner.py) on the CPU: real server and
worker processes exchanging WEIGHTS / GRADIENTS / DATA_BATCH frames over
localhost, at the JAX tests' sizes (F=16, C=3, 4 workers; tests/
test_socket_mode.py), each process under its own timeout.

  * -c 10 and -c -1 with one worker process, -c 0 with two: the logs
    pass the JAX package's validate_run and the best fMeasure is above
    0.5; each worker process's stats line counts its CSV rows;
  * --compress int8 negotiates int8 on both sides;
  * a RuntimeError (standing in for a CUDA error) injected into the
    server's gradient decode ends the server with a non-zero exit and no
    eviction; injected into a worker's weights decode, that worker exits
    1;
  * a worker process killed with SIGKILL and restarted under
    --checkpoint --failure_policy rebalance restores its buffers and is
    readmitted (the port's tests/test_durability.py split case);
  * a JAX server_runner with a port worker_runner, and a port
    server_runner with a JAX worker_runner;
  * the runners' in-process fallback, the flags they refuse, and the
    scale-out flags reaching their roles (tests/test_torch_scaleout_mode.py
    runs those roles);
  * in process: one iteration through a localhost bridge pair is bitwise
    the in-process iteration (the gradient sent and the theta the server
    holds after applying it), for logreg and the MLP.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch

from kafka_ps_tpu.evaluation import validate
from kafka_ps_tpu_torch.cli import server_runner, worker_runner
from kafka_ps_tpu_torch.data.synth import generate, write_csv
from kafka_ps_tpu_torch.utils import checkpoint as ckpt
from torch_split_round import bridge_round

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["-test", "../test.csv", "--num_features", "16", "--num_classes",
          "3", "--num_workers", "4", "-l"]
TIMEOUT = 150.0          # seconds, per process


# -- helpers (one copy for the split tests) ------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ, KPS_PLATFORM="cpu", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _write_csvs(tmp_path, dirs=()):
    x, y = generate(460, 16, 3, noise=1.0, sparsity=0.5, seed=0)
    write_csv(str(tmp_path / "train.csv"), x[:400], y[:400])
    write_csv(str(tmp_path / "test.csv"), x[400:], y[400:])
    for d in dirs:
        (tmp_path / d).mkdir()


def _module(pkg: str, role: str) -> list[str]:
    return [sys.executable, "-m", f"{pkg}.cli.{role}_runner"]


def _start(cmd, cwd):
    return subprocess.Popen(cmd, cwd=cwd, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(procs: dict) -> dict:
    """{name: (rc, stdout, stderr)}, each process under TIMEOUT; all are
    killed if one hangs."""
    out = {}
    for name, proc in procs.items():
        try:
            o, e = proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
            pytest.fail(f"{name} hung")
        out[name] = (proc.returncode, o, e)
    return out


def _stats(stderr: str, role: str) -> dict:
    tag = f"kafka_ps_tpu_torch {role}: "
    lines = [ln for ln in stderr.splitlines() if ln.startswith(tag)]
    assert lines, stderr[-3000:]
    return json.loads(lines[-1][len(tag):])


def _split(tmp_path, c, iters, worker_ids=("0,1,2,3",), flags=(),
           server_pkg="kafka_ps_tpu_torch",
           worker_pkg="kafka_ps_tpu_torch", worker_flags=()):
    """One server and one process per entry of `worker_ids`, each in its
    own directory; returns {name: (rc, stdout, stderr)}."""
    names = ["server"] + [f"w{i}" for i in range(len(worker_ids))]
    _write_csvs(tmp_path, names)
    port = _free_port()
    procs = {"server": _start(
        _module(server_pkg, "server") + [
            "--listen", str(port), "-training", "../train.csv", "-c",
            str(c), "-p", "1", "--max_iterations", str(iters),
            *COMMON, *flags], tmp_path / "server")}
    for i, ids in enumerate(worker_ids):
        procs[f"w{i}"] = _start(
            _module(worker_pkg, "worker") + [
                "--connect", f"127.0.0.1:{port}", "--worker_ids", ids,
                *COMMON, *flags, *worker_flags], tmp_path / f"w{i}")
    return _finish(procs)


def _logs(tmp_path, n_workers):
    sdf = pd.read_csv(tmp_path / "server" / "logs-server.csv", sep=";")
    wdf = pd.concat([pd.read_csv(tmp_path / f"w{i}" / "logs-worker.csv",
                                 sep=";") for i in range(n_workers)])
    return sdf, wdf


def _check_run(tmp_path, results, c, iters, n_workers):
    for name, (rc, _, err) in results.items():
        assert rc == 0, f"{name} failed (rc={rc}):\n{err[-3000:]}"
    sdf, wdf = _logs(tmp_path, n_workers)
    assert set(wdf["partition"]) == {0, 1, 2, 3}
    assert validate.validate_run(wdf, sdf, consistency_model=c) == []
    assert sdf["fMeasure"].max() > 0.5
    server = _stats(results["server"][2], "server")
    assert server["device"] == "cpu"
    assert server["server_iterations"] == iters
    assert server["membership"]["evictions"] == []
    assert server["dropped_sends"] == 0
    assert server["eval"]["lag_clocks"] == 0
    for i in range(n_workers):
        worker = _stats(results[f"w{i}"][2], "worker")
        rows = pd.read_csv(tmp_path / f"w{i}" / "logs-worker.csv", sep=";")
        assert sum(worker["rows"].values()) == len(rows)
        # on the CPU the plain versions run: no kernel is counted
        assert not any(worker["kernels"].values())
        # a worker's last gradient of the run may meet a closed server
        sent = worker["wire"]["gradients"]["frames_out"]
        assert len(rows) - len(worker["worker_ids"]) <= sent <= len(rows)
    return server


# -- the port's own split runs -------------------------------------------------


@pytest.mark.parametrize("c", [10, -1])
def test_split_bounded_and_eventual(tmp_path, c):
    results = _split(tmp_path, c, 60)
    server = _check_run(tmp_path, results, c, 60, 1)
    wire = server["wire"]
    assert wire["gradients"]["frames_in"] >= 60
    assert wire["input-data-batch"]["frames_out"] >= 1


@pytest.mark.parametrize("coalesce", ["--wire-coalesce",
                                      "--no-wire-coalesce"])
def test_split_two_worker_processes_sequential(tmp_path, coalesce):
    results = _split(tmp_path, 0, 40, worker_ids=("0,1", "2,3"),
                     flags=(coalesce,), worker_flags=("--ready-rows", "20"))
    server = _check_run(tmp_path, results, 0, 40, 2)
    w0 = pd.read_csv(tmp_path / "w0" / "logs-worker.csv", sep=";")
    w1 = pd.read_csv(tmp_path / "w1" / "logs-worker.csv", sep=";")
    assert set(w0["partition"]) == {0, 1}
    assert set(w1["partition"]) == {2, 3}
    # READY waited for 20 rows per buffer
    assert pd.concat([w0, w1])["numTuplesSeen"].min() >= 20
    # the per-frame path has no writer thread to count flushes
    assert (server["writers"]["flushes"] > 0) == (coalesce ==
                                                 "--wire-coalesce")


def test_split_compressed_negotiates_int8(tmp_path):
    results = _split(tmp_path, 2, 40, flags=("--compress", "int8"))
    server = _check_run(tmp_path, results, 2, 40, 1)
    assert server["codec"] == "int8"
    assert _stats(results["w0"][2], "worker")["codec"] == "int8"
    assert "compression: int8 (negotiated)" in results["w0"][2]


@pytest.mark.parametrize("server_pkg,worker_pkg", [
    ("kafka_ps_tpu", "kafka_ps_tpu_torch"),
    ("kafka_ps_tpu_torch", "kafka_ps_tpu")])
def test_split_across_packages(tmp_path, server_pkg, worker_pkg):
    results = _split(tmp_path, 10, 60, server_pkg=server_pkg,
                     worker_pkg=worker_pkg, flags=("--compress", "int8"))
    for name, (rc, _, err) in results.items():
        assert rc == 0, f"{name} failed (rc={rc}):\n{err[-3000:]}"
    sdf, wdf = _logs(tmp_path, 1)
    assert validate.validate_run(wdf, sdf, consistency_model=10) == []
    assert sdf["fMeasure"].max() > 0.5
    assert "compression: int8 (negotiated)" in results["w0"][2]


# -- errors that are not disconnects ---------------------------------------------

# runs a runner with serde.from_bytes raising on the 3rd message of one
# type: argv = [message type, server|worker, runner flags...]
_INJECT = """
import sys
from kafka_ps_tpu_torch.runtime import serde
orig, seen = serde.from_bytes, [0]
def from_bytes(payload, device=None):
    msg = orig(payload, device)
    if type(msg).__name__ == sys.argv[1]:
        seen[0] += 1
        if seen[0] == 3:
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered (injected)")
    return msg
serde.from_bytes = from_bytes
from kafka_ps_tpu_torch.cli import server_runner, worker_runner
main = server_runner.main if sys.argv[2] == "server" else worker_runner.main
sys.exit(main(sys.argv[3:]))
"""


@pytest.mark.parametrize("side", ["server", "worker"])
def test_decode_error_is_not_a_disconnect(tmp_path, side):
    """On the server, no eviction and a non-zero exit (under
    rebalance, where a disconnect would evict); on a worker, exit 1."""
    _write_csvs(tmp_path, ("server", "w0"))
    port = _free_port()
    server_cmd = ["--listen", str(port), "-training", "../train.csv", "-c",
                  "-1", "-p", "1", "--max_iterations", "60",
                  "--failure_policy", "rebalance", *COMMON]
    worker_cmd = ["--connect", f"127.0.0.1:{port}", "--worker_ids", "0,1",
                  *COMMON, "--num_workers", "2"]
    server_cmd += ["--num_workers", "2"]
    inject = [sys.executable, "-c", _INJECT]
    procs = {
        "server": _start(
            (inject + ["GradientMessage", "server"] if side == "server"
             else _module("kafka_ps_tpu_torch", "server")) + server_cmd,
            tmp_path / "server"),
        "w0": _start(
            (inject + ["WeightsMessage", "worker"] if side == "worker"
             else _module("kafka_ps_tpu_torch", "worker")) + worker_cmd,
            tmp_path / "w0")}
    results = _finish(procs)
    rc, _, err = results["server" if side == "server" else "w0"]
    if side == "server":
        assert rc != 0, err[-3000:]
        assert "socket reader failed" in err and "injected" in err
        assert "evicted worker" not in err
        assert _stats(err, "server")["membership"]["evictions"] == []
    else:
        assert rc == 1, err[-3000:]
        assert "worker failed" in err and "injected" in err
        assert _stats(err, "worker")["device"] == "cpu"


# -- crash and restart -------------------------------------------------------


def _log_rows(path) -> int:
    try:
        with open(path) as f:
            return max(0, sum(1 for _ in f) - 1)
    except OSError:
        return 0


def test_split_worker_sigkill_restart_recovers_buffers(tmp_path):
    """Kill -9 one of two worker processes mid-run and restart it with
    the same --checkpoint: it restores the pre-crash buffers from its
    state file, is readmitted, and continues its log."""
    _write_csvs(tmp_path, ("server", "wa", "wb"))
    port = _free_port()
    # no iteration cap: the test interrupts the server (SIGINT = orderly
    # shutdown) once it has SEEN the readmission
    server = _start(_module("kafka_ps_tpu_torch", "server") + [
        "--listen", str(port), "-training", "../train.csv", "-c", "10",
        "-p", "2", "--max_iterations", "0", "--eval_every", "10",
        "--failure_policy", "rebalance", "--heartbeat_timeout", "5",
        *COMMON], tmp_path / "server")
    server_lines: list[str] = []
    threading.Thread(target=lambda: server_lines.extend(server.stderr),
                     daemon=True).start()

    def start_worker(cwd, ids, checkpoint=None):
        cmd = _module("kafka_ps_tpu_torch", "worker") + [
            "--connect", f"127.0.0.1:{port}", "--worker_ids", ids,
            "--state_every", "0.2", *COMMON]
        if checkpoint:
            cmd += ["--checkpoint", checkpoint]
        return _start(cmd, cwd)

    wa = start_worker(tmp_path / "wa", "0,1", checkpoint="job.npz")
    wb = start_worker(tmp_path / "wb", "2,3")
    state_path = tmp_path / "wa" / ckpt.worker_state_path("job.npz", [0, 1])
    log_path = tmp_path / "wa" / "logs-worker.csv"
    procs = (server, wa, wb)
    try:
        deadline = time.monotonic() + 120.0
        while ((_log_rows(log_path) < 6 or not state_path.exists())
               and time.monotonic() < deadline):
            assert server.poll() is None, "".join(server_lines)[-3000:]
            assert wa.poll() is None, wa.communicate()[1][-3000:]
            time.sleep(0.05)
        assert _log_rows(log_path) >= 6 and state_path.exists()
        wa.send_signal(signal.SIGKILL)
        wa.wait(timeout=30)
        pre_rows = _log_rows(log_path)
        with np.load(state_path) as z:
            pre = {w: (int((z[f"buf{w}_ids"] > 0).sum()),
                       int(z[f"buf{w}_ids"].max())) for w in (0, 1)}
        assert all(cnt > 0 for cnt, _ in pre.values())

        wa2 = start_worker(tmp_path / "wa", "0,1", checkpoint="job.npz")
        procs = (server, wa2, wb)
        deadline = time.monotonic() + 120.0

        def readmitted():
            return sum("readmitted worker" in ln for ln in server_lines) == 2

        while ((not readmitted() or _log_rows(log_path) <= pre_rows + 2)
               and time.monotonic() < deadline):
            assert server.poll() is None, "".join(server_lines)[-3000:]
            assert wa2.poll() is None, wa2.communicate()[1][-3000:]
            time.sleep(0.05)
        assert readmitted(), "".join(server_lines)[-3000:]
        assert _log_rows(log_path) > pre_rows + 2
        server.send_signal(signal.SIGINT)
        server.wait(timeout=TIMEOUT)
        _, err_b = wb.communicate(timeout=TIMEOUT)
        _, err_a2 = wa2.communicate(timeout=TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    server_err = "".join(server_lines)
    assert server.returncode == 0, server_err[-3000:]
    assert wb.returncode == 0, err_b[-3000:]
    assert wa2.returncode == 0, err_a2[-3000:]
    # the restarted process restored what the state file held at death
    assert "restored worker buffers" in err_a2
    stats = _stats(err_a2, "worker")
    assert stats["restored"] is True
    assert all(stats["rows_received"][str(w)] >= pre[w][1] for w in (0, 1))
    assert sorted(w for w, _ in _stats(server_err, "server")[
        "membership"]["readmissions"]) == [0, 1]
    # the restarted process appended to the run's log (one run id)
    wdf = pd.read_csv(log_path, sep=";")
    assert len(wdf) > pre_rows


# -- the runners -------------------------------------------------------------


@pytest.mark.parametrize("runner,argv,item", [
    # the read replica (ROADMAP item 21) is ported: what it still refuses
    # is --listen, and running without --durable-log
    pytest.param(server_runner, ["--serve-replica", "--listen", "0",
                                 "--durable-log", "wal"], "standalone",
                 id="kafka_ps_tpu_torch.cli.server_runner-argv0-item 21"),
    (server_runner, ["--listen", "0", "--durable-log", "wal"],
     "--checkpoint"),
    (worker_runner, ["--connect", "127.0.0.1:1", "--durable-log", "wal"],
     "--checkpoint"),
    (server_runner, ["--shards", "2", "--shard-id", "1"], "--listen"),
    (server_runner, ["--listen", "0", "--shards", "2", "--shard-id", "2"],
     "--shard-id"),
    (worker_runner, ["--connect", "127.0.0.1:1", "--aggregate",
                     "127.0.0.1:2"], "exclusive"),
    (server_runner, ["--serve-replica"], "requires --durable-log")])
def test_runners_refuse_what_is_not_ported(runner, argv, item, monkeypatch):
    monkeypatch.setenv("KPS_PLATFORM", "cpu")
    with pytest.raises(SystemExit, match=item):
        runner.main(argv)


@pytest.mark.parametrize("runner,argv,role,check", [
    (server_runner, ["--listen", "0", "--shards", "2", "--shard-id", "1"],
     "run_server_shard", lambda a: (a.shards, a.shard_id) == (2, 1)),
    (server_runner, ["--listen", "0", "--bsp-order"], "run_server",
     lambda a: a.bsp_order and a.shards == 1),
    (server_runner, ["--listen", "0", "--shards", "2", "--bsp-order",
                     "--durable-log", "wal"], "run_server_shard",
     lambda a: a.bsp_order and a.durable_log == "wal"),
    (worker_runner, ["--connect", "127.0.0.1:1,127.0.0.1:2"],
     "_run_worker_sharded",
     lambda a, addrs, aggregate=False: (addrs == ["127.0.0.1:1",
                                                  "127.0.0.1:2"]
                                        and not aggregate)),
    (worker_runner, ["--aggregate", "127.0.0.1:3", "--worker_ids", "2,3"],
     "_run_worker_sharded",
     lambda a, addrs, aggregate=False: (addrs == ["127.0.0.1:3"]
                                        and aggregate
                                        and a.worker_ids == "2,3"))])
def test_runners_start_the_scale_out_roles(runner, argv, role, check,
                                           monkeypatch):
    """--shards, --bsp-order, a comma-separated --connect and --aggregate
    parse and reach the role that serves them."""
    from kafka_ps_tpu_torch.cli import socket_mode
    monkeypatch.setenv("KPS_PLATFORM", "cpu")
    calls = []
    monkeypatch.setattr(socket_mode, role,
                        lambda *a, **kw: calls.append((a, kw)) or 0)
    assert runner.main(argv) == 0
    (args, kw), = calls
    assert check(*args, **kw)


def test_agg_runner_starts_the_relay_role(monkeypatch):
    from kafka_ps_tpu_torch.cli import agg_runner, socket_mode
    calls = []
    monkeypatch.setattr(socket_mode, "run_aggregator",
                        lambda a: calls.append(a) or 0)
    assert agg_runner.main(["--connect", "127.0.0.1:9", "--listen", "7",
                            "--agg-id", "2", "--worker_ids", "0,1",
                            "--summed", "--flush-interval", "0.01"]) == 0
    (a,) = calls
    assert (a.connect, a.listen, a.agg_id, a.worker_ids, a.summed,
            a.flush_interval) == ("127.0.0.1:9", 7, 2, "0,1", True, 0.01)
    with pytest.raises(SystemExit):
        agg_runner.main(["--listen", "7"])        # --connect is required


@pytest.mark.parametrize("runner", [server_runner, worker_runner])
def test_runners_fall_back_to_the_in_process_trainer(runner, tmp_path,
                                                     monkeypatch, capsys):
    x, y = generate(300, 16, 3, seed=1)
    write_csv(str(tmp_path / "train.csv"), x[:240], y[:240])
    write_csv(str(tmp_path / "test.csv"), x[240:], y[240:])
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("KPS_PLATFORM", "cpu")
    argv = ["-test", "test.csv", "--num_features", "16", "--num_classes",
            "3", "--num_workers", "2", "-l", "--mode", "serial",
            "--max_iterations", "12"]
    if runner is server_runner:
        argv += ["-training", "train.csv", "-p", "0"]
    else:
        # the worker role's server-side defaults read ./data/train.csv
        (tmp_path / "data").mkdir()
        write_csv(str(tmp_path / "data" / "train.csv"), x[:240], y[:240])
        argv += ["-min", "8", "-max", "32"]
    assert runner.main(argv) == 0
    assert "kafka_ps_tpu_torch run: " in capsys.readouterr().err
    assert _log_rows(tmp_path / "logs-worker.csv") >= 12


# -- one iteration through the sockets equals one in process --------------------


@pytest.mark.parametrize("task,slab", [("logreg", "f32"), ("mlp", "f32"),
                                       ("logreg", "int8"), ("mlp", "bf16")])
def test_one_round_through_the_bridges_is_bitwise_in_process(task, slab):
    (ref_grads, ref_theta), (grads, theta) = bridge_round("cpu", task,
                                                          slab=slab)
    for a, b in zip(ref_grads, grads):
        assert b.values.device.type == "cpu"
        assert (a.worker_id, a.vector_clock) == (b.worker_id, b.vector_clock)
        assert torch.equal(a.values, b.values)
    assert torch.equal(ref_theta, theta)
    assert theta.abs().sum() > 0
