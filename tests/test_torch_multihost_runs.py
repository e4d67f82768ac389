"""`python -m kafka_ps_tpu_torch.cli.run -r --fused` jobs on the CPU: one
process per rank, joined over gloo through the KPS_* env vars
(parallel/multihost.py), as tests/test_multiprocess.py runs the JAX
package's jobs.  Rank 0 writes the server log, the events log and the
checkpoint; the other ranks write logs-worker.p<rank>.csv.  The logs pass
both packages' validate_run.  --param_shards runs in a job only, one
rank per device (the JAX package runs it in one process instead).  The
refusals keep the JAX CLI's text wherever the rule is the same.

The CLI's producer streams, so theta depends on timing: the numeric
checks against the JAX package are app-level
(tests/test_torch_multidevice.py).
"""

import ast
import os

import numpy as np
import pandas as pd
import pytest
import torch.distributed as dist

from kafka_ps_tpu.evaluation import validate as jvalidate
from kafka_ps_tpu_torch.cli import run as cli_run
from kafka_ps_tpu_torch.data.synth import generate, write_csv
from kafka_ps_tpu_torch.evaluation import validate
from torch_multidevice_runs import free_port, start_cli_job

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"KPS_PLATFORM": "cpu", "OMP_NUM_THREADS": "1"}
ITERS = 24


def _write_csvs(d):
    # one draw, then split: train and test share class geometry
    x, y = generate(390, 16, 3, noise=1.0, sparsity=0.5, seed=0)
    write_csv(os.path.join(d, "train.csv"), x[:300], y[:300])
    write_csv(os.path.join(d, "test.csv"), x[300:], y[300:])


def _args(*extra):
    return ["-training", "train.csv", "-test", "test.csv",
            "--num_features", "16", "--num_classes", "3", "--num_workers",
            "4", "-p", "1", "--fused", "-r", "-l",
            "--local_learning_rate", "0.1", "--max_iterations", str(ITERS),
            *extra]


JOBS = {
    "logreg": (2, _args("--checkpoint", "ckpt.npz", "--checkpoint_every",
                        "8")),
    "mlp": (2, _args("--task", "mlp", "--hidden_dim", "8")),
    "range": (4, _args("--param_shards", "2", "--checkpoint", "ckpt.npz",
                       "--checkpoint_every", "8")),
}
# jobs every rank of which refuses, with the JAX text
REFUSED = {
    "workers3": (2, _args("--num_workers", "3"),
                 "3 active workers must be a multiple of the 2-device mesh "
                 "in --remote mode"),
    "shards4": (2, _args("--param_shards", "4"),
                "--param_shards 4 must divide the device count 2"),
}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The jobs of JOBS and REFUSED, started at once, each in its own
    directory: (directory, every rank's (returncode, stdout, stderr))."""
    started = {}
    for name, (world, args, *_) in {**JOBS, **REFUSED}.items():
        d = str(tmp_path_factory.mktemp(name))
        _write_csvs(d)
        started[name] = (d, start_cli_job(d, world, args, env=ENV))
    out = {}
    for name, (d, job) in started.items():
        done = job.wait()
        for rc, o, e in done:
            assert rc == 0 or name in REFUSED, \
                f"{name}: rc={rc}\n{o[-2000:]}\n{e[-3000:]}"
        out[name] = (d, done)
    return out


def _read(d, name):
    return pd.read_csv(os.path.join(d, name), sep=";")


def _merged(logs):
    """The ranks' worker rows in stamp order, the lower clock first at
    one millisecond (it enabled the higher; the auditor orders ties by
    row order)."""
    return pd.concat(logs).sort_values(["timestamp", "vectorClock"],
                                       kind="stable")


@pytest.mark.parametrize("name", ["logreg", "mlp"])
def test_two_rank_job_logs(jobs, name):
    d, done = jobs[name]
    server = _read(d, "logs-server.csv")
    w0, w1 = _read(d, "logs-worker.csv"), _read(d, "logs-worker.p1.csv")
    assert len(server) >= ITERS // 4
    # rank-major block assignment: rank 0 hosts workers 0 and 1
    assert set(w0["partition"]) == {0, 1}
    assert set(w1["partition"]) == {2, 3}
    # every worker advanced in lockstep: the same clocks everywhere
    worker = _merged([w0, w1])
    clocks = worker.groupby("partition")["vectorClock"].apply(set)
    assert all(c == set(range(1, ITERS // 4 + 1)) for c in clocks)
    # the sequential contract holds across the job, by both auditors
    assert validate.validate_run(worker, server, consistency_model=0) == []
    assert jvalidate.validate_run(worker, server, consistency_model=0) == []
    # learning happened
    assert server["loss"].iloc[-1] < server["loss"].iloc[0]
    for r, (_, _, err) in enumerate(done):
        assert f"multihost: rank {r} of 2 on cpu, backend gloo" in err


@pytest.mark.parametrize("name", ["logreg", "mlp", "range"])
def test_only_rank_zero_writes_the_server_and_events_logs(jobs, name):
    d, done = jobs[name]
    world = len(done)
    want = {"logs-server.csv", "logs-events.csv", "logs-worker.csv"} | {
        f"logs-worker.p{r}.csv" for r in range(1, world)}
    assert {f for f in os.listdir(d) if f.startswith("logs-")} == want
    assert open(os.path.join(d, "logs-events.csv")).read() == \
        "timestamp;event;partition\n"


@pytest.mark.parametrize("name", ["logreg", "range"])
def test_one_checkpoint_writer_and_no_buffers(jobs, name):
    d, _ = jobs[name]
    assert [f for f in os.listdir(d) if f.startswith("ckpt")] == ["ckpt.npz"]
    with np.load(os.path.join(d, "ckpt.npz")) as z:
        assert z["iterations"] >= ITERS
        assert np.abs(z["theta"]).sum() > 0
        assert bool(z["active"].all())
        assert not [k for k in z.files if k.startswith("buf")]


def test_four_rank_param_shards_job(jobs):
    """--param_shards 2 over 4 ranks: a 2 x 2 workers x params mesh, one
    worker a rank; theta's shards assembled in the checkpoint."""
    d, done = jobs["range"]
    server = _read(d, "logs-server.csv")
    logs = [_read(d, "logs-worker.csv")] + [
        _read(d, f"logs-worker.p{r}.csv") for r in range(1, 4)]
    assert [set(w["partition"]) for w in logs] == [{0}, {1}, {2}, {3}]
    worker = _merged(logs)
    assert validate.validate_run(worker, server, consistency_model=0) == []
    assert jvalidate.validate_run(worker, server, consistency_model=0) == []
    assert server["loss"].iloc[-1] < server["loss"].iloc[0]
    with np.load(os.path.join(d, "ckpt.npz")) as z:
        assert z["theta"].shape == (4 * 16 + 4,)   # logreg, unpadded


# -- refusals -------------------------------------------------------------


def _jax_exit_texts() -> set[str]:
    """Every constant message of a SystemExit in the JAX CLI."""
    path = os.path.join(REPO, "kafka_ps_tpu", "cli", "run.py")
    texts = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", None)
                == "SystemExit" and node.args
                and isinstance(node.args[0], ast.Constant)):
            texts.add(node.args[0].value)
    return texts


@pytest.fixture
def csv_dir(tmp_path, monkeypatch):
    _write_csvs(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("KPS_PLATFORM", "cpu")
    for var in ("KPS_COORDINATOR", "KPS_NUM_PROCESSES", "KPS_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    return tmp_path


def _refusal(argv) -> str:
    with pytest.raises(SystemExit) as e:
        cli_run.main(argv)
    assert not dist.is_initialized()      # the CLI left the job
    return str(e.value)


def _one_rank_job(monkeypatch):
    monkeypatch.setenv("KPS_COORDINATOR", f"127.0.0.1:{free_port()}")
    monkeypatch.setenv("KPS_NUM_PROCESSES", "1")
    monkeypatch.setenv("KPS_PROCESS_ID", "0")


@pytest.mark.parametrize("extra,text", [
    ([], "-r joined a multi-host job but only --fused runs over"),
    (["--fused", "--durable-log", "wal"],
     "--durable-log is single-process; a multi-host job"),
    (["--fused", "--serve"], "--serve is single-process: the serving"),
])
def test_job_refusals_keep_the_jax_text(csv_dir, monkeypatch, extra, text):
    _one_rank_job(monkeypatch)
    argv = [a for a in _args(*extra) if a != "--fused"] + (
        ["--fused"] if "--fused" in extra else [])
    msg = _refusal(argv)
    assert msg.startswith(text)
    assert msg in _jax_exit_texts()


def test_param_shards_requires_fused_with_the_jax_text(csv_dir):
    argv = [a for a in _args("--param_shards", "2") if a != "--fused"]
    msg = _refusal(argv)
    assert msg == ("--param_shards requires --fused (the range-sharded "
                   "server is a fused-mesh mode)")
    assert msg in _jax_exit_texts()


@pytest.mark.parametrize("shards", [2, 3])
def test_param_shards_without_a_job_sees_one_device(csv_dir, shards):
    """Where the port and the JAX package differ: without a job the
    port's device count is 1, so any --param_shards > 1 is refused, with
    the JAX text (the JAX CLI counts its process's local devices, 8 in
    these tests, and runs --param_shards 2 in one process)."""
    for argv in (_args("--param_shards", str(shards)),
                 [a for a in _args("--param_shards", str(shards))
                  if a != "-r"]):
        assert _refusal(argv) == (f"--param_shards {shards} must divide "
                                  "the device count 1")


def test_param_shards_help_states_the_difference():
    helps = {a.dest: a.help for a in cli_run.build_parser()._actions}
    assert "only in a -r job" in " ".join(helps["param_shards"].split())


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_job_refusals_of_the_mesh(jobs, name):
    """In a 2-rank job: 3 workers on a 2-device mesh, and --param_shards
    4 on 2 devices, each refused by every rank with the JAX text."""
    _, done = jobs[name]
    for rc, _, err in done:
        assert rc != 0 and err.strip().splitlines()[-1] == REFUSED[name][2]


def test_a_failed_rendezvous_ends_instead_of_hanging(tmp_path):
    """Rank 0 of a 2-rank job whose rank 1 never comes: the group's finite
    timeout ends it non-zero."""
    import subprocess
    import sys
    code = ("from kafka_ps_tpu_torch.parallel import multihost\n"
            f"multihost.initialize('127.0.0.1:{free_port()}', 2, 0, "
            "timeout_s=3)\n")
    env = dict(os.environ, **ENV)
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
