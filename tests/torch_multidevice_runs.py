"""Small torch.distributed jobs of the port's multi-device fused path,
shared by the CPU tests (tests/test_torch_multidevice.py,
tests/test_torch_multihost_runs.py) and chip_smoke.py.  Imports no JAX.

    python tests/torch_multidevice_runs.py CASE RANK WORLD PORT IN OUT

runs CASE as rank RANK of a WORLD-rank job whose rank 0 listens on
127.0.0.1:PORT, reading its inputs from the pickle IN and writing its
result to the pickle OUT.  `start_job` starts every rank of a job so
(`run_job` also gathers their results); `start_cli_job` starts every rank
of a `python -m kafka_ps_tpu_torch.cli.run -r` job through the KPS_* env
vars.
Every process has a timeout, and so has the group (JOB_TIMEOUT_S), so
that a rank that fails ends the job instead of hanging it.

Cases (each joins the job itself, so that `one_rank_bitwise` can run
its reference first, outside any job):
  * `job`: the bsp step and the multi-round chunk over the job's 1-D
    worker mesh, and the range-sharded step and chunk over a
    (world/P) × P mesh, on seeded slabs sharded by each module's
    shard_worker_batches; StreamingPSApp.run_fused_bsp(mesh=) on rows
    fed before the loop, each rank keeping its own workers' rows (the
    app's data filter); a timed all_reduce;
  * `one_rank_bitwise`: the steps and the app run with no job, then in a
    1-rank job, both kept for a bitwise comparison.
"""

from __future__ import annotations

import functools
import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.abspath(__file__)
JOB_TIMEOUT_S = 30.0
PROC_TIMEOUT_S = 150.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(extra: dict | None = None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for var in ("KPS_COORDINATOR", "KPS_NUM_PROCESSES", "KPS_PROCESS_ID"):
        env.pop(var, None)
    env.update(extra or {})
    return env


def _wait(procs, timeout: float) -> list[tuple[int, str, str]]:
    """Every process's (returncode, stdout, stderr); on a timeout all are
    killed and the job raises."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise RuntimeError(f"job did not end within {timeout} s") from None
    return outs


class Job:
    """The ranks of one started job (`start_job`)."""

    def __init__(self, case, procs, outs, timeout):
        self.case, self.procs, self.outs = case, procs, outs
        self.deadline = time.monotonic() + timeout

    def wait(self) -> list[tuple[int, str, str]]:
        """Every rank's (returncode, stdout, stderr)."""
        return _wait(self.procs, max(self.deadline - time.monotonic(), 1.0))

    def results(self) -> list:
        """The ranks' results, in rank order; a rank that failed raises."""
        for r, (rc, out, err) in enumerate(self.wait()):
            if rc != 0:
                raise RuntimeError(f"rank {r} of {self.case} exited {rc}:\n"
                                   f"{out[-2000:]}\n{err[-4000:]}")
        results = []
        for path in self.outs:
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        return results


def start_job(case: str, world: int, inputs: dict, workdir: str,
              env: dict | None = None,
              timeout: float = PROC_TIMEOUT_S) -> Job:
    """Start `case` on every rank of a `world`-rank job, one process
    each, in `workdir`."""
    os.makedirs(workdir, exist_ok=True)
    path_in = os.path.join(workdir, f"{case}-in.pkl")
    with open(path_in, "wb") as f:
        pickle.dump(inputs, f)
    port = free_port()
    outs = [os.path.join(workdir, f"{case}-out{r}.pkl")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, HERE, case, str(r), str(world), str(port), path_in,
         outs[r]], cwd=workdir, env=_env(env), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    return Job(case, procs, outs, timeout)


def run_job(case: str, world: int, inputs: dict, workdir: str,
            env: dict | None = None,
            timeout: float = PROC_TIMEOUT_S) -> list:
    """`start_job`, then its ranks' results."""
    return start_job(case, world, inputs, workdir, env, timeout).results()


def start_cli_job(workdir: str, world: int, args: list[str],
                  env: dict | None = None,
                  timeout: float = PROC_TIMEOUT_S) -> Job:
    """Start every rank of a `python -m kafka_ps_tpu_torch.cli.run` job in
    `workdir`, joined through the KPS_* env vars."""
    port = free_port()
    procs = []
    for r in range(world):
        extra = dict(env or {}, KPS_COORDINATOR=f"127.0.0.1:{port}",
                     KPS_NUM_PROCESSES=str(world), KPS_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kafka_ps_tpu_torch.cli.run", *args],
            cwd=workdir, env=_env(extra), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    return Job("cli.run", procs, [], timeout)


def cli_job(workdir: str, world: int, args: list[str],
            env: dict | None = None,
            timeout: float = PROC_TIMEOUT_S) -> list[tuple[int, str, str]]:
    """`start_cli_job`, then every rank's (returncode, stdout, stderr)."""
    return start_cli_job(workdir, world, args, env, timeout).wait()


# -- the cases (run inside a rank) -------------------------------------------


def _join(rank: int, world: int, port: int) -> None:
    from kafka_ps_tpu_torch.parallel import multihost
    assert multihost.initialize(f"127.0.0.1:{port}", world, rank,
                                timeout_s=JOB_TIMEOUT_S)


def model_config(spec: dict):
    from kafka_ps_tpu_torch.utils.config import ModelConfig
    return ModelConfig(num_features=spec["F"], num_classes=spec["C"],
                       hidden_dim=spec.get("H", 128),
                       local_learning_rate=spec.get("lr", 0.5))


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _steps(inputs: dict, mesh, range_mesh) -> dict:
    """The bsp step and chunk over `mesh`, the range step and chunk over
    `range_mesh` (None: skipped), from the same theta and slabs."""
    from kafka_ps_tpu_torch.models.task import get_task
    from kafka_ps_tpu_torch.ops import fused_update
    from kafka_ps_tpu_torch.parallel import bsp, range_sharded
    from kafka_ps_tpu_torch.utils.config import resolve_device
    cfg = model_config(inputs)
    task = get_task(inputs["task"], cfg)
    dev = resolve_device()
    n, lr, rounds = len(inputs["x"]), inputs["server_lr"], inputs["rounds"]
    theta0 = torch.as_tensor(inputs["theta"]).to(dev)
    slab = (inputs["x"], inputs["y"], inputs["mask"])
    fused_update.reset_counts()
    out = {}
    xs = (bsp.shard_worker_batches(mesh, *slab) if mesh is not None
          else tuple(torch.as_tensor(a).to(dev) for a in slab))
    t, loss = bsp.make_bsp_step(cfg, n, lr, mesh=mesh, task=task)(theta0, *xs)
    out["bsp"] = (_host(t), _host(loss))
    t, losses = bsp.make_bsp_multi_step(cfg, n, lr, rounds, mesh=mesh,
                                        task=task)(theta0, *xs)
    out["bsp_multi"] = (_host(t), _host(losses))
    if range_mesh is not None:
        xs = range_sharded.shard_worker_batches(range_mesh, *slab)
        shard = range_sharded.shard_theta(range_mesh, theta0, task)
        for key, r in (("range", 1), ("range_multi", rounds)):
            step = range_sharded.make_range_sharded_step(
                cfg, n, lr, range_mesh, rounds=r, task=task)
            t, loss = step(shard, *xs)
            full = range_sharded.gather_theta(range_mesh, t)
            out[key] = (_host(full), _host(loss))
    out["counts"] = fused_update.counts()
    return out


class ListSink:
    def __init__(self):
        self.rows: list[str] = []

    def __call__(self, line: str) -> None:
        self.rows.append(line)

    def close(self) -> None:
        pass


def dataset(spec: dict):
    """(rows as {feature: value} dicts with labels, test x, test y) from
    the port's synth generator (the JAX package's, line for line)."""
    return _dataset(spec["n_train"], spec["n_test"], spec["F"], spec["C"],
                    spec["seed"])


@functools.lru_cache(maxsize=4)
def _dataset(n_train: int, n_test: int, features: int, classes: int,
             seed: int):
    # a process's runs share one copy: 4096 rows of 1024 features take
    # seconds to turn into dicts, and the rows are only read
    from kafka_ps_tpu_torch.data.synth import generate
    x, y = generate(n_train + n_test, features, classes, noise=1.0,
                    sparsity=0.5, seed=seed)
    rows = [({j: float(v) for j, v in enumerate(r) if v != 0.0}, int(lbl))
            for r, lbl in zip(x[:n_train], y[:n_train])]
    return rows, x[n_train:], y[n_train:]


def _app_run(spec: dict, mesh) -> dict:
    """run_fused_bsp(mesh=) on rows fed before the loop (a fixed arrival
    clock, so that every package picks the same buffer slots)."""
    from kafka_ps_tpu_torch.ops import fused_update
    from kafka_ps_tpu_torch.parallel import multihost
    from kafka_ps_tpu_torch.parallel.mesh import in_job
    from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
    from kafka_ps_tpu_torch.utils.config import BufferConfig, PSConfig
    rows, tx, ty = dataset(spec)
    cfg = PSConfig(num_workers=spec["workers"], task=spec["task"],
                   model=model_config(spec),
                   buffer=BufferConfig(min_size=8, max_size=spec["buffer"]),
                   eval_every=spec["eval_every"])
    server, worker = ListSink(), ListSink()
    app = StreamingPSApp(cfg, test_x=tx, test_y=ty, server_log=server,
                         worker_log=worker,
                         clock_ms=iter(range(0, 10 ** 9, 40)).__next__)
    if spec.get("theta") is not None:
        app.server.theta = torch.as_tensor(spec["theta"]).to(app.device)
    active = app.server.tracker.active_workers
    if in_job(mesh):
        app.local_workers = {active[i] for i in multihost.local_worker_ids(
            len(active), mesh)}
    starve = spec.get("starve")          # a worker whose rows are dropped
    for i, (feats, label) in enumerate(rows):
        if i % cfg.num_workers != starve:
            app.data_sink(i % cfg.num_workers, feats, label)
    fused_update.reset_counts()
    t0 = time.perf_counter()
    app.run_fused_bsp(spec["iters"], mesh=mesh)
    seconds = time.perf_counter() - t0
    app.close_logs()
    return {"theta": _host(app.server.theta), "server": server.rows,
            "worker": worker.rows, "fused": dict(app.fused_stats),
            "counts": fused_update.counts(), "seconds": seconds,
            "iterations": app.server.iterations}


def _mesh_of(spec):
    from kafka_ps_tpu_torch.parallel import mesh as mesh_mod
    p = spec.get("param_shards", 1)
    if p == 1:
        return mesh_mod.worker_mesh()
    return mesh_mod.worker_param_mesh(mesh_mod.device_count() // p, p)


def allreduce_ms(numel: int, reps: int = 20) -> list[float]:
    """Milliseconds of each of `reps` all_reduces of `numel` float32 over
    the job's default group, on this rank's device, on the host clock
    around a synchronised call (the fused round's reduction at that
    width), after one untimed call."""
    import torch.distributed as dist

    from kafka_ps_tpu_torch.utils.config import resolve_device
    dev = resolve_device()
    t = torch.ones(numel, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    dist.all_reduce(t)
    sync()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        dist.all_reduce(t)
        sync()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def case_job(rank, world, port, inputs) -> dict:
    """In the job: `_steps` of every entry of inputs["cases"] over its
    worker mesh and its (world/P) × P mesh, P = inputs["param_shards"];
    then `_app_run` of every entry of inputs["runs"], each over its mesh;
    then, with inputs["allreduce_numel"], the timed all_reduces of that
    width (`allreduce_ms`)."""
    from kafka_ps_tpu_torch.parallel import mesh as mesh_mod
    _join(rank, world, port)
    out = {"steps": [], "app": [], "allreduce_ms": None}
    if inputs.get("cases"):
        p = inputs["param_shards"]
        mesh = mesh_mod.worker_mesh()
        range_mesh = mesh_mod.worker_param_mesh(world // p, p)
        out["steps"] = [_steps(c, mesh, range_mesh)
                        for c in inputs["cases"]]
    out["app"] = [_app_run(spec, _mesh_of(spec))
                  for spec in inputs.get("runs", [])]
    if inputs.get("allreduce_numel"):
        out["allreduce_ms"] = allreduce_ms(inputs["allreduce_numel"])
    return out


def case_one_rank_bitwise(rank, world, port, inputs) -> dict:
    """The steps and the app without a job (mesh None, after one
    untimed app run), then the same in a 1-rank job (its 1-D worker
    mesh, a real group)."""
    from kafka_ps_tpu_torch.parallel import mesh as mesh_mod
    _app_run(inputs["app"], None)       # a warm-up: loads, first calls
    out = {"none": {"steps": _steps(inputs["steps"], None, None),
                    "app": _app_run(inputs["app"], None)}}
    _join(rank, world, port)
    mesh = mesh_mod.worker_mesh()
    out["job"] = {"steps": _steps(inputs["steps"], mesh, None),
                  "app": _app_run(inputs["app"], mesh)}
    return out


CASES = {"job": case_job, "one_rank_bitwise": case_one_rank_bitwise}


def main(argv: list[str]) -> int:
    case, rank, world, port, path_in, path_out = argv
    sys.path.insert(0, REPO)
    with open(path_in, "rb") as f:
        inputs = pickle.load(f)
    from kafka_ps_tpu_torch.parallel import multihost
    try:
        result = CASES[case](int(rank), int(world), int(port), inputs)
    finally:
        multihost.shutdown()
    with open(path_out, "wb") as f:
        pickle.dump(result, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
