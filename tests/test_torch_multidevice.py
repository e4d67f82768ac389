"""The port's multi-device fused path on the CPU: parallel/mesh.py,
parallel/multihost.py, parallel/range_sharded.py, bsp.py's mesh branch
and StreamingPSApp.run_fused_bsp(mesh=), in gloo jobs whose ranks the
tests spawn (tests/torch_multidevice_runs.py, one process per rank),
against the JAX package's mesh versions in this process (8 virtual CPU
devices, tests/conftest.py) on the same numpy inputs.

Tolerances: against the JAX package, theta and losses rtol 1e-4, atol
1e-5 (float32 summed in other orders: XLA's psum against gloo's
all_reduce; as tests/test_torch_parallel.py), F1 and accuracy within
1/len(test); row keys exactly.  Inside the port the ranks of a job hold
the same theta bit for bit, and a 1-rank job is bitwise no job.
"""

import ast
import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kafka_ps_tpu.models.task import get_task as jget_task
from kafka_ps_tpu.parallel import bsp as jbsp
from kafka_ps_tpu.parallel import mesh as jmesh
from kafka_ps_tpu.parallel import multihost as jmultihost
from kafka_ps_tpu.parallel import range_sharded as jrange
from kafka_ps_tpu.runtime.app import StreamingPSApp as JApp
from kafka_ps_tpu.utils import config as jconfig
from kafka_ps_tpu_torch.parallel import bsp, mesh, multihost, range_sharded
from kafka_ps_tpu_torch.utils.config import ModelConfig
from kafka_ps_tpu_torch.weights import from_jax_params
from torch_multidevice_runs import dataset, start_job

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
F, C, H = 16, 3, 12
ENV = {"KPS_PLATFORM": "cpu", "OMP_NUM_THREADS": "1"}
STEP_WORKERS, CAP, ROUNDS = 8, 16, 3


def _step_inputs(task: str, seed: int) -> dict:
    """Seeded numpy slabs [8, 16, F] with masked rows and one
    out-of-range label, and a seeded theta."""
    from kafka_ps_tpu.data.synth import generate
    cfg = jconfig.ModelConfig(num_features=F, num_classes=C, hidden_dim=H)
    n = jget_task(task, cfg).num_params
    rng = np.random.default_rng(seed)
    x, y = generate(STEP_WORKERS * CAP, F, C, noise=1.0, sparsity=0.5,
                    seed=seed)
    y[7] = C + 2
    mask = (rng.random(STEP_WORKERS * CAP) < 0.85).astype(np.float32)
    return {"task": task, "F": F, "C": C, "H": H, "lr": 0.5,
            "theta": rng.normal(scale=0.2, size=n).astype(np.float32),
            "x": x.reshape(STEP_WORKERS, CAP, F),
            "y": y.reshape(STEP_WORKERS, CAP),
            "mask": mask.reshape(STEP_WORKERS, CAP),
            "server_lr": 1.0 / STEP_WORKERS, "rounds": ROUNDS}


STEP_CASES = [_step_inputs("logreg", 3), _step_inputs("mlp", 4)]


@functools.lru_cache(maxsize=None)
def _jax_steps(case: int, world: int, param_shards: int) -> dict:
    """The JAX package's bsp step and scan on worker_mesh(world), and its
    range-sharded step and scan on worker_param_mesh(world/P, P), for
    STEP_CASES[case]."""
    case = STEP_CASES[case]
    cfg = jconfig.ModelConfig(num_features=F, num_classes=C, hidden_dim=H,
                              local_learning_rate=0.5)
    task = jget_task(case["task"], cfg)
    n, lr = STEP_WORKERS, case["server_lr"]
    theta = jnp.asarray(case["theta"])
    slab = (case["x"], case["y"], case["mask"])
    m = jmesh.worker_mesh(world)
    xs = jbsp.shard_worker_batches(m, *slab)
    out = {"bsp": jbsp.make_bsp_step(cfg, n, lr, mesh=m, task=task)(
        theta, *xs)}
    out["bsp_multi"] = jbsp.make_bsp_multi_step(
        cfg, n, lr, ROUNDS, mesh=m, task=task)(theta, *xs)
    rm = jmesh.worker_param_mesh(world // param_shards, param_shards)
    xs = jrange.shard_worker_batches(rm, *slab)
    shard = jrange.shard_theta(rm, theta, task)
    for key, r in (("range", 1), ("range_multi", ROUNDS)):
        out[key] = jrange.make_range_sharded_step(cfg, n, lr, rm, rounds=r,
                                                  task=task)(shard, *xs)
    return {k: (np.asarray(t), np.asarray(loss))
            for k, (t, loss) in out.items()}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every job of this file, started at once: the steps and the app
    runs over 2 ranks (a 1 x 2 range mesh), the steps over 4 ranks
    (2 x 2), and the 1-rank job beside no job."""
    specs = _app_specs()
    started = {
        world: start_job("job", world,
                         {"cases": STEP_CASES, "param_shards": 2,
                          "runs": specs if world == 2 else []},
                         str(tmp_path_factory.mktemp(f"job{world}")),
                         env=ENV)
        for world in (2, 4)}
    started["one"] = start_job(
        "one_rank_bitwise", 1,
        {"steps": STEP_CASES[0],
         "app": dict(APP_BASE, task="logreg", eval_every=4,
                     param_shards=1)},
        str(tmp_path_factory.mktemp("one")), env=ENV)
    out = {key: job.results() for key, job in started.items()}
    out["specs"] = specs
    return out


@pytest.fixture(scope="module")
def step_jobs(jobs):
    return {world: [r["steps"] for r in jobs[world]] for world in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", [0, 1], ids=["logreg", "mlp"])
@pytest.mark.parametrize("key", ["bsp", "bsp_multi", "range",
                                 "range_multi"])
def test_steps_match_the_jax_mesh_versions(step_jobs, world, case, key):
    ref = _jax_steps(case, world, 2)[key]
    ranks = [r[case][key] for r in step_jobs[world]]
    for theta, loss in ranks:
        np.testing.assert_allclose(theta, ref[0], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(loss, ref[1], rtol=RTOL, atol=ATOL)
    # every rank holds the same bits
    for theta, loss in ranks[1:]:
        assert np.array_equal(theta, ranks[0][0])
        assert np.array_equal(loss, ranks[0][1])


# -- the app ----------------------------------------------------------------


APP_RUNS = [
    {"task": "logreg", "eval_every": 1, "param_shards": 1},
    {"task": "mlp", "eval_every": 10, "param_shards": 1},
    {"task": "logreg", "eval_every": 10, "param_shards": 2},
]
APP_BASE = {"F": F, "C": C, "H": H, "lr": 0.5, "workers": 4, "buffer": 32,
            "n_train": 200, "n_test": 60, "seed": 0, "iters": 96}


def _japp(spec: dict):
    rows, tx, ty = dataset(spec)
    cfg = jconfig.PSConfig(
        num_workers=spec["workers"], task=spec["task"],
        model=jconfig.ModelConfig(num_features=F, num_classes=C,
                                  hidden_dim=H, local_learning_rate=0.5),
        buffer=jconfig.BufferConfig(min_size=8, max_size=spec["buffer"]),
        eval_every=spec["eval_every"], use_gang=False, eval_async=False)
    server, worker = [], []
    app = JApp(cfg, test_x=tx, test_y=ty, server_log=server.append,
               worker_log=worker.append,
               clock_ms=iter(range(0, 10 ** 9, 40)).__next__)
    for i, (feats, label) in enumerate(rows):
        app.data_sink(i % cfg.num_workers, feats, label)
    return app, server, worker, ty


def _app_specs():
    specs = []
    for run in APP_RUNS:
        spec = dict(APP_BASE, **run)
        japp = _japp(spec)[0]
        spec["theta"] = from_jax_params(
            np.asarray(japp.server.theta),
            ModelConfig(num_features=F, num_classes=C, hidden_dim=H),
            "cpu", task=spec["task"]).numpy()
        specs.append(spec)
    return specs


@pytest.fixture(scope="module")
def app_job(jobs):
    return jobs["specs"], [r["app"] for r in jobs[2]]


def _row_values(row):
    return row.split(";")


@pytest.mark.parametrize("run", range(len(APP_RUNS)),
                         ids=["logreg", "mlp-every10", "logreg-range1x2"])
def test_run_fused_bsp_over_two_ranks_matches_jax(app_job, run):
    specs, ranks = app_job
    spec = specs[run]
    japp, js, jw, ty = _japp(spec)
    p = spec["param_shards"]
    m = jmesh.worker_mesh(2) if p == 1 else jmesh.worker_param_mesh(1, p)
    japp.run_fused_bsp(spec["iters"], mesh=m)
    japp.flush_logs()
    outs = [r[run] for r in ranks]
    # the ranks' thetas bitwise, and within tolerance of the JAX one
    for out in outs:
        assert np.array_equal(out["theta"], outs[0]["theta"])
        assert out["iterations"] == spec["iters"]
    np.testing.assert_allclose(outs[0]["theta"], np.asarray(
        japp.server.theta), rtol=RTOL, atol=ATOL)
    # rank 0 writes the server rows, each rank its own workers' rows
    assert outs[1]["server"] == []
    assert {_row_values(r)[1] for r in outs[0]["worker"]} == {"0", "1"}
    assert {_row_values(r)[1] for r in outs[1]["worker"]} == {"2", "3"}
    tw = sorted((_row_values(r) for o in outs for r in o["worker"]),
                key=lambda r: (int(r[2]), int(r[1])))
    ts = [_row_values(r) for r in outs[0]["server"]]
    js, jw = ([_row_values(r) for r in rows] for rows in (js, jw))
    assert [r[1:3] for r in ts] == [r[1:3] for r in js]
    assert [r[1:3] + r[6:] for r in tw] == [r[1:3] + r[6:] for r in jw]
    tol = 1.0 / len(ty)
    for ours, ref in zip(ts + tw, js + jw):
        np.testing.assert_allclose(float(ours[3]), float(ref[3]),
                                   rtol=RTOL, atol=ATOL)
        assert abs(float(ours[4]) - float(ref[4])) <= tol
        assert abs(float(ours[5]) - float(ref[5])) <= tol
    rounds = spec["iters"] // spec["workers"]
    for out in outs:
        assert out["fused"]["rounds"] == rounds


def test_a_rank_without_data_ends_the_job(tmp_path):
    """Rank 1's worker 2 gets no rows: rank 1 raises the reference's error
    and exits, and rank 0, left alone in its all-reduce, exits non-zero
    too instead of hanging."""
    spec = dict(APP_BASE, task="logreg", eval_every=1, param_shards=1,
                starve=2, iters=8)
    done = start_job("job", 2, {"runs": [spec]}, str(tmp_path), env=ENV,
                     timeout=90).wait()
    assert [rc != 0 for rc, _, _ in done] == [True, True]
    assert "There is no data in the buffer of worker 2" in done[1][2]


# -- one rank ---------------------------------------------------------------


@pytest.fixture(scope="module")
def one_rank(jobs):
    return jobs["one"][0]


@pytest.mark.parametrize("key", ["bsp", "bsp_multi"])
def test_a_one_rank_job_is_bitwise_no_job_steps(one_rank, key):
    none, job = one_rank["none"]["steps"][key], one_rank["job"]["steps"][key]
    assert np.array_equal(none[0], job[0])
    assert np.array_equal(none[1], job[1])


def test_a_one_rank_job_is_bitwise_no_job_app(one_rank):
    none, job = one_rank["none"]["app"], one_rank["job"]["app"]
    assert np.array_equal(none["theta"], job["theta"])
    strip = (lambda rows: [r.split(";", 1)[1] for r in rows])
    assert strip(none["server"]) == strip(job["server"]) != []
    assert strip(none["worker"]) == strip(job["worker"]) != []
    assert none["counts"] == job["counts"]


# -- in this process: meshes, blocks, pads and refusals ----------------------


def test_without_a_job_meshes_are_one_local_rank():
    assert mesh.device_count() == 1
    m = mesh.worker_mesh()
    assert isinstance(m, mesh.LocalMesh) and not mesh.in_job(m)
    assert mesh.axes(m) == {"workers": 1}
    assert mesh.axes(mesh.worker_param_mesh(1, 1)) == {"workers": 1,
                                                       "params": 1}
    assert multihost.global_worker_mesh().size() == 1
    assert multihost.local_worker_ids(6) == list(range(6))


@pytest.mark.parametrize("shape", [(2,), (1, 2), (3, 1)])
def test_a_mesh_larger_than_the_job_is_refused_with_the_jax_text(shape):
    build = mesh.worker_mesh if len(shape) == 1 else mesh.worker_param_mesh
    need = int(np.prod(shape))
    with pytest.raises(ValueError, match=f"^need {need} devices, have 1$"):
        build(*shape)
    # the JAX package's text, for its 8 devices
    with pytest.raises(ValueError, match="^need 9 devices, have 8$"):
        jmesh.worker_param_mesh(3, 3)


def test_initialize_is_a_noop_without_config(monkeypatch):
    for var in ("KPS_COORDINATOR", "KPS_NUM_PROCESSES", "KPS_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False
    assert jmultihost.initialize() is False


def test_initialize_needs_the_whole_config(monkeypatch):
    monkeypatch.setenv("KPS_NUM_PROCESSES", "2")
    monkeypatch.delenv("KPS_COORDINATOR", raising=False)
    with pytest.raises(ValueError, match="KPS_COORDINATOR"):
        multihost.initialize()


class _Devices:
    """A JAX mesh of fake devices, `per` to a process, for
    jmultihost.local_worker_ids."""

    def __init__(self, procs, per):
        self.devices = np.array([type("D", (), {"process_index": p})()
                                 for p in range(procs) for _ in range(per)])


class _Ranks:
    """A job's mesh of `n` ranks for multihost.local_worker_ids."""

    def __init__(self, n):
        self.n = n

    def size(self):
        return self.n


@pytest.mark.parametrize("procs,per,workers", [
    (2, 1, 4), (2, 2, 4), (4, 1, 8), (2, 2, 8), (3, 1, 6)])
def test_local_worker_ids_are_the_jax_block_lists(monkeypatch, procs, per,
                                                  workers):
    """A JAX process owning `per` devices hosts the workers of the port's
    `per` ranks at the same mesh positions."""
    for proc in range(procs):
        monkeypatch.setattr(jax, "process_index", lambda p=proc: p)
        want = jmultihost.local_worker_ids(workers, _Devices(procs, per))
        got = []
        for rank in range(proc * per, (proc + 1) * per):
            monkeypatch.setattr(multihost, "process_index",
                                lambda r=rank: r)
            got += multihost.local_worker_ids(workers, _Ranks(procs * per))
        assert got == want


def test_local_worker_ids_refuse_an_indivisible_count():
    with pytest.raises(ValueError) as ours:
        multihost.local_worker_ids(5, _Ranks(2))
    with pytest.raises(ValueError) as ref:
        jmultihost.local_worker_ids(5, _Devices(2, 1))
    assert str(ours.value) == str(ref.value)


LAYOUT = ModelConfig(num_features=32, num_classes=5)    # 198 params


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_padding_round_trips_like_jax(shards):
    theta = np.arange(LAYOUT.num_params, dtype=np.float32)
    padded = range_sharded.pad_theta(torch.from_numpy(theta), LAYOUT, shards)
    jpadded = np.asarray(jrange.pad_theta(theta, LAYOUT, shards))
    assert range_sharded.padded_num_params(LAYOUT, shards) == \
        jrange.padded_num_params(LAYOUT, shards) == len(jpadded)
    assert np.array_equal(padded.numpy(), jpadded)
    assert np.array_equal(range_sharded.unshard_theta(padded, LAYOUT).numpy(),
                          theta)


def test_a_pad_leak_raises_the_jax_error():
    padded = np.zeros(range_sharded.padded_num_params(LAYOUT, 8), np.float32)
    padded[LAYOUT.num_params + 1] = 0.5
    with pytest.raises(ValueError) as ours:
        range_sharded.unshard_theta(torch.from_numpy(padded), LAYOUT)
    with pytest.raises(ValueError) as ref:
        jrange.unshard_theta(padded, LAYOUT)
    assert str(ours.value) == str(ref.value)
    assert "leaked into the shard pad region: key 199" in str(ours.value)


def test_a_clean_pad_and_no_pad_are_accepted():
    for n in (LAYOUT.num_params, LAYOUT.num_params + 5):
        theta = np.zeros(n, np.float32)
        theta[:LAYOUT.num_params] = 1.0
        range_sharded.assert_pad_clean(torch.from_numpy(theta), LAYOUT)
        jrange.assert_pad_clean(theta, LAYOUT)


class _Mesh2x2(mesh.LocalMesh):
    """A stand-in 2 x 2 mesh: the checks run before any collective."""

    def __init__(self, names=("workers", "params")):
        super().__init__(names)
        self.shape = (2,) * len(names)

    def size(self, mesh_dim=None):
        return int(np.prod(self.shape))


def test_range_step_refusals_keep_the_jax_text():
    with pytest.raises(ValueError) as ours:
        range_sharded.make_range_sharded_step(LAYOUT, 4, 0.25,
                                              mesh.worker_mesh())
    with pytest.raises(ValueError) as ref:
        jrange.make_range_sharded_step(LAYOUT, 4, 0.25, jmesh.worker_mesh(1))
    assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError) as ours:
        range_sharded.make_range_sharded_step(LAYOUT, 6, 0.25, _Mesh2x2())
    with pytest.raises(ValueError) as ref:
        jrange.make_range_sharded_step(LAYOUT, 6, 0.25,
                                       jmesh.worker_param_mesh(2, 2))
    assert str(ours.value) == str(ref.value)


class _JobMesh:
    """A stand-in 1-D mesh of a 2-rank job: the check runs before any
    collective."""

    mesh_dim_names, shape = ("workers",), (2,)

    def size(self, mesh_dim=None):
        return 2


def test_bsp_divisibility_keeps_the_jax_text():
    with pytest.raises(ValueError) as ours:
        bsp.make_bsp_step(LAYOUT, 3, 0.25, mesh=_JobMesh())
    with pytest.raises(ValueError) as ref:
        jbsp.make_bsp_step(jconfig.ModelConfig(num_features=32,
                                               num_classes=5), 3, 0.25,
                           mesh=jmesh.worker_mesh(2))
    assert str(ours.value) == str(ref.value) == \
        "num_workers 3 must be a multiple of mesh size 2"


def test_one_local_rank_runs_the_one_device_branch():
    """A LocalMesh is the one-device branch: the chunk keeps its CUDA
    graph on the card (graph=True) and the step adds no collective."""
    multi = bsp.make_bsp_multi_step(LAYOUT, 4, 0.25, 8,
                                    mesh=mesh.worker_mesh())
    assert multi.graph is True
    assert bsp.make_bsp_multi_step(LAYOUT, 4, 0.25, 8).graph is True


def test_the_job_mesh_module_sources_name_their_jax_counterparts():
    for name in ("mesh", "multihost", "range_sharded"):
        path = os.path.join(REPO, "kafka_ps_tpu_torch", "parallel",
                            f"{name}.py")
        doc = ast.get_docstring(ast.parse(open(path).read()))
        assert re.search(rf"kafka_ps_tpu/parallel/{name}\.py", doc)


def test_global_slabs_and_unreplicate_without_a_job():
    """Outside a job the rank's block is every worker: the global slabs,
    bsp's and range_sharded's blocks are the stacked slabs, on the CPU
    under KPS_PLATFORM=cpu, and unreplicate gives them back."""
    case = STEP_CASES[0]
    slab = (case["x"], case["y"], case["mask"])
    got = [multihost.shard_worker_batches_global(None, *slab, device="cpu"),
           bsp.shard_worker_batches(mesh.worker_mesh(), *slab, device="cpu"),
           range_sharded.shard_worker_batches(mesh.worker_param_mesh(1, 1),
                                              *slab, device="cpu")]
    for tensors in got:
        for t, a in zip(tensors, slab):
            assert t.device.type == "cpu"
            assert np.array_equal(multihost.unreplicate(t), a)
