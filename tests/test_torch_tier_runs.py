"""Runs of the port under tiered residency (store/) on the CPU:

  * app-level capped ≡ resident, bitwise (theta and the rows without
    their timestamps), at -c 0/2/-1 for logreg and the MLP (H=16), with
    the async eval engine and with the fused eval; the policy thread
    runs every 2 ms, so its timing varies while the bits may not;
  * the port's capped run against the JAX package's capped run: row
    keys exact, theta within rtol 1e-4 and atol 1e-5;
  * a top-k ShardedServerGroup: sparse slices applied per page ≡ the
    resident group, and N=2 capped ≡ N=2 uncapped (dense);
  * tiered checkpoints crossing between the packages in both directions,
    the residency included;
  * the CLI's checks of the --tier-* flags, with the JAX messages, and
    one `cli.run` capped/uncapped pair by subprocess with equal CSVs.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from kafka_ps_tpu.cli import run as jrun
from kafka_ps_tpu.runtime.app import StreamingPSApp as JApp
from kafka_ps_tpu.utils import checkpoint as jckpt
from kafka_ps_tpu.utils import config as jconfig
from kafka_ps_tpu_torch.cli import run as run_mod
from kafka_ps_tpu_torch.cli import server_runner
from kafka_ps_tpu_torch.data.buffer import SlidingBuffer
from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime.app import StreamingPSApp
from kafka_ps_tpu_torch.runtime.sharding import ShardedServerGroup
from kafka_ps_tpu_torch.runtime.worker import WorkerNode
from kafka_ps_tpu_torch.store import TIER_COLD, ColdStore, TieredParamStore
from kafka_ps_tpu_torch.utils import checkpoint as ckpt
from kafka_ps_tpu_torch.utils import config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
EVENTUAL = -1


class ListSink:
    def __init__(self):
        self.rows = []

    def __call__(self, line: str) -> None:
        self.rows.append(line)

    def close(self) -> None:
        pass


def _strip(rows):
    return [r.split(";")[1:] for r in rows]


def _keys(rows):
    return [tuple(r.split(";")[1:3]) for r in rows]


# logreg: 3*8+3 = 27 params, pages of 2 -> 14 pages; the MLP at H=16:
# 8*16+16+16*3+3 = 195 params, pages of 8 -> 25 pages.  Two pages hot and
# three warm: most of theta lives cold.
PAGE = {"logreg": 2, "mlp": 8}


def _tier(mod, task):
    p = PAGE[task]
    return mod.TierConfig(hot_bytes=2 * p * 4, warm_bytes=3 * p * 4,
                          page_params=p, rebalance_interval_s=0.002)


def _cfg(mod, consistency, task="logreg", tier=None, **kw):
    return mod.PSConfig(
        num_workers=2, consistency_model=consistency, task=task,
        model=mod.ModelConfig(num_features=8, num_classes=2, hidden_dim=16),
        buffer=mod.BufferConfig(min_size=8, max_size=32),
        stream=mod.StreamConfig(time_per_event_ms=1.0),
        tier=tier or mod.TierConfig(), **kw)


def _dataset(n=128, f=8, seed=3):
    rng = np.random.default_rng(seed)
    y = rng.integers(1, 3, size=n).astype(np.int32)
    centers = np.array([[0.0] * f, [2.0] * f, [-2.0] * f], np.float32)
    x = (centers[y] + rng.normal(scale=0.5, size=(n, f))).astype(np.float32)
    return x, y


def _feed(app, x, y, workers=2):
    for i in range(len(x)):
        app.data_sink(i % workers, {j: float(v) for j, v in enumerate(x[i])
                                    if v != 0}, int(y[i]))


def _run(consistency, task="logreg", tmp_path=None, capped=False,
         iters=20, **kw):
    """A serial port run; returns (theta bytes, server rows, worker rows,
    the store's stats or None)."""
    tier = _tier(config, task) if capped else None
    x, y = _dataset()
    ssink, wsink = ListSink(), ListSink()
    app = StreamingPSApp(_cfg(config, consistency, task, tier, **kw),
                         test_x=x, test_y=y, server_log=ssink,
                         worker_log=wsink, device="cpu")
    if capped:
        store = app.enable_tiering(str(tmp_path / f"cold-{task}-"
                                       f"{consistency}"))
        assert store is app.server.param_store is not None
    _feed(app, x, y)
    app.run_serial(max_server_iterations=iters)
    theta = app.server.theta.numpy().tobytes()
    stats = app.server.param_store.stats() if capped else None
    app.close_tiering()
    app.close_logs()
    return theta, _strip(ssink.rows), _strip(wsink.rows), stats


@pytest.mark.parametrize("task", ["logreg", "mlp"])
@pytest.mark.parametrize("consistency", [0, 2, EVENTUAL])
def test_capped_run_bitwise_equals_resident(tmp_path, task, consistency):
    base = _run(consistency, task)
    capped = _run(consistency, task, tmp_path, capped=True)
    assert capped[0] == base[0]
    assert capped[1] == base[1] and capped[2] == base[2]
    assert len(base[1]) > 0
    # pages were faulted in from the log and demoted to it again while
    # the run applied (the final theta read faults every cold page warm)
    st = capped[3]
    assert st["faults"] > 0 and st["cold_reads"] > 0
    assert st["demotions"] > 0 and st["cold_appends"] > 0


@pytest.mark.parametrize("consistency", [0, EVENTUAL])
def test_capped_run_with_the_fused_eval_is_bitwise(tmp_path, consistency):
    """--no-gang --no-eval-async: the eval apply runs the resident
    path's fused apply and evaluation on the assembled slice."""
    base = _run(consistency, "logreg", use_gang=False, eval_async=False)
    capped = _run(consistency, "logreg", tmp_path, capped=True,
                  use_gang=False, eval_async=False)
    assert capped[:3] == base[:3]


def _jax_run(consistency, task, tmp_path):
    x, y = _dataset()
    ssink, wsink = ListSink(), ListSink()
    app = JApp(_cfg(jconfig, consistency, task, _tier(jconfig, task)),
               test_x=x, test_y=y, server_log=ssink, worker_log=wsink)
    app.enable_tiering(str(tmp_path / f"jax-cold-{task}-{consistency}"))
    _feed(app, x, y)
    app.run_serial(max_server_iterations=20)
    theta = np.asarray(app.server.theta).copy()
    app.close_tiering()
    app.close_eval()
    for s in (app.server.log, *{id(w.log): w.log
                                for w in app.workers}.values()):
        getattr(s, "flush", lambda: None)()
    return theta, ssink.rows, wsink.rows


@pytest.mark.parametrize("task,consistency", [("logreg", 0),
                                              ("logreg", 2),
                                              ("mlp", EVENTUAL)])
def test_capped_run_matches_the_jax_capped_run(tmp_path, task, consistency):
    jtheta, jserver, jworker = _jax_run(consistency, task, tmp_path)
    x, y = _dataset()
    ssink, wsink = ListSink(), ListSink()
    app = StreamingPSApp(_cfg(config, consistency, task,
                              _tier(config, task)),
                         test_x=x, test_y=y, server_log=ssink,
                         worker_log=wsink, device="cpu")
    app.enable_tiering(str(tmp_path / f"cold-{task}-{consistency}"))
    if task == "mlp":
        # the same initial weights (the packages draw them differently)
        from kafka_ps_tpu_torch.weights import from_jax_params
        from kafka_ps_tpu.models.task import get_task as jget_task
        jcfg = _cfg(jconfig, consistency, task)
        app.server.theta = from_jax_params(
            np.asarray(jget_task(task, jcfg.model).init_params()),
            app.cfg.model, "cpu", task="mlp")
    _feed(app, x, y)
    app.run_serial(max_server_iterations=20)
    theta = app.server.theta.numpy()
    app.close_tiering()
    app.close_logs()
    assert _keys(ssink.rows) == _keys(jserver)
    assert _keys(wsink.rows) == _keys(jworker)
    np.testing.assert_allclose(theta, jtheta, rtol=RTOL, atol=ATOL)


# -- range-sharded groups --------------------------------------------------


def _gdata(n=128, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32) + 1
    return x, y


def _group_run(n, consistency, tmp_path=None, compress=None, iters=24):
    sx, sy = _gdata()
    cfg = config.PSConfig(
        num_workers=4, consistency_model=consistency,
        model=config.ModelConfig(num_features=8, num_classes=2),
        buffer=config.BufferConfig(min_size=8, max_size=32),
        use_gang=False, eval_async=False)
    fab = fabric_mod.Fabric()
    group = ShardedServerGroup(cfg, fab, n, device="cpu", test_x=sx,
                               test_y=sy, log=ListSink())
    stores = []
    if tmp_path is not None:
        def make(s):
            st = TieredParamStore(
                s.theta, s._range, hot_bytes=2 * 2 * 4, warm_bytes=2 * 2 * 4,
                page_params=2, device=s.device,
                cold=ColdStore.open(str(tmp_path / f"shard{s.shard_id}of{n}"
                                        / "param-cold")),
                rebalance_interval_s=0.002)
            st.start_policy_thread()
            stores.append(st)
            return st
        group.attach_param_stores(make)
        assert all(s.param_store is not None for s in group.shards)
    buffers = {w: SlidingBuffer(8, cfg.buffer) for w in range(4)}
    nodes = [WorkerNode(w, cfg, fab, buffers[w], "cpu", sx, sy, ListSink())
             for w in range(4)]
    if compress is not None:
        from kafka_ps_tpu_torch import compress as cmod
        codec = cmod.get_codec(cmod.parse_codec(compress),
                               group.task.num_params)
        for nd in nodes:
            nd.compressor = cmod.ErrorFeedback(codec, "cpu")
    for i in range(128):
        buffers[i % 4].add(dict(enumerate(sx[i])), int(sy[i]))
    group.run_serial(nodes, iters)
    stats = [st.stats() for st in stores]     # before a read faults pages
    theta = group.assembled_theta().numpy().tobytes()
    for st in stores:
        st.close()
    return group, theta, stats


@pytest.mark.parametrize("consistency", [0, 2])
def test_sparse_tiered_group_is_bitwise_the_resident_group(tmp_path,
                                                           consistency):
    plain, theta, _ = _group_run(2, consistency, compress="topk:0.1")
    capped, ctheta, stats = _group_run(2, consistency, tmp_path,
                                       compress="topk:0.1")
    assert ctheta == theta
    assert sum(s.sparse_applies for s in capped.shards) == \
        sum(s.sparse_applies for s in plain.shards) > 0
    # each shard demoted pages to its log and faulted them back
    assert all(st["cold_appends"] > 0 and st["faults"] > 0
               for st in stats)
    assert sum(st["pins"]["hot"] + st["pins"]["warm"] + st["pins"]["cold"]
               for st in stats) > 0


def test_two_capped_shards_are_bitwise_two_uncapped(tmp_path):
    _, theta, _ = _group_run(2, 0)
    _, ctheta, stats = _group_run(2, 0, tmp_path)
    assert ctheta == theta
    assert all(st["faults"] > 0 for st in stats)
    # each shard's cold pages under its own directory
    for i in range(2):
        assert os.listdir(tmp_path / f"shard{i}of2" / "param-cold")


# -- tiered checkpoints across the packages --------------------------------


def _ckpt_app(mod, app_cls, tmp_path, name, **kw):
    x, y = _dataset()
    app = app_cls(_cfg(mod, 2, "logreg", _tier(mod, "logreg")),
                  test_x=x, test_y=y, **kw)
    app.enable_tiering(str(tmp_path / name))
    _feed(app, x, y)
    return app


def _tier_keys(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k.startswith("tier_")}


def test_jax_tiered_checkpoint_restores_into_the_port(tmp_path):
    japp = _ckpt_app(jconfig, JApp, tmp_path, "jax-cold")
    japp.run_serial(11)
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, japp.server, buffers=japp.buffers)
    jtheta = np.asarray(japp.server.theta).copy()
    japp.close_tiering()
    japp.close_eval()
    recorded = _tier_keys(path)
    assert (recorded["tier_residency"] == TIER_COLD).any()
    tapp = _ckpt_app(config, StreamingPSApp, tmp_path, "port-cold",
                     device="cpu")
    assert tapp.restore_checkpoint(str(path))
    store = tapp.server.param_store
    assert np.array_equal(store.residency_vector(),
                          recorded["tier_residency"])
    # re-saved by the port: the same tier keys, in the JAX dtypes (saved
    # before any read of theta, which faults the cold pages warm)
    again = str(tmp_path / "again.npz")
    ckpt.save(again, tapp.server, buffers=tapp.buffers)
    for k, v in _tier_keys(again).items():
        assert v.dtype == recorded[k].dtype and v.shape == recorded[k].shape
    assert np.array_equal(_tier_keys(again)["tier_residency"],
                          recorded["tier_residency"])
    assert tapp.server.theta.numpy().tobytes() == jtheta.tobytes()
    tapp.close_tiering()
    tapp.close_logs()


def test_port_tiered_checkpoint_restores_into_jax(tmp_path):
    tapp = _ckpt_app(config, StreamingPSApp, tmp_path, "port-cold",
                     device="cpu")
    tapp.run_serial(11)
    path = str(tmp_path / "port.npz")
    ckpt.save(path, tapp.server, buffers=tapp.buffers)
    ttheta = tapp.server.theta.numpy().copy()
    tapp.close_tiering()
    tapp.close_logs()
    recorded = _tier_keys(path)
    assert set(recorded) == {"tier_residency", "tier_reads", "tier_writes",
                             "tier_page_params"}
    assert (recorded["tier_residency"].dtype, recorded["tier_reads"].dtype,
            recorded["tier_page_params"].dtype) == (np.int8, np.int64,
                                                    np.int64)
    assert (recorded["tier_residency"] == TIER_COLD).any()
    japp = _ckpt_app(jconfig, JApp, tmp_path, "jax-cold")
    assert jckpt.maybe_restore(path, japp.server, buffers=japp.buffers)
    assert np.array_equal(japp.server.param_store.residency_vector(),
                          recorded["tier_residency"])
    assert np.asarray(japp.server.theta).tobytes() == ttheta.tobytes()
    japp.close_tiering()
    japp.close_eval()


@pytest.mark.parametrize("loop", ["serial", "threaded"])
def test_a_drive_loop_ends_with_the_tier_caps_held(tmp_path, loop):
    """A dense apply lands every cold page warm, and the policy thread
    may not pass again before a final checkpoint records the residency
    (here it never does: its interval is an hour).  The drive loop ends
    with a pass that no apply races, so the checkpoint holds the caps;
    the store's close runs one more after the save's read of theta has
    faulted the cold pages warm."""
    x, y = _dataset()
    p = PAGE["logreg"]
    tier = config.TierConfig(hot_bytes=2 * p * 4, warm_bytes=3 * p * 4,
                             page_params=p, rebalance_interval_s=3600.0)
    app = StreamingPSApp(_cfg(config, 2, "logreg", tier), test_x=x,
                         test_y=y, device="cpu")
    store = app.enable_tiering(str(tmp_path / "cold"))
    _feed(app, x, y)
    getattr(app, f"run_{loop}")(11)
    caps = [2, 3, store.num_pages - 5]
    assert np.bincount(store.residency_vector(), minlength=3).tolist() \
        == caps
    path = str(tmp_path / "port.npz")
    ckpt.save(path, app.server, buffers=app.buffers)
    assert np.bincount(_tier_keys(path)["tier_residency"],
                       minlength=3).tolist() == caps
    assert store.tier_counts()["cold"] < caps[2]
    app.close_tiering()
    assert list(store.stats()["settled_tiers"].values()) == caps
    assert store.tier_counts() == dict(zip(("hot", "warm", "cold"), caps))
    app.close_logs()


def test_restore_refuses_another_page_size(tmp_path):
    tapp = _ckpt_app(config, StreamingPSApp, tmp_path, "a", device="cpu")
    path = str(tmp_path / "p.npz")
    ckpt.save(path, tapp.server)
    tapp.close_tiering()
    tapp.close_logs()
    x, y = _dataset()
    cfg = _cfg(config, 2, "logreg", config.TierConfig(
        hot_bytes=8, page_params=4))
    other = StreamingPSApp(cfg, test_x=x, test_y=y, device="cpu")
    other.enable_tiering()
    with pytest.raises(ValueError, match="page size 2 != store page size 4"):
        other.restore_checkpoint(path)
    other.close_tiering()
    other.close_logs()


# -- the CLI ---------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--tier-hot-bytes", "-1"],
    ["--tier-warm-bytes", "-8", "--durable-log", "wal"],
    ["--tier-hot-bytes", "64", "--fused"],
    ["--tier-warm-bytes", "64"],
    ["--tier-page-params", "0"]])
def test_cli_refuses_bad_tier_flags_with_the_jax_messages(argv, monkeypatch,
                                                          tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("KPS_PLATFORM", "cpu")
    with pytest.raises(SystemExit) as port:
        run_mod.main(argv)
    with pytest.raises(SystemExit) as jax_exit:
        jrun.main(argv)
    assert str(port.value) == str(jax_exit.value)
    assert "tier" in str(port.value)
    assert not os.path.exists(tmp_path / "wal")


def test_split_server_refuses_a_warm_cap_without_the_log(monkeypatch):
    monkeypatch.setenv("KPS_PLATFORM", "cpu")
    with pytest.raises(SystemExit, match="--durable-log DIR"):
        server_runner.main(["--listen", "0", "--tier-warm-bytes", "64"])


def test_runner_parsers_take_the_tier_flags():
    from kafka_ps_tpu_torch.cli import worker_runner
    for parser in (run_mod.build_parser(), server_runner.build_parser(),
                   worker_runner.build_parser()):
        a = parser.parse_args(["--tier-hot-bytes", "8", "--tier-warm-bytes",
                               "16", "--tier-page-params", "4"])
        assert (a.tier_hot_bytes, a.tier_warm_bytes,
                a.tier_page_params) == (8, 16, 4)
    a = run_mod.build_parser().parse_args([])
    assert (a.tier_hot_bytes, a.tier_warm_bytes,
            a.tier_page_params) == (0, 0, 1024)


def test_cli_capped_run_writes_the_uncapped_csvs(tmp_path):
    """`cli.run` serial -c 0 on a stream the prefill buffers whole, once
    under the caps (most pages cold) and once without: the same theta in
    the final checkpoint and the same rows, timestamps stripped."""
    from kafka_ps_tpu_torch.data.synth import generate, write_csv
    x, y = generate(2 * 128 + 64, 8, 2, seed=5)
    write_csv(str(tmp_path / "train.csv"), x[:256], y[:256])
    write_csv(str(tmp_path / "test.csv"), x[256:], y[256:])
    env = dict(os.environ, PYTHONPATH=REPO, KPS_PLATFORM="cpu")
    common = ["-training", "train.csv", "-test", "test.csv",
              "--num_workers", "2", "--num_features", "8",
              "--num_classes", "2", "--mode", "serial", "-c", "0", "-p",
              "0", "-l", "--max_iterations", "30", "--checkpoint_every",
              "0"]
    out = {}
    for name, extra in (("plain", []),
                        ("capped", ["--tier-hot-bytes", "16",
                                    "--tier-warm-bytes", "24",
                                    "--tier-page-params", "2"])):
        d = tmp_path / name
        d.mkdir()
        for f in ("train.csv", "test.csv"):
            os.link(tmp_path / f, d / f)
        r = subprocess.run(
            [sys.executable, "-m", "kafka_ps_tpu_torch.cli.run", *common,
             "--checkpoint", "ck.npz", "--durable-log", "wal", *extra],
            cwd=d, env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        stats = [line for line in r.stderr.splitlines()
                 if line.startswith("kafka_ps_tpu_torch run: ")]
        with np.load(d / "ck.npz") as z:
            theta = z["theta"].tobytes()
        rows = [_strip(open(d / f).read().splitlines()[1:])
                for f in ("logs-server.csv", "logs-worker.csv")]
        out[name] = (theta, rows, stats[-1])
    assert out["capped"][0] == out["plain"][0]
    assert out["capped"][1] == out["plain"][1]
    assert len(out["plain"][1][0]) > 0
    assert '"tier"' in out["capped"][2] and '"tier"' not in out["plain"][2]
    assert os.listdir(tmp_path / "capped" / "wal" / "param-cold")
