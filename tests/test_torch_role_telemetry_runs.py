"""The role runners with their telemetry flags (cli/socket_mode.py), as
processes on the CPU, each beside the JAX package's runners given the
same flags (tests/torch_role_runs.py):

  * the split deployment, a server and two worker processes, under BSP
    and (with `--serve --serve-shm` and a socket and a shared-memory
    client) under eventual consistency: every process writes its trace,
    metrics file and flight dump and answers /healthz while it runs; its
    metric families and kinds are the JAX process's; the server's
    `[status]` lines rise; the gradients frames the server read are its
    iterations plus what it dropped or left unapplied, and the workers'
    `delta.wire` flows step at the server; the JAX merge tool stitches
    the processes' traces, and the JAX critpath decomposer finds in the
    port's merged trace every segment it finds in the JAX one (wire,
    apply, publish and serving_read at least); the serving families
    agree with the engine's and the bridge's counts, and the serving
    watchdog is armed and quiet;
  * an aggregation relay (`agg_runner`, port only: no JAX relay runs in
    the tests, ROADMAP C.12) between a server and two `--aggregate`
    workers: `agg_composites_total` and the `agg_fan_in` observations are
    the relay's composites, and the workers' `delta.wire` flows step
    through the relay.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import pytest

from kafka_ps_tpu.telemetry.critpath import SEGMENTS, decompose, load_events
from kafka_ps_tpu.telemetry.merge import merge_traces
from kafka_ps_tpu_torch.data.synth import generate, write_csv
from kafka_ps_tpu_torch.runtime import net
from tests.torch_role_runs import (JAX_PKG, PORT_PKG, Role, event_kinds,
                                   flow_ids, free_port)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = 16
ITERS = 120


def _env() -> dict:
    env = dict(os.environ, KPS_PLATFORM="cpu", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _data(tmp_path):
    x, y = generate(460, F, 3, noise=1.0, sparsity=0.5, seed=0)
    train, test = str(tmp_path / "train.csv"), str(tmp_path / "test.csv")
    write_csv(train, x[:400], y[:400])
    write_csv(test, x[400:], y[400:])
    common = ["-test", test, "--num_features", str(F), "--num_classes", "3",
              "--num_workers", "4"]
    return train, common, x[400:]


def _split(base, pkg, train, common, c, serve):
    """A server and two worker processes of `pkg` under `base`."""
    port = free_port()
    server = Role(pkg, "server_runner",
                  ["--listen", port, "-training", train, "-c", c, "-p", "1",
                   "--max_iterations", ITERS, "--status_every", "0.05",
                   *common, *(("--serve", "--serve-shm") if serve else ())],
                  base / "server", _env())
    workers = [Role(pkg, "worker_runner",
                    ["--connect", f"127.0.0.1:{port}", "--worker_ids", ids,
                     *common], base / f"w{i}", _env())
               for i, ids in enumerate(("0,1", "2,3"))]
    return server, workers, port


def _clients(server, port, rows, stop):
    """A socket and a shared-memory PredictClient reading until the
    server goes away."""
    server.wait_for(r"serving predictions on port")

    def loop(shm):
        client = net.PredictClient("127.0.0.1", port, shm=shm)
        try:
            i = 0
            while not stop.is_set():
                client.predict(rows[i % len(rows)])
                i += 1
                time.sleep(0.002)
        except (ConnectionError, OSError, RuntimeError):
            pass
        finally:
            client.close()

    ts = [threading.Thread(target=loop, args=(shm,), daemon=True)
          for shm in (False, True)]
    for t in ts:
        t.start()
    return ts


def _finish(procs):
    for p in procs:
        try:
            rc = p.wait()
        except Exception:
            for q in procs:
                q.kill()
            raise
        assert rc == 0, p.err[-4000:]


def _written(role, name):
    """The trace, metrics file and exit flight dump one process wrote."""
    trace = role.trace()
    assert "wallClockT0" in trace and trace["traceEvents"]
    assert role.metric_types()
    dumps = role.dumps()
    assert dumps and dumps[-1]["reason"] == "shutdown", name
    assert dumps[-1]["schema"] == "kps-flightdump-v1"
    return trace, dumps


def _healthy(role, name):
    assert role.health, f"{name}: /healthz never answered"
    assert all(code == 200 for code, _ in role.health), role.health[-1]
    return role.health[-1][1]


def _segments(paths, out):
    merged = merge_traces(paths, out)
    found = {s for f in decompose(load_events(out))
             for s in f["segments"]}
    return merged, found


@pytest.mark.parametrize("c,serve", [(0, False), (-1, True)],
                         ids=["bsp", "eventual-serve"])
def test_split_roles_take_the_telemetry_flags_as_the_jax_roles(
        tmp_path, c, serve):
    train, common, rows = _data(tmp_path)
    runs = {pkg: _split(tmp_path / pkg, pkg, train, common, c, serve)
            for pkg in (PORT_PKG, JAX_PKG)}
    stop = threading.Event()
    clients = []
    try:
        if serve:
            for server, _, port in runs.values():
                clients += _clients(server, port, rows, stop)
        _finish([p for server, workers, _ in runs.values()
                 for p in (server, *workers)])
    finally:
        stop.set()
        for t in clients:
            t.join(timeout=10.0)
        for server, workers, _ in runs.values():
            for p in (server, *workers):
                p.kill()
    server, workers, _ = runs[PORT_PKG]
    jserver, jworkers, _ = runs[JAX_PKG]
    # the JAX roles' families and kinds, role by role
    assert server.metric_types() == jserver.metric_types()
    for w, jw in zip(workers, jworkers):
        assert w.metric_types() == jw.metric_types()
    traces = {}
    for name, role in (("server", server), ("w0", workers[0]),
                       ("w1", workers[1])):
        traces[name], dumps = _written(role, name)
        health = _healthy(role, name)
        assert health["role"] == ("server" if name == "server"
                                  else "worker")
        assert {"net.send", "net.hello" if name == "server"
                else "net.weights_recv"} <= event_kinds(dumps)
    assert "gate" in _healthy(server, "server")["watchdogs"]
    iters = server.status_iters()
    assert len(iters) >= 2 and iters == sorted(iters) and iters[-1] > 0
    # the gradients frames: what the server read is what it applied,
    # dropped or left queued; the workers sent at least that much
    st = server.stats("server")
    m = server.metrics()
    got = m["frames_received"]['topic="gradients"']
    members = st["membership"]
    assert got == (st["server_iterations"] + st["gradients_pending"]
                   + members["zombie_gradients_dropped"]
                   + members["duplicate_gradients_dropped"])
    sent = sum(w.metrics()["frames_sent"]['topic="gradients"']
               for w in workers)
    assert sent >= got >= ITERS
    # the delta.wire flows the workers started step at the server's
    # net.recv, but for frames still in flight at its stop
    starts = set(flow_ids(traces["w0"], "delta.wire", "s")
                 + flow_ids(traces["w1"], "delta.wire", "s"))
    steps = set(flow_ids(traces["server"], "delta.wire", "t"))
    assert len(starts) == sent and len(starts - steps) <= sent - got
    paths = [role.path("trace.json") for role in (server, *workers)]
    merged, found = _segments(paths, str(tmp_path / "merged.json"))
    assert merged["cross_process_flows"] >= 1
    if not serve:
        return
    jpaths = [role.path("trace.json") for role in (jserver, *jworkers)]
    _, jfound = _segments(jpaths, str(tmp_path / "jmerged.json"))
    assert jfound <= found <= set(SEGMENTS)
    assert {"wire", "apply", "publish", "serving_read"} <= found
    # a delta.wire flow ends at a serving read in the server's trace
    assert flow_ids(traces["server"], "delta.wire", "f")
    # the serving families against the engine's and the bridge's counts
    assert m["serving_requests_total"][""] == st["serving"]["requests"] > 0
    assert (m["serving_dispatch_mode"]['mode="shm"'] == st["shm_predictions"]
            > 0)
    dog = _healthy(server, "server")["watchdogs"]["serving"]
    assert dog["tripped"] is False and dog["trip_count"] == 0


def test_relay_role_takes_the_telemetry_flags(tmp_path):
    train, common, _ = _data(tmp_path)
    sport, rport = free_port(), free_port()
    server = Role(PORT_PKG, "server_runner",
                  ["--listen", sport, "-training", train, "-c", "-1", "-p",
                   "1", "--max_iterations", ITERS, *common],
                  tmp_path / "server", _env())
    relay = Role(PORT_PKG, "agg_runner",
                 ["--connect", f"127.0.0.1:{sport}", "--listen", rport,
                  "--worker_ids", "0,1,2,3", *common], tmp_path / "relay",
                 _env())
    workers = [Role(PORT_PKG, "worker_runner",
                    ["--aggregate", f"127.0.0.1:{rport}", "--worker_ids",
                     ids, *common], tmp_path / f"w{i}", _env())
               for i, ids in enumerate(("0,1", "2,3"))]
    try:
        _finish([server, relay, *workers])
    finally:
        for p in (server, relay, *workers):
            p.kill()
    traces = {}
    for name, role in (("server", server), ("relay", relay),
                       ("w0", workers[0]), ("w1", workers[1])):
        traces[name], dumps = _written(role, name)
        _healthy(role, name)
    assert {"agg.combine", "agg.forward", "net.send"} <= \
        event_kinds(relay.dumps())
    st = relay.stats("aggregator")
    m = relay.metrics()
    assert m["agg_composites_total"]['mode="stacked"'] == st["composites"] > 0
    assert m["agg_fan_in_count"][""] == st["composites"]
    assert m["agg_fan_in_sum"][""] == st["members"]
    # the members' delta.wire flows step through the relay: at its
    # downstream net.recv, and once more per member at the combine
    starts = set(flow_ids(traces["w0"], "delta.wire", "s")
                 + flow_ids(traces["w1"], "delta.wire", "s"))
    hop = [e for e in traces["relay"]["traceEvents"]
           if e.get("name") == "delta.wire" and e.get("ph") == "t"]
    combined = {e["id"] for e in hop if "agg" in e.get("args", {})}
    assert combined and combined <= starts
    # the composites the relay sent upstream open their own flows, which
    # step at the server
    relayed = set(flow_ids(traces["relay"], "delta.wire", "s"))
    assert relayed & set(flow_ids(traces["server"], "delta.wire", "t"))
    assert np.all([h[0] == 200 for h in relay.health])
