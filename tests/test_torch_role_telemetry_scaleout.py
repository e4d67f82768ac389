"""The shard servers', the sharded worker's and the read replica's
telemetry flags (cli/socket_mode.py), as processes on the CPU
(tests/torch_role_runs.py):

  * two shard servers and a sharded worker process, beside the JAX
    package's with the same flags: each writes its trace, metrics file
    and flight dump and answers /healthz; its families and kinds are the
    JAX process's; every family of a shard's server node carries its
    `shard` label, and the worker's dump holds the `shard.weights`
    records of both shards;
  * shard 1 killed by SIGKILL after its first checkpoint and the
    survivors stopped by SIGTERM: the JAX postmortem reads the port's
    dumps and names the dead shard and the last (worker, clock) it
    acknowledged;
  * a read replica started on an empty log directory and a trainer
    writing the log, beside the JAX package's: the replica records
    `replica.publish` per publication, and its replica and serving
    watchdogs are armed and quiet.
"""

from __future__ import annotations

import glob
import os
import shutil
import signal
import time

from kafka_ps_tpu.telemetry import postmortem
from kafka_ps_tpu_torch.runtime import net
from tests.test_torch_role_telemetry_runs import (_data, _env, _finish,
                                                  _healthy, _written)
from tests.torch_role_runs import JAX_PKG, PORT_PKG, Role, free_port

ITERS = 60
# the families of a shard's ServerNode, each labelled with the shard
NODE_FAMILIES = ("gate_wait_ms", "clock_lag", "worker_lag",
                 "gradients_applied_total")


def _shards(base, pkg, train, common, iters, extra=()):
    ports = [free_port(), free_port()]
    shards = [Role(pkg, "server_runner",
                   ["--listen", ports[i], "--shards", "2", "--shard-id", i,
                    "-training", train, "-c", "2", "-p", "1",
                    "--max_iterations", iters, *common, *extra],
                   base / f"s{i}", _env()) for i in (0, 1)]
    worker = Role(pkg, "worker_runner",
                  ["--connect", ",".join(f"127.0.0.1:{p}" for p in ports),
                   "--worker_ids", "0,1,2,3", *common], base / "w0", _env())
    return shards, worker


def test_shard_roles_take_the_telemetry_flags_as_the_jax_roles(tmp_path):
    train, common, _ = _data(tmp_path)
    runs = {pkg: _shards(tmp_path / pkg, pkg, train, common, ITERS)
            for pkg in (PORT_PKG, JAX_PKG)}
    procs = [p for shards, worker in runs.values() for p in (*shards, worker)]
    try:
        _finish(procs)
    finally:
        for p in procs:
            p.kill()
    (shards, worker), (jshards, jworker) = runs[PORT_PKG], runs[JAX_PKG]
    for p, j in zip((*shards, worker), (*jshards, jworker)):
        assert p.metric_types() == j.metric_types()
    for i, shard in enumerate(shards):
        _written(shard, f"s{i}")
        health = _healthy(shard, f"s{i}")
        assert (health["role"], health["shard"]) == ("server", i)
        m = shard.metrics()
        labelled = [labels for name, samples in m.items()
                    if name.startswith(NODE_FAMILIES)
                    for labels in samples]
        assert labelled and all(f'shard="{i}"' in labels
                                for labels in labelled)
    _, dumps = _written(worker, "w0")
    _healthy(worker, "w0")
    acks = {e["shard"] for d in dumps for e in d["events"]
            if e["kind"] == "shard.weights"}
    assert acks == {0, 1}
    assert dumps[-1]["meta"] == {"shards": [0, 1]}


def test_the_jax_postmortem_names_the_ports_dead_shard(tmp_path):
    train, common, _ = _data(tmp_path)
    shards, worker = _shards(tmp_path, PORT_PKG, train, common, 10 ** 6,
                             ("--checkpoint", "ck.npz",
                              "--checkpoint_every", "10"))
    procs = [*shards, worker]
    try:
        deadline = time.monotonic() + 120.0
        ck = tmp_path / "s1" / "ck.npz.shard1of2.npz"
        while not ck.exists():
            assert time.monotonic() < deadline, shards[1].err[-3000:]
            assert shards[1].proc.poll() is None, shards[1].err[-3000:]
            time.sleep(0.05)
        shards[1].proc.send_signal(signal.SIGKILL)
        shards[1].wait()
        time.sleep(1.0)
        for p in (shards[0], worker):
            p.proc.send_signal(signal.SIGTERM)
        for p in (shards[0], worker):
            p.wait()
    finally:
        for p in procs:
            p.kill()
    box = tmp_path / "dumps"
    box.mkdir()
    for p in procs:
        assert all(d["reason"].startswith("signal:") for d in p.dumps())
        for path in glob.glob(p.path("flight/flightdump-*.json")):
            shutil.copy(path, box)
    assert not shards[1].dumps()
    report = postmortem.analyze(*postmortem.load_dumps_with_errors(str(box)))
    assert report["knownShards"] == [0, 1]
    assert report["deadShards"] == [1]
    acks = [e for d in worker.dumps() for e in d["events"]
            if e["kind"] == "shard.weights" and e["shard"] == 1]
    last = max(acks, key=lambda e: (e["clock"], e["t"]))
    got = report["lastAcks"][1]
    assert (got["worker"], got["clock"]) == (last["worker"], last["clock"])
    text = postmortem.format_report(report)
    assert "dead shard 1" in text and "last ack from shard 1" in text


def test_replica_role_takes_the_telemetry_flags_as_the_jax_replica(
        tmp_path):
    train, common, rows = _data(tmp_path)
    model = common[2:]                   # the model shape flags
    replicas, trainers = {}, {}
    for pkg in (PORT_PKG, JAX_PKG):
        wal = str(tmp_path / pkg / "wal")
        os.makedirs(wal)
        replicas[pkg] = Role(pkg, "server_runner",
                             ["--serve-replica", "--durable-log", wal,
                              "--serve_port", "0", *model],
                             tmp_path / pkg / "replica", _env())
    try:
        for pkg, replica in replicas.items():
            replica.wait_for(r"replica serving on port")
            trainers[pkg] = Role(
                pkg, "run", ["-training", train, *common, "-c", "0", "-p",
                             "0", "--mode", "serial", "--max_iterations",
                             ITERS, "--durable-log",
                             str(tmp_path / pkg / "wal")],
                tmp_path / pkg / "trainer", _env(), telemetry=False)
        _finish(list(trainers.values()))
        final = ITERS // 4
        for pkg, replica in replicas.items():
            port = int(replica.wait_for(r"replica serving on port (\d+)")
                       .group(1))
            client = net.PredictClient("127.0.0.1", port)
            deadline = time.monotonic() + 60.0
            while client.predict(rows[0]).vector_clock < final:
                assert time.monotonic() < deadline, replica.err[-3000:]
                time.sleep(0.05)
            client.close()
            while not replica.health:
                assert time.monotonic() < deadline
                time.sleep(0.05)
            replica.proc.send_signal(signal.SIGINT)
        _finish(list(replicas.values()))
    finally:
        for p in (*replicas.values(), *trainers.values()):
            p.kill()
    replica, jreplica = replicas[PORT_PKG], replicas[JAX_PKG]
    assert replica.metric_types() == jreplica.metric_types()
    _, dumps = _written(replica, "replica")
    health = _healthy(replica, "replica")
    assert health["role"] == "replica"
    for dog in ("replica", "serving"):
        assert health["watchdogs"][dog]["tripped"] is False
    st = replica.stats("replica")
    published = [e for d in dumps for e in d["events"]
                 if e["kind"] == "replica.publish"]
    assert published and len(published) == st["publications"]
    assert published[-1]["clock"] == st["clock"] == ITERS // 4
    m = replica.metrics()
    assert m["serving_requests_total"][""] == st["serving"]["requests"]
