"""The port's static checks (kafka_ps_tpu_torch/analysis/): pscheck's
rules in torch terms, one positive and one negative fixture per rule; the
whole-program passes; the CLI; parity with the JAX analyzer on the rules
that did not change; and the port clean under its own checks.

The JAX-neutral fixtures of tests/analysis_fixtures/ are read in place
(AST input, never imported); tests/torch_analysis_fixtures/ holds the
torch twins of the JAX-specific ones."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from kafka_ps_tpu.analysis import lockflow as jlockflow
from kafka_ps_tpu.analysis import program as jprogram
from kafka_ps_tpu.analysis import psverify as jpsverify
from kafka_ps_tpu_torch.analysis import (lockflow, lockgraph, program,
                                         pscheck, psverify)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "analysis_fixtures"
TORCH_FIXTURES = REPO / "tests" / "torch_analysis_fixtures"
PORT = REPO / "kafka_ps_tpu_torch"


def _findings(path: Path):
    return pscheck.analyze_path(path).findings


# -- one positive and one negative fixture per rule ------------------------

_NEUTRAL_BAD = [
    ("runtime/ps102_bad.py", "PS102"),
    ("ps103/serde.py", "PS103"),
    ("log/ps104_bad.py", "PS104"),
    ("ps104_sharding_bad/runtime/sharding.py", "PS104"),
    ("ps104_sharding_bad/parallel/range_sharded.py", "PS104"),
    ("ps105_bad.py", "PS105"),
    ("store/ps104_bad.py", "PS104"),
    ("store/ps105_bad.py", "PS105"),
    ("serving/ps102_bad.py", "PS102"),
    ("serving/ps105_bad.py", "PS105"),
    ("serving/costmodel_ps102_bad.py", "PS102"),
    ("serving/shm_ps105_bad.py", "PS105"),
    ("serving/dispatch_ps106_bad.py", "PS106"),
    ("runtime/ps106_bad.py", "PS106"),
    ("runtime/ps106_flight_bad.py", "PS106"),
    ("telemetry/critpath.py", "PS104"),
    ("telemetry/slo.py", "PS106"),
    ("telemetry/drift.py", "PS104"),
    ("agg/ps102_bad.py", "PS102"),
    ("agg/ps104_bad.py", "PS104"),
    ("agg/ps105_bad.py", "PS105"),
    ("agg/ps106_bad.py", "PS106"),
    ("runtime/wire_ps102_bad.py", "PS102"),
    ("ps104_wire_bad/runtime/wire.py", "PS104"),
    ("runtime/wire_ps105_bad.py", "PS105"),
    ("runtime/wire_ps106_bad.py", "PS106"),
    ("eval_ps102_bad/evaluation/engine.py", "PS102"),
    ("eval_ps104_bad/evaluation/engine.py", "PS104"),
    ("eval_ps106_bad/evaluation/engine.py", "PS106"),
]
_TORCH_BAD = [
    ("ps101_bad.py", "PS101"),
    ("ps101_graph_bad.py", "PS101"),
    ("store/ps101_bad.py", "PS101"),
]
_NEUTRAL_OK = [
    "runtime/ps102_ok.py", "ps103/net.py", "log/ps104_ok.py",
    "ps104_sharding_ok/runtime/sharding.py",
    "ps104_sharding_ok/parallel/range_sharded.py", "ps105_ok.py",
    "store/ps104_ok.py", "store/ps105_ok.py", "serving/ps102_ok.py",
    "serving/ps105_ok.py", "serving/costmodel_ps102_ok.py",
    "serving/shm_ps105_ok.py", "serving/dispatch_ps106_ok.py",
    "runtime/ps106_ok.py", "runtime/ps106_flight_ok.py",
    "telemetry/profiler.py", "telemetry/modelhealth.py",
    "agg/ps102_ok.py", "agg/ps104_ok.py", "agg/ps105_ok.py",
    "agg/ps106_ok.py", "runtime/wire_ps102_ok.py",
    "ps104_wire_ok/runtime/wire.py", "runtime/wire_ps105_ok.py",
    "runtime/wire_ps106_ok.py", "eval_ps102_ok/evaluation/engine.py",
    "eval_ps104_ok/evaluation/engine.py",
    "eval_ps106_ok/evaluation/engine.py",
]
_TORCH_OK = ["ps101_ok.py", "store/ps101_ok.py"]


@pytest.mark.parametrize(
    "path,rule",
    [(FIXTURES / p, r) for p, r in _NEUTRAL_BAD]
    + [(TORCH_FIXTURES / p, r) for p, r in _TORCH_BAD],
    ids=lambda v: v if isinstance(v, str) else str(
        Path(v).relative_to(REPO / "tests")))
def test_positive_fixture_triggers_exactly_once(path, rule):
    found = _findings(path)
    assert [f.rule for f in found] == [rule], [f.render() for f in found]
    assert not found[0].suppressed


@pytest.mark.parametrize(
    "path",
    [FIXTURES / p for p in _NEUTRAL_OK]
    + [TORCH_FIXTURES / p for p in _TORCH_OK],
    ids=lambda v: str(Path(v).relative_to(REPO / "tests")))
def test_negative_fixture_stays_clean(path):
    assert _findings(path) == []


# -- the torch terms of PS102, PS104 and PS106 -----------------------------

_HANDLER = "class Node:\n    def process(self, msg):\n        {}\n"


@pytest.mark.parametrize("expr", [
    "return msg.values.cpu()",
    "return msg.values.tolist()",
    "return msg.values.numpy()",
    "return msg.loss.item()",
    "return int(msg.loss)",
    "return float(msg.loss)",
    "torch.cuda.synchronize()",
    "self.done.synchronize()",
    "return np.array(msg.values)",
])
def test_a_torch_host_sync_in_a_handler_is_ps102(expr):
    found = pscheck.analyze_source(_HANDLER.format(expr),
                                   "runtime/node.py").findings
    assert [f.rule for f in found] == ["PS102"]


@pytest.mark.parametrize("expr", [
    "return msg.values",
    "return int(time.time() * 1000)",
    "return len(msg.values) + int(3)",
    "return msg.values.to('cpu', non_blocking=True)",
    "self.done.synchronize  # not a call",
])
def test_a_device_resident_handler_is_not_ps102(expr):
    assert pscheck.analyze_source(_HANDLER.format(expr),
                                  "runtime/node.py").findings == []


@pytest.mark.parametrize("arg", [
    "loss.item()", "int(loss)", "loss.cpu()", "float(loss)",
    "rows.tolist()",
])
def test_a_torch_host_sync_in_telemetry_arguments_is_ps106(arg):
    src = f"def record(hist, loss, rows):\n    hist.observe({arg})\n"
    found = pscheck.analyze_source(src, "ops/record.py").findings
    assert [f.rule for f in found] == ["PS106"]


@pytest.mark.parametrize("stmt", [
    "torch.rand(4)",
    "torch.randn(4, 4)",
    "torch.randint(0, 5, (4,))",
    "torch.randperm(8)",
    "torch.multinomial(p, 2)",
    "torch.bernoulli(p)",
    "t.uniform_()",
    "t.normal_(0.0, 1.0)",
    "torch.seed()",
    "t.index_add_(0, idx, v)",
    "t.scatter_add_(0, idx, v)",
    "t.scatter_reduce(0, idx, v, reduce='sum')",
    "t.index_put_((idx,), v, accumulate=True)",
])
def test_torch_nondeterminism_in_a_replay_critical_module_is_ps104(stmt):
    src = f"import torch\n\ndef f(t, p, idx, v):\n    {stmt}\n"
    found = pscheck.analyze_source(src, "log/replay.py").findings
    assert [f.rule for f in found] == ["PS104"]


@pytest.mark.parametrize("stmt,path", [
    ("torch.rand(4, generator=g)", "log/replay.py"),
    ("torch.randperm(8, generator=g)", "store/plan.py"),
    ("t.uniform_(generator=g)", "agg/core.py"),
    ("t.index_put_((idx,), v, accumulate=False)", "log/replay.py"),
    ("t.index_copy_(0, idx, v)", "log/replay.py"),
    ("t.index_add_(0, idx, v)", "models/mlp.py"),
    ("torch.rand(4)", "models/mlp.py"),
])
def test_seeded_or_unscoped_torch_draws_are_not_ps104(stmt, path):
    src = f"import torch\n\ndef f(t, g, idx, v):\n    {stmt}\n"
    assert pscheck.analyze_source(src, path).findings == []


# -- suppression syntax and scoping ----------------------------------------

def test_unreasoned_suppression_is_its_own_finding():
    found = _findings(FIXTURES / "log" / "ps100_bad.py")
    by_rule = {f.rule: f for f in found}
    assert set(by_rule) == {"PS100", "PS104"}
    assert by_rule["PS104"].suppressed and by_rule["PS104"].reason is None
    assert not by_rule["PS100"].suppressed


@pytest.mark.parametrize("src,where", [
    ("import time\ndef f():\n    return time.time()  "
     "# pscheck: disable=PS104 (display only)\n", "log/clock.py"),
    ("import time\ndef f():\n    # pscheck: disable=PS104 (display only)\n"
     "    return time.time()\n", "log/clock.py"),
    ("import time\ndef start(self):\n    self.started_wall = time.time()  "
     "# pscheck: disable=PS104 (display only)\n", "telemetry/profiler.py"),
], ids=["same-line", "preceding-line", "profiler-wall-anchor"])
def test_a_reasoned_suppression_is_reported_with_its_reason(src, where):
    (f,) = pscheck.analyze_source(src, where).findings
    assert f.rule == "PS104" and f.suppressed and f.reason == "display only"


def test_rule_scoping_is_path_based():
    src = "import time\ndef f():\n    return time.time()\n"
    assert pscheck.analyze_source(src, "utils/clock.py").findings == []
    assert len(pscheck.analyze_source(src, "log/clock.py").findings) == 1


# -- the port is clean under its own checks --------------------------------

_PROGRAMS: dict = {}     # (analyzer, target) -> its whole-program model


@pytest.fixture(scope="module")
def reports():
    """(JAX analyzer, port analyzer) reports of each target, relative
    paths as the CLI gives them; each analyzer's program model of each
    target is kept in _PROGRAMS for the lock tests below."""
    def keeping(analyzer, build):
        def kept(paths):
            key = (analyzer, tuple(str(p) for p in paths))
            if key not in _PROGRAMS:
                _PROGRAMS[key] = build(paths)
            return _PROGRAMS[key]
        return kept

    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(REPO)
        mp.setattr(jpsverify, "build", keeping("jax", jprogram.build))
        mp.setattr(psverify, "build", keeping("port", program.build))
        return {target: (jpsverify.analyze([target])[0],
                         psverify.analyze([target])[0])
                for target in ("tests/analysis_fixtures", "kafka_ps_tpu",
                               "kafka_ps_tpu_torch")}


@pytest.mark.parametrize("analyze", ["pscheck", "psverify"])
def test_the_port_has_zero_unsuppressed_findings(analyze, reports):
    if analyze == "pscheck":
        rep = pscheck.analyze_path(PORT)
    else:
        rep = reports["kafka_ps_tpu_torch"][1]
    assert rep.unsuppressed == [], [f.render() for f in rep.unsuppressed]
    for f in rep.suppressed:
        assert f.reason, f.render()


def test_cli_json_and_exit_code():
    proc = subprocess.run(
        [sys.executable, "-m", "kafka_ps_tpu_torch.analysis",
         "kafka_ps_tpu_torch/", "--json"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rep = json.loads(proc.stdout)
    assert set(rep) == {"files", "counts", "by_rule", "findings"}
    assert rep["counts"]["unsuppressed"] == 0
    assert rep["files"] > 80
    assert all(f["reason"] for f in rep["findings"])


@pytest.mark.parametrize("fixture,rule", [
    (FIXTURES / "ps105_bad.py", "PS105"),
    (TORCH_FIXTURES / "ps101_bad.py", "PS101"),
], ids=["ps105", "ps101"])
def test_cli_fails_on_unsuppressed_finding(fixture, rule):
    proc = subprocess.run(
        [sys.executable, "-m", "kafka_ps_tpu_torch.analysis", str(fixture)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert rule in proc.stdout


# -- psverify: the whole-program passes (PS201-PS204, PS107) ---------------

def _verify(path: Path):
    rep, _ = psverify.analyze([path])
    return rep


@pytest.mark.parametrize("relpath,rule", [
    ("ps201_bad.py", "PS201"),
    ("ps202_bad.py", "PS202"),
    ("ps202_owned_bad.py", "PS202"),
    ("ps203_bad.py", "PS203"),
    ("ps204_bad/wire.py", "PS204"),
    ("ps107_bad.py", "PS107"),
])
def test_psverify_positive_fixture_triggers_exactly_once(relpath, rule):
    rep = _verify(FIXTURES / "psverify" / relpath)
    assert [f.rule for f in rep.findings] == [rule], \
        [f.render() for f in rep.findings]
    assert not rep.findings[0].suppressed


@pytest.mark.parametrize("relpath", [
    "ps201_ok.py", "ps202_ok.py", "ps202_owned_ok.py", "ps203_ok.py",
    "ps204_ok/wire.py", "ps107_ok/log/stamp.py",
])
def test_psverify_negative_fixture_stays_clean(relpath):
    rep = _verify(FIXTURES / "psverify" / relpath)
    assert rep.unsuppressed == [], [f.render() for f in rep.unsuppressed]
    assert not [f for f in rep.findings if f.rule == "PS107"]


def test_json_reports_per_rule_suppressed_counts():
    data = _verify(FIXTURES / "psverify" / "ps107_ok" / "log" /
                   "stamp.py").to_json()
    assert data["by_rule"]["PS104"] == {
        "total": 1, "suppressed": 1, "unsuppressed": 0}


def test_static_cycle_detected_while_runtime_stays_silent():
    """The inversion lives on a path the process never takes: the port's
    runtime recorder cannot see it, the static pass must."""
    import importlib.util

    fixture = TORCH_FIXTURES / "psverify" / "ps203_bad.py"
    prog = program.build([fixture])
    assert [f.rule for f in lockflow.check(prog)] == ["PS203"]
    with lockgraph.isolated() as g:
        spec = importlib.util.spec_from_file_location("fxt203", fixture)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert mod.forward()        # ONLY the consistent path runs
        assert g.cycles() == []
        runtime = g.export_edges()
    assert [(e["src"], e["dst"]) for e in runtime] \
        == [("fxt203.A", "fxt203.B")]
    for e in runtime:
        assert "ps203_bad.py" in e["src_first"], e
        assert "ps203_bad.py" in e["dst_first"], e
    cov = lockflow.coverage_diff(prog, runtime)
    assert cov["common"] == 1
    assert [(e["src"], e["dst"]) for e in cov["static_only"]] \
        == [("fxt203.B", "fxt203.A")]
    assert cov["runtime_only"] == []


def test_psverify_cli_reports_lock_coverage(tmp_path):
    fixture = FIXTURES / "psverify" / "ps203_ok.py"
    edges = [{"src": "fx203ok.A", "dst": "fx203ok.B", "site": "x.py:1",
              "thread": "t", "src_first": "", "dst_first": ""}]
    dump = tmp_path / "edges.json"
    dump.write_text(json.dumps({"edges": edges}), encoding="utf-8")
    proc = subprocess.run(
        [sys.executable, "-m", "kafka_ps_tpu_torch.analysis", str(fixture),
         "--json", "--lock-coverage", str(dump)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    cov = json.loads(proc.stdout)["lock_coverage"]
    assert cov["common"] == 1 and cov["runtime_only"] == []


def test_the_rule_catalog_is_the_jax_one_in_torch_terms():
    assert set(psverify.RULES) == set(jpsverify.RULES)
    for code in ("PS101", "PS102", "PS104"):
        assert psverify.RULES[code] != jpsverify.RULES[code]


# -- parity with the JAX analyzer ------------------------------------------

_SHARED_RULES = {"PS103", "PS105", "PS107", "PS201", "PS202", "PS203",
                 "PS204"}
# the port's suppressions of findings only its torch terms raise (PS101's
# builders, PS102's int(...)): the JAX analyzer, which raises no such
# finding, reads each of them as a stale entry (PS107)
_TORCH_TERM_SUPPRESSIONS = {
    ("kafka_ps_tpu_torch/evaluation/engine.py", "PS102"),
    ("kafka_ps_tpu_torch/ops/fused_update.py", "PS101"),
    ("kafka_ps_tpu_torch/runtime/app.py", "PS101"),
    ("kafka_ps_tpu_torch/runtime/server.py", "PS102"),
}


def _keys(rep, rules):
    return {(f.rule, f.path, f.line) for f in rep.findings
            if f.rule in rules}


@pytest.mark.parametrize("target", ["tests/analysis_fixtures",
                                    "kafka_ps_tpu", "kafka_ps_tpu_torch"])
def test_unchanged_rules_find_what_the_jax_analyzer_finds(reports, target):
    jax_rep, port_rep = reports[target]
    jax_keys = _keys(jax_rep, _SHARED_RULES)
    port_keys = _keys(port_rep, _SHARED_RULES)
    assert port_keys - jax_keys == set()
    differ = jax_keys - port_keys
    if target != "kafka_ps_tpu_torch":
        assert differ == set()
        return
    # the only difference: PS107 on the torch-term suppressions, each on
    # its finding's line or the line above it
    assert all(rule == "PS107" for rule, _, _ in differ), differ
    torch_terms = [f for f in port_rep.findings
                   if f.suppressed and (f.rule == "PS101" or (
                       f.rule == "PS102" and f.message.startswith("int(")))]
    assert {(f.path, f.rule) for f in torch_terms} == \
        _TORCH_TERM_SUPPRESSIONS
    assert len(differ) == len(torch_terms)
    for f in torch_terms:
        assert {("PS107", f.path, f.line),
                ("PS107", f.path, f.line - 1)} & differ, f.render()


@pytest.mark.parametrize("target", ["tests/analysis_fixtures",
                                    "kafka_ps_tpu", "kafka_ps_tpu_torch"])
def test_ps104_findings_are_a_superset_of_the_jax_ones(reports, target):
    jax_rep, port_rep = reports[target]
    assert _keys(jax_rep, {"PS104"}) <= _keys(port_rep, {"PS104"})


def _ordered_names(prog) -> set[str]:
    """The literal names of every OrderedLock/OrderedCondition built in a
    package (an f-string's fields as `*`)."""
    out = set()
    for sf in prog.files:
        if "analysis" in Path(sf.path).parts:
            continue
        for node in ast.walk(sf.tree):
            if (isinstance(node, ast.Call) and node.args
                    and program._dotted(node.func).split(".")[-1]
                    in ("OrderedLock", "OrderedCondition")):
                out.add(program._const_str(node.args[0]))
    return out


# the port's own locks: each guards state the JAX package keeps unlocked
# or does not have (ROADMAP C.8's log locks, the tier store's pass lock)
_PORT_ONLY_LOCKS = {
    "CommitLog.lock", "DurableFabric.commit", "DurableFabric.stats",
    "LogManager.partitions", "GangDispatcher.count", "store.pass",
}


def test_every_jax_lock_name_is_an_ordered_lock_of_the_port(reports):
    jax_names = _ordered_names(_PROGRAMS["jax", ("kafka_ps_tpu",)])
    port_names = _ordered_names(_PROGRAMS["port", ("kafka_ps_tpu_torch",)])
    assert jax_names <= port_names
    assert port_names - jax_names == _PORT_ONLY_LOCKS


def _static(mod_lockflow, prog):
    names = set()
    for sf in prog.files:
        for ci in sf.classes:
            names |= set(ci.lock_attrs.values())
        names |= set(sf.module_locks.values())
    return names, {(e.src, e.dst) for e in mod_lockflow.static_edges(prog)}


def test_static_lock_order_edges_on_shared_names_equal_the_jax_ones(
        reports):
    jax_names, jax_edges = _static(
        jlockflow, _PROGRAMS["jax", ("kafka_ps_tpu",)])
    port_names, port_edges = _static(
        lockflow, _PROGRAMS["port", ("kafka_ps_tpu_torch",)])
    shared = jax_names & port_names
    assert len(shared) >= 30

    def on(edges):
        return {e for e in edges if e[0] in shared and e[1] in shared}

    assert on(port_edges) == on(jax_edges)
    # the port's edges off the shared names, each from a port change:
    # the tier store's pass lock (passes one at a time), the durable
    # fabric's cond around a log read (C.8's log locks) and the kernel
    # build's module locks (ops/, plain threading locks)
    assert port_edges - on(port_edges) == {
        ("store.pass", "store.residency"),
        ("DurableFabric._cond", "LogManager.partitions"),
        ("kafka_ps_tpu_torch.ops.fused_update._lock",
         "kafka_ps_tpu_torch.ops._build._lock"),
    }
    assert jax_edges - on(jax_edges) == set()
