"""BENCHMARK.json keeps to the benchmark's contract, and the harness
finds every configuration, cell, metric, kernel count and check by name,
so that a new one is new files and an entry, not an edit."""

import json
import os
import re
import shutil

import pytest

from portbench import manifest

ROOT = manifest.ROOT
BENCH = manifest.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_paths_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    size = os.path.getsize(os.path.join(ROOT, "BENCHMARK.json"))
    assert size <= 64 * 1024


def test_configs_are_files_under_paths_with_their_reductions():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"]
        assert body["reduced"] == c["reduced"] == []
        assert body["source"] == c["source"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == names


def test_cells_name_a_config_and_a_traffic_file_once():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.isfile(os.path.join(
            ROOT, "portbench", "traffic", f"{w['traffic']}.json"))
        assert os.path.isfile(os.path.join(
            ROOT, "portbench", "checks", f"{w['name']}.json"))
    assert len(set(CELLS)) == len(CELLS)


def test_metrics_keep_to_the_contract():
    names = set()
    layers = {}
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            allowed = {"name", "unit", "better", "source", "workloads"}
            allowed |= {"bound"} if kind == "end_to_end" else \
                {"layer", "moves"}
            assert set(m) <= allowed
            assert NAME.match(m["name"]) and m["name"] not in names
            names.add(m["name"])
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                              "higher")
            assert m["source"] in SOURCES
            if "roofline" in m["name"]:
                assert m["name"].endswith("_roofline") and m["unit"] == "%"
            assert set(m.get("workloads", CELLS)) <= set(CELLS)
            assert os.path.isfile(os.path.join(
                ROOT, "portbench", "metrics", f"{m['name']}.py"))
            if kind == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert _line(m["layer"])
                layers.setdefault(m["layer"], set())
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m.get("workloads", CELLS)) <= set(
            moved.get("workloads", CELLS))


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_reports_setup_another_metric_and_a_layer(name):
    cell = manifest.cell(name)
    e2e = {m.name for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    assert cell.traffic["entry"] == "fused"
    for m in cell.end_to_end + cell.per_layer:
        assert callable(m.module.read)


def test_kernel_counts_are_found_by_name():
    k = manifest.kernel("mlp_update")
    assert callable(k.work_ms) and callable(k.bound_ms)


def test_a_new_cell_metric_and_kernel_count_are_new_files_only(tmp_path,
                                                                tiny):
    """A throwaway cell: a copy of the benchmark gains a traffic file, a
    metric reader, a kernel count and their entries; no file that was
    there changes, and the cell runs."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({
        "name": "mlp4096.fused.short", "config": "mlp-h4096",
        "traffic": "fused.short", "chips": 1, "why": "throwaway"})
    bench["per_layer"].append({
        "name": "rounds_per_s", "unit": "rounds/s", "better": "higher",
        "source": "host_clock", "layer": "drive loop",
        "moves": "updates_per_s", "workloads": ["mlp4096.fused.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    pb = tmp_path / "portbench"
    (pb / "traffic" / "fused.short.json").write_text(json.dumps({
        "entry": "fused", "burst_per_worker": 64,
        "test_rows": 100}))
    (pb / "metrics" / "rounds_per_s.py").write_text(
        "def read(run):\n"
        "    return run.updates / run.config['num_workers'] / run.window_s\n")
    (pb / "kernels" / "mlp_copy.py").write_text(
        "from portbench.kernels.mlp_update import bound_ms  # noqa\n"
        "def work_ms(cfg, counts, peak):\n"
        "    return counts.get('copy_launches', 0) * bound_ms(cfg, 1, peak)\n")
    for p, data in before.items():
        assert p.read_bytes() == data

    cell = manifest.cell("mlp4096.fused.short", root=str(tmp_path))
    assert [m.name for m in cell.per_layer][-1] == "rounds_per_s"
    from portbench.kernels.mlp_update import bound_ms
    from portbench.peaks import PEAKS
    h100 = PEAKS["NVIDIA H100 80GB HBM3"]
    assert manifest.kernel("mlp_copy", here=str(pb)).work_ms(
        cell.config, {"copy_launches": 2}, h100) == pytest.approx(
            2 * bound_ms(cell.config, 1, h100))
    small = tiny("mlp4096.fused.backlog")
    cell.config = small.config
    from portbench import cell as cell_mod
    from portbench import check
    out = cell_mod.execute(cell.name, 5, 0.5, True, device="cpu", cell=cell,
                           limits=check.load_limits("mlp4096.fused.backlog"))
    assert out["correct"]
    assert out["metrics"]["rounds_per_s"]["value"] > 0
