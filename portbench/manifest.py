"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) names a configuration, whose `file`
holds its sizes, and a traffic mix, `traffic/<traffic>.json`.  The
configuration's `reference` names its model family's module (under
`reference/`: the model, its control, the names of its rows and kernel
counts, its CPU test sizes); the rows a family reads are `rows/<name>.py`.
Each metric is read by `metrics/<name>.py`, a module with `read(run) ->
float | None`; a kernel family's operation and byte counts are
`kernels/<name>.py`; the limits of a cell's correctness check are
`checks/<cell>.json`.  Adding any of them is adding a file and an entry:
no file here names a cell, a configuration, a model family or a metric.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Metric:
    name: str
    unit: str
    module: object               # metrics/<name>.py

    def read(self, run):
        return self.module.read(run)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    family: object               # the configuration's `reference` module


def benchmark(root: str = ROOT) -> dict:
    return _read_json(os.path.join(root, "BENCHMARK.json"))


def metric(name: str, unit: str = "", here: str = HERE) -> Metric:
    path = os.path.join(here, "metrics", f"{name}.py")
    return Metric(name, unit, _load_module(path, f"portbench_metric_{name}"))


def kernel(name: str, here: str = HERE):
    """The operation and byte counts of one kernel family."""
    return _load_module(os.path.join(here, "kernels", f"{name}.py"),
                        f"portbench_kernel_{name}")


def family(config: dict, root: str = ROOT):
    """The model family module a configuration names under `reference`,
    a path from the root of the checkout."""
    path = os.path.join(root, config["reference"])
    name = os.path.splitext(os.path.basename(path))[0]
    return _load_module(path, f"portbench_family_{name}")


def rows(name: str, here: str = HERE):
    """The rows a model family reads: their generator, what `data_sink`
    gets for one, the record the reference buffer keeps."""
    return _load_module(os.path.join(here, "rows", f"{name}.py"),
                        f"portbench_rows_{name}")


def traffic(name: str, here: str = HERE) -> dict:
    return _read_json(os.path.join(here, "traffic", f"{name}.json"))


def cell(name: str, root: str = ROOT, bench: dict | None = None) -> Cell:
    """The cell `name` of BENCHMARK.json with its configuration, traffic
    and metrics."""
    bench = bench or benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    return compose(entry, bench, root)


def compose(entry: dict, bench: dict, root: str = ROOT) -> Cell:
    """A cell from a workload entry ({name, config, traffic, chips}): the
    configuration named in `bench`, the traffic file, and the metrics
    `bench` lists for that cell's name (or for every cell)."""
    name = entry["name"]
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _read_json(os.path.join(root, conf["file"]))
    here = os.path.join(root, "portbench")

    def metrics(kind: str) -> list[Metric]:
        return [metric(m["name"], m["unit"], here)
                for m in bench[kind]
                if "workloads" not in m or name in m["workloads"]]

    return Cell(name, entry["chips"], config,
                traffic(entry["traffic"], here), metrics("end_to_end"),
                metrics("per_layer"), family(config, root))


def roofline(run, name: str) -> float | None:
    """A kernel family's share of its roofline in the profiled window:
    the summed bounds of its calls (kernels/<name>.py, from the
    program's kernel counters) over the device time of the program's
    kernels, in percent; None without a trace, a known card or a call."""
    p = run.profile
    if p is None or run.peak is None or not p.program_kernel_ns:
        return None
    work = kernel(name).work_ms(run.config, run.profiled_counts, run.peak)
    return 100.0 * work / (p.program_kernel_ns / 1e6) if work else None
