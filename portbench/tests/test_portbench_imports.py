"""Nothing the benchmark runs loads jax, jaxlib, flax or the JAX package,
compared by whole top-level names (the program's name starts with the
JAX package's), and the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import cell as cell_mod
from portbench import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "kafka_ps_tpu"}
PB = os.path.join(manifest.ROOT, "portbench")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(PB, sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


@pytest.mark.parametrize("names,found", [
    (["kafka_ps_tpu_torch", "kafka_ps_tpu_torch.runtime.app", "numpy"], []),
    (["kafka_ps_tpu.models.mlp"], ["kafka_ps_tpu"]),
    (["jaxlib.xla_client", "jax", "flax.linen", "jaxtyping"],
     ["flax", "jax", "jaxlib"]),
])
def test_whole_top_level_names_are_compared(names, found):
    assert cell_mod.forbidden_modules(names) == found


@pytest.mark.parametrize("path", sorted(_sources()))
def test_no_harness_file_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN, path


@pytest.mark.parametrize("path", sorted(_sources("reference"))
                         + [os.path.join(PB, "check.py")])
def test_the_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert tops <= {"__future__", "itertools", "dataclasses", "collections",
                    "json", "math", "os", "numpy", "torch", "portbench"}, \
        tops
    assert not any(m.startswith("portbench.") and
                   not m.startswith("portbench.reference")
                   for m in _imports(path)), path


SHARED = ["check.py", "cell.py", "manifest.py", "calibrate.py",
          "reference/rounds.py", "reference/buffer.py", "metrics/mfu.py",
          "tests/conftest.py"]
FAMILY_MODULES = {"portbench.reference.mlp", "portbench.reference.logreg",
                  "portbench.kernels.mlp_update"}


def _imported(path):
    """Every module an import in `path` names, a from-import's names
    included (`from a import b` names `a` and `a.b`)."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


@pytest.mark.parametrize("rel", SHARED)
def test_no_shared_harness_file_names_a_model_family(rel):
    path = os.path.join(PB, rel)
    assert "hidden_dim" not in open(path).read(), rel
    assert not set(_imported(path)) & FAMILY_MODULES, rel


FAMILIES = sorted({os.path.join(PB, "reference", "logreg.py"),
                   os.path.join(PB, "reference", "mlp.py")}
                  | set(_sources(os.path.join("tests", "families"))))


@pytest.mark.parametrize("path", FAMILIES, ids=os.path.basename)
def test_a_family_module_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert tops <= {"__future__", "torch", "numpy", "portbench"}, tops
    assert all(m == "portbench.reference"
               or m.startswith("portbench.reference.")
               for m in _imports(path) if m.startswith("portbench")), path


def test_the_logreg_family_runs_without_the_program_or_jax():
    """Its update and evaluation in a fresh interpreter, loaded by path
    as the harness loads it."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import torch\n"
        "from portbench import manifest\n"
        "cfg = {'reference': 'portbench/reference/logreg.py',\n"
        "       'num_features': 8, 'num_classes': 3, 'num_max_iter': 2,\n"
        "       'local_learning_rate': 0.5}\n"
        "fam = manifest.family(cfg)\n"
        "m = fam.Model(cfg)\n"
        "x = torch.randn(16, 8); y = torch.randint(1, 4, (16,))\n"
        "d, loss = m.update(m.theta0(), (x, y, torch.ones(16)), fam.F32)\n"
        "print(m.evaluate(m.theta0() + d, (x, y), fam.CONTROL)[0] < "
        "float(loss) + 1)\n"
        "tops = {n.split('.')[0] for n in sys.modules}\n"
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'kafka_ps_tpu',\n"
        "                     'kafka_ps_tpu_torch'}))\n" % manifest.ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split() == ["True", "[]"]


def test_a_run_loads_no_forbidden_module():
    """A whole CPU run of a small cell, in a fresh interpreter."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "sys.path.insert(0, %r)\n"
        "from conftest import tiny_cell\n"
        "from portbench import cell\n"
        "c = tiny_cell('mlp4096.fused.backlog')\n"
        "out = cell.execute(c.name, 11, 0.5, False, device='cpu', cell=c)\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'kafka_ps_tpu'}),"
        " 'kafka_ps_tpu_torch' in tops, out['correct'])\n"
        % (manifest.ROOT, os.path.join(PB, "tests")))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[] True True"


def test_a_checkout_without_the_program_exits_without_a_result(tmp_path):
    shutil_copy = __import__("shutil").copytree
    shutil_copy(PB, tmp_path / "portbench",
                ignore=__import__("shutil").ignore_patterns("__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text(
        open(os.path.join(manifest.ROOT, "BENCHMARK.json")).read())
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mlp4096.fused.backlog", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env={k: v for k, v in os.environ.items()
                          if k != "PYTHONPATH"})
    assert res.returncode != 0
    assert res.stdout.strip() == ""
