"""A model family reaches the harness through new files alone: the
configuration's `reference` names its module, which gives the model, its
control, the names of its rows and kernel counts, and its CPU sizes.
Logistic regression (reference/logreg.py), driven through cell.execute
from a configuration, traffic and limits kept under tests/logreg/ (in no
cell of BENCHMARK.json): a sound run is correct, and the control and
each planted fault are not."""

import json
import os

import pytest
import torch

from conftest import shrink
from portbench import cell as cell_mod
from portbench import check, manifest
from portbench.cell import Run
from portbench.peaks import PEAKS

HERE = os.path.dirname(os.path.abspath(__file__))
LOGREG = os.path.join(HERE, "logreg")
H100 = PEAKS["NVIDIA H100 80GB HBM3"]


def _json(path):
    with open(path) as f:
        return json.load(f)


CONFIGS = ([os.path.join(manifest.ROOT, c["file"])
            for c in manifest.benchmark()["configs"]]
           + [os.path.join(LOGREG, "config.json")])


def logreg_cell():
    cfg = _json(os.path.join(LOGREG, "config.json"))
    return shrink(manifest.Cell(
        "logreg.fused.backlog", 1, cfg,
        _json(os.path.join(LOGREG, "traffic.json")),
        [manifest.metric("updates_per_s", "updates/s"),
         manifest.metric("setup_s", "s")],
        [manifest.metric("mfu", "%")], manifest.family(cfg)))


def _limits():
    return _json(os.path.join(LOGREG, "limits.json"))["limits"]


def _execute(seed=3, trace=False):
    return cell_mod.execute("logreg.fused.backlog", seed, 0.5, trace,
                            device="cpu", cell=logreg_cell(),
                            limits=_limits())


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_every_configuration_names_a_family_with_its_seams(path):
    cfg = _json(path)
    fam = manifest.family(cfg)
    for name in ("Model", "F32", "CONTROL", "ROWS", "COUNTS", "TINY"):
        assert hasattr(fam, name), (path, name)
    rows = manifest.rows(fam.ROWS)
    for name in ("make", "handed", "fields", "program", "test"):
        assert callable(getattr(rows, name)), name
    assert manifest.kernel(fam.COUNTS).flops_per_member(cfg) > 0
    model = fam.Model(cfg, [])
    theta0 = model.theta0()
    assert theta0.dtype == torch.float32 and theta0.ndim == 1
    assert sum(v.numel() for v in model.leaves(theta0).values()) \
        == theta0.numel() == cfg["parameters"]


@pytest.mark.parametrize("seed", [3, 2**31 + 77])
def test_a_sound_logreg_run_is_correct(seed):
    out = _execute(seed)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0
    assert set(out["metrics"]) == {"updates_per_s", "setup_s"}


def test_a_traced_logreg_run_is_correct_and_reads_no_mfu_on_the_cpu():
    out = _execute(5, trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"] == {}


def test_the_logreg_control_fails():
    cr = cell_mod.CellRun(logreg_cell(), 17, 0.5, False, "cpu", 0.0)
    cr.build()
    cr.first_rounds()
    cr.window()
    produced = cr.produced()
    cr.close()
    ref = cr.reference()
    limits = _limits()
    assert check.verdict(check.readings(produced, ref), limits)[0]
    control = cr.reference(prec=cr.family.CONTROL)
    ok, checks = check.verdict(
        check.readings(check.as_produced(control), ref), limits)
    assert not ok, checks


def _zero_delta(plain):
    def fault(theta, x, y, mask, *, cfg):
        delta, loss = plain(theta, x, y, mask, cfg=cfg)
        return torch.zeros_like(delta), loss
    return fault


def _half_batch(plain):
    def fault(theta, x, y, mask, *, cfg):
        mask = mask.clone()
        mask[1::2] = 0.0
        return plain(theta, x, y, mask, cfg=cfg)
    return fault


@pytest.mark.parametrize("fault", [_zero_delta, _half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_a_planted_fault_makes_a_logreg_run_incorrect(monkeypatch, fault):
    """The fault around logistic regression's CPU update, which the gang
    version calls per member."""
    from kafka_ps_tpu_torch.ops import fused_update as fu
    monkeypatch.setattr(fu, "local_update_plain",
                        fault(fu.local_update_plain))
    out = _execute()
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_mfu_counts_the_updates_by_the_configurations_family(path):
    cfg = _json(path)
    run = Run("c", cfg, {}, "NVIDIA H100 80GB HBM3", H100,
              profiled_calls=[(10, 0.5), (30, 1.5)])
    counts = manifest.kernel(manifest.family(cfg).COUNTS)
    want = (100.0 * 40 * cfg["num_workers"] * counts.flops_per_member(cfg)
            / 2.0 / H100["tf32_flop_per_s"])
    assert manifest.metric("mfu").read(run) == want
