"""The check that decides `correct`, driven on the CPU at a small size:
sound runs pass; the control (the reference in its model family's
control precision, TF32 operands, put in the program's place) fails;
and each fault the cells can have, planted under the timed path, makes
`correct` come out false."""

import numpy as np
import pytest
import torch

from portbench import cell as cell_mod
from portbench import check, manifest

CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]


def _execute(tiny, name, seed=3):
    cell = tiny(name)
    return cell_mod.execute(name, seed, 0.6, False, device="cpu",
                            cell=cell)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(tiny, name):
    out = _execute(tiny, name, seed=2**31 + 99)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(tiny, name):
    cr = cell_mod.CellRun(tiny(name), 17, 0.6, False, "cpu", 0.0)
    cr.build()
    cr.first_rounds()
    cr.window()
    produced = cr.produced()
    cr.close()
    ref = cr.reference()
    limits = check.load_limits(name)
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


def _plant(monkeypatch, fault):
    """`fault` around the MLP update's CPU version, which the gang
    version calls per member."""
    from kafka_ps_tpu_torch.ops import fused_update as fu
    monkeypatch.setattr(fu, "mlp_local_update_plain",
                        fault(fu.mlp_local_update_plain))


def _altered_row(monkeypatch):
    from kafka_ps_tpu_torch.data import buffer
    dense = buffer.sparse_to_dense

    def fault(rows, num_features):
        out = dense(rows, num_features)
        out[:, 0] += 1.0
        return out
    monkeypatch.setattr(buffer, "sparse_to_dense", fault)


def _altered_eval(monkeypatch):
    from kafka_ps_tpu_torch.models import metrics
    f1_acc = metrics.weighted_f1_accuracy

    def fault(preds, labels, n):
        f1, acc = f1_acc(preds, labels, n)
        return f1, acc + 0.05
    monkeypatch.setattr(metrics, "weighted_f1_accuracy", fault)


FAULTS = {
    "state_unchanged": lambda mp: _plant(mp, _zero_delta),
    "half_batch": lambda mp: _plant(mp, _half_batch),
    "row_altered_at_insert": _altered_row,
    "eval_answer_altered": _altered_eval,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_makes_the_run_incorrect(tiny, monkeypatch, name,
                                                 fault):
    FAULTS[fault](monkeypatch)
    out = _execute(tiny, name)
    assert not out["correct"], out["checks"]


def test_a_reading_that_is_not_a_number_fails():
    ok, checks = check.verdict({"loss_gap": float("nan")},
                               {"loss_gap": 1.0})
    assert not ok and np.isnan(checks["loss_gap"]["value"])
    assert not check.verdict({"x": 0.0}, {})[0]


@pytest.mark.parametrize("name", CELLS)
def test_the_float32_reference_in_the_programs_place_drifts_at_most_1(
        tiny, name):
    """A stretch's drift is the gap from the float64 witness over the
    float32 reference's own gap from it, at least a floor: the float32
    reference itself, put in the program's place, reads at most 1."""
    cr = cell_mod.CellRun(tiny(name), 29, 0.6, False, "cpu", 0.0)
    cr.build()
    cr.first_rounds()
    cr.close()
    out = check.readings(check.as_produced(cr.reference()), cr.reference())
    for key in ("loss_drift", "change_drift", "call_loss_drift",
                "call_change_drift"):
        assert 0.0 <= out[key] <= 1.0, (key, out[key])
