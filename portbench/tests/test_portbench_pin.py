"""The check's readings of mlp4096.fused.backlog at its CPU size are
pinned, bit for bit (float hex), for two seeds: the model family's code
moved behind reference/mlp.py with the same operations in the same
order, and whatever moves it next has to show up here.  The seven
numbers the check has compared since before the move keep the values
recorded on the commit before it; the four stretch numbers judged
against the float64 witness (check.py: loss_drift, change_drift,
call_loss_drift, call_change_drift), which replaced the plain gaps of
those stretches, are pinned at their first values."""

import pytest

from portbench import cell as cell_mod

NAME = "mlp4096.fused.backlog"
PINNED = {
    20231: {
        "loss_drift": "0x1.f227fe52e8584p-5",
        "update_gap": "0x0.0p+0",
        "change_drift": "0x1.0fb61f1afe4e1p-3",
        "step_loss_gap": "0x1.f35f5860f5cdbp-25",
        "step_update_gap": "0x1.44579101c6bdbp-23",
        "call_loss_drift": "0x1.503aa3c8bc3b6p-4",
        "call_change_drift": "0x1.5d959c6bcb300p-2",
        "eval_loss_gap": "0x0.0p+0",
        "eval_f1_gap": "0x0.0p+0",
        "eval_acc_gap": "0x0.0p+0",
        "buffer_mismatch": "0x0.0p+0",
    },
    2**31 + 7: {
        "loss_drift": "0x1.8f4f420ccb19fp-5",
        "update_gap": "0x0.0p+0",
        "change_drift": "0x1.a2f7a085517d9p-5",
        "step_loss_gap": "0x1.6898828b5b980p-24",
        "step_update_gap": "0x1.2d9db4d5c216ep-22",
        "call_loss_drift": "0x1.09c2892ffe29cp-3",
        "call_change_drift": "0x1.10cd437f76484p-2",
        "eval_loss_gap": "0x0.0p+0",
        "eval_f1_gap": "0x0.0p+0",
        "eval_acc_gap": "0x0.0p+0",
        "buffer_mismatch": "0x0.0p+0",
    },
}


@pytest.mark.parametrize("seed", sorted(PINNED))
def test_the_readings_are_the_pinned_ones_bit_for_bit(tiny, seed):
    out = cell_mod.execute(NAME, seed, 0.3, False, device="cpu",
                           cell=tiny(NAME))
    got = {k: float(v["value"]).hex() for k, v in out["checks"].items()}
    assert got == PINNED[seed]
    assert out["correct"]
