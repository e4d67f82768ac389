"""The kernel families' operation counts: the MLP's give the bounds the
port's kernel table (PERF.md) was measured against; logistic
regression's counts the products of its k steps."""

import pytest

from portbench import manifest
from portbench.peaks import PEAKS

H100 = PEAKS["NVIDIA H100 80GB HBM3"]


def _cfg(hidden):
    return {"buffer": {"max_size": 1024}, "num_features": 1024,
            "hidden_dim": hidden, "num_classes": 5, "num_max_iter": 2}


@pytest.mark.parametrize("hidden,members,bound", [
    (4096, 1, 0.087479),
    (4096, 4, 0.349915),
    (128, 1, 0.002734),
    (128, 4, 0.010935),
])
def test_bounds_match_the_kernel_table(hidden, members, bound):
    k = manifest.kernel("mlp_update")
    assert k.bound_ms(_cfg(hidden), members, H100) == pytest.approx(
        bound, abs=5e-7)


def test_work_is_the_bounds_of_the_calls_counted():
    cfg = _cfg(4096)
    k = manifest.kernel("mlp_update")
    counts = {"mlp_launches": 3, "mlp_batched_launches": 5,
              "mlp_batched_members": 20}
    assert k.work_ms(cfg, counts, H100) == pytest.approx(
        3 * 0.0874788 + 5 * 0.3499151, rel=1e-5)


def test_logreg_counts_k_plus_1_forward_and_k_backward_products():
    cfg = {"buffer": {"max_size": 1024}, "num_features": 1024,
           "num_classes": 5, "num_max_iter": 2}
    k = manifest.kernel("logreg_update")
    assert k.flops_per_member(cfg) == 5 * 2 * 1024 * 1024 * 6
