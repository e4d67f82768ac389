"""The operations of one logistic-regression local update (K1 for one
worker, K2 for each member of a gang), from its shapes: the count `mfu`
takes for the configurations of reference/logreg.py.

A member's k steps on a slab of B rows: k + 1 forward passes, each x·Wᵀ
(2·B·F·R), and k backward passes, each gᵀ·x (2·B·F·R):

    flops = 2·B·F·R·(2k + 1)
"""

from __future__ import annotations


def flops_per_member(cfg: dict) -> float:
    b, f = cfg["buffer"]["max_size"], cfg["num_features"]
    r, k = cfg["num_classes"] + 1, cfg["num_max_iter"]
    return 2.0 * b * f * r * (2 * k + 1)
