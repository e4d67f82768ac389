"""The operations and bytes of one MLP local update (K4 for one
worker, K6 for a gang of `members` sharing one weights vector), from
its shapes.

A member's k steps on a slab of B rows: k + 1 forward passes (k for the
gradients, one for the loss at the updated weights), each x·W1ᵀ
(2·B·F·H) and hid·W2ᵀ (2·B·H·R), and k backward passes, each dhᵀ·x
(2·B·F·H), g·W2 and gᵀ·hid (2·B·H·R each):

    flops = 2·B·H·((2k + 1)·F + (3k + 1)·R)

Bytes: each member's slab (x, y, mask) read and its delta and loss
written once, the shared weights read once.  The bound of a call is
the larger of flops at the TF32 peak and bytes at the memory peak.
"""

from __future__ import annotations


def shapes(cfg: dict) -> dict:
    return {"B": cfg["buffer"]["max_size"], "F": cfg["num_features"],
            "H": cfg["hidden_dim"], "R": cfg["num_classes"] + 1,
            "k": cfg["num_max_iter"]}


def num_params(cfg: dict) -> int:
    s = shapes(cfg)
    return s["H"] * s["F"] + s["H"] + s["R"] * s["H"] + s["R"]


def flops_per_member(cfg: dict) -> float:
    s = shapes(cfg)
    return 2.0 * s["B"] * s["H"] * ((2 * s["k"] + 1) * s["F"]
                                    + (3 * s["k"] + 1) * s["R"])


def bytes_per_call(cfg: dict, members: float) -> float:
    s = shapes(cfg)
    p = num_params(cfg)
    slab = 4 * s["B"] * s["F"] + 4 * s["B"] + 4 * s["B"]
    return members * (slab + 4 * p + 4) + 4 * p


def bound_ms(cfg: dict, members: float, peak: dict) -> float:
    """The least time one call on `members` members could take."""
    return 1e3 * max(members * flops_per_member(cfg)
                     / peak["tf32_flop_per_s"],
                     bytes_per_call(cfg, members) / peak["hbm_bytes_per_s"])


def work_ms(cfg: dict, counts: dict, peak: dict) -> float:
    """The summed bounds of the K4 and K6 calls in `counts` (a delta of
    the program's kernel counters), each K6 call taken at the mean gang
    size of the calls counted."""
    single = counts.get("mlp_launches", 0)
    gangs = counts.get("mlp_batched_launches", 0)
    members = counts.get("mlp_batched_members", 0)
    out = single * bound_ms(cfg, 1, peak)
    if gangs:
        out += gangs * bound_ms(cfg, members / gangs, peak)
    return out
