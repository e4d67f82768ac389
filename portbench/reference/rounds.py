"""The rounds of a sequential (BSP) run, as the reference system defines
them: in round c every worker runs the local update on its own buffer
from the weights of round c-1, and the server adds server_lr times the
sum of the deltas (server_lr = 1/N by default).  The loss of a round is
the mean of the workers' losses.

`rounds` runs a stretch of rounds of a family's `Model` on fixed slabs.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.buffer import Buffer


def server_lr(cfg: dict) -> float:
    slr = cfg.get("server_learning_rate")
    return 1.0 / cfg["num_workers"] if slr is None else slr


def make_buffers(cfg: dict, fields) -> list[Buffer]:
    """One buffer a worker, its records of `fields` (shape, dtype)."""
    b = cfg["buffer"]
    return [Buffer(fields, b["min_size"], b["max_size"],
                   b["coefficient"], b["arrival_window"])
            for _ in range(cfg["num_workers"])]


def slabs(buffers: list[Buffer], device, half_batch: bool = False):
    """Each buffer's (record arrays..., y, mask) on `device`.
    `half_batch` leaves out every second filled row, a fault the check
    must catch."""
    out = []
    for buf in buffers:
        *arrays, m = buf.slab()
        if half_batch:
            m[np.flatnonzero(m)[1::2]] = 0.0
        out.append(tuple(torch.from_numpy(a).to(device)
                         for a in (*arrays, m)))
    return out


def rounds(model, theta: torch.Tensor, slab_list, count: int, prec,
           lr: float) -> tuple[list[torch.Tensor], list[list[float]],
                               list[torch.Tensor]]:
    """`count` rounds from `theta` → (the weights after each round, the
    workers' losses of each round, the deltas of the last round); `lr`
    is the server's learning rate."""
    thetas, losses = [], []
    deltas: list[torch.Tensor] = []
    for _ in range(count):
        deltas, round_losses = [], []
        for slab in slab_list:
            d, loss = model.update(theta, slab, prec)
            deltas.append(d)
            round_losses.append(float(loss))
        theta = theta + lr * torch.stack(deltas).sum(0)
        thetas.append(theta)
        losses.append(round_losses)
    return thetas, losses, deltas
