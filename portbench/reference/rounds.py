"""The rounds of a sequential (BSP) run, as the reference system defines
them: in round c every worker runs the local update on its own buffer
from the weights of round c-1, and the server adds server_lr times the
sum of the deltas (server_lr = 1/N).  The loss of a round is the mean
of the workers' losses.

`Model` holds the sizes; `rounds` runs a stretch of rounds on fixed
slabs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference import mlp
from portbench.reference.buffer import Buffer


@dataclass
class Model:
    features: int
    hidden: int
    rows: int            # classes + 1
    k: int
    lr: float
    workers: int
    server_lr: float

    @classmethod
    def from_config(cls, cfg: dict) -> "Model":
        n = cfg["num_workers"]
        slr = cfg.get("server_learning_rate")
        return cls(cfg["num_features"], cfg["hidden_dim"],
                   cfg["num_classes"] + 1, cfg["num_max_iter"],
                   cfg["local_learning_rate"], n,
                   1.0 / n if slr is None else slr)

    @property
    def sizes(self) -> dict:
        return {"f": self.features, "h": self.hidden, "r": self.rows}

    def leaves(self, theta: torch.Tensor) -> dict[str, torch.Tensor]:
        return mlp.leaves(theta, **self.sizes)

    def update(self, theta, slab, prec):
        x, y, m = slab
        return mlp.local_update(theta, x, y, m, k=self.k, lr=self.lr,
                                prec=prec, **self.sizes)

    def evaluate(self, theta, test, prec):
        return mlp.evaluate(theta, *test, prec=prec, **self.sizes)


def make_buffers(cfg: dict) -> list[Buffer]:
    b = cfg["buffer"]
    return [Buffer(cfg["num_features"], b["min_size"], b["max_size"],
                   b["coefficient"], b["arrival_window"])
            for _ in range(cfg["num_workers"])]


def slabs(buffers: list[Buffer], device, half_batch: bool = False):
    """Each buffer's (x, y, mask) on `device`.  `half_batch` leaves out
    every second filled row, a fault the check must catch."""
    out = []
    for buf in buffers:
        x, y, m = buf.slab()
        if half_batch:
            m[np.flatnonzero(m)[1::2]] = 0.0
        out.append((torch.from_numpy(x).to(device),
                    torch.from_numpy(y).to(device),
                    torch.from_numpy(m).to(device)))
    return out


def rounds(model: Model, theta: torch.Tensor, slab_list, count: int,
           prec) -> tuple[list[torch.Tensor], list[list[float]],
                          list[torch.Tensor]]:
    """`count` rounds from `theta` → (the weights after each round, the
    workers' losses of each round, the deltas of the last round)."""
    thetas, losses = [], []
    deltas: list[torch.Tensor] = []
    for _ in range(count):
        deltas, round_losses = [], []
        for slab in slab_list:
            d, loss = model.update(theta, slab, prec)
            deltas.append(d)
            round_losses.append(float(loss))
        theta = theta + model.server_lr * torch.stack(deltas).sum(0)
        thetas.append(theta)
        losses.append(round_losses)
    return thetas, losses, deltas
