"""A test-only model family: the MLP of reference/mlp.py, its weights
followed as a permutation of all their positions (`Follow` with an
index).  Where that part is all of the weights, the check's gaps are the
whole vector's, bit for bit: the program's snapshots, the reference's
initial weights, its rounds and its leaves all go through the index."""

from __future__ import annotations

import torch

from portbench.reference import mlp
from portbench.reference.follow import Follow

F32, CONTROL, ROWS, COUNTS, TINY = (mlp.F32, mlp.CONTROL, mlp.ROWS,
                                    mlp.COUNTS, mlp.TINY)


class Model(mlp.Model):
    """The MLP on the followed vector θ[index]."""

    def __init__(self, cfg: dict, rows: list | None = None):
        super().__init__(cfg, rows)
        n = mlp.num_params(**self.sizes)
        index = torch.randperm(n, generator=torch.Generator().manual_seed(1))
        self.follow = Follow(index)
        self.inverse = torch.argsort(index)

    def _whole(self, theta: torch.Tensor) -> torch.Tensor:
        return theta[self.inverse.to(theta.device)]

    def leaves(self, theta):
        return super().leaves(self._whole(theta))

    def update(self, theta, slab, prec):
        delta, loss = super().update(self._whole(theta), slab, prec)
        return self.follow.take(delta), loss

    def evaluate(self, theta, test, prec):
        return super().evaluate(self._whole(theta), test, prec)
