"""Multinomial logistic regression in plain float32 PyTorch: the model
the reference system trains (its LogisticRegressionTaskSpark), the
model family of the configurations whose `reference` names this file.

As the reference defines it: a flat vector of (C+1)·F coefficients, one
row of F per class 0..C, then (C+1) intercepts (labels run 1..C; row 0
is never a label, there because the class axis runs 0..max label), zero
at the start; class scores z = x·Wᵀ + b; the masked mean softmax
cross-entropy; a worker's delta is its weights after its k local steps
less the weights it started from; the test metrics are the
support-weighted F1 and the accuracy of argmax z (the first of tied
maxima).  Its departures from the reference, which the system shares:

  * the k local steps are full-batch gradient steps at the local
    learning rate, g = (softmax(z) - onehot)·mask / max(Σ mask, 1),
    dW = gᵀx, db = Σ g, not Spark's k L-BFGS iterations, and there is
    no regularisation;
  * the loss is the masked mean cross-entropy at the updated weights,
    not L-BFGS's last objective;
  * every intercept's delta is kept, also of classes the batch lacks
    (Spark's is 0 there), and the server adds every key, the last
    intercept included (the reference's key range leaves it out).

Every product goes through `Precision.mm` (numerics.py); the control is
TF32 operands.  What a family module gives the harness is listed in
mlp.py's docstring.
"""

from __future__ import annotations

import torch

from portbench.reference.follow import Follow
from portbench.reference.numerics import (F32, TF32, Precision, evaluation,
                                          onehot)

CONTROL = TF32
ROWS = "dense"
COUNTS = "logreg_update"
TINY = {"num_features": 32}


def leaves(theta: torch.Tensor, f: int, r: int) -> dict[str, torch.Tensor]:
    return {"W": theta[:r * f].reshape(r, f), "b": theta[r * f:]}


def init(f: int, r: int) -> torch.Tensor:
    return torch.zeros(r * f + r, dtype=torch.float32)


def _scores(p, x, prec) -> torch.Tensor:
    return prec.mm(x, p["W"].T) + p["b"]


def _loss(z, labels, mask) -> torch.Tensor:
    nll = -(torch.log_softmax(z, dim=-1) * labels).sum(dim=-1)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def local_update(theta: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 mask: torch.Tensor, *, f: int, r: int, k: int, lr: float,
                 prec: Precision = F32) -> tuple[torch.Tensor, torch.Tensor]:
    """k gradient steps on (x, y, mask) → (delta, loss at the updated
    weights)."""
    labels = onehot(y, r)
    weight = (mask / torch.clamp(mask.sum(), min=1.0))[:, None]
    t = theta
    for _ in range(k):
        p = leaves(t, f, r)
        g = (torch.softmax(_scores(p, x, prec), dim=-1) - labels) * weight
        t = t - lr * torch.cat([prec.mm(g.T, x).reshape(-1), g.sum(dim=0)])
    return t - theta, _loss(_scores(leaves(t, f, r), x, prec), labels, mask)


def evaluate(theta: torch.Tensor, x: torch.Tensor, y: torch.Tensor, *,
             f: int, r: int, prec: Precision = F32
             ) -> tuple[float, float, float]:
    """(test loss, weighted F1, accuracy)."""
    z = _scores(leaves(theta, f, r), x, prec)
    labels = onehot(y, r)
    return evaluation(z, labels, _loss(z, labels, torch.ones_like(z[:, 0])))


class Model:
    """The sizes of configuration `cfg` and the arithmetic the check
    runs on them; logistic regression follows all of its weights."""

    def __init__(self, cfg: dict, rows: list | None = None):
        self.sizes = {"f": cfg["num_features"], "r": cfg["num_classes"] + 1}
        self.k = cfg["num_max_iter"]
        self.lr = cfg["local_learning_rate"]
        self.follow = Follow()

    def theta0(self) -> torch.Tensor:
        return self.follow.take(init(**self.sizes))

    def leaves(self, theta: torch.Tensor) -> dict[str, torch.Tensor]:
        return leaves(theta, **self.sizes)

    def update(self, theta, slab, prec):
        x, y, m = slab
        return local_update(theta, x, y, m, k=self.k, lr=self.lr,
                            prec=prec, **self.sizes)

    def evaluate(self, theta, test, prec):
        return evaluate(theta, *test, prec=prec, **self.sizes)
