"""The one-hidden-layer MLP classifier in plain float32 PyTorch: the
model family of the configurations whose `reference` names this file.

Flat layout W1 [H, F] | b1 [H] | W2 [R, H] | b2 [R], R = classes + 1
(labels run 1..C; row 0 is never a label).  Initial weights: W1 and W2
He-normal from a CPU `torch.Generator` seeded 0, biases zero, the
weights the system's server starts from.

`local_update` is the worker's solver: k full-batch gradient steps of
the masked mean cross-entropy, the gradient in closed form,

    g   = (softmax(z) - onehot) * mask / max(sum(mask), 1)
    dW2 = g^T hid,  db2 = sum g,  dh = (g W2) * (pre > 0)
    dW1 = dh^T x,   db1 = sum dh,

then the loss at the updated weights.  `evaluate` gives the test loss,
the support-weighted F1 and the accuracy.  Every product goes through
`Precision.mm` (numerics.py); the control is TF32 operands.

What the harness takes from a family module: `Model` (sizes, initial
weights, leaves, the k-step update, the test evaluation, and `follow`,
what of the weights the check follows: all of them here), `F32` and
`CONTROL` (the check's precision and its control's), `ROWS` (the rows
the model reads, `rows/<ROWS>.py`), `COUNTS` (its operations per update,
`kernels/<COUNTS>.py`) and `TINY` (its sizes in the CPU tests).
"""

from __future__ import annotations

import torch

from portbench.reference.follow import Follow
from portbench.reference.numerics import F32, TF32, Precision, evaluation
from portbench.reference.numerics import onehot as _onehot

INIT_SEED = 0
CONTROL = TF32
ROWS = "dense"
COUNTS = "mlp_update"
TINY = {"num_features": 32, "hidden_dim": 16}


def num_params(f: int, h: int, r: int) -> int:
    return h * f + h + r * h + r


def leaves(theta: torch.Tensor, f: int, h: int,
           r: int) -> dict[str, torch.Tensor]:
    o1 = h * f
    o2 = o1 + h
    o3 = o2 + r * h
    return {"W1": theta[:o1].reshape(h, f), "b1": theta[o1:o2],
            "W2": theta[o2:o3].reshape(r, h), "b2": theta[o3:]}


def init(f: int, h: int, r: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(INIT_SEED)
    w1 = torch.randn((h, f), generator=gen, dtype=torch.float32) \
        * (2.0 / f) ** 0.5
    w2 = torch.randn((r, h), generator=gen, dtype=torch.float32) \
        * (2.0 / h) ** 0.5
    return torch.cat([w1.reshape(-1), torch.zeros(h), w2.reshape(-1),
                      torch.zeros(r)])


def _forward(p, x, prec):
    pre = prec.mm(x, p["W1"].T) + p["b1"]
    hid = torch.relu(pre)
    z = prec.mm(hid, p["W2"].T) + p["b2"]
    return pre, hid, z


def _loss(p, x, onehot, mask, prec) -> torch.Tensor:
    logp = torch.log_softmax(_forward(p, x, prec)[2], dim=-1)
    nll = -(logp * onehot).sum(dim=-1)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def local_update(theta: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 mask: torch.Tensor, *, f: int, h: int, r: int, k: int,
                 lr: float, prec: Precision = F32
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """k gradient steps on (x, y, mask) → (delta, loss at the updated
    weights)."""
    onehot = _onehot(y, r)
    denom = torch.clamp(mask.sum(), min=1.0)
    scale = (mask * onehot.sum(dim=-1) / denom)[:, None]
    t = theta
    for _ in range(k):
        p = leaves(t, f, h, r)
        pre, hid, z = _forward(p, x, prec)
        g = (torch.softmax(z, dim=-1) - onehot) * scale
        dh = prec.mm(g, p["W2"]) * (pre > 0).to(torch.float32)
        grad = torch.cat([prec.mm(dh.T, x).reshape(-1), dh.sum(dim=0),
                          prec.mm(g.T, hid).reshape(-1), g.sum(dim=0)])
        t = t - lr * grad
    return t - theta, _loss(leaves(t, f, h, r), x, onehot, mask, prec)


def evaluate(theta: torch.Tensor, x: torch.Tensor, y: torch.Tensor, *,
             f: int, h: int, r: int, prec: Precision = F32
             ) -> tuple[float, float, float]:
    """(test loss, weighted F1, accuracy)."""
    p = leaves(theta, f, h, r)
    z = _forward(p, x, prec)[2]
    onehot = _onehot(y, r)
    loss = _loss(p, x, onehot, torch.ones(len(y), device=x.device), prec)
    return evaluation(z, onehot, loss)


class Model:
    """The sizes of configuration `cfg` and the arithmetic the check
    runs on them; `rows` are the records of every row handed over (the
    MLP follows all of its weights and reads none of them)."""

    def __init__(self, cfg: dict, rows: list | None = None):
        self.sizes = {"f": cfg["num_features"], "h": cfg["hidden_dim"],
                      "r": cfg["num_classes"] + 1}
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
