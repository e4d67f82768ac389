"""The one-hidden-layer MLP classifier in plain float32 PyTorch.

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
the support-weighted F1 and the accuracy (argmax takes the first of
tied maxima).

Every product goes through `Precision.mm`: plain float32 with TF32 off,
or, for the control, each operand rounded to TF32 (10 mantissa bits,
round to nearest even) with float32 sums, the arithmetic of TF32 tensor
cores, the same on the CPU and the card.
"""

from __future__ import annotations

import torch

INIT_SEED = 0


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


def round_tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value (ties to even), as float32."""
    u = a.contiguous().view(torch.int32)
    u = (u + 0x0FFF + ((u >> 13) & 1)) & ~0x1FFF
    return u.view(torch.float32)


class Precision:
    """float32 with TF32 off (`tf32=False`), or TF32 operands."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = round_tf32(a), round_tf32(b)
        return a @ b


F32 = Precision(False)


def _onehot(y: torch.Tensor, r: int) -> torch.Tensor:
    return (y.reshape(-1, 1).long()
            == torch.arange(r, device=y.device)).to(torch.float32)


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
    preds = torch.argmax(z, dim=-1)
    cm = onehot.T @ _onehot(preds, r)       # [true, predicted] counts
    tp = torch.diagonal(cm)
    support = cm.sum(dim=1)
    predicted = cm.sum(dim=0)
    precision = tp / torch.clamp(predicted, min=1.0)
    recall = tp / torch.clamp(support, min=1.0)
    f1 = 2 * precision * recall / torch.clamp(precision + recall, min=1e-12)
    total = torch.clamp(support.sum(), min=1.0)
    return (float(loss), float((f1 * support).sum() / total),
            float(tp.sum() / total))
