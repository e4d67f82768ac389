"""Arithmetic the model families of the reference share: the precision
of a product, the one-hot labels and the test metrics from class scores.

Every product of a family goes through `Precision.mm`: plain float32
with TF32 off, or, for the control, each operand rounded to TF32 (10
mantissa bits, round to nearest even) with float32 sums, the arithmetic
of TF32 tensor cores, the same on the CPU and the card.
"""

from __future__ import annotations

import torch


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
TF32 = Precision(True)


def onehot(y: torch.Tensor, r: int) -> torch.Tensor:
    return (y.reshape(-1, 1).long()
            == torch.arange(r, device=y.device)).to(torch.float32)


def evaluation(z: torch.Tensor, labels: torch.Tensor,
                 loss: torch.Tensor) -> tuple[float, float, float]:
    """(test loss, weighted F1, accuracy) from the class scores `z` and
    the one-hot `labels`; argmax takes the first of tied maxima."""
    r = labels.shape[1]
    preds = torch.argmax(z, dim=-1)
    cm = labels.T @ onehot(preds, r)        # [true, predicted] counts
    tp = torch.diagonal(cm)
    support = cm.sum(dim=1)
    predicted = cm.sum(dim=0)
    precision = tp / torch.clamp(predicted, min=1.0)
    recall = tp / torch.clamp(support, min=1.0)
    f1 = 2 * precision * recall / torch.clamp(precision + recall, min=1e-12)
    total = torch.clamp(support.sum(), min=1.0)
    return (float(loss), float((f1 * support).sum() / total),
            float(tp.sum() / total))
