"""Test-set evaluation: weighted F1, accuracy and loss (counterpart of
kafka_ps_tpu/models/metrics.py).

Spark's "f1" is the support-weighted mean of per-class F1 and
"accuracy" plain accuracy; both come from one confusion matrix.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kafka_ps_tpu_torch.models.logreg import (logits, loss_fn, one_hot,
                                              unflatten)
from kafka_ps_tpu_torch.utils.config import ModelConfig


class Metrics(NamedTuple):
    f1: torch.Tensor        # support-weighted F1
    accuracy: torch.Tensor
    loss: torch.Tensor      # mean CE on the test set


def confusion_matrix(preds: torch.Tensor, labels: torch.Tensor,
                     n: int) -> torch.Tensor:
    """(n, n) counts[true, pred]; labels outside [0, n) count nowhere."""
    return one_hot(labels, n).T @ one_hot(preds, n)


def weighted_f1_accuracy(preds: torch.Tensor, labels: torch.Tensor, n: int):
    cm = confusion_matrix(preds, labels, n)
    tp = torch.diagonal(cm)
    support = cm.sum(dim=1)         # rows: true counts
    predicted = cm.sum(dim=0)       # cols: predicted counts
    precision = tp / torch.clamp(predicted, min=1.0)
    recall = tp / torch.clamp(support, min=1.0)
    f1 = 2 * precision * recall / torch.clamp(precision + recall, min=1e-12)
    total = torch.clamp(support.sum(), min=1.0)
    return (f1 * support).sum() / total, tp.sum() / total


def evaluate(theta: torch.Tensor, x_test: torch.Tensor, y_test: torch.Tensor,
             *, cfg: ModelConfig) -> Metrics:
    """Full-test-set metrics.  torch.argmax, like jnp.argmax, picks the
    first of tied maxima."""
    params = unflatten(theta, cfg)
    preds = torch.argmax(logits(params, x_test), dim=-1)
    ones = torch.ones(x_test.shape[0], dtype=torch.float32,
                      device=x_test.device)
    loss = loss_fn(params, x_test, y_test, ones)
    f1, acc = weighted_f1_accuracy(preds, y_test, cfg.num_rows)
    return Metrics(f1=f1, accuracy=acc, loss=loss)


def stack_evaluations(evaluate_fn, thetas, x_test, y_test) -> Metrics:
    """Metrics with (k,)-leading fields for k thetas: the standalone
    evaluation once per theta, stacked, so row i is bitwise equal to
    `evaluate_fn(thetas[i], ...)` (torch does not promise that one
    stacked product equals k single ones bit for bit)."""
    ms = [evaluate_fn(t, x_test, y_test) for t in thetas]
    return Metrics(*(torch.stack([getattr(m, f) for m in ms])
                     for f in Metrics._fields))
