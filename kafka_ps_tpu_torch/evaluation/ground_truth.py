"""Offline ground-truth oracle (counterpart of
kafka_ps_tpu/evaluation/ground_truth.py, itself a port of the reference's
evaluation/python-ground-truth-algorithm.ipynb, cells 4-7).

The reference trains an offline model on the full training CSV and
compares it with the streaming system through sklearn's
classification_report.  Here the oracle is the multinomial logistic
regression the streaming system trains, fitted full-batch: `steps` plain
gradient steps on the device with the closed-form gradient of
models/logreg.grad_loss_onehot (the one-hot built once, as the JAX
package's scan hoists it), then models/metrics.evaluate on the test set.

The JAX module compiles the whole fit as one jitted lax.scan and counts
its traces (`_fit_traces`) to pin its jit cache; PyTorch runs eagerly,
so the port has neither the program nor the counter.  The device follows
utils/config.resolve_device: the card unless device="cpu" or
KPS_PLATFORM=cpu.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kafka_ps_tpu_torch.models import logreg
from kafka_ps_tpu_torch.models import metrics as metrics_mod
from kafka_ps_tpu_torch.utils.config import ModelConfig, resolve_device


@dataclasses.dataclass(frozen=True)
class GroundTruth:
    theta: np.ndarray
    f1: float
    accuracy: float
    loss: float
    report: str          # sklearn classification_report text


def train_offline(train_x: np.ndarray, train_y: np.ndarray,
                  cfg: ModelConfig, *, steps: int = 500,
                  learning_rate: float = 0.5, device=None) -> np.ndarray:
    """Full-batch gradient descent from zero: `steps` steps of
    theta - learning_rate * grad over every training row."""
    dev = resolve_device(device)
    x = torch.as_tensor(train_x, dtype=torch.float32, device=dev)
    y = torch.as_tensor(train_y, dtype=torch.int32, device=dev)
    mask = torch.ones((x.shape[0],), dtype=torch.float32, device=dev)
    onehot = logreg.one_hot(y, cfg.num_rows)
    theta = torch.zeros((cfg.num_params,), dtype=torch.float32, device=dev)
    for _ in range(steps):
        g, _loss = logreg.grad_loss_onehot(theta, x, onehot, mask, cfg)
        theta = theta - learning_rate * g
    return theta.cpu().numpy()


def classification_report_text(theta: np.ndarray, test_x: np.ndarray,
                               test_y: np.ndarray, cfg: ModelConfig,
                               device=None) -> str:
    from sklearn.metrics import classification_report
    dev = resolve_device(device)
    params = logreg.unflatten(torch.as_tensor(theta, device=dev), cfg)
    preds = torch.argmax(logreg.logits(params, torch.as_tensor(
        test_x, dtype=torch.float32, device=dev)), dim=-1)
    return classification_report(test_y, preds.cpu().numpy(),
                                 zero_division=0)


def compute(train_x: np.ndarray, train_y: np.ndarray,
            test_x: np.ndarray, test_y: np.ndarray,
            cfg: ModelConfig | None = None, *, steps: int = 500,
            learning_rate: float = 0.5, device=None) -> GroundTruth:
    cfg = cfg or ModelConfig()
    dev = resolve_device(device)
    theta = train_offline(train_x, train_y, cfg, steps=steps,
                          learning_rate=learning_rate, device=dev)
    m = metrics_mod.evaluate(
        torch.as_tensor(theta, device=dev),
        torch.as_tensor(test_x, dtype=torch.float32, device=dev),
        torch.as_tensor(test_y, dtype=torch.int32, device=dev), cfg=cfg)
    return GroundTruth(
        theta=theta,
        f1=float(m.f1),
        accuracy=float(m.accuracy),
        loss=float(m.loss),
        report=classification_report_text(theta, test_x, test_y, cfg,
                                          device=dev),
    )
