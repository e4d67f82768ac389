"""Multinomial logistic regression (counterpart of
kafka_ps_tpu/models/logreg.py).

Parameter layout: a flat float32 vector of (C+1)*F coefficients
(row-major, one row per class 0..C) followed by (C+1) intercepts — 6150
keys for F=1024, C=5.  Labels are 1..C; class row 0 exists but is never
observed.

`local_update` here is the plain PyTorch form of the worker's k-step
solver: a Python loop of `num_max_iter` full-batch gradient steps with
the closed-form gradient, then the loss at the updated parameters.  It
is the version the CUDA kernel (ops/fused_update.py) is held against.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kafka_ps_tpu_torch.utils.config import ModelConfig


class LogRegParams(NamedTuple):
    """Dense views over the flat parameter vector."""

    weights: torch.Tensor    # (C+1, F) coefficient matrix
    intercept: torch.Tensor  # (C+1,)

    @property
    def flat(self) -> torch.Tensor:
        return torch.cat([self.weights.reshape(-1), self.intercept])


def init_params(cfg: ModelConfig, device,
                dtype=torch.float32) -> LogRegParams:
    """Zero-initialized, like the reference."""
    return LogRegParams(
        weights=torch.zeros((cfg.num_rows, cfg.num_features), dtype=dtype,
                            device=device),
        intercept=torch.zeros((cfg.num_rows,), dtype=dtype, device=device))


def unflatten(theta: torch.Tensor, cfg: ModelConfig) -> LogRegParams:
    """Flat vector → (W, b) views.  Inverse of `LogRegParams.flat`."""
    n_coef = cfg.num_rows * cfg.num_features
    return LogRegParams(
        weights=theta[:n_coef].reshape(cfg.num_rows, cfg.num_features),
        intercept=theta[n_coef:])


def one_hot(y: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of integer labels, built by comparison so that a
    label outside [0, n) gives an all-zero row, as jax.nn.one_hot does
    (torch.nn.functional.one_hot raises instead)."""
    classes = torch.arange(n, device=y.device)
    return (y.reshape(-1, 1) == classes).to(torch.float32)


def logits(params: LogRegParams, x: torch.Tensor) -> torch.Tensor:
    """(B, F) @ (F, C+1) + b."""
    return x @ params.weights.T + params.intercept


def loss_fn(params: LogRegParams, x: torch.Tensor, y: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Masked mean softmax cross-entropy.  An out-of-range label adds
    zero NLL (one-hot row of zeros) rather than reading past the class
    axis."""
    logp = torch.log_softmax(logits(params, x), dim=-1)
    nll = -(logp * one_hot(y, params.weights.shape[0])).sum(dim=-1)
    denom = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask).sum() / denom


def grad_loss_onehot(theta: torch.Tensor, x: torch.Tensor,
                     onehot: torch.Tensor, mask: torch.Tensor,
                     cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """G = (softmax − onehot)·mask/n; ∇W = Gᵀ·x, ∇b = Σ G — with the
    one-hot precomputed by callers that run many steps on one batch."""
    params = unflatten(theta, cfg)
    logp = torch.log_softmax(logits(params, x), dim=-1)
    denom = torch.clamp(mask.sum(), min=1.0)
    nll = -(logp * onehot).sum(dim=-1)
    loss = (nll * mask).sum() / denom
    g = (torch.exp(logp) - onehot) * (mask / denom)[:, None]   # [B, C+1]
    grad = LogRegParams(weights=g.T @ x, intercept=g.sum(dim=0)).flat
    return grad, loss


def local_update(theta: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 mask: torch.Tensor, *, cfg: ModelConfig
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """cfg.num_max_iter full-batch gradient steps on the buffer →
    (delta, loss at the updated parameters)."""
    onehot = one_hot(y, cfg.num_rows)
    lr = cfg.local_learning_rate
    t = theta
    for _ in range(cfg.num_max_iter):
        g, _ = grad_loss_onehot(t, x, onehot, mask, cfg)
        t = t - lr * g
    _, final_loss = grad_loss_onehot(t, x, onehot, mask, cfg)
    return t - theta, final_loss


def sparse_to_dense(rows: list[dict[int, float]],
                    num_features: int) -> np.ndarray:
    """Sparse feature maps → dense float32 batch."""
    out = np.zeros((len(rows), num_features), dtype=np.float32)
    for i, r in enumerate(rows):
        for k, v in r.items():
            out[i, int(k)] = v
    return out
