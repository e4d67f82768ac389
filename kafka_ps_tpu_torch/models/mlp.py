"""The second model family: a one-hidden-layer MLP classifier
(counterpart of kafka_ps_tpu/models/mlp.py).

Layout (flat, contiguous — the parameter server's key space), the same as
the JAX package's, so its parameters carry over unchanged
(weights.from_jax_params):

    W1 [H, F] | b1 [H] | W2 [C+1, H] | b2 [C+1]

`local_update` is the plain PyTorch form of the worker's k-step solver:
k full-batch gradient steps on the closed-form gradient, written out by
hand (no autograd), then the loss at the updated parameters.  It equals
`jax.grad` of the reference's masked one-hot cross-entropy: a row whose
label lies outside [0, C] has an all-zero one-hot row, so it gets ZERO
gradient (`row_valid`; logreg's closed form keeps its softmax term
instead), and relu'(0) = 0.  It is the version the CUDA kernels K4/K6
(ops/fused_update.py) are held against.

Initialization differs from the JAX package's on purpose: that one draws
He-normal weights from `jax.random.PRNGKey(0)`, which torch cannot
reproduce.  Here W1 and W2 are He-normal from a `torch.Generator` seeded
0 (on the CPU, so every device gets the same numbers), biases zero.
Comparisons with the JAX package carry its θ₀ across instead.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kafka_ps_tpu_torch.models import metrics as metrics_mod
from kafka_ps_tpu_torch.models.logreg import one_hot
from kafka_ps_tpu_torch.utils.config import ModelConfig

INIT_SEED = 0


class MLPParams(NamedTuple):
    w1: torch.Tensor    # [H, F]
    b1: torch.Tensor    # [H]
    w2: torch.Tensor    # [C+1, H]
    b2: torch.Tensor    # [C+1]


def num_params(cfg: ModelConfig) -> int:
    h, f, c = cfg.hidden_dim, cfg.num_features, cfg.num_rows
    return h * f + h + c * h + c


def unflatten(theta: torch.Tensor, cfg: ModelConfig) -> MLPParams:
    """Flat vector → views.  Inverse of `flatten`."""
    h, f, c = cfg.hidden_dim, cfg.num_features, cfg.num_rows
    o1 = h * f
    o2 = o1 + h
    o3 = o2 + c * h
    return MLPParams(w1=theta[:o1].reshape(h, f), b1=theta[o1:o2],
                     w2=theta[o2:o3].reshape(c, h), b2=theta[o3:])


def flatten(p: MLPParams) -> torch.Tensor:
    return torch.cat([p.w1.reshape(-1), p.b1, p.w2.reshape(-1), p.b2])


def init_params(cfg: ModelConfig, device) -> torch.Tensor:
    """He-normal W1 and W2 from a CPU torch.Generator seeded INIT_SEED,
    zero biases; flat, on `device`."""
    gen = torch.Generator().manual_seed(INIT_SEED)
    w1 = torch.randn((cfg.hidden_dim, cfg.num_features), generator=gen,
                     dtype=torch.float32) * (2.0 / cfg.num_features) ** 0.5
    w2 = torch.randn((cfg.num_rows, cfg.hidden_dim), generator=gen,
                     dtype=torch.float32) * (2.0 / cfg.hidden_dim) ** 0.5
    return flatten(MLPParams(
        w1=w1, b1=torch.zeros(cfg.hidden_dim), w2=w2,
        b2=torch.zeros(cfg.num_rows))).to(device)


def logits(params: MLPParams, x: torch.Tensor) -> torch.Tensor:
    hidden = torch.relu(x @ params.w1.T + params.b1)
    return hidden @ params.w2.T + params.b2


def _loss_onehot(theta, x, onehot, mask, cfg: ModelConfig) -> torch.Tensor:
    """Masked mean cross-entropy against a precomputed one-hot."""
    logp = torch.log_softmax(logits(unflatten(theta, cfg), x), dim=-1)
    nll = -(logp * onehot).sum(dim=-1)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def grad_loss_onehot(theta: torch.Tensor, x: torch.Tensor,
                     onehot: torch.Tensor, mask: torch.Tensor,
                     cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradient of `_loss_onehot` in closed form, and the loss:
        g  = (softmax − onehot) · mask · row_valid / max(Σmask, 1)
        dW2 = gᵀ·hid,  db2 = Σ g,  dh = (g·W2) · (pre > 0)
        dW1 = dhᵀ·x,   db1 = Σ dh"""
    p = unflatten(theta, cfg)
    pre = x @ p.w1.T + p.b1
    hid = torch.relu(pre)
    logp = torch.log_softmax(hid @ p.w2.T + p.b2, dim=-1)
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (-(logp * onehot).sum(dim=-1) * mask).sum() / denom
    row_valid = onehot.sum(dim=-1)
    g = (torch.exp(logp) - onehot) * (mask * row_valid / denom)[:, None]
    dh = (g @ p.w2) * (pre > 0).to(torch.float32)
    grad = flatten(MLPParams(w1=dh.T @ x, b1=dh.sum(dim=0),
                             w2=g.T @ hid, b2=g.sum(dim=0)))
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
    return t - theta, _loss_onehot(t, x, onehot, mask, cfg)


def evaluate(theta: torch.Tensor, x_test: torch.Tensor, y_test: torch.Tensor,
             *, cfg: ModelConfig) -> metrics_mod.Metrics:
    """Full-test-set metrics (weighted F1, accuracy, mean CE)."""
    preds = torch.argmax(logits(unflatten(theta, cfg), x_test), dim=-1)
    ones = torch.ones(x_test.shape[0], dtype=torch.float32,
                      device=x_test.device)
    loss = _loss_onehot(theta, x_test, one_hot(y_test, cfg.num_rows), ones,
                        cfg)
    f1, acc = metrics_mod.weighted_f1_accuracy(preds, y_test, cfg.num_rows)
    return metrics_mod.Metrics(f1=f1, accuracy=acc, loss=loss)


class MLPTask:
    """The MLP over the flat W1|b1|W2|b2 layout (models/task.py)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    @property
    def num_params(self) -> int:
        return num_params(self.cfg)

    def init_params(self, device):
        return init_params(self.cfg, device)

    def evaluate(self, theta, x_test, y_test) -> metrics_mod.Metrics:
        return evaluate(theta, x_test, y_test, cfg=self.cfg)

    def evaluate_batch(self, thetas, x_test, y_test) -> metrics_mod.Metrics:
        return metrics_mod.stack_evaluations(self.evaluate, thetas, x_test,
                                             y_test)
