"""Conversion of the JAX package's parameters into the port's tensors.

kafka_ps_tpu keeps a model's parameters as one flat float32 vector; so
does this package, in the same layout for both families — logreg's
(C+1)*F coefficients row-major then (C+1) intercepts, the MLP's
W1 | b1 | W2 | b2 — so the conversion is a checked copy.
"""

from __future__ import annotations

import numpy as np
import torch

from kafka_ps_tpu_torch.models.task import get_task
from kafka_ps_tpu_torch.utils.config import ModelConfig


def from_jax_params(theta: np.ndarray, cfg: ModelConfig, device,
                    task: str = "logreg") -> torch.Tensor:
    """A flat parameter vector of kafka_ps_tpu (as a numpy array) for
    `task` → the port's flat float32 tensor on `device`."""
    theta = np.asarray(theta)
    if theta.dtype != np.float32:
        raise TypeError(f"parameters must be float32, got {theta.dtype}")
    n = get_task(task, cfg).num_params
    if theta.shape != (n,):
        raise ValueError(f"{task} parameters must be [{n}] for "
                         f"F={cfg.num_features}, C={cfg.num_classes}"
                         + (f", H={cfg.hidden_dim}" if task == "mlp" else "")
                         + f"; got {theta.shape}")
    return torch.tensor(theta, dtype=torch.float32, device=device)
