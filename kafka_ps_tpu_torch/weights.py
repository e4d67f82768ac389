"""Conversion of the JAX package's parameters into the port's tensors.

kafka_ps_tpu keeps a model's parameters as one flat float32 vector; so
does this package.  For logreg the layouts are identical — (C+1)*F
coefficients row-major, then (C+1) intercepts — so the conversion is a
checked copy.  Families whose layouts differ (the MLP, when it is
ported) convert here.
"""

from __future__ import annotations

import numpy as np
import torch

from kafka_ps_tpu_torch.utils.config import ModelConfig


def from_jax_params(theta: np.ndarray, cfg: ModelConfig,
                    device) -> torch.Tensor:
    """A flat parameter vector of kafka_ps_tpu (as a numpy array) → the
    port's flat float32 tensor on `device`."""
    theta = np.asarray(theta)
    if theta.dtype != np.float32:
        raise TypeError(f"parameters must be float32, got {theta.dtype}")
    if theta.shape != (cfg.num_params,):
        raise ValueError(f"parameters must be [{cfg.num_params}] for "
                         f"F={cfg.num_features}, C={cfg.num_classes}; got "
                         f"{theta.shape}")
    return torch.tensor(theta, dtype=torch.float32, device=device)
