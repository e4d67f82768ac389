"""Conversion of the JAX package's parameters and stored slabs into the
port's tensors.

kafka_ps_tpu keeps a model's parameters as one flat float32 vector; so
does this package, in the same layout for both families — logreg's
(C+1)*F coefficients row-major then (C+1) intercepts, the MLP's
W1 | b1 | W2 | b2 — so the conversion is a checked copy.  A stored slab
(f32 or bf16 array, or an int8 QuantizedSlab) converts byte for byte, so
both packages can be fed the same stored values.
"""

from __future__ import annotations

import numpy as np
import torch

from kafka_ps_tpu_torch.compress.slab import QuantizedSlab
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


def from_jax_slab(stored, device="cpu"):
    """A stored slab of kafka_ps_tpu — an f32 or bf16 array, or a
    QuantizedSlab of int8 q and f32 scale (as numpy, or anything
    np.asarray takes) — → the port's form on `device`, the same bytes.
    numpy's bfloat16 (ml_dtypes) is not a dtype torch.from_numpy takes,
    so bf16 goes across as its 16-bit patterns."""
    if hasattr(stored, "q") and hasattr(stored, "scale"):
        q = np.array(stored.q, order="C")     # a writable copy
        scale = np.array(stored.scale, order="C")
        if q.dtype != np.int8 or scale.dtype != np.float32:
            raise TypeError(f"a QuantizedSlab is int8 q and float32 scale, "
                            f"got {q.dtype} and {scale.dtype}")
        return QuantizedSlab(q=torch.from_numpy(q).to(device),
                             scale=torch.from_numpy(scale).to(device))
    a = np.array(stored, order="C")
    if a.dtype == np.float32:
        return torch.from_numpy(a).to(device)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.uint16).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    raise TypeError(f"a stored slab is float32 or bfloat16, got {a.dtype}")
