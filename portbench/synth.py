"""The synthetic stand-in for the reference's data, made from a seed.

The reference trains on Amazon fine-food reviews embedded to 1024 hashed
features with 5 classes (README.md:210-216 of the upstream project); the
embeddings are not redistributable.  `generate` is a copy of the
program's generator (kafka_ps_tpu_torch/data/synth.py), kept here so
that the data a cell runs on cannot change with the program; the cells
use its hard regime (class centers scaled by 0.2, noise 2, 70 % of the
entries zero), in which an offline fit stays well below F1 1.0.

A cell's burst and test set come from one `generate` call.
"""

from __future__ import annotations

import numpy as np

HARD_CENTER_SCALE = 0.2
NOISE = 2.0
SPARSITY = 0.7


def generate(rows: int, num_features: int = 1024, num_classes: int = 5,
             noise: float = 2.0, sparsity: float = 0.7,
             seed: int = 0, center_scale: float = 1.0,
             label_noise: float = 0.0) -> tuple[np.ndarray, np.ndarray]:
    """(x, y) with y in 1..num_classes; a copy of the program's
    `data.synth.generate`."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=1.0,
                         size=(num_classes, num_features)) * center_scale
    y = rng.integers(1, num_classes + 1, size=rows).astype(np.int32)
    x = centers[y - 1] + rng.normal(scale=noise, size=(rows, num_features))
    drop = rng.random(size=x.shape) < sparsity
    x = np.where(drop, 0.0, x).astype(np.float32)
    if label_noise > 0.0:
        flip = rng.random(rows) < label_noise
        shift = rng.integers(1, num_classes, size=rows)
        y = np.where(flip, (y - 1 + shift) % num_classes + 1,
                     y).astype(np.int32)
    return x, y


def table(seed: int, rows: int, num_features: int,
          num_classes: int) -> tuple[np.ndarray, np.ndarray]:
    """`rows` rows of the hard regime: the burst first, the test set
    after it."""
    return generate(rows, num_features, num_classes, noise=NOISE,
                    sparsity=SPARSITY, seed=seed,
                    center_scale=HARD_CENTER_SCALE)


def sparse(row: np.ndarray) -> dict[int, float]:
    """The row as the reference's producer hands it on: a {feature:
    value} map with the zeros dropped (CsvProducer.java:52-57)."""
    nz = np.flatnonzero(row)
    return dict(zip(nz.tolist(), row[nz].tolist()))
