"""Rows of dense hashed features, as the reference's producer streams
them (`synth.py`'s seeded stand-in for the fine-food embeddings).

A row's record is its feature vector alone; `data_sink` gets it as a
{feature: value} map with the zeros dropped; the program's buffers keep
it as their `x`; the test set is the dense rows and their labels, as
both the program and the reference take it.
"""

from __future__ import annotations

import numpy as np

from portbench.synth import sparse, table


def make(cfg: dict, seed: int, count: int):
    """(records, labels) of `count` rows: the burst first, the test set
    after it."""
    x, y = table(seed, count, cfg["num_features"], cfg["num_classes"])
    return (x,), y


def handed(records: tuple, i: int) -> dict[int, float]:
    return sparse(records[0][i])


def fields(cfg: dict) -> tuple:
    return (((cfg["num_features"],), np.float32),)


def program(state: dict) -> tuple:
    """The records the program's buffer holds (its `state()`)."""
    return (state["x"],)


def test(records: tuple, labels: np.ndarray) -> tuple:
    return records[0], labels
