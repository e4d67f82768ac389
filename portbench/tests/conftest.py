"""The benchmark's CPU tests run the harness on the CPU at a small size
(`tiny_cell`); the one test marked `cuda` runs a cell on the card."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny_cell(name: str):
    """Cell `name` of BENCHMARK.json cut to a size the CPU runs in
    seconds: 32 features, 16 hidden units, buffers of 8 to 64 rows."""
    from portbench import manifest
    cell = manifest.cell(name)
    cell.config.update(num_features=32, hidden_dim=16)
    cell.config["buffer"] = dict(cell.config["buffer"], min_size=8,
                                 max_size=64)
    cell.traffic.update(burst_per_worker=64, test_rows=100)
    return cell


@pytest.fixture
def tiny():
    return tiny_cell
