"""The benchmark's CPU tests run the harness on the CPU at a small size
(`tiny_cell`); the one test marked `cuda` runs a cell on the card."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def shrink(cell):
    """`cell` cut to a size the CPU runs in seconds: its model family's
    CPU sizes (`TINY`), buffers of 8 to 64 rows, 64 rows a worker before
    the window and 100 test rows."""
    cell.config.update(cell.family.TINY)
    cell.config["buffer"] = dict(cell.config["buffer"], min_size=8,
                                 max_size=64)
    cell.traffic.update(burst_per_worker=64, test_rows=100)
    return cell


def tiny_cell(name: str):
    """Cell `name` of BENCHMARK.json cut to its CPU size (`shrink`)."""
    from portbench import manifest
    return shrink(manifest.cell(name))


@pytest.fixture
def tiny():
    return tiny_cell
