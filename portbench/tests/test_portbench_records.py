"""The reference buffer keeps a row's record whole, whatever arrays it
holds; the check counts every element of it that differs; and the part
of the weights a family follows reads the whole vector's gaps where the
part is all of it."""

import copy
import os

import numpy as np
import pytest

from portbench import cell as cell_mod
from portbench import check, manifest
from portbench.reference.buffer import Buffer

F, K = 6, 3
POLICY = dict(min_size=4, max_size=16, coefficient=0.3, arrival_window=8)


def _handed(seed, n=200):
    """A seeded sequence of rows: dense values, labels, integer ids, and
    arrival stamps: a burst, then gaps that swing, then slow arrivals, so
    that the target size moves and rows are evicted, several at once
    where it shrinks."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, F)).astype(np.float32)
    y = rng.integers(1, 6, size=n).astype(np.int32)
    ids = rng.integers(0, 2**40, size=(n, K)).astype(np.int64)
    third = n // 3
    gaps = np.concatenate([
        np.full(third, 1.0),
        np.where(rng.random(third) < 0.5, rng.exponential(5.0, third),
                 rng.exponential(3000.0, third)),
        rng.exponential(6000.0, n - 2 * third)])
    return x, y, ids, np.cumsum(gaps)


def _fill(fields, rows, y, stamps):
    buf = Buffer(fields, **POLICY)
    for record, label, stamp in zip(rows, y, stamps):
        buf.add(record, int(label), float(stamp))
    return buf


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 5])
def test_two_array_records_keep_what_dense_records_keep(seed):
    x, y, ids, stamps = _handed(seed)
    dense = _fill((((F,), np.float32),), [(r,) for r in x], y, stamps)
    both = _fill((((F,), np.float32), ((K,), np.int64)),
                 list(zip(x, ids)), y, stamps)
    assert np.array_equal(both.records[0], dense.records[0])
    assert np.array_equal(both.y, dense.y)
    assert np.array_equal(both.ids, dense.ids)
    held = np.flatnonzero(both.ids)
    assert 4 <= len(held) < 16          # the target moved below the max
    # each kept row's ids are the ids handed with its values
    row_of = {r.tobytes(): i for i, r in enumerate(x)}
    for slot in held:
        assert np.array_equal(both.records[1][slot],
                              ids[row_of[both.records[0][slot].tobytes()]])
    *arrays, mask = both.slab()
    assert len(arrays) == 3 and np.array_equal(mask, both.ids > 0)


def test_buffer_mismatch_counts_a_single_altered_id():
    x, y, ids, stamps = _handed(7)
    fields = (((F,), np.float32), ((K,), np.int64))
    replayed = [_fill(fields, list(zip(x, ids))[w::2], y[w::2],
                      stamps[w::2]) for w in range(2)]
    produced = [(tuple(a.copy() for a in b.records), b.y.copy(),
                 b.ids.copy()) for b in replayed]
    assert check.buffer_mismatch(produced, replayed) == 0
    altered = copy.deepcopy(produced)
    slot = int(np.flatnonzero(replayed[1].ids)[0])
    altered[1][0][1][slot, 2] += 1
    assert check.buffer_mismatch(altered, replayed) == 1


def test_following_a_part_reads_the_gaps_of_the_whole(tiny):
    """The MLP followed through a permutation of all of its positions
    (tests/families/mlp_permuted.py) against the MLP followed whole."""
    name = "mlp4096.fused.backlog"
    whole = tiny(name)
    part = tiny(name)
    part.config["reference"] = os.path.relpath(
        os.path.join(os.path.dirname(__file__), "families",
                     "mlp_permuted.py"), manifest.ROOT)
    part.family = manifest.family(part.config)
    readings = []
    for cell in (whole, part):
        cr = cell_mod.CellRun(cell, 31, 0.3, False, "cpu", 0.0)
        cr.build()
        cr.first_rounds()
        cr.window()
        produced = cr.produced()
        cr.close()
        readings.append(check.readings(produced, cr.reference()))
    assert cr.follow.index is not None
    assert readings[1] == readings[0]
    assert readings[0]["step_update_gap"] > 0
