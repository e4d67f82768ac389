"""The port's SlidingBuffer against kafka_ps_tpu's (exact: same slots,
insertion ids, dirty drains, version and numTuplesSeen for one arrival
trace), and the port's SlabStore: incremental uploads bitwise equal to
full ones, and the reference's upload-byte accounting."""

import numpy as np
import pytest
import torch

from kafka_ps_tpu.compress.slab import SlabStore as JSlabStore
from kafka_ps_tpu.data.buffer import SlidingBuffer as JSlidingBuffer
from kafka_ps_tpu.utils.config import BufferConfig as JBufferConfig
from kafka_ps_tpu_torch.compress.slab import MIN_BUCKET, SlabStore
from kafka_ps_tpu_torch.data.buffer import SlidingBuffer
from kafka_ps_tpu_torch.utils.config import BufferConfig

F = 8
POLICY = dict(min_size=4, max_size=16, coefficient=0.3, arrival_window=5)


def _clock(steps):
    """A fake clock_ms stepping through `steps` (ms between arrivals)."""
    state = {"t": 0.0, "i": 0}

    def clock_ms():
        state["t"] += steps[state["i"] % len(steps)]
        state["i"] += 1
        return state["t"]
    return clock_ms


# fast arrivals grow the target to the cap, slow ones shrink it to the
# floor (the delete-n-oldest branch), then fast again
STEPS = [100.0] * 30 + [5000.0] * 12 + [50.0] * 25 + [0.0] * 5


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        dense = rng.normal(size=F) * (rng.random(F) < 0.6)
        feats = {j: float(v) for j, v in enumerate(dense) if v != 0.0}
        yield (feats if i % 3 else dense.astype(np.float32)), \
            int(rng.integers(1, 6))


def _state(b):
    return (b.x.copy(), b.y.copy(), b.insertion_id.copy(), b.version,
            b.num_tuples_seen, b.count, b.target_size(), b.dirty_slots)


def test_buffer_policy_matches_reference_exactly():
    ours = SlidingBuffer(F, BufferConfig(**POLICY), clock_ms=_clock(STEPS))
    ref = JSlidingBuffer(F, JBufferConfig(**POLICY), clock_ms=_clock(STEPS))
    targets = set()
    for i, (feats, label) in enumerate(_rows(len(STEPS))):
        ours.add(feats, label)
        ref.add(feats, label)
        a, b = _state(ours), _state(ref)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
        targets.add(a[6])
        if i % 7 == 6:
            for u, v in zip(ours.drain_dirty(), ref.drain_dirty()):
                np.testing.assert_array_equal(u, v)
        if i % 11 == 10:
            for u, v in zip(ours.snapshot(clear_dirty=True),
                            ref.snapshot(clear_dirty=True)):
                np.testing.assert_array_equal(u, v)
    # the trace went through growth, shrink and the cap
    assert {POLICY["min_size"], POLICY["max_size"]} <= targets


def _full(store, buf):
    store.upload_full(*buf.snapshot(clear_dirty=True))


def test_incremental_slab_equals_full_upload_bitwise():
    cap = POLICY["max_size"]
    buf = SlidingBuffer(F, BufferConfig(**POLICY), clock_ms=_clock(STEPS))
    inc = SlabStore(cap, F, "cpu")
    full = SlabStore(cap, F, "cpu")
    rows = _rows(len(STEPS), seed=1)
    for feats, label in (next(rows) for _ in range(3)):
        buf.add(feats, label)
    _full(inc, buf)
    for feats, label in rows:
        buf.add(feats, label)
        slots, xr, yr, mr = buf.drain_dirty()
        inc.apply_rows(slots, xr, yr, mr)
        x, y, m = buf.snapshot()
        full.upload_full(x, y, m)
        for a, b in zip(inc.arrays(), full.arrays()):
            assert torch.equal(a, b)
        # the spare sentinel row only ever receives zero padding
        assert torch.equal(inc._x[cap], torch.zeros(F))
        assert int(inc._y[cap]) == 0 and float(inc._mask[cap]) == 0.0
    assert inc.incremental_applies > 0
    x, y, m = inc.arrays()
    assert x.is_contiguous() and y.dtype == torch.int32
    assert m.dtype == torch.float32 and x.shape == (cap, F)


@pytest.mark.parametrize("nrows", [1, 3, MIN_BUCKET + 1, 9])
def test_upload_bytes_match_reference(nrows):
    cap = 16
    rng = np.random.default_rng(nrows)
    x = rng.normal(size=(cap, F)).astype(np.float32)
    y = rng.integers(0, 6, size=cap).astype(np.int32)
    m = np.ones(cap, np.float32)
    slots = np.sort(rng.choice(cap, size=nrows, replace=False))
    ours, ref = SlabStore(cap, F, "cpu"), JSlabStore("f32", cap, F)
    for s in (ours, ref):
        s.upload_full(x, y, m)
        s.apply_rows(slots, x[slots] + 1, y[slots], m[slots] * 0)
    assert ours.bytes_uploaded == ref.bytes_uploaded
    assert (ours.full_uploads, ours.incremental_applies,
            ours.rows_applied) == (1, 1, nrows)
    for a, b in zip(ours.arrays(), ref.arrays()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_slab_refuses_apply_before_upload():
    with pytest.raises(RuntimeError):
        SlabStore(4, F, "cpu").apply_rows(np.array([0]),
                                          np.zeros((1, F), np.float32),
                                          np.zeros(1, np.int32),
                                          np.ones(1, np.float32))
