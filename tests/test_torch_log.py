"""The port's commit log (kafka_ps_tpu_torch/log/): the cases of
tests/test_log.py run on the port (record framing, segment roll, sparse-
index seek, retention, crash-truncated tails, the consumer-group offset
store, fsync counters, point reads), a log written by either package
read record for record by the other, and concurrent appends to one
partition: every record under its own offset, and on the durable fabric
every partition's queue in offset order.

Every comparison is exact: the log moves bytes.
"""

from __future__ import annotations

import os
import sys
import threading

import numpy as np
import pytest
import torch

from kafka_ps_tpu.log import CommitLog as JCommitLog
from kafka_ps_tpu.log import LogConfig as JLogConfig
from kafka_ps_tpu.log import LogManager as JLogManager
from kafka_ps_tpu.runtime import messages as jmsg
from kafka_ps_tpu.runtime import serde as jserde
from kafka_ps_tpu_torch.log import (CommitLog, DurableFabric, LogConfig,
                                    LogManager, records)
from kafka_ps_tpu_torch.log.segment import LogSegment, segment_basename
from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime import serde
from kafka_ps_tpu_torch.runtime.messages import (GradientMessage, KeyRange,
                                                 LabeledData, WeightsMessage)


# -- record framing ----------------------------------------------------------

def test_record_roundtrip():
    rec = records.pack_record(42, b"payload")
    assert records.unpack_record(rec, 0) == (42, b"payload", len(rec))


def test_record_rejects_flipped_bit_anywhere():
    rec = bytearray(records.pack_record(7, b"some payload bytes"))
    for i in range(len(rec)):
        corrupt = bytearray(rec)
        corrupt[i] ^= 0x40
        assert records.unpack_record(bytes(corrupt), 0) is None, \
            f"flipped byte {i} went undetected"


def test_record_rejects_truncation():
    rec = records.pack_record(7, b"hello")
    for cut in range(len(rec)):
        assert records.unpack_record(rec[:cut], 0) is None


def test_scan_stops_at_first_invalid():
    buf = (records.pack_record(0, b"a") + records.pack_record(1, b"bb")
           + b"\x01torn tail")
    got = list(records.scan(buf))
    assert [(o, p) for o, p, _ in got] == [(0, b"a"), (1, b"bb")]
    assert records.valid_length(buf) == got[1][2] + records.HEADER_SIZE + 2


def test_all_message_types_roundtrip_through_log(tmp_path):
    """Every message type survives serde framing inside a log record —
    the exact bytes the durable fabric appends."""
    kr = KeyRange(0, 8)
    msgs = [
        WeightsMessage(vector_clock=3, key_range=kr,
                       values=torch.arange(8, dtype=torch.float32)),
        GradientMessage(vector_clock=4, key_range=kr,
                        values=-torch.ones(8), worker_id=2),
        LabeledData(features={1: 0.5, 6: -2.0}, label=3),
    ]
    log = CommitLog(str(tmp_path / "p"), LogConfig(fsync="none"))
    for m in msgs:
        log.append(serde.to_bytes(m))
    out = [serde.from_bytes(p, "cpu") for _, p in log.read_from(0)]
    assert isinstance(out[0], WeightsMessage)
    assert torch.equal(out[0].values, msgs[0].values)
    assert out[0].vector_clock == 3 and out[0].key_range == kr
    assert isinstance(out[1], GradientMessage) and out[1].worker_id == 2
    assert torch.equal(out[1].values, msgs[1].values)
    assert out[2] == msgs[2]
    assert log.appends == 3
    assert log.bytes_appended == sum(len(serde.to_bytes(m)) for m in msgs)
    log.close()


# -- segments ----------------------------------------------------------------

def test_segment_roll_at_configured_size(tmp_path):
    cfg = LogConfig(segment_bytes=256, fsync="none")
    log = CommitLog(str(tmp_path / "p"), cfg)
    payload = b"x" * 100           # ~116B/record -> 3 records per segment
    for i in range(10):
        assert log.append(payload) == i
    assert len(log.segments) > 1
    assert log.rolls == len(log.segments) - 1
    for seg in log.segments:
        # every non-active segment rolled at/past the threshold
        if seg is not log.active:
            assert seg.size >= cfg.segment_bytes
    # base-offset naming is contiguous: each segment starts where the
    # previous ended
    bases = [s.base_offset for s in log.segments]
    assert bases[0] == 0 and bases == sorted(bases)
    for prev, nxt in zip(log.segments, log.segments[1:]):
        assert nxt.base_offset == prev.next_offset
        assert os.path.exists(
            os.path.join(str(tmp_path / "p"),
                         segment_basename(nxt.base_offset) + ".log"))
    assert log.next_offset == 10
    log.close()


def test_reopen_continues_offsets_across_segments(tmp_path):
    cfg = LogConfig(segment_bytes=256, fsync="none")
    log = CommitLog(str(tmp_path / "p"), cfg)
    for _ in range(10):
        log.append(b"x" * 100)
    log.close()
    log2 = CommitLog(str(tmp_path / "p"), cfg)
    assert log2.next_offset == 10
    assert log2.append(b"y") == 10
    assert [o for o, _ in log2.read_from(0)] == list(range(11))
    log2.close()


def test_sparse_index_seek_correctness(tmp_path):
    """read_from(k) returns exactly offsets k.. with intact payloads for
    every k, under a tiny index interval (many entries) and across a
    reopen (index rebuilt from the .log)."""
    directory = str(tmp_path / "seg")
    seg = LogSegment(directory, base_offset=5, index_interval_bytes=64)
    payloads = [f"record-{i}".encode() * (i % 4 + 1) for i in range(40)]
    for p in payloads:
        seg.append(p)
    for k in range(5, 45):
        got = list(seg.read_from(k))
        assert got == [(o, payloads[o - 5]) for o in range(k, 45)]
        # the sparse seek lands at or before the target, never after
        pos = seg.seek_position(k)
        first = next(records.scan(
            open(seg.log_path, "rb").read()[pos:]), None)
        assert first is not None and first[0] <= k
    seg.close()
    # stale/derived index: delete it, reopen, seeks still work
    os.remove(seg.index_path)
    seg2 = LogSegment(directory, base_offset=5, index_interval_bytes=64)
    assert list(seg2.read_from(30)) == [(o, payloads[o - 5])
                                        for o in range(30, 45)]
    assert len(seg2._index) > 1      # rebuilt sparse, not single-entry
    seg2.close()


# -- crash recovery ----------------------------------------------------------

def test_corrupted_tail_truncated_on_open(tmp_path):
    cfg = LogConfig(fsync="none")
    log = CommitLog(str(tmp_path / "p"), cfg)
    for i in range(5):
        log.append(f"rec{i}".encode())
    log.close()
    path = log.active.log_path
    # simulate a torn write: append half a record
    with open(path, "ab") as fh:
        fh.write(records.pack_record(5, b"never acked")[:9])
    log2 = CommitLog(str(tmp_path / "p"), cfg)
    assert log2.truncated_bytes == 9
    assert [p for _, p in log2.read_from(0)] == \
        [f"rec{i}".encode() for i in range(5)]
    # appends continue at the discarded record's offset
    assert log2.append(b"rec5") == 5
    log2.close()


def test_corrupt_byte_mid_file_discards_from_there(tmp_path):
    cfg = LogConfig(fsync="none")
    log = CommitLog(str(tmp_path / "p"), cfg)
    for i in range(5):
        log.append(f"rec{i}".encode())
    log.close()
    with open(log.active.log_path, "r+b") as fh:
        data = bytearray(fh.read())
        data[len(data) // 2] ^= 0xFF        # flip a bit mid-file
        fh.seek(0)
        fh.write(data)
    log2 = CommitLog(str(tmp_path / "p"), cfg)
    kept = [o for o, _ in log2.read_from(0)]
    assert log2.truncated_bytes > 0
    assert kept == list(range(len(kept)))   # a clean prefix survives
    assert log2.next_offset == len(kept)
    log2.close()


# -- retention ---------------------------------------------------------------

def test_retention_deletes_only_fully_consumed_rolled_segments(tmp_path):
    cfg = LogConfig(segment_bytes=256, fsync="none")
    log = CommitLog(str(tmp_path / "p"), cfg)
    for _ in range(10):
        log.append(b"x" * 100)
    assert len(log.segments) >= 3
    second_base = log.segments[1].base_offset
    # consumed up to (not including) the second segment's base: nothing
    # is deletable yet — segment 0 still holds unconsumed records
    assert log.apply_retention(second_base - 1) == 0
    # consumed through the first record of segment 1: segment 0 goes
    assert log.apply_retention(second_base) == 1
    assert log.start_offset == second_base
    assert not os.path.exists(
        os.path.join(str(tmp_path / "p"), segment_basename(0) + ".log"))
    # fully consumed: every rolled segment goes, the active one never
    deleted = log.apply_retention(log.next_offset)
    assert len(log.segments) == 1 and deleted >= 1
    assert log.segments_deleted == 1 + deleted
    assert log.segments[0] is log.active
    assert [o for o, _ in log.read_from(0)] == \
        list(range(log.active.base_offset, 10))
    log.close()


def test_manager_retention_uses_min_across_groups(tmp_path):
    cfg = LogConfig(segment_bytes=256, fsync="none")
    mgr = LogManager(str(tmp_path), cfg)
    log = mgr.get("weights", 0)
    for _ in range(10):
        log.append(b"x" * 100)
    n_before = len(log.segments)
    assert n_before >= 3
    # an uncommitted partition is never reaped
    assert mgr.apply_retention() == 0
    # two groups: the SLOWER one bounds deletion
    mgr.commit("fast", {"weights/0": 10})
    # commit() itself ran retention with min=slowest=fast=10 … but only
    # one group tracks so far; a second, slower group must pull the
    # floor back down for future commits
    mgr2 = LogManager(str(tmp_path), cfg)       # reload offsets from disk
    assert mgr2.committed("fast", "weights", 0) == 10
    log2 = mgr2.get("weights", 0)
    for _ in range(6):
        log2.append(b"y" * 100)
    mgr2.commit("slow", {"weights/0": 11})
    # min(fast=10, slow=11)=10: segments above offset 10 survive
    assert log2.start_offset <= 10 or len(log2.segments) == 1
    assert [o for o, _ in log2.read_from(11)] == list(range(11, 16))
    mgr2.close()


# -- offsets store -----------------------------------------------------------

def test_offset_store_roundtrip_and_merge(tmp_path):
    mgr = LogManager(str(tmp_path), LogConfig(fsync="none"))
    mgr.get("gradients", 0).append(b"g")
    assert mgr.committed("server", "gradients", 0) == 0
    mgr.commit("server", {"gradients/0": 1})
    mgr.commit("server", {"weights/3": 7})      # merge, not replace
    mgr.close()
    mgr2 = LogManager(str(tmp_path), LogConfig(fsync="none"))
    assert mgr2.committed("server", "gradients", 0) == 1
    assert mgr2.committed("server", "weights", 3) == 7
    assert mgr2.committed("other-group", "gradients", 0) == 0
    # discovery found the partition written by the first manager
    assert ("gradients", 0) in mgr2.partitions()
    mgr2.close()


# -- fsync policy ------------------------------------------------------------

def test_fsync_policy_counters(tmp_path):
    log = CommitLog(str(tmp_path / "a"), LogConfig(fsync="always"))
    for _ in range(5):
        log.append(b"p")
    assert log.fsyncs == 5
    assert log.fsync_ms_max <= log.fsync_ms
    log.close()

    log = CommitLog(str(tmp_path / "n"), LogConfig(fsync="none"))
    for _ in range(5):
        log.append(b"p")
    assert log.fsyncs == 0
    log.flush()                                  # forced commit-point sync
    assert log.fsyncs == 1
    log.close()


def test_bad_fsync_policy_rejected():
    with pytest.raises(ValueError, match="fsync"):
        LogConfig(fsync="sometimes")


# -- positioned point reads (read_at: the cold tier's primitive) -------------

def test_read_at_every_offset_mid_segment(tmp_path):
    """Point reads hit every record exactly under a tiny index interval
    (many sparse entries, so floor-seek + header-hop both exercise)."""
    seg = LogSegment(str(tmp_path / "seg"), base_offset=5,
                     index_interval_bytes=64)
    payloads = [f"rec-{i}".encode() * (i % 5 + 1) for i in range(40)]
    for p in payloads:
        seg.append(p)
    for k in range(5, 45):
        assert seg.read_at(k) == payloads[k - 5]
    for bad in (4, 45, 1000, -1):
        with pytest.raises(KeyError):
            seg.read_at(bad)
    seg.close()


def test_read_at_crosses_segments_and_reopen(tmp_path):
    cfg = LogConfig(segment_bytes=256, fsync="none")
    log = CommitLog(str(tmp_path / "p"), cfg)
    payloads = [f"payload-{i:02d}".encode() * 4 for i in range(12)]
    for p in payloads:
        log.append(p)
    assert len(log.segments) > 1     # the bisect-by-base path is real
    for i, p in enumerate(payloads):
        assert log.read_at(i) == p
    log.close()
    log2 = CommitLog(str(tmp_path / "p"), cfg)
    for i in (0, 5, 11):
        assert log2.read_at(i) == payloads[i]
    with pytest.raises(KeyError):
        log2.read_at(12)
    log2.close()


def test_read_at_below_retention_raises(tmp_path):
    cfg = LogConfig(segment_bytes=256, fsync="none")
    log = CommitLog(str(tmp_path / "p"), cfg)
    for _ in range(10):
        log.append(b"x" * 100)
    second_base = log.segments[1].base_offset
    log.apply_retention(second_base)
    with pytest.raises(KeyError):
        log.read_at(0)
    assert log.read_at(second_base) == b"x" * 100
    log.close()


def test_read_at_torn_tail_and_corrupt_record(tmp_path):
    directory = str(tmp_path / "seg")
    seg = LogSegment(directory, base_offset=0)
    for i in range(3):
        seg.append(f"rec{i}".encode() * 10)
    seg.flush()
    # torn tail: half a record from a crashed writer — recovery
    # truncates it on reopen, and read_at never serves it
    with open(seg.log_path, "ab") as fh:
        fh.write(records.pack_record(3, b"never acked")[:11])
    seg.close()
    seg2 = LogSegment(directory, base_offset=0)
    assert seg2.truncated_bytes == 11
    with pytest.raises(KeyError):
        seg2.read_at(3)
    assert seg2.read_at(2) == b"rec2" * 10
    # corruption landing AFTER open: the point read CRC-verifies the
    # target record and refuses — garbage bytes are never returned
    with open(seg2.log_path, "r+b") as fh:
        data = bytearray(fh.read())
        data[-3] ^= 0xFF
        fh.seek(0)
        fh.write(data)
    with pytest.raises(KeyError):
        seg2.read_at(2)
    assert seg2.read_at(1) == b"rec1" * 10   # earlier records unaffected
    seg2.close()


# -- the two packages read each other's logs ---------------------------------

def _frames(seed=0):
    """(port message, JAX message) pairs of every type the fabric logs."""
    rng = np.random.default_rng(seed)
    out = []
    for c in range(6):
        v = rng.standard_normal(40).astype(np.float32)
        out.append((WeightsMessage(vector_clock=c, key_range=KeyRange(0, 40),
                                   values=torch.from_numpy(v.copy())),
                    jmsg.WeightsMessage(vector_clock=c,
                                        key_range=jmsg.KeyRange(0, 40),
                                        values=v)))
        out.append((GradientMessage(vector_clock=c,
                                    key_range=KeyRange(0, 40),
                                    values=torch.from_numpy(-v),
                                    worker_id=c % 3),
                    jmsg.GradientMessage(vector_clock=c,
                                         key_range=jmsg.KeyRange(0, 40),
                                         values=-v, worker_id=c % 3)))
        feats = {int(k): float(np.float32(x)) for k, x in
                 zip(rng.choice(40, 5, replace=False), rng.normal(size=5))}
        out.append((LabeledData(features=feats, label=c % 2),
                    jmsg.LabeledData(features=dict(feats), label=c % 2)))
    return out


def _segment_files(directory):
    return {f: open(os.path.join(directory, f), "rb").read()
            for f in sorted(os.listdir(directory))}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_log_written_by_either_package_is_read_by_the_other(tmp_path,
                                                               writer):
    """Both packages append the same frames (small segments, so several
    roll): the segment and index files are byte for byte the same, each
    package reads the other's log record for record, and the decoded
    messages are the originals."""
    frames = _frames()
    cfg = dict(segment_bytes=512, index_interval_bytes=128, fsync="none")
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jlog = JCommitLog(jdir, JLogConfig(**cfg))
    plog = CommitLog(pdir, LogConfig(**cfg))
    for port_msg, jax_msg in frames:
        assert plog.append(serde.to_bytes(port_msg)) == \
            jlog.append(jserde.to_bytes(jax_msg))
    jlog.close()
    plog.close()
    assert len(plog.segments) > 2
    assert _segment_files(jdir) == _segment_files(pdir)
    src = jdir if writer == "jax" else pdir
    reader = (CommitLog(src, LogConfig(**cfg)) if writer == "jax"
              else JCommitLog(src, JLogConfig(**cfg)))
    got = list(reader.read_from(0))
    assert [o for o, _ in got] == list(range(len(frames)))
    for (offset, payload), (port_msg, jax_msg) in zip(got, frames):
        assert reader.read_at(offset) == payload
        if writer == "jax":
            msg = serde.from_bytes(payload, "cpu")
            want = port_msg
        else:
            msg = jserde.from_bytes(payload)
            want = jax_msg
        if isinstance(want, (LabeledData, jmsg.LabeledData)):
            assert msg == want
        else:
            assert msg.vector_clock == want.vector_clock
            assert getattr(msg, "worker_id", 0) == \
                getattr(want, "worker_id", 0)
            np.testing.assert_array_equal(np.asarray(msg.values),
                                          np.asarray(want.values))
    reader.close()


def test_offsets_and_partitions_cross_between_the_managers(tmp_path):
    """A JAX durable root's partitions and committed offsets open in the
    port's LogManager, and the port's in the JAX one."""
    jm = JLogManager(str(tmp_path / "j"), JLogConfig(fsync="none"))
    for key in range(3):
        jm.get("weights", key).append(b"w" * (key + 1))
    jm.get("gradients", 0).append(b"g")
    jm.commit("workers", {"weights/0": 1, "weights/2": 1})
    jm.close()
    pm = LogManager(str(tmp_path / "j"), LogConfig(fsync="none"))
    assert pm.partitions() == [("gradients", 0), ("weights", 0),
                               ("weights", 1), ("weights", 2)]
    assert pm.committed("workers", "weights", 2) == 1
    assert pm.committed("workers", "weights", 1) == 0
    pm.get("input-data", 5).append(b"row")
    pm.commit("ingest", {"input-data/5": 1})
    pm.close()
    jm2 = JLogManager(str(tmp_path / "j"), JLogConfig(fsync="none"))
    assert ("input-data", 5) in jm2.partitions()
    assert jm2.committed("ingest", "input-data", 5) == 1
    assert [p for _, p in jm2.get("input-data", 5).read_from(0)] == [b"row"]
    jm2.close()


# -- one partition, many writers ---------------------------------------------

THREADS, APPENDS, RECORD = 4, 200, 24637     # a logreg gradient frame


def _stress(fn):
    """Run fn(thread index) on THREADS threads at a short switch interval;
    every thread must finish."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=fn, args=(i,))
                   for i in range(THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)


def test_concurrent_appends_get_distinct_contiguous_offsets(tmp_path):
    """4 threads x 200 appends of a gradient frame's size into one
    partition: 800 records on disk under 800 distinct offsets 0..799,
    each payload intact (the JAX CommitLog has no lock and can write two
    records under one offset here)."""
    log = CommitLog(str(tmp_path / "p"), LogConfig(fsync="none"))
    got: list[list[int]] = [[] for _ in range(THREADS)]

    def writer(i):
        for j in range(APPENDS):
            tag = (i * APPENDS + j).to_bytes(4, "little")
            got[i].append(log.append(tag * (RECORD // 4)))

    _stress(writer)
    n = THREADS * APPENDS
    assert sorted(o for offs in got for o in offs) == list(range(n))
    assert log.next_offset == n and log.appends == n
    log.close()
    reopened = CommitLog(str(tmp_path / "p"), LogConfig(fsync="none"))
    records_on_disk = list(reopened.read_from(0))
    assert [o for o, _ in records_on_disk] == list(range(n))
    tags = set()
    for offset, payload in records_on_disk:
        assert payload == payload[:4] * (RECORD // 4)
        tags.add(payload[:4])
    assert len(tags) == n
    reopened.close()


def test_durable_fabric_queue_order_is_offset_order(tmp_path):
    """4 threads sending to one partition of the durable fabric: the
    queue delivers the messages in their log order, the delivered offsets
    are 0..n-1, and the log holds exactly the queued messages."""
    fabric = DurableFabric(str(tmp_path / "wal"), LogConfig(fsync="none"),
                           device="cpu")
    kr = KeyRange(0, 64)

    def sender(i):
        for c in range(50):
            fabric.send(fabric_mod.GRADIENTS_TOPIC, 0, GradientMessage(
                vector_clock=c, key_range=kr,
                values=torch.full((64,), float(i)), worker_id=i))

    _stress(sender)
    n = THREADS * 50
    polled = [fabric.poll(fabric_mod.GRADIENTS_TOPIC, 0) for _ in range(n)]
    assert fabric.poll(fabric_mod.GRADIENTS_TOPIC, 0) is None
    assert fabric.snapshot_offsets() == {"gradients/0": n}
    logged = [serde.from_bytes(p, "cpu") for _, p in fabric.manager.get(
        fabric_mod.GRADIENTS_TOPIC, 0).read_from(0)]
    assert [(m.worker_id, m.vector_clock) for m in polled] == \
        [(m.worker_id, m.vector_clock) for m in logged]
    # each sender's own messages keep their order
    for i in range(THREADS):
        assert [m.vector_clock for m in polled if m.worker_id == i] == \
            list(range(50))
    fabric.close()


def test_partitions_open_once_under_concurrent_first_sends(tmp_path):
    """Worker threads' first sends to a new partition open ONE log."""
    mgr = LogManager(str(tmp_path), LogConfig(fsync="none"))
    logs = []
    _stress(lambda i: logs.append(mgr.get("gradients", 0)))
    assert all(log is logs[0] for log in logs)
    mgr.close()
