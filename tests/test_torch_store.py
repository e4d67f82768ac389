"""The port's tiered parameter store (kafka_ps_tpu_torch/store/,
compress/slab.ParamPageSlab) on the CPU: the cases of tests/test_store.py
on the port, and the port against the JAX store on the same seeded
inputs.

  * page geometry, the initial residency under the caps, and the
    residency plans after the same pins and synchronous rebalances,
    equal to the JAX store's;
  * a cold fault lands warm, heat promotes, a write to a cold page lands
    warm, `replace_all` round-trips, from a host array and a tensor;
  * the cold record: a round trip, the header check, and the partition's
    files byte for byte the JAX ColdStore's, each package reading the
    other's records;
  * migrations racing full-slice reads, and writes racing the policy
    thread, exact;
  * residency restore re-reading a recorded-cold range, and the page
    count check;
  * the hot tier (ParamPageSlab) and the device-side assembly.
"""

import os
import threading

import numpy as np
import pytest
import torch

from kafka_ps_tpu.runtime.messages import KeyRange as JRange
from kafka_ps_tpu.store import ColdStore as JColdStore
from kafka_ps_tpu.store import TieredParamStore as JStore
from kafka_ps_tpu_torch.compress.slab import ParamPageSlab
from kafka_ps_tpu_torch.runtime.messages import KeyRange
from kafka_ps_tpu_torch.store import (TIER_COLD, TIER_HOT, TIER_WARM,
                                      ColdStore, TieredParamStore)

PAGE = 4          # params per page in these tests
NPAGES = 8


def _values(n=PAGE * NPAGES, seed=7):
    rng = np.random.default_rng(seed)
    return rng.normal(size=n).astype(np.float32)


def _store(tmp_path, hot_pages=2, warm_pages=2, values=None, cold=True,
           name="param-cold", **kw):
    vals = _values() if values is None else values
    c = ColdStore.open(str(tmp_path / name)) if cold else None
    return TieredParamStore(
        vals, KeyRange(0, len(vals)),
        hot_bytes=hot_pages * PAGE * 4, warm_bytes=warm_pages * PAGE * 4,
        page_params=PAGE, cold=c, device="cpu", **kw), vals


def _jstore(tmp_path, hot_pages=2, warm_pages=2, values=None,
            name="jax-cold"):
    vals = _values() if values is None else values
    c = JColdStore.open(str(tmp_path / name))
    return JStore(vals, JRange(0, len(vals)),
                  hot_bytes=hot_pages * PAGE * 4,
                  warm_bytes=warm_pages * PAGE * 4, page_params=PAGE,
                  cold=c)


# -- geometry and residency ------------------------------------------------

def test_page_geometry_matches_the_jax_store():
    vals = _values(PAGE * 3 + 2)     # the last page is a stub
    s = TieredParamStore(vals, KeyRange(0, len(vals)), page_params=PAGE,
                         device="cpu")
    j = JStore(vals, JRange(0, len(vals)), page_params=PAGE)
    assert s.num_pages == j.num_pages == 4
    assert s.page_range(3) == KeyRange(12, 14)
    for lo, hi in ((3, 9), (4, 5), (99, 120), (0, 14), (13, 14)):
        assert (list(s.pages_overlapping(KeyRange(lo, hi)))
                == list(j.pages_overlapping(JRange(lo, hi))))
    assert list(s.pages_overlapping(KeyRange(3, 9))) == [0, 1, 2]
    assert list(s.pages_overlapping(KeyRange(99, 120))) == []
    s.close()
    j.close()


def test_unbounded_default_is_fully_hot():
    vals = _values()
    s = TieredParamStore(vals, KeyRange(0, len(vals)), page_params=PAGE,
                         device="cpu")
    assert s.tier_counts() == {"hot": NPAGES, "warm": 0, "cold": 0}
    assert s.assembled().tobytes() == vals.tobytes()
    assert s.stats()["device_bytes"] == vals.nbytes
    s.close()


def test_budgets_settle_initial_residency(tmp_path):
    s, vals = _store(tmp_path, hot_pages=2, warm_pages=3)
    assert s.tier_counts() == {"hot": 2, "warm": 3, "cold": 3}
    rb = s.resident_bytes()
    assert rb["resident"] == 5 * PAGE * 4
    assert rb["cold_logged"] == 3 * PAGE * 4
    assert s.assembled().tobytes() == vals.tobytes()
    s.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_residency_plans_equal_the_jax_store(tmp_path, seed):
    """The same seeded pins (and writes) followed by synchronous
    rebalances give the same residency vectors and heat in both
    packages, at every step."""
    rng = np.random.default_rng(seed)
    s, vals = _store(tmp_path, hot_pages=2, warm_pages=3)
    j = _jstore(tmp_path, hot_pages=2, warm_pages=3)
    assert np.array_equal(s.residency_vector(), j.residency_vector())
    for _ in range(6):
        for _ in range(int(rng.integers(1, 12))):
            i = int(rng.integers(0, NPAGES))
            lo = int(rng.integers(0, PAGE * NPAGES - 1))
            hi = int(rng.integers(lo + 1, PAGE * NPAGES + 1))
            if rng.random() < 0.25:
                new = rng.normal(size=PAGE).astype(np.float32)
                s.update_page(i, new)
                j.update_page(i, new)
            else:
                assert (s.pin(KeyRange(lo, hi)).tobytes()
                        == np.asarray(j.pin(JRange(lo, hi))).tobytes())
        s.rebalance()
        j.rebalance()
        assert np.array_equal(s.residency_vector(), j.residency_vector())
        for a, b in zip(s.heat_vectors(), j.heat_vectors()):
            assert np.array_equal(a, b)
        assert s.tier_counts() == j.tier_counts()
        assert (s.assembled().tobytes()
                == np.asarray(j.assembled()).tobytes())
    st, jt = s.stats(), j.stats()
    for key in ("pages", "tiers", "pins", "promotions", "demotions",
                "faults", "rebalances", "resident_bytes"):
        assert st[key] == jt[key], key
    s.close()
    j.close()


def test_warm_cap_requires_cold_store():
    vals = _values()
    with pytest.raises(ValueError, match="cold store") as port:
        TieredParamStore(vals, KeyRange(0, len(vals)),
                         warm_bytes=PAGE * 4, page_params=PAGE,
                         device="cpu")
    with pytest.raises(ValueError) as jax_err:
        JStore(vals, JRange(0, len(vals)), warm_bytes=PAGE * 4,
               page_params=PAGE)
    assert str(port.value) == str(jax_err.value)


def test_pin_faults_cold_page_warm(tmp_path):
    s, vals = _store(tmp_path, hot_pages=1, warm_pages=1)
    cold_pages = [i for i in range(NPAGES)
                  if s.residency_vector()[i] == TIER_COLD]
    i = cold_pages[0]
    kr = s.page_range(i)
    got = s.pin(kr)
    assert got.tobytes() == vals[kr.start:kr.end].tobytes()
    assert s.faults == 1
    assert s.residency_vector()[i] == TIER_WARM   # installed warm
    assert s.pins["cold"] == 1
    s.close()


def test_heat_drives_promotion(tmp_path):
    s, _ = _store(tmp_path, hot_pages=1, warm_pages=2)
    victim = int(np.flatnonzero(s.residency_vector() == TIER_COLD)[-1])
    for _ in range(32):
        s.pin(s.page_range(victim))
    s.rebalance()
    assert s.residency_vector()[victim] == TIER_HOT
    # exactly one page fits the hot budget, so the old hot page moved out
    assert s.tier_counts()["hot"] == 1
    s.close()


def test_update_page_on_cold_page_lands_warm(tmp_path):
    s, _ = _store(tmp_path, hot_pages=1, warm_pages=1)
    i = int(np.flatnonzero(s.residency_vector() == TIER_COLD)[0])
    kr = s.page_range(i)
    appends = s.cold.appends
    new = np.arange(kr.end - kr.start, dtype=np.float32)
    s.update_page(i, new)
    assert s.residency_vector()[i] == TIER_WARM
    assert s.pin(kr, count_heat=False).tobytes() == new.tobytes()
    assert s.cold.appends == appends          # a write never appends
    s.close()


def test_update_page_with_a_tensor_on_a_page_not_hot_lands_on_the_host(
        tmp_path):
    """A device value for a page the policy demoted meanwhile is fetched
    to the host, and the page stays warm."""
    s, _ = _store(tmp_path, hot_pages=1, warm_pages=3)
    i = int(np.flatnonzero(s.residency_vector() == TIER_WARM)[0])
    new = torch.arange(PAGE, dtype=torch.float32)
    s.update_page(i, new)
    (_, _, value), = s.pin_pages(s.page_range(i), count_heat=False)
    assert isinstance(value, np.ndarray)
    assert value.tobytes() == new.numpy().tobytes()
    assert s.residency_vector()[i] == TIER_WARM
    s.close()


@pytest.mark.parametrize("as_tensor", [False, True])
def test_replace_all_roundtrip(tmp_path, as_tensor):
    s, _ = _store(tmp_path, hot_pages=2, warm_pages=2)
    new = np.arange(PAGE * NPAGES, dtype=np.float32)
    s.replace_all(torch.from_numpy(new.copy()) if as_tensor else new)
    assert s.assembled().tobytes() == new.tobytes()
    # cold pages landed warm; a rebalance demotes them again
    assert s.tier_counts()["cold"] == 0
    s.rebalance()
    assert s.tier_counts()["cold"] > 0
    assert s.assembled().tobytes() == new.tobytes()
    assert s.assembled_tensor().numpy().tobytes() == new.tobytes()
    s.close()


# -- the cold store --------------------------------------------------------

def test_cold_store_roundtrip_and_header_check(tmp_path):
    c = ColdStore.open(str(tmp_path / "cold"))
    vals = _values(PAGE)
    off = c.put(3, 12, 16, vals)
    assert c.get(off, 3, 12, 16).tobytes() == vals.tobytes()
    with pytest.raises(KeyError, match="wanted page 4"):
        c.get(off, 4, 16, 20)
    with pytest.raises(ValueError):
        c.put(3, 12, 16, vals[:2])
    c.close()


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_cold_partitions_are_the_jax_bytes_both_ways(tmp_path):
    """The same page records give the same partition files in both
    packages, and each package point-reads the other's records."""
    rng = np.random.default_rng(11)
    pages = [(i, i * PAGE, i * PAGE + PAGE,
              rng.normal(size=PAGE).astype(np.float32)) for i in range(6)]
    mine = ColdStore.open(str(tmp_path / "port"))
    theirs = JColdStore.open(str(tmp_path / "jax"))
    offs = [(mine.put(*p), theirs.put(*p)) for p in pages]
    assert [a for a, _ in offs] == [b for _, b in offs]
    mine.close()
    theirs.close()
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    read_jax = ColdStore.open(str(tmp_path / "jax"))
    read_port = JColdStore.open(str(tmp_path / "port"))
    for (i, lo, hi, v), (off, _) in zip(pages, offs):
        assert read_jax.get(off, i, lo, hi).tobytes() == v.tobytes()
        assert read_port.get(off, i, lo, hi).tobytes() == v.tobytes()
    read_jax.close()
    read_port.close()


def test_stores_of_both_packages_demote_to_the_same_records(tmp_path):
    """A port store and a JAX store settling the same values under the
    same caps append byte-equal cold partitions."""
    s, _ = _store(tmp_path, hot_pages=2, warm_pages=2, name="port-cold")
    j = _jstore(tmp_path, hot_pages=2, warm_pages=2, name="jax-cold")
    assert np.array_equal(s.residency_vector(), j.residency_vector())
    s.close()
    j.close()
    assert (_files(tmp_path / "port-cold")
            == _files(tmp_path / "jax-cold"))


# -- races: concurrent promote/demote vs apply and snapshot reads ----------

def test_snapshot_reads_race_migrations(tmp_path):
    """Heat-driven migrations churn under concurrent full-slice reads:
    residency must never change values."""
    s, vals = _store(tmp_path, hot_pages=2, warm_pages=2,
                     rebalance_interval_s=0.001)
    s.start_policy_thread()
    errors = []

    def reader():
        for _ in range(120):
            if s.assembled().tobytes() != vals.tobytes():
                errors.append("assembled drifted")
                return
            if s.assembled_tensor().numpy().tobytes() != vals.tobytes():
                errors.append("assembled tensor drifted")
                return

    def pinner(phase):
        # shift heat between page groups so the policy keeps moving
        for k in range(120):
            i = (k + phase) % NPAGES
            s.pin(s.page_range(i))

    ts = [threading.Thread(target=f) for f in
          (reader, reader, lambda: pinner(0), lambda: pinner(4))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    s.close()
    assert errors == []
    assert s.promotions + s.demotions > 0   # the race happened


def test_concurrent_apply_vs_policy_thread_is_exact(tmp_path):
    """Writes race promote/demote: the version-checked commit lets every
    write win, so after N +1.0 applies per page the slice is exactly
    initial + N (float32 integer math, no tolerance).  Half the writes
    are tensors, as the server's apply writes them."""
    init = np.zeros(PAGE * NPAGES, dtype=np.float32)
    s, _ = _store(tmp_path, hot_pages=2, warm_pages=2, values=init,
                  rebalance_interval_s=0.001)
    s.start_policy_thread()
    rounds = 60

    def writer():
        for r in range(rounds):
            for i in range(NPAGES):
                (_, _, value), = s.pin_pages(s.page_range(i))
                if r % 2:
                    s.update_page(i, s.to_device(value) + 1.0)
                else:
                    host = np.array(value, dtype=np.float32)
                    s.update_page(i, host + np.float32(1.0))

    def reader():
        for _ in range(100):
            assert s.assembled().shape == init.shape

    ts = [threading.Thread(target=writer), threading.Thread(target=reader)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    # assemble before close (close drops the cold log; the CLIs save their
    # final checkpoint before closing the store for the same reason)
    expect = np.full_like(init, float(rounds))
    assert s.assembled().tobytes() == expect.tobytes()
    s.close()
    assert s.rebalances > 0


def test_hot_bytes_stay_under_the_cap_while_pages_migrate(tmp_path):
    """The slab's bytes never exceed the hot cap during a pass, also when
    the pages that enter the hot tier come before the ones that leave it
    in page order: after every install the slab holds at most the cap."""
    s, _ = _store(tmp_path, hot_pages=2, warm_pages=2)
    cap = 2 * PAGE * 4
    for i in (6, 7):
        for _ in range(8):
            s.pin(s.page_range(i))
    s.rebalance()
    assert list(np.flatnonzero(s.residency_vector() == TIER_HOT)) == [6, 7]
    held = []
    put = s._slab.put

    def watched(page, values):
        out = put(page, values)
        held.append(s._slab.device_bytes())
        return out

    s._slab.put = watched
    for i in (0, 1):
        for _ in range(64):
            s.pin(s.page_range(i))
    s.rebalance()
    assert list(np.flatnonzero(s.residency_vector() == TIER_HOT)) == [0, 1]
    assert held and max(held) <= cap
    s.close()


# -- checkpoint restore with a cold-referenced range -----------------------

def test_residency_restore_rereads_cold_range(tmp_path):
    """Restore re-applies recorded residency by demoting cold pages with
    fresh appends, then a pin of a recorded-cold range reproduces the
    exact bytes."""
    s, vals = _store(tmp_path, hot_pages=2, warm_pages=2)
    for _ in range(8):
        s.pin(s.page_range(0))            # make heat non-uniform
    s.rebalance()
    # residency first, then theta (the order utils/checkpoint.save uses)
    tiers = s.residency_vector()
    reads, writes = s.heat_vectors()
    theta = s.assembled()
    assert (tiers == TIER_COLD).any()
    s.close()

    c2 = ColdStore.open(str(tmp_path / "param-cold"))
    appends = c2.log.next_offset
    s2 = TieredParamStore(np.zeros_like(vals), KeyRange(0, len(vals)),
                          hot_bytes=2 * PAGE * 4, warm_bytes=2 * PAGE * 4,
                          page_params=PAGE, cold=c2, device="cpu")
    s2.replace_all(theta)
    s2.set_residency(tiers, reads, writes)
    assert np.array_equal(s2.residency_vector(), tiers)
    assert c2.log.next_offset > appends    # fresh records
    cold_page = int(np.flatnonzero(tiers == TIER_COLD)[0])
    kr = s2.page_range(cold_page)
    assert s2.pin(kr).tobytes() == vals[kr.start:kr.end].tobytes()
    assert s2.assembled().tobytes() == theta.tobytes()
    s2.close()


def test_set_residency_rejects_page_count_mismatch(tmp_path):
    s, _ = _store(tmp_path)
    with pytest.raises(ValueError, match="page_params changed"):
        s.set_residency(np.zeros(NPAGES + 1, dtype=np.int8))
    s.close()


# -- the hot tier and the device-side assembly ----------------------------

def test_param_page_slab_counts_uploads_and_keeps_tensors():
    slab = ParamPageSlab("cpu")
    host = np.arange(PAGE, dtype=np.float32)
    t = slab.put(0, host)
    assert (slab.uploads, slab.bytes_uploaded) == (1, host.nbytes)
    assert t.numpy().tobytes() == host.tobytes()
    dev = torch.ones(PAGE)
    assert slab.put(1, dev) is dev            # stored as it is, not counted
    assert (slab.uploads, slab.bytes_uploaded) == (1, host.nbytes)
    assert 0 in slab and len(slab) == 2
    assert slab.device_bytes() == 2 * PAGE * 4
    got = slab.pop_host(1)
    assert isinstance(got, np.ndarray) and got.tobytes() == \
        dev.numpy().tobytes()
    assert 1 not in slab and slab.device_bytes() == PAGE * 4
    slab.drop(0)
    slab.drop(0)
    assert len(slab) == 0
    with pytest.raises(ValueError, match="hot tier"):
        slab.put(2, torch.ones(PAGE, device="meta"))


def test_store_puts_hot_pages_on_its_device_only(tmp_path):
    s, vals = _store(tmp_path, hot_pages=2, warm_pages=2)
    assert s.device == torch.device("cpu")
    hot = [v for _, _, v in s.pin_pages(KeyRange(0, len(vals)),
                                        count_heat=False)
           if isinstance(v, torch.Tensor)]
    assert len(hot) == 2 and all(v.device == s.device for v in hot)
    assert s.stats()["device_bytes"] == 2 * PAGE * 4
    s.close()


def test_assembled_tensor_is_bitwise_and_counts_its_uploads(tmp_path):
    s, vals = _store(tmp_path, hot_pages=2, warm_pages=3)
    before = s.host_upload_bytes
    t = s.assembled_tensor()
    assert t.dtype == torch.float32 and t.device == s.device
    assert t.numpy().tobytes() == vals.tobytes()
    # the 6 pages not hot (3 warm, 3 cold faulted warm) were uploaded
    assert s.host_upload_bytes - before == 6 * PAGE * 4
    assert s.faults == 3 and s.pins == {"hot": 0, "warm": 0, "cold": 0}
    st = s.stats()
    assert st["cold_reads"] == 3 and st["cold_appends"] == 3
    s.close()


def test_a_store_on_the_card_is_refused_without_one(monkeypatch):
    """The store's device follows the entry-point rule: CUDA unless the
    caller asks for the CPU, and an error without a card."""
    vals = _values()
    monkeypatch.delenv("KPS_PLATFORM", raising=False)
    if torch.cuda.is_available():
        s = TieredParamStore(vals, KeyRange(0, len(vals)),
                             page_params=PAGE)
        assert s.device.type == "cuda"
        s.close()
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            TieredParamStore(vals, KeyRange(0, len(vals)),
                             page_params=PAGE)
    monkeypatch.setenv("KPS_PLATFORM", "cpu")
    s = TieredParamStore(vals, KeyRange(0, len(vals)), page_params=PAGE)
    assert s.device == torch.device("cpu")
    s.close()
