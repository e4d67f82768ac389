"""TieredParamStore: hot/warm/cold residency for one theta slice
(counterpart of kafka_ps_tpu/store/tiered.py).

The server's parameter slice is split into fixed-size PAGES (contiguous
key ranges).  Each page lives in exactly one tier at a time:

  hot   a float32 tensor on the server's device (compress/slab.
        ParamPageSlab);
  warm  a float32 host array;
  cold  one CRC-framed record in a commit log, addressed by offset
        (store/cold.ColdStore).

Per-page heat (reads through `pin`/`pin_pages`, writes through
`update_page`) drives promotion and demotion on a policy thread.  The
byte caps bound what is resident on the device and on the host; every
other page is a log record.

Residency never changes values:

  * pages are replaced whole, never written in place, so any thread may
    keep using a value it obtained earlier;
  * a migration moves the same float32 bits between tiers (upload,
    fetch, log append and point read), so the tier a page is in is
    invisible to every computation: a capped run is bitwise the fully
    resident run, whenever the policy thread runs;
  * the plan is a pure function of the heat counters (pages ordered by
    (-heat, index)); only its timing depends on the scheduler.

Locking (analysis/lockgraph, PS105): one leaf `store.residency`
OrderedLock guards the residency table; the pass lock `store.pass` (the
port's: passes run one at a time) is taken before it.  Blocking
work (log appends and point reads, uploads, fetches) runs outside it: a
migration snapshots (value, version) under the lock, does its I/O
unlocked, then commits only if the page's version is unchanged, so a
racing write wins and the abandoned cold record is append-only garbage.
Writes land hot or warm, so `update_page` never appends to the log.

Port specifics:
  * the store is built for a device (the server's: a hot page lives
    there, never on an implicit default); a warm page is a numpy array;
  * `assembled_tensor()` builds the slice on that device (hot pages as
    they are, warm pages uploaded), bitwise `assembled()`, for the
    server's consumers that take a device tensor; `to_device` uploads a
    warm page for an apply.  Both count their bytes in
    `host_upload_bytes`, and device-to-host fetches outside the slab
    (a demotion, a write to a page that left the hot tier, a
    whole-slice replacement) count in `host_fetch_bytes`;
  * a migration pass keeps the hot pages' bytes under the hot cap at
    every moment (`_migrate`);
  * telemetry (`telemetry=`, null by default) is the JAX store's: the
    families `param_tier_pins_total{tier}`,
    `param_tier_migrations_total{direction}`,
    `param_tier_migration_ms{direction}`, `param_range_heat{kind,range}`
    and `param_tier_pages{tier}` (the last two set at each policy pass),
    and the flight records `store.fault`, `store.promote` and
    `store.demote`.  The plain counters the stats line reads stay beside
    them: `pins`, `faults`, `promotions`, `demotions`, `rebalances`,
    `heat_vectors()` and `stats()`.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from kafka_ps_tpu_torch.analysis.lockgraph import OrderedLock
from kafka_ps_tpu_torch.runtime.messages import KeyRange
from kafka_ps_tpu_torch.telemetry import NULL_TELEMETRY
from kafka_ps_tpu_torch.telemetry.flight import FLIGHT
from kafka_ps_tpu_torch.utils.config import resolve_device

TIER_HOT, TIER_WARM, TIER_COLD = 0, 1, 2
TIER_NAMES = ("hot", "warm", "cold")


def attach_tiered_store(server, tier, key_range: KeyRange,
                        cold_dir: str | None = None):
    """Give `server`'s slice over `key_range` to a TieredParamStore on the
    server's device, under `tier` (utils/config.TierConfig), with its
    cold partition in `cold_dir` (a warm cap needs one), and start the
    policy thread.  None when both caps are 0: theta stays resident."""
    if not tier.enabled:
        return None
    from kafka_ps_tpu_torch.store.cold import ColdStore
    cold = ColdStore.open(cold_dir) if cold_dir is not None else None
    store = TieredParamStore(
        server.theta, key_range, hot_bytes=tier.hot_bytes,
        warm_bytes=tier.warm_bytes, page_params=tier.page_params, cold=cold,
        device=server.device, rebalance_interval_s=tier.rebalance_interval_s,
        telemetry=server.telemetry)
    server.attach_param_store(store)
    store.start_policy_thread()
    return store


class _Page:
    """Residency record for one key range.  `value` is a device tensor
    (hot), a host float32 array (warm), or None (cold: `cold_offset`
    addresses the log record).  `version` counts value replacements;
    migrations commit only against an unchanged version."""

    __slots__ = ("index", "start", "end", "tier", "value", "cold_offset",
                 "version", "reads", "writes")

    def __init__(self, index: int, start: int, end: int,
                 value: np.ndarray):
        self.index = index
        self.start = start
        self.end = end
        self.tier = TIER_WARM
        self.value = value
        self.cold_offset = -1
        self.version = 0
        self.reads = 0
        self.writes = 0

    @property
    def nbytes(self) -> int:
        return (self.end - self.start) * 4

    @property
    def heat(self) -> int:
        return self.reads + self.writes


class TieredParamStore:
    """Paged hot/warm/cold store for one server's theta slice."""

    def __init__(self, values, key_range: KeyRange, *,
                 hot_bytes: int = 0, warm_bytes: int = 0,
                 page_params: int = 1024, cold=None, device=None,
                 rebalance_interval_s: float = 0.05, telemetry=None):
        from kafka_ps_tpu_torch.compress.slab import ParamPageSlab
        if page_params <= 0:
            raise ValueError("page_params must be positive")
        if warm_bytes > 0 and cold is None:
            raise ValueError(
                "a warm-tier cap needs a cold store to overflow into "
                "(pass cold=ColdStore.open(...) or run under "
                "--durable-log)")
        self.key_range = key_range
        self.page_params = page_params
        # 0 = unbounded
        self.hot_budget = hot_bytes if hot_bytes > 0 else None
        self.warm_budget = warm_bytes if warm_bytes > 0 else None
        self.cold = cold
        self.rebalance_interval_s = rebalance_interval_s
        self._slab = ParamPageSlab(resolve_device(device))
        self.device = self._slab.device
        self._lock = OrderedLock("store.residency")
        # one policy pass at a time: the policy thread's, a drive loop's
        # settling pass and the final one at close
        self._pass_lock = OrderedLock("store.pass")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # host counters for the stats line (no device sync near them)
        self.pins = {"hot": 0, "warm": 0, "cold": 0}
        # guarded-by: _lock (rebalance writes hold the residency lock; stats reads are snapshots)
        self.promotions = 0
        # guarded-by: _lock (rebalance writes hold the residency lock; stats reads are snapshots)
        self.demotions = 0
        self.faults = 0          # cold pages materialized on demand
        # guarded-by: _lock (rebalance writes hold the residency lock; stats reads are snapshots)
        self.rebalances = 0
        # the tier counts a rebalance left (reads and writes move pages
        # up until the next one)
        # guarded-by: _lock (rebalance writes hold the residency lock; stats reads are snapshots)
        self.settled = {"hot": 0, "warm": 0, "cold": 0}
        self.host_upload_bytes = 0
        # guarded-by: _lock (the policy thread and the apply path both fetch; stats reads are snapshots)
        self.host_fetch_bytes = 0
        telemetry = telemetry or NULL_TELEMETRY
        self.telemetry = telemetry
        self._m_pins = {t: telemetry.counter("param_tier_pins_total",
                                             tier=t)
                        for t in TIER_NAMES}
        self._m_migrations = {
            d: telemetry.counter("param_tier_migrations_total",
                                 direction=d)
            for d in ("promote", "demote")}
        self._m_migration_ms = {
            d: telemetry.histogram("param_tier_migration_ms", direction=d)
            for d in ("promote", "demote")}

        vals = self._host(values)
        if vals.shape != (key_range.end - key_range.start,):
            raise ValueError(
                f"values shape {vals.shape} != key range "
                f"[{key_range.start}, {key_range.end})")
        self._pages: list[_Page] = []
        for i, lo in enumerate(range(key_range.start, key_range.end,
                                     page_params)):
            hi = min(lo + page_params, key_range.end)
            self._pages.append(_Page(
                i, lo, hi,
                vals[lo - key_range.start:hi - key_range.start].copy()))
        self.rebalance()         # settle the initial residency

    # -- host and device forms of a page value ------------------------------

    def _host(self, value) -> np.ndarray:
        """A host float32 array of `value`; a tensor's fetch is counted
        when it leaves the device."""
        if isinstance(value, np.ndarray):
            return np.ascontiguousarray(value, dtype=np.float32)
        t = value.detach()
        if t.device.type != "cpu":
            # the policy thread and an apply both fetch (never under the
            # residency lock: the copy runs outside it)
            with self._lock:
                self.host_fetch_bytes += t.nbytes
            return t.to("cpu", torch.float32).numpy()
        return t.to(torch.float32).numpy().copy()

    def to_device(self, value) -> torch.Tensor:
        """A page value as a tensor on the store's device: a hot page as
        it is, a warm one uploaded (counted)."""
        if isinstance(value, torch.Tensor):
            return value
        host = np.ascontiguousarray(value, dtype=np.float32)
        self.host_upload_bytes += host.nbytes
        return torch.tensor(host, device=self.device)

    # -- page geometry ------------------------------------------------------

    @property
    def num_pages(self) -> int:
        return len(self._pages)

    def pages_overlapping(self, key_range: KeyRange) -> range:
        """Indices of pages intersecting [start, end)."""
        start = max(key_range.start, self.key_range.start)
        end = min(key_range.end, self.key_range.end)
        if end <= start:
            return range(0)
        first = (start - self.key_range.start) // self.page_params
        last = (end - 1 - self.key_range.start) // self.page_params
        return range(first, last + 1)

    def page_range(self, index: int) -> KeyRange:
        p = self._pages[index]
        return KeyRange(p.start, p.end)

    # -- reads --------------------------------------------------------------

    def pin_pages(self, key_range: KeyRange, count_heat: bool = True):
        """Materialize every page overlapping `key_range`: [(page index,
        KeyRange, value)] with a device tensor for a hot page and a host
        float32 array for a warm or cold one (a cold page is read from
        the log and installed warm).  Counts read heat and per-tier pins
        unless `count_heat` is False."""
        touched = self.pages_overlapping(key_range)
        out = []
        faults = []              # (page, offset, version)
        with self._lock:
            for i in touched:
                p = self._pages[i]
                if count_heat:
                    p.reads += 1
                    tier = TIER_NAMES[p.tier]
                    self.pins[tier] += 1
                    if self.telemetry.enabled:
                        self._m_pins[tier].inc()
                if p.tier == TIER_COLD:
                    faults.append((p, p.cold_offset, p.version))
                    out.append([i, KeyRange(p.start, p.end), None])
                else:
                    out.append([i, KeyRange(p.start, p.end), p.value])
        if faults:
            # the log's point reads run outside the residency lock
            t0 = time.perf_counter()
            fetched = [(p, ver,
                        self.cold.get(off, p.index, p.start, p.end))
                       for p, off, ver in faults]
            dt_ms = (time.perf_counter() - t0) * 1e3
            by_index = {}
            with self._lock:
                for p, ver, vals in fetched:
                    if p.tier == TIER_COLD and p.version == ver:
                        # installed warm: the value is unchanged, so the
                        # version is not bumped
                        p.tier = TIER_WARM
                        p.value = vals
                        p.cold_offset = -1
                        self.faults += 1
                        self.promotions += 1
                    # else a racing write landed a newer value: use it
                    by_index[p.index] = p.value
            if self.telemetry.enabled:
                self._m_migrations["promote"].inc(len(fetched))
                self._m_migration_ms["promote"].observe(dt_ms)
            if FLIGHT.enabled:
                # a demand fault is the tail-latency event a postmortem
                # wants on the timeline: how many pages, how long
                FLIGHT.record("store.fault", pages=len(fetched),
                              ms=round(dt_ms, 3))
            for entry in out:
                if entry[2] is None:
                    entry[2] = by_index[entry[0]]
        return [tuple(e) for e in out]

    def pin(self, key_range: KeyRange, count_heat: bool = True
            ) -> np.ndarray:
        """Host float32 vector for exactly [start, end)."""
        pages = self.pin_pages(key_range, count_heat=count_heat)
        start = max(key_range.start, self.key_range.start)
        end = min(key_range.end, self.key_range.end)
        out = np.empty(end - start, dtype=np.float32)
        for _, kr, value in pages:
            host = self._host(value)
            lo, hi = max(kr.start, start), min(kr.end, end)
            out[lo - start:hi - start] = host[lo - kr.start:hi - kr.start]
        return out

    def assembled(self) -> np.ndarray:
        """The whole slice as a new host vector, with no heat counted
        (reading the whole slice must not make every page look hot)."""
        return self.pin(self.key_range, count_heat=False)

    def assembled_tensor(self) -> torch.Tensor:
        """The whole slice as a new tensor on the store's device, with no
        heat counted: hot pages as they are, warm pages uploaded, cold
        pages faulted in warm first.  Bitwise `assembled()`."""
        pages = self.pin_pages(self.key_range, count_heat=False)
        return torch.cat([self.to_device(v) for _, _, v in pages])

    # -- writes -------------------------------------------------------------

    def update_page(self, index: int, values) -> None:
        """Replace one page's value (an apply's output).  A tensor stays
        on the device when the page is hot; a write to a warm or cold
        page lands warm (never a log append: the log's I/O is the policy
        thread's)."""
        p = self._pages[index]
        prepared = values
        while True:
            if isinstance(prepared, np.ndarray):
                prepared = np.ascontiguousarray(prepared, dtype=np.float32)
            with self._lock:
                is_host = isinstance(prepared, np.ndarray)
                if p.tier == TIER_HOT:
                    p.value = self._slab.put(index, prepared)
                elif is_host:
                    if p.tier == TIER_COLD:
                        p.tier = TIER_WARM
                        p.cold_offset = -1
                    p.value = prepared
                # else: a tensor, but the policy thread demoted the page
                # meanwhile; fetch it outside the lock and retry
                if p.tier == TIER_HOT or is_host:
                    p.version += 1
                    p.writes += 1
                    return
            prepared = self._host(prepared)

    def replace_all(self, values) -> None:
        """Scatter a whole slice into the pages, keeping residency where
        it can (a cold page lands warm; the policy demotes it again): the
        theta setter's path (checkpoint restore, the splice apply, the
        eval applies).  A tensor's hot pages stay on the device (copied,
        so no page keeps the caller's storage alive); the others come
        from one fetch of the slice, made outside the lock when a page
        is not hot."""
        n = self.key_range.end - self.key_range.start
        dev = host = None
        if isinstance(values, torch.Tensor):
            dev = values.detach().to(self.device, torch.float32)
            if tuple(dev.shape) != (n,):
                raise ValueError(f"replace_all shape {tuple(dev.shape)}")
        else:
            host = self._host(values)
            if host.shape != (n,):
                raise ValueError(f"replace_all shape {host.shape}")
        base = self.key_range.start
        while True:
            with self._lock:
                if host is None and any(p.tier != TIER_HOT
                                        for p in self._pages):
                    pass         # fetch outside the lock, then retry
                else:
                    for p in self._pages:
                        lo, hi = p.start - base, p.end - base
                        p.version += 1
                        p.writes += 1
                        if p.tier == TIER_HOT:
                            p.value = self._slab.put(
                                p.index,
                                host[lo:hi].copy() if dev is None
                                else dev[lo:hi].clone())
                        else:
                            if p.tier == TIER_COLD:
                                p.tier = TIER_WARM
                                p.cold_offset = -1
                            p.value = host[lo:hi].copy()
                    return
            host = self._host(dev)

    # -- the policy ---------------------------------------------------------

    def _plan_locked(self) -> dict[int, int]:
        """Target residency from the heat counters: pages ordered by
        (-heat, index), hot until the hot budget, then warm until the
        warm budget, then cold.  A pure function of the counters."""
        order = sorted(self._pages, key=lambda p: (-p.heat, p.index))
        targets: dict[int, int] = {}
        hot_left = self.hot_budget
        warm_left = self.warm_budget
        for p in order:
            if hot_left is None or p.nbytes <= hot_left:
                targets[p.index] = TIER_HOT
                if hot_left is not None:
                    hot_left -= p.nbytes
            elif self.cold is None or warm_left is None \
                    or p.nbytes <= warm_left:
                targets[p.index] = TIER_WARM
                if warm_left is not None:
                    warm_left = max(warm_left - p.nbytes, 0)
            else:
                targets[p.index] = TIER_COLD
        return targets

    def rebalance(self) -> dict:
        """One policy pass: plan, migrate the difference (I/O outside the
        lock, version-checked commits), halve the heat counters, set the
        heat and page-count gauges.  Passes run one at a time."""
        with self._pass_lock:
            return self._rebalance()

    def _rebalance(self) -> dict:
        with self._lock:
            targets = self._plan_locked()
            moves = [(p, targets[p.index], p.value, p.cold_offset,
                      p.version)
                     for p in self._pages if p.tier != targets[p.index]]
        applied = self._migrate(moves)
        with self._lock:
            self.rebalances += 1
            counts = [0, 0, 0]
            for p in self._pages:
                # the policy follows shifts of access, not lifetime
                # totals; integer halving keeps the plan deterministic
                p.reads //= 2
                p.writes //= 2
                counts[p.tier] += 1
            self.settled = dict(zip(TIER_NAMES, counts))
            if self.telemetry.enabled:
                for p in self._pages:
                    rng = f"{p.start}:{p.end}"
                    self.telemetry.gauge("param_range_heat", kind="read",
                                         range=rng).set(p.reads)
                    self.telemetry.gauge("param_range_heat", kind="write",
                                         range=rng).set(p.writes)
                for t, n in zip(TIER_NAMES, counts):
                    self.telemetry.gauge("param_tier_pages",
                                         tier=t).set(n)
        return {"moved": applied, "targets": len(moves)}

    def _migrate(self, moves) -> int:
        """Apply (page, target tier) moves: the host fetch, log append,
        log read or upload runs with the lock released; each commit
        re-checks the page's version, so a racing `update_page` wins.

        The hot pages' bytes never exceed the hot cap: the moves out of
        the hot tier run first, and a page enters the slab only at its
        commit, when the slab has room for it (a demotion a racing write
        abandoned keeps its page hot; the promotion it would have made
        room for waits for a later pass).  The JAX store installs an
        upload before its commit, in page order, so its hot tier can
        hold more than the cap while a pass runs."""
        applied = 0
        moves = sorted(moves, key=lambda m: m[1] == TIER_HOT)
        for p, target, value, cold_offset, version in moves:
            promote = target < p.tier
            t0 = time.perf_counter()
            # unlocked I/O: the value in the target tier's form
            if target == TIER_COLD:
                new_offset = self.cold.put(p.index, p.start, p.end,
                                           self._host(value))
                new_value = None
            elif target == TIER_WARM:
                if value is None:       # cold -> warm: a point read
                    new_value = self.cold.get(cold_offset, p.index,
                                              p.start, p.end)
                else:
                    new_value = self._host(value)
                new_offset = -1
            else:                       # -> hot: an upload
                if value is None:
                    value = self.cold.get(cold_offset, p.index,
                                          p.start, p.end)
                new_value = self._slab.upload(value)
                new_offset = -1
            # the locked, version-checked commit
            with self._lock:
                if p.version != version:
                    # a write replaced the value meanwhile: abandon (an
                    # appended cold record is garbage nothing refers to)
                    continue
                if target == TIER_HOT:
                    if (self.hot_budget is not None
                            and self._slab.device_bytes() + p.nbytes
                            > self.hot_budget):
                        continue
                    self._slab.put(p.index, new_value)
                elif p.tier == TIER_HOT:
                    self._slab.drop(p.index)
                p.tier = target
                p.value = new_value
                p.cold_offset = new_offset
                applied += 1
                if promote:
                    self.promotions += 1
                else:
                    self.demotions += 1
            dt_ms = (time.perf_counter() - t0) * 1e3
            d = "promote" if promote else "demote"
            if self.telemetry.enabled:
                self._m_migrations[d].inc()
                self._m_migration_ms[d].observe(dt_ms)
            if FLIGHT.enabled:
                FLIGHT.record(f"store.{d}", page=p.index,
                              tier=TIER_NAMES[target], ms=round(dt_ms, 3))
        return applied

    # -- the policy thread --------------------------------------------------

    def start_policy_thread(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.rebalance_interval_s):
                self.rebalance()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="kps-tier-policy")
        self._thread.start()

    def close(self) -> None:
        """Join the policy thread, run one last pass that nothing races
        (a pass a write races abandons its demotions, and a read of a cold
        page installs it warm, so the residency the last pass of the
        thread left may hold the warm tier over its cap), and close an
        owned cold log."""
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=10.0)
            self.rebalance()
        self._thread = None
        if self.cold is not None:
            self.cold.close()

    # -- the checkpoint's surface -------------------------------------------

    def residency_vector(self) -> np.ndarray:
        with self._lock:
            return np.array([p.tier for p in self._pages], dtype=np.int8)

    def heat_vectors(self) -> tuple[np.ndarray, np.ndarray]:
        with self._lock:
            return (np.array([p.reads for p in self._pages], np.int64),
                    np.array([p.writes for p in self._pages], np.int64))

    def set_residency(self, tiers, reads=None, writes=None) -> None:
        """Restore recorded residency and heat (utils/checkpoint.py),
        after `replace_all` put the restored values in place.  Recorded-
        cold pages are demoted again with fresh log appends: the
        checkpoint stays self-contained and never refers to records a
        crash may have torn off the log's tail."""
        tiers = np.asarray(tiers)
        if len(tiers) != len(self._pages):
            raise ValueError(
                f"residency vector has {len(tiers)} pages, store has "
                f"{len(self._pages)} — page_params changed across "
                "restore?")
        with self._lock:
            if reads is not None:
                for p, r in zip(self._pages, np.asarray(reads)):
                    p.reads = int(r)
            if writes is not None:
                for p, w in zip(self._pages, np.asarray(writes)):
                    p.writes = int(w)
            moves = [(p, int(t), p.value, p.cold_offset, p.version)
                     for p, t in zip(self._pages, tiers)
                     if p.tier != int(t)]
        self._migrate(moves)

    # -- accounting ---------------------------------------------------------

    def resident_bytes(self) -> dict:
        with self._lock:
            hot = sum(p.nbytes for p in self._pages
                      if p.tier == TIER_HOT)
            warm = sum(p.nbytes for p in self._pages
                       if p.tier == TIER_WARM)
            cold = sum(p.nbytes for p in self._pages
                       if p.tier == TIER_COLD)
        return {"hot": hot, "warm": warm, "cold_logged": cold,
                "resident": hot + warm,
                "total": sum(p.nbytes for p in self._pages)}

    def tier_counts(self) -> dict:
        with self._lock:
            counts = [0, 0, 0]
            for p in self._pages:
                counts[p.tier] += 1
        return dict(zip(TIER_NAMES, counts))

    def stats(self) -> dict:
        """The JAX store's stats, and the port's: the tier counts the last
        rebalance left (`settled_tiers`; `tiers` is the residency now,
        after the reads and writes since), the host traffic counters and
        the cold log's appends and reads."""
        total_pins = sum(self.pins.values()) or 1
        return {
            "pages": self.num_pages,
            "page_params": self.page_params,
            "tiers": self.tier_counts(),
            "settled_tiers": dict(self.settled),
            "pins": dict(self.pins),
            "hit_rate": {t: round(self.pins[t] / total_pins, 4)
                         for t in TIER_NAMES},
            "promotions": self.promotions,
            "demotions": self.demotions,
            "faults": self.faults,
            "rebalances": self.rebalances,
            "resident_bytes": self.resident_bytes(),
            "device_bytes": self._slab.device_bytes(),
            "upload_bytes": self._slab.bytes_uploaded,
            "host_upload_bytes": self.host_upload_bytes,
            "host_fetch_bytes": self.host_fetch_bytes,
            "cold_appends": (self.cold.appends
                             if self.cold is not None else 0),
            "cold_reads": self.cold.reads if self.cold is not None else 0,
        }
