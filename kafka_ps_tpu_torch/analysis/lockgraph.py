"""Runtime lock-order detector — lockdep for the port's threaded
subsystems (gang dispatch, the fabric, async eval, asynclog, the
durable log, net framing and the socket bridges, serving, the tier
store, telemetry); the port of ``kafka_ps_tpu.analysis.lockgraph``.

`OrderedLock(name)` is a drop-in replacement for `threading.Lock` /
`threading.RLock` (pass ``reentrant=True``); `OrderedCondition(name)`
replaces `threading.Condition()`.  While a recorder is installed
(by the pytest plugin, kafka_ps_tpu_torch/analysis/pytest_plugin.py,
or by ``isolated()`` around a run)
every acquisition records directed edges *held-lock -> new-lock* into a
global acquisition graph, keyed by lock NAME rather than instance — so
"some thread takes ServerBridge.send then Fabric.cond" and "another
takes Fabric.cond then ServerBridge.send" collide even when the
instances differ.  A cycle in that graph is a potential deadlock: two
threads can each hold one edge endpoint and block on the other.

Outside tests no recorder is installed and acquire/release reduce to a
None check plus the raw ``_thread`` primitive — zero-cost pass-through.

Condition protocol: ``threading.Condition`` drives its lock through
``acquire``/``release`` and, when present, ``_release_save`` /
``_acquire_restore`` / ``_is_owned``.  ``cond.wait()`` must fully
release the lock (all recursion levels) and restore it on wake without
corrupting the per-thread held-stack, so OrderedLock implements all
three with explicit bookkeeping instead of inheriting the defaults.
"""

from __future__ import annotations

import os
import threading
import traceback
from contextlib import contextmanager
from dataclasses import dataclass, field

__all__ = [
    "OrderedLock",
    "OrderedCondition",
    "LockGraph",
    "enable",
    "disable",
    "current",
    "isolated",
]

_tls = threading.local()


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


@dataclass
class _Edge:
    """First-observed witness for one ordered pair (src held -> dst
    acquired)."""
    src: str
    dst: str
    site: str          # "file.py:123 in func" where dst was acquired
    thread: str


@dataclass
class LockGraph:
    """The global acquisition-order graph: nodes are lock names, an
    edge a->b means some thread acquired b while holding a."""

    edges: dict[tuple[str, str], _Edge] = field(default_factory=dict)
    # lock name -> source location of its FIRST acquisition ("file:line
    # in func"), so exported edges can say where each endpoint lives —
    # the lockflow coverage diff uses this to point at unexercised edges
    names: dict[str, str] = field(default_factory=dict)
    acquisitions: int = 0
    _mu: threading.Lock = field(default_factory=threading.Lock)

    def note(self, name: str, held: list[str]) -> None:
        with self._mu:
            self.acquisitions += 1
            first = name not in self.names
            if first:
                self.names[name] = ""      # claimed; site filled below
            new = [h for h in held if h != name and (h, name) not in self.edges]
        if not (new or first):
            return
        site = _call_site()
        tname = threading.current_thread().name
        with self._mu:
            if first and not self.names[name]:
                self.names[name] = site
            for h in new:
                self.edges.setdefault(
                    (h, name), _Edge(h, name, site, tname))

    def cycles(self) -> list[list[_Edge]]:
        """Every elementary inconsistency as a list of witness edges
        forming a closed walk A->B->...->A.  Computed via Tarjan SCC;
        each non-trivial SCC contributes one representative cycle."""
        with self._mu:
            adj: dict[str, set[str]] = {}
            for (a, b) in self.edges:
                adj.setdefault(a, set()).add(b)
                adj.setdefault(b, set())
            edges = dict(self.edges)

        sccs = _tarjan(adj)
        out = []
        for comp in sccs:
            if len(comp) < 2:
                continue
            cyc = _cycle_in(adj, comp)
            out.append([edges[(a, b)] for a, b in zip(cyc, cyc[1:] + cyc[:1])])
        return out

    def export_edges(self) -> list[dict]:
        """Every observed ordering edge as plain JSON-safe dicts — the
        public read surface the flight recorder's dump uses
        (telemetry/flight.py), so postmortem tooling sees the lock
        order a dead process had actually exercised."""
        with self._mu:
            edges = list(self.edges.values())
            names = dict(self.names)
        return [{"src": e.src, "dst": e.dst, "site": e.site,
                 "thread": e.thread,
                 "src_first": names.get(e.src, ""),
                 "dst_first": names.get(e.dst, "")} for e in edges]

    def summary(self) -> str:
        with self._mu:
            return (f"{len(self.names)} locks, {len(self.edges)} ordered "
                    f"pairs, {self.acquisitions} recorded acquisitions")


# the frames _call_site skips: this module's and threading's (by path,
# so that a caller's file named *lockgraph.py still counts as a site)
_SKIP_FILES = frozenset(os.path.abspath(f)
                        for f in (__file__, threading.__file__))


def _call_site() -> str:
    """First stack frame outside this module and threading.py."""
    for fr in reversed(traceback.extract_stack(limit=12)):
        fn = fr.filename
        if os.path.abspath(fn) in _SKIP_FILES:
            continue
        return f"{fn}:{fr.lineno} in {fr.name}"
    return "<unknown>"


def _tarjan(adj: dict[str, set]) -> list[list[str]]:
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on: set = set()
    stack: list[str] = []
    out: list[list[str]] = []
    counter = [0]

    def strong(v):
        # iterative DFS (fixture graphs are tiny, but no recursion limit
        # surprises on adversarial inputs)
        work = [(v, iter(sorted(adj[v])))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(sorted(adj[w]))))
                    advanced = True
                    break
                if w in on:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                out.append(comp)

    for v in sorted(adj):
        if v not in index:
            strong(v)
    return out


def _cycle_in(adj: dict[str, set], comp: list[str]) -> list[str]:
    """One closed walk through a non-trivial SCC (DFS back to start)."""
    comp_set = set(comp)
    start = sorted(comp)[0]
    path = [start]
    seen = {start}

    def dfs(v):
        for w in sorted(adj[v] & comp_set):
            if w == start and len(path) > 1:
                return True
            if w not in seen:
                seen.add(w)
                path.append(w)
                if dfs(w):
                    return True
                path.pop()
                seen.discard(w)
        return False

    dfs(start)
    return path


# -- recorder installation -------------------------------------------------

_graph: LockGraph | None = None


def enable() -> LockGraph:
    """Install a fresh global recorder (idempotent-ish: returns the
    existing one if already enabled)."""
    global _graph
    if _graph is None:
        _graph = LockGraph()
    return _graph


def disable() -> None:
    global _graph
    _graph = None


def current() -> LockGraph | None:
    return _graph


@contextmanager
def isolated():
    """Swap in a private LockGraph for the duration (test helper: the
    deliberate AB/BA fixture must not pollute the session graph)."""
    global _graph
    prev = _graph
    _graph = g = LockGraph()
    try:
        yield g
    finally:
        _graph = prev


# -- the drop-in primitives ------------------------------------------------

class OrderedLock:
    """Named lock that reports acquisition order to the installed
    recorder.  ``reentrant=True`` wraps an RLock (each re-acquisition
    pushes another held-stack entry; self-edges are never recorded)."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str, reentrant: bool = False):
        self.name = name
        self._lock = threading.RLock() if reentrant else threading.Lock()

    def __repr__(self):
        return f"<OrderedLock {self.name!r} {self._lock!r}>"

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            g = _graph
            if g is not None:
                held = _held()
                g.note(self.name, held)
                held.append(self.name)
        return got

    def release(self) -> None:
        if _graph is not None:
            held = _held()
            # remove the innermost matching entry (tolerates enable/
            # disable transitions mid-hold)
            for i in range(len(held) - 1, -1, -1):
                if held[i] == self.name:
                    del held[i]
                    break
        self._lock.release()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    def locked(self) -> bool:
        return self._lock.locked()

    # -- threading.Condition protocol -------------------------------------

    def _is_owned(self) -> bool:
        inner = getattr(self._lock, "_is_owned", None)
        if inner is not None:
            return inner()
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True

    def _release_save(self):
        """Fully release (all recursion levels) for Condition.wait,
        dropping every held-stack entry for this lock."""
        dropped = 0
        if _graph is not None:
            held = _held()
            dropped = held.count(self.name)
            if dropped:
                _tls.held = [h for h in held if h != self.name]
        inner = getattr(self._lock, "_release_save", None)
        if inner is not None:
            return (inner(), dropped, True)
        self._lock.release()
        return (None, dropped, False)

    def _acquire_restore(self, state) -> None:
        saved, dropped, has_proto = state
        if has_proto:
            self._lock._acquire_restore(saved)
        else:
            self._lock.acquire()
        g = _graph
        if g is not None:
            held = _held()
            g.note(self.name, held)
            held.extend([self.name] * max(dropped, 1))


def OrderedCondition(name: str) -> threading.Condition:
    """threading.Condition over a named reentrant OrderedLock — the
    drop-in for ``threading.Condition()`` in migrated modules."""
    return threading.Condition(OrderedLock(name, reentrant=True))
