"""pytest plugin: record lock-acquisition order across the whole test
session and fail it if the migrated production locks ever form an
inconsistent (cyclic) order — a potential deadlock.

Load it per run with ``python -m pytest -p
kafka_ps_tpu_torch.analysis.pytest_plugin ...``: tests/conftest.py
registers the reference package's plugin, whose recorder sees only the
reference's locks — the port's OrderedLock reports to this package's
recorder.  Disable for a one-off run with ``LOCKGRAPH=0``.
"""

from __future__ import annotations

import os

from kafka_ps_tpu_torch.analysis import lockgraph

# session exit code when the acquisition graph has a cycle (distinct
# from test failures so CI logs point straight at the detector)
EXIT_LOCK_ORDER_CYCLE = 7


def _enabled(config) -> bool:
    return os.environ.get("LOCKGRAPH", "1") != "0"


def pytest_configure(config):
    if _enabled(config):
        lockgraph.enable()


def pytest_terminal_summary(terminalreporter, exitstatus, config):
    g = lockgraph.current()
    if g is None:
        return
    tr = terminalreporter
    cycles = g.cycles()
    tr.ensure_newline()
    if not cycles:
        tr.line(f"lockgraph: {g.summary()}, no ordering cycles", green=True)
        return
    tr.section("lock-order cycles (potential deadlocks)", sep="=", red=True)
    for cyc in cycles:
        names = " -> ".join([e.src for e in cyc] + [cyc[0].src])
        tr.line(f"cycle: {names}", red=True)
        for e in cyc:
            tr.line(f"  {e.src} -> {e.dst}  first seen at {e.site} "
                    f"[thread {e.thread}]")
    tr.line(f"lockgraph: {g.summary()}, {len(cycles)} cycle(s)", red=True)


def pytest_sessionfinish(session, exitstatus):
    g = lockgraph.current()
    if g is not None and g.cycles():
        session.exitstatus = EXIT_LOCK_ORDER_CYCLE


def pytest_unconfigure(config):
    # after the terminal summary has printed (unconfigure is the last
    # hook) — matters for in-process pytest.main() runs
    lockgraph.disable()
