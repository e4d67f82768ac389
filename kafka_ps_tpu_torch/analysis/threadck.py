"""threadck — thread-ownership and race detection (PS201, PS202).

A ThreadSanitizer-style *lockset* analysis over the Program model:

1.  The thread roster of a class is inferred from its entry points —
    ``threading.Thread(target=self._m)``, thread-target closures,
    whole-program ``Thread(target=obj.m)`` name matches — plus the
    pseudo-thread ``external`` that drives every public method.
2.  Every ``self.<attr>`` access site carries the set of canonical
    lock names held there (local ``with`` nesting plus the
    intersection of locks held across the method's call sites).
3.  An attribute reachable from ≥2 threads with at least one
    post-``__init__`` write must either have a non-empty lockset
    intersection over *all* its access sites, or carry an explicit
    annotation:

        self._gauges = {}   # guarded-by: _lock
        self._epoch = 0     # owned-by: kps-eval

    Unprotected multi-thread attributes are PS201 (reported at the
    attribute's definition line, where the fix — or the annotation —
    belongs).  Annotations the lockset analysis can *contradict* are
    PS202: a ``guarded-by`` lock that no access site ever holds, a
    lock name that doesn't resolve, an ``owned-by`` thread not in the
    roster, or an access provably reachable only from other threads.

Deliberate soundness trades (documented, not accidental):

- writes inside ``__init__`` (and helpers reachable only from it)
  are publication, not racing;
- container-mutating calls (``self.q.append(x)``) count as reads —
  the container *reference* is what the lockset protects;
- two distinct "external" callers racing each other collapse into
  one pseudo-thread, so external/external races are out of scope
  (the runtime lockgraph and review own those).
"""

from __future__ import annotations

from .pscheck import Finding
from .program import EXTERNAL_THREAD, Program

__all__ = ["RULES", "check"]

RULES = {
    "PS201": "attribute shared across threads without a consistent "
             "lock (lockset intersection empty) or a guarded-by/"
             "owned-by annotation",
    "PS202": "guarded-by/owned-by annotation contradicted by the "
             "lockset/thread analysis (stale lock name, unknown "
             "thread, or provably foreign access)",
}

# attributes that are synchronization primitives or stdlib-atomic by
# construction: Events/queues guard themselves; a bare bool flag does
# not (that is exactly what PS201 exists to catch), so only types with
# internal locking are listed.
_SELF_SYNCING = frozenset({"Event", "Queue", "SimpleQueue", "deque"})


def _annotation_for(ci, attr):
    line = ci.attr_def_lines.get(attr)
    if line is None:
        return None, None
    annots = ci.file.annotations
    for cand in (line, line - 1):
        got = annots.get(cand)
        if got:
            return got, cand
    return None, None


def _site_locks(access):
    return frozenset(access.method.entry_locks | access.locks)


def check(prog: Program) -> list[Finding]:
    findings: list[Finding] = []
    for ci in prog.classes():
        if not ci.thread_entries:
            continue                     # single-threaded class
        roster = {label for _, label in ci.thread_entries}
        roster.add(EXTERNAL_THREAD)

        by_attr: dict[str, list] = {}
        for mi in ci.all_methods():
            if mi.init_only:
                continue                 # pre-publication accesses
            for a in mi.accesses:
                by_attr.setdefault(a.attr, []).append(a)

        for attr in sorted(by_attr):
            sites = by_attr[attr]
            if ci.attr_types.get(attr) in _SELF_SYNCING:
                continue
            threads: set = set()
            for s in sites:
                threads |= s.method.threads
            writes = [s for s in sites if s.write]
            if len(threads) < 2 or not writes:
                continue

            ann, _ann_line = _annotation_for(ci, attr)
            def_line = ci.attr_def_lines.get(attr, writes[0].line)

            if ann is None:
                common = _site_locks(sites[0])
                for s in sites[1:]:
                    common &= _site_locks(s)
                if common:
                    continue
                bare = next((s for s in sites if not _site_locks(s)),
                            sites[0])
                findings.append(Finding(
                    "PS201", ci.file.path, def_line,
                    f"{ci.name}.{attr} is reached from threads "
                    f"{{{', '.join(sorted(threads))}}} with no lock "
                    "common to all access sites (e.g. unlocked at "
                    f"line {bare.line} in {bare.method.name!r}) — hold "
                    "one lock at every site, or annotate the "
                    "definition with `# guarded-by: <lock-attr>` / "
                    "`# owned-by: <thread>` and a pscheck reason"))
                continue

            kind, value = ann
            if kind == "guarded-by":
                canonical = ci.lock_attrs.get(value)
                if canonical is None and value in ci.lock_attrs.values():
                    canonical = value    # canonical name given directly
                if canonical is None:
                    canonical = next(
                        (c for c in ci.lock_attrs.values()
                         if c == value or c.endswith(f".{value}")), None)
                if canonical is None:
                    findings.append(Finding(
                        "PS202", ci.file.path, def_line,
                        f"{ci.name}.{attr} claims guarded-by: {value} "
                        f"but {value!r} names no lock attribute of "
                        f"{ci.name} — stale annotation"))
                    continue
                if not any(canonical in _site_locks(s) for s in sites):
                    findings.append(Finding(
                        "PS202", ci.file.path, def_line,
                        f"{ci.name}.{attr} claims guarded-by: {value} "
                        f"({canonical}) but no access site ever holds "
                        "that lock — the claim is contradicted"))
            elif kind == "owned-by":
                if value not in roster:
                    findings.append(Finding(
                        "PS202", ci.file.path, def_line,
                        f"{ci.name}.{attr} claims owned-by: {value} "
                        f"but the inferred roster is "
                        f"{{{', '.join(sorted(roster))}}} — unknown "
                        "thread label"))
                    continue
                foreign = next(
                    (s for s in sites
                     if s.method.threads and value not in s.method.threads),
                    None)
                if foreign is not None:
                    findings.append(Finding(
                        "PS202", ci.file.path, foreign.line,
                        f"{ci.name}.{attr} claims owned-by: {value} "
                        f"but {foreign.method.name!r} (threads "
                        f"{{{', '.join(sorted(foreign.method.threads))}}}) "
                        f"accesses it at line {foreign.line} and is not "
                        "reachable from that thread — the claim is "
                        "contradicted"))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
