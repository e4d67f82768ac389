"""lockflow — static lock-order analysis (PS203) and the
static-vs-runtime coverage diff.

The runtime lockgraph (analysis/lockgraph.py) records held→acquired
edges only on paths the tests happen to drive.  This pass extracts the
*static* held→acquired graph from ``with <lock>:`` nesting, follows it
across call edges (bounded interprocedural: same-class methods,
``self.<attr>.<m>()`` with ctor-inferred attribute types, same-module
and imported callees), and runs Tarjan over the result:

- a cycle in the static graph is PS203 — a lock-order inversion that
  exists in the code whether or not any test reaches it;
- the *coverage diff* against ``LockGraph.export_edges()`` lists the
  statically-possible edges no test has exercised, with the source
  location of the acquisition that creates each one: the orderings
  no run has reached yet.

Lock names are canonical (program.py): ``OrderedLock("X")`` edges use
the literal ``X`` and therefore line up 1:1 with the runtime graph's
namespace; plain ``threading.Lock`` attributes get ``Class.attr``
names, participate in cycle detection, but are excluded from the
coverage diff (the runtime recorder cannot see them).

Bounds, stated: call resolution is first-match (no aliasing through
containers or higher-order calls), transitive acquisition sets are
computed to a small fixpoint, and ``acquire()``/``release()`` pairs
outside ``with`` are not modeled (the repo has none outside
lockgraph.py itself — pscheck's PS105 keeps it that way).
"""

from __future__ import annotations

from dataclasses import dataclass

from .lockgraph import _tarjan
from .pscheck import Finding
from .program import Program

__all__ = ["RULES", "StaticEdge", "check", "static_edges",
           "coverage_diff"]

RULES = {
    "PS203": "static lock-order cycle: inconsistent held→acquired "
             "ordering on a path no runtime test exercises",
}


@dataclass(frozen=True)
class StaticEdge:
    src: str
    dst: str
    site: str                  # file:line of the acquisition closing it

    def to_json(self) -> dict:
        return {"src": self.src, "dst": self.dst, "site": self.site}


def _resolve(prog: Program, fn, ev):
    """CallEvent -> MethodInfo/function, or None."""
    kind = ev.target[0]
    if kind == "self" and fn.cls is not None:
        return fn.cls.methods.get(ev.target[1])
    if kind == "attr" and fn.cls is not None:
        tname = fn.cls.attr_types.get(ev.target[1])
        if tname:
            ci = prog.resolve_class(tname, fn.file)
            if ci is not None:
                return ci.methods.get(ev.target[2])
        return None
    if kind == "var-cls":
        ci = prog.resolve_class(ev.target[1], fn.file)
        if ci is not None:
            return ci.methods.get(ev.target[2])
        return None
    if kind == "name":
        got = fn.file.functions.get(ev.target[1])
        if got is not None:
            return got
        ci = prog.resolve_class(ev.target[1], fn.file)
        if ci is not None:
            return ci.methods.get("__init__")
        return None
    if kind == "mod":
        dotted = fn.file.imports.get(ev.target[1], ev.target[1])
        for sf in prog.files:
            if sf.modname == dotted or dotted.endswith(sf.modname):
                return sf.functions.get(ev.target[2])
    return None


def _transitive_acquires(prog: Program) -> dict:
    """id(fn) -> {(lockname, site)} including bounded callee closure."""
    fns = list(prog.functions())
    acq = {id(f): {(a.lock, f"{f.file.path}:{a.line}") for a in f.acquires}
           for f in fns}
    for _ in range(4):                  # bounded interprocedural depth
        changed = False
        for f in fns:
            mine = acq[id(f)]
            before = len(mine)
            for ev in f.calls:
                callee = _resolve(prog, f, ev)
                if callee is not None:
                    mine |= acq[id(callee)]
            if len(mine) != before:
                changed = True
        if not changed:
            break
    return acq


def _edges(prog: Program) -> dict:
    """(src, dst) -> StaticEdge (first site wins, like the runtime graph)."""
    acq = _transitive_acquires(prog)
    out: dict = {}

    def add(src, dst, site):
        if src != dst:                  # reentrancy is not an ordering
            out.setdefault((src, dst), StaticEdge(src, dst, site))

    for f in prog.functions():
        for a in f.acquires:
            for held in a.held:
                add(held, a.lock, f"{f.file.path}:{a.line}")
        for ev in f.calls:
            if not ev.held:
                continue
            callee = _resolve(prog, f, ev)
            if callee is None:
                continue
            for lock, site in acq[id(callee)]:
                for held in ev.held:
                    add(held, lock, f"{f.file.path}:{ev.line} -> {site}")
    return out


def static_edges(prog: Program) -> list:
    return sorted(_edges(prog).values(), key=lambda e: (e.src, e.dst))


def check(prog: Program) -> list[Finding]:
    edges = _edges(prog)
    adj: dict = {}
    for (src, dst) in edges:
        adj.setdefault(src, set()).add(dst)
        adj.setdefault(dst, set())
    findings = []
    for scc in _tarjan(adj):
        if len(scc) < 2:
            continue
        member = set(scc)
        witnesses = sorted((e for (s, d), e in edges.items()
                            if s in member and d in member),
                           key=lambda e: (e.src, e.dst))
        first = witnesses[0]
        path, _, line = first.site.partition(":")
        line = int(line.split(" ")[0].split(":")[0] or 0)
        findings.append(Finding(
            "PS203", path, line,
            "static lock-order cycle among "
            f"{{{', '.join(sorted(member))}}}; witness edges: "
            + "; ".join(f"{e.src}->{e.dst} @ {e.site}"
                        for e in witnesses[:4])
            + " — impose one acquisition order (or restructure so the "
              "inner lock is taken outside the outer critical section)"))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def coverage_diff(prog: Program, runtime_edges: list) -> dict:
    """Diff the static graph against ``LockGraph.export_edges()`` output.

    Only edges whose endpoints both live in the runtime-visible
    namespace (OrderedLock literals — i.e. names the static pass did
    not synthesize as ``Class.attr``/``module.var``) participate; a
    synthesized name contains no information the runtime recorder
    could ever corroborate.
    """
    ordered_names = set()
    for sf in prog.files:
        for ci in sf.classes:
            for attr, canonical in ci.lock_attrs.items():
                if canonical != f"{ci.name}.{attr}":
                    ordered_names.add(canonical)
        for var, canonical in sf.module_locks.items():
            if canonical != f"{sf.modname}.{var}":
                ordered_names.add(canonical)
    static = {(e.src, e.dst): e for e in static_edges(prog)
              if e.src in ordered_names and e.dst in ordered_names}
    runtime = {(e["src"], e["dst"]): e for e in runtime_edges}
    static_only = [static[k].to_json() for k in sorted(static.keys() -
                                                      runtime.keys())]
    runtime_only = [runtime[k] for k in sorted(runtime.keys() -
                                               static.keys())]
    return {
        "static_edges": len(static),
        "runtime_edges": len(runtime),
        "common": len(static.keys() & runtime.keys()),
        "static_only": static_only,
        "runtime_only": runtime_only,
    }
