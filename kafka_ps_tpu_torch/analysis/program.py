"""program — the whole-program AST/symbol model shared by psverify passes.

``pscheck`` is deliberately per-file: each rule inspects one AST in
isolation.  The psverify passes (threadck, lockflow, wireck) need the
opposite: one parse of the whole tree, with symbol tables layered on
top — which classes exist, which attributes hold locks (and under what
*canonical* name, matching the runtime lockgraph's namespace), which
methods are thread entry points, what every ``self.<attr>`` access
site's lockset is, and which callees a call expression resolves to.

This module builds that model exactly once per analysis run; the three
passes are pure functions of it.  Stdlib-only on purpose (same
contract as pscheck): importing it must not pull in torch or jax.
The model is the reference's (``kafka_ps_tpu.analysis.program``) line
for line, so that both analyzers read a tree the same way.

Vocabulary
----------
canonical lock name
    ``OrderedLock("FrameWriter.queue")`` → ``FrameWriter.queue`` (the
    literal, shared with the runtime lockgraph).  A plain
    ``threading.Lock`` on ``self._mu`` of class ``C`` → ``C._mu``.
    ``threading.Condition(self._lock)`` aliases to ``self._lock``'s
    canonical name — waiting on the condition holds that lock.
thread label
    The ``name=`` kwarg of the ``threading.Thread`` that enters the
    method (``kps-eval``), else ``thread:<target>``; the ambient
    caller of public methods is the pseudo-thread ``external``.
annotation
    ``# guarded-by: <lock-attr>`` / ``# owned-by: <thread-label>`` on
    an attribute's definition line (or the line above), stating a
    protection claim the lockset analysis cannot infer.  Contradicted
    claims are PS202 (threadck).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["Program", "SourceFile", "ClassInfo", "MethodInfo",
           "AttrAccess", "Acquire", "CallEvent", "EXTERNAL_THREAD",
           "build"]

EXTERNAL_THREAD = "external"

_LOCK_CTORS = frozenset({
    "OrderedLock", "OrderedCondition", "Lock", "RLock",
    "Condition", "Semaphore", "BoundedSemaphore",
})
_LOCKISH = re.compile(r"lock|mutex|cond|cv|(?:^|[._])mu$", re.IGNORECASE)

ANNOT_RE = re.compile(
    r"#\s*(?P<kind>guarded-by|owned-by):\s*(?P<value>[A-Za-z_][\w.\-]*)")


def _dotted(node) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _const_str(node) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        # f"worker-{wid}" → "worker-*": a coarse but stable label
        out = []
        for v in node.values:
            if isinstance(v, ast.Constant):
                out.append(str(v.value))
            else:
                out.append("*")
        return "".join(out)
    return None


@dataclass
class AttrAccess:
    attr: str
    write: bool
    line: int
    method: "MethodInfo"
    locks: frozenset          # local with-stack at the site (canonical)


@dataclass
class Acquire:
    lock: str                 # canonical name
    held: tuple               # canonical names held when acquiring
    line: int


@dataclass
class CallEvent:
    target: tuple             # ("self", m) | ("attr", a, m) | ("var", v, m)
                              # | ("name", f) | ("mod", local, f)
    held: tuple               # canonical lock names held at the call
    locks: frozenset          # same as held, as a set (threadck view)
    line: int


@dataclass(eq=False)
class MethodInfo:
    name: str
    node: object              # ast.FunctionDef
    cls: "ClassInfo | None"
    file: "SourceFile"
    is_closure: bool = False
    accesses: list = field(default_factory=list)
    acquires: list = field(default_factory=list)
    calls: list = field(default_factory=list)
    threads: set = field(default_factory=set)
    entry_locks: frozenset | None = None
    init_only: bool = False   # reachable from __init__ alone

    @property
    def qname(self) -> str:
        owner = f"{self.cls.name}." if self.cls else ""
        return f"{self.file.modname}.{owner}{self.name}"


@dataclass(eq=False)
class ClassInfo:
    name: str
    node: object              # ast.ClassDef
    file: "SourceFile"
    methods: dict = field(default_factory=dict)    # name -> MethodInfo
    closures: list = field(default_factory=list)   # thread-target closures
    lock_attrs: dict = field(default_factory=dict)  # attr -> canonical
    attr_def_lines: dict = field(default_factory=dict)
    attr_types: dict = field(default_factory=dict)  # attr -> ClassName
    thread_entries: list = field(default_factory=list)  # (MethodInfo, label)

    def all_methods(self):
        yield from self.methods.values()
        yield from self.closures


@dataclass(eq=False)
class SourceFile:
    path: str
    modname: str
    source: str
    tree: object
    annotations: dict = field(default_factory=dict)  # line -> (kind, value)
    imports: dict = field(default_factory=dict)      # local -> dotted
    classes: list = field(default_factory=list)
    functions: dict = field(default_factory=dict)    # name -> MethodInfo
    module_locks: dict = field(default_factory=dict)  # var -> canonical


@dataclass(eq=False)
class Program:
    files: list
    by_class_name: dict       # ClassName -> [ClassInfo]
    global_entries: list      # (method_name, thread_label) from obj.m targets

    def classes(self):
        for f in self.files:
            yield from f.classes

    def functions(self):
        """Every analyzed callable: module functions, methods, closures."""
        for f in self.files:
            yield from f.functions.values()
            for c in f.classes:
                yield from c.all_methods()

    def resolve_class(self, name: str, frm: SourceFile) -> "ClassInfo | None":
        """Resolve a class name as seen from `frm` (import-aware; falls
        back to a program-wide unique name)."""
        cands = self.by_class_name.get(name, [])
        if len(cands) == 1:
            return cands[0]
        imp = frm.imports.get(name)
        for c in cands:
            if c.file.modname == frm.modname:
                return c
            if imp and imp.endswith(f"{c.file.modname}.{name}"):
                return c
        return cands[0] if cands else None


# -- per-file collection ---------------------------------------------------

def _modname(path: Path, root: Path) -> str:
    try:
        rel = path.relative_to(root)
    except ValueError:
        rel = Path(path.name)
    parts = list(rel.with_suffix("").parts)
    if parts and parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts) or path.stem


def _collect_imports(tree, modname: str) -> dict:
    out = {}
    pkg = modname.rsplit(".", 1)[0] if "." in modname else ""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                base = pkg if not base else f"{pkg}.{base}"
            for a in node.names:
                out[a.asname or a.name] = f"{base}.{a.name}" if base \
                    else a.name
    return out


def _lock_ctor(value, cls_name: str, attr: str):
    """-> (canonical_name, alias_attr|None) if `value` constructs a lock."""
    if not isinstance(value, ast.Call):
        return None
    leaf = _dotted(value.func).split(".")[-1]
    if leaf not in _LOCK_CTORS:
        return None
    if leaf in ("OrderedLock", "OrderedCondition"):
        lit = _const_str(value.args[0]) if value.args else None
        return (lit or f"{cls_name}.{attr}", None)
    if leaf == "Condition" and value.args:
        a0 = value.args[0]
        if (isinstance(a0, ast.Attribute) and isinstance(a0.value, ast.Name)
                and a0.value.id == "self"):
            return (f"{cls_name}.{attr}", a0.attr)   # alias, resolved later
        if isinstance(a0, ast.Name):
            return (f"{cls_name}.{attr}", a0.id)
    return (f"{cls_name}.{attr}", None)


def _collect_class_locks(ci: ClassInfo) -> None:
    aliases = {}
    for node in ast.walk(ci.node):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            attr = None
            if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                attr = t.attr
            elif (isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Attribute)
                    and isinstance(t.value.value, ast.Name)
                    and t.value.value.id == "self"):
                attr = t.value.attr           # self._send_lock[conn] = ...
            elif isinstance(t, ast.Name) and node in ci.node.body:
                attr = t.id                    # class-body lock attribute
            if attr is None:
                continue
            got = _lock_ctor(node.value, ci.name, attr)
            if got is None:
                continue
            canonical, alias = got
            if alias is not None:
                aliases[attr] = alias
            else:
                ci.lock_attrs[attr] = canonical
    for attr, target in aliases.items():
        ci.lock_attrs[attr] = ci.lock_attrs.get(
            target, f"{ci.name}.{target}")


def _collect_attr_defs(ci: ClassInfo) -> None:
    init = ci.methods.get("__init__")
    scopes = [init.node] if init else []
    for m in ci.methods.values():
        if m.node not in scopes:
            scopes.append(m.node)
    for scope in scopes:
        for node in ast.walk(scope):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                targets = [node.target]
            for t in targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                        and t.attr not in ci.attr_def_lines):
                    ci.attr_def_lines[t.attr] = t.lineno
            if (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Attribute)
                    and isinstance(node.targets[0].value, ast.Name)
                    and node.targets[0].value.id == "self"
                    and isinstance(node.value, ast.Call)):
                cls = _dotted(node.value.func).split(".")[-1]
                if cls and cls[0].isupper():
                    ci.attr_types.setdefault(node.targets[0].attr, cls)


# -- the per-function walker -----------------------------------------------

class _FnWalker(ast.NodeVisitor):
    """One walk per callable: attribute accesses with locksets, lock
    acquisitions with held-stacks, and call events for later
    resolution.  Closures promoted to thread entries are walked
    separately and skipped here."""

    def __init__(self, mi: MethodInfo, skip_nodes: set):
        self.mi = mi
        self.ci = mi.cls
        self.skip = skip_nodes
        self.stack: list[str] = []     # canonical lock names held
        self.aliases: dict[str, str] = {}   # local var -> canonical lock
        self.types: dict[str, tuple] = {}   # local var -> ("cls", name) etc.
        self._consumed: set[int] = set()    # Attribute ids already counted

    # lock name resolution for a with-item context expression
    def _lock_name(self, expr) -> str | None:
        if isinstance(expr, ast.Subscript):
            expr = expr.value
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self" and self.ci is not None):
            got = self.ci.lock_attrs.get(expr.attr)
            if got:
                return got
            if _LOCKISH.search(expr.attr):
                return f"{self.ci.name}.{expr.attr}"
            return None
        if isinstance(expr, ast.Name):
            if expr.id in self.aliases:
                return self.aliases[expr.id]
            mod = self.mi.file.module_locks.get(expr.id)
            if mod:
                return mod
            if _LOCKISH.search(expr.id):
                return f"{self.mi.file.modname}.{expr.id}"
        return None

    def visit_With(self, node):
        pushed = 0
        for item in node.items:
            self.visit(item.context_expr)   # evaluated before acquiring
            name = self._lock_name(item.context_expr)
            if name is not None:
                self.mi.acquires.append(
                    Acquire(name, tuple(self.stack), item.context_expr.lineno))
                self.stack.append(name)
                pushed += 1
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(pushed):
            self.stack.pop()

    visit_AsyncWith = visit_With

    def visit_FunctionDef(self, node):
        if id(node) in self.skip:
            return                      # thread-entry closure: walked apart
        self.generic_visit(node)        # inline closure: same thread context

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assign(self, node):
        # local lock aliases and local object types feed resolution
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            tgt = node.targets[0].id
            v = node.value
            if (isinstance(v, ast.Attribute) and isinstance(v.value, ast.Name)
                    and v.value.id == "self" and self.ci is not None):
                if v.attr in self.ci.lock_attrs:
                    self.aliases[tgt] = self.ci.lock_attrs[v.attr]
                elif v.attr in self.ci.attr_types:
                    self.types[tgt] = ("cls", self.ci.attr_types[v.attr])
            elif isinstance(v, ast.Call):
                leaf = _dotted(v.func).split(".")[-1]
                if leaf and leaf[0].isupper():
                    self.types[tgt] = ("cls", leaf)
        self.generic_visit(node)

    def _record(self, attr: str, write: bool, line: int) -> None:
        ci = self.ci
        if ci is None:
            return
        if attr in ci.lock_attrs or attr in ci.methods:
            return                      # lock objects / bound methods
        self.mi.accesses.append(AttrAccess(
            attr, write, line, self.mi, frozenset(self.stack)))

    def visit_Attribute(self, node):
        if id(node) in self._consumed:
            self.generic_visit(node)
            return
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                self._record(node.attr, True, node.lineno)
            else:
                self._record(node.attr, False, node.lineno)
        self.generic_visit(node)

    def visit_Subscript(self, node):
        # self.x[k] = v is a WRITE to x (plus the container read)
        if (isinstance(node.ctx, (ast.Store, ast.Del))
                and isinstance(node.value, ast.Attribute)
                and isinstance(node.value.value, ast.Name)
                and node.value.value.id == "self"):
            self._consumed.add(id(node.value))
            self._record(node.value.attr, True, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        t = node.target
        if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                and t.value.id == "self"):
            self._consumed.add(id(t))
            self._record(t.attr, True, t.lineno)
        self.generic_visit(node)

    def visit_Call(self, node):
        f = node.func
        target = None
        if isinstance(f, ast.Attribute):
            v = f.value
            if isinstance(v, ast.Name) and v.id == "self":
                if self.ci is not None and f.attr in self.ci.methods:
                    target = ("self", f.attr)
            elif (isinstance(v, ast.Attribute)
                    and isinstance(v.value, ast.Name)
                    and v.value.id == "self"):
                target = ("attr", v.attr, f.attr)
            elif isinstance(v, ast.Name):
                if v.id in self.types:
                    target = ("var-cls", self.types[v.id][1], f.attr)
                elif v.id in self.mi.file.imports:
                    target = ("mod", v.id, f.attr)
        elif isinstance(f, ast.Name):
            target = ("name", f.id)
        if target is not None:
            self.mi.calls.append(CallEvent(
                target, tuple(self.stack), frozenset(self.stack),
                node.lineno))
        # mutating container calls on self.attr count as reads (already
        # recorded by visit_Attribute through generic_visit)
        self.generic_visit(node)


# -- thread-entry discovery ------------------------------------------------

def _thread_calls(scope):
    for node in ast.walk(scope):
        if (isinstance(node, ast.Call)
                and _dotted(node.func).split(".")[-1] == "Thread"):
            yield node


def _thread_kwargs(call):
    target = name = None
    for kw in call.keywords:
        if kw.arg == "target":
            target = kw.value
        elif kw.arg == "name":
            name = _const_str(kw.value)
    return target, name


def _discover_entries(sf: SourceFile, program_entries: list) -> set:
    """Mark thread entries on classes in `sf`; returns ids of closure
    nodes promoted to entries (so the enclosing walk skips them).
    Targets of the form `obj.m` (obj ≠ self) are appended to
    `program_entries` for whole-program name matching."""
    promoted = set()
    for ci in sf.classes:
        for mi in list(ci.methods.values()):
            for call in _thread_calls(mi.node):
                target, name = _thread_kwargs(call)
                if target is None:
                    continue
                if (isinstance(target, ast.Attribute)
                        and isinstance(target.value, ast.Name)):
                    if target.value.id == "self":
                        ent = ci.methods.get(target.attr)
                        if ent is not None:
                            ci.thread_entries.append(
                                (ent, name or f"thread:{target.attr}"))
                    else:
                        program_entries.append(
                            (target.attr, name or f"thread:{target.attr}"))
                elif isinstance(target, ast.Name):
                    closure = next(
                        (n for n in ast.walk(mi.node)
                         if isinstance(n, ast.FunctionDef)
                         and n.name == target.id and n is not mi.node),
                        None)
                    if closure is not None:
                        cmi = MethodInfo(closure.name, closure, ci, sf,
                                         is_closure=True)
                        ci.closures.append(cmi)
                        ci.thread_entries.append(
                            (cmi, name or f"thread:{target.id}"))
                        promoted.add(id(closure))
                elif isinstance(target, ast.Lambda):
                    for sub in ast.walk(target.body):
                        if (isinstance(sub, ast.Call)
                                and isinstance(sub.func, ast.Attribute)
                                and isinstance(sub.func.value, ast.Name)
                                and sub.func.value.id == "self"):
                            ent = ci.methods.get(sub.func.attr)
                            if ent is not None:
                                ci.thread_entries.append(
                                    (ent,
                                     name or f"thread:{sub.func.attr}"))
    # module-level functions creating Thread(target=obj.m) feed the
    # whole-program entry list too (e.g. a driver spawning worker loops)
    for fn in sf.functions.values():
        for call in _thread_calls(fn.node):
            target, name = _thread_kwargs(call)
            if (target is not None and isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id != "self"):
                program_entries.append(
                    (target.attr, name or f"thread:{target.attr}"))
    return promoted


# -- thread-set / entry-lockset propagation --------------------------------

def _propagate_threads(ci: ClassInfo) -> None:
    methods = ci.methods
    for mi, label in ci.thread_entries:
        mi.threads.add(label)
    for name, mi in methods.items():
        if name == "__init__":
            continue
        if not name.startswith("_") or (name.startswith("__")
                                        and name.endswith("__")):
            mi.threads.add(EXTERNAL_THREAD)

    def spread():
        changed = True
        while changed:
            changed = False
            for mi in ci.all_methods():
                if not mi.threads:
                    continue
                for ev in mi.calls:
                    if ev.target[0] != "self":
                        continue
                    callee = methods.get(ev.target[1])
                    if callee is not None and not \
                            mi.threads <= callee.threads:
                        callee.threads |= mi.threads
                        changed = True
    spread()

    init = methods.get("__init__")
    init_reach = set()
    if init is not None:
        frontier = [init]
        while frontier:
            m = frontier.pop()
            if m.name in init_reach:
                continue
            init_reach.add(m.name)
            for ev in m.calls:
                if ev.target[0] == "self" and ev.target[1] in methods:
                    frontier.append(methods[ev.target[1]])
    for name, mi in methods.items():
        if mi.threads or name == "__init__":
            continue
        if name in init_reach:
            mi.init_only = True         # publication helpers: pre-thread
        else:
            mi.threads.add(EXTERNAL_THREAD)
    spread()
    if init is not None:
        init.init_only = True


def _propagate_entry_locks(ci: ClassInfo) -> None:
    called = set()
    for m in ci.all_methods():
        for ev in m.calls:
            if ev.target[0] == "self":
                called.add(ev.target[1])
    entry_names = {e.name for e, _ in ci.thread_entries}
    forced = set()
    for m in ci.all_methods():
        public = (not m.name.startswith("_")
                  or (m.name.startswith("__") and m.name.endswith("__")))
        if (m.is_closure or public or m.name in entry_names
                or m.name not in called):
            forced.add(m)
    # entry-context methods start lock-free; private callees inherit
    # the intersection of locks held across their call sites
    for m in ci.all_methods():
        m.entry_locks = frozenset() if m in forced else None
    for _ in range(4):
        for m in ci.all_methods():
            if m.entry_locks is None:
                continue
            for ev in m.calls:
                if ev.target[0] != "self":
                    continue
                callee = ci.methods.get(ev.target[1])
                if callee is None or callee in forced:
                    continue
                cand = frozenset(m.entry_locks | ev.locks)
                callee.entry_locks = cand if callee.entry_locks is None \
                    else callee.entry_locks & cand
    for m in ci.all_methods():
        if m.entry_locks is None:
            m.entry_locks = frozenset()


# -- build -----------------------------------------------------------------

def build(paths) -> Program:
    """Parse `paths` (files or directory roots) into a Program."""
    roots = [Path(p) for p in paths]
    seen = {}
    for root in roots:
        files = [root] if root.is_file() else sorted(root.rglob("*.py"))
        base = root.parent if root.is_file() else root.parent
        for f in files:
            if str(f) not in seen:
                seen[str(f)] = (f, base)

    program_entries: list = []
    sfs: list[SourceFile] = []
    for key, (f, base) in seen.items():
        try:
            source = f.read_text(encoding="utf-8")
            tree = ast.parse(source, filename=str(f))
        except (OSError, SyntaxError):
            continue                    # pscheck reports parse failures
        sf = SourceFile(str(f), _modname(f, base), source, tree)
        sf.imports = _collect_imports(tree, sf.modname)
        # annotations live in real comments only (never docstrings —
        # the rule catalog quotes the grammar without becoming claims)
        from .pscheck import _comment_lines
        for lineno, line in _comment_lines(source):
            m = ANNOT_RE.search(line)
            if m:
                sf.annotations[lineno] = (m.group("kind"), m.group("value"))
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                got = _lock_ctor(node.value, sf.modname,
                                 node.targets[0].id)
                if got is not None:
                    sf.module_locks[node.targets[0].id] = got[0]
            elif isinstance(node, ast.ClassDef):
                ci = ClassInfo(node.name, node, sf)
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        ci.methods[sub.name] = MethodInfo(
                            sub.name, sub, ci, sf)
                sf.classes.append(ci)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                sf.functions[node.name] = MethodInfo(
                    node.name, node, None, sf)
        for ci in sf.classes:
            _collect_class_locks(ci)
            _collect_attr_defs(ci)
        sfs.append(sf)

    by_class_name: dict = {}
    for sf in sfs:
        for ci in sf.classes:
            by_class_name.setdefault(ci.name, []).append(ci)

    promoted_all: dict = {}
    for sf in sfs:
        promoted_all[sf.path] = _discover_entries(sf, program_entries)

    # whole-program name matching: Thread(target=obj.m) marks method m
    # on every class that defines it (the roster errs toward inclusion)
    for mname, label in program_entries:
        for cands in by_class_name.values():
            for ci in cands:
                ent = ci.methods.get(mname)
                if ent is not None and all(
                        e is not ent for e, _ in ci.thread_entries):
                    ci.thread_entries.append((ent, label))

    for sf in sfs:
        skip = promoted_all[sf.path]
        for fn in sf.functions.values():
            _FnWalker(fn, skip).visit(fn.node)
        for ci in sf.classes:
            for mi in ci.all_methods():
                walker = _FnWalker(mi, skip if not mi.is_closure
                                   else set())
                if mi.is_closure:
                    walker.visit(mi.node)
                else:
                    walker.visit(mi.node)

    for sf in sfs:
        for ci in sf.classes:
            _propagate_threads(ci)
            _propagate_entry_locks(ci)

    return Program(sfs, by_class_name, program_entries)
