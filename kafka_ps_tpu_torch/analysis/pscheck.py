"""pscheck — AST static analyzer for the port's hard invariants.

The port of ``kafka_ps_tpu.analysis.pscheck``: the same rules, the same
path scoping, handler names and suppression syntax, with the device
terms of PyTorch and CUDA in place of those of JAX.  The invariants live
in prose (module docstrings) and in replay tests that only fire at
bitwise-replay time; these rules catch the regressions at commit time
instead:

  PS100  a ``# pscheck: disable=...`` suppression with no written
         justification — every suppression must carry a reason.
  PS101  a compiled program or a loaded kernel library built outside a
         module-level or keyed-cache site: ``torch.cuda.CUDAGraph()`` /
         ``torch.cuda.graph(...)`` (a capture), ``torch.compile``,
         ``torch.utils.cpp_extension.load*``, ``ctypes.CDLL``,
         ``_build.load`` / ``_build.build`` (nvcc), and the reference's
         ``jit`` / ``pallas_call``.  A class whose ``__init__`` builds
         one is a builder too: its construction is held to the same
         sites, and what its ``__init__`` builds is charged there
         (``parallel/bsp.py``'s ``self._graphs[key] = _Graph(...)`` is
         the keyed-cache form).
  PS102  host-sync calls (``.item()``, ``.cpu()``, ``.tolist()``,
         ``.numpy()``, ``float()``, ``int()``, ``np.asarray``,
         ``np.array``, ``torch.cuda.synchronize()``, ``.synchronize()``
         on a stream or event, the reference's
         ``.block_until_ready()``) inside per-message handlers in
         ``runtime/``, ``serving/`` and ``agg/`` — the hot path's
         no-host-sync property (runtime/worker.py docstring); the
         aggregation tier's combine/forward paths run once per member
         per clock, so a sync there multiplies by fan-in.
  PS103  re-encoding in ``serde.py`` / ``net.py`` (any ``.encode(...)``
         on a non-literal receiver): messages carry verbatim
         ``encoded`` parts; int8 quantization is not idempotent.
  PS104  nondeterminism in replay-critical modules (``log/``,
         ``compress/``, ``store/``, ``agg/``, ``runtime/serde.py``,
         ``runtime/sharding.py``, ``runtime/wire.py``,
         ``parallel/range_sharded.py``): wall clocks, ``random``,
         ``np.random``, ``uuid``/``urandom``, iteration over a bare
         ``set(...)`` (hash order), torch's global RNG (``torch.rand*``,
         ``randperm``, ``multinomial``, ``bernoulli``, ``normal``,
         ``.uniform_()`` / ``.normal_()`` and the other in-place draws
         without an explicit ``generator=``, and ``torch.seed()``), and
         the accumulating scatters ``index_add(_)``, ``scatter_add(_)``,
         ``scatter_reduce(_)`` and ``index_put(_)(..., accumulate=True)``:
         on CUDA these sum through atomics, so the bits depend on the
         order the adds arrive in — replay must be bitwise.  The
         sharding modules are replay-critical because per-shard
         durable-log recovery is bitwise only if routing and assembly
         order depend on (shard, worker, clock) alone; the tiered store
         because its promotion/demotion plan must be a pure function of
         heat counters.  The derived observability modules
         (``telemetry/critpath.py``, ``profiler.py``, ``slo.py``,
         ``modelhealth.py``, ``drift.py``) are held to the same rule:
         their verdicts must be pure functions of recorded timestamps,
         registry snapshots and observation counts, never of a wall
         clock read at analysis time — the drift detectors in
         particular must emit the identical warn/trip sequence on a
         bitwise replay, which is what makes them a usable rollback
         trigger.  The profiler's display-only wall anchor is the one
         reasoned suppression.
  PS105  blocking I/O (socket send/recv/``sendmsg``, frame send/recv,
         the wire engine's ``sendmsg_all``, ``fsync``, ``time.sleep``)
         while holding a lock.  ``runtime/wire.py``'s FrameWriter is
         the rule made structural: producers hold the queue lock only
         for the append, and the writer thread pops a batch under the
         lock but ships it outside (``_pop_batch`` / ``_drain``).
  PS106  the host syncs of PS102 inside the ARGUMENTS of a
         telemetry/trace call (``span``, ``count``, ``observe``,
         ``inc``, ``flow_*``) or a flight-recorder call (``record``,
         telemetry/flight.py) in ``runtime/``, ``ops/``, ``serving/``,
         ``agg/``, ``evaluation/engine.py`` or the derived observability
         modules — instrumentation must observe host scalars only; a
         metric that syncs the device perturbs the very latency it
         measures and breaks the telemetry-off/on bitwise contract.

Suppression syntax, on the finding line or the line directly above::

    x = time.time()  # pscheck: disable=PS104 (wall clock is display-only)

Suppressed findings are still collected, counted and reported — the
CLI (``python -m kafka_ps_tpu_torch.analysis``) fails only on
unsuppressed ones (and on PS100, which cannot be suppressed).

Stdlib-only on purpose: importing this module (or running the CLI)
must not pull in torch.
"""

from __future__ import annotations

import ast
import json
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["RULES", "Finding", "Report", "analyze_source", "analyze_path",
           "scan_source", "apply_suppressions", "main"]

RULES: dict[str, str] = {
    "PS100": "suppression without a written justification",
    "PS101": "CUDA graph capture, torch.compile, a kernel library load "
             "or build (cpp_extension, ctypes.CDLL, _build) or jit/"
             "pallas_call constructed outside a module-level or "
             "keyed-cache site (per-message rebuild)",
    "PS102": "host-sync call (.item/.cpu/.tolist/.numpy, float/int, "
             "np.asarray/np.array, synchronize) inside a per-message "
             "handler in runtime/, serving/ or agg/",
    "PS103": "re-encoding in serde.py/net.py of messages that carry "
             "verbatim encoded parts",
    "PS104": "nondeterminism in a replay-critical module "
             "(log/, compress/, store/, agg/, runtime/serde.py, the "
             "derived observability modules in telemetry/): clocks, "
             "untracked RNG, hash order, atomic-order scatters",
    "PS105": "blocking I/O while holding a lock",
    "PS106": "host-sync call inside the arguments of a telemetry/trace "
             "or flight-recorder call in runtime/, ops/, serving/, "
             "agg/ or the derived observability modules in telemetry/",
}

# -- rule scoping ----------------------------------------------------------

# PS102: handler/dispatch methods that run per message or per batch on
# the hot path.  Curated rather than inferred: the repo's handlers are
# a closed set and name-based scoping keeps the rule reviewable.
HANDLER_NAMES = frozenset({
    "on_weights", "process", "process_batch", "offer", "drain_serial",
    "dispatch_release_set", "_flush_gate", "_dispatch_group",
    "_prepare", "_finish", "_redelivered_weights",
    "submit", "_dispatch", "_serve",
    "_send", "_send_raw", "_send_weights_prepared", "send_weights",
    "_weights_message", "_reader", "run_reader", "publish_snapshot",
    # serving/loadgen.py: the per-request driver path — a host sync
    # here is charged to every request the generator issues, skewing
    # the very latency the harness measures
    "_issue", "_drive", "settle", "make_issue",
    # serving/shm.py + net.ServerBridge._shm_serve: the shared-memory
    # RPC hot path — per-request on both sides of the channel
    "rpc", "serve_once", "respond", "_shm_serve",
    # serving/costmodel.py: fed from inside _dispatch/_serve — a sync
    # here would bill the cost model's own bookkeeping to the request
    "observe_dispatch", "observe_arrival", "window_s",
    # agg/: the aggregation tier's per-delta and per-frame paths — a
    # host sync here is charged once per member per clock, defeating
    # the fan-in reduction the tier exists for (docs/AGGREGATION.md)
    "combine", "_encode", "flush",
    "_on_upstream_frame", "_forward_rows", "_forward_weights",
    "_expand_group",
    # runtime/wire.py: the coalescing writer's pop/flush loop and the
    # buffered reader's parse loop — once per flush batch / per frame;
    # a host sync here stalls every connection sharing the writer
    "_drain", "_pop_batch", "recv_frame", "_fill",
})

# PS102 host-sync markers: argument-less methods that copy a tensor to
# the host or wait for the device (``.synchronize()`` on the
# torch.cuda module, a stream or an event; the reference's
# ``.block_until_ready()``), the scalar coercions, and numpy's copies
_NP_NAMES = frozenset({"np", "numpy"})
_SYNC_ATTRS = frozenset({"item", "cpu", "tolist", "numpy", "synchronize",
                         "block_until_ready"})
_SYNC_BUILTINS = frozenset({"float", "int"})
# int(...) of a value built only from these is a host scalar: the wall
# clock a CSV timestamp column reads, a length
_HOST_ROOTS = frozenset({"time", "len"})
_NP_SYNC_ATTRS = frozenset({"asarray", "array"})

# PS106: attribute-call names that record telemetry (utils/trace.Tracer
# + telemetry/registry metric children + the flight recorder's
# FLIGHT.record, telemetry/flight.py — its event fields must be host
# ints that the hot path already owns).  `.set` is deliberately absent
# — it collides with jax's `.at[...].set(...)`; gauge .set sites are
# covered by the generic PS102 handler scoping instead.
_TELEMETRY_ATTRS = frozenset({
    "span", "count", "observe", "inc",
    "flow", "flow_start", "flow_step", "flow_end",
    "record",
})

# PS104 banned call roots
_TIME_BANNED = frozenset({"time", "time_ns"})          # time.time(_ns)
_DATETIME_BANNED = frozenset({"now", "utcnow", "today"})
_OS_BANNED = frozenset({"urandom"})
# torch draws that read the global generator unless given generator=
_TORCH_RNG = frozenset({
    "rand", "randn", "randint", "rand_like", "randn_like",
    "randint_like", "randperm", "multinomial", "bernoulli", "normal",
    "poisson",
})
_TORCH_RNG_INPLACE = frozenset({
    "uniform_", "normal_", "bernoulli_", "random_", "exponential_",
    "geometric_", "log_normal_", "cauchy_",
})
# accumulating scatters: CUDA sums them with atomics, in arrival order
_ATOMIC_SCATTERS = frozenset({
    "index_add", "index_add_", "scatter_add", "scatter_add_",
    "scatter_reduce", "scatter_reduce_",
})
_ACCUMULATE_PUTS = frozenset({"index_put", "index_put_"})

# PS105 blocking markers
_BLOCKING_ATTRS = frozenset({
    "sendall", "recv", "recv_into", "accept", "connect", "sendto",
    "recvfrom", "sendmsg", "fsync", "sleep",
})
_BLOCKING_NAMES = frozenset({
    "send_frame", "recv_frame", "create_connection", "fsync",
    "sendmsg_all",
})
_LOCKISH = re.compile(r"lock|mutex|cond|cv|(?:^|[._])mu$", re.IGNORECASE)

# PS101: the reference's program builders, by leaf name
_JIT_ROOTS = frozenset({"jit", "pallas_call"})
# PS101: the port's builders, by dotted suffix (a leaf alone is too
# common: ``re.compile``, ``np.load``)
_BUILDER_SUFFIXES = (
    "cuda.CUDAGraph", "cuda.graph", "torch.compile", "ctypes.CDLL",
    "_build.load", "_build.build",
)
_CPP_EXTENSION_LOADS = frozenset({"load", "load_inline"})

SUPPRESS_RE = re.compile(
    r"#\s*pscheck:\s*disable=\s*(?P<codes>PS\d{3}(?:\s*,\s*PS\d{3})*)"
    r"(?:\s*\((?P<reason>[^)]*)\))?")


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    message: str
    suppressed: bool = False
    reason: str | None = None

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "suppressed": self.suppressed,
                "reason": self.reason}

    def render(self) -> str:
        s = f"{self.path}:{self.line}: {self.rule} {self.message}"
        if self.suppressed:
            s += f"  [suppressed: {self.reason}]"
        return s


@dataclass
class Report:
    findings: list[Finding] = field(default_factory=list)
    files: int = 0

    @property
    def suppressed(self) -> list[Finding]:
        return [f for f in self.findings if f.suppressed]

    @property
    def unsuppressed(self) -> list[Finding]:
        return [f for f in self.findings if not f.suppressed]

    def extend(self, other: "Report") -> None:
        self.findings.extend(other.findings)
        self.files += other.files

    def by_rule(self) -> dict:
        """Per-rule counts — the suppression inventory, diffable in CI."""
        out: dict = {}
        for f in self.findings:
            row = out.setdefault(
                f.rule, {"total": 0, "suppressed": 0, "unsuppressed": 0})
            row["total"] += 1
            row["suppressed" if f.suppressed else "unsuppressed"] += 1
        return dict(sorted(out.items()))

    def to_json(self) -> dict:
        return {
            "files": self.files,
            "counts": {"total": len(self.findings),
                       "suppressed": len(self.suppressed),
                       "unsuppressed": len(self.unsuppressed)},
            "by_rule": self.by_rule(),
            "findings": [f.to_json() for f in self.findings],
        }


# -- suppression parsing ---------------------------------------------------

def _comment_lines(source: str):
    """(lineno, comment_text) for every real COMMENT token — a
    suppression spelled inside a string/docstring (e.g. the syntax
    example in this very module) is documentation, not a directive.
    Falls back to raw lines when the file doesn't tokenize."""
    import io
    import tokenize
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                yield tok.start[0], tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        yield from enumerate(source.splitlines(), start=1)


def _parse_suppressions(source: str, path: str):
    """-> ({line: {code: reason|None}}, [PS100 findings])"""
    table: dict[int, dict[str, str | None]] = {}
    ps100: list[Finding] = []
    for lineno, line in _comment_lines(source):
        m = SUPPRESS_RE.search(line)
        if not m:
            continue
        reason = m.group("reason")
        reason = reason.strip() if reason else None
        codes = [c.strip() for c in m.group("codes").split(",")]
        if reason is None:
            ps100.append(Finding(
                "PS100", path, lineno,
                f"suppression of {','.join(codes)} carries no reason — "
                "write one: # pscheck: disable=CODE (why)"))
        table[lineno] = {c: reason for c in codes}
    return table, ps100


# -- the visitor -----------------------------------------------------------

@dataclass
class _FnCtx:
    node: object
    cached: bool          # under functools.lru_cache/cache
    jitted: bool          # under jit/torch.compile (tracing context)
    returned: frozenset   # names returned by this function
    stored: frozenset = frozenset()   # names that flow into a cache store
    builds: bool = False  # __init__ of a builder class


def _dotted(node) -> str:
    """'a.b.c' for Name/Attribute chains, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _returned_names(fn) -> frozenset:
    """Names/attribute-roots this function returns, not descending into
    nested defs (their returns are theirs)."""
    out = set()
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Return) and node.value is not None:
            v = node.value
            if isinstance(v, ast.Name):
                out.add(v.id)
            elif isinstance(v, ast.Tuple):
                out.update(e.id for e in v.elts if isinstance(e, ast.Name))
        stack.extend(ast.iter_child_nodes(node))
    return frozenset(out)


def _stored_names(fn) -> frozenset:
    """Local names whose value reaches a cache store in this function —
    a keyed slot (``cache[key] = v``), an instance attribute
    (``self.x = v``) or a ``global`` — directly or through the names
    assigned from them (``fn = getattr(lib, sym); _fns[sym] = fn``)."""
    globs = {n for node in ast.walk(fn) if isinstance(node, ast.Global)
             for n in node.names}
    assigns = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            assigns.append((node.targets, node.value))
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            assigns.append(([node.target], node.value))

    def names_in(expr):
        return {n.id for n in ast.walk(expr) if isinstance(n, ast.Name)}

    out: set = set()
    for targets, value in assigns:
        if any(isinstance(t, ast.Subscript)
               or (isinstance(t, ast.Attribute)
                   and isinstance(t.value, ast.Name)
                   and t.value.id == "self")
               or (isinstance(t, ast.Name) and t.id in globs)
               for t in targets):
            out |= names_in(value)
    changed = True
    while changed:
        changed = False
        for targets, value in assigns:
            if any(isinstance(t, ast.Name) and t.id in out
                   for t in targets):
                new = names_in(value) - out
                if new:
                    out |= new
                    changed = True
    return frozenset(out)


def _is_builder_dotted(d: str) -> bool:
    """The port's program builders and kernel-library loads."""
    if not d:
        return False
    parts = d.split(".")
    if parts[-1] in _CPP_EXTENSION_LOADS and "cpp_extension" in parts:
        return True
    return any(d == s or d.endswith("." + s) for s in _BUILDER_SUFFIXES)


def _is_builder_call(call: ast.Call) -> bool:
    d = _dotted(call.func)
    return d.split(".")[-1] in _JIT_ROOTS or _is_builder_dotted(d)


def _host_evident(node) -> bool:
    """True when `node` is built only from constants, clock reads
    (``time.*``) and ``len`` — a host scalar by construction."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.BinOp):
        return _host_evident(node.left) and _host_evident(node.right)
    if isinstance(node, ast.UnaryOp):
        return _host_evident(node.operand)
    if isinstance(node, ast.Call):
        return _dotted(node.func).split(".")[0] in _HOST_ROOTS
    return False


def _host_sync_builtin(call: ast.Call) -> bool:
    """float(...) as in the reference's rule; int(...) unless its
    argument is a host scalar by construction."""
    if not (isinstance(call.func, ast.Name)
            and call.func.id in _SYNC_BUILTINS):
        return False
    return not (call.func.id == "int" and len(call.args) == 1
                and _host_evident(call.args[0]))


def _is_cache_decorator(dec) -> bool:
    d = _dotted(dec.func if isinstance(dec, ast.Call) else dec)
    return d.split(".")[-1] in {"lru_cache", "cache", "cached_property"}


def _is_jit_dotted(d: str) -> bool:
    return d.split(".")[-1] in _JIT_ROOTS or d == "torch.compile"


def _is_jit_decorator(dec) -> bool:
    if isinstance(dec, ast.Call):
        d = _dotted(dec.func)
        if d.split(".")[-1] == "partial" and dec.args:
            # functools.partial(jax.jit, ...) used as a decorator
            return _is_jit_dotted(_dotted(dec.args[0]))
        return _is_jit_dotted(d)
    return _is_jit_dotted(_dotted(dec))


class _Checker(ast.NodeVisitor):
    def __init__(self, path: str, rules_in_scope: set):
        self.path = path
        self.scope = rules_in_scope
        self.findings: list[Finding] = []
        self._fns: list[_FnCtx] = []
        self._locks: list[str] = []      # with-blocks holding lockish CMs
        self._jit_ok: set = set()        # id() of pre-approved jit Calls
        self._builder_classes: set = set()
        self._classes: list[str] = []

    def emit(self, rule: str, line: int, msg: str) -> None:
        if rule in self.scope:
            self.findings.append(Finding(rule, self.path, line, msg))

    # -- function context --------------------------------------------------

    def visit_Module(self, node):
        # classes whose __init__ builds a program: constructing one is a
        # build (PS101), charged to the construction site
        for cls in node.body:
            if not isinstance(cls, ast.ClassDef):
                continue
            for sub in cls.body:
                if (isinstance(sub, ast.FunctionDef)
                        and sub.name == "__init__"
                        and any(isinstance(n, ast.Call)
                                and _is_builder_call(n)
                                for n in ast.walk(sub))):
                    self._builder_classes.add(cls.name)
        self.generic_visit(node)

    def visit_ClassDef(self, node):
        self._classes.append(node.name)
        self.generic_visit(node)
        self._classes.pop()

    def visit_FunctionDef(self, node):
        self._function(node)

    def visit_AsyncFunctionDef(self, node):
        self._function(node)

    def _function(self, node):
        cached = any(_is_cache_decorator(d) for d in node.decorator_list)
        jitted = any(_is_jit_decorator(d) for d in node.decorator_list)
        if jitted and "PS101" in self.scope and self._fns:
            ctx = self._fns[-1]
            if not (ctx.cached or ctx.jitted
                    or node.name in ctx.returned
                    or any(f.cached or f.jitted for f in self._fns)):
                self.emit(
                    "PS101", node.lineno,
                    f"@jit on {node.name!r} is rebuilt on every call of "
                    f"{getattr(ctx.node, 'name', '?')!r} — hoist to module "
                    "level or key it in a cache")
        self._fns.append(_FnCtx(node, cached, jitted,
                                _returned_names(node), _stored_names(node),
                                node.name == "__init__"
                                and bool(self._classes)
                                and self._classes[-1]
                                in self._builder_classes))
        self.generic_visit(node)
        self._fns.pop()

    # -- PS101 assignment/return exemptions --------------------------------

    def _approve_jit_value(self, value, targets):
        if not (isinstance(value, ast.Call) and self._is_jit_call(value)):
            return
        for t in targets:
            if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                # instance-attribute cache site (built once per object)
                self._jit_ok.add(id(value))
                return
            if isinstance(t, ast.Subscript):
                # keyed-cache site: cache[key] = build(...)
                self._jit_ok.add(id(value))
                return
            if (isinstance(t, ast.Name) and self._fns
                    and (t.id in self._fns[-1].returned
                         or t.id in self._fns[-1].stored)):
                # factory idiom: the program is returned and the caller
                # owns caching (e.g. app._fused_programs), or this
                # function stores it in a keyed cache itself
                self._jit_ok.add(id(value))
                return

    def visit_Assign(self, node):
        self._approve_jit_value(node.value, node.targets)
        self.generic_visit(node)

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self._approve_jit_value(node.value, [node.target])
        self.generic_visit(node)

    def visit_Return(self, node):
        if (node.value is not None and isinstance(node.value, ast.Call)
                and self._is_jit_call(node.value)):
            self._jit_ok.add(id(node.value))
        elif isinstance(node.value, ast.Tuple):
            for e in node.value.elts:
                if isinstance(e, ast.Call) and self._is_jit_call(e):
                    self._jit_ok.add(id(e))
        self.generic_visit(node)

    # -- with-block lock tracking (PS105) ----------------------------------

    def visit_With(self, node):
        pushed = 0
        for item in node.items:
            try:
                text = ast.unparse(item.context_expr)
            except Exception:  # noqa: BLE001 - defensive, unparse is total
                text = ""
            root = text.split("(")[0]
            if _LOCKISH.search(root):
                self._locks.append(root)
                pushed += 1
        self.generic_visit(node)
        for _ in range(pushed):
            self._locks.pop()

    visit_AsyncWith = visit_With

    # -- PS104 set-iteration -----------------------------------------------

    def _iter_target(self, node):
        if "PS104" not in self.scope:
            return
        it = node.iter if isinstance(node, (ast.For, ast.AsyncFor)) else node
        if isinstance(it, ast.Call):
            root = _dotted(it.func)
            if root in ("set", "frozenset"):
                self.emit(
                    "PS104", it.lineno,
                    "iteration over a bare set() is hash-ordered — wrap "
                    "in sorted(...) for a replay-stable order")
            elif it.args:
                # sorted(set(...)) and friends are fine; bare set in
                # args of non-ordering wrappers is not checked (len(),
                # etc. are order-insensitive)
                pass
        elif isinstance(it, ast.Set):
            self.emit(
                "PS104", it.lineno,
                "iteration over a set literal is hash-ordered — use a "
                "tuple/list or sorted(...)")

    def visit_For(self, node):
        self._iter_target(node)
        self.generic_visit(node)

    visit_AsyncFor = visit_For

    def visit_comprehension(self, node):
        self._iter_target(node.iter)
        self.generic_visit(node)

    # -- calls: PS101/PS102/PS103/PS104/PS105 ------------------------------

    @staticmethod
    def _untracked_torch_draw(node, dotted: str, leaf: str) -> bool:
        """A draw from torch's global generator: ``torch.<rng>(...)`` or
        an in-place ``t.<rng>_(...)`` with no ``generator=``."""
        if any(kw.arg == "generator" for kw in node.keywords):
            return False
        if leaf in _TORCH_RNG and dotted.split(".")[0] == "torch":
            return True
        return (leaf in _TORCH_RNG_INPLACE
                and isinstance(node.func, ast.Attribute)
                and dotted.split(".")[0] not in ("torch", "np", "numpy",
                                                 "random"))

    def _is_jit_call(self, call: ast.Call) -> bool:
        """A program build: a builder call, or the construction of a
        class of this module whose __init__ builds one."""
        if _is_builder_call(call):
            return True
        return (isinstance(call.func, ast.Name)
                and call.func.id in self._builder_classes)

    def visit_Call(self, node):
        dotted = _dotted(node.func)
        leaf = dotted.split(".")[-1]

        # PS101 — a program or library built in a non-cache context
        if (self._fns and self._is_jit_call(node)
                and id(node) not in self._jit_ok
                and not any(f.cached or f.jitted or f.builds
                            for f in self._fns)):
            self.emit(
                "PS101", node.lineno,
                f"{dotted or leaf}(...) built inside "
                f"{getattr(self._fns[-1].node, 'name', '?')!r} is rebuilt "
                "per call — hoist to module level, key it in a cache, or "
                "return it from a factory the caller caches")

        # PS102 — host sync inside a per-message handler
        if self._fns and any(f.node.name in HANDLER_NAMES
                             for f in self._fns
                             if isinstance(f.node, (ast.FunctionDef,
                                                    ast.AsyncFunctionDef))):
            handler = next(f.node.name for f in reversed(self._fns)
                           if f.node.name in HANDLER_NAMES)
            if isinstance(node.func, ast.Attribute):
                if (node.func.attr in _SYNC_ATTRS
                        and not node.args):
                    self.emit(
                        "PS102", node.lineno,
                        f".{node.func.attr}() host-syncs inside handler "
                        f"{handler!r} — keep values device-resident or "
                        "defer via asynclog futures")
                elif (node.func.attr in _NP_SYNC_ATTRS
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id in _NP_NAMES):
                    self.emit(
                        "PS102", node.lineno,
                        f"{dotted}(...) forces D2H inside handler "
                        f"{handler!r} — keep the hot path device-resident")
            elif _host_sync_builtin(node):
                self.emit(
                    "PS102", node.lineno,
                    f"{node.func.id}(...) host-syncs inside handler "
                    f"{handler!r} — defer via asynclog futures")

        # PS106 — host sync inside telemetry-call arguments: the metric/
        # span/flow machinery must be handed host scalars, never device
        # values it would have to fetch
        if ("PS106" in self.scope
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _TELEMETRY_ATTRS):
            for arg in [*node.args, *(kw.value for kw in node.keywords)]:
                for sub in ast.walk(arg):
                    if not isinstance(sub, ast.Call):
                        continue
                    sync = None
                    if _host_sync_builtin(sub):
                        sync = f"{sub.func.id}(...)"
                    elif isinstance(sub.func, ast.Attribute):
                        if sub.func.attr in _SYNC_ATTRS and not sub.args:
                            sync = f".{sub.func.attr}()"
                        elif (sub.func.attr in _NP_SYNC_ATTRS
                                and isinstance(sub.func.value, ast.Name)
                                and sub.func.value.id in _NP_NAMES):
                            sync = f"{_dotted(sub.func)}(...)"
                    if sync is not None:
                        self.emit(
                            "PS106", sub.lineno,
                            f"{sync} host-syncs inside the arguments of "
                            f".{node.func.attr}(...) — record host "
                            "scalars (perf_counter deltas, ints, "
                            ".nbytes); a syncing metric perturbs what "
                            "it measures")

        # PS103 — re-encoding on the wire path
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr == "encode"
                and not isinstance(node.func.value, ast.Constant)):
            self.emit(
                "PS103", node.lineno,
                f"{dotted or '<expr>.encode'}(...) re-encodes on the wire "
                "path — messages carry verbatim encoded parts (int8 "
                "quantization is not idempotent); pass enc.parts through")

        # PS104 — nondeterminism sources
        if "PS104" in self.scope:
            root = dotted.split(".")[0]
            if root == "time" and leaf in _TIME_BANNED:
                self.emit(
                    "PS104", node.lineno,
                    f"{dotted}() reads the wall clock in a replay-critical "
                    "module — replayed runs must be bitwise-identical "
                    "(time.monotonic for pacing is fine)")
            elif root == "datetime" and leaf in _DATETIME_BANNED:
                self.emit("PS104", node.lineno,
                          f"{dotted}() is wall-clock nondeterminism in a "
                          "replay-critical module")
            elif root == "random" or dotted.startswith("np.random.") \
                    or dotted.startswith("numpy.random."):
                self.emit("PS104", node.lineno,
                          f"{dotted}() draws untracked randomness in a "
                          "replay-critical module — thread an explicit "
                          "seed/key through instead")
            elif root == "os" and leaf in _OS_BANNED:
                self.emit("PS104", node.lineno,
                          f"{dotted}() is nondeterministic in a "
                          "replay-critical module")
            elif root == "uuid":
                self.emit("PS104", node.lineno,
                          f"{dotted}() is nondeterministic in a "
                          "replay-critical module")
            elif dotted == "torch.seed" or dotted.endswith(".torch.seed"):
                self.emit("PS104", node.lineno,
                          f"{dotted}() reseeds torch's global generator "
                          "from entropy in a replay-critical module")
            elif self._untracked_torch_draw(node, dotted, leaf):
                self.emit("PS104", node.lineno,
                          f"{dotted or leaf}(...) draws from torch's global "
                          "generator in a replay-critical module — pass "
                          "generator= seeded from the run's seed")
            elif leaf in _ATOMIC_SCATTERS or (
                    leaf in _ACCUMULATE_PUTS and any(
                        kw.arg == "accumulate"
                        and not (isinstance(kw.value, ast.Constant)
                                 and kw.value.value is False)
                        for kw in node.keywords)):
                self.emit("PS104", node.lineno,
                          f"{dotted or leaf}(...) accumulates through "
                          "atomics on CUDA, so its bits depend on the "
                          "order the adds arrive in — sort the indices "
                          "and reduce segments, or add in a fixed order")

        # PS105 — blocking I/O under a lock
        if self._locks:
            blocking = None
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _BLOCKING_ATTRS:
                # obj.wait()/cv.wait_for() release their own lock and
                # are excluded by the marker sets; time.sleep and
                # socket verbs are not
                blocking = dotted or f"<expr>.{node.func.attr}"
            elif isinstance(node.func, ast.Name) \
                    and node.func.id in _BLOCKING_NAMES:
                blocking = node.func.id
            if blocking is not None:
                self.emit(
                    "PS105", node.lineno,
                    f"{blocking}(...) blocks while holding "
                    f"{self._locks[-1]!r} — move the I/O outside the "
                    "critical section")

        self.generic_visit(node)


# -- per-file driver -------------------------------------------------------

def _rules_for(path: Path) -> set:
    parts = set(path.parts)
    rules = {"PS100", "PS101", "PS105"}
    if "runtime" in parts or "serving" in parts or "agg" in parts:
        rules.add("PS102")
    if ("runtime" in parts or "ops" in parts or "serving" in parts
            or "agg" in parts):
        rules.add("PS106")
    if path.name in ("serde.py", "net.py"):
        rules.add("PS103")
    if ("log" in parts or "compress" in parts or "store" in parts
            or "agg" in parts
            or (path.name == "serde.py" and "runtime" in parts)
            or (path.name == "sharding.py" and "runtime" in parts)
            or (path.name == "wire.py" and "runtime" in parts)
            or (path.name == "range_sharded.py" and "parallel" in parts)):
        # agg/ is replay-critical end to end: combine order, the EF
        # clock horizon and checkpoint restore must be pure functions
        # of (worker, clock) for the N=1 bitwise pin to hold
        # (docs/AGGREGATION.md)
        rules.add("PS104")
    if "evaluation" in parts and path.name == "engine.py":
        # the async eval engine: submit/_dispatch run on the server's
        # apply path and the engine thread respectively — a host sync
        # there re-serializes the eval the engine exists to unfuse
        # (PS102); its emission order must be a pure function of the
        # submitted (theta, clock) sequence for the bitwise CSV
        # contract, so no ambient clocks or entropy (PS104); and its
        # metric calls must pass host ints only (PS106)
        rules.add("PS102")
        rules.add("PS104")
        rules.add("PS106")
    if "telemetry" in parts and path.name in ("critpath.py",
                                              "profiler.py", "slo.py",
                                              "modelhealth.py",
                                              "drift.py"):
        # derived observability: analysis verdicts must be pure
        # functions of recorded data (PS104 — the drift detectors are
        # replay-adjacent: same inputs, same trip sequence), and
        # nothing on these paths may host-sync inside an
        # instrumentation call (PS106)
        rules.add("PS104")
        rules.add("PS106")
    return rules


def scan_source(source: str, path: str):
    """Raw per-file scan for the psverify driver: rule findings with
    suppression NOT yet applied, plus the suppression table.

    -> (findings, table, ps100_findings); on a parse failure the
    findings list holds the single synthetic PS100 and table is {}.
    """
    table, ps100 = _parse_suppressions(source, path)
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return ([Finding("PS100", path, e.lineno or 0,
                         f"file does not parse: {e.msg}")], {}, ps100)
    checker = _Checker(path, _rules_for(Path(path)))
    checker.visit(tree)
    return (checker.findings, table, ps100)


def apply_suppressions(findings, table) -> set:
    """Mark findings suppressed from `table` ({line: {code: reason}});
    returns the set of (line, code) table entries that matched — the
    complement is what PS107 (useless suppression) reports on."""
    used: set = set()
    for f in findings:
        for line in (f.line, f.line - 1):
            entry = table.get(line)
            if entry and f.rule in entry:
                f.suppressed = True
                f.reason = entry[f.rule]
                used.add((line, f.rule))
                break
    return used


def analyze_source(source: str, path: str) -> Report:
    rep = Report(files=1)
    findings, table, ps100 = scan_source(source, path)
    rep.findings.extend(ps100)
    apply_suppressions(findings, table)
    rep.findings.extend(findings)
    rep.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return rep


def analyze_path(target: str | Path) -> Report:
    target = Path(target)
    files = ([target] if target.is_file()
             else sorted(target.rglob("*.py")))
    rep = Report()
    for f in files:
        rep.extend(analyze_source(f.read_text(encoding="utf-8"), str(f)))
    return rep


# -- CLI -------------------------------------------------------------------

def main(argv: list[str] | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m kafka_ps_tpu_torch.analysis",
        description="pscheck: project-invariant static analyzer "
                    "(rules PS100-PS106)")
    ap.add_argument("paths", nargs="*", default=["kafka_ps_tpu_torch"],
                    help="files or directories to analyze "
                         "(default: kafka_ps_tpu_torch)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable report on stdout")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for code, desc in sorted(RULES.items()):
            print(f"{code}  {desc}")
        return 0

    rep = Report()
    for p in (args.paths or ["kafka_ps_tpu_torch"]):
        rep.extend(analyze_path(p))

    if args.as_json:
        print(json.dumps(rep.to_json(), indent=2))
    else:
        for f in rep.findings:
            print(f.render())
        print(f"pscheck: {rep.files} files, {len(rep.findings)} findings "
              f"({len(rep.suppressed)} suppressed, "
              f"{len(rep.unsuppressed)} unsuppressed)")
    return 1 if rep.unsuppressed else 0


if __name__ == "__main__":
    sys.exit(main())
