"""wireck — wire-schema cross-check (PS204).

Every byte that crosses the wire is written by one ``struct.pack`` /
``pack_into`` / dtype'd array dump and read back by a matching
``unpack`` / ``unpack_from`` / ``np.frombuffer``.  The two sides live
in different files (serde encodes, net/wire decode; agg/relay re-packs
in place) and nothing but convention keeps them agreeing on field
count, byte width and endianness.  This pass extracts both sides from
the wire modules (``runtime/serde.py``, ``runtime/net.py``,
``runtime/wire.py``, ``agg/``) and reports (PS204):

- a pack format no decode side can read: not an exact match, not a
  contiguous slice of a decoder's format, and not decomposable into a
  concatenation of decoder formats (the split-read idiom —
  ``_FRAME`` packs ``<IBq`` whole, the receive buffer reads ``<I``
  then ``<Bq``);
- symmetrically, an unpack format no encoder produces;
- a format string with native endianness (no ``<``/``>``/``=``/``!``
  prefix) — the wire is little-endian by contract, native byte order
  is a portability bug;
- an ``np.frombuffer`` dtype no encoder in the wire group ever
  constructs (decode of bytes nobody writes);
- a serde type-id registry entry (``_TYPE_IDS``) whose name is
  mentioned by only one of ``to_bytes``/``from_bytes`` — a message
  kind that can be encoded but never decoded, or vice versa.

Named ``struct.Struct`` module constants are resolved through
imports (``net._AGG_MEMBER.unpack_from`` in agg/relay.py credits the
unpack side of net.py's constant), so a constant used on both sides
is exact-match covered by construction.  F-string formats
(``f"<q{len(ids)}q"``) normalize their interpolations to a
variable-repeat token that only matches another variable repeat of
the same type code.
"""

from __future__ import annotations

import ast

from .pscheck import Finding
from .program import Program, _dotted

__all__ = ["RULES", "check"]

RULES = {
    "PS204": "wire-schema mismatch: pack/unpack format, frombuffer "
             "dtype, or serde type-id with no agreeing opposite side "
             "(field count / byte width / endianness)",
}

_PACK_ATTRS = frozenset({"pack", "pack_into"})
_UNPACK_ATTRS = frozenset({"unpack", "unpack_from", "iter_unpack"})
_ENDIAN = "<>=!@"
_EXPAND_CAP = 32

_NP_ENCODE_CTORS = frozenset({
    "empty", "zeros", "ones", "asarray", "array", "ascontiguousarray",
    "fromiter", "full",
})

_DTYPE_BASE = {
    "float32": "f4", "float64": "f8", "float16": "f2",
    "int64": "q", "int32": "i4", "int16": "i2", "int8": "i1",
    "uint64": "Q", "uint32": "u4", "uint16": "u2", "uint8": "u1",
}


def _in_group(sf) -> bool:
    from pathlib import Path
    parts = set(Path(sf.path).parts)
    if "agg" in parts:
        return True
    name = Path(sf.path).name
    return (name in ("serde.py", "net.py", "wire.py")
            and "compress" not in parts)


# -- format-string tokenization --------------------------------------------

def _tokenize(fmt: str):
    """'<qI4s' -> ('q','I',('s',4)); returns (endian, tokens) or None."""
    endian = fmt[0] if fmt and fmt[0] in _ENDIAN else None
    body = fmt[1:] if endian else fmt
    toks: list = []
    num = ""
    for ch in body:
        if ch.isdigit():
            num += ch
            continue
        if ch == " ":
            num = ""
            continue
        n = int(num) if num else 1
        num = ""
        if ch in "sx":
            toks.append((ch, n))
        elif n > _EXPAND_CAP:
            toks.append(("*", ch))
        else:
            toks.extend([ch] * n)
    return endian, tuple(toks)


def _tokenize_expr(node):
    """Format expression -> (endian, tokens) for Constant str or
    JoinedStr with {var} repeat counts; None if not statically known."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return _tokenize(node.value)
    if not isinstance(node, ast.JoinedStr):
        return None
    endian = None
    toks: list = []
    pending_var = False
    first = True
    for part in node.values:
        if isinstance(part, ast.Constant):
            text = str(part.value)
            if first and text and text[0] in _ENDIAN:
                endian = text[0]
                text = text[1:]
            if pending_var:
                if not text:
                    return None
                toks.append(("*", text[0]))
                text = text[1:]
                pending_var = False
            got = _tokenize(text)
            if got is None:
                return None
            toks.extend(got[1])
        else:
            if pending_var:
                return None             # {a}{b} — give up
            pending_var = True
        first = False
    if pending_var:
        return None                     # trailing bare interpolation
    return endian, tuple(toks)


def _fmt_str(endian, toks) -> str:
    out = [endian or ""]
    for t in toks:
        if isinstance(t, tuple) and t[0] == "*":
            out.append(f"{{n}}{t[1]}")
        elif isinstance(t, tuple):
            out.append(f"{t[1]}{t[0]}")
        else:
            out.append(t)
    return "".join(out)


def _is_subseq(needle, hay) -> bool:
    n, h = len(needle), len(hay)
    return any(hay[i:i + n] == needle for i in range(h - n + 1))


def _is_concat(target, pieces) -> bool:
    """target decomposable as a concatenation of fmts from `pieces`."""
    ok = {0}
    for i in range(len(target)):
        if i not in ok:
            continue
        for p in pieces:
            if p and target[i:i + len(p)] == p:
                ok.add(i + len(p))
    return len(target) in ok


# -- site collection -------------------------------------------------------

class _Sites:
    def __init__(self):
        self.pack: dict = {}            # tokens -> [(path, line, fmtstr)]
        self.unpack: dict = {}
        self.native: list = []          # (path, line, fmtstr)
        self.dec_dtypes: dict = {}      # base -> [(path, line, label)]
        self.enc_dtypes: set = set()    # bases

    def add_fmt(self, side: str, got, path: str, line: int):
        endian, toks = got
        label = _fmt_str(endian, toks)
        if endian is None or endian == "@":
            self.native.append((path, line, label))
        (self.pack if side == "pack" else self.unpack) \
            .setdefault(toks, []).append((path, line, label))


def _dtype_base(node) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        s = node.value.lstrip("<>=|")
        return _DTYPE_BASE.get(s, s)
    d = _dotted(node)
    if d.startswith(("np.", "numpy.")):
        return _DTYPE_BASE.get(d.split(".")[-1])
    return None


def _collect(sf, consts, const_uses, sites: _Sites):
    """One walk of a wire-group file: struct format sites, frombuffer
    dtypes, encode-side dtype constructions."""
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if not isinstance(f, ast.Attribute):
            continue
        recv = _dotted(f.value)
        # struct.pack("<fmt", ...) / struct.unpack_from("<fmt", ...)
        if recv == "struct" and f.attr in (_PACK_ATTRS | _UNPACK_ATTRS):
            if node.args:
                got = _tokenize_expr(node.args[0])
                if got is not None:
                    side = "pack" if f.attr in _PACK_ATTRS else "unpack"
                    sites.add_fmt(side, got, sf.path, node.lineno)
        # NAME.pack(...) / other_mod.NAME.unpack_from(...)
        elif f.attr in (_PACK_ATTRS | _UNPACK_ATTRS):
            key = None
            if isinstance(f.value, ast.Name):
                key = (sf.modname, f.value.id)
            elif (isinstance(f.value, ast.Attribute)
                    and isinstance(f.value.value, ast.Name)):
                local = f.value.value.id
                target = sf.imports.get(local)
                if target:
                    for (mod, cname) in consts:
                        if cname == f.value.attr and (
                                target == mod or target.endswith(mod)
                                or mod.endswith(target)):
                            key = (mod, cname)
                            break
            if key in consts:
                side = "pack" if f.attr in _PACK_ATTRS else "unpack"
                sites.add_fmt(side, consts[key], sf.path, node.lineno)
                const_uses.setdefault(key, set()).add(side)
        # np.frombuffer(buf, dtype=...) — decode side
        if recv in ("np", "numpy") and f.attr == "frombuffer":
            dt = None
            for kw in node.keywords:
                if kw.arg == "dtype":
                    dt = kw.value
            if dt is None and len(node.args) > 1:
                dt = node.args[1]
            base = _dtype_base(dt) if dt is not None else None
            if base:
                sites.dec_dtypes.setdefault(base, []).append(
                    (sf.path, node.lineno, base))
        # encode-side dtype constructions
        elif recv in ("np", "numpy") and f.attr in _NP_ENCODE_CTORS:
            for kw in node.keywords:
                if kw.arg == "dtype":
                    base = _dtype_base(kw.value)
                    if base:
                        sites.enc_dtypes.add(base)
            if len(node.args) > 1:
                base = _dtype_base(node.args[1])
                if base:
                    sites.enc_dtypes.add(base)


def _tid_registry(sf) -> tuple:
    """serde's _TYPE_IDS: (line, names, to_bytes literals,
    from_bytes literals) or None."""
    reg_line, names = None, set()
    for node in sf.tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "_TYPE_IDS"
                and isinstance(node.value, ast.Dict)):
            reg_line = node.lineno
            names = {k.value for k in node.value.keys
                     if isinstance(k, ast.Constant)
                     and isinstance(k.value, str)}
    if reg_line is None:
        return None
    enc, dec = set(), set()
    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name in ("to_bytes", "from_bytes"):
            bucket = enc if node.name == "to_bytes" else dec
            for sub in ast.walk(node):
                if isinstance(sub, ast.Constant) \
                        and isinstance(sub.value, str):
                    bucket.add(sub.value)
    return reg_line, names, enc, dec


# -- the pass --------------------------------------------------------------

def check(prog: Program) -> list[Finding]:
    group = [sf for sf in prog.files if _in_group(sf)]
    if not group:
        return []

    consts: dict = {}                   # (modname, NAME) -> (endian, toks)
    for sf in group:
        for node in sf.tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)
                    and _dotted(node.value.func) in ("struct.Struct",
                                                     "Struct")
                    and node.value.args):
                got = _tokenize_expr(node.value.args[0])
                if got is not None:
                    consts[(sf.modname, node.targets[0].id)] = got

    sites = _Sites()
    const_uses: dict = {}
    for sf in group:
        _collect(sf, consts, const_uses, sites)

    findings: list[Finding] = []

    for path, line, label in sites.native:
        findings.append(Finding(
            "PS204", path, line,
            f"struct format {label!r} has native endianness — the wire "
            "contract is explicit little-endian; prefix with '<'"))

    pack_fmts = set(sites.pack)
    unpack_fmts = set(sites.unpack)
    for toks in sorted(sites.pack, key=str):
        if toks in unpack_fmts \
                or any(_is_subseq(toks, u) for u in unpack_fmts) \
                or _is_concat(toks, unpack_fmts):
            continue
        path, line, label = sites.pack[toks][0]
        findings.append(Finding(
            "PS204", path, line,
            f"pack format {label!r} has no decode side in the wire "
            "modules (not an unpack format, slice of one, or "
            "concatenation of them) — one-sided schema"))
    for toks in sorted(sites.unpack, key=str):
        if toks in pack_fmts \
                or any(_is_subseq(toks, p) for p in pack_fmts) \
                or _is_concat(toks, pack_fmts):
            continue
        path, line, label = sites.unpack[toks][0]
        findings.append(Finding(
            "PS204", path, line,
            f"unpack format {label!r} has no encode side in the wire "
            "modules — decoding bytes nobody writes (or a schema "
            "drifted on one side only)"))

    for base in sorted(sites.dec_dtypes):
        if base in sites.enc_dtypes:
            continue
        path, line, _ = sites.dec_dtypes[base][0]
        findings.append(Finding(
            "PS204", path, line,
            f"np.frombuffer dtype {base!r} has no encode-side array "
            "construction in the wire modules — one-sided schema"))

    for sf in group:
        reg = _tid_registry(sf)
        if reg is None:
            continue
        reg_line, names, enc, dec = reg
        for name in sorted(names):
            missing = [side for side, seen in
                       (("to_bytes", enc), ("from_bytes", dec))
                       if name not in seen]
            if missing:
                findings.append(Finding(
                    "PS204", sf.path, reg_line,
                    f"serde type id {name!r} is never mentioned by "
                    f"{' or '.join(missing)} — a message kind that "
                    "cannot round-trip"))

    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
