"""psverify — the combined static-analysis driver.

One invocation runs four layers over the same file set:

1. **pscheck** (PS100–PS106): the per-file invariant rules.
2. **threadck** (PS201/PS202): whole-program thread-ownership and
   lockset race analysis.
3. **lockflow** (PS203): the static held→acquired graph, its Tarjan
   cycles, and — given a runtime edge dump — the static-vs-runtime
   coverage diff.
4. **wireck** (PS204): encode/decode wire-schema cross-checking.

plus **PS107**, which only the combined view can compute: a
``# pscheck: disable=PSxxx`` entry that no finding of that rule (from
*any* pass) matches is itself a finding — the suppression inventory
cannot rot.  PS107 is evaluated in a single round: suppressing a
PS107 with a reasoned ``disable=PS107`` works, but such an entry is
not re-audited within the same run.

Suppression semantics are pscheck's, uniformly: an entry on the
finding line or the line directly above suppresses any rule code,
PS201–PS204 included; reasonless entries stay PS100.

The CLI replaces ``pscheck.main`` behind
``python -m kafka_ps_tpu_torch.analysis`` — same flags, same JSON shape
(``files`` / ``counts`` / ``by_rule`` / ``findings``), same exit
contract (1 iff unsuppressed findings), with ``--lock-coverage FILE``
added to diff against ``LockGraph.export_edges()`` output.

Stdlib-only, like every module in this package.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from . import lockflow, pscheck, threadck, wireck
from .pscheck import Finding, Report
from .program import build

__all__ = ["RULES", "analyze", "main"]

RULES: dict = dict(pscheck.RULES)
RULES["PS107"] = ("useless suppression: a pscheck disable= entry that "
                  "no finding of that rule matches any more")
RULES.update(threadck.RULES)
RULES.update(lockflow.RULES)
RULES.update(wireck.RULES)


def analyze(paths, runtime_edges=None):
    """-> (Report, coverage_diff | None).

    `paths` are files or directory roots; `runtime_edges` is the
    decoded output of ``LockGraph.export_edges()`` (or None to skip
    the coverage diff).
    """
    files: list[Path] = []
    seen: set = set()
    for p in paths:
        p = Path(p)
        for f in ([p] if p.is_file() else sorted(p.rglob("*.py"))):
            if str(f) not in seen:
                seen.add(str(f))
                files.append(f)

    per_file: dict = {}                 # path -> (findings, table, ps100)
    for f in files:
        source = f.read_text(encoding="utf-8")
        per_file[str(f)] = pscheck.scan_source(source, str(f))

    prog = build(paths)
    whole: dict = {}
    for finding in (threadck.check(prog) + lockflow.check(prog)
                    + wireck.check(prog)):
        whole.setdefault(finding.path, []).append(finding)

    rep = Report(files=len(files))
    for path in per_file:
        findings, table, ps100 = per_file[path]
        findings = findings + whole.pop(path, [])
        used = pscheck.apply_suppressions(findings, table)
        stale = [
            Finding("PS107", path, line,
                    f"suppression of {code} matches no {code} finding — "
                    "the code moved or the issue was fixed; delete the "
                    "stale disable= entry")
            for line, entry in table.items()
            for code in entry
            if (line, code) not in used and code != "PS107"]
        pscheck.apply_suppressions(stale, table)
        rep.findings.extend(ps100)
        rep.findings.extend(findings)
        rep.findings.extend(stale)
    # whole-program findings on files outside the scanned set (cannot
    # happen today — both walks share `paths` — but never drop one)
    for leftovers in whole.values():
        rep.findings.extend(leftovers)
    rep.findings.sort(key=lambda f: (f.path, f.line, f.rule))

    coverage = None
    if runtime_edges is not None:
        coverage = lockflow.coverage_diff(prog, runtime_edges)
    return rep, coverage


def main(argv: list[str] | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m kafka_ps_tpu_torch.analysis",
        description="psverify: pscheck invariants (PS100-PS107) + "
                    "threadck races (PS201/202) + lockflow static "
                    "lock order (PS203) + wireck schema (PS204)")
    ap.add_argument("paths", nargs="*", default=["kafka_ps_tpu_torch"],
                    help="files or directories to analyze "
                         "(default: kafka_ps_tpu_torch)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable report on stdout")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--lock-coverage", metavar="FILE",
                    help="runtime lockgraph edge dump (JSON list from "
                         "LockGraph.export_edges()) to diff the static "
                         "graph against")
    args = ap.parse_args(argv)

    if args.list_rules:
        for code, desc in sorted(RULES.items()):
            print(f"{code}  {desc}")
        return 0

    runtime_edges = None
    if args.lock_coverage:
        loaded = json.loads(Path(args.lock_coverage).read_text(
            encoding="utf-8"))
        runtime_edges = loaded["edges"] if isinstance(loaded, dict) \
            else loaded

    rep, coverage = analyze(args.paths or ["kafka_ps_tpu_torch"],
                            runtime_edges)

    if args.as_json:
        out = rep.to_json()
        if coverage is not None:
            out["lock_coverage"] = coverage
        print(json.dumps(out, indent=2))
    else:
        for f in rep.findings:
            print(f.render())
        print(f"psverify: {rep.files} files, {len(rep.findings)} findings "
              f"({len(rep.suppressed)} suppressed, "
              f"{len(rep.unsuppressed)} unsuppressed)")
        if coverage is not None:
            print(f"lock coverage: {coverage['common']} edges exercised "
                  f"at runtime, {len(coverage['static_only'])} static-only, "
                  f"{len(coverage['runtime_only'])} runtime-only")
            for e in coverage["static_only"]:
                print(f"  static-only {e['src']} -> {e['dst']} "
                      f"@ {e['site']}")
    return 1 if rep.unsuppressed else 0


if __name__ == "__main__":
    sys.exit(main())
