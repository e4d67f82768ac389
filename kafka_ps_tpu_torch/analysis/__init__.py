"""Static + runtime invariant checking for kafka_ps_tpu_torch — the
port of ``kafka_ps_tpu.analysis``, a copy rather than an import.

- ``pscheck``   — per-file AST analyzer (rules PS100-PS106 in torch
  terms), stdlib-only.
- ``psverify``  — the combined driver: pscheck plus the whole-program
  passes, behind ``python -m kafka_ps_tpu_torch.analysis
  kafka_ps_tpu_torch/ [--json] [--lock-coverage edges.json]``:

  * ``threadck`` — thread-ownership/race analysis (PS201/PS202):
    lockset intersection over every shared ``self.<attr>`` access
    site, with ``# guarded-by:`` / ``# owned-by:`` annotations.
  * ``lockflow`` — static held→acquired lock graph, Tarjan cycles
    (PS203), and the static-vs-runtime coverage diff.
  * ``wireck``  — encode/decode wire-schema cross-check (PS204).
  * PS107 — useless-suppression audit over the whole inventory.

- ``program``   — the shared whole-program AST/symbol model the three
  passes consume.
- ``lockgraph`` — runtime lock-acquisition-order recorder (OrderedLock /
  OrderedCondition) with deadlock-cycle detection, reported at pytest
  session end by ``kafka_ps_tpu_torch.analysis.pytest_plugin``.

The rule catalog, suppression syntax and annotation grammar are the
reference's (docs/ANALYSIS.md); pscheck's docstring gives the torch
terms of PS101, PS102, PS104 and PS106.

This package must stay importable without torch (and without jax):
the CLI runs before any accelerator runtime is touched.
"""

from kafka_ps_tpu_torch.analysis import lockgraph, pscheck  # noqa: F401

__all__ = ["lockgraph", "pscheck", "psverify", "program",
           "threadck", "lockflow", "wireck"]


def __getattr__(name):
    # the whole-program passes are imported lazily so that importing
    # the package (e.g. for OrderedLock) stays as cheap as before
    if name in __all__:
        import importlib
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(name)
