"""Offline evaluation (counterpart of kafka_ps_tpu/evaluation/): the log
loaders and run summaries (logs.py), the protocol auditor (validate.py),
the plots (plots.py), the ground-truth fit (ground_truth.py) and their
CLI, `python -m kafka_ps_tpu_torch.evaluation`; and the async eval engine
of the trainer's apply path (engine.py).

The offline tools need pandas (matplotlib for the plots, sklearn for the
ground truth's report); the trainer needs none of them.  So this package
imports nothing eagerly: `RunSummary`, `load_server_log`,
`load_worker_log` and `summarize_run`, which the JAX package re-exports
from its `__init__`, load logs.py (and pandas) at their first access.
"""

_LOGS_NAMES = ("RunSummary", "load_server_log", "load_worker_log",
               "summarize_run")


def __getattr__(name: str):
    if name in _LOGS_NAMES:
        from kafka_ps_tpu_torch.evaluation import logs
        return getattr(logs, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
