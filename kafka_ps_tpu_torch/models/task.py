"""The ML-task abstraction (counterpart of kafka_ps_tpu/models/task.py):
the flat parameter layout, the k-step local solver and test evaluation
the runtime dispatches through.  Only the reference's model, logreg, is
ported so far."""

from __future__ import annotations

from kafka_ps_tpu_torch.models import logreg
from kafka_ps_tpu_torch.models import metrics as metrics_mod
from kafka_ps_tpu_torch.utils.config import ModelConfig


class LogRegTask:
    """Multinomial LR over the flat (C+1)·F + (C+1) layout."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    @property
    def num_params(self) -> int:
        return self.cfg.num_params

    def init_params(self, device):
        return logreg.init_params(self.cfg, device).flat

    def evaluate(self, theta, x_test, y_test) -> metrics_mod.Metrics:
        return metrics_mod.evaluate(theta, x_test, y_test, cfg=self.cfg)


_REGISTRY = {"logreg": LogRegTask}


def get_task(name: str, cfg: ModelConfig) -> LogRegTask:
    if name == "mlp":
        raise ValueError(
            "task 'mlp' is not ported to kafka_ps_tpu_torch yet; see "
            "ROADMAP.md (queue A, models/mlp.py)")
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown task {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name](cfg)
