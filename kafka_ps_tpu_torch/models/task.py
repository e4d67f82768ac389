"""The ML-task abstraction (counterpart of kafka_ps_tpu/models/task.py):
the flat parameter layout, the k-step local solver and test evaluation
the runtime dispatches through.  Two families: `logreg`, the reference's
model, and `mlp` (models/mlp.py)."""

from __future__ import annotations

from kafka_ps_tpu_torch.models import logreg
from kafka_ps_tpu_torch.models import metrics as metrics_mod
from kafka_ps_tpu_torch.models.mlp import MLPTask
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

    def evaluate_batch(self, thetas, x_test, y_test) -> metrics_mod.Metrics:
        """(k,)-leading metrics, row i bitwise equal to evaluate(thetas[i])."""
        return metrics_mod.stack_evaluations(self.evaluate, thetas, x_test,
                                             y_test)

    def predict_logits(self, theta, x):
        """(B, F) -> (B, C+1) class scores: the serving plane's forward
        (serving/engine.py)."""
        return logreg.logits(logreg.unflatten(theta, self.cfg), x)


_REGISTRY = {"logreg": LogRegTask, "mlp": MLPTask}


def get_task(name: str, cfg: ModelConfig) -> LogRegTask | MLPTask:
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown task {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name](cfg)
