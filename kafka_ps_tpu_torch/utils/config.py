"""Configuration dataclasses (counterpart of kafka_ps_tpu/utils/config.py)
plus the port's device rule.

The dataclasses keep the reference's names and defaults for the fields
this package implements; options of subsystems not yet ported
(compression, slab dtypes, serving, tiering) are absent rather than
accepted and ignored.  There is no Pallas switch: on the card the
hand-written kernels are the only path.
"""

from __future__ import annotations

import dataclasses
import os

import torch

# Consistency-model constants: sequential/BSP == 0, bounded delay == k > 0,
# eventual == -1.
SEQUENTIAL = 0
EVENTUAL = -1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Logistic-regression shape: a flat vector of (num_classes + 1) *
    num_features coefficients followed by (num_classes + 1) intercepts —
    6*1024 + 6 = 6150 keys by default (labels are 1..num_classes, row 0
    exists but is never observed).  `num_params` is logreg's count; a
    task's own is `get_task(name, cfg).num_params`."""

    num_features: int = 1024
    num_classes: int = 5
    num_max_iter: int = 2       # k local solver steps per iteration
    local_learning_rate: float = 0.5
    hidden_dim: int = 128       # used by the mlp task family only

    @property
    def num_rows(self) -> int:
        return self.num_classes + 1

    @property
    def num_params(self) -> int:
        return self.num_rows * self.num_features + self.num_rows


@dataclasses.dataclass(frozen=True)
class BufferConfig:
    """Dynamic sliding-buffer policy."""

    min_size: int = 128
    max_size: int = 1024
    coefficient: float = 0.3      # target = clamp(bc * events_per_min, min, max)
    arrival_window: int = 500     # inter-arrival-time window length


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Producer pacing."""

    time_per_event_ms: float = 200.0   # steady-state ms per event
    prefill_per_worker: int = 128      # first num_workers*128 rows unthrottled


@dataclasses.dataclass(frozen=True)
class PSConfig:
    """Top-level parameter-server configuration."""

    num_workers: int = 4
    consistency_model: int = SEQUENTIAL   # 0 BSP, k>0 bounded delay, -1 eventual
    task: str = "logreg"
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    buffer: BufferConfig = dataclasses.field(default_factory=BufferConfig)
    stream: StreamConfig = dataclasses.field(default_factory=StreamConfig)
    # server aggregation rate; None = 1/num_workers (BSP averages deltas)
    learning_rate: float | None = None
    eval_every: int = 1
    # async eval engine (evaluation/engine.py): the server's apply hands
    # (theta, clock) to a thread that evaluates and emits rows in clock
    # order, the same rows as the fused apply+eval
    eval_async: bool = True
    # gang dispatch (runtime/gang.py): workers the gate releases at one
    # moment run as one batched kernel call, the server applies queued
    # gradients as one chained batch; bitwise the per-message results
    use_gang: bool = True

    @property
    def server_lr(self) -> float:
        if self.learning_rate is not None:
            return self.learning_rate
        return 1.0 / self.num_workers

    @property
    def max_vector_clock_delay(self) -> int:
        return self.consistency_model


_PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    An explicit `device` wins; otherwise `KPS_PLATFORM` (cpu | cuda |
    gpu) decides; otherwise CUDA.  A CUDA request on a machine without a
    card raises instead of quietly running on the CPU."""
    if device is None:
        platform = os.environ.get("KPS_PLATFORM", "").strip().lower()
        if platform and platform not in _PLATFORMS:
            raise ValueError(
                f"KPS_PLATFORM={platform!r}: expected one of "
                f"{sorted(_PLATFORMS)}")
        device = _PLATFORMS.get(platform, "cuda")
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card found: kafka_ps_tpu_torch runs on an NVIDIA GPU. "
            "Pass device='cpu' or set KPS_PLATFORM=cpu to run on the CPU.")
    return dev
