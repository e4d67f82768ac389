"""Message schema (counterpart of kafka_ps_tpu/runtime/messages.py).

Parameters are addressed as positions in the flat parameter vector;
a message body is one dense slab (here a tensor, on the device for the
in-process fabric) over a contiguous half-open KeyRange.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class KeyRange:
    """Half-open [start, end) span of flat parameter keys."""

    start: int
    end: int

    def __post_init__(self):
        if self.start < 0 or self.end < self.start:
            raise ValueError(f"invalid KeyRange [{self.start}, {self.end})")

    def __len__(self) -> int:
        return self.end - self.start


@dataclasses.dataclass(frozen=True)
class BaseMessage:
    """vector clock + key range + dense values."""

    vector_clock: int
    key_range: KeyRange
    values: torch.Tensor

    def __post_init__(self):
        if len(self.values) != len(self.key_range):
            raise ValueError(
                f"values length {len(self.values)} != key range "
                f"[{self.key_range.start}, {self.key_range.end})")


@dataclasses.dataclass(frozen=True)
class WeightsMessage(BaseMessage):
    """server → worker."""


@dataclasses.dataclass(frozen=True)
class GradientMessage(BaseMessage):
    """worker → server; carries the sending worker's id."""

    worker_id: int = 0


@dataclasses.dataclass(frozen=True)
class GangNotice:
    """Server → drive loop: the gate just released `members` (worker id,
    clock) at one moment, and their per-worker WeightsMessages are in the
    fabric; a dispatcher may claim them as ONE batched kernel call
    (runtime/gang.py).  Advisory: the per-worker messages are the
    protocol, and a dropped notice only costs the coalescing."""

    members: tuple[tuple[int, int], ...]
