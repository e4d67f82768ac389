"""Message schema (counterpart of kafka_ps_tpu/runtime/messages.py).

Parameters are addressed as positions in the flat parameter vector;
a message body is one dense slab (here a tensor, on the device for the
in-process fabric) over a contiguous half-open KeyRange.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class KeyRange:
    """Half-open [start, end) span of flat parameter keys."""

    start: int
    end: int

    def __post_init__(self):
        if self.start < 0 or self.end < self.start:
            raise ValueError(f"invalid KeyRange [{self.start}, {self.end})")

    def contains(self, key: int) -> bool:
        return self.start <= key < self.end

    def __len__(self) -> int:
        return self.end - self.start


@dataclasses.dataclass(frozen=True)
class EncodedValues:
    """Lossy-codec encoding of a message's values (compress/codecs.py):
    codec id + parameter and the encoded parts exactly as the sender
    produced them.  A serializer ships these parts verbatim rather than
    re-encoding `values`: int8 quantization is not idempotent over its
    own decoded output, and a re-encode would desync the sender's
    error-feedback residual from what crossed the wire."""

    codec_id: int
    param: float
    parts: tuple


@dataclasses.dataclass(frozen=True)
class BaseMessage:
    """vector clock + key range + dense values.  `values` is always the
    full-precision view every consumer computes with (for a compressed
    message: the decoded floats); `encoded` is transport metadata only,
    present when a codec produced the message."""

    vector_clock: int
    key_range: KeyRange
    values: torch.Tensor
    encoded: EncodedValues | None = None

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
    """worker → server; carries the sending worker's id.  `host_values`
    is the host array a decoded frame's values came from
    (runtime/serde.py), None otherwise: the model-health plane computes
    on it inline (telemetry/modelhealth.py).  A copy that changes the
    values must drop it."""

    worker_id: int = 0
    host_values: np.ndarray | None = dataclasses.field(
        default=None, compare=False, repr=False)


@dataclasses.dataclass(frozen=True)
class GangNotice:
    """Server → drive loop: the gate just released `members` (worker id,
    clock) at one moment, and their per-worker WeightsMessages are in the
    fabric; a dispatcher may claim them as ONE batched kernel call
    (runtime/gang.py).  Advisory: the per-worker messages are the
    protocol, and a dropped notice only costs the coalescing."""

    members: tuple[tuple[int, int], ...]


@dataclasses.dataclass(frozen=True)
class SparseDeltaMessage:
    """worker → server shard: a sparsified delta slice (range sharding).
    Not a BaseMessage: `values` is the sparse value list, not a dense slab
    over the range.  `indices` are local offsets within `key_range`,
    sorted ascending and unique; an empty slice is still a protocol
    message (the shard's gate must see one gradient per worker and
    clock)."""

    vector_clock: int
    key_range: KeyRange
    indices: torch.Tensor        # int32 local offsets, may be empty
    values: torch.Tensor         # float32, same length as indices
    worker_id: int = 0
    encoded: EncodedValues | None = None   # API parity with BaseMessage
    # as GradientMessage's
    host_values: np.ndarray | None = dataclasses.field(
        default=None, compare=False, repr=False)

    def __post_init__(self):
        if len(self.indices) != len(self.values):
            raise ValueError(
                f"indices length {len(self.indices)} != values length "
                f"{len(self.values)}")


@dataclasses.dataclass(frozen=True)
class CompositeDelta:
    """aggregator → server: one message per (host, clock) carrying the
    deltas of every co-located worker behind an aggregator.

    `members` is the vector-clock map, (worker_id, vector_clock) pairs
    sorted ascending and unique.  Stacked (summed=False): `deltas` holds
    one GradientMessage per member, zipped with `members`, applied per
    member in member order.  Summed (summed=True): `deltas` is ONE
    GradientMessage holding the pre-reduced sum over all members.  A
    stacked member may carry a `trace` attribute (a flow id) that serde
    carries across."""

    agg_id: int
    members: tuple[tuple[int, int], ...]
    deltas: tuple[GradientMessage, ...]
    summed: bool = False

    def __post_init__(self):
        if not self.members:
            raise ValueError("CompositeDelta needs at least one member")
        if list(self.members) != sorted(set(self.members)):
            raise ValueError("CompositeDelta members must be sorted "
                             "and unique")
        if self.summed:
            if len(self.deltas) != 1:
                raise ValueError("summed CompositeDelta carries exactly "
                                 "one pre-reduced delta")
        else:
            if len(self.deltas) != len(self.members):
                raise ValueError(
                    f"stacked CompositeDelta carries one delta per "
                    f"member: {len(self.deltas)} != {len(self.members)}")
            for (w, c), d in zip(self.members, self.deltas):
                if (d.worker_id, d.vector_clock) != (w, c):
                    raise ValueError(
                        f"member ({w}, {c}) does not match its delta "
                        f"({d.worker_id}, {d.vector_clock})")

    @property
    def fan_in(self) -> int:
        return len(self.members)


@dataclasses.dataclass(frozen=True)
class LabeledData:
    """One streamed sample: sparse features + label (the INPUT_DATA
    topic's record)."""

    features: dict[int, float]
    label: int
