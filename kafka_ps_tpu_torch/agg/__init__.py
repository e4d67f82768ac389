"""Hierarchical aggregation (counterpart of kafka_ps_tpu/agg/): a per-host
relay that pre-reduces its co-located workers' deltas into one composite
message per flush, so the server sees O(hosts) connections, not
O(workers)."""

from kafka_ps_tpu_torch.agg.core import (LocalAggregator, direct_equivalent,
                                         merge_composites, split_composite)

__all__ = ["LocalAggregator", "direct_equivalent", "merge_composites",
           "split_composite"]
