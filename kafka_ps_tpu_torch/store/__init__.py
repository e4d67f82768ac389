"""Tiered parameter store (counterpart of kafka_ps_tpu/store/): hot
(device pages) / warm (host arrays) / cold (commit-log records)
residency for a server's theta slice, so the parameter vector outgrows
the card's memory without changing a computed bit."""

from kafka_ps_tpu_torch.store.cold import ColdStore
from kafka_ps_tpu_torch.store.tiered import (TIER_COLD, TIER_HOT,
                                             TIER_NAMES, TIER_WARM,
                                             TieredParamStore,
                                             attach_tiered_store)

__all__ = ["ColdStore", "TieredParamStore", "TIER_HOT", "TIER_WARM",
           "TIER_COLD", "TIER_NAMES", "attach_tiered_store"]
