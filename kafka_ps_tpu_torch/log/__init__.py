"""Durable commit log (counterpart of kafka_ps_tpu/log/): the offset-
addressed, replayable log the reference's Kafka topics are.

  * `records`   — CRC32-framed, length-prefixed record codec (payloads
                  are `runtime/serde.py` binary frames);
  * `segment`   — one append-only segment file + sparse offset index;
  * `log`       — `CommitLog`: segmented partition log with monotonic
                  offsets, roll/retention and an fsync policy;
  * `manager`   — `LogManager`: (topic, key) partition registry +
                  consumer groups with durable committed offsets;
  * `tail`      — read-only tailing for log-following readers;
  * `durable_fabric` — `DurableFabric`: the fabric API layered over the
                  log, with crash recovery by replay from committed
                  offsets.

The on-disk bytes are the JAX package's: a log written by either package
is read record for record by the other.  Recovery: a checkpoint records
the log offsets it covers; resume = load the checkpoint + replay the log
tail; the server drops replayed gradients whose clock it already applied.
"""

from kafka_ps_tpu_torch.log.durable_fabric import DurableFabric
from kafka_ps_tpu_torch.log.log import CommitLog, LogConfig
from kafka_ps_tpu_torch.log.manager import LogManager
from kafka_ps_tpu_torch.log.tail import PartitionTailer, TopicTailer

__all__ = ["CommitLog", "DurableFabric", "LogConfig", "LogManager",
           "PartitionTailer", "TopicTailer"]
