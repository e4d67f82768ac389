"""Online serving plane (counterpart of kafka_ps_tpu/serving/): the
train/serve split of the streaming parameter server.

The trainer keeps aggregating deltas while this package answers live
prediction requests against recent weights:

  * `snapshot.SnapshotRegistry`: immutable (theta, vector_clock,
    wall_time) snapshots published by the server at every
    consistency-gate release, hot-swapped lock-free for readers; theta
    is the server's own tensor, on the card;
  * `engine.PredictionEngine`: micro-batched predictions under a
    deadline and size cap (the read path's gang dispatch), with
    admission control and adaptive dispatch (`costmodel`);
  * `policy`: staleness-bounded reads (`min_clock` / `max_age_s`);
  * `shm`: the same-host shared-memory channel for predict traffic;
  * `replica.ReplicaFollower`: a read replica that follows a durable
    log;
  * `loadgen`: closed- and open-loop load against an engine or a port.

`policy`, `snapshot` and `costmodel` import no torch, so transport and
client code can use them without a device; the engine and the replica
load on first use.
"""

from kafka_ps_tpu_torch.serving.policy import (EVENTUAL_READ,
                                               OverloadedError, ReadBound,
                                               StalenessError)
from kafka_ps_tpu_torch.serving.snapshot import (FrontierCutPublisher,
                                                 MultiModelRegistry,
                                                 Snapshot, SnapshotRegistry)

__all__ = ["EVENTUAL_READ", "OverloadedError", "ReadBound",
           "StalenessError", "Snapshot", "SnapshotRegistry",
           "MultiModelRegistry", "FrontierCutPublisher",
           "PredictionEngine", "Prediction", "ReplicaFollower"]


def __getattr__(name):
    # the engine and the replica pull in torch; load them only when a
    # caller serves predictions
    if name in ("PredictionEngine", "Prediction"):
        from kafka_ps_tpu_torch.serving import engine
        return getattr(engine, name)
    if name == "ReplicaFollower":
        from kafka_ps_tpu_torch.serving.replica import ReplicaFollower
        return ReplicaFollower
    raise AttributeError(name)
