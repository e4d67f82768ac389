"""Checkpoint / resume (counterpart of kafka_ps_tpu/utils/checkpoint.py).

The server's recoverable state (parameter vector, per-worker vector
clocks, reply flags and membership, iteration count, run id) snapshots
to one .npz, written to a temporary name and renamed into place.  The
training window is durable too: in-process runs fold every worker's
buffer (slab, insertion IDs, arrival window) and, with compression on,
its error-feedback residual into the same file; a split deployment keeps
one state file per worker process (`save_worker`,
`maybe_restore_worker`).

Keys and dtypes are the JAX package's, so a checkpoint written by either
package restores into the other.  θ, the buffers and the residuals are
written as host arrays (np.savez of a CUDA tensor raises) and restored
onto the server's and the workers' devices.  With a tiered store on the
server (store/) the file also records each page's tier and heat
(`tier_residency`, `tier_reads`, `tier_writes`, `tier_page_params`),
taken before θ is assembled; a restore checks the page size and applies
the recorded residency once θ is scattered into the pages.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _buffer_items(buffers):
    """Accept a list (app.buffers, index = worker id) or a dict {id: buf}."""
    if buffers is None:
        return []
    if isinstance(buffers, dict):
        return sorted(buffers.items())
    return list(enumerate(buffers))


def _pack_buffers(arrays: dict, buffers) -> None:
    for w, buf in _buffer_items(buffers):
        for k, v in buf.state().items():
            arrays[f"buf{w}_{k}"] = v


def _unpack_buffers(z, buffers) -> bool:
    """Restore any buffers present in the archive; True if any were."""
    found = False
    for w, buf in _buffer_items(buffers):
        if f"buf{w}_ids" not in z.files:
            continue        # a checkpoint without buffers, or a remote worker
        buf.restore_state({k: z[f"buf{w}_{k}"]
                           for k in ("x", "y", "ids", "arrivals")})
        found = True
    return found


def _residual_items(residuals):
    """Accept a dict {worker: ErrorFeedback-like} (app.compressors);
    None means compression is off."""
    if residuals is None:
        return []
    return sorted(residuals.items())


def _pack_residuals(arrays: dict, residuals) -> None:
    # a resume must carry the exact residual the run stopped with, or
    # the compressed stream continues biased
    for w, ef in _residual_items(residuals):
        arrays[f"ef{w}_residual"] = ef.state()


def _unpack_residuals(z, residuals) -> None:
    for w, ef in _residual_items(residuals):
        if f"ef{w}_residual" in z.files:
            ef.restore(z[f"ef{w}_residual"])


def _atomic_savez(path: str, arrays: dict) -> None:
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def save(path: str, server, buffers=None, log_offsets=None,
         residuals=None) -> None:
    arrays = {}
    store = getattr(server, "param_store", None)
    if store is not None:
        # residency and heat BEFORE theta: assembling the slice faults
        # every cold page warm, so the other order would record all
        # pages resident and a restore would never demote again.  They
        # never change the restored values, only the policy's start
        reads, writes = store.heat_vectors()
        arrays["tier_residency"] = store.residency_vector()
        arrays["tier_reads"] = reads
        arrays["tier_writes"] = writes
        arrays["tier_page_params"] = np.asarray(store.page_params,
                                                dtype=np.int64)
    arrays.update(
        theta=server.theta.detach().cpu().numpy(),
        clocks=np.asarray(server.tracker.clocks, dtype=np.int64),
        sent=np.asarray([s.weights_message_sent
                         for s in server.tracker.tracker], dtype=bool),
        active=np.asarray([s.active for s in server.tracker.tracker],
                          dtype=bool),
        iterations=np.asarray(server.iterations, dtype=np.int64),
        run_id=np.asarray(server.run_id, dtype=np.int64))
    if log_offsets is not None:
        # the consumer offsets this snapshot covers ("topic/key" -> next
        # offset), for a durable log's replay
        arrays["log_offsets"] = np.asarray(json.dumps(log_offsets))
    _pack_buffers(arrays, buffers)
    _pack_residuals(arrays, residuals)
    _atomic_savez(path, arrays)


def restore(path: str, server, buffers=None, residuals=None) -> None:
    with np.load(path) as z:
        if tuple(z["theta"].shape) != tuple(server.theta.shape):
            raise ValueError(
                f"checkpoint theta shape {z['theta'].shape} != model "
                f"{tuple(server.theta.shape)}")
        if len(z["clocks"]) != len(server.tracker.tracker):
            raise ValueError("checkpoint worker count mismatch")
        server.theta = torch.tensor(z["theta"], dtype=torch.float32,
                                    device=server.device)
        # checkpoints from before worker eviction existed have no
        # `active` field: every worker is active
        active = (z["active"] if "active" in z.files
                  else np.ones(len(z["clocks"]), dtype=bool))
        for status, clock, sent, act in zip(server.tracker.tracker,
                                            z["clocks"], z["sent"], active):
            status.vector_clock = int(clock)
            status.weights_message_sent = bool(sent)
            status.active = bool(act)
        server.iterations = int(z["iterations"])
        if "run_id" in z.files:      # older checkpoints: keep ours
            server.run_id = int(z["run_id"])
        if "log_offsets" in z.files:
            server.restored_log_offsets = {
                k: int(v) for k, v
                in json.loads(str(z["log_offsets"])).items()}
        store = getattr(server, "param_store", None)
        if store is not None and "tier_residency" in z.files:
            if int(z["tier_page_params"]) != store.page_params:
                raise ValueError(
                    f"checkpoint page size {int(z['tier_page_params'])} "
                    f"!= store page size {store.page_params}")
            # after the theta assignment above put every page hot or
            # warm: recorded-cold pages are demoted again with fresh
            # appends, so the checkpoint never refers to cold records a
            # crash may have torn off the log's tail
            store.set_residency(z["tier_residency"], z["tier_reads"],
                                z["tier_writes"])
        _unpack_buffers(z, buffers)
        _unpack_residuals(z, residuals)
    # the stop killed every in-flight message: start_training_loop
    # re-sends each worker's current clock, so a worker may log a clock
    # the surviving log already holds; the event marks that boundary
    server.record_membership_event("resume", -1)


def maybe_restore(path: str, server, buffers=None, residuals=None) -> bool:
    if os.path.exists(path):
        restore(path, server, buffers=buffers, residuals=residuals)
        return True
    return False


# -- split-mode worker-local state ---------------------------------------------

def peek_run_id(path: str) -> int | None:
    """The run id stored in a checkpoint or worker state file, if any.
    A run is a fresh server start plus every checkpoint resume of it:
    worker-local state is valid only within the run that wrote it."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return int(z["run_id"]) if "run_id" in z.files else None


def shard_state_path(checkpoint: str, shard_id: int,
                     num_shards: int) -> str:
    """One checkpoint file per server shard, derived from the job's
    --checkpoint path; one shard keeps the plain path."""
    if num_shards == 1:
        return checkpoint
    return f"{checkpoint}.shard{shard_id}of{num_shards}.npz"


def worker_state_path(checkpoint: str, worker_ids) -> str:
    """One state file per worker process (the ids it hosts), derived
    from the job's --checkpoint path."""
    tag = "-".join(str(w) for w in sorted(worker_ids))
    return f"{checkpoint}.workers-{tag}.npz"


def save_worker(path: str, buffers, run_id: int = 0,
                residuals=None) -> None:
    arrays: dict = {"_worker_state": np.asarray(1, dtype=np.int64),
                    "run_id": np.asarray(run_id, dtype=np.int64)}
    _pack_buffers(arrays, buffers)
    _pack_residuals(arrays, residuals)
    _atomic_savez(path, arrays)


def maybe_restore_worker(path: str, buffers, run_id: int | None = None,
                         residuals=None) -> bool:
    """Restore the buffers (and, with compression on, the residuals),
    unless `run_id` is given and the file was written under another run
    (a leftover that would seed a fresh run with another run's training
    window)."""
    if not os.path.exists(path):
        return False
    with np.load(path) as z:
        if run_id is not None:
            stored = int(z["run_id"]) if "run_id" in z.files else None
            if stored != run_id:
                return False
        found = _unpack_buffers(z, buffers)
        _unpack_residuals(z, residuals)
        return found
