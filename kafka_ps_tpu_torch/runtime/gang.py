"""Gang dispatch (counterpart of kafka_ps_tpu/runtime/gang.py): the
workers the consistency gate releases at one moment run as ONE batched
kernel call.

The gate routinely releases several workers together: all of them under
sequential consistency, a subset under bounded delay when the slowest
worker catches up, every worker at bootstrap.  The server advertises
such a release set with a GangNotice on GANG_TOPIC beside the per-worker
WeightsMessages.  A `GangDispatcher` claims the set's messages, runs
each member's own `_prepare` (its slab, its `num_tuples_seen`), calls
the family's batched kernel once over all members — K2
(`local_update_batched`) for logreg, K6 (`mlp_local_update_batched`)
for the MLP, which take per-member pointers, so nothing is stacked and
a theta shared by every member (sequential consistency) is passed as
the same tensor k times — then runs each member's `_finish` in
worker-id order: the same worker CSV rows and GradientMessages, in the
same order, as the per-message path.  Bitwise equality with that path
holds because a gang member IS a single call (the batched kernel is the
single kernel with a member axis; the plain batched version loops the
plain single one); tests/test_torch_gang.py pins it.

A failing batched kernel raises.  There is no switch to per-member
single calls: that would hide the kernel.

Threaded mode coalesces by first arrival: the thread that pops a
message covered by a notice leads the gang and claims the siblings'
messages that are ALREADY queued — it never waits; members whose threads
took their own message first run solo there.
"""

from __future__ import annotations

import functools
import threading

from kafka_ps_tpu_torch.models.task import get_task
from kafka_ps_tpu_torch.ops import fused_update
from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime import worker as worker_mod

# the batched kernel of each task family (K2, K6)
BATCHED_SOLVERS = {"logreg": fused_update.local_update_batched,
                   "mlp": fused_update.mlp_local_update_batched}


class GangMemberError(RuntimeError):
    """A gang member failed inside another worker's thread; carries the
    member's id."""

    def __init__(self, worker_id: int, cause: BaseException):
        super().__init__(f"gang member {worker_id} failed: {cause!r}")
        self.worker_id = worker_id


@functools.lru_cache(maxsize=None)
def _gang_solver_fns(task_name: str, cfg):
    """(update, update_and_eval) over per-member lists, the batched
    counterparts of worker._solver_fns: one kernel call for every
    member's update, then per member the same evaluation of
    theta + delta the single path runs."""
    task = get_task(task_name, cfg)
    batched = BATCHED_SOLVERS[task_name]

    def update(thetas, xs, ys, masks):
        return batched(thetas, xs, ys, masks, cfg=cfg)

    def update_and_eval(thetas, xs, ys, masks, test_x, test_y):
        deltas, losses = update(thetas, xs, ys, masks)
        mets = task.evaluate_batch([t + d for t, d in zip(thetas, deltas)],
                                   test_x, test_y)
        return deltas, losses, mets.f1, mets.accuracy

    return update, update_and_eval


class GangDispatcher:
    """Claims release sets and runs them as batched kernel calls.

    Serial drive: `drain_serial()` pops each GangNotice, claims every
    member's weights message and dispatches the whole set.  Threaded
    drive: worker threads route their messages through `offer()`.
    `dispatches` and `members` count the batched calls and the members
    they covered."""

    def __init__(self, workers, fabric, cfg):
        self.workers = {w.worker_id: w for w in workers}
        self.fabric = fabric
        self.cfg = cfg
        self._offer_lock = threading.Lock()
        # (worker_id, clock) -> the member tuple of its notice
        self._notices: dict[tuple[int, int], tuple] = {}
        self._count_lock = threading.Lock()
        self.dispatches = 0
        self.members = 0

    # -- drive-loop entries ----------------------------------------------

    def drain_serial(self) -> bool:
        """Consume every queued gang notice, claiming each release set
        whole.  Returns True if any member ran."""
        progressed = False
        while True:
            notice = self.fabric.poll(fabric_mod.GANG_TOPIC, 0)
            if notice is None:
                return progressed
            members = []
            for w, _ in notice.members:
                msg = self.fabric.poll(fabric_mod.WEIGHTS_TOPIC, w)
                if msg is not None:
                    members.append((self.workers[w], msg))
            if not members:
                continue        # set already consumed elsewhere
            if len(members) == 1:
                members[0][0].on_weights(members[0][1])
            else:
                self.dispatch(members)
            progressed = True

    def offer(self, worker, msg) -> None:
        """Threaded entry, first-arrival leadership: the caller pops the
        notice covering (worker, clock), if any, and claims the siblings'
        messages still queued in the fabric.  Bookkeeping is non-blocking
        under one lock; the dispatch runs outside it."""
        members = None
        with self._offer_lock:
            self._refresh_notices()
            # entries superseded by this worker's own progress can never
            # match again: drop them so the map stays bounded
            for kc in [kc for kc in self._notices
                       if kc[0] == worker.worker_id
                       and kc[1] < msg.vector_clock]:
                del self._notices[kc]
            spec = self._notices.pop((worker.worker_id, msg.vector_clock),
                                     None)
            if spec is not None:
                members = [(worker, msg)]
                for w, _ in spec:
                    if w == worker.worker_id:
                        continue
                    sib = self.fabric.poll(fabric_mod.WEIGHTS_TOPIC, w)
                    if sib is not None:
                        members.append((self.workers[w], sib))
                for w, c in spec:   # claimed: latecomers run solo
                    self._notices.pop((w, c), None)
        if members is None or len(members) == 1:
            worker.on_weights(msg)
        else:
            self.dispatch(members)

    def _refresh_notices(self) -> None:
        while True:
            notice = self.fabric.poll(fabric_mod.GANG_TOPIC, 0)
            if notice is None:
                return
            for member in notice.members:
                self._notices[member] = notice.members

    # -- the batched step -------------------------------------------------

    def dispatch(self, members) -> None:
        """One batched kernel call for a claimed release set, with
        per-message semantics: members sorted by worker id, each
        member's own `_prepare`/`_finish`.  A set that spans eval
        cadence (bounded delay mixes clocks) splits into at most one
        eval and one non-eval call; a part of one member takes the
        single path.  A member whose `_prepare` fails is reported after
        the healthy members have finished."""
        members = sorted(members, key=lambda wm: wm[0].worker_id)
        failures: list[GangMemberError] = []
        prepared = []
        for w, m in members:
            try:
                prepared.append((w, m) + tuple(w._prepare(m)))
            except Exception as e:   # the healthy members still run
                failures.append(GangMemberError(w.worker_id, e))
        results: dict[tuple[int, int], tuple] = {}
        for with_eval in (True, False):
            grp = [p for p in prepared if p[7] == with_eval]
            if grp:
                self._dispatch_group(grp, with_eval, results)
        # _finish in member order: CSV rows and GradientMessages reach
        # their queues in exactly the per-message order
        for w, msg, _, _, _, _, seen, _ in prepared:
            w._finish(msg, seen, *results[(w.worker_id, msg.vector_clock)])
        if failures:
            raise failures[0]

    def _dispatch_group(self, grp, with_eval: bool, results: dict) -> None:
        lead = grp[0][0]
        if len(grp) == 1:
            w, msg, theta, x, y, mask, _, _ = grp[0]
            update_fn, update_eval_fn = worker_mod._solver_fns(
                self.cfg.task, self.cfg.model)
            if with_eval:
                out = update_eval_fn(theta, x, y, mask, w.test_x, w.test_y)
            else:
                out = update_fn(theta, x, y, mask) + (-1.0, -1.0)
            results[(w.worker_id, msg.vector_clock)] = out
            return
        update, update_and_eval = _gang_solver_fns(self.cfg.task,
                                                   self.cfg.model)
        args = [[p[i] for p in grp] for i in (2, 3, 4, 5)]
        k = len(grp)
        if with_eval:
            deltas, losses, f1s, accs = update_and_eval(
                *args, lead.test_x, lead.test_y)
        else:
            deltas, losses = update(*args)
            f1s = accs = (-1.0,) * k
        with self._count_lock:
            self.dispatches += 1
            self.members += k
        for p, d, loss, f1, acc in zip(grp, deltas, losses, f1s, accs):
            results[(p[0].worker_id, p[1].vector_clock)] = (d, loss, f1, acc)
