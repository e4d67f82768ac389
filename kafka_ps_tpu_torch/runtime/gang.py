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
for the MLP, or their bf16 / int8 instances K3 and K5 when the slabs are
stored reduced — which take per-member pointers, so nothing is stacked
(an int8 member's q and row scales are two pointers of their own) and a
theta shared by every member (sequential consistency) is passed as the
same tensor k times — then runs each member's `_finish` in
worker-id order: the same worker CSV rows and GradientMessages, in the
same order, as the per-message path.  Bitwise equality with that path
holds because a gang member IS a single call (the batched kernel is the
single kernel with a member axis; the plain batched version loops the
plain single one); tests/test_torch_gang.py pins it.

A failing batched kernel raises.  There is no switch to per-member
single calls: that would hide the kernel.  A worker whose `on_weights`
is replaced on the instance (a fault injector, a wrapper) is never
claimed: its messages stay queued for its own per-message entry.  With
compression on, members are grouped by clock (one call per release
set), and a compressed worker's redelivered weights clock is answered
from its cache instead of joining a gang.

Threaded mode coalesces by first arrival: the thread that pops a
message covered by a notice leads the gang and claims the siblings'
messages that are ALREADY queued — it never waits; members whose threads
took their own message first run solo there.

Telemetry (tracer=, telemetry=; null by default): a `worker.local_update`
span around each kernel call (`gang=k` on a batched one) with a
`dispatch.device` count, `gang.batched_dispatches` /
`gang.batched_members` on the tracer and `gang_dispatches_total` /
`gang_members_total` in the registry, as in the JAX dispatcher.
"""

from __future__ import annotations

import functools

from kafka_ps_tpu_torch.analysis.lockgraph import OrderedLock
from kafka_ps_tpu_torch.models.task import get_task
from kafka_ps_tpu_torch.ops import fused_update
from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime import worker as worker_mod
from kafka_ps_tpu_torch.telemetry.registry import NULL_TELEMETRY
from kafka_ps_tpu_torch.utils.trace import NULL_TRACER

# the batched kernel of each task family (K2/K3, K6/K5 by slab form)
BATCHED_SOLVERS = {"logreg": fused_update.local_update_batched,
                   "mlp": fused_update.mlp_local_update_batched}


class GangMemberError(RuntimeError):
    """A gang member failed inside another worker's thread; carries the
    member's id."""

    def __init__(self, worker_id: int, cause: BaseException):
        super().__init__(f"gang member {worker_id} failed: {cause!r}")
        self.worker_id = worker_id
        self.__cause__ = cause


class GangError(RuntimeError):
    """Members of one gang dispatch failed after the healthy members had
    finished; `failures` holds a GangMemberError per failed member."""

    def __init__(self, failures):
        super().__init__("gang members failed: " + ", ".join(
            str(f.worker_id) for f in failures))
        self.failures = list(failures)
        self.__cause__ = self.failures[0]


def _gangable(worker) -> bool:
    """A worker whose `on_weights` is overridden on the INSTANCE keeps
    the per-message entry point: the gang's `_prepare`/`_finish` split
    would silently bypass the wrapper."""
    return "on_weights" not in vars(worker)


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

    def __init__(self, workers, fabric, cfg, tracer=None, telemetry=None):
        self.workers = {w.worker_id: w for w in workers}
        self.fabric = fabric
        self.cfg = cfg
        self.tracer = tracer or NULL_TRACER
        self.telemetry = telemetry or NULL_TELEMETRY
        self._m_dispatches = self.telemetry.counter("gang_dispatches_total")
        self._m_members = self.telemetry.counter("gang_members_total")
        self._offer_lock = OrderedLock("GangDispatcher.offer")
        # (worker_id, clock) -> the member tuple of its notice
        self._notices: dict[tuple[int, int], tuple] = {}
        self._count_lock = OrderedLock("GangDispatcher.count")
        self.dispatches = 0
        self.members = 0
        # compressed runs group members by clock, one call per release
        # set, so that a restarted gate that re-fires several releases at
        # once runs the same calls the live run did
        self._per_clock = cfg.compress not in (None, "", "none")

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
                if not _gangable(self.workers[w]):
                    continue    # left queued for the per-message loop
                msg = self.fabric.poll(fabric_mod.WEIGHTS_TOPIC, w)
                if msg is None:
                    continue
                if self.workers[w]._redelivered_weights(msg):
                    continue    # a redelivery: the cached resend only
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
        if not _gangable(worker):
            worker.on_weights(msg)
            return
        if worker._redelivered_weights(msg):
            return              # a redelivery: the cached resend only
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
                    if w == worker.worker_id or not _gangable(
                            self.workers[w]):
                        continue
                    sib = self.fabric.poll(fabric_mod.WEIGHTS_TOPIC, w)
                    if sib is None:
                        continue
                    if self.workers[w]._redelivered_weights(sib):
                        continue    # a redelivery: the cached resend
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
        single path; under compression each clock is a call of its own.
        Members whose `_prepare` fails are reported together, as one
        GangError, after the healthy members have finished."""
        members = sorted(members, key=lambda wm: wm[0].worker_id)
        failures: list[GangMemberError] = []
        prepared = []
        for w, m in members:
            try:
                prepared.append((w, m) + tuple(w._prepare(m)))
            except Exception as e:   # the healthy members still run
                failures.append(GangMemberError(w.worker_id, e))
        results: dict[tuple[int, int], tuple] = {}
        groups: dict[tuple, list] = {}
        for p in prepared:
            key = (p[7], p[1].vector_clock) if self._per_clock else (p[7],)
            groups.setdefault(key, []).append(p)
        for key in sorted(groups, key=lambda k: (not k[0],) + k[1:]):
            self._dispatch_group(groups[key], key[0], results)
        # _finish in member order: CSV rows and GradientMessages reach
        # their queues in exactly the per-message order
        for w, msg, _, _, _, _, seen, _ in prepared:
            w._finish(msg, seen, *results[(w.worker_id, msg.vector_clock)])
        if failures:
            raise GangError(failures)

    def _dispatch_group(self, grp, with_eval: bool, results: dict) -> None:
        lead = grp[0][0]
        if len(grp) == 1:
            w, msg, theta, x, y, mask, _, _ = grp[0]
            update_fn, update_eval_fn = worker_mod._solver_fns(
                self.cfg.task, self.cfg.model)
            with self.tracer.span("worker.local_update",
                                  worker=w.worker_id,
                                  clock=msg.vector_clock):
                if with_eval:
                    out = update_eval_fn(theta, x, y, mask, w.test_x,
                                         w.test_y)
                else:
                    out = update_fn(theta, x, y, mask) + (-1.0, -1.0)
            self.tracer.count("dispatch.device")
            results[(w.worker_id, msg.vector_clock)] = out
            return
        update, update_and_eval = _gang_solver_fns(self.cfg.task,
                                                   self.cfg.model)
        args = [[p[i] for p in grp] for i in (2, 3, 4, 5)]
        k = len(grp)
        # the per-message span's name: one entry covers k members (the
        # `gang` arg tells them apart); it times the launch, not the card
        with self.tracer.span("worker.local_update", gang=k,
                              workers=[p[0].worker_id for p in grp]):
            if with_eval:
                deltas, losses, f1s, accs = update_and_eval(
                    *args, lead.test_x, lead.test_y)
            else:
                deltas, losses = update(*args)
                f1s = accs = (-1.0,) * k
        self.tracer.count("dispatch.device")
        self.tracer.count("gang.batched_dispatches")
        self.tracer.count("gang.batched_members", k)
        if self.telemetry.enabled:
            self._m_dispatches.inc()
            self._m_members.inc(k)
        with self._count_lock:
            self.dispatches += 1
            self.members += k
        for p, d, loss, f1, acc in zip(grp, deltas, losses, f1s, accs):
            results[(p[0].worker_id, p[1].vector_clock)] = (d, loss, f1, acc)
