"""Range-sharded multi-server runtime (counterpart of
kafka_ps_tpu/runtime/sharding.py).

The reference carries a KeyRange on every message but runs one server
over the full range.  Here N servers each own a contiguous slice of the
flat parameter vector with their own vector clocks and gate:

  * `ShardPlan`: N contiguous, disjoint key ranges covering the vector
    exactly (the last one clipped, no pad keys);
  * `ShardRouter`: the worker-side splitter.  One outgoing gradient
    becomes N slices, one per shard: a dense delta dense slices (views of
    the delta), a top-k encoded delta `SparseDeltaMessage`s routed by
    index range.  Empty slices are sent too (every shard's gate needs one
    message per worker and clock).  The last 64 clocks' slices are kept,
    so a recovering shard gets the same tensors again, never a recompute;
  * `WeightsAssembler`: the worker-side reassembly.  Slices at a common
    clock become one full-range WeightsMessage (concatenated on their
    device, in shard-id order), delivered once per clock; a slice at a
    clock already delivered is a recovering shard's redelivery and asks
    the router to resend;
  * `ShardedServerGroup`: N ServerNodes behind one facade.  N=1 builds
    the unsharded node through the same code, so theta and the CSV rows
    are the unsharded server's by construction.  `attach_serving` serves
    it: at N=1 the node publishes at every release, as the unsharded
    server does; at N>1 the group publishes the assembled theta at the
    clock frontier (serving/snapshot.FrontierCutPublisher) between
    drive-loop passes, only when the frontier advanced, never a torn mix
    of shard states.

Splitting and assembly are functions of (shard id, worker id, clock)
alone: no set or dict iteration decides an order in these paths.
`attach_param_stores` gives each shard a tiered store over its range
(store/).

Telemetry: the group hands `tracer=` and `telemetry=` to its nodes (whose
families carry the `shard` label at N>1) and to its frontier eval engine;
the router records `router.resend` and the assembler `shard.weights` (one
per offered slice: the per-shard ack trail from which a postmortem names
the last (worker, clock) a dead shard served).  Both records carry host
ints only, and the recorder stamps the time.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable

import torch

from kafka_ps_tpu_torch.compress.wire import CODEC_TOPK
from kafka_ps_tpu_torch.runtime import fabric as fabric_mod
from kafka_ps_tpu_torch.runtime.messages import (GradientMessage, KeyRange,
                                                 SparseDeltaMessage,
                                                 WeightsMessage)
from kafka_ps_tpu_torch.runtime.server import ServerNode
from kafka_ps_tpu_torch.telemetry.flight import FLIGHT


class ShardPlan:
    """The flat key space [0, num_params) in `num_shards` contiguous
    half-open ranges: span = ceil(num_params / num_shards), shard i owns
    [i*span, min((i+1)*span, num_params))."""

    def __init__(self, num_params: int, num_shards: int):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if num_shards > num_params:
            raise ValueError(
                f"num_shards {num_shards} > num_params {num_params}")
        self.num_params = num_params
        self.num_shards = num_shards
        self.span = -(-num_params // num_shards)          # ceil division
        self.ranges: tuple[KeyRange, ...] = tuple(
            KeyRange(i * self.span, min((i + 1) * self.span, num_params))
            for i in range(num_shards))

    def shard_of(self, key: int) -> int:
        if not 0 <= key < self.num_params:
            raise ValueError(f"key {key} outside [0, {self.num_params})")
        return key // self.span

    def split_dense(self, msg: GradientMessage) -> list[GradientMessage]:
        """One dense slice per shard (full-range input): the owning
        shard's range and that view of the values."""
        values = msg.values
        return [GradientMessage(vector_clock=msg.vector_clock,
                                key_range=rng,
                                values=values[rng.start:rng.end],
                                worker_id=msg.worker_id)
                for rng in self.ranges]

    def split_sparse(self, msg: GradientMessage) -> list[SparseDeltaMessage]:
        """Route a top-k encoded delta by index range: shard i receives
        the (index, value) pairs in its range as local offsets, sorted by
        index (a stable sort, the wire's canonical form); a shard outside
        the survivor set gets an empty slice."""
        idx, vals = msg.encoded.parts
        idx = torch.as_tensor(idx).to(torch.int32)
        vals = torch.as_tensor(vals, device=idx.device).to(torch.float32)
        order = torch.argsort(idx, stable=True)
        idx, vals = idx[order], vals[order]
        bounds = torch.tensor([r.start for r in self.ranges]
                              + [self.num_params], dtype=torch.int32,
                              device=idx.device)
        cuts = torch.searchsorted(idx, bounds).tolist()
        return [SparseDeltaMessage(
                    vector_clock=msg.vector_clock, key_range=rng,
                    indices=idx[cuts[i]:cuts[i + 1]] - rng.start,
                    values=vals[cuts[i]:cuts[i + 1]],
                    worker_id=msg.worker_id)
                for i, rng in enumerate(self.ranges)]


class ShardRouter:
    """Worker-side delta splitter and redelivery cache (one per worker).

    `send(shard_id, slice)` is the transport: the shared fabric in
    process, the shard's bridge in a worker process.  The cache keeps the
    last `cache_clocks` clocks' slices, so a recovering shard that
    redelivers an old weights slice gets the same gradient slices again
    (a recompute after the buffer moved on would diverge the shards)."""

    def __init__(self, plan: ShardPlan,
                 send: Callable[[int, object], None],
                 cache_clocks: int = 64):
        self.plan = plan
        self._send = send
        self._cache: OrderedDict[int, list] = OrderedDict()
        self._cache_clocks = cache_clocks
        self.resent = 0                  # slices sent again by resend

    def route(self, msg: GradientMessage) -> None:
        r = msg.key_range
        if r.start != 0 or r.end != self.plan.num_params:
            raise ValueError(
                f"router expects full-range deltas, got [{r.start}, {r.end})")
        enc = msg.encoded
        if enc is not None and enc.codec_id == CODEC_TOPK:
            slices = self.plan.split_sparse(msg)
        else:
            slices = self.plan.split_dense(msg)
        self._cache[msg.vector_clock] = slices
        while len(self._cache) > self._cache_clocks:
            self._cache.popitem(last=False)
        for shard_id, s in enumerate(slices):
            self._send(shard_id, s)

    def resend(self, shard_id: int, clock: int) -> bool:
        """Send `shard_id` every cached slice at clocks >= `clock`,
        ascending; True when anything went.  A recovering shard is behind
        by every slice from `clock` on, and its duplicate filter drops
        what had got through, so resending the tail is always safe."""
        sent = False
        count = 0
        for c in sorted(self._cache):
            if c >= clock:
                self._send(shard_id, self._cache[c][shard_id])
                self.resent += 1
                sent = True
                count += 1
        if FLIGHT.enabled:
            FLIGHT.record("router.resend", shard=shard_id,
                          from_clock=clock, count=count)
        return sent


class WeightsAssembler:
    """Worker-side reassembly of per-shard weights slices: once every
    shard has sent its slice at one clock, the full-range message goes to
    `deliver(worker, msg)`, once per clock.  A slice at a clock <= the
    last delivered one calls `resend(shard, worker, clock)`."""

    def __init__(self, plan: ShardPlan,
                 deliver: Callable[[int, WeightsMessage], None],
                 resend: Callable[[int, int, int], bool] | None = None):
        self.plan = plan
        self._deliver = deliver
        self._resend = resend
        self._slices: dict[int, dict[int, WeightsMessage]] = {}
        self._delivered: dict[int, int] = {}
        self.stale = 0                   # redelivered slices seen

    def offer(self, shard_id: int, worker: int,
              msg: WeightsMessage) -> bool:
        """Feed one shard's slice; True when it completed an assembly
        and the full message was delivered."""
        if FLIGHT.enabled:
            FLIGHT.record("shard.weights", shard=shard_id, worker=worker,
                          clock=msg.vector_clock)
        last = self._delivered.get(worker, -1)
        if msg.vector_clock <= last:
            self.stale += 1
            if self._resend is not None:
                self._resend(shard_id, worker, msg.vector_clock)
            return False
        held = self._slices.setdefault(worker, {})
        held[shard_id] = msg            # the latest slice per shard wins
        if len(held) < self.plan.num_shards:
            return False
        clocks = [held[s].vector_clock for s in range(self.plan.num_shards)]
        if min(clocks) != max(clocks):
            return False                # not yet at a common clock
        parts = [held[s].values for s in range(self.plan.num_shards)]
        values = parts[0] if len(parts) == 1 else torch.cat(
            [p.to(parts[0].device) for p in parts])
        full = WeightsMessage(vector_clock=clocks[0],
                              key_range=KeyRange(0, self.plan.num_params),
                              values=values)
        self._slices[worker] = {}
        self._delivered[worker] = clocks[0]
        self._deliver(worker, full)
        return True

    def drop(self, worker: int) -> None:
        """Forget a worker's partial assembly (the eviction purge)."""
        self._slices.pop(worker, None)


class _ShardWeightsFabric(fabric_mod.Fabric):
    """The send side each in-process shard node sees: weights slices go
    to the shared assembler (which sends the full message on the real
    fabric), gang notices pass from shard 0 only (every shard releases
    the same sets), everything else goes to the inner fabric."""

    def __init__(self, inner: fabric_mod.Fabric, shard_id: int,
                 assembler: WeightsAssembler, forward_gang: bool):
        super().__init__()
        self._inner = inner
        self._shard_id = shard_id
        self._assembler = assembler
        self._forward_gang = forward_gang

    def send(self, topic: str, key: int, message) -> None:
        if topic == fabric_mod.WEIGHTS_TOPIC:
            self._assembler.offer(self._shard_id, key, message)
            return
        self._inner.send(topic, key, message)

    def send_transient(self, topic: str, key: int, message) -> None:
        if topic == fabric_mod.GANG_TOPIC and not self._forward_gang:
            return
        self._inner.send_transient(topic, key, message)

    def pending(self, topic: str, key: int = 0) -> int:
        if topic == fabric_mod.WEIGHTS_TOPIC:
            return 0        # slices never queue; assembly is immediate
        return self._inner.pending(topic, key)

    def purge(self, topic: str, key: int, pred) -> int:
        if topic == fabric_mod.WEIGHTS_TOPIC:
            self._assembler.drop(key)
            return 0
        return self._inner.purge(topic, key, pred)


class ShardedServerGroup:
    """N range-sharded ServerNodes behind one facade, on `device`.

    N=1 is the unsharded server: the same class, arguments and fabric
    keys.  N>1: shard i owns plan.ranges[i], polls (GRADIENTS_TOPIC, i)
    and sends weights slices through the assembler.  The group evaluates
    and checkpoints at the common clock frontier (the minimum over the
    shards of their stable clocks): the concatenation of the shards'
    slices there is the full vector."""

    def __init__(self, cfg, fabric: fabric_mod.Fabric, num_shards: int,
                 device=None, test_x=None, test_y=None, log=None,
                 tracer=None, telemetry=None):
        from kafka_ps_tpu_torch.models.task import get_task
        from kafka_ps_tpu_torch.utils.config import resolve_device
        self.cfg = cfg
        self.fabric = fabric
        self.device = resolve_device(device)
        self.task = get_task(cfg.task, cfg.model)
        self.plan = ShardPlan(self.task.num_params, num_shards)
        if test_x is not None:
            test_x = torch.as_tensor(test_x, dtype=torch.float32,
                                     device=self.device)
            test_y = torch.as_tensor(test_y, dtype=torch.int32,
                                     device=self.device)
        self.test_x = test_x
        self.test_y = test_y
        self.log = log or (lambda line: None)
        self.tracer = tracer
        self.telemetry = telemetry
        self.routers: dict[int, ShardRouter] = {}
        self._eval_clock = -1
        self.eval_engine = None
        self._cut_publisher = None      # attach_serving at N>1
        if num_shards == 1:
            node = ServerNode(cfg, fabric, self.device, test_x, test_y,
                              self.log, tracer=tracer, telemetry=telemetry)
            self.shards = [node]
            self.single: ServerNode | None = node
            self.assembler = None
            return
        self.single = None
        self.assembler = WeightsAssembler(
            self.plan,
            deliver=lambda w, m: fabric.send(fabric_mod.WEIGHTS_TOPIC, w, m),
            resend=self._resend_slice)
        self.shards = [
            ServerNode(cfg, _ShardWeightsFabric(fabric, i, self.assembler,
                                                forward_gang=(i == 0)),
                       self.device, key_range=rng, shard_id=i,
                       num_shards=num_shards, grad_key=i, tracer=tracer,
                       telemetry=telemetry)
            for i, rng in enumerate(self.plan.ranges)]

    # -- worker wiring -----------------------------------------------------

    def attach_workers(self, workers) -> None:
        """Give each worker a ShardRouter over this group's fabric keys;
        N=1 leaves the workers' unsharded send."""
        if self.plan.num_shards == 1:
            return
        for w in workers:
            router = ShardRouter(
                self.plan,
                send=lambda sid, m: self.fabric.send(
                    fabric_mod.GRADIENTS_TOPIC, sid, m))
            w.shard_router = router
            self.routers[w.worker_id] = router

    def _resend_slice(self, shard_id: int, worker: int, clock: int) -> bool:
        router = self.routers.get(worker)
        return router.resend(shard_id, clock) if router else False

    # -- group state -------------------------------------------------------

    @property
    def iterations(self) -> int:
        """Fully applied deltas: every delta reaches every shard (empty
        slices included), so the slowest shard's count."""
        return min(s.iterations for s in self.shards)

    def frontier_clock(self) -> int:
        """The minimum over the shards of their stable clocks: every
        shard has applied every round below it."""
        return min(s.serving_clock() for s in self.shards)

    def assembled_theta(self) -> torch.Tensor:
        """The shards' slices concatenated in shard-id order (a new
        tensor; the slices stay as they are)."""
        return torch.cat([s.theta for s in self.shards])

    def snapshot_cut(self) -> list[tuple]:
        """The consistent cut, read at a quiescent point of the drive
        loop: per shard (a zero-argument reader of its slice, its stable
        clock), in shard-id order.  The reader is lazy: a tiered slice
        is assembled (its cold pages read) only for a cut that
        publishes."""
        return [((lambda s=s: s.theta), s.serving_clock())
                for s in self.shards]

    def attach_param_stores(self, make_store) -> None:
        """Tiered residency per shard (store/): each shard gets its own
        TieredParamStore over its range, built by `make_store(shard)`, so
        the caller picks per-shard caps and cold partitions (residency is
        a per-process resource)."""
        for s in self.shards:
            s.attach_param_store(make_store(s))

    def attach_serving(self, registry) -> None:
        """Serve the group from `registry`: at N=1 the node publishes at
        every release (the unsharded plane); at N>1 `publish_frontier`
        publishes consistent cuts of the assembled theta."""
        if self.single is not None:
            self.single.serving = registry
            return
        from kafka_ps_tpu_torch.serving.snapshot import FrontierCutPublisher
        self._cut_publisher = FrontierCutPublisher(registry)

    def publish_frontier(self) -> None:
        """Publish a cut if the frontier advanced.  Called by the drive
        loop between passes, where no shard is mid-apply."""
        if self._cut_publisher is not None:
            self._cut_publisher.maybe_publish(self.snapshot_cut())

    # -- eval at the frontier ----------------------------------------------

    def enable_async_eval(self):
        """Attach the async eval engine (evaluation/engine.py): at N=1 to
        the node, as the app does; at N>1 to the group's frontier eval,
        which then submits the assembled theta.  Idempotent; returns the
        engine (None without a test set)."""
        if self.eval_engine is not None or self.test_x is None:
            return self.eval_engine
        from kafka_ps_tpu_torch.evaluation.engine import EvalEngine
        if self.single is not None:
            self.eval_engine = self.single.attach_eval_engine(EvalEngine(
                self.task, self.test_x, self.test_y,
                self.single._emit_eval, telemetry=self.telemetry,
                tracer=self.tracer))
        else:
            self.eval_engine = EvalEngine(
                self.task, self.test_x, self.test_y, self._emit_eval,
                telemetry=self.telemetry, tracer=self.tracer)
        return self.eval_engine

    def close_eval(self) -> None:
        """Evaluate what is pending and join the engine thread."""
        if self.eval_engine is not None:
            self.eval_engine.close()

    def _emit_eval(self, clock: int, m) -> None:
        """The group's eval row, the server schema (partition -1)."""
        from kafka_ps_tpu_torch.utils import asynclog
        asynclog.submit_or_write(
            self.log,
            # pscheck: disable=PS104 (CSV wall-clock column, not replay state)
            f"{int(time.time() * 1000)};-1;{clock};"
            "{};{};{}", m.loss, m.f1, m.accuracy)

    def maybe_eval(self) -> None:
        """At N>1: when the frontier of worker 0's clock over the shards
        crosses the eval cadence, evaluate the assembled theta and emit
        the server row (the theta at the frontier moment, not each
        shard's mid-round prefix).  N=1 evaluates in the node."""
        if self.single is not None or self.test_x is None:
            return
        frontier0 = min(s.tracker.tracker[0].vector_clock
                        for s in self.shards)
        latest = frontier0 - (frontier0 % self.cfg.eval_every)
        if latest <= self._eval_clock or latest < 0:
            return
        self._eval_clock = latest
        theta = self.assembled_theta()          # a new tensor: owned
        if self.eval_engine is not None:
            self.eval_engine.submit(theta, latest)
            return
        self._emit_eval(latest, self.task.evaluate(theta, self.test_x,
                                                   self.test_y))

    # -- checkpoints -------------------------------------------------------

    def set_checkpoint(self, path: str, every: int = 50) -> None:
        """One checkpoint file per shard (utils/checkpoint.
        shard_state_path): its slice, clocks and log offsets."""
        from kafka_ps_tpu_torch.utils import checkpoint as ckpt
        for i, s in enumerate(self.shards):
            s.checkpoint_path = ckpt.shard_state_path(
                path, i, self.plan.num_shards)
            s.checkpoint_every = every

    def maybe_restore(self) -> bool:
        from kafka_ps_tpu_torch.utils import checkpoint as ckpt
        restored = False
        for s in self.shards:
            if s.checkpoint_path:
                restored |= ckpt.maybe_restore(s.checkpoint_path, s)
        return restored

    def save_checkpoint_now(self) -> None:
        for s in self.shards:
            s.save_checkpoint_now()

    # -- drive loop --------------------------------------------------------

    def start(self) -> None:
        for s in self.shards:
            s.start_training_loop()
        self.publish_frontier()

    def run_serial(self, workers, max_server_iterations: int,
                   pump=None) -> None:
        """Deterministic serial scheduler, the app's alternation without
        gangs: weights delivery in worker order, then each shard's
        gradients in shard-id order."""
        self.attach_workers(workers)
        self.start()
        stalled = 0
        while self.iterations < max_server_iterations:
            progressed = False
            for worker in workers:
                msg = self.fabric.poll(fabric_mod.WEIGHTS_TOPIC,
                                       worker.worker_id)
                if msg is not None:
                    worker.on_weights(msg)
                    progressed = True
            for sid, shard in enumerate(self.shards):
                key = 0 if self.single is not None else sid
                while shard.iterations < max_server_iterations:
                    g = self.fabric.poll(fabric_mod.GRADIENTS_TOPIC, key)
                    if g is None:
                        break
                    shard.process(g)
                    progressed = True
            self.maybe_eval()
            self.publish_frontier()
            if pump is not None:
                pump()
            stalled = 0 if progressed else stalled + 1
            if stalled > (1000 if pump is not None else 0):
                raise RuntimeError(
                    "deadlock: no deliverable messages in sharded group")
