"""Async eval engine (counterpart of kafka_ps_tpu/evaluation/engine.py):
test-set evaluation off the server's apply path.

  * The server hands over `(theta, clock)` with an O(1) append.  thetas
    are immutable device tensors (the server only ever REPLACES theta),
    so the hand-off copies nothing and waits on nothing.
  * A `kps-eval` thread pops the backlog, up to `coalesce_width_cap`
    thetas at a time, and evaluates them with the task's
    `evaluate_batch`, which runs the standalone `evaluate` once per
    theta: torch does not promise that one stacked product equals k
    single ones bit for bit, so every row is bitwise the fused path's
    row by construction.  (A stacked one-product eval with a stated
    tolerance is later speed work.)
  * Results are emitted in strict clock order through the same emission
    point the fused path uses (`ServerNode._emit_eval`): the same CSV
    rows.

The thread is lazy and self-reaping: started by the first submit, gone
after IDLE_EXIT_S idle seconds, restarted by the next submit.  `close()`
joins it — a thread left inside CUDA at interpreter exit aborts.  A
backlog past MAX_PENDING makes the SUBMITTER drain (every clock owes a
row, so nothing is dropped; each queued theta pins a device tensor).  A
failed evaluation is kept and raised by the next `drain()` or `close()`
on the caller's thread.

Telemetry (tracer=, telemetry=; null by default): each batch is a
`server.eval` span (`coalesced=k`) with an `eval.dispatch_async` count,
the `eval_coalesce_width` histogram and an `eval.dispatch` flight
record; the `eval_lag_clocks` gauge follows the backlog.  `stats()`
backs the health plane's /evalz.
"""

from __future__ import annotations

import threading
from collections import deque

import torch

from kafka_ps_tpu_torch.analysis.lockgraph import OrderedCondition
from kafka_ps_tpu_torch.telemetry.flight import FLIGHT
from kafka_ps_tpu_torch.telemetry.registry import NULL_TELEMETRY
from kafka_ps_tpu_torch.utils.trace import NULL_TRACER

# the eval_coalesce_width histogram's buckets (thetas per batch)
WIDTH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0)

# backlog past which `submit` drains on the submitter's thread
MAX_PENDING = 64
# idle seconds after which the engine thread exits
IDLE_EXIT_S = 10.0
# hard ceiling on the thetas popped as one batch
MAX_COALESCE = 32

# Byte budget of one popped batch on the H100: per theta, the theta and
# one f32 score per test row, kept within half of the card's 50 MB L2.
# Today `evaluate_batch` runs one standalone eval per theta, so the width
# changes neither the rows nor the device work, only how many thetas one
# poll takes (and the width statistics).  The budget is there for the
# stacked one-product eval ROADMAP lists as later work, whose [width, P]
# weights and [width, n_test] scores must stay L2-resident beside the
# test set it streams.
EVAL_BYTE_BUDGET = 25 * 1024 * 1024


def coalesce_width_cap(num_params: int, n_test: int) -> int:
    """Widest power-of-two batch whose working set — per theta, the
    theta and one f32 per test row — stays within EVAL_BYTE_BUDGET, at
    least 1 and at most MAX_COALESCE."""
    lane_bytes = 4 * (int(num_params) + int(n_test))
    cap = max(1, EVAL_BYTE_BUDGET // max(lane_bytes, 1))
    width = 1
    while width * 2 <= min(cap, MAX_COALESCE):
        width *= 2
    return width


class EvalEngine:
    """Dedicated eval thread over a bounded (theta, clock) queue.

    `emit(clock, metrics)` is called on the engine thread (or the
    draining caller's) in strict clock order; the caller owns row
    formatting and timestamps."""

    def __init__(self, task, test_x, test_y, emit, *, telemetry=None,
                 tracer=None):
        self.tracer = tracer or NULL_TRACER
        self.telemetry = telemetry or NULL_TELEMETRY
        self._m_lag = self.telemetry.gauge(
            "eval_lag_clocks",
            help_text="newest submitted eval clock minus newest "
                      "evaluated eval clock (async eval backlog)")
        self._m_width = self.telemetry.histogram(
            "eval_coalesce_width", buckets=WIDTH_BUCKETS,
            help_text="pending thetas coalesced per batched eval "
                      "dispatch")
        self._task = task
        self._tx = test_x
        self._ty = test_y
        self._emit = emit
        self._max_width = coalesce_width_cap(task.num_params,
                                             test_x.shape[0])
        self._pending: deque = deque()
        self._cv = OrderedCondition("EvalEngine.pending")
        self._inflight = 0           # popped but not yet emitted
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        # host-side counters for /evalz (telemetry/health.py)
        # guarded-by: _cv (submit writes hold the cv; reads are int snapshots)
        self._submitted_clock = -1
        # pscheck: disable=PS201 (dispatch-side monotonic clock; lag/stats reads tolerate a one-batch-stale snapshot)
        self._evaluated_clock = -1
        self._dispatches = 0
        self._evals = 0
        self._width_counts: dict[int, int] = {}

    # -- producer side (the server's apply path) -------------------------

    def submit(self, theta: torch.Tensor, clock: int) -> None:
        """O(1) hand-off of an immutable theta at an eval-cadence clock.
        A backlog past MAX_PENDING drains before returning."""
        clock = int(clock)  # pscheck: disable=PS102 (the gate's clock is a host int; the coercion only normalizes a numpy int)
        with self._cv:
            self._pending.append((theta, clock))
            self._submitted_clock = clock
            backlog = len(self._pending)
            self._cv.notify_all()
        if self.telemetry.enabled:
            self._m_lag.set(self._submitted_clock - self._evaluated_clock)
        self._ensure_thread()
        if backlog > MAX_PENDING:
            self.drain()

    @property
    def lag_clocks(self) -> int:
        """Newest submitted eval clock minus newest evaluated one: 0 when
        every submitted clock has been evaluated."""
        if self._submitted_clock < 0:
            return 0
        return self._submitted_clock - self._evaluated_clock

    # -- the kps-eval thread ---------------------------------------------

    def _ensure_thread(self) -> None:
        with self._cv:
            t = self._thread
            if t is None or not t.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="kps-eval")
                self._thread.start()

    def _loop(self) -> None:
        if self._tx.is_cuda:
            # a new thread has no current CUDA context until it sets one
            torch.cuda.set_device(self._tx.device)
        idle = 0.0
        tick = 0.25
        while not self._stop.is_set():
            with self._cv:
                if not self._pending:
                    self._cv.wait(timeout=tick)
            if self.poll():
                idle = 0.0
                continue
            idle += tick
            if idle >= IDLE_EXIT_S:
                with self._cv:
                    if self._pending:
                        idle = 0.0
                        continue
                    if self._thread is threading.current_thread():
                        self._thread = None
                    return

    def poll(self) -> bool:
        """Pop up to one batch and evaluate it.  Returns whether anything
        was popped.  The engine thread's step; tests and close() call it
        directly for dispatch on the calling thread."""
        with self._cv:
            if not self._pending:
                return False
            batch = []
            while self._pending and len(batch) < self._max_width:
                batch.append(self._pending.popleft())
            self._inflight = len(batch)
        try:
            self._dispatch(batch)
        except Exception as e:      # raised again by drain() / close()
            with self._cv:
                if self._error is None:
                    self._error = e
        finally:
            with self._cv:
                self._inflight = 0
                self._cv.notify_all()
        return True

    def _dispatch(self, batch) -> None:
        """The standalone evaluation of every popped theta, then emission
        in clock order."""
        k = len(batch)
        clock_lo, clock_hi = batch[0][1], batch[-1][1]
        with self.tracer.span("server.eval", clock=clock_hi, coalesced=k):
            mets = self._task.evaluate_batch([theta for theta, _ in batch],
                                             self._tx, self._ty)
            self.tracer.count("eval.dispatch_async")
        with self._cv:
            self._dispatches += 1
            self._evals += k
            self._width_counts[k] = self._width_counts.get(k, 0) + 1
        if self.telemetry.enabled:
            self._m_width.observe(k)
        if FLIGHT.enabled:
            FLIGHT.record("eval.dispatch", width=k,
                          clock_lo=clock_lo, clock_hi=clock_hi)
        for i, (_, clock) in enumerate(batch):
            self._emit(clock, type(mets)(*(field[i] for field in mets)))
            self._evaluated_clock = clock
        if self.telemetry.enabled:
            self._m_lag.set(max(
                0, self._submitted_clock - self._evaluated_clock))

    # -- lifecycle / introspection ---------------------------------------

    def _raise_error(self) -> None:
        with self._cv:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("eval engine: an evaluation failed") from err

    def drain(self, timeout: float = 120.0) -> None:
        """Block until every submitted clock has been evaluated and its
        row handed to `emit`; raises a failed evaluation's error."""
        if not self._stop.is_set():
            # the engine thread stays the only poller: emission order
            self._ensure_thread()
            with self._cv:
                ok = self._cv.wait_for(
                    lambda: not self._pending and self._inflight == 0,
                    timeout=timeout)
            if not ok:
                raise TimeoutError("eval engine drain timed out")
        else:
            while self.poll():
                pass
        self._raise_error()

    def close(self) -> None:
        """Stop and join the kps-eval thread, then evaluate anything
        still pending on the caller's thread."""
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
            t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=60.0)
            if t.is_alive():
                raise RuntimeError("eval engine thread did not stop")
        while self.poll():
            pass
        self._raise_error()

    def stats(self) -> dict:
        """Host-side counters: backlog, clocks, dispatches and widths."""
        with self._cv:
            pending = len(self._pending) + self._inflight
            return {
                "pending": pending,
                "submitted_clock": self._submitted_clock,
                "evaluated_clock": self._evaluated_clock,
                "lag_clocks": self.lag_clocks,
                "dispatches": self._dispatches,
                "evals": self._evals,
                "max_width": self._max_width,
                "widths": {str(w): n for w, n in
                           sorted(self._width_counts.items())},
            }
