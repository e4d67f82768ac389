"""Deferred log formatting (counterpart of kafka_ps_tpu/utils/asynclog.py).

The CSV rows of the hot path carry loss / F1 / accuracy that are still
being computed on the card.  A DeferredSink keeps the LINE order of a
plain sink while those fields stay device tensors:

  * the training thread only appends: it records a CUDA event after the
    work that produces the row's tensors, and never waits;
  * a background drain thread pops the longest prefix whose events have
    completed and moves all its scalars in one stacked `.cpu()` per
    device, overlapping the fetch with further training;
  * flush() forces everything out (drive loops call it on exit) and
    returns the number of rows it wrote.

Every value is turned into a Python float before formatting, so a
tensor's repr never reaches the CSV.

FIFO across threads is kept by a ticket turnstile: a batch takes its
ticket atomically with popping its entries, formats and fetches outside
any lock, and writes when the turnstile reaches its ticket.
"""

from __future__ import annotations

import sys
import threading
from collections import deque

import torch

from kafka_ps_tpu_torch.analysis.lockgraph import OrderedCondition, OrderedLock

# a backlog longer than this is flushed by the submitter in one batch
MAX_PENDING = 4096
# seconds between the drain thread's polls of the completion events
DRAIN_INTERVAL_S = 0.25
# the drain thread exits after this many idle seconds (the next submit
# restarts it), so idle sinks hold no thread
IDLE_EXIT_S = 10.0


def _cuda_event(values):
    """A completion event for the row's CUDA tensors, or None when it
    holds none (CPU tensors and numbers are ready at once)."""
    for v in values:
        if isinstance(v, torch.Tensor) and v.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(v.device))
            return event
    return None


def _fetch(tensors: list[torch.Tensor]) -> dict[int, float]:
    """id(tensor) → float for scalar tensors: one stacked copy to the
    host per device."""
    by_device: dict[torch.device, list[torch.Tensor]] = {}
    for t in tensors:
        by_device.setdefault(t.device, []).append(t)
    out: dict[int, float] = {}
    for group in by_device.values():
        host = torch.stack([t.detach().reshape(()).to(torch.float32)
                            for t in group]).cpu().tolist()
        for t, value in zip(group, host):
            out[id(t)] = value
    return out


class DeferredSink:
    """Wraps a line sink; lines may carry unresolved device scalars.

    submit(template, *values): enqueue `template.format(*values)` where
    each value may be a scalar tensor, fetched when it resolves.
    __call__(line): emit an already-formatted line (kept in FIFO with
    deferred entries).  flush(): force-emit everything.
    """

    def __init__(self, sink):
        self._sink = sink
        self._pending: deque = deque()    # (template, values, event)
        # guards _pending, tickets, _thread
        self._lock = OrderedLock("DeferredSink.pending")
        self._turn_cv = OrderedCondition("DeferredSink.turn")
        self._next_ticket = 0
        self._turn = 0
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- producer side ------------------------------------------------------

    def submit(self, template: str, *values) -> None:
        event = _cuda_event(values)
        with self._lock:
            self._pending.append((template, values, event))
            n = len(self._pending)
        self._ensure_thread()
        if n > MAX_PENDING:
            self.flush()             # backlogged: pay one batched fetch

    def __call__(self, line: str) -> None:
        with self._lock:
            if self._pending or self._thread is not None:
                self._pending.append((line, (), None))
                return
            ticket = self._take_ticket_locked()
        self._emit_in_turn(ticket, (line,))

    # -- drain side ---------------------------------------------------------

    def _ensure_thread(self) -> None:
        with self._lock:
            t = self._thread
            if t is None or not t.is_alive():
                self._thread = threading.Thread(
                    target=self._drain_loop, daemon=True,
                    name="kps-log-drain")
                self._thread.start()

    def _drain_loop(self) -> None:
        idle = 0.0
        while not self._stop.is_set():
            self._wake.wait(timeout=DRAIN_INTERVAL_S)
            self._wake.clear()
            try:
                self._drain_ready()
            except Exception as e:   # rows went back to the queue
                print(f"log drain error, rows kept for the next drain: "
                      f"{e!r}", file=sys.stderr)
            with self._lock:
                if self._pending:
                    idle = 0.0
                    continue
                idle += DRAIN_INTERVAL_S
                if idle >= IDLE_EXIT_S:
                    if self._thread is threading.current_thread():
                        self._thread = None
                    return

    def _take_ticket_locked(self) -> int:
        """Issue the next turnstile ticket; caller holds _lock.  Every
        ticket taken must reach _emit_in_turn, even on error."""
        ticket = self._next_ticket
        self._next_ticket += 1
        return ticket

    def _emit_in_turn(self, ticket: int, lines) -> None:
        """Write `lines` when the turnstile reaches `ticket`; always
        advances the turn."""
        with self._turn_cv:
            self._turn_cv.wait_for(lambda: self._turn == ticket)
            try:
                for line in lines:
                    self._sink(line)
            finally:
                self._turn += 1
                self._turn_cv.notify_all()

    def _drain_ready(self) -> None:
        with self._lock:
            ready = []
            while self._pending:
                event = self._pending[0][2]
                if event is not None and not event.query():
                    break
                ready.append(self._pending.popleft())
            if not ready:
                return
            ticket = self._take_ticket_locked()
        lines: list[str] = []
        try:
            lines = self._format_entries(ready)
        except Exception:
            # back to the head of the queue: the next drain or flush
            # retries them, and a flush raises if the fault persists.
            # Only a flush racing this failed drain can emit later rows
            # before these.
            with self._lock:
                self._pending.extendleft(reversed(ready))
            raise
        finally:
            self._emit_in_turn(ticket, lines)

    @staticmethod
    def _format_entries(entries) -> list[str]:
        fetched = _fetch([v for _, values, _ in entries for v in values
                          if isinstance(v, torch.Tensor)])

        def resolve(v) -> float:
            if isinstance(v, torch.Tensor):
                return fetched[id(v)]
            return float(v)

        return [template.format(*(resolve(v) for v in values))
                if values else template
                for template, values, _ in entries]

    def flush(self) -> int:
        """Emit every pending row now; returns how many rows it fetched,
        formatted and wrote (rows the drain thread took are not
        counted)."""
        with self._lock:
            entries = list(self._pending)
            self._pending.clear()
            # a ticket even when empty: flush doubles as an emission
            # barrier for batches popped before it
            ticket = self._take_ticket_locked()
        lines: list[str] = []
        try:
            if entries:
                lines = self._format_entries(entries)
        finally:
            self._emit_in_turn(ticket, lines)
        return len(lines)

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        with self._lock:
            t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=60.0)
        self.flush()
        close = getattr(self._sink, "close", None)
        if close is not None:
            close()


def submit_or_write(log, template: str, *values) -> None:
    """Route a log line through a DeferredSink when the sink supports
    it, else format at once (plain sinks, test list-appenders)."""
    if hasattr(log, "submit"):
        log.submit(template, *values)
    else:
        log(template.format(*(float(v) for v in values)))
