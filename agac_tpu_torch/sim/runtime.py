"""SimClock + SimScheduler: the discrete-event core.

A single real thread owns the whole simulated world.  Virtual time is
a number that only moves two ways:

- the scheduler dispatches the earliest pending event and jumps the
  clock to its deadline;
- code running INSIDE an event calls ``sleep`` (through the clock
  seam), which advances the clock in place — the discrete-event
  equivalent of a busy thread holding its core.  No nested dispatch
  happens during a sleep; timers that come due while an event sleeps
  fire right after it returns, in deadline order.  This is what makes
  re-entrancy (and therefore deadlock) structurally impossible, and it
  is also exactly how a saturated single-core machine behaves.

Determinism: the ready queue is ordered by ``(deadline, priority,
sequence)`` — sequence is allocation order, so equal-deadline events
run in registration order, every run.  Every dispatch and sleep folds
into a rolling SHA-256 **event-trace hash**; two runs of the same
scenario from the same seed produce the same hash, which is the replay
contract the fuzzer's failure artifacts rely on.  (Within one process
this holds unconditionally; across processes set ``PYTHONHASHSEED``
so set-iteration order in application code cannot diverge.)

Recurring timers **coalesce**: a timer whose period was slept past
fires once and reschedules from *now*, rather than replaying every
missed tick — a 3-hour virtual sleep does not unleash 10,800 settle
polls.
"""

from __future__ import annotations

import contextlib
import hashlib
import heapq
from collections import deque
from typing import Callable, Generator, Iterator, Optional

from .. import clockseam

# epoch base for the virtual wall clock: an arbitrary fixed instant
# (2026-01-01T00:00:00Z) so persisted timestamps are stable run-to-run
SIM_EPOCH = 1767225600.0

# how many recent trace entries are kept readable for debugging and
# failure artifacts (the hash covers ALL entries regardless)
TRACE_TAIL = 4096


class SimClock:
    """The virtual clock, shaped like the seams the stack injects:
    ``monotonic`` / ``time`` / ``sleep``."""

    def __init__(self, scheduler: "SimScheduler"):
        self._scheduler = scheduler

    def monotonic(self) -> float:
        return self._scheduler.now

    def time(self) -> float:
        return SIM_EPOCH + self._scheduler.now

    def sleep(self, seconds: float) -> None:
        self._scheduler.consume(seconds)


class _Event:
    __slots__ = ("deadline", "priority", "seq", "name", "fn", "interval", "cancelled")

    def __init__(self, deadline, priority, seq, name, fn, interval):
        self.deadline = deadline
        self.priority = priority
        self.seq = seq
        self.name = name
        self.fn = fn
        self.interval = interval  # None = one-shot
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class SimScheduler:
    """Deterministic event heap + virtual clock + trace hash."""

    def __init__(self, start: float = 0.0):
        self.now = start
        self.clock = SimClock(self)
        self._heap: list[tuple[float, int, int, _Event]] = []
        self._seq = 0
        self._hash = hashlib.sha256()
        self.events_dispatched = 0
        self.slept_virtual = 0.0
        self.trace_tail: deque[str] = deque(maxlen=TRACE_TAIL)

    # ------------------------------------------------------------------
    # clock views
    # ------------------------------------------------------------------
    def monotonic(self) -> float:
        return self.now

    def time(self) -> float:
        return SIM_EPOCH + self.now

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------
    def _push(self, event: _Event) -> None:
        heapq.heappush(
            self._heap, (event.deadline, event.priority, event.seq, event)
        )

    def call_at(
        self, deadline: float, fn: Callable[[], None], name: str, priority: int = 0
    ) -> _Event:
        """One-shot event at an absolute virtual time (clamped to now)."""
        self._seq += 1
        event = _Event(max(deadline, self.now), priority, self._seq, name, fn, None)
        self._push(event)
        return event

    def call_after(
        self, delay: float, fn: Callable[[], None], name: str, priority: int = 0
    ) -> _Event:
        return self.call_at(self.now + max(delay, 0.0), fn, name, priority)

    def every(
        self,
        interval: float,
        fn: Callable[[], None],
        name: str,
        priority: int = 0,
        first_after: Optional[float] = None,
    ) -> _Event:
        """Recurring event; missed periods coalesce (see module doc)."""
        if interval <= 0:
            raise ValueError(f"recurring event {name!r} needs interval > 0")
        self._seq += 1
        first = self.now + (interval if first_after is None else max(first_after, 0.0))
        event = _Event(first, priority, self._seq, name, fn, interval)
        self._push(event)
        return event

    def spawn(self, gen: Generator[float, None, None], name: str) -> None:
        """Run a cooperative actor: a generator that yields the delay
        (virtual seconds) until its next step.  Each resume is an
        ordinary event, so actor steps interleave deterministically
        with timers and with each other."""

        def resume():
            try:
                delay = next(gen)
            except StopIteration:
                return
            self.call_after(float(delay), resume, name)

        self.call_after(0.0, resume, name)

    # ------------------------------------------------------------------
    # time advancement
    # ------------------------------------------------------------------
    def consume(self, seconds: float) -> None:
        """Advance virtual time in place — the sleep seam.  Called
        from inside a dispatched event (or between events); never
        dispatches, so it cannot re-enter application code."""
        if seconds <= 0:
            return
        self.now += seconds
        self.slept_virtual += seconds
        self._record("sleep", f"{seconds:.6f}")

    def advance_to(self, deadline: float) -> None:
        """Idle the clock forward to ``deadline`` (no-op if past)."""
        if deadline > self.now:
            self.now = deadline

    def next_deadline(self) -> Optional[float]:
        """Earliest pending event's deadline, skipping cancelled."""
        while self._heap and self._heap[0][3].cancelled:
            heapq.heappop(self._heap)
        return self._heap[0][0] if self._heap else None

    def step(self) -> bool:
        """Dispatch exactly one event (the earliest); False when the
        heap is empty.  The clock jumps to the event's deadline; the
        event may consume further virtual time while running."""
        while self._heap:
            _, _, _, event = heapq.heappop(self._heap)
            if event.cancelled:
                continue
            if event.deadline > self.now:
                self.now = event.deadline
            self.events_dispatched += 1
            self._record("event", event.name)
            event.fn()
            if event.interval is not None and not event.cancelled:
                # coalescing reschedule: next tick measured from NOW
                # (which the handler may have advanced), never from the
                # original phase — missed periods collapse into one
                event.deadline = self.now + event.interval
                self._push(event)
            return True
        return False

    # ------------------------------------------------------------------
    # the event-trace hash (the replay contract)
    # ------------------------------------------------------------------
    def _record(self, kind: str, detail: str) -> None:
        line = f"{self.now:.6f}|{kind}|{detail}"
        self._hash.update(line.encode())
        self._hash.update(b"\n")
        self.trace_tail.append(line)

    def record(self, kind: str, detail: str) -> None:
        """Fold an application-level observation into the trace — the
        harness records every worker step and informer delta so the
        hash covers the full interleaving, not just timer firings."""
        self._record(kind, detail)

    def trace_hash(self) -> str:
        return self._hash.hexdigest()


@contextlib.contextmanager
def installed(scheduler: SimScheduler) -> Iterator[SimScheduler]:
    """Install the scheduler's clock into the process-wide clock seam
    (``agac_tpu_torch/clockseam.py``) for the duration of the block.  With
    ``threads=False`` every thread-optional component (workqueue delay
    wakers, event-recorder persistence workers) constructed inside
    falls back to synchronous, scheduler-pumped operation."""
    clock = scheduler.clock
    clockseam.install(
        monotonic=clock.monotonic, wall=clock.time, sleep=clock.sleep, threads=False
    )
    try:
        yield scheduler
    finally:
        clockseam.reset()
