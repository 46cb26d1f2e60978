"""Rate-limited, deduplicating work queues.

Re-implements the semantics of client-go's ``util/workqueue`` that the
reference relies on everywhere (queues constructed with
``workqueue.NewNamedRateLimitingQueue(workqueue.DefaultControllerRateLimiter(), ...)``,
e.g. reference ``pkg/controller/globalaccelerator/controller.go:64-65``):

- **Dedup FIFO**: an item added while queued is coalesced; an item
  added while being processed is re-queued when ``done`` is called, so
  a given key is never processed concurrently by two workers.
- **Delaying**: ``add_after`` schedules an add in the future
  (used by the kernel for ``Result.requeue_after``,
  reference ``pkg/reconcile/reconcile.go:79-82``).
- **Rate limiting**: ``add_rate_limited`` consults a per-item
  exponential-backoff limiter combined with an overall token bucket —
  the same pair as client-go's ``DefaultControllerRateLimiter``
  (5 ms base doubling to a 1000 s cap, plus a 10 qps / 100 burst
  bucket).  ``forget`` resets the per-item backoff.
"""

from __future__ import annotations

import heapq
import threading
import time
from collections import deque
from typing import Any, Callable, Hashable, Optional

from .. import clockseam
from ..analysis import racecheck
from ..observability import instruments


def watch_adds(drain) -> None:
    """Port-only: route the ``add`` calls the calling thread makes to
    ``drain`` (None stops), as a drift tick's enqueue loop does
    (``controllers/common.py``).  Each accepted add calls
    ``drain.expect()`` at once and ``drain.finished()`` when a reconcile
    of the item that began after the add is done.  The thread object
    carries the drain, so nothing is shared between threads."""
    threading.current_thread().agac_drift_drain = drain


class ItemExponentialFailureRateLimiter:
    """Per-item exponential backoff: base * 2^failures, capped."""

    def __init__(self, base_delay: float = 0.005, max_delay: float = 1000.0):
        self._base = base_delay
        self._max = max_delay
        self._failures: dict[Hashable, int] = {}
        self._lock = threading.Lock()

    def when(self, item: Hashable) -> float:
        with self._lock:
            failures = self._failures.get(item, 0)
            self._failures[item] = failures + 1
        # exponent capped so a persistently failing item can never push
        # 2**failures past float range (OverflowError would swallow the
        # requeue entirely)
        delay = self._base * (2 ** min(failures, 64))
        return min(delay, self._max)

    def forget(self, item: Hashable) -> None:
        with self._lock:
            self._failures.pop(item, None)

    def num_requeues(self, item: Hashable) -> int:
        with self._lock:
            return self._failures.get(item, 0)


class BucketRateLimiter:
    """A token bucket shared by all items (qps with burst).

    ``when`` reserves a token and returns how long the caller must wait
    for it, like golang.org/x/time/rate's ``Reserve().Delay()``.

    ``clock`` is injectable (default ``time.monotonic``) so limiter and
    queue tests drive refill with a fake clock instead of sleeping real
    wall time.
    """

    def __init__(
        self,
        qps: float = 10.0,
        burst: int = 100,
        clock: Optional[Callable[[], float]] = None,
    ):
        self._qps = qps
        self._burst = burst
        self._tokens = float(burst)
        # default: the process clock seam (wall time in production,
        # virtual time under the sim runtime)
        self._clock = clock = clock or clockseam.monotonic
        self._last = clock()
        self._lock = threading.Lock()

    def when(self, item: Hashable) -> float:
        with self._lock:
            now = self._clock()
            self._tokens = min(self._burst, self._tokens + (now - self._last) * self._qps)
            self._last = now
            self._tokens -= 1.0
            if self._tokens >= 0:
                return 0.0
            return -self._tokens / self._qps

    def qps(self) -> float:
        with self._lock:
            return self._qps

    def set_qps(self, qps: float) -> None:
        """Retune the refill rate in place — the seam the API health
        plane's AIMD limiter adjusts (cloudprovider/aws/health.py).
        Tokens accrued so far are settled at the OLD rate first, so a
        rate cut takes effect from now rather than retroactively."""
        with self._lock:
            now = self._clock()
            self._tokens = min(self._burst, self._tokens + (now - self._last) * self._qps)
            self._last = now
            self._qps = max(qps, 1e-9)

    def forget(self, item: Hashable) -> None:  # bucket has no per-item state
        pass

    def num_requeues(self, item: Hashable) -> int:
        return 0


class MaxOfRateLimiter:
    """Takes the worst (longest) delay of its children."""

    def __init__(self, *limiters):
        self._limiters = limiters

    def when(self, item: Hashable) -> float:
        return max(l.when(item) for l in self._limiters)

    def forget(self, item: Hashable) -> None:
        for l in self._limiters:
            l.forget(item)

    def num_requeues(self, item: Hashable) -> int:
        return max(l.num_requeues(item) for l in self._limiters)


def default_controller_rate_limiter() -> MaxOfRateLimiter:
    """The client-go default: per-item exponential + overall bucket."""
    return controller_rate_limiter(10.0, 100)


def controller_rate_limiter(
    qps: float = 10.0,
    burst: int = 100,
    max_backoff: float = 1000.0,
    clock: Optional[Callable[[], float]] = None,
) -> MaxOfRateLimiter:
    """The client-go default shape (per-item exponential + overall
    bucket) with a tunable bucket — the analog of passing a custom
    limiter where client-go users outgrow
    ``DefaultControllerRateLimiter()``'s 10 qps / 100 burst.

    qps <= 0 means "no overall bucket" (per-item backoff only).
    ``max_backoff`` caps the per-item exponential delay (client-go's
    1000 s default is far past useful for external-API retries; many
    controllers cap at seconds).  ``clock`` is threaded through to the
    bucket so tests drive refill with a fake clock."""
    if qps <= 0:
        return MaxOfRateLimiter(ItemExponentialFailureRateLimiter(0.005, max_backoff))
    return MaxOfRateLimiter(
        ItemExponentialFailureRateLimiter(0.005, max_backoff),
        BucketRateLimiter(qps, burst, clock=clock),
    )


class RateLimitingQueue:
    """Dedup FIFO + delayed adds + rate-limited adds, in one object.

    The three client-go queue layers (Type, DelayingInterface,
    RateLimitingInterface) collapsed into one class; the controllers
    only ever consume the combined interface.

    Two condition variables share one mutex: workers blocked in
    ``get`` wait on ``_ready`` while the single delay-waker thread
    waits on ``_delay``, so a ``notify`` for one never gets consumed
    by the other.

    ``clock`` is injectable for delay tests: with a fake clock, a test
    advances time and calls ``kick_delays()`` so the waker re-examines
    the heap instead of the test sleeping real wall seconds.
    """

    def __init__(
        self,
        rate_limiter=None,
        name: str = "",
        clock: Optional[Callable[[], float]] = None,
        metrics_registry=None,
    ):
        self.name = name
        self._clock = clock or clockseam.monotonic
        self._limiter = rate_limiter or default_controller_rate_limiter()
        # the controller-runtime standard workqueue metric set, bound
        # to this queue's name label (observability plane)
        queue_metrics = instruments.workqueue_instruments(metrics_registry)
        label = name or "unnamed"
        self._m_depth = queue_metrics.depth.labels(name=label)
        self._m_adds = queue_metrics.adds.labels(name=label)
        self._m_retries = queue_metrics.retries.labels(name=label)
        self._m_queue_duration = queue_metrics.queue_duration.labels(name=label)
        self._m_work_duration = queue_metrics.work_duration.labels(name=label)
        self._added_at: dict[Hashable, float] = {}  # item -> enqueue time
        self._got_at: dict[Hashable, float] = {}  # item -> handed-out time
        self._pop_wait = threading.local()  # per-worker last queue wait
        # racecheck seam: a plain Lock unless the lock-order watchdog
        # is enabled (tests), in which case acquisition order across
        # the worker/waker/handler threads is recorded and verified
        self._mutex = racecheck.make_lock(f"workqueue.{name or 'unnamed'}")
        self._ready = threading.Condition(self._mutex)
        self._delay = threading.Condition(self._mutex)
        self._queue: deque[Any] = deque()  # FIFO of items ready to be handed out
        self._dirty: set = set()  # items needing (re-)processing
        self._processing: set = set()  # items currently being processed
        self._shutting_down = False
        # delayed adds: heap of (ready_monotonic_time, seq, item)
        self._waiting: list = []
        self._seq = 0
        # explain-plane side tables, both O(1) per key:
        # item -> eta of its LATEST delayed add (matched on pop so a
        # superseded entry's maturation does not clear a newer one),
        # and item -> last structured reason code attached at the
        # requeue site (cleared on forget — a converged item carries
        # no stale cause)
        self._waiting_eta: dict[Hashable, float] = {}
        self._reasons: dict[Hashable, str] = {}
        # port-only: item -> the drift ticks waiting for its next
        # reconcile (not yet begun / running)
        self._drains_next: dict[Hashable, list] = {}
        self._drains_running: dict[Hashable, list] = {}
        # the delay waker is a real thread ONLY when the runtime allows
        # threads; under the sim runtime delayed adds are
        # popped synchronously by the cooperative scheduler via
        # pop_due_delays()/kick_delays(), so every requeue interleaving
        # is deterministic
        self._waker: Optional[threading.Thread] = None
        if clockseam.threads_enabled():
            self._waker = threading.Thread(
                target=self._waiting_loop, daemon=True, name=f"workqueue-delay-{name}"
            )
            self._waker.start()

    # ---- Type (dedup FIFO) ----
    def _add_locked(self, item: Hashable) -> None:
        if self._shutting_down or item in self._dirty:
            return
        self._dirty.add(item)
        self._m_adds.inc()
        self._added_at[item] = self._clock()
        if item in self._processing:
            return
        self._queue.append(item)
        self._m_depth.set(len(self._queue))
        self._ready.notify()

    def add(self, item: Hashable) -> None:
        with self._mutex:
            self._add_locked(item)
            self._watch_add_locked(item)

    def _watch_add_locked(self, item: Hashable) -> None:
        drain = getattr(threading.current_thread(), "agac_drift_drain", None)
        if drain is None or self._shutting_down:
            return
        drain.expect()
        self._drains_next.setdefault(item, []).append(drain)

    def _drains_begin_locked(self, item: Hashable) -> None:
        drains = self._drains_next.pop(item, None)
        if drains:
            self._drains_running[item] = drains

    def _drains_done_locked(self, item: Hashable) -> None:
        for drain in self._drains_running.pop(item, ()):
            drain.finished()

    def get(self, timeout: Optional[float] = None) -> tuple[Any, bool]:
        """Block until an item is available. Returns (item, shutdown).

        When shutdown is True the worker loop must exit
        (reference ``pkg/reconcile/reconcile.go:27-31``).  A ``timeout``
        expiry returns ``(None, False)`` — callers that poll must
        distinguish it from shutdown.
        """
        # real wall clock on purpose, independent of the injected
        # delay clock: get() blocks a live worker thread, and a fake
        # delay clock must not turn a poll timeout into a hang
        deadline = None if timeout is None else time.monotonic() + timeout  # agac-lint: ignore[unseamed-clock] -- bounds a real blocked thread; a virtual clock here would turn the poll timeout into a hang
        with self._mutex:
            while not self._queue and not self._shutting_down:
                remaining = None if deadline is None else deadline - time.monotonic()  # agac-lint: ignore[unseamed-clock] -- same real-thread timeout as above
                if remaining is not None and remaining <= 0:
                    return None, False
                self._ready.wait(remaining)
            if not self._queue:
                return None, True
            item = self._queue.popleft()
            self._processing.add(item)
            self._dirty.discard(item)
            self._drains_begin_locked(item)
            now = self._clock()
            wait = max(0.0, now - self._added_at.pop(item, now))
            self._m_queue_duration.observe(wait)
            self._pop_wait.wait = wait
            self._got_at[item] = now
            self._m_depth.set(len(self._queue))
            return item, False

    def last_pop_wait(self) -> Optional[float]:
        """The queued-time of the item THIS worker thread most
        recently got — the queue-wait span the reconcile trace
        attaches (the add timestamp is known only to the queue)."""
        return getattr(self._pop_wait, "wait", None)

    def done(self, item: Hashable) -> None:
        with self._mutex:
            self._processing.discard(item)
            now = self._clock()
            started = self._got_at.pop(item, None)
            if started is not None:
                self._m_work_duration.observe(max(0.0, now - started))
            self._drains_done_locked(item)
            if item in self._dirty:
                self._queue.append(item)
                self._m_depth.set(len(self._queue))
                self._ready.notify()

    def __len__(self) -> int:
        with self._mutex:
            return len(self._queue)

    def peek(self) -> Optional[Any]:
        """The item ``get`` would hand out next, without claiming it
        (the sim harness records it into the event trace before
        stepping a worker)."""
        with self._mutex:
            return self._queue[0] if self._queue else None

    def shutdown(self) -> None:
        with self._mutex:
            self._shutting_down = True
            self._ready.notify_all()
            self._delay.notify_all()

    def shutting_down(self) -> bool:
        with self._mutex:
            return self._shutting_down

    # ---- DelayingInterface ----
    def add_after(self, item: Hashable, delay: float, reason: str = "") -> None:
        if delay <= 0:
            if reason:
                with self._mutex:
                    self._reasons[item] = reason
            self.add(item)
            return
        with self._mutex:
            if self._shutting_down:
                return
            self._seq += 1
            eta = self._clock() + delay
            heapq.heappush(self._waiting, (eta, self._seq, item))
            self._waiting_eta[item] = eta
            if reason:
                self._reasons[item] = reason
            self._delay.notify()

    def kick_delays(self) -> None:
        """Wake the delay waker to re-examine the heap now — the seam
        fake-clock tests use after advancing their clock (a fake clock
        cannot make ``Condition.wait`` return early).  In threadless
        mode (sim runtime) there is no waker: the due items are popped
        synchronously on the caller's thread instead."""
        with self._mutex:
            if self._waker is None:
                self._pop_due_locked()
            else:
                self._delay.notify()

    def pop_due_delays(self) -> None:
        """Synchronously move every matured delayed add onto the ready
        FIFO — the sim scheduler's explicit pump (equivalent to the
        waker thread waking at the right moment, but on the
        cooperative scheduler's own thread, in deterministic order)."""
        with self._mutex:
            self._pop_due_locked()

    def next_delay_deadline(self) -> Optional[float]:
        """The clock time at which the earliest delayed add matures
        (None when nothing is parked) — how the sim scheduler knows
        when this queue next becomes interesting."""
        with self._mutex:
            return self._waiting[0][0] if self._waiting else None

    def _pop_due_locked(self) -> None:
        now = self._clock()
        while self._waiting and self._waiting[0][0] <= now:
            ready_time, _, item = heapq.heappop(self._waiting)
            # only the LATEST delayed add owns the eta entry; a
            # superseded (earlier) entry maturing must not clear it
            if self._waiting_eta.get(item) == ready_time:
                del self._waiting_eta[item]
            self._add_locked(item)

    def debug_status(self) -> dict:
        """A point-in-time dump of the queue's internals for
        ``/debug/queues``: ready/processing/dirty depths,
        parked delay count and how far away the nearest delay is —
        enough to tell a wedged worker pool from a backoff park from a
        genuinely drained queue."""
        with self._mutex:
            now = self._clock()
            return {
                "ready": len(self._queue),
                "processing": sorted(map(str, self._processing)),
                "dirty": len(self._dirty),
                "delayed": len(self._waiting),
                "next_delay_in_s": (
                    round(self._waiting[0][0] - now, 3) if self._waiting else None
                ),
                "shutting_down": self._shutting_down,
            }

    def _waiting_loop(self) -> None:
        with self._mutex:
            while not self._shutting_down:
                self._pop_due_locked()
                now = self._clock()
                wait_for = (self._waiting[0][0] - now) if self._waiting else None
                self._delay.wait(wait_for)

    # ---- RateLimitingInterface ----
    def add_rate_limited(self, item: Hashable, reason: str = "") -> None:
        self._m_retries.inc()
        self.add_after(item, self._limiter.when(item), reason=reason)

    def forget(self, item: Hashable) -> None:
        self._limiter.forget(item)
        with self._mutex:
            self._reasons.pop(item, None)

    def num_requeues(self, item: Hashable) -> int:
        return self._limiter.num_requeues(item)

    # ---- explain plane ----
    def delayed_peek(self, item: Hashable) -> Optional[dict]:
        """If ``item`` currently sits in a delayed add, its next-eta,
        last reason code and backoff count — a dict get, O(1) in queue
        and fleet size (the explain plane's per-key probe).  None when
        the item is not delayed (ready/processing/absent)."""
        with self._mutex:
            eta = self._waiting_eta.get(item)
            if eta is None:
                return None
            return {
                "eta_s": round(max(0.0, eta - self._clock()), 3),
                "reason": self._reasons.get(item, ""),
                "requeues": self._limiter.num_requeues(item),
            }

    def contains(self, item: Hashable) -> bool:
        """True when the item is ready, dirty, or being processed
        (NOT delayed — ``delayed_peek`` answers that) — O(1) set
        membership for the explain plane."""
        with self._mutex:
            return item in self._dirty or item in self._processing

    def last_reason(self, item: Hashable) -> str:
        with self._mutex:
            return self._reasons.get(item, "")
