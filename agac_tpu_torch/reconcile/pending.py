"""The pending-settle table: non-blocking waits for slow AWS state.

The mutation hot path used to HOLD a worker whenever AWS made it wait
— the accelerator disable→DEPLOYED settle poll slept up to 180 s
inside ``process_next_work_item``, and the Route53 ensure requeued
blind 60 s timers while waiting for the GlobalAccelerator controller
to converge.  Workers are a fixed pool; a parked worker is throughput
burned while mutate quota sits idle (the "async mutation
pipeline").

This module turns those waits inside out:

- a process function that reaches an AWS wait state raises
  ``SettleWait`` instead of sleeping.  The reconcile loop catches it,
  **parks** the item here — (queue, key, wait token, deadline) — and
  returns the worker to the queue immediately;
- a poll-tick scheduler (``SettleScheduler``, or an explicit
  ``poll_once()`` in tests/bench — FakeClock-compatible) re-checks all
  parked items of a group through ONE registered **group poller** per
  tick: coalesced describes instead of per-item poll loops.  A wait
  that resolved re-adds its item (backoff forgotten — parking is not a
  failure); a wait that resolved *failed* re-adds rate-limited so a
  persistently failing wait backs off instead of livelocking at tick
  frequency;
- **deadlines** are per item: an entry parked longer than its wait's
  timeout is expired and re-added rate-limited — the item re-runs,
  re-derives its state, and re-parks with a fresh deadline (bounded
  progress, never a wedged table entry);
- **health-plane circuits** integrate at the poller: a poller that
  raises ``CircuitOpenError`` (its coalesced describe was shed) skips
  its group for the tick — parked items age but are not dropped, and
  their deadlines still run, so an outage degrades to the legacy
  requeue cadence instead of hammering the dead service.

The table is deliberately in-memory only.  Crash consistency comes
from level-triggered reconciliation, not persistence: after a process
death the informer relist / drift tick re-enqueues every managed
object, each re-runs idempotently, and whatever still waits re-parks
— the table is REBUILT from requeue (proven by the kill-mid-settle
drill in ``tests/test_process_e2e.py``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from .. import clockseam, klog
from ..analysis import racecheck
from ..observability import instruments, journey

# what a group poller reports per token
SETTLE_PENDING = "pending"
SETTLE_READY = "ready"
SETTLE_FAILED = "failed"

# fallback deadline for waits parked without an explicit timeout
DEFAULT_SETTLE_TIMEOUT = 180.0

# Pollers receive the distinct tokens of their parked group and return
# {token: SETTLE_READY | SETTLE_FAILED}; omitted tokens stay pending.
GroupPoller = Callable[[list], dict]


class SettleWait(Exception):
    """Raised by driver code when a mutate chain reaches an AWS wait
    state (accelerator IN_PROGRESS, a change batch still committing,
    a cross-controller dependency not yet converged).  The reconcile
    loop parks the item instead of treating this as an error.

    ``group`` names the registered poller that can answer the wait;
    ``token`` is what that poller is asked about (an ARN, a hostname,
    a batch ticket); ``timeout`` bounds how long the item may stay
    parked before it is expired back into the queue; ``table`` is the
    pending-settle table the raising driver is wired to (riding on the
    exception keeps the reconcile loop free of global lookups — a
    driver without a table never raises this)."""

    def __init__(
        self,
        group: str,
        token,
        message: str = "",
        table: Optional["PendingSettleTable"] = None,
        timeout: float = DEFAULT_SETTLE_TIMEOUT,
    ):
        self.group = group
        self.token = token
        self.table = table
        self.timeout = timeout
        super().__init__(message or f"waiting on {group}:{token!r}")


@dataclass
class _Parked:
    key: str
    queue: object  # RateLimitingQueue (duck-typed: add/forget/add_rate_limited)
    group: str
    token: object
    parked_at: float
    deadline: float
    # the journey plane's controller label (the parking reconcile
    # loop's worker label; falls back to the queue name when unset)
    controller: str = ""


@dataclass
class _GroupState:
    poller: Optional[GroupPoller] = None
    entries: dict = field(default_factory=dict)  # key -> _Parked


class PendingSettleTable:
    """Parked reconcile items keyed by (group, item key), with one
    coalescing poller per group.  Thread-safe; pollers run OUTSIDE the
    lock (they may touch the wire)."""

    def __init__(
        self,
        clock: Optional[Callable[[], float]] = None,
        registry=None,
    ):
        self._clock = clock or clockseam.monotonic
        # racecheck seam: instrumented when the lock-order watchdog is
        # armed (chaos/soak tiers), a plain Lock otherwise
        self._lock = racecheck.make_lock("pending-settle")
        self._groups: dict[str, _GroupState] = {}
        # cumulative counters (stats() / bench export)
        self.parked_total = 0
        self.resolved_total = 0
        self.failed_total = 0
        self.expired_total = 0
        self.circuit_skips = 0
        self.max_depth = 0
        metrics = instruments.pipeline_instruments(registry)
        metrics.pending_depth.labels(table="settle").set_function(self.depth)
        metrics.pending_oldest_age.labels(table="settle").set_function(
            self.oldest_age
        )
        self._m_parked = metrics.pending_parked
        self._m_resolved = metrics.pending_resolved

    # ------------------------------------------------------------------
    # registration + parking
    # ------------------------------------------------------------------
    def register_poller(self, group: str, poller: GroupPoller) -> None:
        """Install (or replace) the coalescing poller for ``group``.
        Re-registration is idempotent by design: every per-region
        driver construction re-registers the same global pollers."""
        with self._lock:
            self._groups.setdefault(group, _GroupState()).poller = poller

    def park(self, key: str, queue, wait: SettleWait, controller: str = "",
             reason: str = "parked-settle") -> None:
        """Park ``key`` until ``wait`` resolves (or its deadline
        expires).  A key re-parked in the same group replaces its
        entry (fresh token + deadline); parking the same key under a
        different group moves it — one wait per item at a time, the
        one its latest reconcile pass hit.  ``reason`` is the explain
        code the parking site asserts (always ``parked-settle`` today;
        the kwarg exists so the unexplained-requeue lint sees a literal
        at the call site rather than special-casing park)."""
        del reason  # the parked entry itself IS the explain evidence
        now = self._clock()
        entry = _Parked(
            key=key,
            queue=queue,
            group=wait.group,
            token=wait.token,
            parked_at=now,
            deadline=now + max(wait.timeout, 0.001),
            controller=controller,
        )
        with self._lock:
            for state in self._groups.values():
                state.entries.pop(key, None)
            self._groups.setdefault(wait.group, _GroupState()).entries[key] = entry
            self.parked_total += 1
            self.max_depth = max(self.max_depth, self._depth_locked())
        self._m_parked.labels(group=wait.group).inc()

    def parked_info(self, key: str) -> Optional[dict]:
        """If ``key`` is parked, its wait's shape (group, token,
        parked_at, deadline, controller) — the explain plane's per-key
        probe.  The scan is over the handful of registered GROUPS (an
        entry lookup per group is a dict get), never over entries."""
        with self._lock:
            for group, state in self._groups.items():
                entry = state.entries.get(key)
                if entry is not None:
                    return {
                        "group": group,
                        "token": entry.token,
                        "parked_at": entry.parked_at,
                        "deadline": entry.deadline,
                        "controller": entry.controller,
                    }
        return None

    def parked_keys(self) -> list[str]:
        """Every parked key across groups — the sim explain oracle's
        ground truth for the ``parked-settle`` verdict."""
        with self._lock:
            return [
                key
                for state in self._groups.values()
                for key in state.entries
            ]

    def discard(self, key: str) -> None:
        """Drop a parked entry without requeueing (the item was
        re-enqueued by an external event and already re-ran)."""
        with self._lock:
            for state in self._groups.values():
                state.entries.pop(key, None)

    def reset(self) -> None:
        """Drop EVERY parked entry without requeueing — process death
        (the sim harness's leader kill, the kill drills): the table is
        in-memory only and is rebuilt from requeue by the next
        generation's relist, so entries referencing a dead generation's
        queues must not be polled on its behalf."""
        with self._lock:
            for state in self._groups.values():
                state.entries.clear()

    # ------------------------------------------------------------------
    # the poll tick
    # ------------------------------------------------------------------
    def poll_once(self) -> dict:
        """One scheduler tick: for every group, expire overdue entries,
        then ask the group's poller about the remainder in ONE call and
        requeue whatever resolved.  Returns a report for logging/tests:
        ``{"resolved": n, "failed": n, "expired": n, "pending": n,
        "circuit_skipped": [groups]}``."""
        report = {"resolved": 0, "failed": 0, "expired": 0, "pending": 0,
                  "circuit_skipped": []}
        with self._lock:
            groups = {
                name: (state.poller, list(state.entries.values()))
                for name, state in self._groups.items()
                if state.entries
            }
        now = self._clock()
        for name, (poller, entries) in groups.items():
            live: list[_Parked] = []
            for entry in entries:
                if now >= entry.deadline:
                    self._remove(entry)
                    self.expired_total += 1
                    report["expired"] += 1
                    # expiry is failure-shaped: the wait never resolved,
                    # so the retry backs off like any failing item
                    self._requeue(entry, failed=True,
                                  stage=journey.STAGE_SETTLE_EXPIRED)
                else:
                    live.append(entry)
            if not live:
                continue
            if poller is None:
                report["pending"] += len(live)
                continue
            tokens = []
            seen = set()
            for entry in live:  # tokens are hashable (str / ticket objects)
                if entry.token not in seen:
                    seen.add(entry.token)
                    tokens.append(entry.token)
            try:
                outcomes = poller(tokens)
            except Exception as err:
                # CircuitOpenError lands here too: the coalesced check
                # was shed — skip this group for the tick, entries age
                # toward their own deadlines
                self.circuit_skips += 1
                report["circuit_skipped"].append(name)
                klog.v(2).infof(
                    "settle poll for group %s skipped: %s", name, err
                )
                report["pending"] += len(live)
                continue
            for entry in live:
                outcome = outcomes.get(entry.token, SETTLE_PENDING)
                if outcome == SETTLE_READY:
                    self._remove(entry)
                    self.resolved_total += 1
                    report["resolved"] += 1
                    self._m_resolved.labels(group=name, outcome="ready").inc()
                    self._requeue(entry, failed=False,
                                  stage=journey.STAGE_SETTLE_RESOLVED)
                elif outcome == SETTLE_FAILED:
                    self._remove(entry)
                    self.failed_total += 1
                    report["failed"] += 1
                    self._m_resolved.labels(group=name, outcome="failed").inc()
                    self._requeue(entry, failed=True,
                                  stage=journey.STAGE_SETTLE_FAILED)
                else:
                    report["pending"] += 1
        return report

    def _remove(self, entry: _Parked) -> None:
        with self._lock:
            state = self._groups.get(entry.group)
            if state is not None and state.entries.get(entry.key) is entry:
                del state.entries[entry.key]

    @staticmethod
    def _requeue(entry: _Parked, failed: bool, stage: str) -> None:
        # the journey stamp: the settle wait's outcome is a
        # lifecycle stage; queue names are the controller labels the
        # journey plane keys on
        journey.tracker().stage(
            entry.controller
            or getattr(entry.queue, "name", "")
            or entry.group,
            entry.key,
            stage,
            reason="backoff" if failed else "in-flight",
        )
        try:
            if failed:
                # a failed/expired wait retries like any failing item
                entry.queue.add_rate_limited(entry.key, reason="backoff")
            else:
                entry.queue.forget(entry.key)
                entry.queue.add(entry.key)
        except Exception as err:  # a dead queue must not kill the tick
            klog.errorf("settle requeue of %r failed: %s", entry.key, err)

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------
    def _depth_locked(self) -> int:
        return sum(len(state.entries) for state in self._groups.values())

    def depth(self) -> int:
        with self._lock:
            return self._depth_locked()

    def depth_by_group(self) -> dict[str, int]:
        with self._lock:
            return {
                name: len(state.entries)
                for name, state in self._groups.items()
                if state.entries
            }

    def oldest_age(self) -> float:
        """Seconds the oldest parked entry has waited (0 when empty) —
        the staleness signal the depth gauge alone cannot carry."""
        with self._lock:
            oldest = min(
                (
                    entry.parked_at
                    for state in self._groups.values()
                    for entry in state.entries.values()
                ),
                default=None,
            )
        if oldest is None:
            return 0.0
        return max(0.0, self._clock() - oldest)

    def stats(self) -> dict:
        with self._lock:
            depth = self._depth_locked()
        return {
            "depth": depth,
            "depth_by_group": self.depth_by_group(),
            "parked_total": self.parked_total,
            "resolved_total": self.resolved_total,
            "failed_total": self.failed_total,
            "expired_total": self.expired_total,
            "circuit_skips": self.circuit_skips,
            "max_depth": self.max_depth,
        }


class SettleScheduler:
    """The poll-tick driver: calls ``table.poll_once()`` every
    ``interval`` seconds on a daemon thread until ``stop`` fires.
    Tests and the bench drive ``poll_once()`` directly instead (the
    drift_tick pattern), so the thread is wall-clock-only plumbing."""

    def __init__(
        self,
        table: PendingSettleTable,
        interval: float = 1.0,
    ):
        self.table = table
        self.interval = max(interval, 0.01)
        self._thread: Optional[threading.Thread] = None

    def start(self, stop: threading.Event) -> threading.Thread:
        def loop():
            while not stop.wait(self.interval):
                try:
                    self.table.poll_once()
                except Exception as err:  # a bad tick must not kill the loop
                    klog.errorf("settle scheduler tick failed: %s", err)

        self._thread = threading.Thread(
            target=loop, daemon=True, name="settle-scheduler"
        )
        self._thread.start()
        return self._thread
