"""The per-zone Route53 change batcher.

``ChangeResourceRecordSets`` accepts up to 1,000 changes per call, yet
the driver issued ONE call per record mutation — 1,100 wire calls for
1,100 records in the bench's tuned phase, serializing every Route53
worker through the 5 req/s quota one record at a time.  The batcher
coalesces change submissions destined for the same hosted zone across
concurrently-reconciling items into multi-change wire calls:

- the first submitter of a zone window becomes the batch **leader**:
  it waits up to ``linger`` for co-submitters (cut short the moment
  the batch reaches ``max_changes``), then commits ONE call carrying
  every gathered submission;
- a submission's changes are **never split** across wire calls — the
  driver's atomic TXT+A pair stays atomic;
- on success the committed changes are folded into the zone's
  ``RecordSetCache`` snapshot once (write-through), and every owning
  submission resolves OK;
- on ``InvalidChangeBatch`` against a multi-submission batch — Route53
  batches are all-or-nothing, so one bad change fails every co-batched
  record — the leader invalidates the zone snapshot ONCE and degrades
  to per-submission commits: healthy co-batched submissions land,
  only the owning item gets the error (partial-failure fan-out, pinned
  by ``tests/test_r53_batching.py`` and a FaultPlan chaos drill);
- any other error (throttle, outage, NoSuchHostedZone) fails the whole
  batch to every owner — each item's own retry policy takes over.

Submissions are consumed two ways: ``submit()`` blocks the caller
until its outcome (cleanup/GC paths — cold, correctness-first), while
``submit_async()`` returns a ``BatchTicket`` immediately so the ensure
hot path can park the item in the pending-settle table instead of
holding a worker through the linger (``AWSDriver`` raises
``SettleWait`` with the ticket; the settle poller checks
``ticket.state()`` — a pure in-memory read — each tick).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from ... import clockseam, klog
from ...analysis import racecheck
from ...observability import instruments, profile
from .errors import AWSAPIError
from .types import Change

FLUSH_LINGER = "linger"
FLUSH_FULL = "full"
FLUSH_SPLIT = "split"

# Route53's documented per-call ceiling
MAX_CHANGES_PER_CALL = 1000

CommitFn = Callable[[str, list[Change]], None]
FoldFn = Callable[[str, list[Change]], None]
InvalidateFn = Callable[[str], None]


class BatchTicket:
    """One submission's outcome handle.  ``state()`` is the settle
    poller's contract: ``"pending"`` until the batch (or this
    submission's split retry) commits, then ``"ready"`` or
    ``"failed"``; ``error`` carries the submission's own failure.
    Hashable by identity so it can be a pending-settle token."""

    __slots__ = ("zone_id", "changes", "_event", "error")

    def __init__(self, zone_id: str, changes: list[Change]):
        self.zone_id = zone_id
        self.changes = changes
        self._event = threading.Event()
        self.error: Optional[Exception] = None

    def _resolve(self, error: Optional[Exception] = None) -> None:
        self.error = error
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def state(self) -> str:
        if not self._event.is_set():
            return "pending"
        return "failed" if self.error is not None else "ready"

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)


class _ZoneBatch:
    __slots__ = ("tickets", "closed", "full_event")

    def __init__(self):
        self.tickets: list[BatchTicket] = []
        self.closed = False
        self.full_event = threading.Event()  # cuts the leader's linger short

    def change_count(self) -> int:
        return sum(len(t.changes) for t in self.tickets)


class ChangeBatcher:
    """Per-zone gatherer of record-change submissions into multi-change
    ``ChangeResourceRecordSets`` calls.  One instance per process,
    shared by every driver (the factory owns the singleton); the commit
    / fold / invalidate callables ride on each submission because they
    close over the submitting driver's service handle and caches."""

    def __init__(
        self,
        max_changes: int = 100,
        linger: float = 0.1,
        clock: Optional[Callable[[], float]] = None,
        wait_full: Optional[Callable[[threading.Event, float], bool]] = None,
        registry=None,
    ):
        self.max_changes = max(1, min(max_changes, MAX_CHANGES_PER_CALL))
        self.linger = max(linger, 0.0)
        self._clock = clock or clockseam.monotonic
        # the leader's linger wait, seam-injectable: real
        # Event.wait in threaded mode; under the sim runtime the
        # default becomes a virtual-time advance, so a linger window
        # costs zero wall clock and the commit lands at a
        # deterministic virtual instant
        if wait_full is not None:
            self._wait_full = wait_full
        elif clockseam.threads_enabled():
            self._wait_full = lambda event, timeout: event.wait(timeout)
        else:
            def _virtual_wait(event: threading.Event, timeout: float) -> bool:
                clockseam.sleep(timeout)
                return event.is_set()

            self._wait_full = _virtual_wait
        # racecheck seam: instrumented when the lock-order watchdog is
        # armed (chaos/soak tiers), a plain Lock otherwise
        self._lock = racecheck.make_lock("r53-batcher")
        self._forming: dict[str, _ZoneBatch] = {}
        # cumulative counters (stats() / bench export)
        self.batches = 0
        self.changes_total = 0
        self.submissions_total = 0
        self.flushes = {FLUSH_LINGER: 0, FLUSH_FULL: 0, FLUSH_SPLIT: 0}
        self.split_commits = 0
        self.batch_sizes: dict[int, int] = {}  # changes-per-call -> count
        metrics = instruments.pipeline_instruments(registry)
        self._m_batch_changes = metrics.batch_changes
        self._m_flushes = {
            reason: metrics.batch_flushes.labels(reason=reason)
            for reason in (FLUSH_LINGER, FLUSH_FULL, FLUSH_SPLIT)
        }

    def stats(self) -> dict:
        with self._lock:
            return {
                "submissions": self.submissions_total,
                "changes": self.changes_total,
                "wire_calls": self.batches,
                "flushes": dict(self.flushes),
                "split_commits": self.split_commits,
                "batch_sizes": dict(sorted(self.batch_sizes.items())),
            }

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def submit_async(
        self,
        zone_id: str,
        changes: list[Change],
        commit: CommitFn,
        fold: Optional[FoldFn] = None,
        invalidate: Optional[InvalidateFn] = None,
    ) -> BatchTicket:
        """Queue ``changes`` for the zone's forming batch and return a
        ticket.  The calling thread becomes the batch leader only when
        it opened the batch — leaders run the linger + commit inline
        before returning (their ticket is always ``done()`` on return);
        joiners return immediately with a pending ticket."""
        ticket = BatchTicket(zone_id, list(changes))
        if len(ticket.changes) > self.max_changes:
            # an oversized single submission gets its own call
            with self._lock:
                self.submissions_total += 1
            self._commit_batch(
                zone_id, [ticket], commit, fold, invalidate, reason=FLUSH_FULL
            )
            return ticket
        with self._lock:
            self.submissions_total += 1
            batch = self._forming.get(zone_id)
            if (
                batch is not None
                and not batch.closed
                and batch.change_count() + len(ticket.changes) <= self.max_changes
            ):
                batch.tickets.append(ticket)
                if batch.change_count() >= self.max_changes:
                    batch.full_event.set()
                return ticket  # joiner: the leader will commit
            batch = _ZoneBatch()
            batch.tickets.append(ticket)
            self._forming[zone_id] = batch
        # leader: gather co-submitters, then flush
        full = False
        if self.linger > 0:
            full = self._wait_full(batch.full_event, self.linger)
        with self._lock:
            batch.closed = True
            if self._forming.get(zone_id) is batch:
                del self._forming[zone_id]
            tickets = list(batch.tickets)
        self._commit_batch(
            zone_id, tickets, commit, fold, invalidate,
            reason=FLUSH_FULL if full else FLUSH_LINGER,
        )
        return ticket

    def submit(
        self,
        zone_id: str,
        changes: list[Change],
        commit: CommitFn,
        fold: Optional[FoldFn] = None,
        invalidate: Optional[InvalidateFn] = None,
        wait_check: Optional[Callable[[], None]] = None,
    ) -> None:
        """Blocking submission: coalesces like ``submit_async`` and
        waits for the outcome, re-raising this submission's own error.
        ``wait_check`` (e.g. ``api_health.check_deadline``) runs every
        wait slice so a worker never wedges on a stuck batch."""
        ticket = self.submit_async(zone_id, changes, commit, fold, invalidate)
        while not ticket.wait(0.05):
            if wait_check is not None:
                wait_check()
        if ticket.error is not None:
            raise ticket.error

    # ------------------------------------------------------------------
    # commit + partial-failure fan-out
    # ------------------------------------------------------------------
    def _record_flush(self, n_changes: int, reason: str) -> None:
        with self._lock:
            self.batches += 1
            self.changes_total += n_changes
            self.flushes[reason] += 1
            self.batch_sizes[n_changes] = self.batch_sizes.get(n_changes, 0) + 1
        self._m_batch_changes.observe(float(n_changes))
        self._m_flushes[reason].inc()

    def _commit_batch(
        self,
        zone_id: str,
        tickets: list[BatchTicket],
        commit: CommitFn,
        fold: Optional[FoldFn],
        invalidate: Optional[InvalidateFn],
        reason: str,
    ) -> None:
        with profile.stage("r53-batch-flush"):
            self._commit_batch_inner(
                zone_id, tickets, commit, fold, invalidate, reason
            )

    def _commit_batch_inner(
        self,
        zone_id: str,
        tickets: list[BatchTicket],
        commit: CommitFn,
        fold: Optional[FoldFn],
        invalidate: Optional[InvalidateFn],
        reason: str,
    ) -> None:
        merged: list[Change] = []
        for ticket in tickets:
            merged.extend(ticket.changes)
        try:
            commit(zone_id, merged)
        except Exception as err:
            self._fan_out_failure(
                zone_id, tickets, err, commit, fold, invalidate
            )
            return
        except BaseException as err:
            # a dying leader (SimulatedCrash in the kill drills, or a
            # KeyboardInterrupt) must not leave co-batched waiters
            # parked forever: fail their tickets ambiguously — the
            # level-triggered retry re-reads and repairs either way —
            # and let the death propagate
            ambiguous = AWSAPIError(
                "RequestTimeout", f"batch leader died mid-commit: {err}"
            )
            for ticket in tickets:
                ticket._resolve(ambiguous)
            raise
        self._record_flush(len(merged), reason)
        if fold is not None:
            self._fold(fold, zone_id, merged)
        for ticket in tickets:
            ticket._resolve()

    def _fan_out_failure(
        self,
        zone_id: str,
        tickets: list[BatchTicket],
        err: Exception,
        commit: CommitFn,
        fold: Optional[FoldFn],
        invalidate: Optional[InvalidateFn],
    ) -> None:
        invalid = isinstance(err, AWSAPIError) and err.code in (
            "InvalidChangeBatch", "NoSuchHostedZone"
        )
        if invalid and invalidate is not None:
            # the zone snapshot lied (or the zone is gone): drop it
            # ONCE for the whole batch — split retries below must not
            # re-invalidate per failing submission
            self._invalidate(invalidate, zone_id)
        if not (
            isinstance(err, AWSAPIError)
            and err.code == "InvalidChangeBatch"
            and len(tickets) > 1
        ):
            # whole-batch failure (throttle/outage/zone gone, or a
            # single-owner batch): every owner retries via its own
            # requeue policy
            for ticket in tickets:
                ticket._resolve(err)
            return
        # InvalidChangeBatch on a co-batched call: one submission's
        # change poisoned the atomic batch.  Degrade to per-submission
        # commits so only the owning item fails.
        klog.warningf(
            "change batch for %s rejected (%s); splitting %d submissions",
            zone_id, err, len(tickets),
        )
        with self._lock:
            self.split_commits += 1
        for ticket in tickets:
            try:
                commit(zone_id, ticket.changes)
            except Exception as sub_err:
                ticket._resolve(sub_err)
                continue
            self._record_flush(len(ticket.changes), FLUSH_SPLIT)
            if fold is not None:
                self._fold(fold, zone_id, ticket.changes)
            ticket._resolve()

    @staticmethod
    def _fold(fold: FoldFn, zone_id: str, changes: list[Change]) -> None:
        try:
            fold(zone_id, changes)
        except Exception as err:  # cache fold must not fail the commit
            klog.errorf("write-through fold for %s failed: %s", zone_id, err)

    @staticmethod
    def _invalidate(invalidate: InvalidateFn, zone_id: str) -> None:
        try:
            invalidate(zone_id)
        except Exception as err:
            klog.errorf("zone invalidation for %s failed: %s", zone_id, err)
