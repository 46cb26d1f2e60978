"""Per-object journey tracking: spec edit → converged AWS state.

The observability plane measures component health — queue
depths, call latencies, circuit states — but none of it answers the
only question a *user* of the controller has: "I edited my Service;
how long until AWS matched it?"  This module stamps every lifecycle
stage of a reconcile key's journey:

    spec observed / enqueued → reconcile attempts → requeues →
    parked-settle waits → shard handoffs → converged (or deleted)

keyed by (controller, namespace/name) with the spec generation that
opened the journey, and feeds three fleet-facing signals:

- ``agac_journey_converge_seconds{controller,trigger}`` — the
  end-to-end convergence-latency histogram (the SLO engine's input);
  ``trigger`` says what opened the journey: a ``spec`` edit, a
  ``drift`` resync, or a shard ``handoff`` adoption;
- ``agac_journey_inflight{controller}`` and
  ``agac_journey_oldest_unconverged_age_seconds{controller}`` — the
  live backlog view (depth alone hides a single wedged object; the
  oldest-age gauge is what pages);
- ``agac_journey_stages_total{controller,stage}`` — stage flow
  counters, so a requeue storm or settle-expiry burst is visible as a
  rate, not only as latency.

Every journey carries an id (``<key>@g<generation>#<serial>``) that
the reconcile loop writes into each flight-recorder entry — a slow
convergence surfaced by ``/slo`` is one grep away from its recorded
attempts.

There is one process-global tracker (``tracker()``), the default for
the reconcile loop and the controllers' enqueue stamps; the sim
harness and the bench ``install()`` private trackers (bound to private
registries) for per-scenario isolation, exactly like the clock seam.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from .. import clockseam
from . import instruments
from .metrics import MetricsRegistry

# journey triggers (the converge histogram's second label)
TRIGGER_SPEC = "spec"
TRIGGER_DRIFT = "drift"
TRIGGER_HANDOFF = "handoff"
# a live shard-count resize re-homed the key: distinct
# from a failover handoff so resize-driven re-homes get their own
# convergence histogram series
TRIGGER_RESIZE = "resize"

# stage names (the stages_total label values)
STAGE_ENQUEUED = "enqueued"
STAGE_ATTEMPT = "attempt"
STAGE_REQUEUED = "requeued"
STAGE_PARKED = "parked"
STAGE_SETTLE_RESOLVED = "settle-resolved"
STAGE_SETTLE_FAILED = "settle-failed"
STAGE_SETTLE_EXPIRED = "settle-expired"
STAGE_HANDOFF = "handoff"
STAGE_CONVERGED = "converged"
STAGE_DELETED = "deleted"
STAGE_DROPPED = "dropped"

# in-flight journeys tracked before new opens are dropped (counted):
# bounds a key explosion the same way the metric registry's series cap
# does — 4x the largest simulated fleet per controller is generous
DEFAULT_MAX_INFLIGHT = 262_144


class Journey:
    """One object's in-flight journey: opened by an enqueue stamp,
    closed by a converged/deleted reconcile pass."""

    __slots__ = (
        "controller", "key", "generation", "trigger", "started",
        "attempts", "requeues", "parks", "handoffs", "last_stage",
        "last_reason", "serial",
    )

    def __init__(self, controller: str, key: str, generation: int,
                 trigger: str, started: float, serial: int):
        self.controller = controller
        self.key = key
        self.generation = generation
        self.trigger = trigger
        self.started = started
        self.serial = serial
        self.attempts = 0
        self.requeues = 0
        self.parks = 0
        self.handoffs = 0
        self.last_stage = STAGE_ENQUEUED
        self.last_reason = ""

    @property
    def id(self) -> str:
        return f"{self.key}@g{self.generation}#{self.serial}"

    def to_dict(self, now: float) -> dict:
        return {
            "id": self.id,
            "controller": self.controller,
            "key": self.key,
            "generation": self.generation,
            "trigger": self.trigger,
            "age_s": round(max(0.0, now - self.started), 3),
            "attempts": self.attempts,
            "requeues": self.requeues,
            "parks": self.parks,
            "handoffs": self.handoffs,
            "last_stage": self.last_stage,
            "last_reason": self.last_reason,
        }


class JourneyTracker:
    """Thread-safe (controller, key) → Journey table + the metric
    stamps.  Every method is a cheap no-op for keys it has never been
    told about, so instrumented paths never branch on tracker state."""

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        clock: Callable[[], float] = clockseam.monotonic,
        max_inflight: int = DEFAULT_MAX_INFLIGHT,
    ):
        self._clock = clock
        self._lock = threading.Lock()
        self._inflight: dict[tuple[str, str], Journey] = {}
        self._serial = 0
        self._max_inflight = max(1, max_inflight)
        self._metrics = instruments.journey_instruments(registry)
        self._bound_controllers: set[str] = set()
        # cumulative close counters (stats()/tests; the histogram's
        # _count carries the same totals per label)
        self.converged_total = 0
        self.deleted_total = 0
        self.dropped_total = 0  # opens refused at the inflight cap

    # ------------------------------------------------------------------
    # opening stamps
    # ------------------------------------------------------------------
    def observe_enqueued(
        self,
        controller: str,
        key: str,
        generation: int = 0,
        trigger: str = TRIGGER_SPEC,
    ) -> None:
        """The journey's opening stamp, from the controllers' enqueue
        paths.  A key already in flight keeps its clock UNLESS a newer
        spec generation arrives — the user experiences latency to the
        generation they last wrote, so the clock restarts there."""
        now = self._clock()
        with self._lock:
            journey = self._inflight.get((controller, key))
            if journey is not None:
                if generation > journey.generation:
                    # a newer spec superseded the in-flight journey:
                    # restart the clock at the edit the user now waits on
                    journey.generation = generation
                    journey.started = now
                    journey.trigger = trigger
                journey.last_stage = STAGE_ENQUEUED
            else:
                if len(self._inflight) >= self._max_inflight:
                    self.dropped_total += 1
                    return
                self._serial += 1
                journey = Journey(
                    controller, key, generation, trigger, now, self._serial
                )
                self._inflight[(controller, key)] = journey
                if journey.handoffs == 0 and trigger == TRIGGER_HANDOFF:
                    journey.handoffs = 1
            self._bind_controller_views(controller)
        self._metrics.stages.labels(
            controller=controller, stage=STAGE_ENQUEUED
        ).inc()
        if trigger == TRIGGER_HANDOFF:
            self._metrics.stages.labels(
                controller=controller, stage=STAGE_HANDOFF
            ).inc()

    # ------------------------------------------------------------------
    # in-flight stamps
    # ------------------------------------------------------------------
    def stage(
        self, controller: str, key: str, stage: str, reason: str = ""
    ) -> None:
        """A mid-journey stamp (requeued / parked / settle outcomes).
        Unknown keys still count the stage — the flow counters must see
        every requeue even when the open stamp was dropped.  ``reason``
        is the structured explain-catalog code attached at the
        requeue/park site; the explain plane reads it back as the
        journey's last known cause."""
        with self._lock:
            journey = self._inflight.get((controller, key))
            if journey is not None:
                journey.last_stage = stage
                if reason:
                    journey.last_reason = reason
                if stage == STAGE_REQUEUED:
                    journey.requeues += 1
                elif stage == STAGE_PARKED:
                    journey.parks += 1
                elif stage == STAGE_HANDOFF:
                    journey.handoffs += 1
        self._metrics.stages.labels(controller=controller, stage=stage).inc()

    def attempt(self, controller: str, key: str) -> None:
        with self._lock:
            journey = self._inflight.get((controller, key))
            if journey is not None:
                journey.attempts += 1
                journey.last_stage = STAGE_ATTEMPT
        self._metrics.stages.labels(
            controller=controller, stage=STAGE_ATTEMPT
        ).inc()

    # ------------------------------------------------------------------
    # closing stamps
    # ------------------------------------------------------------------
    def converged(self, controller: str, key: str) -> Optional[float]:
        return self._close(controller, key, STAGE_CONVERGED)

    def deleted(self, controller: str, key: str) -> Optional[float]:
        return self._close(controller, key, STAGE_DELETED)

    def drop(self, controller: str, key: str) -> None:
        """Close a journey that can NEVER converge (permanent error:
        the retry policy dropped the item) WITHOUT observing a
        latency — a dropped item is not a convergence, and folding it
        into the histogram would poison the SLO with infinities."""
        with self._lock:
            self._inflight.pop((controller, key), None)
        self._metrics.stages.labels(
            controller=controller, stage=STAGE_DROPPED
        ).inc()

    def release(self, selects: Callable[[str], bool]) -> int:
        """Close, WITHOUT observing a latency, every in-flight journey
        whose key ``selects`` picks; returns how many.  A process
        calls it for keys it stopped serving: their convergence is
        the new owner's to observe, in its own tracker, and a copy
        left open here would age forever."""
        released = [
            (controller, key)
            for controller, key in self.inflight_keys()
            if selects(key)
        ]
        with self._lock:
            for entry in released:
                self._inflight.pop(entry, None)
        return len(released)

    def _close(self, controller: str, key: str, stage: str) -> Optional[float]:
        now = self._clock()
        with self._lock:
            journey = self._inflight.pop((controller, key), None)
            if journey is None:
                return None
            if stage == STAGE_CONVERGED:
                self.converged_total += 1
            else:
                self.deleted_total += 1
            trigger = journey.trigger
            latency = max(0.0, now - journey.started)
        self._metrics.stages.labels(controller=controller, stage=stage).inc()
        self._metrics.converge.labels(
            controller=controller, trigger=trigger
        ).observe(latency)
        return latency

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------
    def journey_id(self, controller: str, key: str) -> Optional[str]:
        with self._lock:
            journey = self._inflight.get((controller, key))
            return journey.id if journey is not None else None

    def view(self, controller: str, key: str) -> Optional[dict]:
        """One journey's snapshot dict (None when not in flight) — a
        single dict get, the explain plane's O(1) per-key read."""
        now = self._clock()
        with self._lock:
            journey = self._inflight.get((controller, key))
            return journey.to_dict(now) if journey is not None else None

    def inflight_keys(self) -> list[tuple[str, str]]:
        """Every in-flight (controller, key) — the explain plane's
        blocked-histogram sweep (O(unconverged), never per-lookup)."""
        with self._lock:
            return list(self._inflight)

    def inflight(self, controller: Optional[str] = None) -> int:
        with self._lock:
            if controller is None:
                return len(self._inflight)
            return sum(
                1 for (ctrl, _key) in self._inflight if ctrl == controller
            )

    def oldest_age(self, controller: Optional[str] = None) -> float:
        with self._lock:
            oldest = min(
                (
                    journey.started
                    for (ctrl, _key), journey in self._inflight.items()
                    if controller is None or ctrl == controller
                ),
                default=None,
            )
        if oldest is None:
            return 0.0
        return max(0.0, self._clock() - oldest)

    def oldest_unconverged_age(self, controller: Optional[str] = None) -> float:
        """Age in seconds of the oldest journey still in flight
        (0.0 when nothing is in flight) — the documented public
        accessor the autoscaler's signal collector reads, and the same
        number ``agac_journey_oldest_unconverged_age_seconds``
        exports.  ``controller`` narrows to one controller's
        journeys; the default spans the whole tracker."""
        return self.oldest_age(controller)

    def slowest(self, limit: int = 10) -> list[dict]:
        """The oldest unconverged journeys, oldest first — the
        ``/slo`` endpoint's drill-down list (each entry's id is
        grep-able in the flight recorder)."""
        now = self._clock()
        with self._lock:
            journeys = sorted(self._inflight.values(), key=lambda j: j.started)
        return [journey.to_dict(now) for journey in journeys[:limit]]

    def stats(self) -> dict:
        with self._lock:
            inflight = len(self._inflight)
        return {
            "inflight": inflight,
            "converged_total": self.converged_total,
            "deleted_total": self.deleted_total,
            "dropped_total": self.dropped_total,
            "oldest_age_s": round(self.oldest_age(), 3),
        }

    def _bind_controller_views(self, controller: str) -> None:
        """Bind the per-controller inflight/oldest-age callback gauges
        the first time a controller appears (called under the lock)."""
        if controller in self._bound_controllers:
            return
        self._bound_controllers.add(controller)
        self._metrics.inflight.labels(controller=controller).set_function(
            lambda ctrl=controller: self.inflight(ctrl)
        )
        self._metrics.oldest_age.labels(controller=controller).set_function(
            lambda ctrl=controller: self.oldest_age(ctrl)
        )


# ---------------------------------------------------------------------------
# the process-global tracker (reconcile loop + controllers default to
# it); the sim harness and the bench install private trackers
# ---------------------------------------------------------------------------

_tracker = JourneyTracker()


def tracker() -> JourneyTracker:
    return _tracker


def install(new_tracker: JourneyTracker) -> JourneyTracker:
    """Swap the process tracker (sim harness / bench isolation);
    returns the previous one so the caller can restore it."""
    global _tracker
    previous = _tracker
    _tracker = new_tracker
    return previous
