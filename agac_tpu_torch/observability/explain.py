"""The convergence explain plane: per-object blocked-on diagnosis.

The stack can measure *how slow* (journey histograms), *how
burned* (SLO windows), and *where the CPU goes* (stage
accountant) — but none of it answers the operator's actual question:
**why is ``ns/name`` not converged right now?**  Every plane holds one
shard of the answer and none of them talk:

- the JourneyTracker knows the object is in flight and what its last
  stage was;
- the PendingSettleTable knows it is parked on an AWS wait (group +
  deadline);
- the workqueue knows it is sitting in a backoff delay (count +
  next-eta);
- the HealthTracker knows the service circuit is open and when a probe
  will be admitted;
- the ShardFilter/ring knows this replica does not own the key — or
  that nobody does for a moment, mid-resize;
- the SLO engine knows deferrable work is being shed under burn.

``ExplainEngine`` assembles those into a single **blocked-on verdict**
per (controller, key) plus a causal timeline, fed by *structured
reason codes* attached at every requeue/park/skip site (the
``unexplained-requeue`` lint rule keeps the sites honest) rather than
inferred after the fact.  Every lookup is O(1) per key — dict gets
against live state, never a fleet enumeration (the unit tier
micro-asserts it).

The verdict vocabulary is a closed catalog; ``unknown`` is not in it.
A managed object always classifies to something actionable:

========================  ==================================================
verdict                   meaning
========================  ==================================================
``converged``             no journey in flight; the object matches AWS
``in-flight``             queued/processing, or waiting a scheduled re-check
``parked-settle``         parked on an AWS wait state (group + deadline)
``circuit-open``          requeued by an open service circuit (retry hint)
``quota-paced``           adaptive pacing pushed the call past its deadline
``backoff``               failing and retried with exponential backoff
``shed``                  deferrable work held back under SLO budget burn
``unowned-resize``        key is mid-handoff in a live resize (ring epoch)
``not-owner``             another replica's shards own the key
``informer-unsynced``     local caches have not completed their first sync
``not-managed``           the object exists but carries no managed marker
``deleted``               the object is gone from the cluster
========================  ==================================================

Surfaces: ``/debug/explain?key=ns/name[&controller=]`` (manager health
server), the ``explain`` CLI subcommand (fleet-wide over
``--fleet-peers``: the owning shard answers, non-owners report
``not-owner`` with their ring epoch), the
``agac_explain_blocked{reason}`` callback gauge (fleet-merged like
every gauge), and the SIGTERM post-mortem's top-blocked-on table.

One process-global engine (``engine()``/``install()``, the journey
tracker seam pattern); the manager wires the real one at build time
and the sim harness reads each replica's own.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from .. import clockseam, klog
from ..errors import NotFoundError
from . import instruments, journey, recorder

# ---------------------------------------------------------------------------
# the verdict catalog (closed vocabulary — never "unknown")
# ---------------------------------------------------------------------------

VERDICT_CONVERGED = "converged"
VERDICT_IN_FLIGHT = "in-flight"
VERDICT_PARKED_SETTLE = "parked-settle"
VERDICT_CIRCUIT_OPEN = "circuit-open"
VERDICT_QUOTA_PACED = "quota-paced"
VERDICT_BACKOFF = "backoff"
VERDICT_SHED = "shed"
VERDICT_UNOWNED_RESIZE = "unowned-resize"
VERDICT_NOT_OWNER = "not-owner"
VERDICT_INFORMER_UNSYNCED = "informer-unsynced"
VERDICT_NOT_MANAGED = "not-managed"
VERDICT_DELETED = "deleted"

VERDICTS = (
    VERDICT_CONVERGED,
    VERDICT_IN_FLIGHT,
    VERDICT_PARKED_SETTLE,
    VERDICT_CIRCUIT_OPEN,
    VERDICT_QUOTA_PACED,
    VERDICT_BACKOFF,
    VERDICT_SHED,
    VERDICT_UNOWNED_RESIZE,
    VERDICT_NOT_OWNER,
    VERDICT_INFORMER_UNSYNCED,
    VERDICT_NOT_MANAGED,
    VERDICT_DELETED,
)

# the reason codes a requeue/park/skip call site may literally assert
# (the subset of the catalog that is a *cause* a site can know, not a
# state the engine derives) — the unexplained-requeue lint rule keeps
# a literal copy and a sync test pins the two equal
REASON_CODES = frozenset({
    VERDICT_IN_FLIGHT,
    VERDICT_BACKOFF,
    VERDICT_CIRCUIT_OPEN,
    VERDICT_QUOTA_PACED,
    VERDICT_PARKED_SETTLE,
    VERDICT_SHED,
    VERDICT_NOT_OWNER,
})

# most-blocking first: the envelope's summary verdict and the fleet
# merge both pick the highest-priority verdict present.  ``converged``
# outranks the terminal non-answers: an object one controller manages
# and has converged, while another controller's predicate rejects it
# (a service without a hostname annotation, say), IS converged.
_PRIORITY = (
    VERDICT_CIRCUIT_OPEN,
    VERDICT_QUOTA_PACED,
    VERDICT_PARKED_SETTLE,
    VERDICT_SHED,
    VERDICT_BACKOFF,
    VERDICT_UNOWNED_RESIZE,
    VERDICT_INFORMER_UNSYNCED,
    VERDICT_IN_FLIGHT,
    VERDICT_NOT_OWNER,
    VERDICT_CONVERGED,
    VERDICT_NOT_MANAGED,
    VERDICT_DELETED,
)

# the non-terminal verdicts the agac_explain_blocked gauge exports a
# series for (terminal states never appear in a blocked histogram)
BLOCKED_VERDICTS = (
    VERDICT_IN_FLIGHT,
    VERDICT_PARKED_SETTLE,
    VERDICT_CIRCUIT_OPEN,
    VERDICT_QUOTA_PACED,
    VERDICT_BACKOFF,
    VERDICT_SHED,
    VERDICT_UNOWNED_RESIZE,
    VERDICT_NOT_OWNER,
    VERDICT_INFORMER_UNSYNCED,
)

# blocked_counts() classifies every in-flight journey — O(unconverged),
# fine at scrape cadence but not per label collection (the gauge has
# one series per blocked verdict), so one sweep is cached briefly
BLOCKED_CACHE_TTL = 1.0


def most_blocking(verdicts) -> str:
    """The highest-priority verdict present (``converged`` when the
    iterable is empty) — the envelope summary and the fleet merge."""
    present = set(verdicts)
    for verdict in _PRIORITY:
        if verdict in present:
            return verdict
    return VERDICT_CONVERGED


class _Worker:
    """One registered reconcile queue: the per-controller hooks a
    classification consults, all O(1) per key."""

    __slots__ = ("controller", "queue", "key_to_obj", "managed")

    def __init__(self, controller, queue, key_to_obj, managed=None):
        self.controller = controller
        self.queue = queue
        self.key_to_obj = key_to_obj
        self.managed = managed


def _resolve(value):
    """Wired planes may be live objects or late-bound callables (the
    manager wires its settle table after build)."""
    return value() if callable(value) else value


class ExplainEngine:
    """Assembles one blocked-on verdict + causal timeline per
    (controller, key) from the planes wired in.  Every input is
    optional: an unwired plane simply cannot contribute its verdicts,
    it never makes classification fail."""

    def __init__(
        self,
        journeys: Optional["journey.JourneyTracker"] = None,
        clock: Optional[Callable[[], float]] = None,
        identity: str = "",
        settle_table=None,
        health=None,
        shard_filter=None,
        resize_status: Optional[Callable[[], dict]] = None,
        informers_synced: Optional[Callable[[], bool]] = None,
        slo_shedding: Optional[Callable[[], bool]] = None,
        flight_recorder=None,
    ):
        # None = the process-global tracker at query time (it may be
        # install()ed after this engine is built — sim/bench isolation)
        self._journeys = journeys
        self._clock = clock or clockseam.monotonic
        self.identity = identity
        self._settle_table = settle_table
        self._health = health
        self._shard_filter = shard_filter
        self._resize_status = resize_status
        self._informers_synced = informers_synced
        self._slo_shedding = slo_shedding
        self._recorder = flight_recorder
        self._workers: dict[str, _Worker] = {}
        self._lock = threading.Lock()
        self._counts_cache: tuple[Optional[float], dict] = (None, {})
        self._metrics = None

    # ------------------------------------------------------------------
    # wiring
    # ------------------------------------------------------------------
    def register_worker(self, controller, queue, key_to_obj, managed=None) -> None:
        """Register one reconcile queue under its worker label (the
        same ``spec["name"]`` the journey plane keys on)."""
        with self._lock:
            self._workers[controller] = _Worker(controller, queue, key_to_obj, managed)

    def controllers(self) -> list[str]:
        with self._lock:
            return sorted(self._workers)

    def bind_metrics(self, registry=None) -> None:
        """Bind the ``agac_explain_blocked{reason}`` callback gauge:
        one series per blocked verdict, each reading the cached
        blocked-count sweep (so a scrape costs one O(unconverged)
        classification pass, not one per series)."""
        self._metrics = instruments.explain_instruments(registry)
        for verdict in BLOCKED_VERDICTS:
            self._metrics.blocked.labels(reason=verdict).set_function(
                lambda v=verdict: self.blocked_counts().get(v, 0)
            )

    def _count_query(self, surface: str) -> None:
        if self._metrics is not None:
            self._metrics.queries.labels(surface=surface).inc()

    def _journey_tracker(self):
        return self._journeys if self._journeys is not None else journey.tracker()

    def _flight_recorder(self):
        resolved = _resolve(self._recorder)
        return resolved if resolved is not None else recorder.flight_recorder()

    def ring_epoch(self) -> int:
        """The live resize epoch (0 when sharding/resize is not wired)
        — stamped into flight-recorder reconcile entries so a recorded
        outcome is attributable to the ring it ran under."""
        if self._resize_status is None:
            return 0
        try:
            return int((self._resize_status() or {}).get("epoch", 0))
        except Exception:
            return 0

    # ------------------------------------------------------------------
    # classification
    # ------------------------------------------------------------------
    def classify(self, controller: str, key: str) -> dict:
        """One (controller, key)'s verdict + detail + timeline.  Every
        consult is a per-key lookup (dict get / heap-index get) — never
        a fleet enumeration."""
        worker = self._workers.get(controller)
        detail: dict = {}
        verdict = self._verdict(controller, key, worker, detail)
        return {
            "controller": controller,
            "key": key,
            "verdict": verdict,
            "detail": detail,
            "timeline": self._timeline(controller, key),
        }

    def _verdict(self, controller, key, worker, detail) -> str:
        # 1. ownership: a key this replica's shards do not cover is
        # another replica's problem — report so, with the ring epoch,
        # and distinguish the transient mid-resize window
        shard_filter = _resolve(self._shard_filter)
        if shard_filter is not None and not shard_filter.all_shards:
            ownership = shard_filter.explain_key(key)
            if not ownership.get("owned", True):
                resize = {}
                if self._resize_status is not None:
                    try:
                        resize = self._resize_status() or {}
                    except Exception:
                        resize = {}
                detail.update(ownership)
                detail["ring_epoch"] = resize.get("epoch", 0)
                detail["resize_state"] = resize.get("state", "stable")
                if ownership.get("moving"):
                    # the drain/handoff window: the key left this
                    # replica (or has not been adopted yet) — the owner
                    # answer arrives once the transition's per-key
                    # protocol completes
                    return VERDICT_UNOWNED_RESIZE
                return VERDICT_NOT_OWNER

        # 2. a cache that never synced cannot answer object questions
        if self._informers_synced is not None and not self._informers_synced():
            detail["note"] = "informer caches have not completed their first sync"
            return VERDICT_INFORMER_UNSYNCED

        # 3. an in-flight journey: find WHERE the key currently waits
        journey_view = self._journey_tracker().view(controller, key)
        if journey_view is not None:
            detail["journey"] = journey_view
            return self._inflight_verdict(key, worker, detail)

        # 4. no journey: the object is terminal — converged, unmanaged,
        # or gone (single-key cache get, never a list)
        if worker is None:
            detail["note"] = f"no worker registered for controller {controller!r}"
            return VERDICT_NOT_MANAGED
        try:
            obj = worker.key_to_obj(key)
        except NotFoundError:
            detail["note"] = "object absent from the informer cache"
            return VERDICT_DELETED
        except Exception as err:
            detail["lookup_error"] = str(err)
            return VERDICT_NOT_MANAGED
        if worker.managed is not None and not worker.managed(obj):
            detail["note"] = "object exists but carries no managed marker"
            return VERDICT_NOT_MANAGED
        return VERDICT_CONVERGED

    def _inflight_verdict(self, key, worker, detail) -> str:
        now = self._clock()
        # parked on an AWS wait state?
        table = _resolve(self._settle_table)
        if table is not None:
            parked = table.parked_info(key)
            if parked is not None:
                detail["parked"] = {
                    "group": parked["group"],
                    "token": str(parked["token"]),
                    "parked_for_s": round(max(0.0, now - parked["parked_at"]), 3),
                    "deadline_in_s": round(parked["deadline"] - now, 3),
                }
                return VERDICT_PARKED_SETTLE
        # sitting in a backoff/requeue delay?
        if worker is not None:
            delayed = worker.queue.delayed_peek(key)
            if delayed is not None:
                detail["delayed"] = delayed
                reason = delayed.get("reason", "")
                if reason == VERDICT_CIRCUIT_OPEN:
                    health = _resolve(self._health)
                    if health is not None:
                        detail["open_circuits"] = health.open_services()
                    return VERDICT_CIRCUIT_OPEN
                if reason == VERDICT_QUOTA_PACED:
                    return VERDICT_QUOTA_PACED
                if reason == VERDICT_SHED:
                    return VERDICT_SHED
                if reason == VERDICT_IN_FLIGHT:
                    return VERDICT_IN_FLIGHT
                return VERDICT_BACKOFF
            if worker.queue.contains(key):
                detail["queue"] = "ready-or-processing"
                return VERDICT_IN_FLIGHT
        # journey open but the key is nowhere in the machinery: either
        # deferrable work is being shed under burn, or we caught the
        # instant between two queue moves
        if self._slo_shedding is not None:
            try:
                if self._slo_shedding():
                    detail["note"] = "work deferred under SLO budget burn"
                    return VERDICT_SHED
            except Exception:
                pass
        detail["note"] = "journey open; between queue movements"
        return VERDICT_IN_FLIGHT

    # ------------------------------------------------------------------
    # timeline
    # ------------------------------------------------------------------
    def _timeline(self, controller, key) -> list[dict]:
        """The causal timeline: the journey's opening stamp, then this
        key's flight-recorder entries oldest → newest (the ring buffer
        is bounded, so the scan is O(capacity), independent of fleet
        size), then the current wait if any."""
        events: list[dict] = []
        journey_view = self._journey_tracker().view(controller, key)
        if journey_view is not None:
            events.append({
                "event": "enqueued",
                "age_s": journey_view["age_s"],
                "trigger": journey_view["trigger"],
                "generation": journey_view["generation"],
                "journey": journey_view["id"],
            })
        try:
            entries = self._flight_recorder().dump()
        except Exception:
            entries = []
        for entry in entries:
            if entry.get("key") != key:
                continue
            if entry.get("controller") not in ("", None, controller):
                continue
            event = {
                "event": entry.get("kind", ""),
                "seq": entry.get("seq"),
                "time": entry.get("time"),
            }
            for field in ("result", "reason", "error", "duration", "ring_epoch"):
                if entry.get(field) not in ("", None):
                    event[field] = entry[field]
            events.append(event)
        if journey_view is not None:
            events.append({
                "event": "last-stage",
                "stage": journey_view["last_stage"],
                "reason": journey_view.get("last_reason", ""),
            })
        return events

    # ------------------------------------------------------------------
    # envelopes
    # ------------------------------------------------------------------
    def explain(
        self, key: str, controller: Optional[str] = None,
        surface: str = "debug-endpoint",
    ) -> dict:
        """The ``/debug/explain`` answer: per-controller verdicts for
        ``key`` (or just the named controller's), the replica identity
        and ring epoch, and a summary verdict (most blocking wins).
        Raises ``KeyError`` for an unregistered controller name (the
        endpoint's 404)."""
        self._count_query(surface)
        with self._lock:
            names = sorted(self._workers)
        if controller:
            if controller not in names:
                raise KeyError(controller)
            names = [controller]
        verdicts = {name: self.classify(name, key) for name in names}
        # an engine with no registered workers cannot vouch for
        # convergence — not-managed is the honest empty answer
        summary = (
            most_blocking(v["verdict"] for v in verdicts.values())
            if verdicts
            else VERDICT_NOT_MANAGED
        )
        return {
            "key": key,
            "identity": self.identity,
            "ring_epoch": self.ring_epoch(),
            "verdict": summary,
            "controllers": verdicts,
        }

    # ------------------------------------------------------------------
    # the blocked histogram (gauge + post-mortem table)
    # ------------------------------------------------------------------
    def blocked_counts(self) -> dict[str, int]:
        """Verdict → count over every in-flight journey — the
        ``agac_explain_blocked`` gauge's collection sweep.  O(number of
        unconverged objects); cached for ``BLOCKED_CACHE_TTL`` so the
        gauge's per-series callbacks share one sweep."""
        now = self._clock()
        stamp, cached = self._counts_cache
        if stamp is not None and 0 <= now - stamp < BLOCKED_CACHE_TTL:
            return cached
        counts: dict[str, int] = {}
        for controller, key in self._journey_tracker().inflight_keys():
            try:
                verdict = self.classify(controller, key)["verdict"]
            except Exception:
                continue
            counts[verdict] = counts.get(verdict, 0) + 1
        self._counts_cache = (now, counts)
        return counts

    def top_blocked(self, limit: int = 8) -> list[tuple[str, int]]:
        counts = self.blocked_counts()
        return sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:limit]

    def log_top_blocked(self, limit: int = 8) -> None:
        """Dump the top blocked-on table via klog — the SIGTERM
        post-mortem companion to the flight-recorder tail and the
        stack profiler's top table."""
        self._count_query("post-mortem")
        rows = self.top_blocked(limit)
        if not rows:
            return
        total = sum(count for _, count in rows)
        klog.infof("explain: top blocked-on verdicts (%d unconverged):", total)
        for reason, count in rows:
            klog.infof("  %6d  %s", count, reason)


# ---------------------------------------------------------------------------
# fleet merge (the `explain` CLI's resolution over --fleet-peers)
# ---------------------------------------------------------------------------


def merge_fleet_explains(answers: dict[str, dict]) -> dict:
    """Resolve per-peer ``/debug/explain`` answers into one fleet
    verdict: the owning shard's answer (any verdict that is not
    ``not-owner``/``unowned-resize``) is authoritative; non-owners only
    contribute their ring epoch.  Multiple owner-shaped answers (a
    resize race) resolve most-blocking-first; peers that failed to
    answer are reported, never silently dropped."""
    peers: dict[str, dict] = {}
    owners: list[tuple[str, dict]] = []
    for peer, answer in sorted(answers.items()):
        if not isinstance(answer, dict) or "error" in answer:
            peers[peer] = {
                "error": (answer or {}).get("error", "no answer")
                if isinstance(answer, dict)
                else "no answer",
            }
            continue
        verdict = answer.get("verdict", VERDICT_NOT_OWNER)
        peers[peer] = {
            "verdict": verdict,
            "identity": answer.get("identity", ""),
            "ring_epoch": answer.get("ring_epoch", 0),
        }
        if verdict not in (VERDICT_NOT_OWNER, VERDICT_UNOWNED_RESIZE):
            owners.append((peer, answer))
    if owners:
        ranked = {answer.get("verdict"): peer for peer, answer in owners}
        verdict = most_blocking(ranked)
        owner = ranked[verdict]
        authoritative = dict(answers[owner])
    else:
        owner = None
        verdict = most_blocking(
            info.get("verdict") for info in peers.values() if "verdict" in info
        ) if any("verdict" in info for info in peers.values()) else VERDICT_NOT_OWNER
        authoritative = {}
    return {
        "verdict": verdict,
        "owner": owner,
        "peers": peers,
        "answer": authoritative,
    }


# ---------------------------------------------------------------------------
# the process-global engine (manager wires the real one at build; the
# default is journey-tracker-only so every surface degrades gracefully)
# ---------------------------------------------------------------------------

_engine = ExplainEngine()


def engine() -> ExplainEngine:
    return _engine


def install(new_engine: ExplainEngine) -> ExplainEngine:
    """Swap the process engine (manager build / tests); returns the
    previous one so the caller can restore it."""
    global _engine
    previous = _engine
    _engine = new_engine
    return previous


def ring_epoch() -> int:
    """The installed engine's live resize epoch — the reconcile loop's
    one-call seam for stamping flight-recorder entries."""
    return _engine.ring_epoch()
