"""Per-shard lease membership and the elastic resharding
plane.

``leaderelection.py`` coordinates ONE active replica through one
Lease.  Sharding generalizes that to N named leases
(``agac-shard-<i>``): every live replica contends for shard leases up
to its configured capacity, renews what it holds, and steals leases
whose holder stopped renewing — the same observed-record/local-clock
freshness CAS the single-leader elector uses (one ``LeaderElection``
per shard lease, so the two paths can never drift on lease
semantics).

Safety argument the exclusive-ownership oracle leans on:

- a shard is claimed only through ``LeaderElection.try_acquire_or_renew``,
  which refuses while the lease is *fresh* (held and renewed within
  ``lease_duration`` on the local monotonic clock) — a live holder
  renewing every ``retry_period`` is never stolen from;
- a holder whose renew CAS fails (someone else stole an expired
  lease) drops the shard from its owned set IMMEDIATELY, before the
  next enqueue can consult the filter;
- a replica over capacity releases the lease only AFTER dropping the
  shard locally and after its workers' reconciles of the shard's keys
  have returned, and keeps renewing it until then, so the next
  claimant can never overlap with it.

Elastic resharding makes ``shard_count`` a LIVE target
instead of a boot constant.  The fleet coordinates through ONE extra
Lease record (``agac-shard-ring``) whose annotations carry the
authoritative ring description:

- ``agac.io/target-shards`` / ``agac.io/from-shards`` /
  ``agac.io/resize-epoch`` — the in-flight (or last completed)
  transition, written by ``request_resize`` (the
  ``resize-shards`` CLI);
- ``agac.io/drained-<i>`` — the per-shard DRAIN ack: the holder of
  old-ring shard ``i`` has stopped serving every key that re-homes
  away from ``i``, as of this epoch;
- ``agac.io/adopted-<j>`` — the per-shard HANDOFF ack: the holder of
  new-ring shard ``j`` has claimed its lease, run the reshard resync
  over the keys it gains, and now serves them.

The two-phase drain/handoff protocol per moving arc (old owner → new
owner), in marker order:

1. the old owner keeps serving a re-homed key until the gainer shard's
   lease is CLAIMED (the new owner is standing by);
2. the old owner then stops serving the moving keys, and writes its
   drain ack once none of its workers is still inside a reconcile of
   one of them (the filter's in-flight registry), so no reconcile of
   the old owner outlives its ack;
3. the new owner adopts only after observing every donor's drain ack:
   it starts serving, runs the reshard resync (journeys stamped
   ``trigger=resize``), and writes its handoff ack;
4. when every gainer has acked, all replicas flip to the new ring and
   obsolete leases (shrink) are released.

So no key is ever double-mutated (the old owner's last reconcile of it
returns strictly before the new owner starts) and no key is unowned
longer than one handoff window (the drain begins only once the adopter
is standing by; the window includes the old owner's reconciles still
in flight at the stop).  The sim's key-level exclusive-ownership oracle
holds *throughout* the transition, not just at the endpoints.

Placement is load-aware: every renew publishes the
replica's measured keys-owned into its lease records, claims prefer
the heaviest unclaimed shard while the replica is at-or-below the
lightest peer's load, an overloaded replica abstains from claiming
(unless a shard has sat unheld past an availability grace), and a
replica more than ``rebalance_hysteresis_keys`` above the lightest
peer sheds its lightest shard at most once per
``rebalance_cooldown_ticks`` — claims converge toward balance instead
of oscillating.

Quota division rides on ownership: a replica's share of the global
AWS budget is ``owned/shard_count`` (the manager feeds it to
``HealthTracker.set_quota_fraction``); during a transition the
denominator is ``max(from, to)``, so the fleet aggregate stays under
the global budget even while both numbering spaces have live leases.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

from .. import klog
from ..analysis import racecheck
from ..cluster.objects import Lease, LeaseSpec, ObjectMeta
from ..errors import AlreadyExistsError, ConflictError, NotFoundError
from ..leaderelection import LeaderElection, LeaderElectionConfig
from ..observability import instruments
from .ring import DEFAULT_VNODES, HashRing, RingTransition, transition_plan

# ring-lease annotation keys (the resize coordination record)
ANN_TARGET = "agac.io/target-shards"
ANN_FROM = "agac.io/from-shards"
ANN_EPOCH = "agac.io/resize-epoch"
ANN_DRAINED = "agac.io/drained-"   # + <shard> -> epoch
ANN_ADOPTED = "agac.io/adopted-"   # + <shard> -> epoch
# per-lease load publication (preferred-owner placement input)
ANN_KEYS_OWNED = "agac.io/keys-owned"
# the ring lease's replica-load board: one annotation per live
# replica (`agac.io/replica-load-<identity>` = "<beat>:<keys>"), so a
# replica holding NO leases is still visible to shed decisions — the
# joining-replica case lease annotations cannot cover.  Beats advance
# per publish; an entry whose beat stops advancing is ignored (and
# eventually pruned by any writer): a crashed replica must not keep
# attracting sheds.
ANN_LOAD = "agac.io/replica-load-"
LOAD_PUBLISH_TICKS = 5
LOAD_STALE_TICKS = 4 * LOAD_PUBLISH_TICKS

# resize states the /healthz sharding block reports
RESIZE_STABLE = "stable"
RESIZE_DRAINING = "draining"
RESIZE_ADOPTING = "adopting"

# recompute the (O(fleet)) per-shard key counts at most every N ticks:
# load decisions tolerate staleness; a 50k-key sim soak does not
# tolerate a full-fleet walk per 30s membership tick
LOAD_REFRESH_TICKS = 10

# a replica AT capacity in a STABLE ring probes foreign leases (and
# re-reads the ring lease) only every N ticks: at 8 shards x sub-second
# retry periods, per-tick probing floods the apiserver enough to delay
# renewals into spurious lease steals (observed as a cliff in the
# 4-shard bench point).  Below capacity, or mid-resize, every tick
# probes — claims and drain/handoff progress stay tick-latency.
PROBE_TICKS = 5

# how often a shutting-down replica re-checks its in-flight reconciles
# before releasing its leases (seconds; threaded runtime only)
RELEASE_POLL = 0.05

# per-ring-version key→shard memo bound (satellite: the SHA-256 ring
# walk is off the enqueue/drift/GC hot path once a key has been seen);
# past the cap lookups compute without caching rather than thrash
FILTER_MEMO_MAX_KEYS = 1 << 18
_FILTER_MEMO_MAX_RINGS = 3


@dataclass
class ShardingConfig:
    # 1 (default) disables the sharding plane entirely: single-process
    # semantics, every key owned, classic leader election untouched.
    # Under sharded mode this is the BOOT count; the live count follows
    # the ring lease (``resize-shards``).
    shard_count: int = 1
    # most shard leases one replica may hold; 0 = no cap (one survivor
    # may adopt the whole keyspace).  Failover coverage requires
    # (replicas - 1) * shards_per_replica >= shard_count.
    shards_per_replica: int = 0
    vnodes: int = DEFAULT_VNODES
    namespace: str = "kube-system"
    lease_prefix: str = "agac-shard"
    lease: LeaderElectionConfig = field(default_factory=LeaderElectionConfig)
    # lease holder identity; "" = a fresh uuid (production).  The sim
    # harness injects stable names so replays stay byte-identical.
    identity: str = ""
    # load-aware placement: the keys-owned gap to the
    # lightest peer below which claims stay index-ordered and no shard
    # is ever shed — the hysteresis that makes placement converge
    rebalance_hysteresis_keys: int = 8
    # membership ticks between voluntary sheds (and before a replica
    # re-claims a shard it shed)
    rebalance_cooldown_ticks: int = 6
    # ticks a shard may sit UNHELD before an overloaded replica claims
    # it anyway — availability beats balance
    unheld_grace_ticks: int = 4

    @property
    def enabled(self) -> bool:
        return self.shard_count > 1

    @property
    def max_shards(self) -> int:
        if self.shards_per_replica <= 0:
            return self.shard_count
        return min(self.shards_per_replica, self.shard_count)


class _TransitionView:
    """An immutable snapshot of one replica's in-flight transition —
    what the filter consults per key, without locking."""

    __slots__ = ("old_ring", "new_ring", "drained", "adopted")

    def __init__(
        self,
        old_ring: HashRing,
        new_ring: HashRing,
        drained: frozenset[int],
        adopted: frozenset[int],
    ):
        self.old_ring = old_ring
        self.new_ring = new_ring
        self.drained = drained
        self.adopted = adopted


class ShardFilter:
    """The ownership predicate every enqueue funnel, drift source and
    GC sweep consults.  ``owned`` is a live callable so the filter
    tracks membership changes with no re-wiring.

    Key→shard lookups are memoized per ring version: the SHA-256 ring walk runs once per (ring, key), so
    the enqueue/drift/GC gates pay a dict hit on every consult after
    the first — flat across shard widths (the bench micro-asserts it).

    During a live resize the membership supplies a ``transition``
    snapshot and the filter computes EFFECTIVE ownership: a key whose
    shard differs between the rings is served by its old owner until
    that owner drains, and by its new owner only once adopted — the
    drain/handoff protocol's per-key truth."""

    def __init__(
        self,
        ring: Optional[HashRing],
        owned: Callable[[], frozenset[int]],
        ring_provider: Optional[Callable[[], HashRing]] = None,
        transition: Optional[Callable[[], Optional[_TransitionView]]] = None,
        on_skip: Optional[Callable[[str], None]] = None,
    ):
        self._ring = ring
        self._owned = owned
        self._ring_provider = ring_provider
        self._transition = transition
        # called by ``with_shard_guard`` with each key a worker popped
        # but no longer serves
        self.on_skip = on_skip
        # ring.version -> {key: shard}; tiny dict of dicts so a
        # transition's two rings memoize independently
        self._memos: dict[str, dict[str, int]] = {}
        # one entry per worker inside a guarded process func, its key
        # (``with_shard_guard`` appends and removes; each is one atomic
        # list operation): the membership hands a key to another
        # replica (drain ack, shed, release) only once no worker of
        # this replica is still reconciling it
        self.inflight_keys: list[str] = []

    @property
    def all_shards(self) -> bool:
        return self._ring is None and self._ring_provider is None

    def _current_ring(self) -> Optional[HashRing]:
        if self._ring_provider is not None:
            return self._ring_provider()
        return self._ring

    def _shard_of(self, ring: HashRing, key: str) -> int:
        memo = self._memos.get(ring.version)
        if memo is None:
            if len(self._memos) >= _FILTER_MEMO_MAX_RINGS:
                # a third ring version means the older of the two
                # transition rings is dead: drop everything stale
                self._memos.clear()
            memo = self._memos.setdefault(ring.version, {})
        shard = memo.get(key)
        if shard is None:
            shard = ring.shard_for_key(key)
            if len(memo) < FILTER_MEMO_MAX_KEYS:
                memo[key] = shard
        return shard

    def owned_shards(self) -> frozenset[int]:
        if self._current_ring() is None:
            return frozenset({0})
        return self._owned()

    def owns_key(self, key: str) -> bool:
        ring = self._current_ring()
        if ring is None:
            return True
        view = self._transition() if self._transition is not None else None
        if view is None:
            return self._shard_of(ring, key) in self._owned()
        s_old = self._shard_of(view.old_ring, key)
        s_new = self._shard_of(view.new_ring, key)
        owned = self._owned()
        if s_old == s_new:
            # non-moving arc: continuous ownership through the resize
            return s_old in owned
        if s_new in owned and s_new in view.adopted:
            return True
        if s_old in owned:
            # the old owner serves a moving key until ITS drain ack —
            # written strictly before any adopter starts
            return s_old not in view.drained
        return False

    def explain_key(self, key: str) -> dict:
        """The explain plane's ownership probe: ``owns_key``'s verdict
        PLUS why — the key's shard(s), whether it is mid-move in a live
        resize, and which side of the drain/handoff protocol this
        replica sits on.  Same memoized lookups as ``owns_key``; O(1)
        per key."""
        ring = self._current_ring()
        if ring is None:
            return {"owned": True, "shard": 0, "moving": False}
        view = self._transition() if self._transition is not None else None
        owned = self._owned()
        if view is None:
            shard = self._shard_of(ring, key)
            return {"owned": shard in owned, "shard": shard, "moving": False}
        s_old = self._shard_of(view.old_ring, key)
        s_new = self._shard_of(view.new_ring, key)
        info = {
            "shard": s_old,
            "target_shard": s_new,
            "moving": s_old != s_new,
            "drained_here": s_old in owned and s_old in view.drained,
            "adopting_here": s_new in owned,
        }
        info["owned"] = self.owns_key(key)
        return info

    def inflight(self, ring: HashRing, shard: int, moving_to: Optional[HashRing] = None) -> list[str]:
        """Keys a worker is reconciling right now that ``ring`` puts on
        ``shard`` (and, with ``moving_to``, that the next ring puts
        elsewhere: the keys a drain of ``shard`` hands over)."""
        return [
            key for key in sorted(set(self.inflight_keys))
            if self._shard_of(ring, key) == shard
            and (moving_to is None or self._shard_of(moving_to, key) != shard)
        ]

    def owns(self, namespace: str, name: str) -> bool:
        return self.owns_key(f"{namespace}/{name}")

    def owns_obj(self, obj) -> bool:
        return self.owns(obj.metadata.namespace, obj.metadata.name)

    def token(self) -> str:
        """A stable label for the current owned set — the per-shard
        report key ``Manager.drift_tick`` / ``GarbageCollector`` store
        partial results under (the single-owner-merge fix)."""
        if self._current_ring() is None:
            return "all"
        owned = sorted(self._owned())
        return ",".join(map(str, owned)) if owned else "none"


# single-shard mode: one process owns the whole keyspace (the
# pre-sharding semantics every existing tier runs under)
OWNS_ALL = ShardFilter(None, lambda: frozenset({0}))  # agac-lint: ignore[shared-state-census] -- stateless sentinel; its only mutable is the idempotent shard memo


# ---------------------------------------------------------------------------
# resize request (the ``resize-shards`` CLI / sim verb)
# ---------------------------------------------------------------------------


def ring_lease_name(lease_prefix: str = "agac-shard") -> str:
    return f"{lease_prefix}-ring"


def _parse_markers(anns: dict, prefix: str, epoch: int) -> frozenset[int]:
    marks = set()
    for key, value in anns.items():
        if key.startswith(prefix) and value == str(epoch):
            try:
                marks.add(int(key[len(prefix):]))
            except ValueError:
                continue
    return frozenset(marks)


def resize_in_flight(anns: dict, vnodes: int = DEFAULT_VNODES) -> bool:
    """True while the ring lease describes a transition whose gainers
    have not all acked their handoffs."""
    try:
        target = int(anns.get(ANN_TARGET, 0) or 0)
        origin = int(anns.get(ANN_FROM, target) or target)
        epoch = int(anns.get(ANN_EPOCH, 0) or 0)
    except ValueError:
        return False
    if not target or origin == target:
        return False
    plan = transition_plan(HashRing(origin, vnodes), HashRing(target, vnodes))
    adopted = _parse_markers(anns, ANN_ADOPTED, epoch)
    return not plan.gainers <= adopted


def ring_status(
    client,
    namespace: str = "kube-system",
    lease_prefix: str = "agac-shard",
    vnodes: int = DEFAULT_VNODES,
) -> dict:
    """Read-only view of the ring lease for CLI/tooling: the live
    target shard count, the origin of any transition, the resize
    epoch, and whether a transition is still in flight.  Raises
    RuntimeError when the lease is absent (no sharded fleet)."""
    name = ring_lease_name(lease_prefix)
    try:
        lease = client.get("Lease", namespace, name)
    except NotFoundError:
        raise RuntimeError(
            f"ring lease {namespace}/{name} not found — is a sharded "
            "fleet (--shard-count >= 2) running?"
        )
    anns = dict(lease.metadata.annotations or {})
    target = int(anns.get(ANN_TARGET, 0) or 0)
    origin = int(anns.get(ANN_FROM, target) or target)
    epoch = int(anns.get(ANN_EPOCH, 0) or 0)
    return {
        "shard_count": target,
        "from_shards": origin,
        "epoch": epoch,
        "in_flight": resize_in_flight(anns, vnodes),
    }


def request_resize(
    client,
    target_count: int,
    namespace: str = "kube-system",
    lease_prefix: str = "agac-shard",
    vnodes: int = DEFAULT_VNODES,
    force: bool = False,
) -> int:
    """Set the fleet's live shard-count target by CAS-writing the ring
    lease: bumps the resize epoch, records from→to, and clears stale
    drain/handoff markers.  Every replica's next membership tick
    observes the new target and enters the drain/handoff transition.
    Returns the new epoch.  Refuses while a transition is in flight
    unless ``force`` (a superseding resize restarts the protocol)."""
    if target_count < 1:
        raise ValueError(f"target shard count must be >= 1, got {target_count}")
    name = ring_lease_name(lease_prefix)
    for _attempt in range(8):
        try:
            lease = client.get("Lease", namespace, name)
        except NotFoundError:
            raise RuntimeError(
                f"ring lease {namespace}/{name} not found — is a sharded "
                "fleet (--shard-count >= 2) running?"
            )
        anns = dict(lease.metadata.annotations or {})
        current = int(anns.get(ANN_TARGET, 0) or 0)
        epoch = int(anns.get(ANN_EPOCH, 0) or 0)
        if current == target_count:
            return epoch  # already there: idempotent no-op
        if not force and resize_in_flight(anns, vnodes):
            raise RuntimeError(
                f"resize to {anns.get(ANN_TARGET)} still in flight "
                f"(epoch {epoch}); retry once it completes, or force"
            )
        cleaned = {
            key: value
            for key, value in anns.items()
            if not key.startswith((ANN_DRAINED, ANN_ADOPTED))
        }
        cleaned[ANN_FROM] = str(current or target_count)
        cleaned[ANN_TARGET] = str(target_count)
        cleaned[ANN_EPOCH] = str(epoch + 1)
        lease.metadata.annotations = cleaned
        try:
            client.update("Lease", lease)
            return epoch + 1
        except ConflictError:
            continue
    raise RuntimeError(f"could not CAS the ring lease {namespace}/{name}")


class ShardMembership:
    """One replica's view of the N shard leases.

    ``tick(client)`` is the cooperative entry point (the sim harness
    schedules it; ``run`` wraps it in the threaded loop): observe the
    ring lease (entering/advancing/completing a resize transition),
    renew owned leases, drop lost ones, claim at most one
    unheld/expired lease while below capacity (load-aware, gainer
    shards first during a transition), and refresh the observed shard
    map."""

    def __init__(
        self,
        config: ShardingConfig,
        identity: Optional[str] = None,
        clock: Optional[Callable[[], float]] = None,
        registry=None,
        on_change: Optional[Callable[["ShardMembership"], None]] = None,
    ):
        self.config = config
        self.shard_count = config.shard_count  # LIVE count (ring lease)
        self.ring = HashRing(config.shard_count, config.vnodes)
        self._clock = clock
        self._electors: dict[int, LeaderElection] = {}
        # racecheck seam: instrumented when the lock-order watchdog is
        # armed (chaos/soak tiers), a plain Lock otherwise
        self._lock = racecheck.make_lock("sharding.membership")
        self._owned: frozenset[int] = frozenset()
        # last observed holder per shard (None = unheld/unknown) and a
        # version that bumps whenever the observed assignment changes —
        # the shard-map-version gauge
        self._observed: dict[int, Optional[str]] = {}
        self.map_version = 0
        self.on_change = on_change
        # ---- elastic resharding state ----
        self.next_ring: Optional[HashRing] = None
        self.plan: Optional[RingTransition] = None
        self.resize_epoch = 0
        self._drained_local: set[int] = set()
        # donor shards whose moving keys this replica stopped serving,
        # their drain ack waiting on reconciles still in flight
        self._draining_local: set[int] = set()
        self._adopted_local: set[int] = set()
        # gainer shards adopted locally whose reshard resync the
        # manager has not yet run (the ack marker waits on it)
        self._resync_pending: set[int] = set()
        # handoff markers whose CAS failed — retried next tick
        self._ack_pending: dict[str, str] = {}
        self._observed_drained: frozenset[int] = frozenset()
        self._observed_adopted: frozenset[int] = frozenset()
        self.resizes_completed = 0
        # ---- load-aware placement state ----
        # Manager wires this to a per-shard managed-key counter over
        # the informer caches; None (unit tests) = claim-order only
        self.fleet_key_counts: Optional[Callable[[], dict[int, int]]] = None
        self._load_cache: tuple[int, dict[int, int]] = (-LOAD_REFRESH_TICKS, {})
        self._observed_loads: dict[str, int] = {}  # holder identity -> keys
        self._unheld_streak: dict[int, int] = {}
        # shard -> (holder, renew time) its lease showed at the last peek
        self._peeked_records: dict[int, tuple] = {}
        self._recently_shed: dict[int, int] = {}
        self._last_shed_tick = -(10 ** 9)
        self._tick_serial = 0
        # shards this replica holds as the taker of last resort (an
        # availability-grace claim while overloaded, or a shed that
        # bounced back unclaimed): never shed these again until some
        # OTHER holder is observed — a shed into a fleet with no taker
        # would just re-orphan the keys
        self._last_resort: set[int] = set()
        # shards dropped locally whose lease is released once no
        # reconcile of their keys is in flight here
        self._release_pending: set[int] = set()
        # ring-lease load board state: publish beat + per-peer
        # (beat, tick-last-advanced) liveness tracking
        self._load_beat = 0
        self._published_load: Optional[int] = None
        self._board_seen: dict[str, tuple[int, int]] = {}
        self._board_loads: dict[str, int] = {}

        # quota-only hook: fired when the ring (the quota denominator)
        # changes without an ownership change — entering a transition.
        # Ownership changes and transition completion fire on_change.
        self.on_quota_change: Optional[Callable[["ShardMembership"], None]] = None
        # fired just before this replica starts serving keys another
        # process served (a claimed lease, an adopted gainer shard): a
        # process drops its read snapshots there, so no reconcile of
        # those keys reads AWS as it stood before the handover
        self.on_adopt: Optional[Callable[[], None]] = None
        # fired just after this replica hands keys it served to others
        # (a drain ack, a lost lease, a shed lease's release, a shard
        # the ring dropped, shutdown) with None, and with the key when
        # a worker pops a key it no longer serves: a process closes its
        # own record of those keys' in-flight work there, as the new
        # owner keeps its own.  Left unset where one record spans every
        # replica (the sim's fleet-wide journeys)
        self.on_release: Optional[Callable[[Optional[str]], None]] = None

        metrics = instruments.sharding_instruments(registry)
        self._metrics = metrics
        metrics.map_version.set_function(lambda: float(self.map_version))
        metrics.ring_shards.set_function(lambda: float(self.shard_count))
        metrics.resize_epoch.set_function(lambda: float(self.resize_epoch))
        metrics.resize_state.set_function(self._resize_state_value)
        metrics.handoff_pending.set_function(
            lambda: float(len(self._pending_gainers()))
        )
        self._m_steals = metrics.steals
        self._m_rebalances = metrics.rebalances
        self._m_resizes = metrics.resizes

        first = self._ensure_elector(0, identity=identity)
        self.identity = first.identity  # uuid unless injected
        for shard in range(1, config.shard_count):
            self._ensure_elector(shard)
        self.filter = ShardFilter(
            self.ring,
            self.owned_shards,
            ring_provider=lambda: self.ring,
            transition=self.transition_view,
            on_skip=self._released,
        )

    def _ensure_elector(self, shard: int, identity: Optional[str] = None):
        elector = self._electors.get(shard)
        if elector is None:
            elector = LeaderElection(
                f"{self.config.lease_prefix}-{shard}", self.config.namespace,
                config=self.config.lease,
                identity=identity or getattr(self, "identity", None),
                clock=self._clock,
            )
            elector.annotation_provider = self._lease_annotations
            self._electors[shard] = elector
            self._observed.setdefault(shard, None)
            self._metrics.lease_held.labels(shard=str(shard)).set_function(
                self._held_view(shard)
            )
        return elector

    def _held_view(self, shard: int) -> Callable[[], float]:
        return lambda: 1.0 if shard in self._owned else 0.0

    # ------------------------------------------------------------------
    def owned_shards(self) -> frozenset[int]:
        return self._owned

    def transition_view(self) -> Optional[_TransitionView]:
        """The filter's per-key transition snapshot; None while
        stable."""
        next_ring = self.next_ring
        if next_ring is None:
            return None
        return _TransitionView(
            self.ring, next_ring,
            frozenset(self._drained_local | self._draining_local),
            frozenset(self._adopted_local),
        )

    def quota_fraction(self) -> float:
        """This replica's slice of the global AWS budget: the quota is
        divided evenly per shard, and budget follows ownership.
        During a transition the denominator is the larger numbering
        space, so the fleet sum stays under the global budget while
        both rings have live leases.  A drained shard the next ring
        drops serves no key here any more and counts for nothing: its
        adopters may complete the transition, and take their slice of
        the smaller ring, before this replica does."""
        total = self.shard_count
        serving = self._owned
        if self.next_ring is not None:
            total = max(total, self.next_ring.shard_count)
            serving = serving - self._dropped_drained()
        return len(serving) / total

    def _dropped_drained(self) -> frozenset[int]:
        next_ring = self.next_ring
        if next_ring is None:
            return frozenset()
        return frozenset(s for s in self._drained_local if s >= next_ring.shard_count)

    def shard_map(self) -> dict:
        with self._lock:
            observed = dict(self._observed)
        return {
            "ring": self.ring.version,
            "version": self.map_version,
            "identity": self.identity,
            "owned": sorted(self._owned),
            "holders": {str(s): observed[s] for s in sorted(observed)},
            "live_shards": sum(1 for h in observed.values() if h),
        }

    # ------------------------------------------------------------------
    # resize status (the /healthz sharding block)
    # ------------------------------------------------------------------
    def _pending_gainers(self) -> list[int]:
        plan = self.plan
        if plan is None:
            return []
        acked = self._observed_adopted | frozenset(self._adopted_local)
        return sorted(plan.gainers - acked)

    def _resize_state(self) -> str:
        plan = self.plan
        if plan is None:
            return RESIZE_STABLE
        for shard in self._owned:
            if shard in plan.gainers_of and shard not in self._drained_local:
                return RESIZE_DRAINING
        return RESIZE_ADOPTING

    def _resize_state_value(self) -> float:
        return {
            RESIZE_STABLE: 0.0,
            RESIZE_DRAINING: 1.0,
            RESIZE_ADOPTING: 2.0,
        }[self._resize_state()]

    def resize_status(self) -> dict:
        status = {
            "state": self._resize_state(),
            "epoch": self.resize_epoch,
            "ring": self.ring.version,
            "shard_count": self.shard_count,
            "completed_total": self.resizes_completed,
        }
        if self.next_ring is not None:
            status.update(
                {
                    "target_ring": self.next_ring.version,
                    "from": self.shard_count,
                    "to": self.next_ring.shard_count,
                    "drained": sorted(
                        self._observed_drained | frozenset(self._drained_local)
                    ),
                    "adopted": sorted(
                        self._observed_adopted | frozenset(self._adopted_local)
                    ),
                    "pending_gainers": self._pending_gainers(),
                }
            )
        status["handoff_pending"] = len(self._pending_gainers())
        return status

    # ------------------------------------------------------------------
    # the membership tick
    # ------------------------------------------------------------------
    def tick(self, client) -> bool:
        """One membership round; returns True when the owned set
        changed (the manager rebalances quota and re-enqueues adopted
        keys on True)."""
        self._tick_serial += 1
        probe_due = (
            self.next_ring is not None
            or len(self._owned) < self.capacity()
            or bool(self._ack_pending)
            or self._tick_serial % PROBE_TICKS == 0
        )
        changed = False
        if probe_due:
            changed = self._sync_ring_lease(client)
        owned = set(self._owned)
        held = len(owned)
        # renew what we hold; a failed CAS means someone stole an
        # expired lease out from under a paused/partitioned replica —
        # drop the shard before anything else consults the filter
        for shard in sorted(owned):
            acquired, holder = self._electors[shard].try_acquire_or_renew(client)
            if acquired:
                self._observe(shard, self.identity)
            else:
                owned.discard(shard)
                self._publish(owned)
                changed = True
                self._electors[shard].set_leading(False)
                self._observe(shard, holder or None)
                klog.warningf(
                    "shard %d lease lost to %s (identity %s)",
                    shard, holder or "<unheld>", self.identity,
                )
        if len(owned) < held:
            self._released()
        self._renew_releasing(client)
        self._flush_releases(client)
        if probe_due:
            changed |= self._maybe_shed(client, owned)
            changed |= self._claim_one(client, owned)
            self._drive_transition(client)
            self._publish_load(client)
        if changed:
            self._m_rebalances.inc()
            if self.on_change is not None:
                self.on_change(self)
        return changed

    def _active_shards(self) -> list[int]:
        total = self.shard_count
        if self.next_ring is not None:
            total = max(total, self.next_ring.shard_count)
        return list(range(total))

    def capacity(self) -> int:
        total = len(self._active_shards())
        if self.config.shards_per_replica <= 0:
            return total
        return min(self.config.shards_per_replica, total)

    # ------------------------------------------------------------------
    # claims (load-aware preferred-owner placement)
    # ------------------------------------------------------------------
    def _claim_one(self, client, owned: set[int]) -> bool:
        """Claim at most one unheld/expired lease while below
        capacity; try_acquire_or_renew refuses fresh leases, so only
        unheld or expired ones are ever taken.  Candidates are probed
        first (keeping the observed map and peer loads honest), then
        ranked: gainer shards first during a transition (claims
        unblock the handoff), then by measured key weight while this
        replica is not overloaded."""
        candidates = []
        for shard in self._active_shards():
            if shard in owned:
                continue
            holder, renewed = self._peek_holder(client, shard)
            self._observe(shard, holder)
            if holder and renewed:
                self._unheld_streak.pop(shard, None)
            else:
                self._unheld_streak[shard] = self._unheld_streak.get(shard, 0) + 1
            candidates.append(shard)
        if len(owned) >= self.capacity():
            return False
        counts = self._key_counts()
        my_load = sum(counts.get(shard, 0) for shard in owned) if counts else 0
        peer_loads = self._peer_loads()
        overloaded = bool(
            counts
            and peer_loads
            and my_load > min(peer_loads) + self.config.rebalance_hysteresis_keys
        )
        gainers = self.plan.gainers if self.plan is not None else frozenset()

        def rank(shard: int) -> tuple:
            # gainers first (handoff progress), then heavy shards
            # (preferred-owner placement), index as the deterministic
            # tie-break — claim-order semantics when loads are unknown
            return (
                0 if shard in gainers else 1,
                -counts.get(shard, 0) if counts else 0,
                shard,
            )

        for shard in sorted(candidates, key=rank):
            shed_at = self._recently_shed.get(shard)
            if (
                shed_at is not None
                and self._tick_serial - shed_at < self.config.rebalance_cooldown_ticks
            ):
                continue  # never re-claim a shard just shed away
            if (
                overloaded
                and shard not in gainers
                and self._unheld_streak.get(shard, 0)
                <= self.config.unheld_grace_ticks
            ):
                # leave it for a lighter peer — unless it has sat
                # unheld past the availability grace
                continue
            elector = self._ensure_elector(shard)
            previous = elector.observed_holder()
            acquired, holder = elector.try_acquire_or_renew(client)
            if acquired:
                self._adopting()
                owned.add(shard)
                self._publish(owned)
                elector.set_leading(True)
                if overloaded or shard in self._recently_shed:
                    # availability-grace claim (or a shed that bounced
                    # back unclaimed): this replica is the taker of
                    # last resort — never shed the shard again until
                    # another holder is observed
                    self._last_resort.add(shard)
                self._observe(shard, self.identity)
                self._unheld_streak.pop(shard, None)
                if previous and previous != self.identity:
                    self._m_steals.inc()
                    klog.infof(
                        "shard %d lease stolen from expired holder %s",
                        shard, previous,
                    )
                else:
                    klog.infof("shard %d lease acquired", shard)
                return True
            self._observe(shard, holder or None)
        return False

    def _maybe_shed(self, client, owned: set[int]) -> bool:
        """Voluntary rebalance: a replica more than the hysteresis
        above the lightest live peer releases its lightest shard, at
        most once per cooldown — placement converges toward balance
        and the cooldown + re-claim embargo prevent oscillation."""
        if (
            self.next_ring is not None  # never rebalance mid-resize
            or len(owned) < 2
            or self.fleet_key_counts is None
            or self._tick_serial - self._last_shed_tick
            < self.config.rebalance_cooldown_ticks
        ):
            return False
        counts = self._key_counts()
        if not counts:
            return False
        my_load = sum(counts.get(shard, 0) for shard in owned)
        peer_loads = self._peer_loads()
        if not peer_loads:
            return False  # no live peer visible: keep everything
        if my_load - min(peer_loads) <= self.config.rebalance_hysteresis_keys:
            return False
        candidates = owned - self._last_resort
        if not candidates:
            return False  # everything held as taker of last resort
        victim = min(candidates, key=lambda shard: (counts.get(shard, 0), shard))
        # strict improvement: handing the victim to the lightest peer
        # must close the gap by more than the hysteresis, or the shed
        # is churn (e.g. the only shed-able shard IS the heavy one)
        if counts.get(victim, 0) > my_load - min(peer_loads) - (
            self.config.rebalance_hysteresis_keys
        ):
            return False
        # drop locally FIRST, then release once no reconcile of the
        # victim's keys is in flight here, so the claimant can never
        # overlap with us (the release_all ordering)
        owned.discard(victim)
        self._publish(owned)
        self._electors[victim].set_leading(False)
        self._release_pending.add(victim)
        self._flush_releases(client)
        self._observe(victim, None)
        self._recently_shed[victim] = self._tick_serial
        self._last_shed_tick = self._tick_serial
        klog.infof(
            "shard %d shed for rebalance (load %d vs lightest peer %d)",
            victim, my_load, min(peer_loads),
        )
        return True

    def _flush_releases(self, client) -> None:
        """Release every lease dropped locally whose keys no worker
        here is reconciling any more.  The keys leave this process at
        the release (until then no other replica can take them, and a
        claim back keeps them here)."""
        for shard in sorted(self._release_pending):
            if shard in self._owned:
                self._release_pending.discard(shard)  # claimed back
            elif not self.filter.inflight(self.ring, shard):
                self._release_pending.discard(shard)
                self._electors[shard].release(client)
                self._released()

    def _renew_releasing(self, client) -> None:
        """Renew every lease dropped locally whose release waits on a
        reconcile of its keys in flight here: the lease serves no key
        any more, but a lapse would let a peer claim it, and reconcile
        the same key, while that reconcile still runs."""
        for shard in sorted(self._release_pending - self._owned):
            if not self.filter.inflight(self.ring, shard):
                continue  # released by the flush that follows
            acquired, holder = self._electors[shard].try_acquire_or_renew(client)
            if not acquired:
                self._release_pending.discard(shard)
                self._observe(shard, holder or None)
                klog.warningf(
                    "shard %d lease lost to %s while its release waited on "
                    "reconciles in flight", shard, holder or "<unheld>",
                )

    def _adopting(self) -> None:
        if self.on_adopt is not None:
            self.on_adopt()

    def _released(self, key: Optional[str] = None) -> None:
        if self.on_release is not None:
            self.on_release(key)

    def _key_counts(self) -> dict[int, int]:
        if self.fleet_key_counts is None:
            return {}
        stamp, cached = self._load_cache
        if self._tick_serial - stamp < LOAD_REFRESH_TICKS:
            return cached
        try:
            counts = dict(self.fleet_key_counts())
        except Exception:
            counts = cached
        self._load_cache = (self._tick_serial, counts)
        return counts

    def _replica_load(self) -> int:
        counts = self._key_counts()
        return sum(counts.get(shard, 0) for shard in self._owned)

    def _lease_annotations(self) -> dict[str, str]:
        """Published into every lease record this replica writes: the
        measured keys-owned peers rank placement by."""
        if self.fleet_key_counts is None:
            return {}
        return {ANN_KEYS_OWNED: str(self._replica_load())}

    def _holder_is_live(self, identity: str) -> bool:
        with self._lock:
            return identity in self._observed.values()

    def _peer_loads(self) -> list[int]:
        """Peers' measured keys-owned, merged from two channels: the
        annotations on leases they hold (fresh, but invisible for a
        replica holding nothing) and the ring lease's load board
        (covers idle joiners; beat-staleness filtered)."""
        loads: dict[str, int] = {}
        for identity, load in self._observed_loads.items():
            if identity != self.identity and self._holder_is_live(identity):
                loads[identity] = load
        for identity, (beat, last_advance) in self._board_seen.items():
            if identity == self.identity:
                continue
            if self._tick_serial - last_advance > LOAD_STALE_TICKS:
                continue  # crashed/stopped publisher: ignore
            board_load = self._board_loads.get(identity)
            if board_load is not None:
                loads.setdefault(identity, board_load)
        return list(loads.values())

    def _read_board(self, anns: dict) -> None:
        seen_now = set()
        for key, value in anns.items():
            if not key.startswith(ANN_LOAD):
                continue
            identity = key[len(ANN_LOAD):]
            seen_now.add(identity)
            try:
                beat_str, load_str = value.split(":", 1)
                beat, load = int(beat_str), int(load_str)
            except ValueError:
                continue
            previous = self._board_seen.get(identity)
            if previous is None or beat > previous[0]:
                self._board_seen[identity] = (beat, self._tick_serial)
            self._board_loads[identity] = load
        for identity in list(self._board_seen):
            if identity not in seen_now:
                self._board_seen.pop(identity, None)
                self._board_loads.pop(identity, None)

    def _publish_load(self, client) -> None:
        """Publish this replica's measured load onto the ring lease's
        board — refreshed every LOAD_PUBLISH_TICKS (the beat is the
        liveness signal) or immediately when the load changed; prunes
        entries whose beat went stale (dead publishers)."""
        if self.fleet_key_counts is None:
            return
        load = self._replica_load()
        due = (
            load != self._published_load
            or self._tick_serial % LOAD_PUBLISH_TICKS == 0
        )
        if not due:
            return
        name = ring_lease_name(self.config.lease_prefix)
        try:
            lease = client.get("Lease", self.config.namespace, name)
            anns = dict(lease.metadata.annotations or {})
            self._load_beat += 1
            anns[f"{ANN_LOAD}{self.identity}"] = f"{self._load_beat}:{load}"
            for identity, (beat, last_advance) in list(self._board_seen.items()):
                if (
                    identity != self.identity
                    and self._tick_serial - last_advance > 2 * LOAD_STALE_TICKS
                ):
                    anns.pop(f"{ANN_LOAD}{identity}", None)
            lease.metadata.annotations = anns
            client.update("Lease", lease)
            self._published_load = load
        except Exception:
            return  # CAS conflict or hiccup: next publish retries

    def _peek_holder(self, client, shard: int) -> tuple[Optional[str], bool]:
        """(holder, renewed): the lease's holder, and whether its record
        changed since the last peek.  A holder that stops renewing (a
        killed replica) leaves its lease held, expired, and its last
        keys-owned behind; counted as unheld, it reaches the
        availability grace, so an overloaded survivor still claims the
        lease once it expires."""
        try:
            lease = client.get(
                "Lease", self.config.namespace,
                f"{self.config.lease_prefix}-{shard}",
            )
        except Exception:
            return None, False
        holder = lease.spec.holder_identity or None
        record = (holder, lease.spec.renew_time)
        renewed = self._peeked_records.get(shard) != record
        self._peeked_records[shard] = record
        if holder:
            raw = (lease.metadata.annotations or {}).get(ANN_KEYS_OWNED)
            if raw is not None:
                try:
                    self._observed_loads[holder] = int(raw)
                except ValueError:
                    pass
        return holder, renewed

    def _publish(self, owned: set[int]) -> None:
        self._owned = frozenset(owned)

    def _observe(self, shard: int, holder: Optional[str]) -> None:
        if holder is not None and holder != self.identity:
            # another taker exists: the shard is shed-able again and
            # the re-claim embargo is moot
            self._last_resort.discard(shard)
            self._recently_shed.pop(shard, None)
        with self._lock:
            if self._observed.get(shard) != holder:
                self._observed[shard] = holder
                self.map_version += 1

    # ------------------------------------------------------------------
    # the resize transition
    # ------------------------------------------------------------------
    def _sync_ring_lease(self, client) -> bool:
        """Observe (creating on first contact) the ring lease; enter a
        new transition when the target moved.  Returns True when the
        LIVE ring changed (the manager treats it like an ownership
        change: quota re-divided)."""
        name = ring_lease_name(self.config.lease_prefix)
        try:
            lease = client.get("Lease", self.config.namespace, name)
        except NotFoundError:
            lease = Lease(
                metadata=ObjectMeta(
                    name=name, namespace=self.config.namespace,
                    annotations={
                        ANN_TARGET: str(self.shard_count),
                        ANN_FROM: str(self.shard_count),
                        ANN_EPOCH: "0",
                    },
                ),
                spec=LeaseSpec(),
            )
            try:
                client.create("Lease", lease)
            except AlreadyExistsError:
                try:
                    lease = client.get("Lease", self.config.namespace, name)
                except Exception:
                    return False
            except Exception:
                return False
        except Exception:
            return False  # apiserver hiccup: keep the current state
        anns = dict(lease.metadata.annotations or {})
        self._read_board(anns)
        try:
            target = int(anns.get(ANN_TARGET, self.shard_count))
            origin = int(anns.get(ANN_FROM, target) or target)
            epoch = int(anns.get(ANN_EPOCH, 0) or 0)
        except ValueError:
            return False
        self._observed_drained = _parse_markers(anns, ANN_DRAINED, epoch)
        self._observed_adopted = _parse_markers(anns, ANN_ADOPTED, epoch)
        if epoch <= self.resize_epoch:
            return False
        if self.next_ring is None and target == self.shard_count:
            self.resize_epoch = epoch  # no-op epoch bump
            return False
        if self._begin_transition(origin, target, epoch):
            # the quota denominator moved to max(from, to) but no
            # shard changed hands yet: re-divide without triggering
            # the manager's full handoff resync
            if self.on_quota_change is not None:
                self.on_quota_change(self)
        return False

    def _begin_transition(self, origin: int, target: int, epoch: int) -> bool:
        """Arm the drain/handoff protocol toward ``target`` shards."""
        if self.next_ring is not None:
            # a superseding resize restarts the protocol from the
            # CURRENT live ring (whatever was adopted stays adopted
            # only if both rings agree — the new plan recomputes)
            klog.warningf(
                "resize superseded mid-flight: restarting toward %d shards "
                "(epoch %d)", target, epoch,
            )
        elif origin != self.shard_count:
            klog.warningf(
                "ring lease says the fleet is at %d shards but this replica "
                "booted at %d — trusting the lease", origin, self.shard_count,
            )
            self.shard_count = origin
            self.ring = HashRing(origin, self.config.vnodes)
        self.resize_epoch = epoch
        self._drained_local.clear()
        self._draining_local.clear()
        self._adopted_local.clear()
        self._resync_pending.clear()
        self._ack_pending.clear()
        if target == self.shard_count:
            self.next_ring = None
            self.plan = None
            return False
        self.next_ring = HashRing(target, self.config.vnodes)
        self.plan = transition_plan(self.ring, self.next_ring)
        for shard in self._active_shards():
            self._ensure_elector(shard)
        with self._lock:
            self.map_version += 1
        klog.infof(
            "resize epoch %d: %d -> %d shards (moves ~%.1f%% of the "
            "keyspace; gainers %s)",
            epoch, self.shard_count, target,
            100.0 * self.plan.moved_fraction, sorted(self.plan.gainers),
        )
        return True

    def _shard_claimed(self, shard: int) -> bool:
        if shard in self._owned:
            return True
        with self._lock:
            return bool(self._observed.get(shard))

    def _drive_transition(self, client) -> None:
        plan = self.plan
        if plan is None:
            self._flush_acks(client)
            return
        epoch = self.resize_epoch
        markers: dict[str, str] = {}
        drained_now: set[int] = set()
        # DONOR drain: stop serving moving keys once every gainer that
        # receives them is standing by (lease claimed), then ack the
        # drain once no worker here is still reconciling one of them:
        # the filter refuses the moving keys from the stop on, and the
        # ack waits out the reconciles that passed it before, so no
        # reconcile of this replica outlives its own ack
        for shard in sorted(self._owned):
            gainer_set = plan.gainers_of.get(shard)
            if gainer_set is None or shard in self._drained_local:
                continue
            if shard not in self._draining_local:
                if not all(self._shard_claimed(gainer) for gainer in gainer_set):
                    continue
                self._draining_local.add(shard)
                with self._lock:
                    self.map_version += 1
            if self.filter.inflight(self.ring, shard, moving_to=self.next_ring):
                continue
            # added before discarded, so the filter sees the shard in
            # one set or the other throughout
            self._drained_local.add(shard)
            self._draining_local.discard(shard)
            drained_now.add(shard)
            markers[f"{ANN_DRAINED}{shard}"] = str(epoch)
            klog.infof(
                "resize epoch %d: shard %d drained (gainers %s standing by)",
                epoch, shard, sorted(gainer_set),
            )
        # GAINER adopt: start serving the moving keys only once every
        # donor has acked its drain; the reshard resync (and then the
        # handoff ack) is driven by the manager, which owns the
        # informer caches the resync enumerates
        for shard in sorted(self._owned):
            donor_set = plan.donors_of.get(shard)
            if donor_set is None or shard in self._adopted_local:
                continue
            drained = self._observed_drained | frozenset(self._drained_local)
            if donor_set <= drained:
                self._adopting()
                self._adopted_local.add(shard)
                self._resync_pending.add(shard)
                with self._lock:
                    self.map_version += 1
                klog.infof(
                    "resize epoch %d: shard %d adopting (donors %s drained)",
                    epoch, shard, sorted(donor_set),
                )
        if markers:
            self._write_markers(client, markers)
            self._released()
            if self._dropped_drained() & drained_now:
                # a dropped shard's slice is free: re-divide now
                if self.on_quota_change is not None:
                    self.on_quota_change(self)
        self._flush_acks(client)
        # completion needs the MARKERS, not just local state: an
        # adopter that has not acked may still be mid-resync
        if plan.gainers <= self._observed_adopted or not plan.gainers:
            self._complete_transition(client)

    def resync_pending(self) -> frozenset[int]:
        """Gainer shards adopted locally whose reshard resync has not
        run yet — the manager drives the resync, then acks."""
        return frozenset(self._resync_pending)

    def moved_key_predicate(self) -> Callable[[str], bool]:
        """True for keys this replica gained in the in-flight resize —
        the resync's scope (non-moving keys need no re-enqueue)."""
        plan = self.plan
        adopted = frozenset(self._adopted_local)
        if plan is None or not adopted:
            return lambda key: False

        def moved(key: str) -> bool:
            new_shard = plan.new.shard_for_key(key)
            return new_shard in adopted and plan.old.shard_for_key(key) != new_shard

        return moved

    def ack_adoptions(self, client) -> None:
        """Write the handoff ack for every adopted shard whose resync
        just ran (manager calls this right after ``reshard_resync``)."""
        if not self._resync_pending:
            return
        markers = {
            f"{ANN_ADOPTED}{shard}": str(self.resize_epoch)
            for shard in self._resync_pending
        }
        self._resync_pending.clear()
        self._write_markers(client, markers)

    def _write_markers(self, client, markers: dict[str, str]) -> None:
        self._ack_pending.update(markers)
        self._flush_acks(client)

    def _flush_acks(self, client) -> None:
        if not self._ack_pending:
            return
        name = ring_lease_name(self.config.lease_prefix)
        try:
            lease = client.get("Lease", self.config.namespace, name)
            anns = dict(lease.metadata.annotations or {})
            epoch = str(self.resize_epoch)
            due = {
                key: value
                for key, value in self._ack_pending.items()
                if value == epoch and anns.get(ANN_EPOCH) == epoch
            }
            if not due:
                self._ack_pending.clear()
                return
            anns.update(due)
            lease.metadata.annotations = anns
            client.update("Lease", lease)
            self._ack_pending.clear()
            self._observed_drained = _parse_markers(
                anns, ANN_DRAINED, self.resize_epoch
            )
            self._observed_adopted = _parse_markers(
                anns, ANN_ADOPTED, self.resize_epoch
            )
        except Exception:
            return  # CAS conflict or hiccup: retried next tick

    def _complete_transition(self, client) -> None:
        target = self.next_ring.shard_count
        origin = self.shard_count
        self.ring = self.next_ring
        self.shard_count = target
        self.next_ring = None
        self.plan = None
        self._drained_local.clear()
        self._draining_local.clear()
        self._adopted_local.clear()
        self._resync_pending.clear()
        obsolete = sorted(shard for shard in self._owned if shard >= target)
        if obsolete:
            # drop locally first, then release (claimants never overlap)
            self._publish(set(self._owned) - set(obsolete))
            for shard in obsolete:
                elector = self._electors[shard]
                elector.set_leading(False)
                elector.release(client)
                self._observe(shard, None)
            self._released()
        with self._lock:
            self.map_version += 1
        self.resizes_completed += 1
        self._m_resizes.inc()
        klog.infof(
            "resize epoch %d complete: %d -> %d shards (owned %s)",
            self.resize_epoch, origin, target, sorted(self._owned),
        )
        # quota denominator changed even when ownership did not: the
        # manager must re-divide
        if self.on_change is not None:
            self.on_change(self)

    # ------------------------------------------------------------------
    def run(self, client, stop: threading.Event) -> None:
        """The threaded loop (one immediate tick, then every
        retry_period); the sim harness schedules ``tick`` itself."""
        klog.infof(
            "shard membership: identity %s contending for %d shards "
            "(capacity %d)",
            self.identity, self.shard_count, self.capacity(),
        )
        while not stop.is_set():
            try:
                self.tick(client)
            except Exception as err:  # a bad tick must not kill the loop
                klog.errorf("shard membership tick failed: %s", err)
            stop.wait(self.config.lease.retry_period)
        self.release_all(client)

    def release_all(self, client) -> None:
        """Clean shutdown: drop every shard locally FIRST, then release
        the leases so successors claim them without waiting out the
        lease duration.  Shutdown stays bounded: a lease whose keys a
        worker still reconciles after the renew deadline is renewed
        once and left to expire, not released."""
        owned = sorted(self._owned)
        self._publish(set())
        # the successor claims at once: let the reconciles that passed
        # the filter before the drop return first, for at most the
        # renew deadline (the longest a holder may go without renewing)
        waited = 0.0
        while self.filter.inflight_keys and waited < self.config.lease.renew_deadline:
            threading.Event().wait(RELEASE_POLL)
            waited += RELEASE_POLL
        for shard in sorted(set(owned) | self._release_pending):
            elector = self._electors[shard]
            elector.set_leading(False)
            if self.filter.inflight(self.ring, shard):
                # a reconcile of its keys outlived the wait: renew the
                # lease once more and let it expire, so no successor
                # claims the key for one lease duration, rather than
                # hand it over mid-mutation
                elector.try_acquire_or_renew(client)
                klog.warningf(
                    "shard %d: reconciles still in flight after %.1fs, "
                    "leaving its lease to expire", shard, waited,
                )
            else:
                elector.release(client)
        self._release_pending.clear()
        if owned:
            self._released()
        # clean shutdown removes this replica's load-board entry so
        # peers stop scoring placement against a gone replica
        try:
            name = ring_lease_name(self.config.lease_prefix)
            lease = client.get("Lease", self.config.namespace, name)
            anns = dict(lease.metadata.annotations or {})
            if anns.pop(f"{ANN_LOAD}{self.identity}", None) is not None:
                lease.metadata.annotations = anns
                client.update("Lease", lease)
        except Exception:
            pass
        if owned and self.on_change is not None:
            self.on_change(self)
