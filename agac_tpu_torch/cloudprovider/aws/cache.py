"""The coalesced read plane: discovery, topology, zone, record-set and
load-balancer caches.

The reference's hottest path is discovery: every reconcile lists ALL
accelerators and then calls ListTagsForResource per accelerator —
O(total accelerators) AWS calls per work item (reference
``pkg/cloudprovider/aws/global_accelerator.go:87-110``; flagged as the
hot spot in SURVEY.md §3.2).  This cache memoizes the
(accelerator, tags) snapshot for a short TTL and absorbs this
process's own writes, so:

- a converged steady state (resyncs, level-trigger re-reconciles)
  costs one AWS list per TTL window instead of per item;
- any local write is immediately visible, so a reconcile never acts
  on its own stale write;
- cross-process writes (another controller instance) are visible
  after at most the TTL — the same order of staleness the reference
  already tolerates between its 30 s informer resyncs, since
  reconciles are level-triggered and idempotent.

Opt-in: drivers constructed without a cache behave exactly like the
reference (fresh scan every call).

Two mechanisms keep creation storms O(N) instead of O(N^2):

- **Single-flight loading.**  Only one worker runs the O(N) scan at a
  time; concurrent missers wait for its snapshot instead of issuing
  duplicate scans.  (Measured under the shaped-latency bench at
  N=1000: without this, ~32 workers each re-scan on every miss.)
- **A write journal during loads.**  A write landing while a scan is
  in flight used to discard the scan's result (the scan may predate
  the write), so during a storm — where every item writes — no
  snapshot ever got stored and every reconcile paid a fresh O(N)
  scan.  Instead, writes made during a load are journaled and FOLDED
  INTO the loaded snapshot before it is stored: the writer knows
  exactly the (accelerator, tags) it wrote, so local knowledge
  repairs whatever the scan missed.  ``invalidate`` (external/unknown
  change) journaled during a load still prevents the store.

Snapshot entries are SHARED between callers, never copied per read:
``Accelerator`` and ``Tag`` are frozen dataclasses, and the snapshot
list itself is replaced wholesale, never mutated in place.  (A
defensive deepcopy per hit used to dominate the steady-state reconcile
profile.)

Beyond the two discovery caches, this module carries the three caches
of the coalesced VERIFICATION read plane: drift ticks used
to pay O(N) per-object reads — three GA list calls per accelerator,
one ListResourceRecordSets per hostname against a handful of shared
zones, and one single-name DescribeLoadBalancers per object.  The
read plane collapses those to ~one GA read per accelerator, one
record-set list per hosted zone per tick window, and multi-name
DescribeLoadBalancers wire calls:

- ``AcceleratorTopologyCache`` — per-accelerator (listener, endpoint
  group) chains, write-through from the driver's own mutate chains;
- ``RecordSetCache`` — per-zone record-set snapshots with the change
  batches the driver commits folded back in;
- ``LoadBalancerCoalescer`` — a TTL cache plus a gatherer that merges
  concurrent single-name lookups into one multi-name wire call.

All three are TICK-SCOPED by construction: drift verification exists
to catch out-of-band tampering, so snapshots are shared within one
verification round (TTLs well under any sane ``--drift-resync-period``)
and re-read on the next, and every mismatch/not-found path invalidates
the same way ``HostedZoneCache`` does.  Local writes are folded or
write-through applied, never masked.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Iterator, Optional

from ... import clockseam
from ...observability import instruments, trace

from .errors import ListenerNotFoundException
from .types import (
    CHANGE_ACTION_DELETE,
    Accelerator,
    EndpointGroup,
    Listener,
    LoadBalancer,
    ResourceRecordSet,
    Tag,
)

Snapshot = list[tuple[Accelerator, list[Tag]]]


class _FlightTimer:
    """Wall time of one cache's single-flight loads and of the callers
    parked behind them, by the cache's name in ``read_plane_stats``:
    the port-only histograms ``agac_read_plane_{load,wait}_seconds``
    and, in a sampled reconcile, ``read-plane-load:<cache>`` /
    ``read-plane-wait:<cache>`` trace spans.  Reads the cache's clock;
    changes nothing the cache does."""

    __slots__ = ("_clock", "_load", "_wait", "_load_span", "_wait_span")

    def __init__(self, cache: str, clock: Callable[[], float]):
        self._clock = clock
        self._load = instruments.read_plane_load_seconds().labels(cache=cache)
        self._wait = instruments.read_plane_wait_seconds().labels(cache=cache)
        self._load_span = f"read-plane-load:{cache}"
        self._wait_span = f"read-plane-wait:{cache}"

    @contextlib.contextmanager
    def loading(self) -> Iterator[None]:
        """Time the leader's load, whether it returns or raises."""
        start = self._clock()
        try:
            yield
        finally:
            end = self._clock()
            self._load.observe(end - start)
            trace.record(self._load_span, start, end)

    def waited(self, parked_at: float) -> None:
        """A caller parked behind a load is back; ``parked_at`` is the
        cache's clock when it counted itself a waiter (under the lock)."""
        end = self._clock()
        self._wait.observe(end - parked_at)
        trace.record(self._wait_span, parked_at, end)


class HostedZoneCache:
    """TTL snapshot of ALL hosted zones, so ``get_hosted_zone``'s
    parent-domain walk (reference ``route53.go:334-358``) runs in
    memory instead of costing ~2 ListHostedZonesByName probes per
    Route53 ensure — half the Route53 quota spend under the
    shaped-latency bench, against a zone set that is created by
    humans and changes about never.

    Staleness is handled at the callers, cheaply: a hostname that
    does NOT resolve in the snapshot falls back to a live walk (a
    zone created moments ago is still found, and the stale snapshot
    is dropped); a cached zone that was deleted out-of-band surfaces
    as NoSuchHostedZone on first use, which invalidates the snapshot
    so the retry re-reads.  Loads are single-flight: concurrent
    missers wait for one zone list instead of issuing their own."""

    def __init__(self, ttl: float = 60.0, clock: Optional[Callable[[], float]] = None):
        self._ttl = ttl
        self._clock = clock or clockseam.monotonic
        self._lock = threading.Lock()
        self._zones: Optional[list] = None
        self._by_name: Optional[dict] = None
        self._expires = 0.0
        self._load_event: Optional[threading.Event] = None
        self.hits = 0
        self.misses = 0
        self.waits = 0  # callers that parked behind another's load
        self._timer = _FlightTimer("zones", self._clock)

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses, "waits": self.waits}

    @staticmethod
    def _build_index(zones: list) -> dict:
        """name → zone, NAME-SORTED first-wins: Route53 allows
        duplicate zone names, and the live ListHostedZonesByName probe
        (max_items=1) returns the name-ordered first — sorting before
        setdefault keeps the cached walk's winner identical to the
        probe's regardless of ListHostedZones iteration order."""
        by_name: dict = {}
        for zone in sorted(zones, key=lambda z: z.name):
            by_name.setdefault(zone.name, zone)
        return by_name

    def zones(self, loader: Callable[[], list]) -> list:
        """The zone snapshot, loading through ``loader`` (a full
        ListHostedZones drain) when absent or expired."""
        while True:
            with self._lock:
                if self._zones is not None and self._clock() < self._expires:
                    self.hits += 1
                    return self._zones
                if self._load_event is None:
                    self._load_event = event = threading.Event()
                    self.misses += 1
                    break
                event = self._load_event
                self.waits += 1
                parked_at = self._clock()
            event.wait()
            self._timer.waited(parked_at)
        try:
            with self._timer.loading():
                zones = list(loader())
        except BaseException:
            with self._lock:
                self._load_event = None
            event.set()
            raise
        with self._lock:
            self._zones = zones
            self._by_name = self._build_index(zones)
            self._expires = self._clock() + self._ttl
            self._load_event = None
        event.set()
        return zones

    def zone_index(self, loader: Callable[[], list]) -> dict:
        """The name → zone index for the current snapshot, built once
        per load (not per walk)."""
        zones = self.zones(loader)
        with self._lock:
            if self._zones is zones and self._by_name is not None:
                return self._by_name
        # the snapshot changed between zones() and here (rare):
        # build from the list this caller actually holds
        return self._build_index(zones)

    def invalidate(self) -> None:
        with self._lock:
            self._zones = None
            self._by_name = None
            self._expires = 0.0


class DiscoveryCache:
    def __init__(
        self,
        ttl: float = 5.0,
        clock: Optional[Callable[[], float]] = None,
        degraded: Optional[Callable[[], bool]] = None,
        tags_ttl: Optional[float] = None,
    ):
        self._ttl = ttl
        self._clock = clock or clockseam.monotonic
        # incremental snapshot refresh: with tags_ttl set,
        # a reload may REUSE the tags of accelerators the previous
        # snapshot already knew (``reusable_tags``) instead of paying
        # one ListTagsForResource per accelerator per reload — local
        # writes are write-through (upsert) so they are always exact,
        # and out-of-band TAG edits are re-detected within tags_ttl
        # (a full tag re-list).  None (default) = legacy behavior:
        # every reload re-reads every accelerator's tags, and the tag
        # tamper-detection bound stays the snapshot TTL itself.
        self._tags_ttl = tags_ttl
        self._tags_loaded_at: Optional[float] = None
        self._tags_refreshing = False
        # arn -> tags an ``invalidate_keeping_tags`` kept from the
        # snapshot it dropped, reusable until a snapshot is loaded again
        self._kept_tags: Optional[dict] = None
        # health-plane hook (factory wires it to "is the GA circuit
        # open"): while True, an expired snapshot is served stale
        # instead of dispatching a reload that is known to fail —
        # bounded staleness beats a guaranteed error during a brownout
        self._degraded = degraded
        self._lock = threading.Lock()
        # the snapshot proper: arn -> (Accelerator, tags), plus an
        # inverted tag index (key, value) -> set of arns so tag-scan
        # queries (`match`) cost O(result), not O(fleet) — the 7-day
        # sim soak surfaced the linear scan as an O(N^2) convergence
        # wall at N=10k.  ``_list_cache`` memoizes the list view
        # ``get``/``peek`` hand out; any write drops it.
        self._entries: Optional[dict[str, tuple[Accelerator, list[Tag]]]] = None
        self._by_tag: dict[tuple[str, str], set[str]] = {}
        self._list_cache: Optional[Snapshot] = None
        self._expires = 0.0
        # set while a load is in flight; completion (success or not)
        # sets it.  Guarded by _lock.
        self._load_event: Optional[threading.Event] = None
        # writes observed while the in-flight load runs, replayed onto
        # the loaded snapshot before it is stored.  Guarded by _lock.
        self._journal: Optional[list] = None
        self.hits = 0
        self.misses = 0
        self.waits = 0  # callers that parked behind another's load
        self.stale_serves = 0  # expired snapshots served while degraded
        self.tag_full_refreshes = 0  # loads that re-read every tag set
        self.tag_incremental_loads = 0  # loads that reused known tags
        self._timer = _FlightTimer("discovery", self._clock)

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "waits": self.waits,
                "stale_serves": self.stale_serves,
                "tag_full_refreshes": self.tag_full_refreshes,
                "tag_incremental_loads": self.tag_incremental_loads,
            }

    def reusable_tags(self) -> dict:
        """arn → tags the in-flight loader may reuse instead of
        re-listing live (the incremental-refresh seam the driver's
        ``_load_discovery_snapshot`` consults).  Empty when the cache
        holds nothing, when incremental refresh is off (tags_ttl
        None), or when the tag set is due for a full re-read — the
        load that receives {} IS the full refresh, and its successful
        store restamps the tag clock."""
        with self._lock:
            now = self._clock()
            known = self._known_tags()
            due = (
                self._tags_ttl is None
                or known is None
                or self._tags_loaded_at is None
                or now >= self._tags_loaded_at + self._tags_ttl
            )
            if due:
                self.tag_full_refreshes += 1
                self._tags_refreshing = True
                return {}
            self.tag_incremental_loads += 1
            return known

    def _known_tags(self) -> Optional[dict]:
        """The snapshot's arn -> tags, or those an
        ``invalidate_keeping_tags`` kept (caller holds the lock)."""
        if self._entries is not None:
            return {arn: tags for arn, (_, tags) in self._entries.items()}
        return self._kept_tags

    @staticmethod
    def _build_index(
        entries: dict[str, tuple[Accelerator, list[Tag]]],
    ) -> dict[tuple[str, str], set[str]]:
        by_tag: dict[tuple[str, str], set[str]] = {}
        for arn, (_, tags) in entries.items():
            for tag in tags:
                by_tag.setdefault((tag.key, tag.value), set()).add(arn)
        return by_tag

    def _index_add(self, arn: str, tags: list[Tag]) -> None:
        for tag in tags:
            self._by_tag.setdefault((tag.key, tag.value), set()).add(arn)

    def _index_discard(self, arn: str, tags: list[Tag]) -> None:
        for tag in tags:
            bucket = self._by_tag.get((tag.key, tag.value))
            if bucket is not None:
                bucket.discard(arn)
                if not bucket:
                    del self._by_tag[(tag.key, tag.value)]

    def _ensure(self, loader: Callable[[], Snapshot]):
        """Guarantee a fresh snapshot, loading through ``loader`` when
        absent or expired; returns ``(entries, by_tag)`` — the stored
        structures on the normal path, transient ones when a journaled
        ``invalidate`` poisoned the store.

        The load runs OUTSIDE the lock (holding it across the O(N)
        scan would convoy all workers behind one loader) and is
        SINGLE-FLIGHT: a second misser waits for the first's snapshot
        instead of scanning again.  Writes that land during the scan
        are journaled and folded into the snapshot before it is
        stored, so a stale scan can never mask a newer local write."""
        while True:
            with self._lock:
                if self._entries is not None and self._clock() < self._expires:
                    self.hits += 1
                    return self._entries, self._by_tag
                if (
                    self._entries is not None
                    and self._degraded is not None
                    and self._degraded()
                ):
                    self.stale_serves += 1
                    return self._entries, self._by_tag
                if self._load_event is None:
                    self._load_event = event = threading.Event()
                    self._journal = []
                    self.misses += 1
                    break
                event = self._load_event
                self.waits += 1
                parked_at = self._clock()
            # another worker is already scanning: wait for its result,
            # then re-check (it may have failed — then we lead a retry)
            event.wait()
            self._timer.waited(parked_at)
        try:
            with self._timer.loading():
                snapshot = list(loader())
        except BaseException:
            with self._lock:
                self._load_event = None
                self._journal = None
                self._tags_refreshing = False
            event.set()
            raise
        with self._lock:
            journal = self._journal or []
            self._load_event = None
            self._journal = None
            discard = False
            entries = {
                accelerator.accelerator_arn: (accelerator, list(tags))
                for accelerator, tags in snapshot
            }
            for op, payload in journal:
                if op == "invalidate":
                    discard = True
                elif op == "upsert":
                    accelerator, tags = payload
                    entries[accelerator.accelerator_arn] = (accelerator, tags)
                elif op == "refresh":
                    known = entries.get(payload.accelerator_arn)
                    if known is not None:
                        entries[payload.accelerator_arn] = (payload, known[1])
                else:  # remove
                    entries.pop(payload, None)
            if discard:
                self._entries = None
                self._by_tag = {}
                self._list_cache = None
                self._expires = 0.0
                self._tags_refreshing = False
                result = (entries, self._build_index(entries))
            else:
                self._entries = entries
                self._by_tag = self._build_index(entries)
                self._list_cache = None
                self._expires = self._clock() + self._ttl
                if self._tags_refreshing:
                    # this load was a full tag refresh: restart the
                    # incremental-reuse window from its completion
                    self._tags_loaded_at = self._clock()
                    self._tags_refreshing = False
                result = (entries, self._by_tag)
        event.set()
        return result

    def get(self, loader: Callable[[], Snapshot]) -> Snapshot:
        """The full snapshot as a list of (accelerator, tags) pairs,
        loading when absent or expired (see ``_ensure``).  The list
        view is memoized until the next write, so repeated full walks
        (GC sweeps, drift ticks) share one materialization."""
        entries, _ = self._ensure(loader)
        with self._lock:
            if entries is self._entries:
                if self._list_cache is None:
                    self._list_cache = list(entries.values())
                return self._list_cache
        return list(entries.values())

    def match(
        self, loader: Callable[[], Snapshot], want: dict[str, str]
    ) -> Snapshot:
        """All (accelerator, tags) pairs whose tags contain every
        (key, value) in ``want``, answered from the inverted tag index
        in O(candidates of the rarest key) — for the owner-tag scans
        every reconcile issues, O(1) instead of O(fleet).  Results are
        ordered by arn so iteration order never depends on set/hash
        order (the sim's replay contract)."""
        entries, by_tag = self._ensure(loader)
        with self._lock:
            candidates: Optional[set[str]] = None
            for pair in want.items():
                bucket = by_tag.get(pair)
                if not bucket:
                    return []
                if candidates is None or len(bucket) < len(candidates):
                    candidates = bucket
            if candidates is None:
                return list(entries.values())
            result = []
            for arn in sorted(candidates):
                entry = entries.get(arn)
                if entry is not None and all(
                    (key, value) in by_tag and arn in by_tag[(key, value)]
                    for key, value in want.items()
                ):
                    result.append(entry)
        return result

    def peek(self) -> Optional[Snapshot]:
        """The current snapshot WITHOUT loading, even when expired —
        the settle poller's read (reconcile/pending.py): local writes
        are upserted write-through so the peek is exact for them, and
        the scheduler thread must never dispatch an O(N) scan."""
        with self._lock:
            if self._entries is None:
                return None
            if self._list_cache is None:
                self._list_cache = list(self._entries.values())
            return self._list_cache

    def invalidate_keeping_tags(self) -> None:
        """``invalidate`` for a change known to leave accelerators' tags
        as they were (this process starts serving keys another process
        served): the next load lists every accelerator anew, but reuses
        the tags of those it knew, within the tag window, as it does
        between full tag re-lists.  An owner tag never changes; another
        process's re-tag is an out-of-band tag edit, re-read within the
        window."""
        with self._lock:
            kept = self._known_tags()
        self.invalidate()
        with self._lock:
            self._kept_tags = kept

    def invalidate(self) -> None:
        """External/unknown change: drop the snapshot, and poison any
        in-flight load so its result is returned but not stored."""
        with self._lock:
            self._forget_kept_tags()
            self._entries = None
            self._by_tag = {}
            self._list_cache = None
            self._expires = 0.0
            if self._journal is not None:
                self._journal.append(("invalidate", None))

    def upsert(self, accelerator: Accelerator, tags: list[Tag]) -> None:
        """Fold a local create/update into the snapshot instead of
        discarding it.  During creation storms every item writes; a
        blanket invalidate would force a full O(N) rescan per write,
        making convergence O(N^2) AWS calls.  The writer knows exactly
        the (accelerator, tags) it wrote, so the snapshot can absorb
        it and stay warm.  Expiry is left unchanged: entries from the
        original load still refresh within the TTL, so cross-process
        staleness bounds are unaffected.  During an in-flight load the
        write is also journaled so the loaded snapshot cannot miss it."""
        entry = (accelerator, list(tags))
        with self._lock:
            if self._journal is not None:
                self._journal.append(("upsert", entry))
            if self._entries is not None:
                old = self._entries.get(accelerator.accelerator_arn)
                if old is not None:
                    self._index_discard(accelerator.accelerator_arn, old[1])
                self._entries[accelerator.accelerator_arn] = entry
                self._index_add(accelerator.accelerator_arn, entry[1])
                self._list_cache = None

    def _forget_kept_tags(self) -> None:
        self._kept_tags = None  # caller holds the lock

    def refresh(self, accelerator: Accelerator) -> None:
        """Fold a local change of an accelerator's own fields (a
        disable: ``enabled`` and ``status``) into the snapshot, its tags
        kept.  An accelerator the snapshot does not hold needs nothing:
        the next load lists it as it is.  During a load the change is
        journaled and folded into the loaded snapshot."""
        arn = accelerator.accelerator_arn
        with self._lock:
            if self._journal is not None:
                self._journal.append(("refresh", accelerator))
            old = self._entries.get(arn) if self._entries is not None else None
            if old is not None:
                self._entries[arn] = (accelerator, old[1])
                self._list_cache = None

    def remove(self, accelerator_arn: str) -> None:
        """Drop a locally deleted accelerator from the snapshot (same
        rationale and journal semantics as ``upsert``)."""
        with self._lock:
            if self._journal is not None:
                self._journal.append(("remove", accelerator_arn))
            if self._entries is not None:
                old = self._entries.pop(accelerator_arn, None)
                if old is not None:
                    self._index_discard(accelerator_arn, old[1])
                self._list_cache = None


# ---------------------------------------------------------------------------
# the coalesced verification read plane
# ---------------------------------------------------------------------------


class _TopologyEntry:
    """Per-accelerator chain state.  ``listener``/``endpoint_group``
    are the write-through-maintained data; ``verified_expires`` is the
    tick-scope window within which the chain counts as verified
    against AWS; ``full_expires`` bounds how long the write-through
    listener identity is trusted before a full relist (the detection
    bound for out-of-band listener *mutation*/addition — deletion is
    caught every verify, see ``AcceleratorTopologyCache``).
    ``creating_until``, when set, is the end of a pending-create record:
    this process created the accelerator and is building its chain, so
    the entry's members are exact without a read (``begin_create``)."""

    __slots__ = (
        "listener", "endpoint_group", "verified_expires", "full_expires",
        "load_event", "journal", "creating_until",
    )

    def __init__(self):
        self.listener: Optional[Listener] = None
        self.endpoint_group: Optional[EndpointGroup] = None
        self.verified_expires = 0.0
        self.full_expires = 0.0
        self.load_event: Optional[threading.Event] = None
        self.journal: Optional[list] = None
        self.creating_until = 0.0


class AcceleratorTopologyCache:
    """Per-accelerator (listener, endpoint group) chains for the drift
    verify path.

    The uncoalesced verify pays three GA reads per object per tick
    (ListListeners + ListEndpointGroups + ListTagsForResource).  This
    cache gets a converged tick down to ONE read per accelerator:

    - tags come from the shared discovery snapshot (the same data the
      tag-scan ownership match already read — re-listing them live
      bought nothing but quota spend);
    - the listener identity is write-through from the driver's own
      mutate chains (``upsert_listener``), so a cheap verify only has
      to confirm the chain tail: ONE ``ListEndpointGroups(listener)``
      call proves the listener still exists (GA raises
      ListenerNotFound for a deleted parent — and GA cannot delete a
      listener that still has endpoint groups, so a live endpoint
      group implies a live listener) AND returns the endpoint set for
      membership/weight drift checks.

    Freshness contract (tick-scoped):

    - ``verify_ttl`` is the verification dedup window — one cheap
      verify per accelerator per tick; it must sit well under the
      drift period (production periods are >= 300 s, default here
      15 s).  Writes REFRESH DATA but never mark a chain verified:
      verification means an actual AWS read.
    - ``full_ttl`` bounds trust in the write-through listener object:
      past it, the next load is a full relist (ListListeners +
      ListEndpointGroups), which also catches out-of-band listener
      port/protocol edits and extra listeners.
    - any not-found on the verify read falls back to a full load in
      the same flight; mismatch paths in the driver invalidate.

    A chain this process is creating is the one exception to "verify
    by reading": after its own ``CreateAccelerator`` the driver opens a
    pending-create record (``begin_create``).  AWS creates an
    accelerator with no listener, and until the record ends the entry
    holds exactly what the driver has written since, so ``chain``
    answers from it with no read: ListenerNotFound before the
    listener's create, (listener, None) after it.  The record ends at
    the endpoint group's write, at ``end_create`` (a create call that
    raised), at ``invalidate``/``remove``/``invalidate_all``, or
    ``verify_ttl`` after the chain's last write (a create that stalls
    reads AWS again); what it leaves is the write-through seed, not
    verified, as a chain created without the record would leave it.

    Loads are single-flight PER KEY with the same write-journal fold
    as ``DiscoveryCache``: a write-through landing mid-load repairs
    the loaded chain, an invalidate/remove poisons the store.
    """

    def __init__(
        self,
        verify_ttl: float = 15.0,
        full_ttl: float = 900.0,
        clock: Optional[Callable[[], float]] = None,
        pending_creates: bool = True,
    ):
        self._verify_ttl = verify_ttl
        self._full_ttl = full_ttl
        self._clock = clock or clockseam.monotonic
        # False only where a replay re-derives a run recorded by a
        # controller that read between the create stages
        # (``sim.replay``): ``begin_create`` then opens no record
        self._pending_creates = pending_creates
        self._lock = threading.Lock()
        self._entries: dict[str, _TopologyEntry] = {}
        self.hits = 0       # served from the verified window
        self.verifies = 0   # cheap single-read verifies
        self.misses = 0     # full relists
        self.waits = 0      # callers parked behind another's load
        self._timer = _FlightTimer("topology", self._clock)
        self._skipped = {
            stage: instruments.chain_create_reads_skipped_total().labels(stage=stage)
            for stage in ("listener", "endpoint_group")
        }

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "verifies": self.verifies,
                "misses": self.misses,
                "waits": self.waits,
                "entries": len(self._entries),
            }

    def chain(
        self,
        arn: str,
        full_loader: Callable[[str], tuple[Listener, Optional[EndpointGroup]]],
        verify_loader: Callable[[Listener], Optional[EndpointGroup]],
    ) -> tuple[Listener, Optional[EndpointGroup]]:
        """The verified (listener, endpoint_group) chain for ``arn``.

        ``full_loader(arn)`` is the 2-read relist (raises
        ListenerNotFound when the accelerator has no listener — the
        caller's create-if-missing path); ``verify_loader(listener)``
        is the 1-read tail check returning the endpoint group (or
        None) and raising ListenerNotFound when the cached listener is
        gone, which falls back to a full load in the same flight."""
        creating = False
        while True:
            with self._lock:
                entry = self._entries.get(arn)
                now = self._clock()
                if entry is not None and entry.creating_until:
                    if now < entry.creating_until:
                        creating, listener = True, entry.listener
                        break
                    entry = self._end_create_locked(arn, entry)
                if entry is not None and entry.load_event is None:
                    if entry.listener is not None and now < entry.verified_expires:
                        self.hits += 1
                        return entry.listener, entry.endpoint_group
                if entry is not None and entry.load_event is not None:
                    event = entry.load_event
                    self.waits += 1
                    parked_at = now
                else:
                    if entry is None:
                        entry = self._entries[arn] = _TopologyEntry()
                    entry.load_event = event = threading.Event()
                    entry.journal = []
                    cheap = entry.listener is not None and now < entry.full_expires
                    cached_listener = entry.listener
                    break
            event.wait()
            self._timer.waited(parked_at)

        if creating:
            # a pending-create record: the chain is what this process
            # has written since its CreateAccelerator
            if listener is None:
                self._skipped["listener"].inc()
                raise ListenerNotFoundException(arn)
            self._skipped["endpoint_group"].inc()
            return listener, None

        full = not cheap
        try:
            with self._timer.loading():
                if cheap:
                    self.verifies += 1
                    try:
                        listener = cached_listener
                        endpoint_group = verify_loader(cached_listener)
                    except ListenerNotFoundException:
                        # the write-through listener vanished out-of-band:
                        # relist in the same flight (it may have been
                        # recreated with a new arn by another actor)
                        full = True
                if full:
                    self.misses += 1
                    listener, endpoint_group = full_loader(arn)
        except BaseException as err:
            with self._lock:
                entry.load_event = None
                entry.journal = None
                # no listener at all (accelerator mid-create, chain
                # torn down, or the cached identity confirmed dead):
                # drop the entry so the caller's create path re-seeds
                # it via write-through instead of re-verifying a ghost
                if self._entries.get(arn) is entry and (
                    entry.listener is None
                    or isinstance(err, ListenerNotFoundException)
                ):
                    del self._entries[arn]
            event.set()
            raise

        with self._lock:
            journal = entry.journal or []
            entry.load_event = None
            entry.journal = None
            discard = False
            for op, payload in journal:
                if op in ("invalidate", "remove"):
                    discard = True
                elif op == "listener":
                    listener = payload
                elif op == "endpoint_group":
                    endpoint_group = payload
            if discard:
                if self._entries.get(arn) is entry:
                    del self._entries[arn]
            else:
                now = self._clock()
                entry.listener = listener
                entry.endpoint_group = endpoint_group
                entry.verified_expires = now + self._verify_ttl
                if full:
                    entry.full_expires = now + self._full_ttl
        event.set()
        return listener, endpoint_group

    # -- write-through from the driver's mutate chains ------------------
    def begin_create(self, arn: str) -> None:
        """This process has just created accelerator ``arn``, which AWS
        made with no listener: open its pending-create record, and
        with it the full-trust window a listener's write-through seed
        opens."""
        if not self._pending_creates:
            return
        with self._lock:
            entry = self._entries[arn] = _TopologyEntry()
            now = self._clock()
            entry.creating_until = now + self._verify_ttl
            entry.full_expires = now + self._full_ttl

    def end_create(self, arn: str) -> None:
        """A create call of ``arn``'s chain raised: end its
        pending-create record, so the next pass reads AWS."""
        with self._lock:
            entry = self._entries.get(arn)
            if entry is not None and entry.creating_until:
                self._end_create_locked(arn, entry)

    def _end_create_locked(
        self, arn: str, entry: _TopologyEntry
    ) -> Optional[_TopologyEntry]:
        """End ``entry``'s record (caller holds the lock); an entry with
        no listener yet is dropped, as a failed relist drops it.
        Returns what stays of the entry."""
        entry.creating_until = 0.0
        if entry.listener is None:
            del self._entries[arn]
            return None
        return entry

    def upsert_listener(self, arn: str, listener: Listener) -> None:
        """Fold a local listener create/update in.  A fresh entry is
        seeded with a full-trust window (the writer just created the
        chain, so the topology is known exactly) but NOT marked
        verified — drift verification means an actual AWS read, never
        trusting our own write."""
        with self._lock:
            entry = self._entries.get(arn)
            if entry is None:
                entry = self._entries[arn] = _TopologyEntry()
                entry.full_expires = self._clock() + self._full_ttl
            if entry.journal is not None:
                entry.journal.append(("listener", listener))
            entry.listener = listener
            if entry.creating_until:
                entry.creating_until = self._clock() + self._verify_ttl

    def upsert_endpoint_group(self, arn: str, endpoint_group: EndpointGroup) -> None:
        with self._lock:
            entry = self._entries.get(arn)
            if entry is None:
                return  # no chain context to attach to
            if entry.journal is not None:
                entry.journal.append(("endpoint_group", endpoint_group))
            entry.endpoint_group = endpoint_group
            entry.creating_until = 0.0

    def invalidate(self, arn: str) -> None:
        """External/unknown change to this chain: drop it, and poison
        any in-flight load so its result is returned but not stored."""
        with self._lock:
            entry = self._entries.get(arn)
            if entry is None:
                return
            if entry.journal is not None:
                entry.journal.append(("invalidate", None))
            else:
                del self._entries[arn]

    def invalidate_all(self) -> None:
        """Drop every cached chain (sharding reshard: the adopted
        keyspace was written by ANOTHER process, so every local
        snapshot is suspect)."""
        with self._lock:
            for arn, entry in list(self._entries.items()):
                if entry.journal is not None:
                    entry.journal.append(("invalidate", None))
                else:
                    del self._entries[arn]

    def remove(self, arn: str) -> None:
        """The accelerator was deleted locally (same journal semantics
        as ``invalidate``; kept separate for intent at call sites)."""
        self.invalidate(arn)

    def invalidate_endpoint_group(self, endpoint_group_arn: str) -> None:
        """An endpoint-group mutation landed by eg arn (the
        EndpointGroupBinding paths address groups directly): expire
        the verification window of whichever chain holds it so the
        next read re-verifies instead of serving the stale endpoint
        set.  O(entries) scan — in-memory, and eg mutates are orders
        rarer than reads."""
        with self._lock:
            for entry in self._entries.values():
                eg = entry.endpoint_group
                if eg is not None and eg.endpoint_group_arn == endpoint_group_arn:
                    entry.verified_expires = 0.0


def _wire_record_name(name: str) -> str:
    """Route53 returns names dot-terminated with ``*`` escaped as
    ``\\052``; snapshot entries must look like API responses so the
    driver's matching helpers work unchanged.  Idempotent."""
    if not name.endswith("."):
        name += "."
    return name if "\\052" in name else name.replace("*", "\\052", 1)


def _wire_record(record: ResourceRecordSet) -> ResourceRecordSet:
    """A normalized copy of a submitted record set, shaped like the
    service would return it (wire name, dot-terminated alias target)."""
    from .types import AliasTarget, ResourceRecord

    alias = record.alias_target
    if alias is not None:
        dns = alias.dns_name if alias.dns_name.endswith(".") else alias.dns_name + "."
        alias = AliasTarget(
            dns_name=dns,
            evaluate_target_health=alias.evaluate_target_health,
            hosted_zone_id=alias.hosted_zone_id,
        )
    return ResourceRecordSet(
        name=_wire_record_name(record.name),
        type=record.type,
        ttl=record.ttl,
        resource_records=[ResourceRecord(r.value) for r in record.resource_records],
        alias_target=alias,
    )


class RecordSetCache:
    """Per-hosted-zone record-set snapshots for the Route53 verify and
    cleanup paths.

    Hostnames cluster onto a handful of shared zones, so the
    per-object ``ListResourceRecordSets`` drain was the single biggest
    Route53 read family per drift tick (1,100 calls against ~10 zones
    in the bench fleet).  One snapshot per zone per tick window
    collapses that to one list per zone.

    Freshness: tick-scoped TTL (well under the drift period), plus the
    driver folds every change batch it successfully commits back into
    the snapshot (``apply_changes``) so a reconcile never acts on its
    own stale write, and invalidates the zone on InvalidChangeBatch /
    NoSuchHostedZone — the signatures of a snapshot that lied.  A
    stale-positive (record actually deleted after the load) is caught
    on the next tick's reload; a stale-negative CREATE fails loudly at
    AWS, invalidates, and the backoff retry re-reads — the same repair
    shape ``HostedZoneCache`` uses.

    Loads are single-flight per zone with the DiscoveryCache journal
    fold: changes applied while a load is in flight are replayed onto
    the loaded snapshot before it is stored."""

    def __init__(
        self,
        ttl: float = 15.0,
        clock: Optional[Callable[[], float]] = None,
        degraded: Optional[Callable[[], bool]] = None,
    ):
        self._ttl = ttl
        self._clock = clock or clockseam.monotonic
        # health-plane hook (factory wires it to "is the Route53
        # circuit open"): serve expired zone snapshots stale while the
        # service is down instead of dispatching doomed reloads —
        # degraded drift verification with bounded staleness
        self._degraded = degraded
        self._lock = threading.Lock()
        # zone id -> (snapshot, expires) / in-flight (event, journal)
        self._snapshots: dict[str, tuple[list[ResourceRecordSet], float]] = {}
        self._loading: dict[str, tuple[threading.Event, list]] = {}
        self.hits = 0
        self.misses = 0
        self.waits = 0
        self.stale_serves = 0  # expired snapshots served while degraded
        self._timer = _FlightTimer("record_sets", self._clock)

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "waits": self.waits,
                "zones": len(self._snapshots),
                "stale_serves": self.stale_serves,
            }

    def get(
        self, zone_id: str, loader: Callable[[], list[ResourceRecordSet]]
    ) -> list[ResourceRecordSet]:
        while True:
            with self._lock:
                cached = self._snapshots.get(zone_id)
                if cached is not None and self._clock() < cached[1]:
                    self.hits += 1
                    return cached[0]
                if (
                    cached is not None
                    and self._degraded is not None
                    and self._degraded()
                ):
                    self.stale_serves += 1
                    return cached[0]
                in_flight = self._loading.get(zone_id)
                if in_flight is None:
                    event = threading.Event()
                    self._loading[zone_id] = (event, [])
                    self.misses += 1
                    break
                event = in_flight[0]
                self.waits += 1
                parked_at = self._clock()
            event.wait()
            self._timer.waited(parked_at)
        try:
            with self._timer.loading():
                snapshot = list(loader())
        except BaseException:
            with self._lock:
                self._loading.pop(zone_id, None)
            event.set()
            raise
        with self._lock:
            _, journal = self._loading.pop(zone_id, (None, []))
            discard = False
            for op, payload in journal:
                if op == "invalidate":
                    discard = True
                else:  # ("changes", list[Change])
                    snapshot = self._fold_changes(snapshot, payload)
            if not discard:
                self._snapshots[zone_id] = (snapshot, self._clock() + self._ttl)
        event.set()
        return snapshot

    @staticmethod
    def _fold_changes(snapshot: list[ResourceRecordSet], changes: list) -> list:
        """Replay a committed change batch onto a snapshot, returning
        a NEW list (snapshots are shared, never mutated in place)."""
        result = list(snapshot)
        for change in changes:
            record = _wire_record(change.record_set)
            key = (record.name, record.type)
            result = [r for r in result if (r.name, r.type) != key]
            if change.action != CHANGE_ACTION_DELETE:
                result.append(record)
        return result

    def apply_changes(self, zone_id: str, changes: list) -> None:
        """Fold a change batch this process successfully committed into
        the zone snapshot (write-through), and journal it into any
        in-flight load so the loaded snapshot cannot miss it."""
        with self._lock:
            in_flight = self._loading.get(zone_id)
            if in_flight is not None:
                in_flight[1].append(("changes", changes))
            cached = self._snapshots.get(zone_id)
            if cached is not None:
                self._snapshots[zone_id] = (
                    self._fold_changes(cached[0], changes), cached[1]
                )

    def invalidate(self, zone_id: str) -> None:
        with self._lock:
            self._snapshots.pop(zone_id, None)
            in_flight = self._loading.get(zone_id)
            if in_flight is not None:
                in_flight[1].append(("invalidate", None))

    def invalidate_all(self) -> None:
        with self._lock:
            self._snapshots.clear()
            for _, journal in self._loading.values():
                journal.append(("invalidate", None))


class _LBBatch:
    __slots__ = ("names", "event", "results", "error", "closed", "split", "settled")

    def __init__(self):
        self.names: set[str] = set()
        self.event = threading.Event()
        self.results: dict[str, LoadBalancer] = {}
        self.error: Optional[BaseException] = None
        self.closed = False
        # real ELBv2 fails the WHOLE call when any requested name is
        # missing; a split batch degrades members to single fetches
        self.split = False
        # set once the leader recorded an outcome; a wake-up without it
        # (leader died mid-fetch) degrades joiners to single fetches
        self.settled = False


class LoadBalancerCoalescer:
    """Batches concurrent single-name ``DescribeLoadBalancers`` lookups
    into multi-name wire calls behind a short TTL cache.

    Every reconcile of every controller starts with one LB lookup, so
    a drift tick fires ~N concurrent single-name describes.  The wire
    protocol already takes up to 20 names per call
    (``Names.member.N``, real_backend.py) — the first misser of a
    window becomes the batch leader, waits ``batch_window`` for
    co-missers, and issues ONE describe for the gathered names; the
    TTL then shares each result across the controllers that look up
    the same LB in the same tick (GA + EndpointGroupBinding both
    resolve ``benchNNNN``-style names).

    Freshness: the TTL is tick-scoped (LB state/dns drift is re-read
    every round); results are never negatively cached — a name absent
    from a response returns None to the caller (the driver raises its
    usual LoadBalancerNotFound) and the next lookup goes to the wire.
    Real ELBv2 fails an entire multi-name call when ANY name is
    unknown, so a LoadBalancerNotFound on a multi-name batch degrades
    that batch to per-name fetches instead of poisoning 19 healthy
    lookups."""

    # DescribeLoadBalancers accepts at most 20 names per call
    MAX_BATCH = 20

    def __init__(
        self,
        ttl: float = 15.0,
        batch_window: float = 0.01,
        clock: Optional[Callable[[], float]] = None,
        sleep: Optional[Callable[[float], None]] = None,
    ):
        self._ttl = ttl
        self._batch_window = batch_window
        self._clock = clock or clockseam.monotonic
        self._sleep = sleep or clockseam.sleep
        self._lock = threading.Lock()
        self._cache: dict[str, tuple[LoadBalancer, float]] = {}
        self._forming: Optional[_LBBatch] = None
        self.hits = 0
        self.misses = 0
        self.waits = 0          # joiners that parked on a leader's batch
        self.batches = 0        # wire calls issued (incl. split singles)
        self.batch_sizes: dict[int, int] = {}  # size -> count

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "waits": self.waits,
                "batches": self.batches,
                "batch_sizes": dict(sorted(self.batch_sizes.items())),
            }

    def _record_batch(self, size: int) -> None:
        self.batches += 1
        self.batch_sizes[size] = self.batch_sizes.get(size, 0) + 1

    def _store(self, lbs: list[LoadBalancer]) -> None:
        expires = self._clock() + self._ttl
        for lb in lbs:
            self._cache[lb.load_balancer_name] = (lb, expires)

    def get(
        self, name: str, fetch: Callable[[list[str]], list[LoadBalancer]]
    ) -> Optional[LoadBalancer]:
        """The load balancer named ``name``, or None if AWS does not
        know it.  ``fetch(names)`` is the raw multi-name describe."""
        with self._lock:
            cached = self._cache.get(name)
            if cached is not None and self._clock() < cached[1]:
                self.hits += 1
                return cached[0]
            self.misses += 1
            batch = self._forming
            if (
                batch is not None
                and not batch.closed
                and len(batch.names | {name}) <= self.MAX_BATCH
            ):
                batch.names.add(name)
                leader = False
                self.waits += 1
            else:
                batch = _LBBatch()
                batch.names.add(name)
                self._forming = batch
                leader = True

        if leader:
            try:
                if self._batch_window > 0:
                    self._sleep(self._batch_window)  # gather co-missers
                with self._lock:
                    batch.closed = True
                    if self._forming is batch:
                        self._forming = None
                    names = sorted(batch.names)
                try:
                    found = fetch(names)
                except Exception as err:
                    if len(names) > 1 and _is_lb_not_found(err):
                        # real-AWS all-or-nothing semantics: one unknown
                        # name failed the whole call — degrade to singles
                        batch.split = True
                    else:
                        batch.error = err
                else:
                    with self._lock:
                        self._store(found)
                        self._record_batch(len(names))
                    batch.results = {lb.load_balancer_name: lb for lb in found}
                batch.settled = True
            finally:
                # even a BaseException mid-fetch must wake the joiners
                # (an unset event would park them forever); an unsettled
                # wake-up degrades them to their own single fetches
                if not batch.settled:
                    batch.split = True
                batch.event.set()
        else:
            batch.event.wait()

        if batch.error is not None:
            raise batch.error
        if batch.split:
            found = fetch([name])  # may raise not-found: caller's contract
            with self._lock:
                self._store(found)
                self._record_batch(1)
            for lb in found:
                if lb.load_balancer_name == name:
                    return lb
            return None
        return batch.results.get(name)


def _is_lb_not_found(err: BaseException) -> bool:
    code = getattr(err, "code", "")
    return isinstance(code, str) and "LoadBalancerNotFound" in code
