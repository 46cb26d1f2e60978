"""Controller manager: registry + lifecycle + the health endpoint.

Capability parity with the reference's ``pkg/manager/`` (136 LoC): a
named registry of controller initializers, one shared informer factory
with a 30 s resync (``manager.go:52-53``), controllers launched in
their own threads, informers started after registration, and a join
that returns when the stop event fires.

One difference by design: a single ``ClusterClient`` serves both the
built-in kinds and the CRD (the reference needs two generated
clientsets + two informer factories; the generic cluster layer makes
that split unnecessary).

Beyond the reference: the API health plane.  The manager
optionally carries a ``HealthTracker``; ``drift_tick`` skips
controllers whose backing service circuits are open (marking the tick
partial instead of issuing verify reads into an outage), shutdown
names the reconcile key any straggler thread is wedged on, a watchdog
surfaces stuck workers, and ``make_health_server`` serves
``/healthz`` + ``/readyz`` (stdlib server, same pattern as
``webhook/server.py``) reporting per-circuit state and worker
liveness for deployment probes.

And the crash-recovery plane: when
``ControllerConfig.garbage_collector.interval > 0`` the manager runs
the orphan GC sweeper (``controllers/garbagecollector.py``) on its own
daemon thread, sharing the controllers' informer caches and cloud
factory; ``gc_sweep()`` drives one sweep explicitly (bench/tests, the
``drift_tick`` pattern) and ``/healthz`` carries ``gc_status()``.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from . import clockseam, klog
from .cloudprovider.aws import health as api_health
from .cluster import ClusterClient, SharedInformerFactory
from .observability import fleet as obs_fleet
from .observability import journey as obs_journey
from .observability import metrics as obs_metrics
from .observability import profile as obs_profile
from .observability import recorder as obs_recorder
from .observability import stackprof as obs_stackprof
from .observability import slo as obs_slo
from .observability import explain as obs_explain
from .controllers import (
    EndpointGroupBindingConfig,
    EndpointGroupBindingController,
    GarbageCollector,
    GarbageCollectorConfig,
    GlobalAcceleratorConfig,
    GlobalAcceleratorController,
    Route53Config,
    Route53Controller,
)
from .controllers.common import CloudFactory
from .observability import instruments as obs_instruments
from .sharding import OWNS_ALL, ShardMembership, ShardingConfig
from .sharding.reports import merge_shard_reports

INFORMER_RESYNC_PERIOD = 30.0

# a worker on one reconcile key longer than this is "stuck" for the
# watchdog and /healthz (a healthy reconcile is seconds; the longest
# legitimate hold is the 180 s settle poll)
WORKER_STUCK_THRESHOLD = 300.0


@dataclass
class ControllerConfig:
    global_accelerator: GlobalAcceleratorConfig = field(
        default_factory=GlobalAcceleratorConfig
    )
    route53: Route53Config = field(default_factory=Route53Config)
    endpoint_group_binding: EndpointGroupBindingConfig = field(
        default_factory=EndpointGroupBindingConfig
    )
    # the orphan GC sweeper; interval 0 (default) disables
    garbage_collector: GarbageCollectorConfig = field(
        default_factory=GarbageCollectorConfig
    )
    # poll-tick period of the pending-settle scheduler: how
    # often parked reconcile items (accelerator settles, change-batch
    # commits, cross-controller waits) are re-checked in coalesced
    # reads and requeued.  Only takes effect when a settle table is
    # passed to Manager.run; the checks are cheap (one coalesced list
    # + in-memory peeks), so 1 s keeps resolve latency ~1 tick.
    settle_poll_interval: float = 1.0
    # the horizontal sharding plane: shard_count > 1 runs
    # this replica as one of several concurrently-live controllers,
    # each owning the keys its shard leases cover
    sharding: ShardingConfig = field(default_factory=ShardingConfig)


InitFunc = Callable[
    [
        ClusterClient,
        SharedInformerFactory,
        ControllerConfig,
        Optional[CloudFactory],
        object,  # shard filter (sharding.ShardFilter)
    ],
    object,
]


def new_controller_initializers() -> dict[str, InitFunc]:
    """The controller registry (reference ``manager.go:34-40``)."""
    return {
        "global-accelerator-controller": lambda client, informers, config, cloud, shards: GlobalAcceleratorController(
            client, informers, config.global_accelerator, cloud, shard_filter=shards
        ),
        "route53-controller": lambda client, informers, config, cloud, shards: Route53Controller(
            client, informers, config.route53, cloud, shard_filter=shards
        ),
        "endpoint-group-binding-controller": lambda client, informers, config, cloud, shards: EndpointGroupBindingController(
            client, informers, config.endpoint_group_binding, cloud, shard_filter=shards
        ),
    }


class Manager:
    def __init__(
        self,
        resync_period: float = INFORMER_RESYNC_PERIOD,
        health: Optional["api_health.HealthTracker"] = None,
        heartbeats: Optional["api_health.WorkerHeartbeats"] = None,
        metrics_registry: Optional["obs_metrics.MetricsRegistry"] = None,
    ):
        self._resync_period = resync_period
        self._health = health
        self.heartbeats = heartbeats or api_health.worker_heartbeats()
        # the registry the GC sweeper's counters land in;
        # None keeps a private one per manager (unit tiers build many
        # managers per process), cmd/root and the bench pass the
        # process-global registry so /metrics carries the gc series
        self.metrics_registry = (
            metrics_registry
            if metrics_registry is not None
            else obs_metrics.MetricsRegistry()
        )
        self.controllers: dict[str, object] = {}
        # the shared informer factory build() wired (None until then)
        self.informer_factory: Optional[SharedInformerFactory] = None
        # per-shard drift reports keyed by ownership token ("all" in
        # single-shard mode); the legacy ``last_drift_report`` view
        # merges them additively so a second shard's tick can never
        # silently overwrite the first (the single-owner-merge fix)
        self.last_drift_reports: dict[str, dict] = {}
        # the sharding plane, built by build() when
        # config.sharding.shard_count > 1; the filter defaults to
        # owns-everything single-shard semantics
        self.shard_membership: Optional[ShardMembership] = None
        self.shard_filter = OWNS_ALL
        # set by the membership on-change hook; the shard loop performs
        # the adopted-key resync once informers are synced
        self._reshard_pending = False
        # read-plane invalidation hook, called before every reshard
        # resync: the adopted keyspace was written by ANOTHER process,
        # so every local snapshot (discovery, topology, record sets,
        # zones) is suspect — reconciling adopted keys through a stale
        # cache creates DUPLICATE accelerators.  Wired by cmd/root
        # (factory caches) and the sim harness (per-replica world).
        self.on_reshard: Optional[Callable[[], None]] = None
        # fired by the membership just BEFORE this replica starts
        # serving keys another process served (a claimed lease, an
        # adopted gainer shard), ahead of the resync above: a worker
        # that pops such a key in between must not read the old
        # snapshots either.  Wired by cmd/root (factory caches and the
        # durable fake account); the sim leaves it unset.
        self.on_adopt: Optional[Callable[[], None]] = None
        # fired by the membership when this replica hands keys it
        # served to others: with None just after (a drain ack, a lost
        # lease, a shed lease's release, a shard the ring dropped,
        # shutdown), with the key when a worker pops one it no longer
        # serves.  Wired
        # by cmd/root, whose process keeps its own journeys
        # (``release_journeys``); the sim's fleet-wide journeys leave
        # it unset.
        self.on_release: Optional[Callable[[Optional[str]], None]] = None
        # the orphan GC sweeper, built by run() when its
        # interval is > 0; None = disabled (reference parity)
        self.gc: Optional[GarbageCollector] = None
        # the pending-settle table the run() caller wired;
        # None = blocking-settle parity.  settle_tick() drives one
        # scheduler round explicitly (tests/bench, the drift_tick
        # pattern).
        self.settle_table = None
        # the explain plane, built by build()
        self.explain_engine: Optional[obs_explain.ExplainEngine] = None

    def build(
        self,
        client: ClusterClient,
        config: ControllerConfig,
        cloud_factory: Optional[CloudFactory] = None,
        informer_factory: Optional[SharedInformerFactory] = None,
    ) -> SharedInformerFactory:
        """Construct every registered controller (and the GC sweeper
        when enabled) WITHOUT starting any thread.  ``run`` wraps this
        with the threaded lifecycle; the deterministic sim harness
        (``agac_tpu_torch/sim/``) calls it directly and steps the same
        controller objects cooperatively on virtual time — the two
        runtimes can never drift apart on what a manager contains."""
        informer_factory = informer_factory or SharedInformerFactory(
            client, self._resync_period
        )
        self.informer_factory = informer_factory
        if config.sharding.enabled:
            # the membership must exist BEFORE the controllers: their
            # informer handlers consult the filter from the first
            # delivered event
            self.shard_membership = ShardMembership(
                config.sharding,
                identity=config.sharding.identity or None,
                registry=self.metrics_registry,
                on_change=self._on_shard_change,
            )
            # entering a resize transition re-divides quota (the
            # denominator grew to max(from, to)) without the full
            # handoff resync an ownership change triggers
            self.shard_membership.on_quota_change = self._on_shard_quota_change
            self.shard_membership.on_adopt = self._on_shard_adopt
            self.shard_membership.on_release = self._on_shard_release
            # load-aware placement input: measured managed
            # keys per shard under the live ring
            self.shard_membership.fleet_key_counts = self._count_keys_by_shard
            self.shard_filter = self.shard_membership.filter
            obs_instruments.sharding_instruments(
                self.metrics_registry
            ).keys_owned.set_function(self._count_owned_keys)
            if self._health is not None:
                # budget follows ownership from the very start: a
                # replica that has not acquired any shard yet paces at
                # the floor, not the whole global budget
                self._health.set_quota_fraction(0.0)
        for name, init in new_controller_initializers().items():
            self.controllers[name] = init(
                client, informer_factory, config, cloud_factory,
                self.shard_filter,
            )
        # the explain plane: one engine per manager, wired
        # to every plane the blocked-on classification consults; the
        # settle table is late-bound (run()/the sim harness attach it
        # after build), hence the lambda
        self.explain_engine = obs_explain.ExplainEngine(
            identity=(
                self.shard_membership.identity
                if self.shard_membership is not None
                else (config.sharding.identity or "")
            ),
            settle_table=lambda: self.settle_table,
            health=self._health,
            shard_filter=lambda: self.shard_filter,
            resize_status=self._resize_status,
            informers_synced=self._informers_synced,
            slo_shedding=self._slo_shedding,
        )
        self.explain_engine.bind_metrics(self.metrics_registry)
        for controller in self.controllers.values():
            for spec in controller.worker_specs():
                self.explain_engine.register_worker(
                    spec["name"], spec["queue"], spec["key_to_obj"],
                    managed=spec.get("managed"),
                )
        gc_config = config.garbage_collector
        if gc_config.interval > 0 and cloud_factory is not None:
            # the sweeper shares the controllers' informer caches (its
            # owner cross-checks must see the same world the reconciles
            # do) and the same cloud factory (deletes flow through the
            # shaped drivers); it never sweeps before those caches sync
            self.gc = GarbageCollector(
                informer_factory, gc_config, cloud_factory, health=self._health,
                registry=self.metrics_registry,
                shard_filter=self.shard_filter,
            )
        return informer_factory

    def run(
        self,
        client: ClusterClient,
        config: ControllerConfig,
        stop: threading.Event,
        cloud_factory: Optional[CloudFactory] = None,
        block: bool = True,
        settle_table=None,
    ) -> list[threading.Thread]:
        """Start every registered controller plus the shared informers;
        with ``block=True`` (the reference's ``wg.Wait()``) returns only
        after ``stop`` fires and all controller threads exit."""
        if not clockseam.threads_enabled():
            raise RuntimeError(
                "Manager.run spawns controller/gc/shard threads; under "
                "the sim's cooperative executor call build() and step "
                "the worker specs explicitly"
            )
        informer_factory = self.build(client, config, cloud_factory)
        # the threaded (production) lifecycle owns the process: its
        # engine becomes the global one the reconcile loop's recorder
        # stamps and the default /debug/explain lookup resolve.  The
        # sim harness calls build() directly and reads each replica's
        # own engine instead.
        obs_explain.install(self.explain_engine)
        threads = []
        for name, controller in self.controllers.items():
            klog.infof("Starting %s", name)
            thread = threading.Thread(
                target=controller.run, args=(stop,), daemon=True, name=name
            )
            thread.start()
            threads.append(thread)
            klog.infof("Started %s", name)

        if self.gc is not None:
            threading.Thread(
                target=self.gc.run, args=(stop,), daemon=True,
                name="garbage-collector",
            ).start()

        if self.shard_membership is not None:
            # the sharding plane's lease loop: every replica
            # runs it concurrently — shard leases, not the single
            # leader lease, decide who works which keys
            threading.Thread(
                target=self._shard_loop, args=(client, stop), daemon=True,
                name="shard-membership",
            ).start()

        if settle_table is not None and config.settle_poll_interval > 0:
            # the async mutation pipeline's poll tick:
            # re-checks every parked reconcile item in coalesced reads
            # and requeues resolved/expired waits
            from .reconcile.pending import SettleScheduler

            self.settle_table = settle_table
            SettleScheduler(
                settle_table, interval=config.settle_poll_interval
            ).start(stop)

        informer_factory.start(stop)
        api_health.start_worker_watchdog(stop, self.heartbeats)
        if block:
            stop.wait()
            for thread in threads:
                thread.join(timeout=5)
            self._log_stragglers(threads)
        return threads

    def _log_stragglers(self, threads: list[threading.Thread]) -> None:
        """Name every controller thread that failed to join, plus the
        reconcile key any of its workers is wedged on (heartbeat
        table) — a silently leaked straggler made wedged shutdowns
        undiagnosable."""
        for thread in threads:
            if not thread.is_alive():
                continue
            wedged = [
                f"{worker} on {info['key']!r} for {info['age']:.0f}s"
                for worker, info in self.heartbeats.snapshot().items()
                if worker.startswith(thread.name)
            ]
            klog.errorf(
                "controller thread %s failed to join within 5s%s",
                thread.name,
                f"; busy workers: {', '.join(wedged)}" if wedged else "",
            )

    # ------------------------------------------------------------------
    # sharding plane
    # ------------------------------------------------------------------
    def _on_shard_change(self, membership: ShardMembership) -> None:
        """Membership hook: quota follows ownership immediately; the
        adopted-key resync is deferred to the shard loop (it needs
        synced informer caches to enumerate)."""
        if self._health is not None:
            self._health.set_quota_fraction(membership.quota_fraction())
        self._reshard_pending = True
        obs_recorder.flight_recorder().record(
            "shard-rebalance",
            owned=sorted(membership.owned_shards()),
            quota_fraction=round(membership.quota_fraction(), 4),
        )

    def _on_shard_adopt(self) -> None:
        if self.on_adopt is not None:
            self.on_adopt()

    def _on_shard_release(self, key: Optional[str] = None) -> None:
        if self.on_release is not None:
            self.on_release(key)

    def release_journeys(self, key: Optional[str] = None) -> int:
        """Close, without observing a latency, the process tracker's
        in-flight journeys of keys this replica no longer serves (only
        ``key``'s when given); returns how many.  Right only where the
        tracker holds this replica's journeys alone: the new owner
        observes the convergence in its own process."""
        owns = self.shard_filter.owns_key
        released = obs_journey.tracker().release(
            lambda k: (key is None or k == key) and not owns(k)
        )
        if released and key is None:
            klog.v(2).infof(
                "released %d journeys of keys now served elsewhere (shards %s)",
                released, self.shard_filter.token(),
            )
        return released

    def _on_shard_quota_change(self, membership: ShardMembership) -> None:
        """A resize transition began: the quota denominator moved but
        no shard changed hands — re-divide without the full handoff
        resync."""
        if self._health is not None:
            self._health.set_quota_fraction(membership.quota_fraction())
        obs_recorder.flight_recorder().record(
            "shard-resize",
            state=membership.resize_status().get("state"),
            epoch=membership.resize_epoch,
            quota_fraction=round(membership.quota_fraction(), 4),
        )

    def shard_tick(self, client: ClusterClient) -> bool:
        """One membership round plus (when ownership changed and the
        informer caches are synced) the adopted-keyspace resync — the
        cooperative entry point the threaded loop AND the sim harness
        both drive, so the two runtimes cannot diverge on failover
        semantics.  Returns True when the owned-shard set changed.

        During a live resize the tick also drives this
        replica's side of the drain/handoff protocol: shards adopted
        this round get their moved keys resynced (journeys stamped
        ``trigger=resize``) and the handoff ack is written only AFTER
        that resync ran — the marker in the lease record is the
        protocol's statement that the new owner is actually serving."""
        if self.shard_membership is None:
            return False
        changed = self.shard_membership.tick(client)
        if self.shard_membership.resync_pending() and self._informers_synced():
            moved = self.shard_membership.moved_key_predicate()
            if self.on_reshard is not None:
                # the gained keys were written by other processes:
                # every local snapshot is suspect (duplicate-accelerator
                # hazard, same as a failover adoption)
                self.on_reshard()
            enqueued = self._resync_sources(
                trigger=obs_journey.TRIGGER_RESIZE,
                key_predicate=moved,
            )
            klog.infof(
                "resize resync: re-enqueued %d re-homed keys for shards %s",
                enqueued, self.shard_filter.token(),
            )
            self.shard_membership.ack_adoptions(client)
        if self._reshard_pending and self._informers_synced():
            self._reshard_pending = False
            self.reshard_resync()
        return changed

    def request_resize(self, client: ClusterClient, target_count: int) -> int:
        """CAS the fleet's live shard-count target onto the ring lease
        (the ``resize-shards`` CLI calls the module function directly;
        this is the embedded/test entry point)."""
        from .sharding import request_resize as _request_resize

        membership = self.shard_membership
        if membership is None:
            raise RuntimeError("sharding is not enabled on this manager")
        return _request_resize(
            client, target_count,
            namespace=membership.config.namespace,
            lease_prefix=membership.config.lease_prefix,
            vnodes=membership.config.vnodes,
        )

    def _resize_status(self) -> dict:
        """The live resize view the explain engine stamps verdicts
        with ({} in single-shard mode)."""
        if self.shard_membership is None:
            return {}
        return self.shard_membership.resize_status()

    @staticmethod
    def _slo_shedding() -> bool:
        """True while the SLO engine is actively shedding deferrable
        load — read from the attribute, NOT ``should_shed`` (that gate
        counts a shed action; an explain lookup must not)."""
        slo_engine = obs_slo.engine()
        return bool(slo_engine is not None and slo_engine.shedding)

    def _informers_synced(self) -> bool:
        if self.informer_factory is None:
            return False
        return all(
            informer.has_synced()
            for informer in self.informer_factory.informers()
        )

    def reshard_resync(self) -> int:
        """Re-enqueue every managed object this replica's shards now
        own — the level-triggered adoption path after a lease steal or
        first acquisition (informer events never replay for keys whose
        events were consumed by a dead replica).  The controllers' own
        drift sources carry the shard predicate, so this can never
        enqueue foreign keys."""
        if self.on_reshard is not None:
            # fresh reads for an adopted keyspace: another process
            # wrote it, local snapshots would ensure duplicates
            self.on_reshard()
        # journeys opened by this resync are HANDOFF-triggered: the
        # adopted keys' convergence latency is failover cost, not a
        # spec edit's, and the SLO plane separates the two
        enqueued = self._resync_sources(trigger=obs_journey.TRIGGER_HANDOFF)
        klog.infof(
            "shard resync: re-enqueued %d keys for shards %s",
            enqueued, self.shard_filter.token(),
        )
        return enqueued

    def _resync_sources(
        self, trigger: str, key_predicate=None
    ) -> int:
        """Walk every controller's canonical drift sources, enqueueing
        owned objects (optionally narrowed by ``key_predicate`` over
        the ``namespace/name`` key — the resize resync only re-homes
        MOVED keys)."""
        from .cluster.objects import meta_namespace_key

        enqueued = 0
        for controller in self.controllers.values():
            for lister, predicate, enqueue in controller.drift_resync_sources(
                trigger=trigger
            ):
                for obj in lister.list():
                    if not predicate(obj):
                        continue
                    if key_predicate is not None and not key_predicate(
                        meta_namespace_key(obj)
                    ):
                        continue
                    enqueue(obj)
                    enqueued += 1
        return enqueued

    def _shard_loop(self, client: ClusterClient, stop: threading.Event) -> None:
        membership = self.shard_membership
        klog.infof(
            "Starting shard membership (identity %s, %d shards, capacity %d)",
            membership.identity, membership.shard_count,
            membership.capacity(),
        )
        while not stop.is_set():
            try:
                self.shard_tick(client)
            except Exception as err:  # a bad tick must not kill the loop
                klog.errorf("shard tick failed: %s", err)
            stop.wait(membership.config.lease.retry_period)
        membership.release_all(client)
        klog.info("Shutting down shard membership")

    def shard_status(self) -> dict:
        """Shard assignment for ``/healthz``: which leases this replica
        holds, the observed map, and its quota slice."""
        if self.shard_membership is None:
            return {"enabled": False}
        status = {"enabled": True}
        status.update(self.shard_membership.shard_map())
        status["quota_fraction"] = round(
            self.shard_membership.quota_fraction(), 4
        )
        status["keys_owned"] = self._count_owned_keys()
        # elastic resharding: ring version, resize state
        # (stable/draining/adopting) and per-shard handoff progress
        status["resize"] = self.shard_membership.resize_status()
        return status

    def _count_owned_keys(self) -> int:
        """Managed Services + Ingresses owned by this replica's shards
        (the ``agac_shard_keys_owned`` gauge's collection-time view)."""
        if self.informer_factory is None:
            return 0
        from .controllers.globalaccelerator import (
            is_managed_ingress,
            is_managed_service,
        )

        count = 0
        try:
            for obj in self.informer_factory.informer("Service").lister().list():
                if is_managed_service(obj) and self.shard_filter.owns_obj(obj):
                    count += 1
            for obj in self.informer_factory.informer("Ingress").lister().list():
                if is_managed_ingress(obj) and self.shard_filter.owns_obj(obj):
                    count += 1
        except Exception:
            return count
        return count

    def _count_keys_by_shard(self) -> dict[int, int]:
        """Managed keys per shard under the LIVE ring — the measured
        load the membership's preferred-owner placement scores claims
        and sheds by.  Counts the whole fleet (not only
        owned shards): a claim decision needs the weight of shards
        this replica does NOT hold yet."""
        if self.informer_factory is None or self.shard_membership is None:
            return {}
        from .cluster.objects import meta_namespace_key
        from .controllers.globalaccelerator import (
            is_managed_ingress,
            is_managed_service,
        )

        ring = self.shard_membership.ring
        counts: dict[int, int] = {}
        try:
            for obj in self.informer_factory.informer("Service").lister().list():
                if is_managed_service(obj):
                    shard = ring.shard_for_key(meta_namespace_key(obj))
                    counts[shard] = counts.get(shard, 0) + 1
            for obj in self.informer_factory.informer("Ingress").lister().list():
                if is_managed_ingress(obj):
                    shard = ring.shard_for_key(meta_namespace_key(obj))
                    counts[shard] = counts.get(shard, 0) + 1
        except Exception:
            return counts
        return counts

    def keys_by_shard(self) -> dict[int, int]:
        """The per-shard managed-key census under the live ring, as a
        documented public accessor — the autoscaler's load-board
        signal reads this instead of reaching into the
        placement internals.  Empty when sharding is disabled."""
        return self._count_keys_by_shard()

    def drift_tick(self) -> int:
        """Drive ONE drift-resync round explicitly: walk every
        registered controller's own ``drift_resync_sources()`` — the
        same lister/predicate/enqueue triples the in-process ticker
        consumes, so an external tick can never diverge from a real
        one.  Returns the number of enqueued objects.  Used by the
        bench's drift-tick phase and the call-budget regression tier
        to bracket exactly one round.

        Degraded mode (health plane): a controller whose
        ``DRIFT_SERVICES`` include an open circuit is skipped — its
        verify reads would only feed the outage — and the tick is
        marked partial in ``last_drift_report`` (exported into
        bench_detail.json), so a stale verify round is visibly stale
        rather than silently incomplete."""
        report: dict = {
            # the shard-ownership token this (possibly partial) tick
            # covered — "all" in single-shard mode
            "shards": self.shard_filter.token(),
            "enqueued": {},
            "skipped": {},
            "partial": False,
        }
        if obs_slo.should_shed("drift-tick"):
            # burn-rate shedding: drift verification is
            # deferrable — while the convergence budget burns, the
            # tick is skipped and says so instead of adding load
            report["shed"] = True
            report["partial"] = True
            self.last_drift_reports[report["shards"]] = report
            obs_recorder.flight_recorder().record(
                "drift-tick", shards=report["shards"], shed=True
            )
            klog.warningf("drift tick: shed under SLO budget burn")
            return 0
        enqueued = 0
        # the fleet-enumeration cost of a verify round, attributed as
        # its own stage — the tick runs outside any
        # reconcile scope, so it flushes immediately under "manager"
        with obs_profile.stage("drift-tick"):
            for name, controller in self.controllers.items():
                open_services = (
                    [
                        service
                        for service in getattr(controller, "DRIFT_SERVICES", ())
                        if self._health.is_open(service)
                    ]
                    if self._health is not None
                    else []
                )
                if open_services:
                    report["skipped"][name] = open_services
                    report["partial"] = True
                    klog.warningf(
                        "drift tick: skipping %s (open circuits: %s)",
                        name, ", ".join(open_services),
                    )
                    continue
                count = 0
                for lister, predicate, enqueue in controller.drift_resync_sources():
                    for obj in lister.list():
                        if predicate(obj):
                            enqueue(obj)
                            count += 1
                report["enqueued"][name] = count
                enqueued += count
        self.last_drift_reports[report["shards"]] = report
        obs_recorder.flight_recorder().record(
            "drift-tick",
            shards=report["shards"],
            enqueued=dict(report["enqueued"]),
            skipped=dict(report["skipped"]),
            partial=report["partial"],
        )
        return enqueued

    @property
    def last_drift_report(self) -> dict:
        """The legacy single-report view: an additive merge over the
        per-shard partials stored in ``last_drift_reports`` (identical
        to the raw report while one replica covers the whole
        keyspace)."""
        return merge_shard_reports(self.last_drift_reports)

    def settle_tick(self) -> dict:
        """Drive ONE pending-settle poll round explicitly (tests and
        the bench; same pattern as ``drift_tick``).  No-op when no
        settle table is wired."""
        if self.settle_table is None:
            return {}
        return self.settle_table.poll_once()

    def settle_status(self) -> dict:
        """Pending-settle depth/age counters for ``/healthz`` and
        bench_detail."""
        if self.settle_table is None:
            return {"enabled": False}
        return self.settle_table.stats()

    def gc_sweep(self) -> dict:
        """Drive ONE orphan-GC sweep explicitly (tests and the bench's
        gc-sweep phase; same pattern as ``drift_tick``).  No-op when
        the sweeper is disabled."""
        if self.gc is None:
            return {}
        with obs_profile.stage("gc-sweep"):
            return self.gc.sweep_once()

    def gc_status(self) -> dict:
        """The sweeper's counters for ``/healthz`` and bench_detail:
        cumulative totals, pending (grace-held) depths, and the last
        sweep's full report."""
        if self.gc is None:
            return {"enabled": False}
        return self.gc.status()

    def queue_status(self) -> dict:
        """Every controller queue's live internals (ready depth, items
        being processed, parked delays and the next delay's maturity)
        — the ``/debug/queues`` view that makes a wedged or
        delay-parked queue diagnosable from the outside."""
        status: dict = {}
        for controller in self.controllers.values():
            for spec in controller.worker_specs():
                queue = spec["queue"]
                status[spec["name"]] = queue.debug_status()
        return status


# ---------------------------------------------------------------------------
# /healthz + /readyz (stdlib server, the webhook/server.py pattern)
# ---------------------------------------------------------------------------


class _HealthHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    # probes arrive every few seconds from the kubelet: verbose level
    # from day one (the webhook's healthz flooded logs at info)
    def log_message(self, fmt, *args):
        klog.v(4).infof("health http: " + fmt, *args)

    def do_GET(self):
        # every endpoint dispatches on the bare path through one route
        # table with one shared query parser and a
        # uniform JSON error contract: unknown path → 404 JSON naming
        # the known endpoints, bad query → 400 JSON with "error"
        path, _, raw_query = self.path.partition("?")
        handler = self._ROUTES.get(path)
        if handler is None:
            self._respond(404, {
                "error": f"no such endpoint: {path}",
                "endpoints": sorted(self._ROUTES),
            })
            return
        handler(self, _parse_query(raw_query))

    def _healthz(self, query=None):
        """Process liveness: 200 unless a worker is stuck past the
        threshold (a wedged worker pool deserves a kubelet restart —
        state is all external, restart-resume is proven by the
        resilience tier)."""
        klog.v(4).infof("healthz")
        stuck = self.server.heartbeats.stuck(self.server.stuck_threshold)
        body = {
            "workers": self.server.heartbeats.snapshot(),
            "stuck": [
                {"worker": worker, "key": key, "age": round(age, 1)}
                for worker, key, age in stuck
            ],
            # orphan-GC sweep status: operators watching a
            # dry-run rollout read would-delete counts here instead of
            # grepping logs
            "gc": self.server.gc_status(),
            # shard assignment: which shard leases this
            # replica holds, the observed map, and its quota slice
            "sharding": self.server.shard_status(),
            # convergence SLO summary: burn rates + shed
            # state — the block the rollout/federation gates read;
            # the full view (objectives, slowest journeys) is /slo
            "slo": self.server.slo_status(),
            # shard autoscaler: rail/knob settings and the
            # last decision; full history is /debug/autoscaler
            "autoscaler": self.server.autoscaler_status(),
        }
        self._respond(500 if stuck else 200, body)

    def _readyz(self, query=None):
        """Readiness: 503 while any API circuit is open — the pod is
        alive but degraded, and deployment probes/rollouts should see
        that without scraping logs."""
        klog.v(4).infof("readyz")
        tracker = self.server.health_tracker
        open_services = tracker.open_services() if tracker is not None else []
        body = {
            "open_circuits": open_services,
            "services": tracker.snapshot() if tracker is not None else {},
        }
        self._respond(503 if open_services else 200, body)

    def _metrics(self, query=None):
        """Prometheus text exposition of the wired registry:
        the scrape endpoint operators point their Prometheus at."""
        payload = self.server.metrics_registry.render().encode()
        self.send_response(200)
        self.send_header("Content-Type", obs_metrics.CONTENT_TYPE)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _slo(self, query=None):
        """The convergence SLO plane in full: declared
        objectives with burn rates and quantile estimates, shed state,
        and the slowest unconverged journeys (each id greps straight
        into /debug/flightrecorder)."""
        self._respond(200, self.server.slo_status())

    def _fleet_metrics(self, query=None):
        """The fleet-merged exposition: this replica's
        registry plus every configured peer's /metrics — counters and
        journey histograms summed, gauges labeled by shard.  A peer
        that fails to scrape is named in the leading meta comments,
        never silently dropped."""
        payload = self.server.fleet_view.render().encode()
        self.send_response(200)
        self.send_header("Content-Type", obs_metrics.CONTENT_TYPE)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _flightrecorder(self, query=None):
        """The flight recorder's ring buffer, oldest → newest — the
        live post-mortem of the last few hundred reconcile outcomes.
        The active incident capture's cursor rides along,
        naming the replayable artifact this window corresponds to."""
        recorder = self.server.flight_recorder
        body = {
            "capacity": recorder.capacity,
            "recorded_total": recorder.recorded_total,
            "entries": recorder.dump(),
        }
        try:
            from .sim.capture import active as _capture_active

            tap = _capture_active()
            if tap is not None:
                body["capture_cursor"] = tap.cursor()
        except Exception:
            pass
        self._respond(200, body)

    def _queues(self, query=None):
        self._respond(200, self.server.queue_status())

    def _autoscaler(self, query=None):
        """The autoscaler's bounded decision history, oldest → newest,
        each entry carrying the full evidence snapshot the policy saw
        — suppressed decisions included (a quiet autoscaler should be
        explainably quiet)."""
        self._respond(
            200,
            {
                "status": self.server.autoscaler_status(),
                "decisions": self.server.autoscaler_history(),
            },
        )

    def _profile(self, query):
        """On-demand sampling-profiler capture:
        ``?seconds=N`` samples the live process for N seconds (bounded
        by the profiler) and returns the folded stacks plus the ranked
        top table; ``&format=folded`` returns the flamegraph-ready
        text instead of JSON.  The stage accountant's cumulative
        attribution table rides along so one curl answers both "where
        is wall time going right now" and "where has CPU gone since
        start"."""
        try:
            seconds = float(query.get("seconds", "1"))
            hz = float(query.get("hz", "0")) or None
        except ValueError:
            self._respond(400, {"error": "seconds/hz must be numbers"})
            return
        capture = self.server.profile_capture(seconds, hz)
        if query.get("format", "") == "folded":
            payload = (capture["folded"] + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; charset=utf-8")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
            return
        capture["stages"] = obs_profile.attribution_table()
        self._respond(200, capture)

    def _explain(self, query):
        """The explain plane's single-key probe:
        ``?key=ns/name[&controller=worker-label]`` returns the
        blocked-on verdict + causal timeline per controller — every
        lookup O(1) per key, no fleet enumeration.  Unknown controller
        → 404; missing/malformed key → 400."""
        key = query.get("key", "")
        if not key:
            self._respond(400, {"error": "missing required query param: key"})
            return
        if "/" not in key:
            self._respond(400, {
                "error": f"key must be namespace/name, got {key!r}"
            })
            return
        controller = query.get("controller") or None
        try:
            answer = self.server.explain_lookup(key, controller)
        except KeyError:
            self._respond(404, {
                "error": f"no such controller: {controller!r}",
            })
            return
        self._respond(200, answer)

    def _respond(self, code: int, body: dict):
        payload = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    # bare path → handler(self, query): the single dispatch surface —
    # a new endpoint is one row here (plus its handler), and the 404
    # body enumerates exactly this table
    _ROUTES = {
        "/healthz": _healthz,
        "/readyz": _readyz,
        "/metrics": _metrics,
        "/metrics/fleet": _fleet_metrics,
        "/slo": _slo,
        "/debug/flightrecorder": _flightrecorder,
        "/debug/queues": _queues,
        "/debug/autoscaler": _autoscaler,
        "/debug/profile": _profile,
        "/debug/explain": _explain,
    }


def _parse_query(raw_query: str) -> dict:
    """The shared query-string parser: first value per param (no
    endpoint takes repeated params)."""
    return {
        name: values[0]
        for name, values in urllib.parse.parse_qs(raw_query).items()
        if values
    }


def make_health_server(
    port: int,
    health: Optional["api_health.HealthTracker"] = None,
    heartbeats: Optional["api_health.WorkerHeartbeats"] = None,
    stuck_threshold: float = WORKER_STUCK_THRESHOLD,
    host: str = "",
    gc_status: Optional[Callable[[], dict]] = None,
    metrics_registry: Optional["obs_metrics.MetricsRegistry"] = None,
    flight_recorder: Optional["obs_recorder.FlightRecorder"] = None,
    shard_status: Optional[Callable[[], dict]] = None,
    slo_status: Optional[Callable[[], dict]] = None,
    fleet_view: Optional["obs_fleet.FleetView"] = None,
    queue_status: Optional[Callable[[], dict]] = None,
    autoscaler_status: Optional[Callable[[], dict]] = None,
    autoscaler_history: Optional[Callable[[], list]] = None,
    profile_capture: Optional[Callable[..., dict]] = None,
    explain_lookup: Optional[Callable[..., dict]] = None,
) -> ThreadingHTTPServer:
    """Build the manager's health endpoint (bind port 0 in tests);
    call ``serve_forever`` on a daemon thread to serve.  ``gc_status``
    is the manager's ``gc_status`` hook (defaults to disabled).
    ``/metrics`` renders ``metrics_registry`` (default: the
    process-global registry, where the hot-path instruments land),
    ``/debug/flightrecorder`` dumps ``flight_recorder`` (default: the
    process-global ring), ``/slo`` serves ``slo_status`` (default: the
    installed global SLO engine, or a disabled stub), and
    ``/metrics/fleet`` serves ``fleet_view`` (default: a one-source
    view over this replica's own registry — ``--fleet-peers`` adds
    the rest of the fleet)."""
    server = ThreadingHTTPServer((host, port), _HealthHandler)
    server.health_tracker = health
    server.heartbeats = heartbeats or api_health.worker_heartbeats()
    server.stuck_threshold = stuck_threshold
    server.gc_status = gc_status or (lambda: {"enabled": False})
    server.shard_status = shard_status or (lambda: {"enabled": False})
    server.queue_status = queue_status or (lambda: {})
    server.slo_status = slo_status or obs_slo.status_or_disabled
    server.autoscaler_status = autoscaler_status or (lambda: {"enabled": False})
    server.autoscaler_history = autoscaler_history or (lambda: [])
    server.profile_capture = profile_capture or obs_stackprof.capture
    # /debug/explain: default to the installed process
    # engine (an unwired default engine knows no workers and answers
    # not-managed — graceful, never a 500)
    server.explain_lookup = explain_lookup or (
        lambda key, controller=None: obs_explain.engine().explain(key, controller)
    )
    server.metrics_registry = (
        metrics_registry if metrics_registry is not None else obs_metrics.registry()
    )
    server.fleet_view = fleet_view or obs_fleet.FleetView(
        {"self": server.metrics_registry.render}
    )
    server.flight_recorder = (
        flight_recorder
        if flight_recorder is not None
        else obs_recorder.flight_recorder()
    )
    klog.infof("Health endpoint listening on :%d", server.server_address[1])
    return server
