"""SimHarness: the whole Manager on virtual time.

The harness assembles the SAME objects production runs — controllers
via ``Manager.build`` (so a sim manager can never drift from a real
one), the pending-settle table, the Route53 change batcher, the API
health plane, the read-plane caches, the GC sweeper, and lease-based
leader electors — but wires every clock to a ``SimScheduler`` and
replaces every thread with a cooperative pump:

- **informers** are driven by a non-blocking watch cursor
  (``FakeCluster.events_since``) plus periodic relists
  (``SharedInformer.sync_once``) on the resync timer; a trimmed-
  history gap degrades to a relist exactly like a real 410 Gone;
- **workers** are stepped one item at a time, round-robin over every
  queue in construction order, after every scheduler event — the
  deterministic ready-queue order of the cooperative executor;
- **delayed requeues** (rate-limiter backoff, ``requeue_after``,
  stage yields) sit in each queue's waiting heap; the harness asks
  ``next_delay_deadline()`` and parks a wake event so virtual time
  jumps straight to the next interesting instant;
- **settle polls / drift ticks / GC sweeps / lease renewals /
  resyncs** are recurring scheduler events driving the same
  ``poll_once``/``drift_tick``/``gc_sweep``/``try_acquire_or_renew``
  entry points tests and the bench already use;
- **leader churn** is first-class: N contending electors over the
  shared Lease object; ``kill_leader()`` drops the leading replica's
  whole stack without releasing the lease (crash semantics — the
  standby takes over a full lease_duration later), ``demote_leader()``
  releases cleanly.  A new stack is built by whichever replica
  acquires the lease, resynced from cluster + AWS state — the same
  level-triggered recovery story the process drills prove.

Every worker step, informer delta batch and timer firing folds into
the scheduler's event-trace hash, so one seed ⇒ one interleaving ⇒
one hash — the replay contract ``sim/fuzz.py`` builds on.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Generator, Optional

from .. import klog
from ..autoscaler import (
    AutoscalerLoop,
    ScalePolicy,
    ScalePolicyConfig,
    ScaleSignals,
)
from ..cloudprovider.aws import AWSDriver
from ..cloudprovider.aws.batcher import ChangeBatcher
from ..cloudprovider.aws.cache import (
    AcceleratorTopologyCache,
    DiscoveryCache,
    HostedZoneCache,
    LoadBalancerCoalescer,
    RecordSetCache,
)
from ..cloudprovider.aws.fake_backend import (
    FakeAWSBackend,
    FaultPlan,
    SimulatedCrash,
)
from ..cloudprovider.aws.health import (
    ELBV2_OPS,
    GA_OPS,
    ROUTE53_OPS,
    HealthConfig,
    HealthTracker,
)
from ..cluster import FakeCluster, SharedInformerFactory
from ..controllers import (
    EndpointGroupBindingConfig,
    GlobalAcceleratorConfig,
    Route53Config,
)
from ..controllers.common import with_circuit_backoff
from ..controllers.garbagecollector import GarbageCollectorConfig
from ..leaderelection import LeaderElection, LeaderElectionConfig
from ..manager import ControllerConfig, Manager
from ..observability import fleet as obs_fleet
from ..observability import journey as obs_journey
from ..observability import metrics as obs_metrics
from ..observability import recorder as obs_recorder
from ..observability import slo as obs_slo
from ..cluster import serde
from ..reconcile.pending import PendingSettleTable
from ..reconcile.reconcile import process_next_work_item
from ..sharding import ShardingConfig
from . import capture as capture_mod
from . import runtime
from .capture import IncidentCapture

# a pump round that never quiesces within this many worker steps is a
# livelock (an item requeueing itself with zero delay) — fail loudly
# with the offending queues instead of spinning forever
PUMP_STEP_LIMIT = 1_000_000


@dataclass
class SimHarnessConfig:
    """Knobs for one simulated world.  Defaults favor scenario
    realism at production-shaped timings — virtual time makes the
    long constants free."""

    cluster_name: str = "default"
    replicas: int = 1
    # horizontal sharding: shard_count > 1 switches the
    # harness into multi-replica mode — ``replicas`` concurrently-LIVE
    # stacks, each with its own process-world (settle table, batcher,
    # caches, health tracker) and its own shard membership over the
    # shared Lease objects, instead of one active leader
    shard_count: int = 1
    shards_per_replica: int = 0
    resync_period: float = 3600.0
    settle_poll_interval: float = 1.0
    drift_tick_period: float = 0.0  # 0 = off
    gc_sweep_period: float = 0.0  # 0 = off
    gc_grace_sweeps: int = 2
    gc_max_deletes: int = 50
    queue_qps: float = 0.0  # 0 = per-item backoff only
    queue_burst: int = 100
    queue_max_backoff: float = 8.0
    reconcile_deadline: float = 0.0
    # driver pacing (production constants; virtual seconds are free)
    poll_interval: float = 10.0
    poll_timeout: float = 180.0
    lb_not_active_retry: float = 5.0
    accelerator_missing_retry: float = 5.0
    stage_requeue: float = 0.01
    # async mutation pipeline
    r53_batch_linger: float = 0.2
    r53_batch_max: int = 100
    # API health plane; None disables
    health: Optional[HealthConfig] = None
    # read plane TTLs
    discovery_ttl: float = 30.0
    discovery_tags_ttl: float = 300.0
    zone_ttl: float = 60.0
    read_plane_ttl: float = 15.0
    topology_full_ttl: float = 900.0
    # leader election (client-go's 60/15/5 shape by default)
    lease: LeaderElectionConfig = field(
        default_factory=lambda: LeaderElectionConfig(
            lease_duration=60.0, renew_deadline=15.0, retry_period=5.0
        )
    )
    # fake-backend shape when the harness builds it
    quota_accelerators: int = 200
    settle_describes: int = 2
    # the convergence SLO plane: evaluation cadence of the
    # per-scenario engine (0 disables journey/SLO tracking entirely);
    # shed gates default OFF in sim — the burn state machine and its
    # metrics run either way, but only a scenario that opts in has
    # sustained burn actually defer GC sweeps / drift ticks
    slo_eval_interval: float = 15.0
    slo_shed_gates: bool = False
    # objective override for the per-scenario SLO engine (None = the
    # shipped default_objectives()).  Autoscale scenarios declare
    # fast-tripping low-threshold objectives so a load wave burns the
    # budget within sim-scale minutes AND the cumulative good fraction
    # can recover above target after the reaction — keeping check_slo
    # meaningful post-scale instead of permanently poisoned by the wave
    slo_objectives: Optional[tuple] = None
    # burn-window override (None = DEFAULT_WINDOWS, 5 m / 1 h).  The
    # autoscale scenarios shrink these so a load wave's burn both
    # trips AND decays inside one sim-scale run — with the production
    # 1 h window the wave would poison scale-in headroom for an hour
    # of virtual time after it ended
    slo_windows: Optional[tuple] = None
    # SLO-driven shard autoscaler: arms a harness-level
    # AutoscalerLoop over the scenario's SLO engine, journey tracker,
    # membership state and health planes, executing through the traced
    # request_resize verb.  Sharded mode only.  autoscale_policy is a
    # ScalePolicyConfig (None = defaults — production-shaped cooldowns,
    # usually too slow for sim scenarios)
    autoscale: bool = False
    autoscale_interval: float = 15.0
    autoscale_policy: Optional[ScalePolicyConfig] = None
    # elastic resharding: the longest a moving key may sit
    # unowned between its donor's drain and its gainer's adoption
    # before the handoff oracle flags it; 0 = 4 lease retry periods
    # (drain starts only once the adopter is standing by, so the gap
    # is bounded by tick interleaving, not lease expiry)
    handoff_window_budget: float = 0.0
    # incident capture: a non-empty path arms an
    # ``IncidentCapture`` tap for the harness's lifetime — every
    # external input (informer batches, AWS outcomes, lease
    # observations, scenario verbs and cluster writes) lands in the
    # bounded JSONL ring so a failed drill replays through
    # ``sim.replay.ReplayHarness``.  The ``AGAC_SIM_CAPTURE`` env var
    # arms the same tap without touching the scenario (the chaos
    # suites' capture-on-failure teardown path).
    capture_path: Optional[str] = None
    capture_max_bytes: int = capture_mod.DEFAULT_MAX_BYTES


# config fields the capture header cannot round-trip (callable-bearing
# or element-type-erased tuples); a capture made with one set records
# its presence so the replay can warn instead of silently differing
_CONFIG_OPAQUE_FIELDS = ("slo_objectives", "slo_windows", "autoscale_policy")


def encode_config(config: SimHarnessConfig) -> dict:
    """Capture-header encoding of the harness config: scalars verbatim,
    nested dataclasses via the serde wire format, opaque fields listed
    by name (the replay restores defaults and warns)."""
    out: dict[str, Any] = {}
    for f in dataclasses.fields(config):
        value = getattr(config, f.name)
        if f.name in _CONFIG_OPAQUE_FIELDS:
            if value is not None:
                out.setdefault("__opaque__", []).append(f.name)
            continue
        if value is None:
            continue
        if dataclasses.is_dataclass(value) and not isinstance(value, type):
            out[f.name] = {"__dc__": type(value).__name__, "fields": serde.to_wire(value)}
        else:
            out[f.name] = value
    return out


def decode_config(data: dict) -> SimHarnessConfig:
    """Inverse of ``encode_config``; the replayed harness never
    re-captures (``capture_path`` is stripped — the shadow stream is
    in-memory by construction)."""
    kwargs: dict[str, Any] = {}
    for f in dataclasses.fields(SimHarnessConfig):
        if f.name not in data or f.name in ("capture_path",):
            continue
        value = data[f.name]
        if isinstance(value, (dict, list)):
            value = capture_mod.decode_value(value)
        kwargs[f.name] = value
    return SimHarnessConfig(**kwargs)


# one process may build many harnesses (a pytest chaos module, a fuzz
# batch); each gets a distinct capture file under the armed base path
_capture_serials: dict[str, int] = {}
_capture_serial_lock = threading.Lock()


def _next_capture_path(base: str) -> str:
    """The nth harness writing the SAME ``base`` in this process gets
    ``-n`` spliced before the extension (the first keeps the bare
    path) — distinct bases stay untouched, so sequential tests with
    their own paths name their artifacts predictably while a
    multi-harness drill sharing one knob never clobbers itself."""
    with _capture_serial_lock:
        serial = _capture_serials.get(base, 0) + 1
        _capture_serials[base] = serial
    if serial == 1:
        return base
    root, ext = os.path.splitext(base)
    return f"{root}-{serial}{ext or '.jsonl'}"


class _World:
    """One process's shared-memory state: the API health plane, the
    pending-settle table, the Route53 change batcher, the read-plane
    caches and the per-region LB coalescers.  Single-leader mode keeps
    ONE world across leader generations (that state is process-level
    there); sharded mode builds one world PER replica, so concurrently
    live replicas can only communicate through the cluster and AWS —
    never through shared caches, which would be cross-process
    telepathy."""

    def __init__(self, harness: "SimHarness"):
        config = harness.config
        scheduler = harness.scheduler
        self._harness = harness
        # one PRIVATE metrics registry per process-world:
        # concurrently-live sim replicas must never fold their
        # counters/gauges into one process-global registry — two
        # replicas' agac_shard_keys_owned summed into one series is
        # exactly the cross-process telepathy the fleet-merge layer
        # exists to do explicitly (and label by shard)
        self.registry = obs_metrics.MetricsRegistry()
        self.health = (
            HealthTracker(
                config=config.health,
                clock=scheduler.monotonic,
                sleep=scheduler.clock.sleep,
                registry=self.registry,
            )
            if config.health is not None
            else None
        )
        self.settle_table = PendingSettleTable(
            clock=scheduler.monotonic, registry=self.registry
        )
        self.batcher = (
            ChangeBatcher(
                max_changes=config.r53_batch_max,
                linger=config.r53_batch_linger,
                clock=scheduler.monotonic,
            )
            if config.r53_batch_linger > 0
            else None
        )
        self.discovery = DiscoveryCache(
            ttl=config.discovery_ttl,
            tags_ttl=config.discovery_tags_ttl or None,
            degraded=(
                (lambda: self.health.is_open("globalaccelerator"))
                if self.health is not None
                else None
            ),
        )
        self.zones = HostedZoneCache(ttl=config.zone_ttl)
        self.topology = AcceleratorTopologyCache(
            verify_ttl=config.read_plane_ttl,
            full_ttl=config.topology_full_ttl,
            pending_creates=harness.pending_creates,
        )
        self.records = RecordSetCache(
            ttl=config.read_plane_ttl,
            degraded=(
                (lambda: self.health.is_open("route53"))
                if self.health is not None
                else None
            ),
        )
        self.lb_coalescers: dict[str, LoadBalancerCoalescer] = {}

    def cloud_factory(self, region: str) -> AWSDriver:
        harness = self._harness
        if self.health is not None:
            ga = self.health.guard(harness.aws, "globalaccelerator", GA_OPS)
            elbv2 = self.health.guard(harness.aws, f"elbv2[{region}]", ELBV2_OPS)
            route53 = self.health.guard(harness.aws, "route53", ROUTE53_OPS)
        else:
            ga = elbv2 = route53 = harness.aws
        coalescer = self.lb_coalescers.get(region)
        if coalescer is None:
            coalescer = self.lb_coalescers[region] = LoadBalancerCoalescer(
                ttl=harness.config.read_plane_ttl, batch_window=0.0
            )
        return AWSDriver(
            ga,
            elbv2,
            route53,
            poll_interval=harness.config.poll_interval,
            poll_timeout=harness.config.poll_timeout,
            sleep=harness.scheduler.clock.sleep,
            lb_not_active_retry=harness.config.lb_not_active_retry,
            accelerator_missing_retry=harness.config.accelerator_missing_retry,
            discovery_cache=self.discovery,
            zone_cache=self.zones,
            topology_cache=self.topology,
            record_cache=self.records,
            lb_coalescer=coalescer,
            settle_table=self.settle_table,
            change_batcher=self.batcher,
            stage_requeue=harness.config.stage_requeue,
        )


class _WorkerEntry:
    """One queue's cooperative worker: the controller's own
    ``worker_specs()`` entry, circuit-wrapped exactly like
    ``run_workers`` would."""

    __slots__ = (
        "name", "queue", "key_to_obj", "process_delete",
        "process_create_or_update", "on_sync_result", "reconcile_deadline",
    )

    def __init__(self, spec: dict):
        self.name = spec["name"]
        self.queue = spec["queue"]
        self.key_to_obj = spec["key_to_obj"]
        self.process_delete = with_circuit_backoff(spec["process_delete"])
        self.process_create_or_update = with_circuit_backoff(
            spec["process_create_or_update"]
        )
        self.on_sync_result = spec.get("on_sync_result")
        self.reconcile_deadline = spec.get("reconcile_deadline") or None


class _Stack:
    """One controller-process generation: a Manager + informers +
    worker entries, alive while its replica leads."""

    def __init__(
        self,
        harness: "SimHarness",
        identity: str,
        world: Optional[_World] = None,
        controller_config: Optional[ControllerConfig] = None,
    ):
        self.identity = identity
        self.world = world if world is not None else harness.world
        config = (
            controller_config
            if controller_config is not None
            else harness.controller_config
        )
        self.manager = Manager(
            resync_period=harness.config.resync_period,
            health=self.world.health,
            metrics_registry=self.world.registry,
        )
        # stacks hold the RAW cluster: controller writes (status
        # updates, finalizers, leases) are consequences a replay
        # re-derives, never recorded external inputs
        self.informer_factory = SharedInformerFactory(
            harness._raw_cluster,
            harness.config.resync_period,
            clock=harness.scheduler.monotonic,
        )
        self.manager.build(
            harness._raw_cluster, config, self.world.cloud_factory,
            self.informer_factory,
        )
        self.manager.settle_table = self.world.settle_table
        # initial list+sync, then per-informer watch cursors
        self.cursors: dict = {}
        for informer in self.informer_factory.informers():
            self.cursors[informer] = informer.sync_once()
        self.workers: list[_WorkerEntry] = [
            _WorkerEntry(spec)
            for controller in self.manager.controllers.values()
            for spec in controller.worker_specs()
        ]

    def pump_informers(self, harness: "SimHarness") -> bool:
        """Apply new cluster events to every informer and dispatch
        handler deltas inline; True when anything moved.  With a
        capture armed every delivered batch (and every 410-degraded
        relist) lands in the tap — the informer half of the incident
        time machine; with a replay's ``informer_feed`` substituted,
        recorded batches are applied instead of live cluster deltas."""
        if harness.informer_feed is not None:
            return self._pump_recorded(harness)
        moved = False
        tap = harness.capture
        for informer in self.informer_factory.informers():
            events, cursor = harness._raw_cluster.events_since(
                informer.kind, self.cursors[informer]
            )
            if events is None:
                # watch window trimmed (the 410 Gone analog): relist
                self.cursors[informer] = informer.sync_once()
                if tap is not None:
                    tap.record_informer_batch(
                        self.identity, informer.kind, [],
                        cursor=self.cursors[informer], relist=True, delivered=0,
                    )
                harness.scheduler.record("informer", f"{informer.kind}:relist")
                moved = True
                continue
            for event in events:
                informer.apply_event(event)
            self.cursors[informer] = cursor
            delivered = informer.drain_pending_deltas()
            if events or delivered:
                if tap is not None:
                    tap.record_informer_batch(
                        self.identity, informer.kind, events,
                        cursor=cursor, relist=False, delivered=delivered,
                    )
                harness.scheduler.record(
                    "informer", f"{informer.kind}:{len(events)}"
                )
                moved = True
        return moved

    def _pump_recorded(self, harness: "SimHarness") -> bool:
        """Replay-substitution pump: apply the recorded watch batches
        that are due at (or before) the current virtual instant for
        this stack's identity, in recorded order, instead of reading
        the live cluster — the live-capture replay path where the
        recorded stream IS the truth."""
        moved = False
        feed = harness.informer_feed
        tap = harness.capture
        now = harness.scheduler.monotonic()
        for informer in self.informer_factory.informers():
            for batch in feed.due(self.identity, informer.kind, now):
                if batch.get("relist"):
                    self.cursors[informer] = informer.sync_once()
                    if tap is not None:
                        tap.record_informer_batch(
                            self.identity, informer.kind, [],
                            cursor=self.cursors[informer],
                            relist=True, delivered=0,
                        )
                    harness.scheduler.record(
                        "informer", f"{informer.kind}:relist"
                    )
                    moved = True
                    continue
                events = feed.decode_events(batch)
                for event in events:
                    informer.apply_event(event)
                self.cursors[informer] = batch.get("cursor", "")
                delivered = informer.drain_pending_deltas()
                if events or delivered:
                    if tap is not None:
                        tap.record_informer_batch(
                            self.identity, informer.kind, events,
                            cursor=self.cursors[informer],
                            relist=False, delivered=delivered,
                        )
                    harness.scheduler.record(
                        "informer", f"{informer.kind}:{len(events)}"
                    )
                    moved = True
        return moved

    def resync(self, harness: "SimHarness") -> None:
        for informer in self.informer_factory.informers():
            self.cursors[informer] = informer.sync_once()
        harness.scheduler.record("informer", "resync")


class _SimElector:
    """Cooperative lease state machine over the real ``LeaderElection``
    CAS logic — ticked every retry_period by the scheduler instead of
    running acquire/renew threads."""

    def __init__(self, harness: "SimHarness", identity: str):
        self.harness = harness
        self.identity = identity
        self.elector = LeaderElection(
            "agac-sim-controller",
            "kube-system",
            config=harness.config.lease,
            identity=identity,
            clock=harness.scheduler.monotonic,
        )
        self.leading = False
        self.renew_deadline = 0.0
        self.dead = False
        self.event = harness.scheduler.every(
            harness.config.lease.retry_period,
            self.tick,
            f"elector:{identity}",
            first_after=0.0,
        )

    def tick(self) -> None:
        if self.dead:
            return
        acquired, _holder = self.elector.try_acquire_or_renew(
            self.harness._raw_cluster
        )
        now = self.harness.scheduler.monotonic()
        if not self.leading:
            if acquired:
                self.leading = True
                self.renew_deadline = now + self.harness.config.lease.renew_deadline
                self.elector.set_leading(True)
                self.harness._on_leader_acquired(self)
        elif acquired:
            self.renew_deadline = now + self.harness.config.lease.renew_deadline
            if self.harness._stack is None:
                # we lead but no stack exists (a prior guard deferred
                # the build while an old generation drained) — build now
                self.harness._on_leader_acquired(self)
        elif now >= self.renew_deadline:
            self.leading = False
            self.elector.set_leading(False)
            self.harness._on_leader_lost(self)

    def kill(self) -> None:
        """Crash: stop participating WITHOUT releasing the lease."""
        self.dead = True
        self.leading = False
        self.elector.set_leading(False)
        self.event.cancel()

    def release(self) -> None:
        """Graceful shutdown: release the lease so a standby can
        acquire on its next tick instead of waiting out the lease."""
        self.dead = True
        self.leading = False
        self.elector.set_leading(False)
        self.event.cancel()
        self.elector._release(self.harness._raw_cluster)


class _ShardReplica:
    """One concurrently-live sharded controller replica: its
    own process-world (settle table, batcher, caches, health tracker),
    its own Manager — whose ``build()`` creates the shard membership
    and filter — and a cooperative membership tick every retry_period.
    The in-sim analog of a separate controller process: replicas talk
    only through the shared cluster and AWS state."""

    def __init__(self, harness: "SimHarness", identity: str):
        self.harness = harness
        self.identity = identity
        self.dead = False
        self.world = _World(harness)
        config = harness.config
        sharding = ShardingConfig(
            shard_count=config.shard_count,
            shards_per_replica=config.shards_per_replica,
            lease=config.lease,
            identity=identity,
        )
        self.controller_config = harness._make_controller_config(sharding)
        self.stack = _Stack(
            harness, identity, world=self.world,
            controller_config=self.controller_config,
        )
        self.stack._sim_replica = self
        # reshard adoptions drop this replica's world snapshots — the
        # adopted chains were written by another replica's driver
        self.stack.manager.on_reshard = self._invalidate_world
        self.tick_event = harness.scheduler.every(
            config.lease.retry_period,
            self.shard_tick,
            f"shard-tick:{identity}",
            first_after=0.0,
        )

    def shard_tick(self) -> None:
        if self.dead:
            return
        manager = self.stack.manager
        try:
            changed = manager.shard_tick(self.harness._raw_cluster)
        except SimulatedCrash as crash:
            self.harness._handle_crash_replica(self, crash)
            return
        if changed:
            self.harness.scheduler.record(
                "shard", f"{self.identity}:{manager.shard_filter.token()}"
            )
        self.harness.check_exclusive_ownership()

    def _invalidate_world(self) -> None:
        world = self.world
        world.discovery.invalidate()
        world.zones.invalidate()
        world.topology.invalidate_all()
        world.records.invalidate_all()

    def kill(self) -> None:
        """Crash semantics: the stack vanishes, the shard leases stay
        HELD until they expire under a survivor's observation."""
        self.dead = True
        self.tick_event.cancel()

    def stop(self) -> None:
        """Graceful shutdown: drop shards locally, then release the
        leases for immediate takeover."""
        self.dead = True
        self.tick_event.cancel()
        self.stack.manager.shard_membership.release_all(
            self.harness._raw_cluster
        )


class _RecordingCluster:
    """The scenario-facing cluster handle while a capture is armed:
    reads pass through untouched; the four mutators record a
    ``cluster`` event AFTER the apiserver accepts them — these writes
    are EXTERNAL inputs (the drill script's own actions), so a replay
    re-injects them at their recorded instants.  Controller-internal
    writes never flow here: stacks, electors and membership hold the
    raw cluster, because their writes are consequences the replay
    re-derives, not inputs."""

    def __init__(self, inner, harness: "SimHarness"):
        self._inner = inner
        self._harness = harness

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _record(self, method: str, kind: str, namespace="", name="", obj=None) -> None:
        tap = self._harness.capture
        if tap is not None:
            tap.record_cluster_mutation(
                method, kind, namespace=namespace, name=name, obj=obj
            )

    def create(self, kind, obj):
        result = self._inner.create(kind, obj)
        self._record("create", kind, obj=obj)
        return result

    def update(self, kind, obj):
        result = self._inner.update(kind, obj)
        self._record("update", kind, obj=obj)
        return result

    def update_status(self, kind, obj):
        result = self._inner.update_status(kind, obj)
        self._record("update_status", kind, obj=obj)
        return result

    def delete(self, kind, namespace, name):
        self._inner.delete(kind, namespace, name)
        self._record("delete", kind, namespace=namespace or "", name=name)


_AWS_SEED_HELPERS = frozenset(
    {"add_load_balancer", "add_hosted_zone", "set_load_balancer_state"}
)


class _RecordingAWS:
    """The scenario-facing AWS handle while a capture is armed: the
    seed helpers (LB registration, hosted-zone creation, LB state
    flips) are EXTERNAL inputs — a drill script conjuring the world —
    so they land on the capture chain as ``aws_seed`` control events
    and a replay re-injects them at their recorded instants.  API ops
    and oracle reads pass straight through; their outcomes are
    captured separately at the instrumented driver seam."""

    def __init__(self, inner, harness: "SimHarness"):
        self._inner = inner
        self._harness = harness

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name not in _AWS_SEED_HELPERS:
            return attr

        def seeded(*args, **kwargs):
            result = attr(*args, **kwargs)
            self._harness._record_control(
                "aws_seed", method=name, args=list(args), kwargs=dict(kwargs)
            )
            return result

        return seeded


class SimHarness:
    """Context manager owning one simulated world.  Use::

        with SimHarness(config=SimHarnessConfig(...)) as h:
            h.cluster.create("Service", make_lb_service())
            h.run_for(300.0)          # five virtual minutes
            assert h.converged(...)
    """

    def __init__(
        self,
        cluster: Optional[FakeCluster] = None,
        aws: Optional[FakeAWSBackend] = None,
        config: Optional[SimHarnessConfig] = None,
        capture: Optional[IncidentCapture] = None,
        pending_creates: bool = True,
    ):
        self.config = config or SimHarnessConfig()
        self.scheduler = runtime.SimScheduler()
        self._given_cluster = cluster
        self._given_aws = aws
        self._given_capture = capture
        # the topology caches' pending-create records: off only to
        # replay a capture whose controller read between the create
        # stages (``sim.replay``)
        self.pending_creates = pending_creates
        # the incident tap, armed in __enter__; the replay
        # harness sets informer_feed to substitute recorded watch
        # batches for live cluster deltas
        self.capture: Optional[IncidentCapture] = None
        self.informer_feed = None
        self._prev_capture: Optional[IncidentCapture] = None
        self._internal_verbs = 0
        self._installed = False
        self._stack: Optional[_Stack] = None
        self._electors: list[_SimElector] = []
        self._replica_serial = 0
        # sharded multi-replica mode
        self._sharded = self.config.shard_count > 1
        self._replicas: list["_ShardReplica"] = []
        self._queue_wake = None
        self._pumping = False
        self.generations = 0  # stacks built (leadership acquisitions)
        self.violations: list[str] = []
        # elastic resharding: unowned-window tracking of
        # moving keys across a drain/handoff, and the violations the
        # check_resize_handoffs oracle surfaces
        self.handoff_violations: list[str] = []
        self._unowned_since: dict[str, float] = {}
        self._resize_requests: list[int] = []
        # SLO-driven autoscaler: built in __enter__ when
        # config.autoscale arms it (sharded mode only)
        self.autoscaler: Optional[AutoscalerLoop] = None
        self.autoscaler_recorder: Optional[obs_recorder.FlightRecorder] = None
        # hooks the fuzzer uses: called around every GC sweep so
        # continuous oracles can snapshot ownership immediately before
        # the sweep and attribute each deletion to it precisely
        # (anything deleted BETWEEN sweeps belongs to the ordinary
        # reconcile paths, not the sweeper)
        self.on_gc_sweep_begin: Optional[Callable] = None
        self.on_gc_sweep: Optional[Callable] = None
        # called with (harness, stack) after every generation build —
        # scenario/canary customization point (each leadership
        # acquisition builds a fresh stack, so per-instance patches
        # must be re-applied)
        self.on_stack_built: Optional[Callable] = None

    # ------------------------------------------------------------------
    # world construction (inside the installed seam)
    # ------------------------------------------------------------------
    def __enter__(self) -> "SimHarness":
        from .. import clockseam

        clock = self.scheduler.clock
        clockseam.install(
            monotonic=clock.monotonic,
            wall=clock.time,
            sleep=clock.sleep,
            threads=False,
        )
        self._installed = True
        config = self.config
        self._raw_cluster = self._given_cluster or FakeCluster()
        if not hasattr(self._raw_cluster, "events_since"):
            raise TypeError(
                "SimHarness needs a cluster with events_since (FakeCluster)"
            )
        self.aws = self._given_aws or FakeAWSBackend(
            quota_accelerators=config.quota_accelerators,
            settle_describes=config.settle_describes,
        )
        # fault plan with NO creator exemption: the harness thread IS
        # every controller thread, so an exemption would exempt the
        # whole world.  Oracle reads use the unfaulted helper methods.
        if self.aws.fault_plan is None:
            self.aws.install_fault_plan(FaultPlan(exempt_creator=False))
        self.fault_plan = self.aws.fault_plan

        # the incident capture tap: armed by an explicit
        # IncidentCapture (the replay's shadow stream), the config knob,
        # or the AGAC_SIM_CAPTURE env var (chaos-suite teardowns).  The
        # header snapshots cluster + config so a replay reconstructs
        # the world; scenario-facing cluster writes flow through the
        # recording proxy, while stacks/electors keep the raw handle.
        self.capture = self._given_capture
        if self.capture is None:
            path = config.capture_path or os.environ.get("AGAC_SIM_CAPTURE")
            if path:
                self.capture = IncidentCapture(
                    _next_capture_path(path),
                    max_bytes=config.capture_max_bytes,
                    clock_mode="virtual",
                    source="sim",
                    snapshot_fn=self._capture_snapshot,
                )
        if self.capture is not None:
            self._prev_capture = capture_mod.install(self.capture)
            self.capture.record_clock("start")
            self.cluster = _RecordingCluster(self._raw_cluster, self)
            self.aws = _RecordingAWS(self.aws, self)
        else:
            self.cluster = self._raw_cluster

        # the convergence SLO plane: one fleet-scoped journey
        # tracker + SLO engine per scenario, on virtual time, installed
        # over the process globals for the harness's lifetime (the
        # reconcile loop and the controllers' enqueue stamps read the
        # global seam) and restored on exit.  Journeys are fleet-wide
        # by design: a key's journey survives the replica that opened
        # it, so a failover's true end-to-end latency is measured.
        self.journey_registry = obs_metrics.MetricsRegistry()
        self.journey = obs_journey.JourneyTracker(
            registry=self.journey_registry, clock=self.scheduler.monotonic
        )
        self._prev_journey = obs_journey.install(self.journey)
        self.slo_engine = obs_slo.SLOEngine(
            registry=self.journey_registry,
            objectives=config.slo_objectives,
            windows=(
                config.slo_windows
                if config.slo_windows is not None
                else obs_slo.DEFAULT_WINDOWS
            ),
            clock=self.scheduler.monotonic,
            journey_tracker=self.journey,
            shed_gates=config.slo_shed_gates,
        )
        self._prev_slo = obs_slo.install_engine(self.slo_engine)
        if config.slo_eval_interval > 0:
            self.scheduler.every(
                config.slo_eval_interval, self.slo_engine.tick, "slo-eval",
                priority=1,
            )
        if config.autoscale:
            # the shard autoscaler, tick-driven on the
            # virtual clock; registered AFTER slo-eval so a co-timed
            # evaluation sees this instant's burn, not last round's
            assert self._sharded, "autoscale needs shard_count > 1"
            self._wire_autoscaler()

        if self._sharded:
            # every replica gets its OWN process-world when it is
            # built (add_shard_replica below); the harness-level
            # aliases stay None so nothing accidentally shares state
            self.world = None
            self.health = None
            self.settle_table = None
            self.batcher = None
            self.controller_config = self._make_controller_config()
        else:
            self.world = _World(self)
            self.health = self.world.health
            self.settle_table = self.world.settle_table
            self.batcher = self.world.batcher
            self.controller_config = self._make_controller_config()

        # recurring plumbing ticks (priority 1: after same-instant
        # scenario actors, before nothing in particular — stable order)
        self.scheduler.every(
            config.settle_poll_interval, self._settle_tick, "settle-poll", priority=1
        )
        if config.drift_tick_period > 0:
            self.scheduler.every(
                config.drift_tick_period, self._drift_tick, "drift-tick", priority=1
            )
        if config.gc_sweep_period > 0:
            self.scheduler.every(
                config.gc_sweep_period, self._gc_tick, "gc-sweep", priority=1
            )
        self.scheduler.every(
            config.resync_period, self._resync_tick, "informer-resync", priority=1
        )
        with self._internal():
            if self._sharded:
                for _ in range(config.replicas):
                    self.add_shard_replica()
            else:
                for _ in range(config.replicas):
                    self._add_replica()
        return self

    # ------------------------------------------------------------------
    # incident capture
    # ------------------------------------------------------------------
    def _capture_snapshot(self) -> dict:
        """The capture header's world snapshot: enough to rebuild this
        harness — config plus the cluster store (rv-ordered, with the
        rv counter, so the replay mints the same resourceVersion
        stream).  Re-taken at every ring rotation."""
        objects: list = []
        rv = 0
        if hasattr(self._raw_cluster, "snapshot"):
            pairs, rv = self._raw_cluster.snapshot()
            objects = [
                {"kind": kind, "obj": capture_mod.encode_value(obj)}
                for kind, obj in pairs
            ]
        snapshot = {
            "config": encode_config(self.config),
            "cluster": {"resourceVersion": rv, "objects": objects},
        }
        if hasattr(self.aws, "snapshot_state"):
            snapshot["aws"] = self.aws.snapshot_state()
        return snapshot

    @contextlib.contextmanager
    def _internal(self):
        """Scope marking harness-initiated verbs: control events
        recorded inside carry origin=internal, so a replay knows they
        re-derive (crash handling, replacement replicas, autoscaler
        resizes) instead of needing re-injection."""
        self._internal_verbs += 1
        try:
            yield
        finally:
            self._internal_verbs -= 1

    def _record_control(self, action: str, **fields) -> None:
        if self.capture is not None:
            origin = "internal" if self._internal_verbs else "external"
            self.capture.record_control(action, origin=origin, **fields)

    def _wire_autoscaler(self) -> None:
        """Build the harness-level AutoscalerLoop: signals from the
        scenario's SLO engine / journey tracker, the first live
        replica's membership + key census (any replica works — the
        ring lease is shared truth), the union of live replicas' open
        circuits, and execution through the traced ``request_resize``
        verb.  Decisions land in a dedicated flight recorder so
        scenarios can assert EVERY decision was recorded."""
        config = self.config
        self.autoscaler_recorder = obs_recorder.FlightRecorder(
            capacity=4096, clock=self.scheduler.monotonic
        )

        def resize_status() -> dict:
            live = self.live_replicas()
            if not live:
                return {}
            return live[0].stack.manager.shard_membership.resize_status()

        def keys_by_shard() -> dict:
            live = self.live_replicas()
            if not live:
                return {}
            return live[0].stack.manager.keys_by_shard()

        def open_circuits() -> set:
            services: set = set()
            for replica in self.live_replicas():
                health = replica.world.health
                if health is not None:
                    services.update(health.open_services())
            return services

        signals = ScaleSignals(
            slo_engine=self.slo_engine,
            journey_tracker=self.journey,
            resize_status=resize_status,
            keys_by_shard=keys_by_shard,
            replica_count=lambda: len(self.live_replicas()),
            open_circuits=open_circuits,
            clock=self.scheduler.monotonic,
        )
        policy = ScalePolicy(config.autoscale_policy or ScalePolicyConfig())

        def execute_resize(target_count: int) -> int:
            # autoscaler resizes re-derive on replay (the loop runs
            # again over the same signals) — internal origin
            with self._internal():
                return self.request_resize(target_count)

        self.autoscaler = AutoscalerLoop(
            signals,
            policy,
            execute=execute_resize,
            registry=self.journey_registry,
            flight_recorder=self.autoscaler_recorder,
        )

        def autoscale_tick() -> None:
            if self.live_replicas():
                self.autoscaler.tick()

        self.scheduler.every(
            config.autoscale_interval, autoscale_tick, "autoscale", priority=1
        )

    def _make_controller_config(
        self, sharding: Optional[ShardingConfig] = None
    ) -> ControllerConfig:
        config = self.config
        return ControllerConfig(
            global_accelerator=GlobalAcceleratorConfig(
                cluster_name=config.cluster_name,
                queue_qps=config.queue_qps,
                queue_burst=config.queue_burst,
                queue_max_backoff=config.queue_max_backoff,
                reconcile_deadline=config.reconcile_deadline,
            ),
            route53=Route53Config(
                cluster_name=config.cluster_name,
                queue_qps=config.queue_qps,
                queue_burst=config.queue_burst,
                queue_max_backoff=config.queue_max_backoff,
                reconcile_deadline=config.reconcile_deadline,
            ),
            endpoint_group_binding=EndpointGroupBindingConfig(
                queue_qps=config.queue_qps,
                queue_burst=config.queue_burst,
                queue_max_backoff=config.queue_max_backoff,
                reconcile_deadline=config.reconcile_deadline,
            ),
            garbage_collector=GarbageCollectorConfig(
                interval=config.gc_sweep_period,
                grace_sweeps=config.gc_grace_sweeps,
                max_deletes=config.gc_max_deletes,
                cluster_name=config.cluster_name,
            ),
            settle_poll_interval=config.settle_poll_interval,
            sharding=sharding if sharding is not None else ShardingConfig(),
        )

    def __exit__(self, *exc) -> None:
        from .. import clockseam

        self._installed = False
        if self.capture is not None:
            self.capture.record_clock("stop")
            capture_mod.install(self._prev_capture)
            if self.capture is not self._given_capture:
                self.capture.close()
        obs_journey.install(self._prev_journey)
        obs_slo.install_engine(self._prev_slo)
        clockseam.reset()

    # ------------------------------------------------------------------
    # cloud factory (the per-region driver production would build)
    # ------------------------------------------------------------------
    def cloud_factory(self, region: str) -> AWSDriver:
        """Single-leader mode's driver factory (the process world's);
        sharded replicas each build drivers from their OWN world."""
        return self.world.cloud_factory(region)

    # ------------------------------------------------------------------
    # sharded multi-replica mode
    # ------------------------------------------------------------------
    def add_shard_replica(self) -> "_ShardReplica":
        """Add one concurrently-live sharded replica (its own world,
        manager, membership and informer cursors)."""
        assert self._sharded, "add_shard_replica needs shard_count > 1"
        self._replica_serial += 1
        replica = _ShardReplica(self, f"shard-replica-{self._replica_serial}")
        self._replicas.append(replica)
        self.generations += 1
        self._record_control("add_shard_replica", identity=replica.identity)
        if self.on_stack_built is not None:
            self.on_stack_built(self, replica.stack)
        return replica

    def live_replicas(self) -> list["_ShardReplica"]:
        return [replica for replica in self._replicas if not replica.dead]

    def kill_shard_replica(
        self, identity: Optional[str] = None, replace: bool = False
    ) -> str:
        """Hard-kill a sharded replica (default: the first live one):
        its stack and world vanish, its shard leases stay HELD — a
        survivor with spare capacity steals them one lease_duration
        after the last renewal it observed, then adopts the orphaned
        keyspace via the reshard resync."""
        for replica in self._replicas:
            if replica.dead:
                continue
            if identity is None or replica.identity == identity:
                self._record_control(
                    "kill_shard_replica",
                    identity=replica.identity, replace=replace,
                )
                self.scheduler.record("shard", f"killed:{replica.identity}")
                replica.kill()
                if replace:
                    with self._internal():
                        self.add_shard_replica()
                return replica.identity
        raise RuntimeError(f"no live shard replica matching {identity!r}")

    def stop_shard_replica(self, identity: Optional[str] = None) -> str:
        """Gracefully stop a sharded replica: shards are dropped
        locally first, then the leases released, so successors claim
        them without waiting out the lease duration."""
        for replica in self._replicas:
            if replica.dead:
                continue
            if identity is None or replica.identity == identity:
                self._record_control(
                    "stop_shard_replica", identity=replica.identity
                )
                self.scheduler.record("shard", f"released:{replica.identity}")
                replica.stop()
                return replica.identity
        raise RuntimeError(f"no live shard replica matching {identity!r}")

    def shard_ownership(self) -> dict[str, frozenset[int]]:
        """Live replicas' owned-shard sets — the exclusive-ownership
        oracle's subject."""
        return {
            replica.identity: replica.stack.manager.shard_membership.owned_shards()
            for replica in self.live_replicas()
        }

    def request_resize(self, target_count: int) -> int:
        """The live-resize verb: CAS the new shard-count
        target onto the ring lease; every replica's next membership
        tick begins the drain/handoff transition.  The key-level
        exclusive-ownership oracle arms itself for the transition."""
        from ..sharding import request_resize as _request_resize

        epoch = _request_resize(self._raw_cluster, target_count)
        self._resize_requests.append(target_count)
        self._record_control("request_resize", target=target_count, epoch=epoch)
        self.scheduler.record("resize", f"target:{target_count}@e{epoch}")
        return epoch

    def resize_states(self) -> dict[str, dict]:
        """Per-replica resize status (assertion surface)."""
        return {
            replica.identity: (
                replica.stack.manager.shard_membership.resize_status()
            )
            for replica in self.live_replicas()
        }

    def resize_settled(self, target_count: int) -> bool:
        """True once every live replica's membership runs the stable
        target-count ring with no handoffs pending."""
        for status in self.resize_states().values():
            if (
                status["state"] != "stable"
                or status["shard_count"] != target_count
                or status["handoff_pending"]
            ):
                return False
        return True

    def check_exclusive_ownership(self) -> None:
        """The no-key-owned-by-two-shards oracle, continuous form:
        called after every membership tick; any overlap between two
        LIVE replicas' owned sets is appended to ``violations``.
        (A dead replica's stale leases are unowned keyspace, not an
        overlap — nobody enqueues for them until a survivor steals.)

        During a live resize shard indices are not the
        whole truth — a moving key's EFFECTIVE owner depends on the
        drain/handoff state — so the check drops to key granularity:
        every managed key must have at most one live owner through the
        whole transition, and a moving key's unowned window (donor
        drained, gainer not yet adopted) must stay within the handoff
        budget while both sides are alive."""
        ownership = sorted(self.shard_ownership().items())
        for i, (id_a, owned_a) in enumerate(ownership):
            for id_b, owned_b in ownership[i + 1:]:
                overlap = owned_a & owned_b
                if overlap:
                    self.violations.append(
                        f"exclusive-ownership: shards {sorted(overlap)} owned "
                        f"by BOTH {id_a} and {id_b} at "
                        f"t={self.scheduler.monotonic():.1f}"
                    )
        transitioning = any(
            replica.stack.manager.shard_membership.next_ring is not None
            for replica in self.live_replicas()
        )
        if transitioning or self._unowned_since:
            self._check_key_ownership(transitioning)

    # keys beyond which the key-level sweep would dominate the tick
    # (transitions in huge fleets fall back to the shard-set check)
    _KEY_ORACLE_CAP = 10_000

    def _handoff_budget(self) -> float:
        if self.config.handoff_window_budget > 0:
            return self.config.handoff_window_budget
        return 4.0 * self.config.lease.retry_period

    def _check_key_ownership(self, transitioning: bool) -> None:
        from ..controllers.globalaccelerator import is_managed_service
        from ..cluster.objects import meta_namespace_key

        live = self.live_replicas()
        live_identities = {replica.identity for replica in live}
        services, _ = self.cluster.list("Service")
        managed = [
            meta_namespace_key(svc) for svc in services if is_managed_service(svc)
        ]
        if len(managed) > self._KEY_ORACLE_CAP:
            return
        now = self.scheduler.monotonic()
        budget = self._handoff_budget()
        for key in managed:
            owners = [
                replica.identity
                for replica in live
                if replica.stack.manager.shard_filter.owns_key(key)
            ]
            if len(owners) > 1:
                self.violations.append(
                    f"exclusive-ownership: key {key!r} owned by "
                    f"{sorted(owners)} at t={now:.1f}"
                )
                self._unowned_since.pop(key, None)
            elif owners:
                since = self._unowned_since.pop(key, None)
                if since is not None and now - since > budget:
                    self.handoff_violations.append(
                        f"handoff-window: key {key!r} unowned for "
                        f"{now - since:.1f}s (budget {budget:.1f}s)"
                    )
            else:
                # unowned: only a PROTOCOL gap counts against the
                # handoff budget — a dead holder's keyspace waits for
                # the lease steal, which is failover latency, not a
                # drain/handoff defect
                if transitioning and self._key_holders_live(key, live_identities):
                    self._unowned_since.setdefault(key, now)
                else:
                    self._unowned_since.pop(key, None)

    def _key_holders_live(self, key: str, live_identities: set) -> bool:
        """True when every lease the key's handoff depends on — its
        old-ring shard, its new-ring shard, and every OTHER donor the
        gainer's adoption waits for — is held by a LIVE replica: the
        case where an unowned window is the protocol's own latency.
        A dead holder anywhere in that dependency set turns the window
        into failover latency (bounded by the lease steal, not the
        handoff budget), so the clock stops."""
        for replica in self.live_replicas():
            membership = replica.stack.manager.shard_membership
            if membership.next_ring is None or membership.plan is None:
                continue
            s_old = membership.ring.shard_for_key(key)
            s_new = membership.next_ring.shard_for_key(key)
            holders = membership.shard_map()["holders"]
            involved = {s_old, s_new}
            involved.update(membership.plan.donors_of.get(s_new, ()))
            return all(
                holders.get(str(shard)) in live_identities
                for shard in involved
            )
        return False

    # ------------------------------------------------------------------
    # leadership
    # ------------------------------------------------------------------
    def _add_replica(self) -> _SimElector:
        self._replica_serial += 1
        elector = _SimElector(self, f"replica-{self._replica_serial}")
        self._electors.append(elector)
        return elector

    def _on_leader_acquired(self, elector: _SimElector) -> None:
        if self._stack is not None:
            return  # split-brain guard: a live stack keeps running
        klog.infof("sim: %s acquired leadership", elector.identity)
        self.scheduler.record("leader", f"acquired:{elector.identity}")
        self._stack = _Stack(self, elector.identity)
        self.generations += 1
        if self.on_stack_built is not None:
            self.on_stack_built(self, self._stack)

    def _on_leader_lost(self, elector: _SimElector) -> None:
        if self._stack is not None and self._stack.identity == elector.identity:
            self.scheduler.record("leader", f"lost:{elector.identity}")
            self._drop_stack()

    def _drop_stack(self) -> None:
        self._stack = None
        # in-memory only by doctrine: the next generation rebuilds the
        # table from requeue (kill-mid-settle drill semantics)
        self.settle_table.reset()

    def leader(self) -> Optional[str]:
        return self._stack.identity if self._stack is not None else None

    def kill_leader(self) -> None:
        """Hard-kill the leading replica: its stack vanishes, the
        lease stays held — the standby (or a replacement replica)
        takes over one lease_duration after the last renewal it
        observed.  A replacement contender is added so the pool size
        is preserved."""
        for elector in self._electors:
            if self._stack is not None and elector.identity == self._stack.identity:
                self._record_control("kill_leader", identity=elector.identity)
                self.scheduler.record("leader", f"killed:{elector.identity}")
                elector.kill()
                self._drop_stack()
                with self._internal():
                    self._add_replica()
                return
        raise RuntimeError("no leader to kill")

    def _handle_crash(self, crash: SimulatedCrash) -> None:
        klog.warningf("sim: %s — killing leader generation", crash)
        self.scheduler.record("crash", f"{crash.op}:{crash.when}")
        if self._stack is not None:
            # crash recovery is a CONSEQUENCE of the recorded fault
            # plan, not a scenario verb — internal for the replay
            with self._internal():
                self.kill_leader()

    def _handle_crash_replica(
        self, replica: "_ShardReplica", crash: SimulatedCrash
    ) -> None:
        """Sharded-mode crash: the replica whose worker/tick hit the
        crash boundary dies (leases stay held); a replacement contender
        joins so the pool size is preserved, exactly like
        ``kill_leader``."""
        klog.warningf("sim: %s — killing %s", crash, replica.identity)
        self.scheduler.record("crash", f"{crash.op}:{crash.when}")
        self.scheduler.record("shard", f"crashed:{replica.identity}")
        replica.kill()
        with self._internal():
            self.add_shard_replica()

    def demote_leader(self) -> None:
        """Gracefully stop the leading replica (lease released)."""
        for elector in self._electors:
            if self._stack is not None and elector.identity == self._stack.identity:
                self._record_control("demote_leader", identity=elector.identity)
                self.scheduler.record("leader", f"released:{elector.identity}")
                elector.release()
                self._drop_stack()
                with self._internal():
                    self._add_replica()
                return
        raise RuntimeError("no leader to demote")

    # ------------------------------------------------------------------
    # recurring plumbing ticks
    # ------------------------------------------------------------------
    def _settle_tick(self) -> None:
        if self._sharded:
            for replica in self.live_replicas():
                if replica.world.settle_table.depth():
                    try:
                        replica.world.settle_table.poll_once()
                    except SimulatedCrash as crash:
                        self._handle_crash_replica(replica, crash)
            return
        if self._stack is not None and self.settle_table.depth():
            try:
                self.settle_table.poll_once()
            except SimulatedCrash as crash:
                self._handle_crash(crash)

    def _drift_tick(self) -> None:
        if self._sharded:
            for replica in self.live_replicas():
                try:
                    replica.stack.manager.drift_tick()
                except SimulatedCrash as crash:
                    self._handle_crash_replica(replica, crash)
            return
        if self._stack is not None:
            try:
                self._stack.manager.drift_tick()
            except SimulatedCrash as crash:
                self._handle_crash(crash)

    def _gc_tick(self) -> None:
        for stack in self.live_stacks():
            if stack.manager.gc is None:
                continue
            if self.on_gc_sweep_begin is not None:
                self.on_gc_sweep_begin(self)
            try:
                report = stack.manager.gc_sweep()
            except SimulatedCrash as crash:
                if self._sharded:
                    self._handle_crash_replica(stack._sim_replica, crash)
                    continue
                self._handle_crash(crash)
                return
            if self.on_gc_sweep is not None:
                self.on_gc_sweep(self, report)

    def _resync_tick(self) -> None:
        for stack in self.live_stacks():
            stack.resync(self)

    # ------------------------------------------------------------------
    # the cooperative executor
    # ------------------------------------------------------------------
    def live_stacks(self) -> list[_Stack]:
        """Every live stack, in deterministic construction order: the
        leader's (single mode) or one per live sharded replica."""
        if self._sharded:
            return [replica.stack for replica in self.live_replicas()]
        return [self._stack] if self._stack is not None else []

    def settle_tables(self) -> list:
        """Every live pending-settle table (one per process-world)."""
        if self._sharded:
            return [replica.world.settle_table for replica in self.live_replicas()]
        return [self.settle_table] if self.settle_table is not None else []

    def _stack_alive(self, stack: _Stack) -> bool:
        if self._sharded:
            replica = getattr(stack, "_sim_replica", None)
            return replica is not None and not replica.dead
        return self._stack is stack

    def _step_worker(self, stack: _Stack, entry: _WorkerEntry) -> None:
        key = entry.queue.peek()
        self.scheduler.record("work", f"{entry.name}:{key}")
        thread = threading.current_thread()
        original = thread.name
        # the reconcile kernel derives its controller label (metrics,
        # traces, heartbeats) from the worker thread's name
        thread.name = f"{entry.name}-worker-0"
        try:
            process_next_work_item(
                entry.queue,
                entry.key_to_obj,
                entry.process_delete,
                entry.process_create_or_update,
                entry.on_sync_result,
                reconcile_deadline=entry.reconcile_deadline,
            )
        except SimulatedCrash as crash:
            # the in-sim analog of os._exit(137): the "process" whose
            # worker hit this API boundary dies — its whole stack
            # vanishes, its lease(s) stay held, recovery is takeover +
            # level-triggered resync
            if self._sharded:
                self._handle_crash_replica(stack._sim_replica, crash)
            else:
                self._handle_crash(crash)
        finally:
            thread.name = original

    def _pump(self) -> None:
        """Drain everything runnable at the current virtual instant:
        informer deltas, matured queue delays, and every ready work
        item — one item per queue per round, round-robin over every
        live stack, until quiescent.  This is the cooperative
        thread-step executor; its iteration order (stacks in
        construction order; informers then queues in construction
        order within each) IS the deterministic ready-queue order."""
        if self._pumping:
            return  # re-entrancy guard (an actor stepping inside pump)
        self._pumping = True
        try:
            steps = 0
            while True:
                progress = False
                for stack in self.live_stacks():
                    if not self._stack_alive(stack):
                        continue  # crashed earlier in this round
                    progress |= stack.pump_informers(self)
                    for entry in stack.workers:
                        if not self._stack_alive(stack):
                            break  # a crash killed this stack
                        entry.queue.pop_due_delays()
                        if len(entry.queue):
                            self._step_worker(stack, entry)
                            progress = True
                            steps += 1
                if not progress:
                    return
                if steps > PUMP_STEP_LIMIT:
                    depths = {
                        e.name: len(e.queue)
                        for s in self.live_stacks()
                        for e in s.workers
                    }
                    raise RuntimeError(
                        f"sim pump livelock: {steps} worker steps without "
                        f"quiescing (queue depths {depths})"
                    )
        finally:
            self._pumping = False

    def _schedule_queue_wake(self) -> None:
        deadlines = [
            deadline
            for stack in self.live_stacks()
            for entry in stack.workers
            if (deadline := entry.queue.next_delay_deadline()) is not None
        ]
        if not deadlines:
            return
        deadline = min(deadlines)
        if self._queue_wake is not None and not self._queue_wake.cancelled:
            if self._queue_wake.deadline <= deadline:
                return
            self._queue_wake.cancel()
        self._queue_wake = self.scheduler.call_at(
            deadline, lambda: None, "queue-wake", priority=2
        )

    # ------------------------------------------------------------------
    # running
    # ------------------------------------------------------------------
    def run_until(self, deadline: float) -> None:
        """Advance the world to virtual time ``deadline``."""
        assert self._installed, "use `with SimHarness(...) as h:`"
        while True:
            self._pump()
            self._schedule_queue_wake()
            next_deadline = self.scheduler.next_deadline()
            if next_deadline is None or next_deadline > deadline:
                break
            self.scheduler.step()
        self.scheduler.advance_to(deadline)

    def run_for(self, seconds: float) -> None:
        self.run_until(self.scheduler.monotonic() + seconds)

    def run_until_quiescent(
        self, timeout: float, settle_window: float = 0.0
    ) -> bool:
        """Run until no queue holds ready OR delayed work, nothing is
        parked in the settle table, and (optionally) a further
        ``settle_window`` of virtual time passes without any AWS call
        — or until ``timeout`` virtual seconds elapse.  Returns True
        on quiescence."""
        deadline = self.scheduler.monotonic() + timeout
        while self.scheduler.monotonic() < deadline:
            self._pump()
            if not self._busy():
                if settle_window <= 0:
                    return True
                calls_before = len(self.aws.calls)
                self.run_for(settle_window)
                if len(self.aws.calls) == calls_before and not self._busy():
                    return True
                continue
            self._schedule_queue_wake()
            next_deadline = self.scheduler.next_deadline()
            if next_deadline is None or next_deadline > deadline:
                break
            self.scheduler.step()
        return not self._busy()

    def _busy(self) -> bool:
        stacks = self.live_stacks()
        if not stacks:
            return False
        for table in self.settle_tables():
            if table.depth():
                return True
        for stack in stacks:
            for entry in stack.workers:
                if len(entry.queue) or entry.queue.next_delay_deadline() is not None:
                    return True
        return False

    # ------------------------------------------------------------------
    # scenario actors + trace
    # ------------------------------------------------------------------
    def spawn(self, gen: Generator[float, None, None], name: str) -> None:
        self.scheduler.spawn(gen, name)

    def after(self, delay: float, fn: Callable[[], None], name: str) -> None:
        self.scheduler.call_after(delay, fn, name)

    def trace_hash(self) -> str:
        return self.scheduler.trace_hash()

    def fleet_metrics(self) -> str:
        """The fleet-merged exposition over every LIVE replica's
        private world registry plus the scenario's journey registry —
        the in-sim analog of scraping every replica's /metrics/fleet
        (counters/histograms summed, gauges labeled by shard)."""
        sources = {"journeys": self.journey_registry.render}
        for stack in self.live_stacks():
            sources[stack.identity] = stack.world.registry.render
        return obs_fleet.FleetView(sources).render()

    def stats(self) -> dict:
        stats = {
            "virtual_time": round(self.scheduler.monotonic(), 3),
            "events": self.scheduler.events_dispatched,
            "aws_calls": len(self.aws.calls),
            "generations": self.generations,
            "leader": self.leader(),
        }
        if self._sharded:
            stats["replicas"] = [r.identity for r in self.live_replicas()]
            stats["ownership"] = {
                identity: sorted(owned)
                for identity, owned in self.shard_ownership().items()
            }
            stats["settle"] = [table.stats() for table in self.settle_tables()]
        else:
            stats["settle"] = self.settle_table.stats()
            stats["batcher"] = self.batcher.stats() if self.batcher else None
        return stats
