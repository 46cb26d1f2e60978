"""Cloud factory used by the CLI process.

The production analog of the reference's inline ``NewAWS(region)``
calls: one driver per region, with GA/Route53 pinned to the global
endpoint region (us-west-2, reference ``aws.go:26-32``).

``AGAC_CLOUD=fake`` switches the whole process onto one shared
in-memory backend — the no-credentials demo/e2e mode (the reference
has no equivalent; its e2e needs real AWS).  The fake can be seeded
from the environment so annotated Services find their load balancers:

- ``AGAC_FAKE_LBS``: comma-separated ``name=hostname`` pairs (region
  is parsed from the hostname);
- ``AGAC_FAKE_ZONES``: comma-separated hosted-zone names;
- ``AGAC_FAKE_STATE``: path to a JSON state file that makes the fake
  DURABLE across process generations (``FileBackedFakeAWSBackend``) —
  the kill-recovery drills' ground truth;
- ``AGAC_FAKE_CRASH``: ``op:when[,op:when...]`` one-shot crash faults
  mapped to hard process death (``os._exit(137)``) at the exact API
  boundary — the in-repo ``kill -9`` (see ``FaultPlan.crash``).

The default mode builds the real SigV4 HTTP backend.

Cache wiring: one process-wide instance of each cache, shared by the
per-reconcile drivers — the discovery and hosted-zone snapshots plus
the three coalesced-read-plane caches (accelerator topology, per-zone
record sets, and the per-REGION DescribeLoadBalancers coalescers; a
batch goes out through one region's endpoint, so coalescers must
never be shared across regions).  TTLs come from the environment
(table in docs/operations.md "Runtime knobs"); the ``controller``
subcommand's ``--read-plane-ttl`` flag feeds ``configure_read_plane``.
"""

from __future__ import annotations

import os
import threading
from typing import Callable

from ...observability import instruments as obs_instruments
from ...observability import metrics as obs_metrics
from ...reconcile.pending import PendingSettleTable
from .batcher import ChangeBatcher
from .cache import (
    AcceleratorTopologyCache,
    DiscoveryCache,
    HostedZoneCache,
    LoadBalancerCoalescer,
    RecordSetCache,
)
from .driver import AWSDriver
from .fake_backend import FakeAWSBackend, FaultPlan, FileBackedFakeAWSBackend
from .health import ELBV2_OPS, GA_OPS, ROUTE53_OPS, HealthConfig, HealthTracker
from .load_balancer import get_lb_name_from_hostname

_fake_backend: FakeAWSBackend | None = None
_lock = threading.Lock()
# process-wide API health plane (circuit breakers + AIMD pacing)
_health_tracker: HealthTracker | None = None
# process-wide cache singletons shared by the per-reconcile drivers
_discovery_cache: DiscoveryCache | None = None
_zone_cache: HostedZoneCache | None = None
_topology_cache: AcceleratorTopologyCache | None = None
_record_cache: RecordSetCache | None = None
_lb_coalescers: dict[str, LoadBalancerCoalescer] = {}
# the async mutation pipeline: one pending-settle table and
# one per-zone change batcher per process, shared by every driver
_settle_table: PendingSettleTable | None = None
_change_batcher: ChangeBatcher | None = None

# memoized TTL values (env parsed once per process; a malformed value
# must not poison every reconcile — fall back and say so once)
_ttl_values: dict[str, float] = {}  # agac-lint: ignore[shared-state-census] -- idempotent env memo; racing fills store the same parsed value
# explicit overrides (CLI flags) beat the environment
_ttl_overrides: dict[str, float] = {}


def _env_float(name: str, default: float) -> float:
    if name in _ttl_overrides:
        return _ttl_overrides[name]
    if name in _ttl_values:
        return _ttl_values[name]
    raw = os.environ.get(name, str(default))
    try:
        value = float(raw)
    except ValueError:
        from ... import klog

        klog.errorf("%s=%r is not a number; using default %gs", name, raw, default)
        value = default
    _ttl_values[name] = value
    return value


def configure_read_plane(ttl: float | None) -> None:
    """Pin the three read-plane TTLs from the CLI (``--read-plane-ttl``):
    one knob for the verification-read tick scope.  ``None`` keeps the
    per-cache environment variables / defaults; 0 disables the read
    plane entirely (reference-parity per-object reads)."""
    if ttl is None:
        return
    for name in (
        "AGAC_TOPOLOGY_VERIFY_TTL",
        "AGAC_RECORDSET_CACHE_TTL",
        "AGAC_LB_CACHE_TTL",
    ):
        _ttl_overrides[name] = ttl


def configure_pipeline(
    settle_poll_interval: float | None = None,
    r53_batch_max: float | None = None,
    r53_batch_linger: float | None = None,
) -> None:
    """Pin the async-mutation-pipeline knobs from the CLI
    (``--settle-poll-interval`` / ``--r53-batch-max`` /
    ``--r53-batch-linger``); ``None`` keeps the per-knob environment
    variables / defaults.  settle interval 0 disables the
    pending-settle table (reference-parity blocking settle); linger 0
    disables Route53 change batching (one wire call per mutation)."""
    for name, value in (
        ("AGAC_SETTLE_POLL_INTERVAL", settle_poll_interval),
        ("AGAC_R53_BATCH_MAX", r53_batch_max),
        ("AGAC_R53_BATCH_LINGER", r53_batch_linger),
    ):
        if value is not None:
            _ttl_overrides[name] = value


def settle_poll_interval() -> float:
    """The pending-settle scheduler's tick period: each tick re-checks
    every parked chain in coalesced reads.  1 s default — the checks
    are one ListAccelerators for all parked teardowns plus pure
    in-memory peeks, so a tight tick is cheap and convergence latency
    for resolved waits stays ~1 s.  0 disables the whole table."""
    return _env_float("AGAC_SETTLE_POLL_INTERVAL", 1.0)


def shared_settle_table() -> PendingSettleTable | None:
    """The process-wide pending-settle table, or None when disabled
    (``AGAC_SETTLE_POLL_INTERVAL=0``).  The manager runs the poll-tick
    scheduler over it (``Manager.run``)."""
    global _settle_table
    if settle_poll_interval() <= 0:
        return None
    with _lock:
        if _settle_table is None:
            _settle_table = PendingSettleTable(registry=obs_metrics.registry())
        return _settle_table


def shared_change_batcher() -> ChangeBatcher | None:
    """The process-wide per-zone Route53 change batcher, or None when
    disabled (``AGAC_R53_BATCH_LINGER=0``, the default — batching is
    opt-in until a deployment raises the linger; see docs/operations.md
    "Async mutation pipeline")."""
    global _change_batcher
    linger = _env_float("AGAC_R53_BATCH_LINGER", 0.0)
    if linger <= 0:
        return None
    with _lock:
        if _change_batcher is None:
            _change_batcher = ChangeBatcher(
                max_changes=int(_env_float("AGAC_R53_BATCH_MAX", 100)),
                linger=linger,
                registry=obs_metrics.registry(),
            )
        return _change_batcher


def _chain_stage_requeue() -> float:
    """Stage-yield requeue delay for the interleaved accelerator
    chain; 0 disables staging (one worker holds the item across the
    whole create chain — reference parity)."""
    if _env_float("AGAC_CHAIN_STAGES", 1.0) <= 0:
        return 0.0
    return _env_float("AGAC_CHAIN_STAGE_REQUEUE", 0.01)


def pipeline_stats() -> dict:
    """Pending-settle + batcher counters — the bench/healthz hook."""
    with _lock:
        table, batcher = _settle_table, _change_batcher
    stats = {}
    if table is not None:
        stats["pending_settle"] = table.stats()
    if batcher is not None:
        stats["r53_batching"] = batcher.stats()
    return stats


def configure_api_health(
    window: float | None = None,
    failure_ratio: float | None = None,
    min_calls: float | None = None,
    open_duration: float | None = None,
    probe_budget: float | None = None,
    aimd_qps: float | None = None,
) -> None:
    """Pin the API health plane knobs from the CLI (``--api-health-*``
    flags); ``None`` keeps the per-knob environment variables /
    defaults.  window 0 disables the whole plane (reference-parity
    fixed-rate retries)."""
    for name, value in (
        ("AGAC_API_HEALTH_WINDOW", window),
        ("AGAC_API_HEALTH_FAILURE_RATIO", failure_ratio),
        ("AGAC_API_HEALTH_MIN_CALLS", min_calls),
        ("AGAC_API_HEALTH_OPEN_DURATION", open_duration),
        ("AGAC_API_HEALTH_PROBE_BUDGET", probe_budget),
        ("AGAC_API_HEALTH_AIMD_QPS", aimd_qps),
    ):
        if value is not None:
            _ttl_overrides[name] = value


def shared_health_tracker() -> HealthTracker | None:
    """The process-wide health tracker, or None when disabled
    (``AGAC_API_HEALTH_WINDOW=0``).  Knob table in docs/operations.md
    "API health plane"."""
    global _health_tracker
    # 30 s rolling window / 50% failure ratio over >= 10 calls: wide
    # enough that one unlucky burst of throttles never trips the
    # breaker, tight enough that a real brownout opens it within one
    # drift verify round
    window = _env_float("AGAC_API_HEALTH_WINDOW", 30.0)
    if window <= 0:
        return None
    with _lock:
        if _health_tracker is None:
            _health_tracker = HealthTracker(
                registry=obs_metrics.registry(),
                config=HealthConfig(
                    window=window,
                    min_calls=int(_env_float("AGAC_API_HEALTH_MIN_CALLS", 10)),
                    failure_ratio=_env_float("AGAC_API_HEALTH_FAILURE_RATIO", 0.5),
                    # 15 s open: long enough to actually shed load,
                    # short enough that recovery is noticed within one
                    # requeue interval
                    open_duration=_env_float("AGAC_API_HEALTH_OPEN_DURATION", 15.0),
                    probe_budget=int(_env_float("AGAC_API_HEALTH_PROBE_BUDGET", 1)),
                    # AIMD ceiling: 20 calls/s per service per process
                    # (comfortably above steady-state need; the point
                    # is the multiplicative cut under throttling)
                    aimd_qps=_env_float("AGAC_API_HEALTH_AIMD_QPS", 20.0),
                )
            )
        return _health_tracker


def api_health_stats() -> dict:
    """Per-circuit state + outcome counters — the observability hook
    the manager's /readyz endpoint and the bench export."""
    with _lock:
        tracker = _health_tracker
    return tracker.snapshot() if tracker is not None else {}


def _discovery_cache_ttl() -> float:
    # 30 s default: the write journal (cache.py) makes the TTL a pure
    # cross-process staleness bound — local writes are always visible —
    # so it can match the 30 s informer-resync staleness the reference
    # already tolerates; measured at N=1000 this cuts refresh scans 6x
    # vs the old 5 s with no correctness cost
    return _env_float("AGAC_DISCOVERY_CACHE_TTL", 30.0)


def _zone_cache_ttl() -> float:
    # 60 s: hosted zones are created by humans, not this controller —
    # the TTL only bounds how long a zone deleted out-of-band keeps
    # resolving (and the ensure path invalidates explicitly on
    # NoSuchHostedZone anyway); 0 disables
    return _env_float("AGAC_ZONE_CACHE_TTL", 60.0)


def _shared_zone_cache() -> HostedZoneCache | None:
    global _zone_cache
    ttl = _zone_cache_ttl()
    if ttl <= 0:
        return None
    with _lock:
        if _zone_cache is None:
            _zone_cache = HostedZoneCache(ttl=ttl)
        return _zone_cache


def _shared_discovery_cache() -> DiscoveryCache | None:
    global _discovery_cache
    ttl = _discovery_cache_ttl()
    if ttl <= 0:
        return None
    tracker = shared_health_tracker()
    # 300 s: between full tag re-lists, snapshot reloads REUSE known
    # accelerators' tags (local writes are write-through exact) and
    # only new arns pay a live ListTagsForResource — the O(N) tag-read
    # stall per reload is gone, at the cost of out-of-band TAG edits
    # being detected within 300 s instead of the 30 s snapshot TTL
    # (bound documented in docs/operations.md).
    # <= 0 restores the legacy full re-read per reload.
    tags_ttl = _env_float("AGAC_DISCOVERY_TAGS_TTL", 300.0)
    with _lock:
        if _discovery_cache is None:
            _discovery_cache = DiscoveryCache(
                ttl=ttl,
                tags_ttl=tags_ttl if tags_ttl > 0 else None,
                # degraded mode: with the GA circuit open, serve the
                # expired discovery snapshot stale rather than dispatch
                # a doomed O(N) rescan (staleness bound: the outage)
                degraded=(
                    (lambda: tracker.is_open("globalaccelerator"))
                    if tracker is not None
                    else None
                ),
            )
        return _discovery_cache


def _shared_topology_cache() -> AcceleratorTopologyCache | None:
    global _topology_cache
    # 15 s verify window: the verification dedup scope of one drift
    # tick (periods are >= 300 s at any fleet size worth ticking, see
    # docs/operations.md); 0 disables.  The full-relist TTL bounds how
    # long the write-through listener identity is trusted before ports/
    # protocol are re-read from AWS — 900 s keeps that within a few
    # ticks at production periods.
    verify_ttl = _env_float("AGAC_TOPOLOGY_VERIFY_TTL", 15.0)
    full_ttl = _env_float("AGAC_TOPOLOGY_FULL_TTL", 900.0)
    if verify_ttl <= 0:
        return None
    with _lock:
        if _topology_cache is None:
            _topology_cache = AcceleratorTopologyCache(
                verify_ttl=verify_ttl, full_ttl=max(full_ttl, verify_ttl)
            )
        return _topology_cache


def _shared_record_cache() -> RecordSetCache | None:
    global _record_cache
    # 15 s: the per-zone snapshot scope of one verification round; the
    # driver folds its own change batches back in, so the TTL only
    # bounds detection of OUT-OF-BAND record edits; 0 disables
    ttl = _env_float("AGAC_RECORDSET_CACHE_TTL", 15.0)
    if ttl <= 0:
        return None
    tracker = shared_health_tracker()
    with _lock:
        if _record_cache is None:
            _record_cache = RecordSetCache(
                ttl=ttl,
                # degraded mode: with the Route53 circuit open, serve
                # expired zone snapshots stale (see DiscoveryCache)
                degraded=(
                    (lambda: tracker.is_open("route53"))
                    if tracker is not None
                    else None
                ),
            )
        return _record_cache


def _shared_lb_coalescer(region: str) -> LoadBalancerCoalescer | None:
    # 15 s: LB state/DNS are re-read every verification round; the
    # 10 ms gather window turns a tick's concurrent single-name
    # lookups into ~worker-pool-sized wire batches; 0 disables
    ttl = _env_float("AGAC_LB_CACHE_TTL", 15.0)
    if ttl <= 0:
        return None
    window = _env_float("AGAC_LB_BATCH_WINDOW", 0.01)
    with _lock:
        coalescer = _lb_coalescers.get(region)
        if coalescer is None:
            coalescer = _lb_coalescers[region] = LoadBalancerCoalescer(
                ttl=ttl, batch_window=max(window, 0.0)
            )
        return coalescer


def _seed_from_environment(backend: FakeAWSBackend) -> None:
    from ... import klog

    for pair in filter(None, os.environ.get("AGAC_FAKE_LBS", "").split(",")):
        name, _, hostname = pair.partition("=")
        if not hostname:
            continue
        try:
            _, region = get_lb_name_from_hostname(hostname)
        except ValueError as err:
            # a malformed entry must not poison every reconcile or
            # leave the backend half-seeded
            klog.errorf("AGAC_FAKE_LBS: skipping %r: %s", pair, err)
            continue
        backend.add_load_balancer(name, region, hostname)
    for zone in filter(None, os.environ.get("AGAC_FAKE_ZONES", "").split(",")):
        backend.add_hosted_zone(zone)


def _install_crash_plan(backend: FakeAWSBackend) -> None:
    """``AGAC_FAKE_CRASH=op:when[,op:when...]`` arms one-shot crash
    faults (``FaultPlan.crash``) on the shared fake backend, mapped to
    hard process death — the ``kill -9`` analog the kill-recovery
    drills in ``tests/test_process_e2e.py`` drive.  ``when`` is
    ``before`` (default) or ``after-commit``."""
    raw = os.environ.get("AGAC_FAKE_CRASH", "")
    if not raw:
        return
    from ... import klog

    plan = backend.install_fault_plan(FaultPlan(exempt_creator=False))
    for entry in filter(None, raw.split(",")):
        op, _, when = entry.partition(":")
        plan.crash(op.strip(), when=when.strip() or "before")

    def die(crash):
        klog.errorf("AGAC_FAKE_CRASH: %s — exiting hard", crash)
        os._exit(137)  # the kill -9 exit status, uncatchable like it

    plan.on_crash = die


def shared_fake_backend() -> FakeAWSBackend:
    global _fake_backend
    with _lock:
        if _fake_backend is None:
            # AGAC_FAKE_STATE makes the fake AWS durable (a JSON state
            # file shared across process generations) — committed
            # mutations survive a kill -9, which is what makes crash
            # drills against AGAC_CLOUD=fake meaningful
            state_path = os.environ.get("AGAC_FAKE_STATE", "")
            # AGAC_FAKE_SETTLE=N makes accelerator create/update settle
            # through N describe/list reads before DEPLOYED — the seam
            # the kill-mid-settle process drill uses to exercise the
            # pending-settle path against a real controller process
            settle = int(os.environ.get("AGAC_FAKE_SETTLE", "0") or 0)
            # AGAC_FAKE_LATENCY=S shapes every fake API call with S
            # seconds of wire latency — the multi-process sharding
            # bench's capacity model (worker pool x latency per
            # process)
            latency = float(os.environ.get("AGAC_FAKE_LATENCY", "0") or 0)
            # AGAC_FAKE_QUOTA_ACCELERATORS raises the fake account's
            # accelerator quota (default 20) the way a real account
            # requests a quota increase — fleet-scale process drills
            # and the sharding bench need hundreds
            quota = int(os.environ.get("AGAC_FAKE_QUOTA_ACCELERATORS", "20") or 20)
            if state_path:
                _fake_backend = FileBackedFakeAWSBackend(
                    state_path, settle_describes=settle, latency=latency,
                    quota_accelerators=quota,
                )
            else:
                _fake_backend = FakeAWSBackend(
                    settle_describes=settle, latency=latency,
                    quota_accelerators=quota,
                )
            _seed_from_environment(_fake_backend)
            _install_crash_plan(_fake_backend)
        return _fake_backend


def invalidate_read_plane() -> None:
    """Drop every process-wide read-plane snapshot: wired as
    ``Manager.on_reshard``, so a replica adopting another process's
    keyspace re-reads AWS instead of trusting snapshots taken before
    the ownership change — a stale discovery snapshot at adoption time
    means duplicate accelerators.  The discovery snapshot keeps the tags
    of the accelerators it knew, so the re-read lists every accelerator
    and reads tags only for new ones.  A durable fake account
    (``AGAC_FAKE_STATE``) re-reads its file on the next call too."""
    with _lock:
        discovery, zones = _discovery_cache, _zone_cache
        topology, records = _topology_cache, _record_cache
        backend = _fake_backend
    if isinstance(backend, FileBackedFakeAWSBackend):
        backend.invalidate_reads()
    if discovery is not None:
        discovery.invalidate_keeping_tags()
    if zones is not None:
        zones.invalidate()
    if topology is not None:
        topology.invalidate_all()
    if records is not None:
        records.invalidate_all()


def adoption_hooks() -> tuple[Callable[[], None], Callable[[], None]]:
    """``(on_adopt, on_reshard)`` for a command-line Manager: both drop
    the read plane (``invalidate_read_plane``), except that the resync
    which follows an adoption keeps what the adoption dropped and a
    load since has re-read: that load read after the adoption, and
    dropping it would re-read every accelerator's tags once more."""
    adopted = threading.Event()

    def adoption() -> None:
        adopted.set()
        invalidate_read_plane()

    def resync() -> None:
        if adopted.is_set():
            adopted.clear()
            return
        invalidate_read_plane()

    return adoption, resync


def read_plane_stats() -> dict:
    """Efficacy counters of every live cache (hits / misses /
    single-flight waits / batch sizes) — the observability hook the
    bench exports per phase."""
    stats = {}
    with _lock:
        named = {
            "discovery": _discovery_cache,
            "zones": _zone_cache,
            "topology": _topology_cache,
            "record_sets": _record_cache,
        }
        coalescers = dict(_lb_coalescers)
    for name, cache in named.items():
        if cache is not None:
            stats[name] = cache.stats()
    for region, coalescer in coalescers.items():
        stats[f"load_balancers[{region}]"] = coalescer.stats()
    return stats


def _guarded_handles(ga, elbv2, route53, region: str):
    """Wrap the three service handles in the health plane's guards
    (circuit gate + AIMD pacing + outcome classification); pass-through
    when the plane is disabled.  GA and Route53 are global endpoints —
    one circuit each; ELBv2 is regional — one circuit per region."""
    tracker = shared_health_tracker()
    if tracker is None:
        return ga, elbv2, route53
    return (
        tracker.guard(ga, "globalaccelerator", GA_OPS),
        tracker.guard(elbv2, f"elbv2[{region}]", ELBV2_OPS),
        tracker.guard(route53, "route53", ROUTE53_OPS),
    )


def _driver_timing() -> dict:
    """Driver pacing knobs, env-overridable: production keeps the
    reference's constants (10 s settle poll / 180 s budget, 30 s
    LB-not-active requeue, 60 s accelerator-missing requeue); the
    fake-backed drills and demos shrink them so convergence is
    observable in seconds."""
    from .driver import ACCELERATOR_MISSING_RETRY, LB_NOT_ACTIVE_RETRY

    return dict(
        poll_interval=_env_float("AGAC_POLL_INTERVAL", 10.0),
        poll_timeout=_env_float("AGAC_POLL_TIMEOUT", 180.0),
        lb_not_active_retry=_env_float(
            "AGAC_LB_NOT_ACTIVE_RETRY", LB_NOT_ACTIVE_RETRY
        ),
        accelerator_missing_retry=_env_float(
            "AGAC_ACCELERATOR_MISSING_RETRY", ACCELERATOR_MISSING_RETRY
        ),
    )


def real_cloud_factory(region: str) -> AWSDriver:
    caches = dict(
        discovery_cache=_shared_discovery_cache(),
        zone_cache=_shared_zone_cache(),
        topology_cache=_shared_topology_cache(),
        record_cache=_shared_record_cache(),
        lb_coalescer=_shared_lb_coalescer(region),
        settle_table=shared_settle_table(),
        change_batcher=shared_change_batcher(),
        stage_requeue=_chain_stage_requeue(),
        refresh_discovery_on_disable=True,
        **_driver_timing(),
    )
    # expose every live cache's hit/miss counters as collection-time
    # gauges on the global registry — the caches keep their
    # own counters, /metrics reads them through read_plane_stats
    obs_instruments.read_plane_instruments(obs_metrics.registry()).watch_stats(
        read_plane_stats
    )
    if os.environ.get("AGAC_CLOUD") == "fake":
        backend = shared_fake_backend()
        ga, elbv2, route53 = _guarded_handles(backend, backend, backend, region)
        return AWSDriver(ga, elbv2, route53, **caches)
    from .real_backend import RealAWSClients

    clients = RealAWSClients.from_environment(region)
    tracker = shared_health_tracker()
    if tracker is not None:
        # the in-client retry loop reports per-attempt throttle/5xx
        # classifications, so a brownout the 3-attempt retries keep
        # absorbing still drives the AIMD limiter down
        clients.ga.set_outcome_hook(tracker.service("globalaccelerator").record)
        clients.elbv2.set_outcome_hook(tracker.service(f"elbv2[{region}]").record)
        clients.route53.set_outcome_hook(tracker.service("route53").record)
    ga, elbv2, route53 = _guarded_handles(
        clients.ga, clients.elbv2, clients.route53, region
    )
    return AWSDriver(ga, elbv2, route53, **caches)
