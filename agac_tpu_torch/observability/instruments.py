"""Every metric the stack exposes, declared in one place.

Instrumented modules (workqueue, reconcile loop, driver, health plane,
GC, informers, leader election) obtain their metrics through the
accessor functions below instead of declaring names inline, so:

- the metric CATALOG (docs/operations.md, regenerated by
  ``python -m agac_tpu_torch.observability.catalog`` / ``make
  metrics-catalog``) is built by calling ``register_all()`` on a fresh
  registry — it structurally cannot drift from the instrumented code;
- names, types, label sets and help strings are reviewable in one
  file;
- the ``unregistered-metric`` lint rule has one sanctioned pattern to
  bless (``registry.counter(...)`` with literal names/labels).

Accessors are get-or-create against the given registry (default: the
process-global one), so calling them per-constructed-object is cheap.
"""

from __future__ import annotations

from typing import Callable, Optional

from .. import clockseam

from . import metrics as metrics_mod
from . import trace
from .metrics import MetricsRegistry

# reconcile/workqueue latencies live between milliseconds (cache-hit
# sync) and minutes (settle polls, deep backoffs)
_DURATION_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0, 180.0,
)
# AWS control-plane calls: sub-ms fakes up to tens of seconds of
# retry/pacing on the real wire
_CALL_BUCKETS = (
    0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0,
)


def _reg(registry: Optional[MetricsRegistry]) -> MetricsRegistry:
    return registry if registry is not None else metrics_mod.registry()


# ---------------------------------------------------------------------------
# workqueue (the controller-runtime standard set)
# ---------------------------------------------------------------------------


class WorkqueueInstruments:
    def __init__(self, registry: Optional[MetricsRegistry] = None):
        reg = _reg(registry)
        self.depth = reg.gauge(
            "agac_workqueue_depth",
            "Items currently queued (not being processed) per workqueue",
            labels=("name",),
        )
        self.adds = reg.counter(
            "agac_workqueue_adds_total",
            "Items added to the workqueue (dedup-coalesced adds count once)",
            labels=("name",),
        )
        self.retries = reg.counter(
            "agac_workqueue_retries_total",
            "Rate-limited re-adds (failed syncs and requeue=True results)",
            labels=("name",),
        )
        self.queue_duration = reg.histogram(
            "agac_workqueue_queue_duration_seconds",
            "Seconds an item waited in the queue before a worker picked it up",
            labels=("name",),
            buckets=_DURATION_BUCKETS,
        )
        self.work_duration = reg.histogram(
            "agac_workqueue_work_duration_seconds",
            "Seconds an item was held by a worker (get to done)",
            labels=("name",),
            buckets=_DURATION_BUCKETS,
        )


def workqueue_instruments(registry: Optional[MetricsRegistry] = None) -> WorkqueueInstruments:
    return WorkqueueInstruments(registry)


# ---------------------------------------------------------------------------
# reconcile loop
# ---------------------------------------------------------------------------

RESULT_SUCCESS = "success"
RESULT_REQUEUE = "requeue"
RESULT_REQUEUE_AFTER = "requeue-after"
RESULT_ERROR = "error"
RESULT_PERMANENT_ERROR = "permanent-error"
# the item reached an AWS wait state and was parked in the
# pending-settle table — neither success nor failure
RESULT_PARKED = "parked"
# the popped key belongs to another replica's shards (the
# residue across a resize drain/handoff or a lease steal) — forgotten
# without work, journey untouched
RESULT_SKIPPED = "skipped"


class ReconcileInstruments:
    def __init__(self, registry: Optional[MetricsRegistry] = None):
        reg = _reg(registry)
        self.results = reg.counter(
            "agac_reconcile_results_total",
            "Completed sync passes by retry-policy outcome "
            "(success / requeue / requeue-after / error / permanent-error)",
            labels=("controller", "result"),
        )
        self.duration = reg.histogram(
            "agac_reconcile_duration_seconds",
            "Wall-clock seconds per sync pass, per controller",
            labels=("controller",),
            buckets=_DURATION_BUCKETS,
        )
        self.deadline_exceeded = reg.counter(
            "agac_reconcile_deadline_exceeded_total",
            "Sync passes cut by the per-item reconcile deadline (health plane)",
            labels=("controller",),
        )
        self.traces_sampled = reg.counter(
            "agac_traces_sampled_total",
            "Reconcile traces sampled and emitted as structured log lines",
            labels=("controller",),
        )


def reconcile_instruments(registry: Optional[MetricsRegistry] = None) -> ReconcileInstruments:
    return ReconcileInstruments(registry)


# ---------------------------------------------------------------------------
# AWS API calls (driver-level: every call, guarded or not)
# ---------------------------------------------------------------------------


class AWSCallInstruments:
    def __init__(self, registry: Optional[MetricsRegistry] = None):
        reg = _reg(registry)
        self.calls = reg.counter(
            "agac_aws_api_calls_total",
            "AWS API calls by service, operation and outcome (success or the "
            "service error code)",
            labels=("service", "op", "outcome"),
        )
        self.duration = reg.histogram(
            "agac_aws_api_call_duration_seconds",
            "AWS API call latency per service and operation, including "
            "health-plane pacing and in-client retries",
            labels=("service", "op"),
            buckets=_CALL_BUCKETS,
        )


def aws_call_instruments(registry: Optional[MetricsRegistry] = None) -> AWSCallInstruments:
    return AWSCallInstruments(registry)


def _profile_mod():
    """Late-bound ``observability.profile`` accessor: profile.py
    imports this module at top level for its instruments, so the stage
    bracket below must resolve the reverse edge lazily."""
    global _profile
    if _profile is None:
        from . import profile as _p

        _profile = _p
    return _profile


_profile = None


def _capture_mod():
    """Late-bound incident-capture seam: ``sim.capture``
    builds its instruments from this module, so the reverse edge — the
    driver hook recording every classified call outcome into the
    active capture — resolves lazily."""
    global _capture
    if _capture is None:
        from ..sim import capture as _c

        _capture = _c
    return _capture


_capture = None


class InstrumentedAPI:
    """The driver hook: proxies a service handle, timing every API
    call into the call histogram/counter, charging its CPU to an
    ``aws:{service}.{op}`` profile stage (a child of the
    reconcile loop's ``driver-mutate`` stage, so per-op cost splits
    out of the process func's exclusive time), and attaching an
    AWS-call span to the current reconcile trace.  Layered INSIDE the
    health guard (the guard's pacing wait is part of the latency a
    reconcile actually pays, so it belongs in the measurement).
    Non-API attributes pass through untouched."""

    def __init__(
        self,
        inner,
        service: str,
        ops: frozenset[str],
        registry: Optional[MetricsRegistry] = None,
        clock: Callable[[], float] = clockseam.monotonic,
    ):
        self._inner = inner
        self._service = service
        self._ops = ops
        self._clock = clock
        self._instruments = aws_call_instruments(registry)
        self._children: dict[str, tuple] = {}

    def _bind(self, op: str) -> tuple:
        bound = self._children.get(op)
        if bound is None:
            bound = (
                self._instruments.duration.labels(service=self._service, op=op),
                op,
            )
            self._children[op] = bound
        return bound

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name not in self._ops or not callable(attr):
            return attr
        duration_child, op = self._bind(name)
        calls = self._instruments.calls
        service = self._service
        clock = self._clock

        def observed(*args, **kwargs):
            start = clock()
            outcome = "success"
            result = None
            error: Optional[BaseException] = None
            try:
                with _profile_mod().api_stage(service, op):
                    result = attr(*args, **kwargs)
                    return result
            except Exception as err:
                # the service error code is the outcome label; the
                # registry's cardinality cap bounds hostile code sets
                outcome = getattr(err, "code", None) or type(err).__name__
                error = err
                raise
            except BaseException as err:
                # crash boundaries (the fault plan's SimulatedCrash)
                # keep the legacy outcome label but must still reach
                # the capture tap — a crash IS an external input the
                # incident replay has to reproduce
                error = err
                raise
            finally:
                end = clock()
                duration_child.observe(end - start)
                calls.labels(service=service, op=op, outcome=outcome).inc()
                trace.record_call(service, op, start, end, outcome)
                tap = _capture_mod().active()
                if tap is not None:
                    tap.record_aws_call(
                        service,
                        op,
                        (
                            "success"
                            if error is None
                            else getattr(error, "code", None) or type(error).__name__
                        ),
                        args=args,
                        kwargs=kwargs,
                        result=result,
                        error=error,
                        duration=end - start,
                    )

        return observed


def instrument_api(
    inner,
    service: str,
    ops: frozenset[str],
    registry: Optional[MetricsRegistry] = None,
) -> InstrumentedAPI:
    return InstrumentedAPI(inner, service, ops, registry=registry)


# ---------------------------------------------------------------------------
# API health plane (circuit breakers + AIMD)
# ---------------------------------------------------------------------------

_CIRCUIT_STATE_VALUES = {"closed": 0.0, "half-open": 1.0, "open": 2.0}


class HealthInstruments:
    def __init__(self, registry: Optional[MetricsRegistry] = None):
        reg = _reg(registry)
        self.outcomes = reg.counter(
            "agac_service_outcomes_total",
            "Health-plane outcome classifications per service (includes "
            "per-retry-attempt classifications from the real backend)",
            labels=("service", "outcome"),
        )
        self.circuit_state = reg.gauge(
            "agac_circuit_state",
            "Circuit breaker state per service: 0 closed, 1 half-open, 2 open",
            labels=("service",),
        )
        self.circuit_opened = reg.gauge(
            "agac_circuit_opened_total",
            "Times the service circuit tripped open (cumulative)",
            labels=("service",),
        )
        self.circuit_rejected = reg.gauge(
            "agac_circuit_rejected_total",
            "Calls shed without touching the wire while the circuit was open",
            labels=("service",),
        )
        self.aimd_qps = reg.gauge(
            "agac_aimd_qps",
            "Live AIMD-adapted call rate per service (None/absent when pacing "
            "is disabled)",
            labels=("service",),
        )

    def watch_service(self, service_health) -> None:
        """Register collection-time views over one ServiceHealth: the
        breaker and limiter keep the numbers, the registry reads
        them — no copied state to drift."""
        name = service_health.name
        breaker = service_health.breaker
        self.circuit_state.labels(service=name).set_function(
            lambda: _CIRCUIT_STATE_VALUES.get(breaker.state(), -1.0)
        )
        self.circuit_opened.labels(service=name).set_function(
            lambda: breaker.opened_total
        )
        self.circuit_rejected.labels(service=name).set_function(
            lambda: breaker.rejected_total
        )
        if service_health.limiter is not None:
            self.aimd_qps.labels(service=name).set_function(
                service_health.limiter.rate
            )


def health_instruments(registry: Optional[MetricsRegistry] = None) -> HealthInstruments:
    return HealthInstruments(registry)


# ---------------------------------------------------------------------------
# read plane (cache efficacy as collection-time views over stats())
# ---------------------------------------------------------------------------


class ReadPlaneInstruments:
    def __init__(self, registry: Optional[MetricsRegistry] = None):
        reg = _reg(registry)
        self.hits = reg.gauge(
            "agac_read_plane_hits",
            "Cumulative cache hits per read-plane cache (collection-time view "
            "over the cache's own counters)",
            labels=("cache",),
        )
        self.misses = reg.gauge(
            "agac_read_plane_misses",
            "Cumulative cache misses (loader dispatches) per read-plane cache",
            labels=("cache",),
        )

    def watch_stats(self, stats_fn: Callable[[], dict]) -> None:
        """Bind hit/miss views for every cache named by ``stats_fn``
        (the factory's ``read_plane_stats``).  Caches appear lazily, so
        the binding re-runs per collection via per-cache closures over
        the stats function."""

        def bind(cache_name: str, field: str) -> Callable[[], float]:
            def read() -> float:
                return float(stats_fn().get(cache_name, {}).get(field, 0))

            return read

        for cache_name in stats_fn():
            self.hits.labels(cache=cache_name).set_function(bind(cache_name, "hits"))
            self.misses.labels(cache=cache_name).set_function(bind(cache_name, "misses"))


def read_plane_instruments(registry: Optional[MetricsRegistry] = None) -> ReadPlaneInstruments:
    return ReadPlaneInstruments(registry)


# ---------------------------------------------------------------------------
# async mutation pipeline (pending-settle table + Route53 change batcher)
# ---------------------------------------------------------------------------

# multi-change ChangeResourceRecordSets batches: 2 changes per
# single-item submission (the TXT+A pair) up to the API's 1,000 cap
_BATCH_SIZE_BUCKETS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 250.0, 1000.0)


class PipelineInstruments:
    def __init__(self, registry: Optional[MetricsRegistry] = None):
        reg = _reg(registry)
        self.pending_depth = reg.gauge(
            "agac_pending_settle_depth",
            "Reconcile items currently parked in the pending-settle table "
            "(waiting on an AWS settle / batch commit / cross-controller "
            "dependency) instead of holding a worker",
            labels=("table",),
        )
        self.pending_oldest_age = reg.gauge(
            "agac_pending_settle_oldest_age_seconds",
            "Age of the oldest parked item — staleness signal the depth "
            "gauge alone cannot carry",
            labels=("table",),
        )
        self.pending_parked = reg.counter(
            "agac_pending_settle_parked_total",
            "Items parked in the pending-settle table, by wait group",
            labels=("group",),
        )
        self.pending_resolved = reg.counter(
            "agac_pending_settle_resolved_total",
            "Parked items whose wait resolved and were requeued, by group "
            "and outcome (ready / failed; expiries count as failed)",
            labels=("group", "outcome"),
        )
        self.batch_changes = reg.histogram(
            "agac_r53_batch_changes",
            "Changes per committed ChangeResourceRecordSets wire call "
            "through the per-zone change batcher",
            buckets=_BATCH_SIZE_BUCKETS,
        )
        self.batch_flushes = reg.counter(
            "agac_r53_batch_flushes_total",
            "Change-batcher flushes by reason: linger (gather window "
            "elapsed), full (max batch size reached), split (a multi-item "
            "batch degraded to per-item commits after InvalidChangeBatch)",
            labels=("reason",),
        )


def pipeline_instruments(registry: Optional[MetricsRegistry] = None) -> PipelineInstruments:
    return PipelineInstruments(registry)


# ---------------------------------------------------------------------------
# garbage collector
# ---------------------------------------------------------------------------


class GCInstruments:
    def __init__(self, registry: Optional[MetricsRegistry] = None):
        reg = _reg(registry)
        self.sweeps = reg.counter(
            "agac_gc_sweeps_total", "Orphan-GC sweeps started"
        )
        self.deleted = reg.counter(
            "agac_gc_deleted_total",
            "Confirmed orphans torn down, by resource kind",
            labels=("kind",),
        )
        self.adopted = reg.counter(
            "agac_gc_adopted_total",
            "Candidates dropped because their owner reappeared or the "
            "pre-deletion verify refused",
        )
        self.would_delete = reg.counter(
            "agac_gc_would_delete_total",
            "Dry-run deletions that WOULD have happened (watch this through a "
            "dry-run rollout)",
        )
        self.pending = reg.gauge(
            "agac_gc_pending",
            "Grace-held orphan candidates awaiting consecutive-sweep "
            "confirmation, by resource kind",
            labels=("kind",),
        )
        self.last_candidates = reg.gauge(
            "agac_gc_last_sweep_candidates",
            "Orphan candidates observed by the most recent sweep, by kind",
            labels=("kind",),
        )


def gc_instruments(registry: Optional[MetricsRegistry] = None) -> GCInstruments:
    return GCInstruments(registry)


# ---------------------------------------------------------------------------
# informers + leader election
# ---------------------------------------------------------------------------


class InformerInstruments:
    def __init__(self, registry: Optional[MetricsRegistry] = None):
        reg = _reg(registry)
        self.resync_age = reg.gauge(
            "agac_informer_resync_age_seconds",
            "Seconds since the informer's last successful relist (resync lag; "
            "-1 before the first list completes)",
            labels=("kind",),
        )
        self.items = reg.gauge(
            "agac_informer_items",
            "Objects currently in the informer's store, per kind",
            labels=("kind",),
        )
        self.listwatch_errors = reg.counter(
            "agac_informer_listwatch_errors_total",
            "List/watch cycles that failed and backed off, per kind",
            labels=("kind",),
        )


def informer_instruments(registry: Optional[MetricsRegistry] = None) -> InformerInstruments:
    return InformerInstruments(registry)


class LeaderElectionInstruments:
    def __init__(self, registry: Optional[MetricsRegistry] = None):
        reg = _reg(registry)
        self.is_leader = reg.gauge(
            "agac_leader_is_leader",
            "1 while this process holds the leader lease, else 0",
            labels=("name",),
        )
        self.transitions = reg.counter(
            "agac_leader_transitions_total",
            "Leadership takeovers this process performed (lease acquired from "
            "a different or expired holder)",
            labels=("name",),
        )


def leaderelection_instruments(
    registry: Optional[MetricsRegistry] = None,
) -> LeaderElectionInstruments:
    return LeaderElectionInstruments(registry)


# ---------------------------------------------------------------------------
# sharding plane (per-shard leases + keyspace partition)
# ---------------------------------------------------------------------------


class ShardingInstruments:
    def __init__(self, registry: Optional[MetricsRegistry] = None):
        reg = _reg(registry)
        self.lease_held = reg.gauge(
            "agac_shard_lease_held",
            "1 while this replica holds the shard's lease, else 0 (one "
            "series per shard index)",
            labels=("shard",),
        )
        self.map_version = reg.gauge(
            "agac_shard_map_version",
            "Monotonic version of the shard map this replica has observed "
            "(bumps whenever any shard's observed holder changes)",
        )
        self.steals = reg.counter(
            "agac_shard_lease_steals_total",
            "Shard leases this replica took over from an EXPIRED holder "
            "(failover adoptions; first claims of unheld leases not counted)",
        )
        self.rebalances = reg.counter(
            "agac_shard_rebalances_total",
            "Membership ticks on which this replica's owned-shard set "
            "changed (quota re-divided, adopted keys re-enqueued)",
        )
        self.keys_owned = reg.gauge(
            "agac_shard_keys_owned",
            "Managed reconcile keys (Services + Ingresses) currently owned "
            "by this replica's shards (collection-time view over the "
            "informer caches)",
        )
        # elastic resharding
        self.ring_shards = reg.gauge(
            "agac_shard_ring_shards",
            "Shard count of the LIVE hash ring this replica partitions "
            "under (follows the ring lease; moves on a completed resize)",
        )
        self.resize_state = reg.gauge(
            "agac_shard_resize_state",
            "Resize transition state of this replica: 0 stable, 1 draining "
            "(this replica still holds undrained donor shards), 2 adopting "
            "(drains done, gainer handoffs pending)",
        )
        self.resize_epoch = reg.gauge(
            "agac_shard_resize_epoch",
            "Resize epoch observed on the ring lease (bumps per "
            "resize-shards request; stable between resizes)",
        )
        self.handoff_pending = reg.gauge(
            "agac_shard_handoff_pending",
            "Gainer shards of the in-flight resize that have not yet acked "
            "their handoff (0 while stable — the resize-completion signal)",
        )
        self.resizes = reg.counter(
            "agac_shard_resizes_total",
            "Ring transitions this replica completed (drain/handoff "
            "protocol ran to the flip)",
        )


def sharding_instruments(registry: Optional[MetricsRegistry] = None) -> ShardingInstruments:
    return ShardingInstruments(registry)


# ---------------------------------------------------------------------------
# convergence SLO plane (object journeys + burn-rate engine)
# ---------------------------------------------------------------------------

# end-to-end spec→converged latency: sub-second cache-hit no-ops up to
# the deep tail (settle chains, brownouts, failover adoptions).  The
# 60/120/300 bounds are ALSO the SLO thresholds — the engine counts
# "good" journeys straight off these cumulative buckets, so objective
# thresholds must stay aligned with a bucket bound.
JOURNEY_BUCKETS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 20.0, 30.0, 60.0, 120.0,
    300.0, 600.0, 1800.0, 3600.0,
)


class JourneyInstruments:
    def __init__(self, registry: Optional[MetricsRegistry] = None):
        reg = _reg(registry)
        self.converge = reg.histogram(
            "agac_journey_converge_seconds",
            "End-to-end object-journey latency: first enqueue of a spec "
            "generation to the verified converged (or deleted) pass, per "
            "controller queue; trigger = what opened the journey (spec edit, "
            "drift resync, shard-handoff adoption, resize re-home)",
            labels=("controller", "trigger"),
            buckets=JOURNEY_BUCKETS,
        )
        self.stages = reg.counter(
            "agac_journey_stages_total",
            "Journey lifecycle stamps by stage (enqueued / attempt / "
            "requeued / parked / settle outcomes / handoff / converged / "
            "deleted) — stage flow as a rate, not only as latency",
            labels=("controller", "stage"),
        )
        self.inflight = reg.gauge(
            "agac_journey_inflight",
            "Journeys currently open (enqueued but not yet verified "
            "converged/deleted), per controller queue",
            labels=("controller",),
        )
        self.oldest_age = reg.gauge(
            "agac_journey_oldest_unconverged_age_seconds",
            "Age of the oldest unconverged journey per controller queue — "
            "the single-wedged-object signal the inflight depth hides",
            labels=("controller",),
        )


def journey_instruments(registry: Optional[MetricsRegistry] = None) -> JourneyInstruments:
    return JourneyInstruments(registry)


class SLOInstruments:
    def __init__(self, registry: Optional[MetricsRegistry] = None):
        reg = _reg(registry)
        self.burn_rate = reg.gauge(
            "agac_slo_burn_rate",
            "Error-budget burn rate per objective and window: 1.0 burns the "
            "budget exactly at the sustainable rate, >1 exhausts it early",
            labels=("objective", "window"),
        )
        self.p99 = reg.gauge(
            "agac_slo_p99_seconds",
            "Estimated p-quantile (the objective's percentile) of the "
            "objective's journey-latency histogram, interpolated from "
            "cumulative buckets",
            labels=("objective",),
        )
        self.healthy = reg.gauge(
            "agac_slo_healthy",
            "1 while the objective's cumulative good fraction meets its "
            "target, else 0 (0 with no observations yet counts as healthy)",
            labels=("objective",),
        )
        self.shedding = reg.gauge(
            "agac_slo_shedding",
            "1 while sustained budget burn has the engine shedding "
            "deferrable load (GC sweeps, drift resync pacing), else 0",
        )
        self.sheds = reg.counter(
            "agac_slo_sheds_total",
            "Deferrable work skipped under burn-rate shedding, by action "
            "(gc-sweep / drift-tick / drift-resync)",
            labels=("action",),
        )
        self.evaluations = reg.counter(
            "agac_slo_evaluations_total",
            "SLO engine evaluation ticks (burn windows advance only when "
            "this moves)",
        )


def slo_instruments(registry: Optional[MetricsRegistry] = None) -> SLOInstruments:
    return SLOInstruments(registry)


# ---------------------------------------------------------------------------
# SLO-driven shard autoscaler
# ---------------------------------------------------------------------------


class AutoscalerInstruments:
    def __init__(self, registry: Optional[MetricsRegistry] = None):
        reg = _reg(registry)
        self.target_shards = reg.gauge(
            "agac_autoscaler_target_shards",
            "Shard count the autoscaler currently wants (follows executed "
            "decisions; in observe-only mode this is the recommendation it "
            "WOULD have executed)",
        )
        self.decisions = reg.counter(
            "agac_autoscaler_decisions_total",
            "Autoscaler evaluation verdicts by action (scale-out / scale-in "
            "/ hold) and the evidence reason that drove them (burn / "
            "age-growth / headroom / steady)",
            labels=("action", "reason"),
        )
        self.suppressed = reg.counter(
            "agac_autoscaler_suppressed_total",
            "Scale decisions a hard rail refused to execute, by rail "
            "(disabled / transition-in-progress / cooldown-out / cooldown-in "
            "/ at-max / at-min / observe-only / execute-error)",
            labels=("rail",),
        )


def autoscaler_instruments(
    registry: Optional[MetricsRegistry] = None,
) -> AutoscalerInstruments:
    return AutoscalerInstruments(registry)


# ---------------------------------------------------------------------------
# continuous profiling plane (stage accountant)
# ---------------------------------------------------------------------------

# per-stage exclusive time: microseconds of bookkeeping up through
# multi-second driver/settle stages
_STAGE_BUCKETS = (
    1e-6, 5e-6, 1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1,
    0.5, 1.0, 5.0,
)


class ProfileInstruments:
    def __init__(self, registry: Optional[MetricsRegistry] = None):
        reg = _reg(registry)
        self.stage_cpu = reg.histogram(
            "agac_profile_stage_cpu_seconds",
            "Exclusive per-stage thread-CPU seconds from the stage "
            "accountant (queue-pop / shard-filter / informer-lookup / "
            "serialize / driver-mutate / settle-park / self-tax / "
            "drift-tick / gc-sweep / r53-batch-flush, plus dynamic "
            "aws:{service}.{op} call stages); child-stage time is "
            "subtracted, so stages sum to the measured total",
            labels=("stage", "controller"),
            buckets=_STAGE_BUCKETS,
        )
        self.stage_wall = reg.histogram(
            "agac_profile_stage_wall_seconds",
            "Exclusive per-stage wall-clock seconds from the stage "
            "accountant — read next to the CPU series: a stage with "
            "wall >> cpu is waiting, one with wall ~= cpu is compute-bound",
            labels=("stage", "controller"),
            buckets=_STAGE_BUCKETS,
        )
        self.cpu_wall_ratio = reg.gauge(
            "agac_profile_reconcile_cpu_wall_ratio",
            "CPU/wall ratio of the most recent reconcile per controller: "
            "~1 means the worker is compute-bound (the single-core wall), "
            "~0 means it spends its life waiting on AWS/settles",
            labels=("controller",),
        )
        self.reconciles = reg.counter(
            "agac_profile_reconciles_total",
            "Reconcile scopes the stage accountant closed (denominator "
            "for per-reconcile stage-cost rates)",
            labels=("controller",),
        )


def profile_instruments(registry: Optional[MetricsRegistry] = None) -> ProfileInstruments:
    return ProfileInstruments(registry)


class ExplainInstruments:
    def __init__(self, registry: Optional[MetricsRegistry] = None):
        reg = _reg(registry)
        self.blocked = reg.gauge(
            "agac_explain_blocked",
            "Unconverged managed objects by blocked-on verdict from the "
            "explain plane (in-flight / parked-settle / circuit-open / "
            "quota-paced / backoff / shed / unowned-resize / not-owner / "
            "informer-unsynced) — the fleet-merged blocked-on histogram "
            "dashboards read next to the journey backlog",
            labels=("reason",),
        )
        self.queries = reg.counter(
            "agac_explain_queries_total",
            "Explain lookups served, by surface (debug-endpoint / cli / "
            "post-mortem)",
            labels=("surface",),
        )


def explain_instruments(registry: Optional[MetricsRegistry] = None) -> ExplainInstruments:
    return ExplainInstruments(registry)


class CaptureInstruments:
    """Incident capture & replay."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        reg = _reg(registry)
        self.events = reg.counter(
            "agac_capture_events_total",
            "External-input events recorded into the incident capture, by "
            "event kind (aws / informer / lease / signal / clock / control "
            "/ cluster)",
            labels=("kind",),
        )
        self.drops = reg.counter(
            "agac_capture_dropped_total",
            "Capture events dropped because serialization or the ring "
            "write failed (the tap is contained: a drop never fails the "
            "path it observes)",
        )
        self.rotations = reg.counter(
            "agac_capture_ring_rotations_total",
            "Incident-capture ring segment rotations (size or age cap "
            "reached; the previous rotation is evicted)",
        )
        self.last_serial = reg.gauge(
            "agac_capture_last_serial",
            "Serial of the most recently recorded capture event — the "
            "replay cursor a post-mortem names",
        )


def capture_instruments(registry: Optional[MetricsRegistry] = None) -> CaptureInstruments:
    return CaptureInstruments(registry)


# ---------------------------------------------------------------------------
# catalog support
# ---------------------------------------------------------------------------


def register_all(registry: Optional[MetricsRegistry] = None) -> MetricsRegistry:
    """Force-register every instrument family (the catalog generator's
    entry point: a fresh registry in, the full metric set out)."""
    reg = _reg(registry)
    workqueue_instruments(reg)
    reconcile_instruments(reg)
    aws_call_instruments(reg)
    health_instruments(reg)
    read_plane_instruments(reg)
    pipeline_instruments(reg)
    gc_instruments(reg)
    informer_instruments(reg)
    leaderelection_instruments(reg)
    sharding_instruments(reg)
    journey_instruments(reg)
    slo_instruments(reg)
    autoscaler_instruments(reg)
    profile_instruments(reg)
    explain_instruments(reg)
    capture_instruments(reg)
    return reg


# ---------------------------------------------------------------------------
# port-only instruments: wall time where the port waits, outside
# ``register_all`` (so the generated catalog stays the reference's);
# README.md documents them ("Port-only instruments")
# ---------------------------------------------------------------------------


def read_plane_load_seconds(registry: Optional[MetricsRegistry] = None) -> metrics_mod.Metric:
    reg = _reg(registry)
    return reg.histogram(
        "agac_read_plane_load_seconds",
        "Wall seconds of each single-flight read-plane load (the leader's "
        "loader call: a discovery snapshot's pages and tag reads, a zone "
        "list, a chain relist or verify, a zone's record sets), per cache",
        labels=("cache",),
        buckets=_CALL_BUCKETS,
    )


def read_plane_wait_seconds(registry: Optional[MetricsRegistry] = None) -> metrics_mod.Metric:
    reg = _reg(registry)
    return reg.histogram(
        "agac_read_plane_wait_seconds",
        "Wall seconds a caller stayed parked behind another caller's "
        "single-flight read-plane load, per cache",
        labels=("cache",),
        buckets=_CALL_BUCKETS,
    )


def pending_settle_wait_seconds(registry: Optional[MetricsRegistry] = None) -> metrics_mod.Metric:
    reg = _reg(registry)
    return reg.histogram(
        "agac_pending_settle_wait_seconds",
        "Seconds an item stayed parked in the pending-settle table, from "
        "park to leaving it, by wait group and outcome (ready / failed / "
        "expired when it resolves, replaced by a re-park, discarded when "
        "dropped unresolved)",
        labels=("group", "outcome"),
        buckets=_DURATION_BUCKETS,
    )


def apiserver_request_duration_seconds(registry: Optional[MetricsRegistry] = None) -> metrics_mod.Metric:
    reg = _reg(registry)
    return reg.histogram(
        "agac_apiserver_request_duration_seconds",
        "Wall seconds of each request to the Kubernetes API server on the "
        "wire, by verb (the HTTP method, WATCH for a stream, timed to its "
        "response headers) and status class (2xx / 4xx / 5xx, error when "
        "no response came); a retried 401 counts twice",
        labels=("verb", "code"),
        buckets=_CALL_BUCKETS,
    )


def fake_aws_lock_seconds(registry: Optional[MetricsRegistry] = None) -> metrics_mod.Metric:
    reg = _reg(registry)
    return reg.histogram(
        "agac_fake_aws_lock_seconds",
        "The durable fake AWS account's interprocess lock: seconds waited "
        "for it (wait) and held (held), per outermost acquisition; "
        "registered only by a process that builds the file-backed fake",
        labels=("phase",),
        buckets=_CALL_BUCKETS,
    )


def drift_ticks_total(registry: Optional[MetricsRegistry] = None) -> metrics_mod.Metric:
    reg = _reg(registry)
    return reg.counter(
        "agac_drift_ticks_total",
        "Ticks of a controller's in-process drift-resync ticker, by "
        "outcome: ran, or shed under SLO budget burn",
        labels=("controller", "outcome"),
    )


def drift_tick_keys_total(registry: Optional[MetricsRegistry] = None) -> metrics_mod.Metric:
    reg = _reg(registry)
    return reg.counter(
        "agac_drift_tick_keys_total",
        "Keys a controller's in-process drift-resync ticks enqueued",
        labels=("controller",),
    )


def drift_tick_drain_seconds(registry: Optional[MetricsRegistry] = None) -> metrics_mod.Metric:
    reg = _reg(registry)
    return reg.histogram(
        "agac_drift_tick_drain_seconds",
        "Wall seconds from a drift-resync tick's start until every key it "
        "enqueued has finished a reconcile begun after the enqueue; "
        "observed once per tick, per controller",
        labels=("controller",),
        buckets=_DURATION_BUCKETS,
    )


def binding_weight_sync_total(registry: Optional[MetricsRegistry] = None) -> metrics_mod.Metric:
    reg = _reg(registry)
    return reg.counter(
        "agac_binding_weight_sync_total",
        "Endpoints an EndpointGroupBinding's weight sync visited, by "
        "outcome: written, or skipped where the state the pass already "
        "held (the add's response or its describe) showed the spec's "
        "weight and the pass applied no edit of the binding's spec",
        labels=("outcome",),
    )


def chain_create_reads_skipped_total(
    registry: Optional[MetricsRegistry] = None,
) -> metrics_mod.Metric:
    reg = _reg(registry)
    return reg.counter(
        "agac_chain_create_reads_skipped_total",
        "Chain reads a staged create did without: a verify of the chain "
        "this process is creating, answered from what it wrote since its "
        "CreateAccelerator, by the stage it resumed: listener "
        "(ListListeners) or endpoint_group (ListEndpointGroups)",
        labels=("stage",),
    )


# (family name, the accessor that registers it)
PORT_ONLY: tuple[tuple[str, Callable[[Optional[MetricsRegistry]], metrics_mod.Metric]], ...] = (
    ("agac_read_plane_load_seconds", read_plane_load_seconds),
    ("agac_read_plane_wait_seconds", read_plane_wait_seconds),
    ("agac_pending_settle_wait_seconds", pending_settle_wait_seconds),
    ("agac_apiserver_request_duration_seconds", apiserver_request_duration_seconds),
    ("agac_fake_aws_lock_seconds", fake_aws_lock_seconds),
    ("agac_drift_ticks_total", drift_ticks_total),
    ("agac_drift_tick_keys_total", drift_tick_keys_total),
    ("agac_drift_tick_drain_seconds", drift_tick_drain_seconds),
    ("agac_binding_weight_sync_total", binding_weight_sync_total),
    ("agac_chain_create_reads_skipped_total", chain_create_reads_skipped_total),
)
