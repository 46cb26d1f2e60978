"""The orphan garbage collector: crash-consistent
ownership from tagged ground truth.

The event-driven controllers are reactive only: a ``Service`` deleted
while the controller is down is a PERMANENT leak — the informer relist
never replays the delete (there is no tombstone for an object the
initial list simply doesn't contain), so the accelerator chain and its
Route53 records outlive their owner forever (the reactive-cleanup-only
gap documented at ``cloudprovider/aws/driver.py`` ``_list_related``).
This controller closes the loop from the OTHER side: the ownership
tags and TXT heritage values the drivers write into AWS are a durable
ownership database, so correctness is re-derivable after any crash by
cross-checking that database against the apiserver — Swift's
elastic-control-plane argument, and Arcturus' framing of overlay
stability as a control-loop property under component failure.

A sweep enumerates everything this cluster's controller owns (via the
coalesced read plane: the discovery snapshot for accelerators, the
zone/record-set snapshots for TXT heritage values), checks each
owner's Kubernetes object, and tears down confirmed orphans through
the drivers' existing teardown paths.  Deleting is the one operation
a controller can never take back, so the sweeper is fail-closed
behind hard rails:

- **no sweep before informers sync** — an empty cache is not an empty
  cluster;
- **no conclusions from a failed listing** — a sweep whose enumeration
  errored mutates no grace state and deletes nothing;
- **grace period** — an orphan must be observed in ``grace_sweeps``
  CONSECUTIVE sweeps before deletion; disappearing from one sweep
  resets its counter;
- **per-sweep deletion budget** — a mass-orphan event (or a bug)
  deletes at most ``max_deletes`` resources per sweep;
- **live ownership re-verify at the deletion point** — the teardown
  funnel re-reads tags from AWS (never a cache) and re-checks the
  apiserver immediately before deleting (enforced by the
  ``delete-without-ownership-check`` lint rule);
- **dry-run mode** — counts and logs would-be deletions without
  touching AWS (the recommended first rollout step);
- **circuit-aware** — a phase whose backing service circuit is open
  is skipped entirely: never GC on partial data.

An orphan whose owner REAPPEARS (a Service deleted and re-created
while pending) is *adopted*: dropped from the pending table and
counted, never deleted — the reconcile path repairs any drift.

With an ``OrphanTeardown`` wired (the command line does), a confirmed
orphan is not torn down inside the sweep: its owner is handed to
teardown workers, whose funnel verifies ownership live at the deletion
point, parks on the accelerator's settle wait in the pending-settle
table and resumes from it, as a delete event's teardown does.  An
owner whose teardown this process is already running is no candidate,
so the sweep never races the reactive path, and ``deleted`` counts
the owners it handed over.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass
from typing import Callable, Optional

from .. import klog
from ..cloudprovider.aws.driver import OWNER_TAG_KEY, accelerator_owner_tag_value
from ..errors import NotFoundError
from ..observability import instruments, recorder
from ..observability import profile as obs_profile
from ..observability import slo as obs_slo
from ..observability.metrics import MetricsRegistry
from ..sharding import OWNS_ALL
from ..sharding.reports import merge_shard_reports, store_shard_report
from ..reconcile import RateLimitingQueue, Result
from .common import CloudFactory, GLOBAL_REGION, run_workers, with_shard_guard

CONTROLLER_AGENT_NAME = "garbage-collector"

# the owner-tag resource kinds the sweeper knows how to cross-check;
# anything else is fail-closed (never deleted)
_KNOWN_RESOURCES = ("service", "ingress")


@dataclass
class GarbageCollectorConfig:
    # seconds between sweeps; 0 (default) disables the sweeper —
    # reference parity: orphans wait for a reactive event that will
    # never come
    interval: float = 0.0
    # consecutive sweeps an orphan must be observed before deletion
    grace_sweeps: int = 2
    # deletion budget per sweep (accelerators + record owners combined)
    max_deletes: int = 10
    # observe/log only, delete nothing — the recommended first rollout
    dry_run: bool = False
    cluster_name: str = "default"


def verify_accelerator_orphan_ownership(
    cloud, arn: str, cluster_name: str, owner: tuple[str, str, str],
    owner_exists: Callable[[str, str, str], bool],
) -> bool:
    """The accelerator-side ownership verify the deletion funnel must
    pass: the Kubernetes owner is still absent (apiserver is the
    authority — a re-created owner means adopt, not delete) AND the
    accelerator's LIVE tags still claim this cluster's ownership (a
    re-tagged or already-deleted accelerator is not ours to touch)."""
    resource, ns, name = owner
    if owner_exists(resource, ns, name):
        return False
    return cloud.verify_accelerator_orphan(
        arn, cluster_name, accelerator_owner_tag_value(resource, ns, name)
    )


def verify_record_orphan_ownership(
    owner: tuple[str, str, str],
    owner_exists: Callable[[str, str, str], bool],
) -> bool:
    """The record-side ownership verify: the owner object is still
    absent at the deletion point.  Record scoping itself is inherent —
    ``cleanup_record_set`` deletes only records whose TXT values match
    this exact cluster/resource/ns/name heritage value."""
    resource, ns, name = owner
    return not owner_exists(resource, ns, name)


TEARDOWN_QUEUE = f"{CONTROLLER_AGENT_NAME}-teardown"


class OrphanTeardown:
    """Where the sweeper's confirmed orphans are torn down, once one is
    wired (the command line wires it):

    - an accelerator owner goes to this queue, worked by ``workers``
      threads through the sweeper's own funnel (live ownership
      verify, then the AWS driver's teardown), so up to ``workers`` chains
      come down at once, and each parks on its accelerator's settle
      wait in the pending-settle table and resumes from it, as a
      delete event's teardown does;
    - a record owner goes to the Route53 controller's queue, whose
      delete reconcile removes its TXT and A records.

    ``controller_queues`` maps (kind, resource) to the queue of the
    controller that tears that kind of orphan down on a delete event;
    ``tearing_down`` names an owner this process is tearing down
    already, in one of those queues or in this one: queued, running,
    backing off or parked (``settle_table`` is a callable, bound after
    the controllers)."""

    def __init__(self, controller_queues: dict, settle_table: Callable[[], object], workers: int):
        self._controller_queues = controller_queues
        self._settle_table = settle_table
        self._workers = workers
        self.queue = RateLimitingQueue(name=TEARDOWN_QUEUE)

    def tearing_down(self, kind: str, owner: tuple[str, str, str]) -> bool:
        resource, ns, name = owner
        queued = [(self._controller_queues[(kind, resource)], f"{ns}/{name}")]
        if kind == "accelerators":
            queued.append((self.queue, "/".join(owner)))
        table = self._settle_table()
        parked = set(table.parked_keys()) if table is not None else set()
        return any(
            key in parked or queue.contains(key) or queue.delayed_peek(key) is not None
            for queue, key in queued
        )

    def hand_over(self, kind: str, owner: tuple[str, str, str]) -> None:
        resource, ns, name = owner
        if kind == "accelerators":
            self.queue.add("/".join(owner))
        else:
            self._controller_queues[(kind, resource)].add(f"{ns}/{name}")

    def start_workers(self, stop: threading.Event, key_to_obj, process_delete) -> None:
        run_workers(
            TEARDOWN_QUEUE, self.queue, workers=self._workers, stop=stop,
            key_to_obj=key_to_obj, process_delete=process_delete,
            # the owner came back: its controller's own reconcile adopts
            process_create_or_update=_owner_returned,
        )

    def stop_workers(self) -> None:
        self.queue.shutdown()


def _owner_returned(obj) -> Result:
    return Result()


class GarbageCollector:
    """Periodic orphan sweeper over ownership ground truth.

    Constructed by the manager when ``interval > 0``; ``sweep_once``
    is also driven explicitly by tests and the bench (the same pattern
    as ``Manager.drift_tick``)."""

    def __init__(
        self,
        informer_factory,
        config: GarbageCollectorConfig,
        cloud_factory: CloudFactory,
        health=None,
        registry: "MetricsRegistry | None" = None,
        shard_filter=None,
        teardown: Optional[OrphanTeardown] = None,
    ):
        self._config = config
        self._cloud = cloud_factory
        self._health = health
        # None: confirmed orphans are torn down inside the sweep
        self._teardown = teardown
        # sharding candidate partition: a sweeper only ever
        # considers orphans whose owner key its shards own — no replica
        # can sweep (or even grace-count) another shard's owners.
        # OWNS_ALL = the single-sweeper-per-cluster semantics.
        self._shards = shard_filter if shard_filter is not None else OWNS_ALL
        # the teardown workers' process functions, behind the shard guard
        self._guarded_teardowns = {
            resource: with_shard_guard(
                self._shards, functools.partial(self._tear_down_accelerators, resource)
            )
            for resource in (_KNOWN_RESOURCES if teardown is not None else ())
        }
        self._service_informer = informer_factory.informer("Service")
        self._ingress_informer = informer_factory.informer("Ingress")
        self._service_lister = self._service_informer.lister()
        self._ingress_lister = self._ingress_informer.lister()
        self._lock = threading.Lock()
        # grace state: candidate -> consecutive sweeps observed orphaned
        self._pending_accelerators: dict[str, int] = {}  # arn -> count
        self._pending_records: dict[tuple[str, str, str], int] = {}
        # cumulative totals live in the metrics registry —
        # status(), /healthz and /metrics all read the same children
        # instead of separately maintained ints.  registry=None keeps
        # a private registry (unit-tier isolation); the manager passes
        # its own (the process-global one in production).
        metrics = instruments.gc_instruments(
            registry if registry is not None else MetricsRegistry()
        )
        self._m_sweeps = metrics.sweeps
        self._m_deleted = {
            "accelerators": metrics.deleted.labels(kind="accelerators"),
            "records": metrics.deleted.labels(kind="records"),
        }
        self._m_adopted = metrics.adopted
        self._m_would_delete = metrics.would_delete
        self._m_pending = {
            "accelerators": metrics.pending.labels(kind="accelerators"),
            "records": metrics.pending.labels(kind="records"),
        }
        self._m_candidates = {
            "accelerators": metrics.last_candidates.labels(kind="accelerators"),
            "records": metrics.last_candidates.labels(kind="records"),
        }
        self._m_pending["accelerators"].set_function(
            lambda: len(self._pending_accelerators)
        )
        self._m_pending["records"].set_function(lambda: len(self._pending_records))
        # per-shard partial reports keyed by ownership token (the
        # single-owner-merge fix): a second sweeper's report lands in
        # its own slot instead of silently overwriting the first
        self.last_sweep_reports: dict[str, dict] = {}

    # ------------------------------------------------------------------
    # apiserver cross-check
    # ------------------------------------------------------------------
    def _synced(self) -> bool:
        return (
            self._service_informer.has_synced()
            and self._ingress_informer.has_synced()
        )

    def _owner_exists(self, resource: str, ns: str, name: str) -> bool:
        lister = {
            "service": self._service_lister,
            "ingress": self._ingress_lister,
        }.get(resource)
        if lister is None:
            # unknown resource kind in the owner tag: fail closed —
            # claim the owner exists so nothing is ever deleted
            return True
        try:
            lister.namespaced(ns).get(name)
            return True
        except NotFoundError:
            return False

    @staticmethod
    def _parse_owner_tag(value: str) -> Optional[tuple[str, str, str]]:
        parts = value.split("/")
        if len(parts) != 3 or not all(parts):
            return None
        if parts[0] not in _KNOWN_RESOURCES:
            return None
        return parts[0], parts[1], parts[2]

    def _circuit_open(self, service: str) -> bool:
        return self._health is not None and self._health.is_open(service)

    # ------------------------------------------------------------------
    # the sweep
    # ------------------------------------------------------------------
    def sweep_once(self) -> dict:
        """One full sweep; returns (and stores) its report.  All grace
        state mutations happen here, under the rails documented in the
        module docstring."""
        config = self._config
        if obs_slo.should_shed("gc-sweep"):
            # burn-rate shedding: while the convergence SLO
            # budget burns, the sweeper is the FIRST deferrable load to
            # go — orphans wait, user-facing convergence does not.  No
            # grace state moves (a shed sweep is a non-observation).
            klog.warningf("gc sweep: shed under SLO budget burn")
            return {"shed": True, "shards": self._shards.token()}
        report = {
            # the shard-ownership token this partial sweep covered
            # ("all" in single-shard mode)
            "shards": self._shards.token(),
            "dry_run": config.dry_run,
            "candidates": {"accelerators": 0, "records": 0},
            "grace_held": 0,
            "deleted": {"accelerators": 0, "records": 0},
            "adopted": 0,
            "would_delete": 0,
            "budget_deferred": 0,
            "skipped_circuit_open": [],
            "skipped_unsynced": False,
            "listing_failed": [],
        }
        if self._teardown is not None:
            # owners a controller was already tearing down
            report["in_teardown"] = 0
        self._m_sweeps.inc()
        report["sweep"] = int(self._m_sweeps.value())
        if not self._shards.owned_shards():
            # a sharded replica holding no leases owns no keyspace:
            # enumerating the fleet would spend quota to observe keys
            # it may not touch — and no grace state may move either
            report["skipped_no_shards"] = True
            self._store_report(report)
            return report
        if not self._synced():
            # an informer that has not listed yet makes EVERY owner
            # look absent — the one mistake this controller must never
            # make.  No grace state moves either: an unsynced sweep is
            # a non-observation.
            report["skipped_unsynced"] = True
            klog.warningf("gc sweep: informers not synced, skipping")
            self._store_report(report)
            return report
        cloud = self._cloud(GLOBAL_REGION)
        budget = [max(0, config.max_deletes)]  # shared across both phases
        self._sweep_accelerators(cloud, report, budget)
        self._sweep_records(cloud, report, budget)
        self._store_report(report)
        if report["deleted"]["accelerators"] or report["deleted"]["records"]:
            klog.infof(
                "gc sweep %d: deleted %d accelerators, %d record owners "
                "(candidates %r, grace-held %d)",
                report["sweep"], report["deleted"]["accelerators"],
                report["deleted"]["records"], report["candidates"],
                report["grace_held"],
            )
        return report

    def _store_report(self, report: dict) -> None:
        for kind in ("accelerators", "records"):
            self._m_deleted[kind].inc(report["deleted"][kind])
            self._m_candidates[kind].set(report["candidates"][kind])
        self._m_adopted.inc(report["adopted"])
        self._m_would_delete.inc(report["would_delete"])
        recorder.flight_recorder().record(
            "gc-sweep",
            shards=report.get("shards"),
            sweep=report.get("sweep"),
            deleted=dict(report["deleted"]),
            candidates=dict(report["candidates"]),
            adopted=report["adopted"],
            dry_run=report["dry_run"],
        )
        with self._lock:
            store_shard_report(self.last_sweep_reports, report)

    @property
    def last_sweep_report(self) -> dict:
        """The legacy single-report view: an additive merge over the
        per-shard partials (identical to the raw report while one
        sweeper covers the whole keyspace)."""
        with self._lock:
            return merge_shard_reports(self.last_sweep_reports)

    def _sweep_accelerators(self, cloud, report: dict, budget: list) -> None:
        if self._circuit_open("globalaccelerator"):
            # never GC on partial data: an open circuit means the
            # listing (or the deletion) would run against a degraded
            # service — grace state is left untouched
            report["skipped_circuit_open"].append("globalaccelerator")
            return
        try:
            pairs = cloud.list_cluster_owned_pairs(self._config.cluster_name)
        except Exception as err:
            # fail closed: a sweep that could not enumerate proves
            # nothing — no counts move, nothing is deleted
            report["listing_failed"].append("accelerators")
            klog.errorf("gc sweep: accelerator listing failed: %s", err)
            return
        next_pending: dict[str, int] = {}
        with self._lock:
            pending = dict(self._pending_accelerators)
        for accelerator, tags in pairs:
            arn = accelerator.accelerator_arn
            owner_raw = next(
                (t.value for t in tags if t.key == OWNER_TAG_KEY), ""
            )
            owner = self._parse_owner_tag(owner_raw)
            if owner is None:
                # unparseable/unknown owner tag: never a candidate
                klog.v(4).infof(
                    "gc sweep: %s has unparseable owner tag %r, skipping",
                    arn, owner_raw,
                )
                continue
            if not self._shards.owns(owner[1], owner[2]):
                # another shard's keyspace: not a candidate, and no
                # grace state moves — its own sweeper observes it
                continue
            if self._owner_exists(*owner):
                if arn in pending:
                    report["adopted"] += 1
                    klog.infof(
                        "gc sweep: owner %s/%s/%s reappeared, adopting %s",
                        *owner, arn,
                    )
                continue
            if self._teardown is not None and self._teardown.tearing_down("accelerators", owner):
                report["in_teardown"] += 1
                continue
            count = pending.get(arn, 0) + 1
            report["candidates"]["accelerators"] += 1
            if count < self._config.grace_sweeps:
                report["grace_held"] += 1
                next_pending[arn] = count
                continue
            if self._config.dry_run:
                report["would_delete"] += 1
                next_pending[arn] = count
                klog.infof(
                    "gc sweep (dry-run): would delete accelerator %s "
                    "(owner %s gone for %d sweeps)", arn, owner_raw, count,
                )
                continue
            if budget[0] <= 0:
                report["budget_deferred"] += 1
                next_pending[arn] = count
                continue
            if self._teardown is not None:
                # verified live at the deletion point, by the worker
                self._teardown.hand_over("accelerators", owner)
                report["deleted"]["accelerators"] += 1
                budget[0] -= 1
                continue
            try:
                if self._delete_accelerator_orphan(cloud, arn, owner):
                    report["deleted"]["accelerators"] += 1
                    budget[0] -= 1
                else:
                    # verification refused (owner raced back, tags
                    # changed, or already gone): drop the candidate
                    report["adopted"] += 1
            except Exception as err:
                klog.errorf("gc sweep: deleting %s failed: %s", arn, err)
                next_pending[arn] = count  # retried next sweep
        with self._lock:
            self._pending_accelerators = next_pending

    def _sweep_records(self, cloud, report: dict, budget: list) -> None:
        if self._circuit_open("route53"):
            report["skipped_circuit_open"].append("route53")
            return
        try:
            owners = cloud.list_owned_record_owners(self._config.cluster_name)
        except Exception as err:
            report["listing_failed"].append("records")
            klog.errorf("gc sweep: record listing failed: %s", err)
            return
        next_pending: dict[tuple[str, str, str], int] = {}
        with self._lock:
            pending = dict(self._pending_records)
        for owner in sorted(owners):
            if owner[0] not in _KNOWN_RESOURCES:
                continue  # fail closed on foreign resource kinds
            if not self._shards.owns(owner[1], owner[2]):
                continue  # another shard's keyspace (see accelerators)
            if self._owner_exists(*owner):
                if owner in pending:
                    report["adopted"] += 1
                continue
            if self._teardown is not None and self._teardown.tearing_down("records", owner):
                report["in_teardown"] += 1
                continue
            count = pending.get(owner, 0) + 1
            report["candidates"]["records"] += 1
            if count < self._config.grace_sweeps:
                report["grace_held"] += 1
                next_pending[owner] = count
                continue
            if self._config.dry_run:
                report["would_delete"] += 1
                next_pending[owner] = count
                klog.infof(
                    "gc sweep (dry-run): would delete records owned by %s/%s/%s",
                    *owner,
                )
                continue
            if budget[0] <= 0:
                report["budget_deferred"] += 1
                next_pending[owner] = count
                continue
            try:
                if self._delete_record_orphan(cloud, owner):
                    report["deleted"]["records"] += 1
                    budget[0] -= 1
                else:
                    report["adopted"] += 1
            except Exception as err:
                klog.errorf(
                    "gc sweep: deleting records of %s/%s/%s failed: %s",
                    *owner, err,
                )
                next_pending[owner] = count
        with self._lock:
            self._pending_records = next_pending

    # ------------------------------------------------------------------
    # the teardown funnels (delete-without-ownership-check lint rule:
    # every deletion below this line flows through an ownership verify)
    # ------------------------------------------------------------------
    def _delete_accelerator_orphan(
        self, cloud, arn: str, owner: tuple[str, str, str]
    ) -> bool:
        if not verify_accelerator_orphan_ownership(
            cloud, arn, self._config.cluster_name, owner, self._owner_exists
        ):
            return False
        cloud.cleanup_global_accelerator(arn)
        return True

    def _owner_object(self, key: str):
        """The teardown worker's owner lookup (``resource/ns/name``):
        NotFoundError sends the key down the delete path."""
        resource, ns, name = key.split("/", 2)
        lister = self._service_lister if resource == "service" else self._ingress_lister
        return lister.namespaced(ns).get(name)

    def _tear_down_owner(self, key: str) -> Result:
        """The teardown worker's process function: the owner's
        accelerators, as its tags name them, through the funnel below,
        behind the shard guard (a key the ring moved away is the new
        owner's to sweep).  A settle wait parks the key."""
        resource, _, namespaced = key.partition("/")
        return self._guarded_teardowns[resource](namespaced)

    def _tear_down_accelerators(self, resource: str, namespaced: str) -> Result:
        ns, name = namespaced.split("/", 1)
        owner = (resource, ns, name)
        cloud = self._cloud(GLOBAL_REGION)
        for accelerator in cloud.list_global_accelerator_by_resource(
            self._config.cluster_name, resource, ns, name
        ):
            self._delete_accelerator_orphan(cloud, accelerator.accelerator_arn, owner)
        return Result()

    def _delete_record_orphan(self, cloud, owner: tuple[str, str, str]) -> bool:
        if not verify_record_orphan_ownership(owner, self._owner_exists):
            return False
        if self._teardown is not None:
            self._teardown.hand_over("records", owner)
            return True
        resource, ns, name = owner
        cloud.cleanup_record_set(self._config.cluster_name, resource, ns, name)
        return True

    # ------------------------------------------------------------------
    # lifecycle + observability
    # ------------------------------------------------------------------
    def run(self, stop: threading.Event) -> None:
        klog.infof(
            "Starting garbage collector (interval %.1fs, grace %d sweeps, "
            "budget %d/sweep%s)",
            self._config.interval, self._config.grace_sweeps,
            self._config.max_deletes,
            ", DRY-RUN" if self._config.dry_run else "",
        )
        if self._teardown is not None:
            self._teardown.start_workers(stop, self._owner_object, self._tear_down_owner)
        while not stop.wait(self._config.interval):
            try:
                # stage accountant: the threaded loop's
                # sweeps are attributed like the explicit
                # Manager.gc_sweep path
                with obs_profile.stage("gc-sweep"):
                    self.sweep_once()
            except Exception as err:  # a bad sweep must not kill the loop
                klog.errorf("gc sweep failed: %s", err)
        if self._teardown is not None:
            self._teardown.stop_workers()
        klog.info("Shutting down garbage collector")

    def status(self) -> dict:
        """The /healthz + bench payload: config, cumulative totals,
        pending (grace-held) queue depths, and the last sweep's full
        counter set.  Totals are read FROM the registry children (the
        single source /metrics also renders).  ``last_sweep`` is the
        merged view over per-shard partials; ``per_shard`` carries the
        raw partial reports keyed by ownership token."""
        with self._lock:
            per_shard = {
                token: dict(report)
                for token, report in self.last_sweep_reports.items()
            }
        last_sweep = merge_shard_reports(per_shard)
        return {
            "shards": self._shards.token(),
            "per_shard": per_shard,
            "enabled": True,
            "dry_run": self._config.dry_run,
            "interval": self._config.interval,
            "grace_sweeps": self._config.grace_sweeps,
            "max_deletes": self._config.max_deletes,
            "sweeps_total": int(self._m_sweeps.value()),
            "deleted_total": int(
                sum(child.value() for child in self._m_deleted.values())
            ),
            "adopted_total": int(self._m_adopted.value()),
            "pending": {
                "accelerators": int(self._m_pending["accelerators"].value()),
                "records": int(self._m_pending["records"].value()),
            },
            "last_sweep": last_sweep,
        }
