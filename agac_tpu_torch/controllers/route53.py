"""The Route53 controller.

Capability parity with the reference's ``pkg/controller/route53/``
(467 LoC): watches Services and Ingresses carrying the
``route53-hostname`` annotation (comma-separated hostnames, wildcards
allowed), ensures a TXT-ownership record plus an A-alias record to the
managed accelerator per hostname, and cleans up by scanning all hosted
zones on delete or annotation removal.

Cross-controller coupling is via AWS state only: the accelerator is
discovered through its tags and the reconcile requeues every minute
until the GlobalAccelerator controller has converged
(reference ``pkg/cloudprovider/aws/route53.go:63-77``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

from .. import apis, klog
from ..cloudprovider import detect_cloud_provider
from ..cluster import ClusterClient, EventRecorder, SharedInformerFactory
from ..cluster.objects import meta_namespace_key, split_meta_namespace_key
from ..errors import no_retry_errorf
from ..reconcile import RateLimitingQueue, Result, controller_rate_limiter
from ..sharding import OWNS_ALL
from ..observability import journey as obs_journey
from .common import (
    CloudFactory,
    GLOBAL_REGION,
    annotation_changed,
    default_cloud_factory,
    has_annotation,
    lb_name_region_or_warn,
    make_sync_error_warner,
    run_workers,
    with_shard_guard,
    stamp_journey_enqueued,
    start_drift_resync,
    unwrap_tombstone,
    was_load_balancer_service,
)

CONTROLLER_AGENT_NAME = "route53-controller"


def is_hostname_managed_service(svc) -> bool:
    """The single managed-Service predicate — shared by the informer
    add handler and the drift-resync ticker so the two can never
    diverge."""
    return was_load_balancer_service(svc) and has_annotation(
        svc, apis.ROUTE53_HOSTNAME_ANNOTATION
    )


def is_hostname_managed_ingress(ingress) -> bool:
    return has_annotation(ingress, apis.ROUTE53_HOSTNAME_ANNOTATION)


@dataclass
class Route53Config:
    workers: int = 1
    cluster_name: str = "default"
    queue_qps: float = 10.0
    queue_burst: int = 100
    # per-item exponential backoff cap (client-go default 1000 s)
    queue_max_backoff: float = 1000.0
    # see GlobalAcceleratorConfig.drift_resync_period; 0 = reference parity
    drift_resync_period: float = 0.0
    # see GlobalAcceleratorConfig.reconcile_deadline; 0 = disabled
    reconcile_deadline: float = 0.0


class Route53Controller:
    # the accelerator is discovered through GA tags, the records live
    # in Route53 — drift ticks for this controller need both healthy
    DRIFT_SERVICES = ("route53", "globalaccelerator")

    def __init__(
        self,
        client: ClusterClient,
        informer_factory: SharedInformerFactory,
        config: Route53Config,
        cloud_factory: Optional[CloudFactory] = None,
        shard_filter=None,
    ):
        self.cluster_name = config.cluster_name
        # sharding ownership predicate; OWNS_ALL = the
        # single-shard semantics every pre-sharding tier runs under
        self._shards = shard_filter if shard_filter is not None else OWNS_ALL
        self._workers = config.workers
        self._drift_resync_period = config.drift_resync_period
        self._reconcile_deadline = config.reconcile_deadline
        self._cloud = cloud_factory or default_cloud_factory
        self.recorder = EventRecorder(client, CONTROLLER_AGENT_NAME)
        self.service_queue = RateLimitingQueue(
            controller_rate_limiter(
                config.queue_qps, config.queue_burst, config.queue_max_backoff
            ),
            name=f"{CONTROLLER_AGENT_NAME}-service",
        )
        self.ingress_queue = RateLimitingQueue(
            controller_rate_limiter(
                config.queue_qps, config.queue_burst, config.queue_max_backoff
            ),
            name=f"{CONTROLLER_AGENT_NAME}-ingress",
        )

        service_informer = informer_factory.informer("Service")
        self.service_lister = service_informer.lister()
        service_informer.add_event_handler(
            on_add=self._add_service_notification,
            on_update=self._update_service_notification,
            on_delete=self._delete_service_notification,
        )
        ingress_informer = informer_factory.informer("Ingress")
        self.ingress_lister = ingress_informer.lister()
        ingress_informer.add_event_handler(
            on_add=self._add_ingress_notification,
            on_update=self._update_ingress_notification,
            on_delete=self._delete_ingress_notification,
        )
        self._informer_factory = informer_factory
        # "resource/ns/name" keys whose owned records a cleanup already
        # removed: a PERSISTENTLY absent/blank hostname annotation must
        # not rescan every hosted zone on each re-enqueue (r2 advisor).
        # Plain set, no lock: add/discard/contains are atomic under the
        # GIL and the worst race costs one redundant scan.
        self._cleaned_up: set[str] = set()

    # ------------------------------------------------------------------
    # event handlers (reference ``route53/controller.go:89-170``)
    # ------------------------------------------------------------------
    def _add_service_notification(self, svc) -> None:
        # structural gate, NOT the hostname annotation: ADD events
        # replay on informer sync (boot, leadership, shard adoption) —
        # the level-triggered recovery edge for an annotation removal
        # or delete consumed while the key was unowned.  A namesake
        # re-created WITHOUT the annotation must still get one cleanup
        # reconcile (memoized by ``_cleaned_up``), or its old records
        # leak forever: GC never sweeps records whose owner object
        # exists.  Only annotated objects open a user-facing journey —
        # a cleanup-recovery check is not a convergence anyone waits on.
        if was_load_balancer_service(svc):
            self._enqueue(
                self.service_queue, svc,
                journey=is_hostname_managed_service(svc),
            )

    def _update_service_notification(self, old, new) -> None:
        if old == new:
            return
        if was_load_balancer_service(new):
            if has_annotation(new, apis.ROUTE53_HOSTNAME_ANNOTATION) or annotation_changed(
                old, new, apis.ROUTE53_HOSTNAME_ANNOTATION
            ):
                self._enqueue(self.service_queue, new)

    def _delete_service_notification(self, obj) -> None:
        svc = unwrap_tombstone(obj)
        if svc is None:
            return
        if was_load_balancer_service(svc):
            self._enqueue(self.service_queue, svc)

    def _add_ingress_notification(self, ingress) -> None:
        # the reference gates ingress adds on the hostname annotation
        # only (``route53/controller.go:131-136``); the gate here is
        # wider still — ANY ingress add, matching the delete handler —
        # so a cleanup consumed while the key was unowned is recovered
        # by the informer-sync ADD replay (see
        # _add_service_notification)
        self._enqueue(
            self.ingress_queue, ingress,
            journey=is_hostname_managed_ingress(ingress),
        )

    def _update_ingress_notification(self, old, new) -> None:
        if old == new:
            return
        if has_annotation(new, apis.ROUTE53_HOSTNAME_ANNOTATION) or annotation_changed(
            old, new, apis.ROUTE53_HOSTNAME_ANNOTATION
        ):
            self._enqueue(self.ingress_queue, new)

    def _delete_ingress_notification(self, obj) -> None:
        ingress = unwrap_tombstone(obj)
        if ingress is None:
            return
        self._enqueue(self.ingress_queue, ingress)

    def _enqueue(
        self, queue: RateLimitingQueue, obj, journey: bool = True
    ) -> None:
        key = meta_namespace_key(obj)
        if not self._shards.owns_key(key):
            return  # another shard's replica reconciles this key
        if journey:
            stamp_journey_enqueued(queue.name, obj)
        queue.add_rate_limited(key, reason="in-flight")

    def _resync_enqueue(
        self, queue: RateLimitingQueue, obj, trigger: str,
        journey: bool = True,
    ) -> None:
        """Drift/handoff re-enqueue: journey-stamped, then the plain
        dedup add (the client-go resync pattern).  ``journey=False``
        for cleanup-recovery enqueues of unannotated objects."""
        if journey:
            stamp_journey_enqueued(queue.name, obj, trigger=trigger)
        queue.add(meta_namespace_key(obj))

    def drift_resync_sources(
        self, trigger: str = obs_journey.TRIGGER_DRIFT
    ) -> list:
        """The canonical ``[(lister, predicate, enqueue), ...]`` drift
        re-enqueue wiring — consumed by the in-process ticker and by
        external single-tick drivers (the bench's drift-tick
        measurement), so the two can never diverge.  ``trigger``
        labels the journeys these enqueues open."""
        owns = self._shards.owns_obj  # shard-aware: foreign keys never tick
        if trigger == obs_journey.TRIGGER_DRIFT:
            svc_pred, ing_pred = (
                is_hostname_managed_service,
                is_hostname_managed_ingress,
            )
        else:
            # handoff/resize adoptions widen to every candidate object:
            # a hostname annotation REMOVED while the key was unowned
            # still has records to clean up (the cleanup reconcile of an
            # unannotated object is cheap and `_cleaned_up`-memoized)
            svc_pred = was_load_balancer_service
            ing_pred = lambda ing: True  # noqa: E731 — symmetric shape
        return [
            (
                self.service_lister,
                lambda svc: svc_pred(svc) and owns(svc),
                lambda svc: self._resync_enqueue(
                    self.service_queue, svc, trigger,
                    journey=is_hostname_managed_service(svc),
                ),
            ),
            (
                self.ingress_lister,
                lambda ing: ing_pred(ing) and owns(ing),
                lambda ing: self._resync_enqueue(
                    self.ingress_queue, ing, trigger,
                    journey=is_hostname_managed_ingress(ing),
                ),
            ),
        ]

    def worker_specs(self) -> list[dict]:
        """The canonical worker wiring (see the GlobalAccelerator
        controller's docstring) — shared by run() and the sim
        harness."""
        return [
            dict(
                name=f"{CONTROLLER_AGENT_NAME}-service",
                queue=self.service_queue,
                key_to_obj=self._key_to_service,
                # pop-time ownership re-check: residue of a
                # resize drain or lease steal is skipped, not worked
                process_delete=with_shard_guard(
                    self._shards, self.process_service_delete
                ),
                process_create_or_update=with_shard_guard(
                    self._shards, self.process_service_create_or_update
                ),
                on_sync_result=make_sync_error_warner(
                    self.recorder, self._key_to_service
                ),
                reconcile_deadline=self._reconcile_deadline,
                # explain plane: the not-managed predicate
                managed=is_hostname_managed_service,
            ),
            dict(
                name=f"{CONTROLLER_AGENT_NAME}-ingress",
                queue=self.ingress_queue,
                key_to_obj=self._key_to_ingress,
                process_delete=with_shard_guard(
                    self._shards, self.process_ingress_delete
                ),
                process_create_or_update=with_shard_guard(
                    self._shards, self.process_ingress_create_or_update
                ),
                on_sync_result=make_sync_error_warner(
                    self.recorder, self._key_to_ingress
                ),
                reconcile_deadline=self._reconcile_deadline,
                managed=is_hostname_managed_ingress,
            ),
        ]

    # ------------------------------------------------------------------
    # run loop
    # ------------------------------------------------------------------
    def run(self, stop: threading.Event) -> None:
        klog.info("Starting Route53 controller")
        klog.info("Waiting for informer caches to sync")
        if not self._informer_factory.wait_for_cache_sync(stop):
            raise RuntimeError("failed to wait for caches to sync")
        klog.info("Starting workers")
        for spec in self.worker_specs():
            run_workers(workers=self._workers, stop=stop, **spec)
        klog.info("Started workers")
        # plain dedup add, not add_rate_limited — see the
        # GlobalAccelerator controller's resync comment
        start_drift_resync(
            CONTROLLER_AGENT_NAME, stop, self._drift_resync_period,
            self.drift_resync_sources(),
        )
        stop.wait()
        klog.info("Shutting down workers")
        self.service_queue.shutdown()
        self.ingress_queue.shutdown()
        self.recorder.shutdown()

    def _key_to_service(self, key: str):
        ns, name = split_meta_namespace_key(key)
        return self.service_lister.namespaced(ns).get(name)

    def _key_to_ingress(self, key: str):
        ns, name = split_meta_namespace_key(key)
        return self.ingress_lister.namespaced(ns).get(name)

    # ------------------------------------------------------------------
    # process funcs (reference ``route53/service.go`` / ``ingress.go``)
    # ------------------------------------------------------------------
    def process_service_delete(self, key: str) -> Result:
        return self._process_delete(key, "service")

    def process_ingress_delete(self, key: str) -> Result:
        return self._process_delete(key, "ingress")

    def _process_delete(self, key: str, resource: str) -> Result:
        klog.infof("%s has been deleted", key)
        ns, name = split_meta_namespace_key(key)
        cloud = self._cloud(GLOBAL_REGION)
        cloud.cleanup_record_set(self.cluster_name, resource, ns, name)
        # the object is gone: a future namesake must get a fresh scan
        self._cleaned_up.discard(f"{resource}/{ns}/{name}")
        return Result()

    def process_service_create_or_update(self, svc) -> Result:
        if getattr(svc, "KIND", None) != "Service":
            raise no_retry_errorf("object is not Service, it is %s", type(svc).__name__)
        return self._process_create_or_update(
            svc, "service", svc.status.load_balancer.ingress, "Service"
        )

    def process_ingress_create_or_update(self, ingress) -> Result:
        if getattr(ingress, "KIND", None) != "Ingress":
            raise no_retry_errorf(
                "object is not Ingress, it is %s", type(ingress).__name__
            )
        return self._process_create_or_update(
            ingress, "ingress", ingress.status.load_balancer.ingress, "Ingress"
        )

    def _process_create_or_update(self, obj, resource: str, lb_ingresses, kind: str) -> Result:
        ns, name = obj.metadata.namespace, obj.metadata.name
        cleanup_key = f"{resource}/{ns}/{name}"
        hostname_annotation = obj.metadata.annotations.get(apis.ROUTE53_HOSTNAME_ANNOTATION)
        if hostname_annotation is None:
            if cleanup_key in self._cleaned_up:
                # already cleaned for this persistent no-annotation
                # state — don't rescan all zones on every re-enqueue
                return Result()
            cloud = self._cloud(GLOBAL_REGION)
            cloud.cleanup_record_set(self.cluster_name, resource, ns, name)
            self._cleaned_up.add(cleanup_key)
            klog.infof("Delete route53 records for %s %s/%s", kind, ns, name)
            self.recorder.event(
                obj, "Normal", "Route53RecordDeleted", "Route53 record sets are deleted"
            )
            return Result()

        # An empty or all-whitespace annotation value is treated like
        # annotation REMOVAL (clean up owned records — a user blanking
        # the value means the same as deleting the key), plus a Warning
        # so the likely mistake is visible.  The reference passes
        # ``[""]`` through and the reconcile spins on GetHostedZone("")
        # forever with no telemetry.
        hostnames = [h.strip() for h in hostname_annotation.split(",") if h.strip()]
        if not hostnames:
            if cleanup_key in self._cleaned_up:
                return Result()
            cloud = self._cloud(GLOBAL_REGION)
            cloud.cleanup_record_set(self.cluster_name, resource, ns, name)
            self._cleaned_up.add(cleanup_key)
            self.recorder.eventf(
                obj, "Warning", "InvalidAnnotation",
                "annotation %s is empty: expected comma-separated hostnames; "
                "owned Route53 records were cleaned up",
                apis.ROUTE53_HOSTNAME_ANNOTATION,
            )
            return Result()
        # records are being (re)created: the next blanking/removal must
        # clean up again
        self._cleaned_up.discard(cleanup_key)
        for lb_ingress in lb_ingresses:
            try:
                provider = detect_cloud_provider(lb_ingress.hostname)
            except ValueError as err:
                klog.error(err)
                continue
            if provider != "aws":
                klog.warningf("Not implemented for %s", provider)
                continue
            parsed = lb_name_region_or_warn(self.recorder, obj, lb_ingress.hostname)
            if parsed is None:
                continue
            _, region = parsed
            cloud = self._cloud(region)
            if resource == "service":
                created, retry_after = cloud.ensure_route53_for_service(
                    obj, lb_ingress, hostnames, self.cluster_name
                )
            else:
                created, retry_after = cloud.ensure_route53_for_ingress(
                    obj, lb_ingress, hostnames, self.cluster_name
                )
            if retry_after > 0:
                # waiting on the GlobalAccelerator chain (or a change
                # batch) to converge — forward progress, not backoff
                return Result(requeue=True, requeue_after=retry_after,
                              reason="in-flight")
            if created:
                self.recorder.eventf(
                    obj,
                    "Normal",
                    "Route53RecordCreated",
                    "Route53 record set is created: %s",
                    hostnames,
                )
        return Result()
