"""The GlobalAccelerator controller.

Capability parity with the reference's
``pkg/controller/globalaccelerator/`` (515 LoC): watches Services and
Ingresses, filters on the LoadBalancer/ALB predicates plus the managed
annotation (including annotation *removal*, which must enqueue so the
accelerator gets cleaned up), and reconciles each object into an
accelerator → listener → endpoint-group chain via the AWS driver.

Two independent rate-limited queues (service/ingress) as in the
reference (``controller.go:64-65``); events
``GlobalAcceleratorCreated`` / ``GlobalAcceleratorDeleted``
(``service.go:82,117``); 30 s requeue while the LB is not Active.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

from .. import apis, klog
from ..cloudprovider import detect_cloud_provider
from ..cluster import ClusterClient, EventRecorder, SharedInformerFactory
from ..cluster.objects import split_meta_namespace_key, meta_namespace_key
from ..errors import no_retry_errorf
from ..observability import journey as obs_journey
from ..reconcile import RateLimitingQueue, Result, controller_rate_limiter
from ..sharding import OWNS_ALL
from .common import (
    CloudFactory,
    GLOBAL_REGION,
    annotation_changed,
    default_cloud_factory,
    has_annotation,
    lb_name_region_or_warn,
    make_sync_error_warner,
    run_workers,
    stamp_journey_enqueued,
    start_drift_resync,
    with_shard_guard,
    unwrap_tombstone,
    was_alb_ingress,
    was_load_balancer_service,
)

CONTROLLER_AGENT_NAME = "global-accelerator-controller"


def is_managed_service(svc) -> bool:
    """The single managed-Service predicate — shared by the informer
    add handler and the drift-resync ticker so the two can never
    diverge."""
    return was_load_balancer_service(svc) and has_annotation(
        svc, apis.AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION
    )


def is_managed_ingress(ingress) -> bool:
    return was_alb_ingress(ingress) and has_annotation(
        ingress, apis.AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION
    )


@dataclass
class GlobalAcceleratorConfig:
    workers: int = 1
    cluster_name: str = "default"
    # overall enqueue token bucket (client-go default 10 qps / 100
    # burst); raise for large fleets — per-item backoff is unaffected
    queue_qps: float = 10.0
    queue_burst: int = 100
    # per-item exponential backoff cap (client-go default 1000 s)
    queue_max_backoff: float = 1000.0
    # re-enqueue every managed object each N seconds so AWS-side
    # drift is repaired without a Kubernetes edit; 0 (default) =
    # reference parity: equal resync updates are skipped and
    # out-of-band drift waits for an object change
    drift_resync_period: float = 0.0
    # per-item reconcile deadline (seconds) armed by the worker loop:
    # settle polls and backend retry backoffs consult it and raise the
    # retryable DeadlineExceeded instead of wedging the worker (API
    # health plane); 0 (default) disables
    reconcile_deadline: float = 0.0


class GlobalAcceleratorController:
    # the AWS services this controller's reconciles/verify reads hit —
    # the manager's drift tick skips this controller (tick marked
    # partial) while any of their circuits is open
    DRIFT_SERVICES = ("globalaccelerator", "elbv2")

    def __init__(
        self,
        client: ClusterClient,
        informer_factory: SharedInformerFactory,
        config: GlobalAcceleratorConfig,
        cloud_factory: Optional[CloudFactory] = None,
        shard_filter=None,
    ):
        self.cluster_name = config.cluster_name
        # the sharding plane's ownership predicate: every
        # enqueue funnel and drift source consults it, so a sharded
        # replica only ever works keys its shard leases own.  Default
        # OWNS_ALL = single-shard semantics.
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

    # ------------------------------------------------------------------
    # event handlers (reference ``controller.go:91-173``)
    # ------------------------------------------------------------------
    def _add_service_notification(self, svc) -> None:
        # structural gate, NOT the managed annotation: ADD events are
        # what replay on informer sync (boot, leadership, shard
        # adoption), so they are the level-triggered recovery edge for
        # a delete/unmanage consumed while the key was unowned — a
        # namesake re-created WITHOUT the annotation must still get
        # one cleanup reconcile, or its old chain leaks forever (GC
        # never touches resources whose owner object exists).  Only
        # managed objects open a user-facing journey — the recovery
        # check is not a convergence anyone waits on.
        if was_load_balancer_service(svc):
            klog.v(4).infof(
                "Service %s/%s is created", svc.metadata.namespace, svc.metadata.name
            )
            self._enqueue(
                self.service_queue, svc, journey=is_managed_service(svc)
            )

    def _update_service_notification(self, old, new) -> None:
        if old == new:
            return
        if was_load_balancer_service(new):
            if has_annotation(
                new, apis.AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION
            ) or annotation_changed(
                old, new, apis.AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION
            ):
                klog.v(4).infof(
                    "Service %s/%s is updated",
                    new.metadata.namespace,
                    new.metadata.name,
                )
                self._enqueue(self.service_queue, new)

    def _delete_service_notification(self, obj) -> None:
        svc = unwrap_tombstone(obj)
        if svc is None:
            return
        if was_load_balancer_service(svc):
            klog.v(4).infof(
                "Deleting Service %s/%s", svc.metadata.namespace, svc.metadata.name
            )
            self._enqueue(self.service_queue, svc)

    def _add_ingress_notification(self, ingress) -> None:
        # structural gate (see _add_service_notification): recovery of
        # cleanups consumed while the key was unowned
        if was_alb_ingress(ingress):
            klog.v(4).infof(
                "Ingress %s/%s is created",
                ingress.metadata.namespace,
                ingress.metadata.name,
            )
            self._enqueue(
                self.ingress_queue, ingress, journey=is_managed_ingress(ingress)
            )

    def _update_ingress_notification(self, old, new) -> None:
        if old == new:
            return
        if was_alb_ingress(new):
            if has_annotation(
                new, apis.AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION
            ) or annotation_changed(
                old, new, apis.AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION
            ):
                klog.v(4).infof(
                    "Ingress %s/%s is updated",
                    new.metadata.namespace,
                    new.metadata.name,
                )
                self._enqueue(self.ingress_queue, new)

    def _delete_ingress_notification(self, obj) -> None:
        ingress = unwrap_tombstone(obj)
        if ingress is None:
            return
        klog.v(4).infof(
            "Deleting Ingress %s/%s",
            ingress.metadata.namespace,
            ingress.metadata.name,
        )
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
        """Drift/handoff re-enqueue: journey-stamped with its trigger,
        then the plain dedup add (NOT add_rate_limited — the client-go
        resync pattern; see the run() comment).  ``journey=False`` for
        cleanup-recovery enqueues of unmanaged objects — not a
        convergence anyone waits on."""
        if journey:
            stamp_journey_enqueued(queue.name, obj, trigger=trigger)
        queue.add(meta_namespace_key(obj))

    # ------------------------------------------------------------------
    # run loop (reference ``controller.go:195-229``)
    # ------------------------------------------------------------------
    def run(self, stop: threading.Event) -> None:
        klog.info("Starting GlobalAccelerator controller")
        klog.info("Waiting for informer caches to sync")
        if not self._informer_factory.wait_for_cache_sync(stop):
            raise RuntimeError("failed to wait for caches to sync")
        klog.info("Starting workers")
        for spec in self.worker_specs():
            run_workers(workers=self._workers, stop=stop, **spec)
        klog.info("Started workers")
        # resync ticks use the plain dedup add, NOT add_rate_limited:
        # the client-go resync pattern.  Metered adds would drain the
        # shared enqueue bucket (starving event-driven reconciles on
        # large fleets) and bump per-item failure counts of items
        # mid-retry-backoff.
        start_drift_resync(
            CONTROLLER_AGENT_NAME, stop, self._drift_resync_period,
            self.drift_resync_sources(),
        )
        stop.wait()
        klog.info("Shutting down workers")
        self.service_queue.shutdown()
        self.ingress_queue.shutdown()
        self.recorder.shutdown()

    def worker_specs(self) -> list[dict]:
        """The canonical worker wiring — (queue, key resolver, process
        funcs, sync-result hook, deadline) per queue.  Consumed by the
        threaded ``run`` loop above AND stepped cooperatively by the
        sim harness, so the two runtimes reconcile through
        identical plumbing."""
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
                # explain plane: is this cached object one
                # the controller manages at all?
                managed=is_managed_service,
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
                managed=is_managed_ingress,
            ),
        ]

    def drift_resync_sources(
        self, trigger: str = obs_journey.TRIGGER_DRIFT
    ) -> list:
        """The canonical ``[(lister, predicate, enqueue), ...]`` drift
        re-enqueue wiring — consumed by the in-process ticker
        (``start_drift_resync``) and by external single-tick drivers
        (the bench's drift-tick measurement), so the two can never
        diverge.  ``trigger`` labels the journeys these enqueues open
        (drift ticks vs. the manager's shard-handoff resync)."""
        owns = self._shards.owns_obj  # shard-aware: foreign keys never tick
        if trigger == obs_journey.TRIGGER_DRIFT:
            svc_pred, ing_pred = is_managed_service, is_managed_ingress
        else:
            # handoff/resize adoptions are level-triggered RECOVERY: a
            # managed annotation REMOVED while the key was unowned (its
            # event consumed by a dead replica, or landing in the
            # drain→adopt gap) still has AWS state to tear down, so the
            # net widens to every object that could carry a chain — an
            # unmanaged one reconciles to a cheap cleanup check
            svc_pred, ing_pred = was_load_balancer_service, was_alb_ingress
        return [
            (
                self.service_lister,
                lambda svc: svc_pred(svc) and owns(svc),
                lambda svc: self._resync_enqueue(
                    self.service_queue, svc, trigger,
                    journey=is_managed_service(svc),
                ),
            ),
            (
                self.ingress_lister,
                lambda ing: ing_pred(ing) and owns(ing),
                lambda ing: self._resync_enqueue(
                    self.ingress_queue, ing, trigger,
                    journey=is_managed_ingress(ing),
                ),
            ),
        ]

    def _key_to_service(self, key: str):
        ns, name = split_meta_namespace_key(key)
        return self.service_lister.namespaced(ns).get(name)

    def _key_to_ingress(self, key: str):
        ns, name = split_meta_namespace_key(key)
        return self.ingress_lister.namespaced(ns).get(name)

    # ------------------------------------------------------------------
    # process funcs (reference ``service.go`` / ``ingress.go``)
    # ------------------------------------------------------------------
    def process_service_delete(self, key: str) -> Result:
        return self._process_delete(key, "service")

    def process_ingress_delete(self, key: str) -> Result:
        return self._process_delete(key, "ingress")

    def _process_delete(self, key: str, resource: str) -> Result:
        klog.infof("%s has been deleted", key)
        ns, name = split_meta_namespace_key(key)
        cloud = self._cloud(GLOBAL_REGION)
        for accelerator in cloud.list_global_accelerator_by_resource(
            self.cluster_name, resource, ns, name
        ):
            cloud.cleanup_global_accelerator(accelerator.accelerator_arn)
        return Result()

    def process_service_create_or_update(self, svc) -> Result:
        if getattr(svc, "KIND", None) != "Service":
            raise no_retry_errorf("object is not Service, it is %s", type(svc).__name__)
        return self._process_create_or_update(svc, "service", "Service")

    def process_ingress_create_or_update(self, ingress) -> Result:
        if getattr(ingress, "KIND", None) != "Ingress":
            raise no_retry_errorf(
                "object is not Ingress, it is %s", type(ingress).__name__
            )
        return self._process_create_or_update(ingress, "ingress", "Ingress")

    def _process_create_or_update(self, obj, resource: str, kind: str) -> Result:
        ns, name = obj.metadata.namespace, obj.metadata.name
        if not obj.status.load_balancer.ingress:
            klog.warningf("%s/%s does not have ingress LoadBalancer, so skip it", ns, name)
            return Result()

        if apis.AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION not in obj.metadata.annotations:
            cloud = self._cloud(GLOBAL_REGION)
            for accelerator in cloud.list_global_accelerator_by_resource(
                self.cluster_name, resource, ns, name
            ):
                cloud.cleanup_global_accelerator(accelerator.accelerator_arn)
            klog.infof("Delete Global Accelerator for %s %s/%s", kind, ns, name)
            self.recorder.event(
                obj, "Normal", "GlobalAcceleratorDeleted", "Global Accelerators are deleted"
            )
            return Result()

        for lb_ingress in obj.status.load_balancer.ingress:
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
            lb_name, region = parsed
            cloud = self._cloud(region)
            if resource == "service":
                arn, created, retry_after = cloud.ensure_global_accelerator_for_service(
                    obj, lb_ingress, self.cluster_name, lb_name, region
                )
            else:
                arn, created, retry_after = cloud.ensure_global_accelerator_for_ingress(
                    obj, lb_ingress, self.cluster_name, lb_name, region
                )
            # event BEFORE the requeue check: in staged mode
            # the accelerator-create stage returns created=True WITH a
            # stage requeue — the accelerator exists, so the event is
            # due now, not after the chain tail lands
            if created:
                self.recorder.eventf(
                    obj,
                    "Normal",
                    "GlobalAcceleratorCreated",
                    "Global Accelerator is created: %s",
                    arn,
                )
            if retry_after > 0:
                # the ensure chain is mid-flight on the AWS side (a
                # staged create or a settle hint): the wait is forward
                # progress, not an error backoff
                return Result(requeue=True, requeue_after=retry_after,
                              reason="in-flight")
        return Result()
