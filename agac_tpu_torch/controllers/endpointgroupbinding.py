"""The EndpointGroupBinding controller — the CRD's finalizer state
machine.

Capability parity with the reference's
``pkg/controller/endpointgroupbinding/`` (439 LoC):

- create → install the finalizer (``reconcile.go:99-110``);
- update → resolve the referenced Service/Ingress to LB ARNs through
  the listers + ELBv2 (``reconcile.go:219-252``), diff against
  ``status.endpointIds``, add/remove endpoints, sync weights, then
  update status with the new ids and ObservedGeneration
  (``reconcile.go:112-217``);
- delete → remove all endpoints (tolerating a vanished endpoint group
  via the ``EndpointGroupNotFoundException`` error code,
  ``reconcile.go:48-64``), then clear the finalizer so the apiserver
  completes the deletion; a 1 s requeue drives the loop
  (``reconcile.go:96``).

ARN-change update events are dropped at the handler (belt-and-braces
with the validating webhook, ``controller.go:84-94``).

The reference's delete loop mutates ``endpointIds`` while iterating by
index (``reconcile.go:71-85``, flagged in SURVEY.md §7 as a known
bug); the intent — remove every endpoint, persist the emptied status,
requeue — is implemented here without the index dance.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

from .. import klog
from ..apis.endpointgroupbinding import FINALIZER, EndpointGroupBinding
from ..cloudprovider.aws import aws_error_code, get_region_from_arn
from ..cloudprovider.aws.errors import (
    ERR_ENDPOINT_GROUP_NOT_FOUND,
    EndpointGroupNotFoundException,
)
from ..cluster import ClusterClient, EventRecorder, SharedInformerFactory
from ..cluster.objects import meta_namespace_key, split_meta_namespace_key
from ..reconcile import RateLimitingQueue, Result, controller_rate_limiter
from ..sharding import OWNS_ALL
from ..observability import instruments
from ..observability import journey as obs_journey
from .common import (
    CloudFactory,
    GLOBAL_REGION,
    default_cloud_factory,
    lb_name_region_or_warn,
    make_sync_error_warner,
    run_workers,
    with_shard_guard,
    stamp_journey_enqueued,
    start_drift_resync,
)

CONTROLLER_AGENT_NAME = "endpoint-group-binding-controller"
KIND = "EndpointGroupBinding"


@dataclass
class EndpointGroupBindingConfig:
    workers: int = 1
    queue_qps: float = 10.0
    queue_burst: int = 100
    # per-item exponential backoff cap (client-go default 1000 s)
    queue_max_backoff: float = 1000.0
    # see GlobalAcceleratorConfig.drift_resync_period; 0 = reference parity
    drift_resync_period: float = 0.0
    # see GlobalAcceleratorConfig.reconcile_deadline; 0 = disabled
    reconcile_deadline: float = 0.0


class EndpointGroupBindingController:
    # endpoint membership lives in GA; LB resolution goes through ELBv2
    DRIFT_SERVICES = ("globalaccelerator", "elbv2")

    def __init__(
        self,
        client: ClusterClient,
        informer_factory: SharedInformerFactory,
        config: EndpointGroupBindingConfig,
        cloud_factory: Optional[CloudFactory] = None,
        shard_filter=None,
    ):
        self._client = client
        # sharding ownership predicate; OWNS_ALL = the
        # single-shard semantics every pre-sharding tier runs under
        self._shards = shard_filter if shard_filter is not None else OWNS_ALL
        self._workers = config.workers
        self._drift_resync_period = config.drift_resync_period
        self._reconcile_deadline = config.reconcile_deadline
        self._cloud = cloud_factory or default_cloud_factory
        self.recorder = EventRecorder(client, CONTROLLER_AGENT_NAME)
        self.workqueue = RateLimitingQueue(
            controller_rate_limiter(
                config.queue_qps, config.queue_burst, config.queue_max_backoff
            ), name=KIND
        )

        self.service_lister = informer_factory.informer("Service").lister()
        self.ingress_lister = informer_factory.informer("Ingress").lister()
        binding_informer = informer_factory.informer(KIND)
        self.binding_lister = binding_informer.lister()
        binding_informer.add_event_handler(
            on_add=self._enqueue,
            on_update=self._update_notification,
        )
        self._informer_factory = informer_factory

    def _update_notification(self, old, new) -> None:
        # Changing spec.endpointGroupArn is blocked by the validating
        # webhook; drop such events defensively too
        # (reference ``controller.go:84-94``).
        if old.spec.endpoint_group_arn != new.spec.endpoint_group_arn:
            klog.error("Do not allow changing EndpointGroupArn field")
            return
        self._enqueue(new)

    def _enqueue(self, obj) -> None:
        key = meta_namespace_key(obj)
        if not self._shards.owns_key(key):
            return  # another shard's replica reconciles this key
        # the journey label is the WORKER name (what the reconcile
        # loop closes under), not the queue's kind name
        stamp_journey_enqueued(CONTROLLER_AGENT_NAME, obj)
        self.workqueue.add_rate_limited(key, reason="in-flight")

    def _resync_enqueue(self, obj, trigger: str) -> None:
        """Drift/handoff re-enqueue: journey-stamped, then the plain
        dedup add (the client-go resync pattern)."""
        stamp_journey_enqueued(CONTROLLER_AGENT_NAME, obj, trigger=trigger)
        self.workqueue.add(meta_namespace_key(obj))

    def drift_resync_sources(
        self, trigger: str = obs_journey.TRIGGER_DRIFT
    ) -> list:
        """The canonical ``[(lister, predicate, enqueue), ...]`` drift
        re-enqueue wiring — consumed by the in-process ticker and by
        external single-tick drivers (the bench's drift-tick
        measurement), so the two can never diverge.  ``trigger``
        labels the journeys these enqueues open."""
        # every EndpointGroupBinding is managed (no annotation gate);
        # the shard filter still partitions them across replicas
        return [
            (
                self.binding_lister,
                self._shards.owns_obj,
                lambda b: self._resync_enqueue(b, trigger),
            )
        ]

    def worker_specs(self) -> list[dict]:
        """The canonical worker wiring (see the GlobalAccelerator
        controller's docstring) — shared by run() and the sim
        harness."""
        return [
            dict(
                name=CONTROLLER_AGENT_NAME,
                queue=self.workqueue,
                key_to_obj=self._key_to_binding,
                # pop-time ownership re-check: residue of a
                # resize drain or lease steal is skipped, not worked
                process_delete=with_shard_guard(
                    self._shards, self._process_deleted_key
                ),
                process_create_or_update=with_shard_guard(
                    self._shards, self.reconcile
                ),
                on_sync_result=make_sync_error_warner(
                    self.recorder, self._key_to_binding
                ),
                reconcile_deadline=self._reconcile_deadline,
                # explain plane: every EndpointGroupBinding
                # is managed (no annotation gate)
                managed=None,
            ),
        ]

    # ------------------------------------------------------------------
    # run loop (reference ``controller.go:103-141``)
    # ------------------------------------------------------------------
    def run(self, stop: threading.Event) -> None:
        klog.info("Starting EndpointGroupBinding controller")
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
        self.workqueue.shutdown()
        self.recorder.shutdown()

    def _key_to_binding(self, key: str):
        ns, name = split_meta_namespace_key(key)
        return self.binding_lister.namespaced(ns).get(name)

    @staticmethod
    def _process_deleted_key(key: str) -> Result:
        # Deletion is finalizer-driven; by the time the object is gone
        # from the cache the cleanup already ran
        # (reference ``controller.go:151-159``).
        klog.infof("EndpointGroupBinding %s has been deleted", key)
        return Result()

    # ------------------------------------------------------------------
    # reconcile state machine (reference ``reconcile.go:20-34``)
    # ------------------------------------------------------------------
    def reconcile(self, obj: EndpointGroupBinding) -> Result:
        cloud = self._cloud(GLOBAL_REGION)
        if obj.metadata.deletion_timestamp is not None:
            return self._reconcile_delete(obj, cloud)
        if not obj.metadata.finalizers:
            return self._reconcile_create(obj)
        return self._reconcile_update(obj, cloud)

    def _reconcile_create(self, obj: EndpointGroupBinding) -> Result:
        # obj is already the kernel's deep copy — safe to mutate
        obj.metadata.finalizers = [FINALIZER]
        self._client.update(KIND, obj)
        return Result()

    def _clear_finalizer(self, obj: EndpointGroupBinding) -> None:
        obj.metadata.finalizers = []
        self._client.update(KIND, obj)

    def _reconcile_delete(self, obj: EndpointGroupBinding, cloud) -> Result:
        if not obj.status.endpoint_ids:
            self._clear_finalizer(obj)
            return Result()

        try:
            endpoint_group = cloud.describe_endpoint_group(obj.spec.endpoint_group_arn)
        except Exception as err:
            code = aws_error_code(err)
            if code:
                klog.v(1).infof(
                    "Failed to get EndpointGroup %s: %s", obj.spec.endpoint_group_arn, code
                )
                if code == ERR_ENDPOINT_GROUP_NOT_FOUND:
                    # the endpoint group is gone; nothing left to detach
                    self._clear_finalizer(obj)
                    return Result()
            raise

        for endpoint_id in obj.status.endpoint_ids:
            regional = self._cloud(get_region_from_arn(endpoint_id))
            regional.remove_lb_from_endpoint_group(endpoint_group, endpoint_id)

        obj.status.endpoint_ids = []
        obj.status.observed_generation = obj.metadata.generation
        self._client.update_status(KIND, obj)
        return Result(requeue=True, requeue_after=1.0, reason="in-flight")

    def _reconcile_update(self, obj: EndpointGroupBinding, cloud) -> Result:
        hostnames = self._load_balancer_hostnames(obj)
        arns: dict[str, tuple[str, str]] = {}  # lb arn -> (lb name, region)
        for hostname in hostnames:
            parsed = lb_name_region_or_warn(self.recorder, obj, hostname)
            if parsed is None:
                # abort WITHOUT mutating: dropping the hostname from
                # the diff would remove its (possibly healthy) endpoint
                # from the group on a parse error; leave bindings
                # untouched until the referenced object's status
                # changes and re-enqueues (no retry — permanent)
                return Result()
            lb_name, region = parsed
            regional = self._cloud(region)
            lb = regional.get_load_balancer(lb_name)
            arns[lb.load_balancer_arn] = (lb_name, region)
        klog.v(4).infof("Service LoadBalancer ARNs: %r", list(arns))

        new_endpoint_ids = [arn for arn in arns if arn not in obj.status.endpoint_ids]
        removed_endpoint_ids = [
            endpoint_id
            for endpoint_id in obj.status.endpoint_ids
            if endpoint_id not in arns
        ]
        klog.v(4).infof("New EndpointIds: %r", new_endpoint_ids)
        klog.v(4).infof("Removed EndpointIds: %r", removed_endpoint_ids)
        endpoint_group = None
        if (
            not new_endpoint_ids
            and not removed_endpoint_ids
            and obj.status.observed_generation == obj.metadata.generation
        ):
            # the reference returns here unconditionally
            # (``reconcile.go:157-159``) — status is trusted, so AWS
            # state mutated out-of-band is never re-examined.  With
            # drift resync on, that would make the ticker a no-op for
            # converged bindings: verify the ACTUAL endpoint group
            # instead (one describe per tick, reused below when drift
            # is found) and fall through to the repair path when an
            # endpoint vanished or a weight was edited behind the
            # controller.
            if self._drift_resync_period <= 0:
                return Result()
            try:
                endpoint_group = cloud.describe_endpoint_group(
                    obj.spec.endpoint_group_arn
                )
            except EndpointGroupNotFoundException:
                # the whole group was deleted out-of-band: the ARN is
                # immutable, so no retry can ever succeed — surface it
                # and stop (the delete path tolerates the same code,
                # and deleting the binding remains the way out)
                self.recorder.eventf(
                    obj, "Warning", "EndpointGroupGone",
                    "endpoint group %s no longer exists; delete or recreate "
                    "this EndpointGroupBinding",
                    obj.spec.endpoint_group_arn,
                )
                return Result()
            present = {
                d.endpoint_id: d for d in endpoint_group.endpoint_descriptions
            }
            # the guard above means every status id is a key of arns,
            # so membership drift reduces to "status id absent in AWS"
            missing = [
                endpoint_id
                for endpoint_id in obj.status.endpoint_ids
                if endpoint_id not in present
            ]
            weight_drifted = obj.spec.weight is not None and any(
                present[endpoint_id].weight != obj.spec.weight
                for endpoint_id in arns
                if endpoint_id in present
            )
            if not missing and not weight_drifted:
                return Result()
            klog.infof(
                "Drift on EndpointGroupBinding %s/%s: missing=%r weight_drifted=%s",
                obj.metadata.namespace, obj.metadata.name, missing, weight_drifted,
            )
            new_endpoint_ids = missing  # re-add through the normal path

        if endpoint_group is None:
            endpoint_group = cloud.describe_endpoint_group(obj.spec.endpoint_group_arn)

        # the weight AWS holds for each endpoint, as far as this pass
        # already knows it: the describe above, then each add's response
        # (a pass that applies an edit of a converged binding's spec
        # trusts none of it and writes, as the reference does)
        edited = 0 < obj.status.observed_generation != obj.metadata.generation
        known_weights = {
            d.endpoint_id: d.weight for d in endpoint_group.endpoint_descriptions
        }
        results = list(obj.status.endpoint_ids)
        for endpoint_id in removed_endpoint_ids:
            regional = self._cloud(get_region_from_arn(endpoint_id))
            regional.remove_lb_from_endpoint_group(endpoint_group, endpoint_id)
            results = [r for r in results if r != endpoint_id]

        for endpoint_id in new_endpoint_ids:
            lb_name, region = arns[endpoint_id]
            regional = self._cloud(region)
            added, retry_after = regional.add_lb_endpoint(
                endpoint_group,
                lb_name,
                obj.spec.client_ip_preservation,
                obj.spec.weight,
            )
            if retry_after > 0:
                # the add is settling on the AWS side — forward
                # progress, not an error backoff
                return Result(requeue=True, requeue_after=retry_after,
                              reason="in-flight")
            if added is None:
                continue
            known_weights[added.endpoint_id] = added.weight
            if added.endpoint_id not in results:
                # drift repair re-adds ids that are still in status —
                # appending unconditionally would duplicate them
                results.append(added.endpoint_id)

        # weight sync for every bound endpoint (reference
        # ``reconcile.go:195-202``), skipping the write where this pass
        # already saw the spec's weight in AWS: the reference resends it
        # (a describe and an UpdateEndpointGroup) after every add
        for endpoint_id in arns:
            if (
                not edited
                and endpoint_id in known_weights
                and known_weights[endpoint_id] == obj.spec.weight
            ):
                outcome = "skipped"
            else:
                cloud.update_endpoint_weight(endpoint_group, endpoint_id, obj.spec.weight)
                outcome = "written"
            instruments.binding_weight_sync_total().labels(outcome=outcome).inc()

        obj.status.endpoint_ids = results
        obj.status.observed_generation = obj.metadata.generation
        self._client.update_status(KIND, obj)
        return Result()

    def _load_balancer_hostnames(self, obj: EndpointGroupBinding) -> list[str]:
        """Resolve serviceRef/ingressRef to LB hostnames via the
        listers (reference ``reconcile.go:219-252``)."""
        if obj.spec.service_ref is not None:
            service = self.service_lister.namespaced(obj.metadata.namespace).get(
                obj.spec.service_ref.name
            )
            ingresses = service.status.load_balancer.ingress
            if not ingresses:
                klog.warningf(
                    "%s/%s does not have ingress LoadBalancer, so skip it",
                    service.metadata.namespace,
                    service.metadata.name,
                )
                return []
            return [i.hostname for i in ingresses]
        if obj.spec.ingress_ref is not None:
            ingress = self.ingress_lister.namespaced(obj.metadata.namespace).get(
                obj.spec.ingress_ref.name
            )
            ingresses = ingress.status.load_balancer.ingress
            if not ingresses:
                klog.warningf(
                    "%s/%s does not have ingress LoadBalancer, so skip it",
                    ingress.metadata.namespace,
                    ingress.metadata.name,
                )
                return []
            return [i.hostname for i in ingresses]
        klog.errorf(
            "EndpointGroupBinding %s does not have serviceRef or ingressRef",
            obj.metadata.name,
        )
        return []
