"""Typed Kubernetes object model — the subset of kinds the framework
watches or writes, as plain dataclasses.

The analog of the k8s.io/api types the reference imports (corev1
Service, networkingv1 Ingress, coordination Lease, corev1 Event) plus
object-key helpers mirroring ``cache.MetaNamespaceKeyFunc`` /
``cache.SplitMetaNamespaceKey`` that the reference uses for queue keys
(e.g. ``pkg/controller/globalaccelerator/controller.go:175-191``).

Every kind carries an ``ObjectMeta`` and declares its ``KIND``; deep
copies go through ``copy.deepcopy`` (the DeepCopyObject analog —
plain data, no back references).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..errors import NoRetryError


# ---------------------------------------------------------------------------
# metadata and keys
# ---------------------------------------------------------------------------


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = ""
    uid: str = ""
    resource_version: str = ""
    generation: int = 0
    creation_timestamp: Optional[str] = None
    deletion_timestamp: Optional[str] = None
    annotations: dict[str, str] = field(default_factory=dict)
    labels: dict[str, str] = field(default_factory=dict)
    finalizers: list[str] = field(default_factory=list)


def meta_namespace_key(obj) -> str:
    """``<namespace>/<name>`` (or ``<name>`` for cluster-scoped)."""
    meta = obj.metadata if hasattr(obj, "metadata") else obj
    if meta.namespace:
        return f"{meta.namespace}/{meta.name}"
    return meta.name


def split_meta_namespace_key(key: str) -> tuple[str, str]:
    """Split ``ns/name`` → (ns, name); a bare name has empty ns.

    Raises NoRetryError on malformed keys, which the reconcile kernel
    logs without requeueing — the behavior the reference gets from
    ``NewNoRetryErrorf("invalid resource key: ...")``
    (e.g. ``pkg/controller/globalaccelerator/service.go:32-34``).
    """
    parts = key.split("/")
    if len(parts) == 1:
        return "", parts[0]
    if len(parts) == 2:
        return parts[0], parts[1]
    raise NoRetryError(f"invalid resource key: {key}")


# ---------------------------------------------------------------------------
# core/v1 Service
# ---------------------------------------------------------------------------


@dataclass
class ServicePort:
    name: str = ""
    protocol: str = "TCP"
    port: int = 0
    target_port: Optional[int] = None
    node_port: Optional[int] = None


@dataclass
class ServiceSpec:
    type: str = "ClusterIP"
    ports: list[ServicePort] = field(default_factory=list)
    load_balancer_class: Optional[str] = None


@dataclass
class PortStatus:
    port: int = 0
    protocol: str = "TCP"
    error: Optional[str] = None


@dataclass
class LoadBalancerIngress:
    ip: str = ""
    hostname: str = ""
    ports: list[PortStatus] = field(default_factory=list)


@dataclass
class LoadBalancerStatus:
    ingress: list[LoadBalancerIngress] = field(default_factory=list)


@dataclass
class ServiceStatus:
    load_balancer: LoadBalancerStatus = field(default_factory=LoadBalancerStatus)


@dataclass
class Service:
    KIND = "Service"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ServiceSpec = field(default_factory=ServiceSpec)
    status: ServiceStatus = field(default_factory=ServiceStatus)


# ---------------------------------------------------------------------------
# networking/v1 Ingress
# ---------------------------------------------------------------------------


@dataclass
class ServiceBackendPort:
    name: str = ""
    number: int = 0


@dataclass
class IngressServiceBackend:
    name: str = ""
    port: ServiceBackendPort = field(default_factory=ServiceBackendPort)


@dataclass
class IngressBackend:
    service: Optional[IngressServiceBackend] = None


@dataclass
class HTTPIngressPath:
    path: str = ""
    path_type: str = "Prefix"
    backend: IngressBackend = field(default_factory=IngressBackend)


@dataclass
class HTTPIngressRuleValue:
    paths: list[HTTPIngressPath] = field(default_factory=list)


@dataclass
class IngressRule:
    host: str = ""
    http: Optional[HTTPIngressRuleValue] = None


@dataclass
class IngressSpec:
    ingress_class_name: Optional[str] = None
    default_backend: Optional[IngressBackend] = None
    rules: list[IngressRule] = field(default_factory=list)


@dataclass
class IngressLoadBalancerIngress:
    ip: str = ""
    hostname: str = ""
    ports: list[PortStatus] = field(default_factory=list)


@dataclass
class IngressLoadBalancerStatus:
    ingress: list[IngressLoadBalancerIngress] = field(default_factory=list)


@dataclass
class IngressStatus:
    load_balancer: IngressLoadBalancerStatus = field(default_factory=IngressLoadBalancerStatus)


@dataclass
class Ingress:
    KIND = "Ingress"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: IngressSpec = field(default_factory=IngressSpec)
    status: IngressStatus = field(default_factory=IngressStatus)


# ---------------------------------------------------------------------------
# core/v1 Event (the recorder's output; SURVEY.md §5 observability)
# ---------------------------------------------------------------------------


@dataclass
class ObjectReference:
    kind: str = ""
    namespace: str = ""
    name: str = ""
    uid: str = ""


@dataclass
class EventSource:
    component: str = ""


@dataclass
class Event:
    KIND = "Event"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    involved_object: ObjectReference = field(default_factory=ObjectReference)
    reason: str = ""
    message: str = ""
    type: str = "Normal"
    count: int = 1
    source: EventSource = field(default_factory=EventSource)
    first_timestamp: Optional[str] = None
    last_timestamp: Optional[str] = None


# ---------------------------------------------------------------------------
# coordination/v1 Lease (leader election; SURVEY.md §2 row 2)
# ---------------------------------------------------------------------------


@dataclass
class LeaseSpec:
    holder_identity: Optional[str] = None
    lease_duration_seconds: Optional[int] = None
    acquire_time: Optional[str] = None
    renew_time: Optional[str] = None
    lease_transitions: int = 0


@dataclass
class Lease:
    KIND = "Lease"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LeaseSpec = field(default_factory=LeaseSpec)


# ---------------------------------------------------------------------------
# shared condition type (used by CRD status)
# ---------------------------------------------------------------------------


@dataclass
class Condition:
    type: str = ""
    status: str = ""
    reason: str = ""
    message: str = ""
    last_transition_time: Optional[str] = None
