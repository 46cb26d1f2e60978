"""Cluster I/O layer: typed Kubernetes objects, a client interface
with a fake in-memory apiserver, shared informers with listers, and an
event recorder.

The analog of the reference's use of client-go informers/listers and
its generated CRD clientset (SURVEY.md §2 rows 4, 17), built as one
generic machine: any registered kind gets storage, watches, informers,
and listers for free.
"""

from .objects import (
    Condition,
    Event,
    Ingress,
    IngressBackend,
    IngressLoadBalancerIngress,
    IngressRule,
    IngressServiceBackend,
    HTTPIngressPath,
    HTTPIngressRuleValue,
    Lease,
    LeaseSpec,
    LoadBalancerIngress,
    ObjectMeta,
    PortStatus,
    Service,
    ServiceBackendPort,
    ServicePort,
    meta_namespace_key,
    split_meta_namespace_key,
)
from .client import ClusterClient, WatchEvent
from .fake import FakeCluster
from .informer import Lister, SharedInformer, SharedInformerFactory, Tombstone
from .record import EventRecorder

__all__ = [
    "ObjectMeta",
    "Service",
    "ServicePort",
    "LoadBalancerIngress",
    "PortStatus",
    "Ingress",
    "IngressRule",
    "IngressBackend",
    "IngressServiceBackend",
    "IngressLoadBalancerIngress",
    "HTTPIngressPath",
    "HTTPIngressRuleValue",
    "ServiceBackendPort",
    "Event",
    "Lease",
    "LeaseSpec",
    "Condition",
    "meta_namespace_key",
    "split_meta_namespace_key",
    "ClusterClient",
    "WatchEvent",
    "FakeCluster",
    "SharedInformer",
    "SharedInformerFactory",
    "Lister",
    "Tombstone",
    "EventRecorder",
]
