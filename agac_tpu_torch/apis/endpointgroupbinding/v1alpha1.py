"""The EndpointGroupBinding custom resource, v1alpha1.

Capability parity with the reference's CRD types
(``pkg/apis/endpointgroupbinding/v1alpha1/types.go:16-70``): spec binds
the load balancers of a referenced Service or Ingress into an existing
Global Accelerator endpoint group (by ARN, immutable via the
validating webhook), with optional weight and client-IP preservation;
status tracks the endpoint ids added plus ObservedGeneration.

Group/version/kind and the finalizer string are identical to the
reference (group ``operator.h3poteto.dev``, ``registry.go:22-33``;
finalizer at ``pkg/controller/endpointgroupbinding/reconcile.go:18``),
so existing manifests and stored objects are compatible.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ...cluster.objects import ObjectMeta

GROUP = "operator.h3poteto.dev"
VERSION = "v1alpha1"
KIND = "EndpointGroupBinding"
PLURAL = "endpointgroupbindings"
FINALIZER = "operator.h3poteto.dev/endpointgroupbindings"


@dataclass
class ServiceReference:
    name: str = ""


@dataclass
class IngressReference:
    name: str = ""


@dataclass
class EndpointGroupBindingSpec:
    endpoint_group_arn: str = ""
    client_ip_preservation: bool = field(
        default=False, metadata={"wire": "clientIPPreservation"}
    )
    weight: Optional[int] = None
    service_ref: Optional[ServiceReference] = None
    ingress_ref: Optional[IngressReference] = None


@dataclass
class EndpointGroupBindingStatus:
    endpoint_ids: list[str] = field(default_factory=list)
    observed_generation: int = 0


@dataclass
class EndpointGroupBinding:
    KIND = KIND
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: EndpointGroupBindingSpec = field(default_factory=EndpointGroupBindingSpec)
    status: EndpointGroupBindingStatus = field(
        default_factory=EndpointGroupBindingStatus
    )
