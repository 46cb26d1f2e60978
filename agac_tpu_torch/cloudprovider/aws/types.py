"""AWS resource types used by the drivers — the analog of the
aws-sdk-go-v2 ``types`` packages the reference imports (gatypes,
elbv2types, route53types).

Only the fields the framework reads or writes are modeled.  Enum-ish
string constants follow the AWS wire values.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

# Protocols (gatypes.Protocol)
PROTOCOL_TCP = "TCP"
PROTOCOL_UDP = "UDP"

# Accelerator status (gatypes.AcceleratorStatus)
ACCELERATOR_STATUS_DEPLOYED = "DEPLOYED"
ACCELERATOR_STATUS_IN_PROGRESS = "IN_PROGRESS"

# Load balancer states (elbv2types.LoadBalancerStateEnum)
LB_STATE_ACTIVE = "active"
LB_STATE_PROVISIONING = "provisioning"
LB_STATE_FAILED = "failed"

# Client affinity (gatypes.ClientAffinity)
CLIENT_AFFINITY_NONE = "NONE"

# IP address type
IP_ADDRESS_TYPE_IPV4 = "IPV4"

# Route53 record types and change actions
RR_TYPE_A = "A"
RR_TYPE_TXT = "TXT"
RR_TYPE_CNAME = "CNAME"
CHANGE_ACTION_CREATE = "CREATE"
CHANGE_ACTION_DELETE = "DELETE"
CHANGE_ACTION_UPSERT = "UPSERT"

# The fixed hosted zone of every Global Accelerator alias target
# (reference ``pkg/cloudprovider/aws/route53.go:250-257``).
GLOBAL_ACCELERATOR_HOSTED_ZONE_ID = "Z2BJ6XQ5FK7U4H"


# Tag and Accelerator are frozen: they flow through the shared
# DiscoveryCache snapshot (cache.py), which hands the same objects to
# every worker without defensive copies.
@dataclass(frozen=True)
class Tag:
    key: str
    value: str


@dataclass(frozen=True)
class Accelerator:
    accelerator_arn: str = ""
    name: str = ""
    dns_name: str = ""
    enabled: bool = True
    status: str = ACCELERATOR_STATUS_DEPLOYED
    ip_address_type: str = IP_ADDRESS_TYPE_IPV4


@dataclass
class PortRange:
    from_port: int
    to_port: int


@dataclass
class Listener:
    listener_arn: str = ""
    protocol: str = PROTOCOL_TCP
    port_ranges: list[PortRange] = field(default_factory=list)
    client_affinity: str = CLIENT_AFFINITY_NONE


@dataclass
class EndpointDescription:
    endpoint_id: str = ""
    weight: Optional[int] = None
    client_ip_preservation_enabled: bool = False


@dataclass
class EndpointConfiguration:
    endpoint_id: str = ""
    weight: Optional[int] = None
    client_ip_preservation_enabled: bool = False


@dataclass
class EndpointGroup:
    endpoint_group_arn: str = ""
    endpoint_group_region: str = ""
    endpoint_descriptions: list[EndpointDescription] = field(default_factory=list)


@dataclass
class LoadBalancer:
    load_balancer_arn: str = ""
    load_balancer_name: str = ""
    dns_name: str = ""
    state_code: str = LB_STATE_ACTIVE
    type: str = "network"  # "network" | "application"
    scheme: str = "internet-facing"


@dataclass
class HostedZone:
    id: str = ""
    name: str = ""  # always dot-terminated, e.g. "example.com."


@dataclass
class ResourceRecord:
    value: str = ""


@dataclass
class AliasTarget:
    dns_name: str = ""
    evaluate_target_health: bool = True
    hosted_zone_id: str = ""


@dataclass
class ResourceRecordSet:
    name: str = ""  # dot-terminated on the wire
    type: str = RR_TYPE_A
    ttl: Optional[int] = None
    resource_records: list[ResourceRecord] = field(default_factory=list)
    alias_target: Optional[AliasTarget] = None


@dataclass
class Change:
    action: str
    record_set: ResourceRecordSet
