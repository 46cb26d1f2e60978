"""AWS cloud layer: resource types, API interfaces, the in-memory
fake backend, and the high-level resource drivers (Global Accelerator,
Route53, ELBv2 lookups).

Deliberate improvement over the reference (SURVEY.md §7 stage 3): the
drivers depend on abstract API interfaces instead of concrete SDK
clients, so the fake backend can be injected and the whole driver
logic — ownership tags, drift detection, rollback, delete
orchestration — is unit-testable.  The reference constructs ``NewAWS``
inline in its process funcs (e.g.
``pkg/controller/globalaccelerator/service.go:35,65,101``), which is
why its AWS layer has no unit tests.
"""

from .types import (
    Accelerator,
    AliasTarget,
    Change,
    EndpointConfiguration,
    EndpointDescription,
    EndpointGroup,
    HostedZone,
    Listener,
    LoadBalancer,
    PortRange,
    ResourceRecord,
    ResourceRecordSet,
    Tag,
)
from .errors import (
    AWSAPIError,
    ERR_ENDPOINT_GROUP_NOT_FOUND,
    ERR_LISTENER_NOT_FOUND,
    EndpointGroupNotFoundException,
    ListenerNotFoundException,
    aws_error_code,
)
from .load_balancer import get_lb_name_from_hostname, get_region_from_arn
from .cache import (
    AcceleratorTopologyCache,
    DiscoveryCache,
    HostedZoneCache,
    LoadBalancerCoalescer,
    RecordSetCache,
)
from .driver import AWSDriver, Route53OwnerValue
from .fake_backend import FakeAWSBackend, FaultPlan
from .health import (
    AIMDLimiter,
    CircuitBreaker,
    CircuitOpenError,
    DeadlineExceeded,
    HealthConfig,
    HealthTracker,
    WorkerHeartbeats,
)

__all__ = [
    "Accelerator",
    "Tag",
    "Listener",
    "PortRange",
    "EndpointGroup",
    "EndpointDescription",
    "EndpointConfiguration",
    "LoadBalancer",
    "HostedZone",
    "ResourceRecordSet",
    "ResourceRecord",
    "AliasTarget",
    "Change",
    "AWSAPIError",
    "ListenerNotFoundException",
    "EndpointGroupNotFoundException",
    "ERR_LISTENER_NOT_FOUND",
    "ERR_ENDPOINT_GROUP_NOT_FOUND",
    "aws_error_code",
    "get_lb_name_from_hostname",
    "get_region_from_arn",
    "AWSDriver",
    "Route53OwnerValue",
    "FakeAWSBackend",
    "FaultPlan",
    "AIMDLimiter",
    "CircuitBreaker",
    "CircuitOpenError",
    "DeadlineExceeded",
    "HealthConfig",
    "HealthTracker",
    "WorkerHeartbeats",
    "DiscoveryCache",
    "HostedZoneCache",
    "AcceleratorTopologyCache",
    "RecordSetCache",
    "LoadBalancerCoalescer",
]
