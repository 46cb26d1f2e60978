"""The three domain controllers (SURVEY.md §2 rows 8-10): each owns
informer event handlers with predicates, rate-limited workqueues, and
process-delete / process-create-or-update functions driven by the
generic reconcile kernel."""

from .globalaccelerator import GlobalAcceleratorConfig, GlobalAcceleratorController
from .route53 import Route53Config, Route53Controller
from .endpointgroupbinding import (
    EndpointGroupBindingConfig,
    EndpointGroupBindingController,
)
from .garbagecollector import GarbageCollector, GarbageCollectorConfig

__all__ = [
    "GlobalAcceleratorController",
    "GlobalAcceleratorConfig",
    "Route53Controller",
    "Route53Config",
    "EndpointGroupBindingController",
    "EndpointGroupBindingConfig",
    "GarbageCollector",
    "GarbageCollectorConfig",
]
