from .v1alpha1 import (
    FINALIZER,
    GROUP,
    VERSION,
    EndpointGroupBinding,
    EndpointGroupBindingSpec,
    EndpointGroupBindingStatus,
    IngressReference,
    ServiceReference,
)

__all__ = [
    "GROUP",
    "VERSION",
    "FINALIZER",
    "EndpointGroupBinding",
    "EndpointGroupBindingSpec",
    "EndpointGroupBindingStatus",
    "ServiceReference",
    "IngressReference",
]
