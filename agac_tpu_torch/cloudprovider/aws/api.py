"""Abstract AWS service interfaces — the injection seam between the
drivers and either the real AWS APIs or the in-memory fake backend.

The operation set is exactly what the reference's drivers call on
aws-sdk-go-v2 (SURVEY.md §2 rows 12-15); list operations are
paginated with (max_results, next_token) pairs the way the reference
consumes SDK paginators (``pkg/cloudprovider/aws/global_accelerator.go:619-636``,
``route53.go:199-213,318-332``).
"""

from __future__ import annotations

import abc
from typing import Optional

from .types import (
    Accelerator,
    Change,
    EndpointConfiguration,
    EndpointDescription,
    EndpointGroup,
    HostedZone,
    Listener,
    LoadBalancer,
    PortRange,
    ResourceRecordSet,
    Tag,
)


class GlobalAcceleratorAPI(abc.ABC):
    # accelerators
    @abc.abstractmethod
    def list_accelerators(
        self, max_results: int, next_token: Optional[str]
    ) -> tuple[list[Accelerator], Optional[str]]: ...

    @abc.abstractmethod
    def describe_accelerator(self, arn: str) -> Accelerator: ...

    @abc.abstractmethod
    def create_accelerator(
        self, name: str, ip_address_type: str, enabled: bool, tags: list[Tag]
    ) -> Accelerator: ...

    @abc.abstractmethod
    def update_accelerator(
        self, arn: str, name: Optional[str] = None, enabled: Optional[bool] = None
    ) -> Accelerator: ...

    @abc.abstractmethod
    def delete_accelerator(self, arn: str) -> None: ...

    @abc.abstractmethod
    def list_tags_for_resource(self, arn: str) -> list[Tag]: ...

    @abc.abstractmethod
    def tag_resource(self, arn: str, tags: list[Tag]) -> None: ...

    # listeners
    @abc.abstractmethod
    def list_listeners(
        self, accelerator_arn: str, max_results: int, next_token: Optional[str]
    ) -> tuple[list[Listener], Optional[str]]: ...

    @abc.abstractmethod
    def create_listener(
        self,
        accelerator_arn: str,
        port_ranges: list[PortRange],
        protocol: str,
        client_affinity: str,
    ) -> Listener: ...

    @abc.abstractmethod
    def update_listener(
        self,
        listener_arn: str,
        port_ranges: list[PortRange],
        protocol: str,
        client_affinity: str,
    ) -> Listener: ...

    @abc.abstractmethod
    def delete_listener(self, arn: str) -> None: ...

    # endpoint groups
    @abc.abstractmethod
    def list_endpoint_groups(
        self, listener_arn: str, max_results: int, next_token: Optional[str]
    ) -> tuple[list[EndpointGroup], Optional[str]]: ...

    @abc.abstractmethod
    def describe_endpoint_group(self, arn: str) -> EndpointGroup: ...

    @abc.abstractmethod
    def create_endpoint_group(
        self,
        listener_arn: str,
        endpoint_group_region: str,
        endpoint_configurations: list[EndpointConfiguration],
    ) -> EndpointGroup: ...

    @abc.abstractmethod
    def update_endpoint_group(
        self, arn: str, endpoint_configurations: list[EndpointConfiguration]
    ) -> EndpointGroup: ...

    @abc.abstractmethod
    def delete_endpoint_group(self, arn: str) -> None: ...

    @abc.abstractmethod
    def add_endpoints(
        self, arn: str, endpoint_configurations: list[EndpointConfiguration]
    ) -> list[EndpointDescription]: ...

    @abc.abstractmethod
    def remove_endpoints(self, arn: str, endpoint_ids: list[str]) -> None: ...


class ELBv2API(abc.ABC):
    @abc.abstractmethod
    def describe_load_balancers(self, names: list[str]) -> list[LoadBalancer]: ...


class Route53API(abc.ABC):
    @abc.abstractmethod
    def list_hosted_zones(
        self, max_items: int, marker: Optional[str]
    ) -> tuple[list[HostedZone], Optional[str]]: ...

    @abc.abstractmethod
    def list_hosted_zones_by_name(
        self, dns_name: str, max_items: int
    ) -> list[HostedZone]: ...

    @abc.abstractmethod
    def list_resource_record_sets(
        self, hosted_zone_id: str, max_items: int, start_record_name: Optional[str]
    ) -> tuple[list[ResourceRecordSet], Optional[str]]: ...

    @abc.abstractmethod
    def change_resource_record_sets(
        self, hosted_zone_id: str, changes: list[Change]
    ) -> None: ...
