"""A frozen copy of the port's in-memory ``FakeAWSBackend``.

The benchmark owns the AWS its in-process deployments act on: a later
change to the program may not change the world it is measured against.
This is the port's ``cloudprovider/aws/fake_backend.py`` class as it
stood when the benchmark was written, with the seams the benchmark does
not use taken out (the fault plan, the durable-file hook, the racecheck
guards and the per-call latency; ``perfbench/world/shaping.py`` shapes
the calls instead).  It imports only the object and error types that
``cloudprovider/aws/api.py``'s interfaces require.
"""

from __future__ import annotations

import inspect
import re
import threading
import uuid
from dataclasses import replace
from typing import Optional

from agac_tpu_torch.cloudprovider.aws.api import ELBv2API, GlobalAcceleratorAPI, Route53API
from agac_tpu_torch.cloudprovider.aws.errors import (
    AWSAPIError,
    ERR_ACCELERATOR_NOT_DISABLED,
    ERR_ACCELERATOR_NOT_FOUND,
    ERR_ASSOCIATED_ENDPOINT_GROUP_FOUND,
    ERR_ASSOCIATED_LISTENER_FOUND,
    ERR_INVALID_ARGUMENT,
    ERR_INVALID_CHANGE_BATCH,
    ERR_INVALID_PORT_RANGE,
    ERR_LIMIT_EXCEEDED,
    ERR_LOAD_BALANCER_NOT_FOUND,
    ERR_NO_SUCH_HOSTED_ZONE,
    EndpointGroupNotFoundException,
    ListenerNotFoundException,
)
from agac_tpu_torch.cloudprovider.aws.types import (
    ACCELERATOR_STATUS_DEPLOYED,
    ACCELERATOR_STATUS_IN_PROGRESS,
    CHANGE_ACTION_CREATE,
    CHANGE_ACTION_DELETE,
    CHANGE_ACTION_UPSERT,
    Accelerator,
    Change,
    EndpointDescription,
    EndpointGroup,
    HostedZone,
    Listener,
    LoadBalancer,
    PortRange,
    ResourceRecordSet,
    Tag,
)

_ACCOUNT = "123456789012"

# CreateAccelerator Name constraint (GA API reference): up to 64
# characters, only alphanumerics/periods/hyphens, must not begin or
# end with a hyphen or period
_ACCELERATOR_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9.-]{0,62}[A-Za-z0-9]$|^[A-Za-z0-9]$")

_VALID_PROTOCOLS = frozenset({"TCP", "UDP"})
_VALID_CLIENT_AFFINITY = frozenset({"NONE", "SOURCE_IP"})
_VALID_IP_ADDRESS_TYPES = frozenset({"IPV4", "DUAL_STACK"})
# Route53 record types the 2013-04-01 API accepts
_VALID_RR_TYPES = frozenset(
    {"A", "AAAA", "CAA", "CNAME", "DS", "MX", "NAPTR", "NS", "PTR",
     "SOA", "SPF", "SRV", "TXT"}
)
_MAX_TTL = 2_147_483_647  # Route53 TTL is a 32-bit signed int


def _validate_accelerator_name(name: str) -> None:
    if not _ACCELERATOR_NAME_RE.match(name or ""):
        raise AWSAPIError(
            ERR_INVALID_ARGUMENT,
            f"Accelerator name {name!r} must be 1-64 alphanumeric, period or "
            "hyphen characters and must not begin or end with a hyphen or period",
        )


def _validate_port_ranges(port_ranges, max_ranges: int) -> None:
    if not port_ranges:
        raise AWSAPIError(ERR_INVALID_ARGUMENT, "at least one port range is required")
    if len(port_ranges) > max_ranges:
        raise AWSAPIError(
            ERR_LIMIT_EXCEEDED,
            f"{len(port_ranges)} port ranges exceeds the {max_ranges} per-listener quota",
        )
    for port_range in port_ranges:
        from_port = getattr(port_range, "from_port", None)
        to_port = getattr(port_range, "to_port", None)
        if from_port is None or to_port is None:
            raise AWSAPIError(
                ERR_INVALID_ARGUMENT,
                f"port range {port_range!r} must carry FromPort and ToPort",
            )
        if not (1 <= from_port <= 65535 and 1 <= to_port <= 65535):
            raise AWSAPIError(
                ERR_INVALID_PORT_RANGE,
                f"port range {from_port}-{to_port} outside 1-65535",
            )
        if from_port > to_port:
            raise AWSAPIError(
                ERR_INVALID_PORT_RANGE,
                f"FromPort {from_port} greater than ToPort {to_port}",
            )


def _validate_listener_args(port_ranges, protocol, client_affinity, max_ranges) -> None:
    _validate_port_ranges(port_ranges, max_ranges)
    if protocol not in _VALID_PROTOCOLS:
        raise AWSAPIError(ERR_INVALID_ARGUMENT, f"invalid Protocol {protocol!r}")
    if client_affinity not in _VALID_CLIENT_AFFINITY:
        raise AWSAPIError(
            ERR_INVALID_ARGUMENT, f"invalid ClientAffinity {client_affinity!r}"
        )


def _paginate(items: list, max_results: int, next_token: Optional[str]):
    start = int(next_token) if next_token else 0
    page = items[start : start + max_results]
    token = str(start + max_results) if start + max_results < len(items) else None
    return page, token


# every method the drivers can reach — exactly the three API
# interfaces; the shaping proxy shapes and counts these and no helper
API_OPS = frozenset(
    name
    for cls in (GlobalAcceleratorAPI, ELBv2API, Route53API)
    for name, member in vars(cls).items()
    if inspect.isfunction(member) and not name.startswith("_")
)


class _SerialCounter:
    """``itertools.count`` with a readable current value, so durable
    backends can persist it and resume without ID collisions."""

    __slots__ = ("value",)

    def __init__(self, start: int = 1):
        self.value = start

    def __next__(self) -> int:
        value = self.value
        self.value += 1
        return value

    def __iter__(self) -> "_SerialCounter":
        return self


class _AcceleratorState:
    def __init__(self, accelerator: Accelerator, tags: list[Tag], settle: int):
        self.accelerator = accelerator
        self.tags = tags
        self.listeners: dict[str, Listener] = {}
        self.pending_describes = settle  # describes until DEPLOYED


class FakeAWSBackend(GlobalAcceleratorAPI, ELBv2API, Route53API):
    """One object implements all three services; hand it to the driver
    as ga_api, elb_api and route53_api."""

    def __init__(
        self,
        settle_describes: int = 0,
        # the documented default service quotas; raise them the way a
        # real account requests quota increases (the bench's 1000-
        # accelerator fleet does)
        quota_accelerators: int = 20,
        quota_listeners_per_accelerator: int = 10,
        quota_port_ranges_per_listener: int = 10,
        quota_endpoint_groups_per_listener: int = 10,
        quota_endpoints_per_group: int = 10,
        quota_tags_per_resource: int = 50,
        quota_changes_per_batch: int = 1000,
    ):
        lock = threading.RLock()
        self._lock = lock
        self.settle_describes = settle_describes
        self.quota_accelerators = quota_accelerators
        self.quota_listeners_per_accelerator = quota_listeners_per_accelerator
        self.quota_port_ranges_per_listener = quota_port_ranges_per_listener
        self.quota_endpoint_groups_per_listener = quota_endpoint_groups_per_listener
        self.quota_endpoints_per_group = quota_endpoints_per_group
        self.quota_tags_per_resource = quota_tags_per_resource
        self.quota_changes_per_batch = quota_changes_per_batch
        self._accelerators: dict[str, _AcceleratorState] = {}
        # listener arn -> (accelerator arn); endpoint groups keyed by arn
        self._listener_parent: dict[str, str] = {}
        self._endpoint_groups: dict[str, EndpointGroup] = {}
        self._eg_parent: dict[str, str] = {}  # eg arn -> listener arn
        self._load_balancers: dict[str, LoadBalancer] = {}  # name -> LB
        self._zones: dict[str, HostedZone] = {}  # id -> zone
        self._records: dict[str, dict[tuple[str, str], ResourceRecordSet]] = {}
        self._counter = _SerialCounter()
        # derived indexes (plain dicts, always mutated under the lock;
        # insertion-ordered so iteration stays deterministic for the
        # sim replay contract): arns still settling toward DEPLOYED —
        # so a ListAccelerators page settles O(pending), not O(fleet) —
        # and listener arn -> its endpoint-group arns, so per-chain
        # listing is O(chain), not a scan of every group in the fleet
        self._settling: dict[str, None] = {}
        self._egs_by_listener: dict[str, dict[str, None]] = {}
        # memoized ListAccelerators item list, dropped whenever any
        # accelerator payload changes — a paginated drain at N=10k is
        # ~100 page calls, and rebuilding the O(N) list per page made
        # every drain O(N^2/page) in the 7-day sim soak
        self._accel_list_cache: "Optional[list[Accelerator]]" = None
        # call log: ("CreateAccelerator", arn), ...
        self.calls: list[tuple] = []

    # ------------------------------------------------------------------
    # test helpers
    # ------------------------------------------------------------------
    def add_load_balancer(
        self,
        name: str,
        region: str,
        dns_name: str,
        state_code: str = "active",
        lb_type: str = "network",
        scheme: str = "internet-facing",
    ) -> LoadBalancer:
        with self._lock:
            # idempotent on (name, dns): a restarted process re-seeding
            # the same env-declared LB must not mint a new arn — the
            # durable state's endpoint groups reference the old one
            existing = self._load_balancers.get(name)
            if existing is not None and existing.dns_name == dns_name:
                return existing
            arn = (
                f"arn:aws:elasticloadbalancing:{region}:{_ACCOUNT}:"
                f"loadbalancer/{'net' if lb_type == 'network' else 'app'}/{name}/{next(self._counter):016x}"
            )
            lb = LoadBalancer(
                load_balancer_arn=arn,
                load_balancer_name=name,
                dns_name=dns_name,
                state_code=state_code,
                type=lb_type,
                scheme=scheme,
            )
            self._load_balancers[name] = lb
        return lb

    def set_load_balancer_state(self, name: str, state_code: str) -> None:
        with self._lock:
            self._load_balancers[name].state_code = state_code

    def add_hosted_zone(self, name: str) -> HostedZone:
        if not name.endswith("."):
            name += "."
        with self._lock:
            # idempotent by name (same rationale as add_load_balancer:
            # restart re-seeding must not duplicate the zone)
            for zone in self._zones.values():
                if zone.name == name:
                    return zone
            zone = HostedZone(id=f"/hostedzone/Z{next(self._counter):08X}", name=name)
            self._zones[zone.id] = zone
            self._records.setdefault(zone.id, {})
        return zone

    def records_in_zone(self, zone_id: str) -> list[ResourceRecordSet]:
        with self._lock:
            return list(self._records.get(zone_id, {}).values())

    def all_accelerator_arns(self) -> list[str]:
        with self._lock:
            return list(self._accelerators.keys())

    def chain_counts(self) -> tuple[int, int, int]:
        """(accelerators, listeners, endpoint groups) — the complete-
        chain convergence odometer.  With staged chains an
        accelerator exists passes before its listener/endpoint group
        do, so counting accelerators alone would declare convergence
        early."""
        with self._lock:
            return (
                len(self._accelerators),
                len(self._listener_parent),
                len(self._endpoint_groups),
            )

    def accelerator_owners(self) -> dict[str, Optional[str]]:
        """arn -> owner-tag value — a test/oracle helper read that is
        neither faulted nor call-counted (sim oracles snapshot GC
        ground truth through this without perturbing fault budgets or
        quiescence windows)."""
        with self._lock:
            return {
                arn: next(
                    (
                        t.value
                        for t in state.tags
                        # keep in sync with driver.OWNER_TAG_KEY (the
                        # fake never imports the driver)
                        if t.key == "aws-global-accelerator-owner"
                    ),
                    None,
                )
                for arn, state in self._accelerators.items()
            }

    def all_hosted_zone_ids(self) -> list[str]:
        """Every hosted-zone id (unfaulted helper; see above)."""
        with self._lock:
            return sorted(self._zones.keys())

    # ------------------------------------------------------------------
    # GlobalAcceleratorAPI
    # ------------------------------------------------------------------
    def _settle(self, state: _AcceleratorState) -> None:
        if state.pending_describes > 0:
            state.pending_describes -= 1
            if state.pending_describes == 0:
                state.accelerator = replace(
                    state.accelerator, status=ACCELERATOR_STATUS_DEPLOYED
                )
                self._settling.pop(state.accelerator.accelerator_arn, None)
                self._accel_list_cache = None

    def _get_state(self, arn: str) -> _AcceleratorState:
        state = self._accelerators.get(arn)
        if state is None:
            raise AWSAPIError(ERR_ACCELERATOR_NOT_FOUND, arn)
        return state

    def list_accelerators(self, max_results, next_token):
        with self._lock:
            self.calls.append(("ListAccelerators",))
            for arn in list(self._settling):
                state = self._accelerators.get(arn)
                if state is None:
                    self._settling.pop(arn, None)
                else:
                    self._settle(state)
            if self._accel_list_cache is None:
                self._accel_list_cache = [
                    s.accelerator for s in self._accelerators.values()
                ]
            return _paginate(self._accel_list_cache, max_results, next_token)

    def describe_accelerator(self, arn):
        with self._lock:
            self.calls.append(("DescribeAccelerator", arn))
            state = self._get_state(arn)
            self._settle(state)
            return state.accelerator

    def create_accelerator(self, name, ip_address_type, enabled, tags):
        _validate_accelerator_name(name)
        if ip_address_type not in _VALID_IP_ADDRESS_TYPES:
            raise AWSAPIError(
                ERR_INVALID_ARGUMENT, f"invalid IpAddressType {ip_address_type!r}"
            )
        with self._lock:
            if len(tags) > self.quota_tags_per_resource:
                raise AWSAPIError(
                    ERR_LIMIT_EXCEEDED,
                    f"{len(tags)} tags exceeds the {self.quota_tags_per_resource} "
                    "per-resource quota",
                )
            if len(self._accelerators) >= self.quota_accelerators:
                raise AWSAPIError(
                    ERR_LIMIT_EXCEEDED,
                    f"account quota of {self.quota_accelerators} accelerators reached",
                )
            # uuid5 over the serial counter, not uuid4: the ARN must be
            # re-derivable on incident replay (counter state travels in
            # the capture snapshot; random minting would diverge)
            arn = (
                f"arn:aws:globalaccelerator::{_ACCOUNT}:accelerator/"
                f"{uuid.uuid5(uuid.NAMESPACE_URL, f'agac/{_ACCOUNT}/{next(self._counter)}')}"
            )
            accelerator = Accelerator(
                accelerator_arn=arn,
                name=name,
                dns_name=f"a{next(self._counter):016x}.awsglobalaccelerator.com",
                enabled=enabled,
                status=(
                    ACCELERATOR_STATUS_IN_PROGRESS
                    if self.settle_describes
                    else ACCELERATOR_STATUS_DEPLOYED
                ),
                ip_address_type=ip_address_type,
            )
            self._accelerators[arn] = _AcceleratorState(
                accelerator, list(tags), self.settle_describes
            )
            self._accel_list_cache = None
            if self.settle_describes:
                self._settling[arn] = None
            self.calls.append(("CreateAccelerator", arn))
            return accelerator

    def update_accelerator(self, arn, name=None, enabled=None):
        if name is not None:
            _validate_accelerator_name(name)
        with self._lock:
            state = self._get_state(arn)
            changes = {}
            if name is not None:
                changes["name"] = name
            if enabled is not None:
                changes["enabled"] = enabled
            if self.settle_describes:
                changes["status"] = ACCELERATOR_STATUS_IN_PROGRESS
                state.pending_describes = self.settle_describes
                self._settling[arn] = None
            state.accelerator = replace(state.accelerator, **changes)
            self._accel_list_cache = None
            self.calls.append(("UpdateAccelerator", arn))
            return state.accelerator

    def delete_accelerator(self, arn):
        with self._lock:
            state = self._get_state(arn)
            if state.accelerator.enabled:
                raise AWSAPIError(
                    ERR_ACCELERATOR_NOT_DISABLED, "accelerator must be disabled"
                )
            if state.listeners:
                raise AWSAPIError(
                    ERR_ASSOCIATED_LISTENER_FOUND, "accelerator still has listeners"
                )
            del self._accelerators[arn]
            self._accel_list_cache = None
            self.calls.append(("DeleteAccelerator", arn))

    def list_tags_for_resource(self, arn):
        with self._lock:
            self.calls.append(("ListTagsForResource", arn))
            return list(self._get_state(arn).tags)

    def tag_resource(self, arn, tags):
        with self._lock:
            state = self._get_state(arn)
            merged = {t.key: t.value for t in state.tags}
            merged.update({t.key: t.value for t in tags})
            if len(merged) > self.quota_tags_per_resource:
                raise AWSAPIError(
                    ERR_LIMIT_EXCEEDED,
                    f"{len(merged)} tags exceeds the "
                    f"{self.quota_tags_per_resource} per-resource quota",
                )
            state.tags = [Tag(k, v) for k, v in merged.items()]
            self.calls.append(("TagResource", arn))

    def list_listeners(self, accelerator_arn, max_results, next_token):
        with self._lock:
            self.calls.append(("ListListeners", accelerator_arn))
            state = self._get_state(accelerator_arn)
            items = [
                Listener(
                    listener_arn=l.listener_arn,
                    protocol=l.protocol,
                    port_ranges=list(l.port_ranges),
                    client_affinity=l.client_affinity,
                )
                for l in state.listeners.values()
            ]
            return _paginate(items, max_results, next_token)

    def create_listener(self, accelerator_arn, port_ranges, protocol, client_affinity):
        _validate_listener_args(
            port_ranges, protocol, client_affinity,
            self.quota_port_ranges_per_listener,
        )
        with self._lock:
            state = self._get_state(accelerator_arn)
            if len(state.listeners) >= self.quota_listeners_per_accelerator:
                raise AWSAPIError(
                    ERR_LIMIT_EXCEEDED,
                    f"accelerator quota of {self.quota_listeners_per_accelerator} "
                    "listeners reached",
                )
            arn = f"{accelerator_arn}/listener/{next(self._counter):08x}"
            listener = Listener(
                listener_arn=arn,
                protocol=protocol,
                port_ranges=list(port_ranges),
                client_affinity=client_affinity,
            )
            state.listeners[arn] = listener
            self._listener_parent[arn] = accelerator_arn
            self.calls.append(("CreateListener", arn))
            return Listener(**{**vars(listener), "port_ranges": list(port_ranges)})

    def _get_listener(self, listener_arn: str) -> Listener:
        parent = self._listener_parent.get(listener_arn)
        if parent is None or parent not in self._accelerators:
            raise ListenerNotFoundException(listener_arn)
        return self._accelerators[parent].listeners[listener_arn]

    def update_listener(self, listener_arn, port_ranges, protocol, client_affinity):
        _validate_listener_args(
            port_ranges, protocol, client_affinity,
            self.quota_port_ranges_per_listener,
        )
        with self._lock:
            listener = self._get_listener(listener_arn)
            listener.port_ranges = list(port_ranges)
            listener.protocol = protocol
            listener.client_affinity = client_affinity
            self.calls.append(("UpdateListener", listener_arn))
            return Listener(**{**vars(listener), "port_ranges": list(port_ranges)})

    def delete_listener(self, arn):
        with self._lock:
            listener = self._get_listener(arn)
            if self._egs_by_listener.get(arn):
                raise AWSAPIError(
                    ERR_ASSOCIATED_ENDPOINT_GROUP_FOUND,
                    "listener still has endpoint groups",
                )
            parent = self._listener_parent.pop(arn)
            del self._accelerators[parent].listeners[arn]
            self.calls.append(("DeleteListener", arn))

    def list_endpoint_groups(self, listener_arn, max_results, next_token):
        with self._lock:
            self.calls.append(("ListEndpointGroups", listener_arn))
            self._get_listener(listener_arn)  # existence check
            items = [
                self._copy_eg(self._endpoint_groups[arn])
                for arn in self._egs_by_listener.get(listener_arn, ())
            ]
            return _paginate(items, max_results, next_token)

    @staticmethod
    def _copy_eg(eg: EndpointGroup) -> EndpointGroup:
        return EndpointGroup(
            endpoint_group_arn=eg.endpoint_group_arn,
            endpoint_group_region=eg.endpoint_group_region,
            endpoint_descriptions=[
                EndpointDescription(**vars(d)) for d in eg.endpoint_descriptions
            ],
        )

    def describe_endpoint_group(self, arn):
        with self._lock:
            self.calls.append(("DescribeEndpointGroup", arn))
            eg = self._endpoint_groups.get(arn)
            if eg is None:
                raise EndpointGroupNotFoundException(arn)
            return self._copy_eg(eg)

    def _validate_endpoint_configurations(self, configs) -> None:
        if len(configs) > self.quota_endpoints_per_group:
            raise AWSAPIError(
                ERR_LIMIT_EXCEEDED,
                f"{len(configs)} endpoints exceeds the "
                f"{self.quota_endpoints_per_group} per-group quota",
            )
        for config in configs:
            if not config.endpoint_id:
                raise AWSAPIError(ERR_INVALID_ARGUMENT, "EndpointId is required")
            if config.weight is not None and not (0 <= config.weight <= 255):
                raise AWSAPIError(
                    ERR_INVALID_ARGUMENT,
                    f"endpoint Weight {config.weight} outside 0-255",
                )

    def create_endpoint_group(self, listener_arn, endpoint_group_region, endpoint_configurations):
        if not endpoint_group_region:
            raise AWSAPIError(ERR_INVALID_ARGUMENT, "EndpointGroupRegion is required")
        self._validate_endpoint_configurations(endpoint_configurations)
        with self._lock:
            self._get_listener(listener_arn)
            groups_on_listener = len(self._egs_by_listener.get(listener_arn, ()))
            if groups_on_listener >= self.quota_endpoint_groups_per_listener:
                raise AWSAPIError(
                    ERR_LIMIT_EXCEEDED,
                    f"listener quota of {self.quota_endpoint_groups_per_listener} "
                    "endpoint groups reached",
                )
            arn = f"{listener_arn}/endpoint-group/{next(self._counter):08x}"
            eg = EndpointGroup(
                endpoint_group_arn=arn,
                endpoint_group_region=endpoint_group_region,
                endpoint_descriptions=[
                    EndpointDescription(
                        endpoint_id=c.endpoint_id,
                        weight=c.weight,
                        client_ip_preservation_enabled=c.client_ip_preservation_enabled,
                    )
                    for c in endpoint_configurations
                ],
            )
            self._endpoint_groups[arn] = eg
            self._eg_parent[arn] = listener_arn
            self._egs_by_listener.setdefault(listener_arn, {})[arn] = None
            self.calls.append(("CreateEndpointGroup", arn))
            return self._copy_eg(eg)

    def update_endpoint_group(self, arn, endpoint_configurations):
        """UpdateEndpointGroup treats the configuration list as the
        COMPLETE desired endpoint set (real AWS semantics) — callers
        updating one endpoint must send all of them."""
        self._validate_endpoint_configurations(endpoint_configurations)
        with self._lock:
            eg = self._endpoint_groups.get(arn)
            if eg is None:
                raise EndpointGroupNotFoundException(arn)
            eg.endpoint_descriptions = [
                EndpointDescription(
                    endpoint_id=c.endpoint_id,
                    weight=c.weight,
                    client_ip_preservation_enabled=c.client_ip_preservation_enabled,
                )
                for c in endpoint_configurations
            ]
            self.calls.append(("UpdateEndpointGroup", arn))
            return self._copy_eg(eg)

    def delete_endpoint_group(self, arn):
        with self._lock:
            if arn not in self._endpoint_groups:
                raise EndpointGroupNotFoundException(arn)
            del self._endpoint_groups[arn]
            parent = self._eg_parent.pop(arn)
            bucket = self._egs_by_listener.get(parent)
            if bucket is not None:
                bucket.pop(arn, None)
                if not bucket:
                    del self._egs_by_listener[parent]
            self.calls.append(("DeleteEndpointGroup", arn))

    def add_endpoints(self, arn, endpoint_configurations):
        self._validate_endpoint_configurations(endpoint_configurations)
        with self._lock:
            eg = self._endpoint_groups.get(arn)
            if eg is None:
                raise EndpointGroupNotFoundException(arn)
            new_ids = {c.endpoint_id for c in endpoint_configurations} - {
                d.endpoint_id for d in eg.endpoint_descriptions
            }
            if len(eg.endpoint_descriptions) + len(new_ids) > self.quota_endpoints_per_group:
                raise AWSAPIError(
                    ERR_LIMIT_EXCEEDED,
                    f"group quota of {self.quota_endpoints_per_group} endpoints reached",
                )
            added = []
            for c in endpoint_configurations:
                desc = EndpointDescription(
                    endpoint_id=c.endpoint_id,
                    weight=c.weight,
                    client_ip_preservation_enabled=c.client_ip_preservation_enabled,
                )
                existing = [d for d in eg.endpoint_descriptions if d.endpoint_id == c.endpoint_id]
                if existing:
                    existing[0].weight = c.weight
                    existing[0].client_ip_preservation_enabled = c.client_ip_preservation_enabled
                    added.append(existing[0])
                else:
                    eg.endpoint_descriptions.append(desc)
                    added.append(desc)
            self.calls.append(("AddEndpoints", arn))
            return [EndpointDescription(**vars(d)) for d in added]

    def remove_endpoints(self, arn, endpoint_ids):
        with self._lock:
            eg = self._endpoint_groups.get(arn)
            if eg is None:
                raise EndpointGroupNotFoundException(arn)
            eg.endpoint_descriptions = [
                d for d in eg.endpoint_descriptions if d.endpoint_id not in endpoint_ids
            ]
            self.calls.append(("RemoveEndpoints", arn))

    # ------------------------------------------------------------------
    # ELBv2API
    # ------------------------------------------------------------------
    def describe_load_balancers(self, names):
        with self._lock:
            # batch size in the log so the read-plane call-budget and
            # coalescer tests can assert wire-call counts AND widths
            self.calls.append(("DescribeLoadBalancers", len(names)))
            found = [
                LoadBalancer(**vars(self._load_balancers[n]))
                for n in names
                if n in self._load_balancers
            ]
            if not found:
                raise AWSAPIError(
                    ERR_LOAD_BALANCER_NOT_FOUND,
                    f"Load balancers '{names}' not found",
                )
            return found

    # ------------------------------------------------------------------
    # Route53API
    # ------------------------------------------------------------------
    @staticmethod
    def _wire_name(name: str) -> str:
        """Route53 stores names dot-terminated with ``*`` as ``\\052``."""
        if not name.endswith("."):
            name += "."
        return name.replace("*", "\\052", 1)

    def list_hosted_zones(self, max_items, marker):
        with self._lock:
            self.calls.append(("ListHostedZones",))
            zones = sorted(self._zones.values(), key=lambda z: z.name)
            return _paginate([HostedZone(**vars(z)) for z in zones], max_items, marker)

    def list_hosted_zones_by_name(self, dns_name, max_items):
        """Lexicographic from ``dns_name`` onward, like the real API."""
        if not dns_name.endswith("."):
            dns_name += "."
        with self._lock:
            self.calls.append(("ListHostedZonesByName", dns_name))
            # Route53 orders by reversed-label DNS name; plain name sort
            # is enough for the "does an exact zone exist" probe the
            # driver performs (reference route53.go:337-357).
            zones = sorted(self._zones.values(), key=lambda z: z.name)
            after = [HostedZone(**vars(z)) for z in zones if z.name >= dns_name]
            return after[:max_items]

    @staticmethod
    def _copy_rrs(r: ResourceRecordSet) -> ResourceRecordSet:
        from agac_tpu_torch.cloudprovider.aws.types import AliasTarget, ResourceRecord

        return ResourceRecordSet(
            name=r.name,
            type=r.type,
            ttl=r.ttl,
            resource_records=[ResourceRecord(rr.value) for rr in r.resource_records],
            alias_target=AliasTarget(**vars(r.alias_target)) if r.alias_target else None,
        )

    def list_resource_record_sets(self, hosted_zone_id, max_items, start_record_name):
        with self._lock:
            self.calls.append(("ListResourceRecordSets", hosted_zone_id))
            if hosted_zone_id not in self._zones:
                raise AWSAPIError(ERR_NO_SUCH_HOSTED_ZONE, hosted_zone_id)
            records = sorted(
                self._records[hosted_zone_id].values(), key=lambda r: (r.name, r.type)
            )
            items = [self._copy_rrs(r) for r in records]
            return _paginate(items, max_items, start_record_name)

    def change_resource_record_sets(self, hosted_zone_id, changes: list[Change]):
        if not changes:
            raise AWSAPIError(
                ERR_INVALID_CHANGE_BATCH, "change batch must not be empty"
            )
        if len(changes) > self.quota_changes_per_batch:
            raise AWSAPIError(
                ERR_INVALID_CHANGE_BATCH,
                f"{len(changes)} changes exceeds the "
                f"{self.quota_changes_per_batch} per-batch limit",
            )
        with self._lock:
            if hosted_zone_id not in self._zones:
                raise AWSAPIError(ERR_NO_SUCH_HOSTED_ZONE, hosted_zone_id)
            table = self._records[hosted_zone_id]
            # validate the whole batch first: Route53 batches are atomic
            for change in changes:
                record_set = change.record_set
                if record_set.type not in _VALID_RR_TYPES:
                    raise AWSAPIError(
                        ERR_INVALID_CHANGE_BATCH,
                        f"invalid record type {record_set.type!r}",
                    )
                if not record_set.name:
                    raise AWSAPIError(
                        ERR_INVALID_CHANGE_BATCH, "record name is required"
                    )
                if record_set.ttl is not None and not (0 <= record_set.ttl <= _MAX_TTL):
                    raise AWSAPIError(
                        ERR_INVALID_CHANGE_BATCH,
                        f"TTL {record_set.ttl} outside 0-{_MAX_TTL}",
                    )
                if record_set.alias_target is None and record_set.ttl is None:
                    # a non-alias record set must carry a TTL
                    raise AWSAPIError(
                        ERR_INVALID_CHANGE_BATCH,
                        f"record {record_set.name!r} has neither AliasTarget nor TTL",
                    )
            for change in changes:
                record = change.record_set
                key = (self._wire_name(record.name), record.type)
                if change.action == CHANGE_ACTION_CREATE and key in table:
                    raise AWSAPIError(
                        ERR_INVALID_CHANGE_BATCH,
                        f"record {key} already exists",
                    )
                if change.action == CHANGE_ACTION_DELETE and key not in table:
                    raise AWSAPIError(
                        ERR_INVALID_CHANGE_BATCH,
                        f"record {key} does not exist",
                    )
                if change.action not in (
                    CHANGE_ACTION_CREATE,
                    CHANGE_ACTION_DELETE,
                    CHANGE_ACTION_UPSERT,
                ):
                    raise AWSAPIError(ERR_INVALID_CHANGE_BATCH, change.action)
            for change in changes:
                record = self._copy_rrs(change.record_set)
                record.name = self._wire_name(record.name)
                if record.alias_target and not record.alias_target.dns_name.endswith("."):
                    # Route53 returns alias DNSNames dot-terminated
                    # regardless of how they were submitted
                    record.alias_target.dns_name += "."
                key = (record.name, record.type)
                if change.action == CHANGE_ACTION_DELETE:
                    del table[key]
                else:
                    table[key] = record
            self.calls.append(("ChangeResourceRecordSets", hosted_zone_id))

