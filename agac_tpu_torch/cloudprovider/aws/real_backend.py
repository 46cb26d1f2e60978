"""Real AWS service clients over stdlib HTTP with SigV4 signing.

The production counterpart of ``FakeAWSBackend``, implementing the
same three API interfaces the drivers consume — the analog of the
aws-sdk-go-v2 clients the reference constructs
(``pkg/cloudprovider/aws/aws.go:12-38``).  Three wire protocols:

- **Global Accelerator**: AWS JSON 1.1 (``X-Amz-Target:
  GlobalAccelerator_V20180706.<Op>``), global endpoint in us-west-2 —
  the same pinning as the reference (``aws.go:26-28``);
- **ELBv2**: Query protocol (form-encoded ``Action=...``), XML
  responses, regional endpoints;
- **Route53**: REST XML on the global endpoint (signed as us-east-1).

Transport is injectable for tests; error bodies are mapped onto
``AWSAPIError`` with the service error code so the drivers' code-based
branching (``EndpointGroupNotFoundException`` etc.) works identically
against fake and real backends.
"""

from __future__ import annotations

import json
import random
import time
import threading
import uuid
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Callable, Optional

from ... import klog

from .api import ELBv2API, GlobalAcceleratorAPI, Route53API
from .errors import (
    AWSAPIError,
    ERR_ENDPOINT_GROUP_NOT_FOUND,
    ERR_LISTENER_NOT_FOUND,
    EndpointGroupNotFoundException,
    ListenerNotFoundException,
)
from .health import (
    OUTCOME_CONNECTION_ERROR,
    OUTCOME_SERVER_ERROR,
    OUTCOME_THROTTLE,
    THROTTLE_CODES,
    DeadlineExceeded,
    deadline_remaining,
)
from .sigv4 import Credentials, CredentialProvider, sign_request, xml_strip_ns
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

GA_ENDPOINT_REGION = "us-west-2"  # Global Accelerator is a global service
GA_TARGET_PREFIX = "GlobalAccelerator_V20180706"
ELBV2_API_VERSION = "2015-12-01"
ROUTE53_API_VERSION = "2013-04-01"

Transport = Callable[[str, str, dict, Optional[bytes], float], tuple[int, bytes]]


def _default_transport(method, url, headers, body, timeout) -> tuple[int, bytes]:
    request = urllib.request.Request(url, data=body, headers=headers, method=method)
    try:
        with urllib.request.urlopen(request, timeout=timeout) as response:
            return response.status, response.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


# The aws-sdk-go-v2 clients the reference constructs retry transiently
# failed calls before the error ever reaches the reconcile loop
# ("standard" retry mode: 3 attempts, exponential backoff with full
# jitter).  Same semantics here, at the one choke point every wire
# protocol shares.
RETRY_ATTEMPTS = 3
RETRY_BASE_DELAY = 0.2
RETRY_MAX_DELAY = 5.0
_RETRYABLE_STATUSES = {429, 500, 502, 503, 504}
# service error codes retryable regardless of HTTP status — the SDK's
# transient/throttling taxonomy (GA/ELBv2 throttles arrive as 400s;
# PriorRequestNotComplete is Route53's).  Compared EXACTLY against the
# parsed service code, never substring-matched against the body (an
# InvalidChangeBatch message echoing a record value that happens to
# contain "Throttling" must not be retried).
RETRYABLE_CODES = frozenset(
    {
        "Throttling",
        "ThrottlingException",
        "ThrottledException",
        "TooManyRequestsException",
        "RequestThrottled",
        "RequestThrottledException",
        "RequestLimitExceeded",
        "SlowDown",
        "ServiceUnavailable",
        "ServiceUnavailableException",
        "RequestTimeout",
        "RequestTimeoutException",
        "PriorRequestNotComplete",
        "TransientFailure",
        "InternalFailure",
        "InternalServiceError",
        "InternalServiceErrorException",
    }
)


# Exception classes a malformed (truncated, garbage, wrong-protocol)
# response body can raise out of json/ElementTree parsing or the
# shape-mapping code below.  Every parse is wrapped so these surface
# as a diagnosable AWSAPIError naming the operation — never a raw
# ParseError/KeyError traceback into the reconcile loop, which would
# be retried as an anonymous error forever.  The analog of
# aws-sdk-go-v2's DeserializationError wrapping, which the reference
# gets from the SDK (go.mod:8-13).
_MALFORMED = (AttributeError, TypeError, ValueError, KeyError, IndexError)


def _deserialization_error(operation: str, why, body: bytes) -> AWSAPIError:
    return AWSAPIError(
        "DeserializationError",
        f"{operation}: malformed response from service ({why}); "
        f"body[:200]={body[:200].decode(errors='replace')!r}",
    )


def _ga_error_code(body: bytes) -> str:
    """Service code from an AWS JSON-1.1 error body (``__type``)."""
    try:
        payload = json.loads(body)
        raw = payload.get("__type") or payload.get("code") or ""
        return raw.split("#")[-1]
    except Exception:
        return ""


def _xml_error_code(body: bytes) -> str:
    """Service code from a Query/REST-XML error body (``<Code>``)."""
    try:
        root = xml_strip_ns(ET.fromstring(body))
        return root.findtext(".//Code") or ""
    except ET.ParseError:
        return ""


class _SignedClient:
    def __init__(
        self,
        service: str,
        region: str,
        endpoint: str,
        credentials=None,
        transport: Optional[Transport] = None,
        timeout: float = 30.0,
        attempts: int = RETRY_ATTEMPTS,
        sleep: Optional[Callable[[float], None]] = None,
        error_code_parser: Callable[[bytes], str] = _xml_error_code,
    ):
        self.service = service
        self.region = region
        self.endpoint = endpoint.rstrip("/")
        if credentials is None:
            self._provider = CredentialProvider()
        elif isinstance(credentials, Credentials):
            self._provider = CredentialProvider(static=credentials)
        else:  # already a provider
            self._provider = credentials
        self._transport = transport or _default_transport
        self._timeout = timeout
        self._attempts = max(1, attempts)
        self._sleep = sleep if sleep is not None else time.sleep
        self._error_code = error_code_parser
        # health-plane seam: called with an outcome classification for
        # every RETRIED attempt (throttle / server-error / connection-
        # error).  The guard layer above the API objects only sees the
        # final result, so without this hook a brownout the in-client
        # retries keep absorbing would be invisible to the AIMD
        # limiter until it overflowed the attempt budget.
        self.on_outcome: Optional[Callable[[str], None]] = None

    def _retryable(self, status: int, body: bytes) -> bool:
        if status in _RETRYABLE_STATUSES:
            return True
        return status >= 400 and self._error_code(body) in RETRYABLE_CODES

    def _report(self, outcome: str) -> None:
        if self.on_outcome is not None:
            try:
                self.on_outcome(outcome)
            except Exception as err:  # observability must not fail the call
                klog.errorf("health outcome hook failed: %s", err)

    def _attempt_outcome(self, status: int, body: bytes) -> str:
        code = self._error_code(body)
        if status == 429 or code in THROTTLE_CODES:
            return OUTCOME_THROTTLE
        return OUTCOME_SERVER_ERROR

    def request(
        self, method: str, path: str, headers: dict[str, str], body: bytes
    ) -> tuple[int, bytes]:
        url = f"{self.endpoint}{path}"
        last_exc: Optional[Exception] = None
        for attempt in range(self._attempts):
            if attempt:
                # full jitter keeps a fleet of workers from thundering
                backoff = random.uniform(
                    0, min(RETRY_MAX_DELAY, RETRY_BASE_DELAY * (2 ** attempt))
                )
                # the retry checks the reconcile deadline (health
                # plane): no point burning a backoff sleep plus another
                # attempt the caller can no longer use — surface the
                # retryable deadline error and free the worker
                remaining = deadline_remaining()
                if remaining is not None and remaining <= backoff:
                    raise DeadlineExceeded(
                        f"{method} {path}: reconcile deadline expired "
                        f"before retry {attempt + 1}/{self._attempts}"
                    )
                self._sleep(backoff)
            # re-sign every attempt: fresh timestamp, and the provider
            # refreshes expiring session credentials (IRSA) transparently
            signed = sign_request(
                method, url, headers, body, self.service, self.region,
                self._provider.get(),
            )
            try:
                status, payload = self._transport(
                    method, url, signed, body or None, self._timeout
                )
            except (urllib.error.URLError, OSError) as err:
                # connection refused/reset, DNS failure, socket timeout.
                # Re-sending after a possible commit is safe everywhere:
                # GA creates carry an IdempotencyToken (below); updates,
                # tag merges and record UPSERTs are idempotent; deletes
                # re-sent after a commit surface NotFound, which every
                # driver path already treats as absence; the rest are
                # reads.
                last_exc = err
                self._report(OUTCOME_CONNECTION_ERROR)
                klog.v(2).infof(
                    "retrying %s %s after connection error (%s, attempt %d/%d)",
                    method, path, err, attempt + 1, self._attempts,
                )
                continue
            if attempt + 1 < self._attempts and self._retryable(status, payload):
                self._report(self._attempt_outcome(status, payload))
                klog.v(2).infof(
                    "retrying %s %s after HTTP %d (attempt %d/%d)",
                    method, path, status, attempt + 1, self._attempts,
                )
                continue
            return status, payload
        raise AWSAPIError(
            "RequestError", f"{method} {url} failed after {self._attempts} attempts: {last_exc}"
        )


# ---------------------------------------------------------------------------
# Global Accelerator (AWS JSON 1.1)
# ---------------------------------------------------------------------------


def _ga_error(operation: str, status: int, body: bytes) -> AWSAPIError:
    code = _ga_error_code(body) or "UnknownError"
    try:
        payload = json.loads(body)
        if not isinstance(payload, dict):
            raise ValueError("not an object")
        message = payload.get("message") or payload.get("Message") or ""
    except Exception:
        # half-written/garbage error envelope: still a typed error
        # naming the operation, with the body excerpt for diagnosis
        message = body[:200].decode(errors="replace")
    # the typed not-found returns carry the same operation prefix as
    # every other GA error — anonymous messages made those two error
    # classes the only undiagnosable ones (ADVICE r5 #4)
    prefixed = f"{operation}: {message or f'HTTP {status}'}"
    if code == ERR_LISTENER_NOT_FOUND:
        return ListenerNotFoundException(prefixed)
    if code == ERR_ENDPOINT_GROUP_NOT_FOUND:
        return EndpointGroupNotFoundException(prefixed)
    return AWSAPIError(code, prefixed)


def _accelerator_from_json(data: dict) -> Accelerator:
    return Accelerator(
        accelerator_arn=data.get("AcceleratorArn", ""),
        name=data.get("Name", ""),
        dns_name=data.get("DnsName", ""),
        enabled=bool(data.get("Enabled", False)),
        status=data.get("Status", ""),
        ip_address_type=data.get("IpAddressType", "IPV4"),
    )


def _listener_from_json(data: dict) -> Listener:
    return Listener(
        listener_arn=data.get("ListenerArn", ""),
        protocol=data.get("Protocol", "TCP"),
        port_ranges=[
            PortRange(p.get("FromPort", 0), p.get("ToPort", 0))
            for p in data.get("PortRanges", [])
        ],
        client_affinity=data.get("ClientAffinity", "NONE"),
    )


def _endpoint_group_from_json(data: dict) -> EndpointGroup:
    return EndpointGroup(
        endpoint_group_arn=data.get("EndpointGroupArn", ""),
        endpoint_group_region=data.get("EndpointGroupRegion", ""),
        endpoint_descriptions=[
            EndpointDescription(
                endpoint_id=d.get("EndpointId", ""),
                weight=d.get("Weight"),
                client_ip_preservation_enabled=bool(
                    d.get("ClientIPPreservationEnabled", False)
                ),
            )
            for d in data.get("EndpointDescriptions", [])
        ],
    )


def _endpoint_configurations_json(configs: list[EndpointConfiguration]) -> list[dict]:
    out = []
    for c in configs:
        entry: dict = {
            "EndpointId": c.endpoint_id,
            "ClientIPPreservationEnabled": c.client_ip_preservation_enabled,
        }
        if c.weight is not None:
            entry["Weight"] = c.weight
        out.append(entry)
    return out


class RealGlobalAcceleratorAPI(GlobalAcceleratorAPI):
    def __init__(
        self, credentials=None, transport=None, endpoint=None,
        attempts=RETRY_ATTEMPTS, sleep=None,
    ):
        self._client = _SignedClient(
            "globalaccelerator",
            GA_ENDPOINT_REGION,
            endpoint or f"https://globalaccelerator.{GA_ENDPOINT_REGION}.amazonaws.com",
            credentials,
            transport,
            attempts=attempts,
            sleep=sleep,
            error_code_parser=_ga_error_code,
        )

    def set_outcome_hook(self, hook) -> None:
        """Feed per-retry outcome classifications to the health plane."""
        self._client.on_outcome = hook

    def _call(self, operation: str, payload: dict, parse=None):
        """POST one JSON-1.1 operation.  ``parse`` maps the decoded
        response dict to the return value; any malformed body — not
        JSON, not an object, or a shape the mapper chokes on — raises
        ``AWSAPIError("DeserializationError")`` naming the operation."""
        body = json.dumps(payload).encode()
        status, response = self._client.request(
            "POST",
            "/",
            {
                "Content-Type": "application/x-amz-json-1.1",
                "X-Amz-Target": f"{GA_TARGET_PREFIX}.{operation}",
            },
            body,
        )
        if status >= 300:
            raise _ga_error(operation, status, response)
        try:
            data = json.loads(response) if response else {}
        except ValueError as err:
            raise _deserialization_error(operation, err, response) from err
        if not isinstance(data, dict):
            raise _deserialization_error(
                operation, f"expected JSON object, got {type(data).__name__}", response
            )
        if parse is None:
            return data
        try:
            return parse(data)
        except _MALFORMED as err:
            raise _deserialization_error(operation, repr(err), response) from err

    # accelerators
    def list_accelerators(self, max_results, next_token):
        payload: dict = {"MaxResults": max_results}
        if next_token:
            payload["NextToken"] = next_token
        return self._call(
            "ListAccelerators",
            payload,
            parse=lambda data: (
                [_accelerator_from_json(a) for a in data.get("Accelerators", [])],
                data.get("NextToken"),
            ),
        )

    def describe_accelerator(self, arn):
        return self._call(
            "DescribeAccelerator",
            {"AcceleratorArn": arn},
            parse=lambda data: _accelerator_from_json(data.get("Accelerator", {})),
        )

    def create_accelerator(self, name, ip_address_type, enabled, tags):
        return self._call(
            "CreateAccelerator",
            {
                "Name": name,
                "IpAddressType": ip_address_type,
                "Enabled": enabled,
                "Tags": [{"Key": t.key, "Value": t.value} for t in tags],
                # one token per logical create, shared by retries: a
                # re-sent request after a timeout-after-commit returns
                # the original resource instead of minting a duplicate
                # (the SDK auto-fills this field for the reference)
                "IdempotencyToken": uuid.uuid4().hex,
            },
            parse=lambda data: _accelerator_from_json(data.get("Accelerator", {})),
        )

    def update_accelerator(self, arn, name=None, enabled=None):
        payload: dict = {"AcceleratorArn": arn}
        if name is not None:
            payload["Name"] = name
        if enabled is not None:
            payload["Enabled"] = enabled
        return self._call(
            "UpdateAccelerator",
            payload,
            parse=lambda data: _accelerator_from_json(data.get("Accelerator", {})),
        )

    def delete_accelerator(self, arn):
        self._call("DeleteAccelerator", {"AcceleratorArn": arn})

    def list_tags_for_resource(self, arn):
        return self._call(
            "ListTagsForResource",
            {"ResourceArn": arn},
            parse=lambda data: [
                Tag(t.get("Key", ""), t.get("Value", "")) for t in data.get("Tags", [])
            ],
        )

    def tag_resource(self, arn, tags):
        self._call(
            "TagResource",
            {
                "ResourceArn": arn,
                "Tags": [{"Key": t.key, "Value": t.value} for t in tags],
            },
        )

    # listeners
    def list_listeners(self, accelerator_arn, max_results, next_token):
        payload: dict = {"AcceleratorArn": accelerator_arn, "MaxResults": max_results}
        if next_token:
            payload["NextToken"] = next_token
        return self._call(
            "ListListeners",
            payload,
            parse=lambda data: (
                [_listener_from_json(l) for l in data.get("Listeners", [])],
                data.get("NextToken"),
            ),
        )

    def create_listener(self, accelerator_arn, port_ranges, protocol, client_affinity):
        return self._call(
            "CreateListener",
            {
                "AcceleratorArn": accelerator_arn,
                "PortRanges": [
                    {"FromPort": p.from_port, "ToPort": p.to_port} for p in port_ranges
                ],
                "Protocol": protocol,
                "ClientAffinity": client_affinity,
                "IdempotencyToken": uuid.uuid4().hex,
            },
            parse=lambda data: _listener_from_json(data.get("Listener", {})),
        )

    def update_listener(self, listener_arn, port_ranges, protocol, client_affinity):
        return self._call(
            "UpdateListener",
            {
                "ListenerArn": listener_arn,
                "PortRanges": [
                    {"FromPort": p.from_port, "ToPort": p.to_port} for p in port_ranges
                ],
                "Protocol": protocol,
                "ClientAffinity": client_affinity,
            },
            parse=lambda data: _listener_from_json(data.get("Listener", {})),
        )

    def delete_listener(self, arn):
        self._call("DeleteListener", {"ListenerArn": arn})

    # endpoint groups
    def list_endpoint_groups(self, listener_arn, max_results, next_token):
        payload: dict = {"ListenerArn": listener_arn, "MaxResults": max_results}
        if next_token:
            payload["NextToken"] = next_token
        return self._call(
            "ListEndpointGroups",
            payload,
            parse=lambda data: (
                [_endpoint_group_from_json(g) for g in data.get("EndpointGroups", [])],
                data.get("NextToken"),
            ),
        )

    def describe_endpoint_group(self, arn):
        return self._call(
            "DescribeEndpointGroup",
            {"EndpointGroupArn": arn},
            parse=lambda data: _endpoint_group_from_json(data.get("EndpointGroup", {})),
        )

    def create_endpoint_group(self, listener_arn, endpoint_group_region, endpoint_configurations):
        return self._call(
            "CreateEndpointGroup",
            {
                "ListenerArn": listener_arn,
                "EndpointGroupRegion": endpoint_group_region,
                "EndpointConfigurations": _endpoint_configurations_json(
                    endpoint_configurations
                ),
                "IdempotencyToken": uuid.uuid4().hex,
            },
            parse=lambda data: _endpoint_group_from_json(data.get("EndpointGroup", {})),
        )

    def update_endpoint_group(self, arn, endpoint_configurations):
        return self._call(
            "UpdateEndpointGroup",
            {
                "EndpointGroupArn": arn,
                "EndpointConfigurations": _endpoint_configurations_json(
                    endpoint_configurations
                ),
            },
            parse=lambda data: _endpoint_group_from_json(data.get("EndpointGroup", {})),
        )

    def delete_endpoint_group(self, arn):
        self._call("DeleteEndpointGroup", {"EndpointGroupArn": arn})

    def add_endpoints(self, arn, endpoint_configurations):
        return self._call(
            "AddEndpoints",
            {
                "EndpointGroupArn": arn,
                "EndpointConfigurations": _endpoint_configurations_json(
                    endpoint_configurations
                ),
            },
            parse=lambda data: [
                EndpointDescription(
                    endpoint_id=d.get("EndpointId", ""),
                    weight=d.get("Weight"),
                    client_ip_preservation_enabled=bool(
                        d.get("ClientIPPreservationEnabled", False)
                    ),
                )
                for d in data.get("EndpointDescriptions", [])
            ],
        )

    def remove_endpoints(self, arn, endpoint_ids):
        self._call(
            "RemoveEndpoints",
            {
                "EndpointGroupArn": arn,
                "EndpointIdentifiers": [
                    {"EndpointId": endpoint_id} for endpoint_id in endpoint_ids
                ],
            },
        )


# ---------------------------------------------------------------------------
# ELBv2 (Query protocol, XML)
# ---------------------------------------------------------------------------


def _xml_error(operation: str, status: int, body: bytes) -> AWSAPIError:
    try:
        root = xml_strip_ns(ET.fromstring(body))
    except ET.ParseError:
        # half-written/garbage error envelope: still a typed error
        # naming the operation, with the body excerpt for diagnosis
        return AWSAPIError(
            "UnknownError",
            f"{operation}: HTTP {status} with unparseable body: "
            f"{body[:200].decode(errors='replace')!r}",
        )
    return AWSAPIError(
        root.findtext(".//Code") or "UnknownError",
        f"{operation}: {root.findtext('.//Message') or f'HTTP {status}'}",
    )


def _parse_xml_response(operation: str, expected_root: str, body: bytes) -> ET.Element:
    """Parse a 2xx XML response body, validating the document is the
    operation's response document.  The root-tag check matters: an
    HTML error page or wrong-protocol body often still parses as XML,
    and without it ``findall`` would quietly return nothing — absence
    where the truth is 'the response was garbage'."""
    try:
        root = xml_strip_ns(ET.fromstring(body))
    except ET.ParseError as err:
        raise _deserialization_error(operation, err, body) from err
    if root.tag != expected_root:
        raise _deserialization_error(
            operation, f"expected <{expected_root}>, got <{root.tag}>", body
        )
    return root


class RealELBv2API(ELBv2API):
    def __init__(
        self, region: str, credentials=None, transport=None, endpoint=None,
        attempts=RETRY_ATTEMPTS, sleep=None,
    ):
        self._client = _SignedClient(
            "elasticloadbalancing",
            region,
            endpoint or f"https://elasticloadbalancing.{region}.amazonaws.com",
            credentials,
            transport,
            attempts=attempts,
            sleep=sleep,
        )

    def set_outcome_hook(self, hook) -> None:
        """Feed per-retry outcome classifications to the health plane."""
        self._client.on_outcome = hook

    # DescribeLoadBalancers accepts at most 20 names per request
    # (ELBv2 API reference); the read plane's coalescer batches up to
    # exactly this, but a direct caller with a wider list must not get
    # a ValidationError — chunk and concatenate.
    MAX_NAMES_PER_CALL = 20

    def describe_load_balancers(self, names):
        if len(names) > self.MAX_NAMES_PER_CALL:
            found = []
            for i in range(0, len(names), self.MAX_NAMES_PER_CALL):
                found.extend(
                    self.describe_load_balancers(
                        names[i : i + self.MAX_NAMES_PER_CALL]
                    )
                )
            return found
        params = {"Action": "DescribeLoadBalancers", "Version": ELBV2_API_VERSION}
        for i, name in enumerate(names, start=1):
            params[f"Names.member.{i}"] = name
        body = urllib.parse.urlencode(params).encode()
        status, response = self._client.request(
            "POST",
            "/",
            {"Content-Type": "application/x-www-form-urlencoded"},
            body,
        )
        if status >= 300:
            raise _xml_error("DescribeLoadBalancers", status, response)
        root = _parse_xml_response(
            "DescribeLoadBalancers", "DescribeLoadBalancersResponse", response
        )
        try:
            return [
                LoadBalancer(
                    load_balancer_arn=member.findtext("LoadBalancerArn", ""),
                    load_balancer_name=member.findtext("LoadBalancerName", ""),
                    dns_name=member.findtext("DNSName", ""),
                    state_code=member.findtext("State/Code", ""),
                    type=member.findtext("Type", ""),
                    scheme=member.findtext("Scheme", ""),
                )
                for member in root.findall(".//LoadBalancers/member")
            ]
        except _MALFORMED as err:
            raise _deserialization_error(
                "DescribeLoadBalancers", repr(err), response
            ) from err


# ---------------------------------------------------------------------------
# Route53 (REST XML)
# ---------------------------------------------------------------------------

_R53_NS = "https://route53.amazonaws.com/doc/2013-04-01/"


def _record_set_to_xml(record: ResourceRecordSet) -> ET.Element:
    rrs = ET.Element("ResourceRecordSet")
    ET.SubElement(rrs, "Name").text = record.name
    ET.SubElement(rrs, "Type").text = record.type
    if record.alias_target is not None:
        alias = ET.SubElement(rrs, "AliasTarget")
        ET.SubElement(alias, "HostedZoneId").text = record.alias_target.hosted_zone_id
        ET.SubElement(alias, "DNSName").text = record.alias_target.dns_name
        ET.SubElement(alias, "EvaluateTargetHealth").text = (
            "true" if record.alias_target.evaluate_target_health else "false"
        )
    if record.ttl is not None:
        ET.SubElement(rrs, "TTL").text = str(record.ttl)
    if record.resource_records:
        records = ET.SubElement(rrs, "ResourceRecords")
        for rr in record.resource_records:
            ET.SubElement(
                ET.SubElement(records, "ResourceRecord"), "Value"
            ).text = rr.value
    return rrs


def _record_set_from_xml(element: ET.Element) -> ResourceRecordSet:
    alias = element.find("AliasTarget")
    ttl = element.findtext("TTL")
    return ResourceRecordSet(
        name=element.findtext("Name", ""),
        type=element.findtext("Type", ""),
        ttl=int(ttl) if ttl else None,
        resource_records=[
            ResourceRecord(value.findtext("Value", ""))
            for value in element.findall("ResourceRecords/ResourceRecord")
        ],
        alias_target=(
            AliasTarget(
                dns_name=alias.findtext("DNSName", ""),
                evaluate_target_health=alias.findtext("EvaluateTargetHealth") == "true",
                hosted_zone_id=alias.findtext("HostedZoneId", ""),
            )
            if alias is not None
            else None
        ),
    )


class RealRoute53API(Route53API):
    def __init__(
        self, credentials=None, transport=None, endpoint=None,
        attempts=RETRY_ATTEMPTS, sleep=None,
    ):
        # Route53 is global; requests are signed against us-east-1
        self._client = _SignedClient(
            "route53",
            "us-east-1",
            endpoint or "https://route53.amazonaws.com",
            credentials,
            transport,
            attempts=attempts,
            sleep=sleep,
        )

    def set_outcome_hook(self, hook) -> None:
        """Feed per-retry outcome classifications to the health plane."""
        self._client.on_outcome = hook

    def _get(self, operation: str, expected_root: str, path: str) -> ET.Element:
        status, response = self._client.request("GET", path, {}, b"")
        if status >= 300:
            raise _xml_error(operation, status, response)
        return _parse_xml_response(operation, expected_root, response)

    @staticmethod
    def _zone_from_xml(element: ET.Element) -> HostedZone:
        return HostedZone(
            id=element.findtext("Id", ""), name=element.findtext("Name", "")
        )

    def list_hosted_zones(self, max_items, marker):
        query = {"maxitems": str(max_items)}
        if marker:
            query["marker"] = marker
        root = self._get(
            "ListHostedZones",
            "ListHostedZonesResponse",
            f"/{ROUTE53_API_VERSION}/hostedzone?{urllib.parse.urlencode(query)}",
        )
        zones = [
            self._zone_from_xml(z) for z in root.findall(".//HostedZones/HostedZone")
        ]
        next_marker = root.findtext("NextMarker")
        return zones, next_marker

    def list_hosted_zones_by_name(self, dns_name, max_items):
        query = urllib.parse.urlencode({"dnsname": dns_name, "maxitems": str(max_items)})
        root = self._get(
            "ListHostedZonesByName",
            "ListHostedZonesByNameResponse",
            f"/{ROUTE53_API_VERSION}/hostedzonesbyname?{query}",
        )
        return [
            self._zone_from_xml(z) for z in root.findall(".//HostedZones/HostedZone")
        ]

    def list_resource_record_sets(self, hosted_zone_id, max_items, start_record_name):
        zone = hosted_zone_id.split("/")[-1]
        query = {"maxitems": str(max_items)}
        if start_record_name:
            query["name"] = start_record_name
        root = self._get(
            "ListResourceRecordSets",
            "ListResourceRecordSetsResponse",
            f"/{ROUTE53_API_VERSION}/hostedzone/{zone}/rrset?{urllib.parse.urlencode(query)}",
        )
        try:
            records = [
                _record_set_from_xml(r)
                for r in root.findall(".//ResourceRecordSets/ResourceRecordSet")
            ]
        except _MALFORMED as err:
            # e.g. a non-numeric TTL: typed, named, never a raw
            # ValueError into the reconcile loop
            raise _deserialization_error(
                "ListResourceRecordSets", repr(err), ET.tostring(root)
            ) from err
        next_name = root.findtext("NextRecordName")
        is_truncated = root.findtext("IsTruncated") == "true"
        return records, (next_name if is_truncated else None)

    def change_resource_record_sets(self, hosted_zone_id, changes: list[Change]):
        zone = hosted_zone_id.split("/")[-1]
        request = ET.Element("ChangeResourceRecordSetsRequest", xmlns=_R53_NS)
        batch = ET.SubElement(request, "ChangeBatch")
        changes_el = ET.SubElement(batch, "Changes")
        for change in changes:
            change_el = ET.SubElement(changes_el, "Change")
            ET.SubElement(change_el, "Action").text = change.action
            change_el.append(_record_set_to_xml(change.record_set))
        body = ET.tostring(request, encoding="utf-8", xml_declaration=True)
        status, response = self._client.request(
            "POST",
            f"/{ROUTE53_API_VERSION}/hostedzone/{zone}/rrset",
            {"Content-Type": "application/xml"},
            body,
        )
        if status >= 300:
            raise _xml_error("ChangeResourceRecordSets", status, response)


_process_provider: Optional[CredentialProvider] = None
_provider_lock = threading.Lock()


def _shared_credential_provider() -> CredentialProvider:
    """ONE provider for the whole process.  `from_environment` runs
    per reconcile (the reference's `NewAWS(region)`-per-item shape);
    a fresh provider each time would redo credential resolution —
    under IRSA that is an STS AssumeRoleWithWebIdentity round trip per
    work item, pure latency plus an STS throttling risk at fleet
    scale.  The provider caches until expiry and refreshes itself, so
    sharing is exactly what it is built for."""
    global _process_provider
    with _provider_lock:
        if _process_provider is None:
            _process_provider = CredentialProvider()
        return _process_provider


@dataclass
class RealAWSClients:
    ga: RealGlobalAcceleratorAPI
    elbv2: RealELBv2API
    route53: RealRoute53API

    @classmethod
    def from_environment(cls, region: str) -> "RealAWSClients":
        provider = _shared_credential_provider()
        return cls(
            ga=RealGlobalAcceleratorAPI(provider),
            elbv2=RealELBv2API(region, provider),
            route53=RealRoute53API(provider),
        )
