"""ELB hostname reverse-engineering.

Capability parity with the reference's
``pkg/cloudprovider/aws/load_balancer.go:32-98``: the controllers only
have the LB hostname from Service/Ingress status, and must recover the
LB *name* (to DescribeLoadBalancers) and *region* (to build a regional
client) from it.  Four hostname shapes exist:

- public ALB:    ``<name>-<hash>.<region>.elb.amazonaws.com``
- internal ALB:  ``internal-<name>-<hash>.<region>.elb.amazonaws.com``
- public NLB:    ``<name>-<hash>.elb.<region>.amazonaws.com``
- internal NLB:  ``<name>-<hash>.elb.<region>.amazonaws.com``

(ALBs put the region *after* ``elb``; NLBs before — the regexes keyed
on that, reference ``load_balancer.go:33-34``.)  The unit-test table in
``load_balancer_test.go:9-50`` is the behavioral contract.
"""

from __future__ import annotations

import re

_ALB_SUFFIX = re.compile(r"\.elb\.amazonaws\.com$")
_NLB_SUFFIX = re.compile(r"\.elb\..+\.amazonaws\.com$")
_INTERNAL_PREFIX = re.compile(r"^internal-")
_INTERNAL_ALB_NAME = re.compile(r"^internal\-([\w\-]+)\-[\w]+$")
_NAME_WITH_HASH = re.compile(r"^([\w\-]+)\-[\w]+$")


def get_lb_name_from_hostname(hostname: str) -> tuple[str, str]:
    """Return (lb_name, region) parsed from an ELB hostname.

    Raises ValueError for hostnames that are not Elastic Load
    Balancers or do not parse.
    """
    if _ALB_SUFFIX.search(hostname):
        return _match_alb_hostname(hostname)
    if _NLB_SUFFIX.search(hostname):
        return _match_nlb_hostname(hostname)
    raise ValueError(f"{hostname} is not Elastic Load Balancer")


def _match_alb_hostname(hostname: str) -> tuple[str, str]:
    parts = hostname.split(".")
    subdomain, region = parts[0], parts[1]
    if _INTERNAL_PREFIX.search(subdomain):
        match = _INTERNAL_ALB_NAME.match(subdomain)
        if not match:
            raise ValueError(f"Failed to parse subdomain for internal ALB: {subdomain}")
        return match.group(1), region
    match = _NAME_WITH_HASH.match(subdomain)
    if not match:
        raise ValueError(f"Failed to parse subdomain for public ALB: {subdomain}")
    return match.group(1), region


def _match_nlb_hostname(hostname: str) -> tuple[str, str]:
    parts = hostname.split(".")
    subdomain, region = parts[0], parts[2]
    match = _NAME_WITH_HASH.match(subdomain)
    if not match:
        raise ValueError(f"Failed to parse subdomain for NLB: {subdomain}")
    return match.group(1), region


def get_region_from_arn(arn: str) -> str:
    """ARNs are ``arn:partition:service:region:account:resource``
    (reference ``load_balancer.go:95-98``)."""
    return arn.split(":")[3]
