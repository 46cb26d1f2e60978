"""Differential check of the port's main path end to end: a small
mixed fleet (20 Services, 2 ALB Ingresses, 2 EndpointGroupBindings,
``bench.py``'s shapes, built by ``chip_smoke.py``'s fleet helpers)
converges through each package's ``Manager`` on its own
``FakeCluster`` and ``FakeAWSBackend``, and the two worlds must agree.

Worker threads order the AWS calls differently from run to run, so
ARNs differ; the comparison is over canonical state, in which every
ARN is replaced by the key of the object that owns it: the chain per
owner (tags, listeners, endpoints), the Route53 records per zone and
the binding status.  The recorded events must be equal as a multiset
of (kind, namespace/name, reason)."""

from __future__ import annotations

import collections
import importlib

import pytest

N_SERVICES = 20
OWNER_TAG = "aws-global-accelerator-owner"


@pytest.fixture(scope="module")
def smoke():
    return importlib.import_module("chip_smoke")


def _converge(smoke, package):
    # the Route53 wait for a missing accelerator cut from 6 s, so the
    # small fleet converges in about a second
    fleet, _ = smoke.converge(smoke.load(package), N_SERVICES, accelerator_missing_retry=0.05)
    return fleet


def canonical_state(fleet) -> dict:
    snap = fleet.aws.snapshot_state()
    lb_name = {lb["load_balancer_arn"]: lb["load_balancer_name"] for lb in snap["load_balancers"]}
    bindings = {}
    for ns, name in fleet.binding_keys:
        binding = fleet.cluster.get("EndpointGroupBinding", ns, name)
        bindings[f"{ns}/{name}"] = (
            [lb_name.get(e, e) for e in binding.status.endpoint_ids],
            binding.status.observed_generation,
            sorted(binding.metadata.finalizers),
        )
    return {**canonical_aws(snap), "bindings": bindings}


def canonical_aws(snap: dict) -> dict:
    """A fake backend's ``snapshot_state()`` with every ARN replaced by
    its owner's key: the chains per owner and the records per zone."""
    lb_name = {lb["load_balancer_arn"]: lb["load_balancer_name"] for lb in snap["load_balancers"]}
    owner = {}
    by_dns = {}
    listener_owner = {}
    for entry in snap["accelerators"]:
        accel = entry["accelerator"]
        owner[accel["accelerator_arn"]] = dict(entry["tags"]).get(OWNER_TAG, accel["name"])
        by_dns[accel["dns_name"].rstrip(".")] = owner[accel["accelerator_arn"]]
        for listener in entry["listeners"]:
            listener_owner[listener["listener_arn"]] = owner[accel["accelerator_arn"]]
    groups = collections.defaultdict(list)
    for eg in snap["endpoint_groups"]:
        endpoints = sorted(
            tuple(sorted({**d, "endpoint_id": lb_name.get(d["endpoint_id"], d["endpoint_id"])}.items()))
            for d in eg["endpoints"]
        )
        groups[listener_owner[eg["parent"]]].append((eg["region"], endpoints))
    chains = collections.defaultdict(list)
    for entry in snap["accelerators"]:
        accel = entry["accelerator"]
        key = owner[accel["accelerator_arn"]]
        chains[key].append(
            (
                accel["name"],
                accel["enabled"],
                accel["status"],
                accel["ip_address_type"],
                tuple(sorted(map(tuple, entry["tags"]))),
                tuple(
                    sorted(
                        (l["protocol"], l["client_affinity"], tuple(map(tuple, l["port_ranges"])))
                        for l in entry["listeners"]
                    )
                ),
                tuple(sorted(groups[key])),
            )
        )
    zone_name = {z["id"]: z["name"] for z in snap["zones"]}
    records = {
        zone_name[zone_id]: sorted(
            (
                r["name"],
                r["type"],
                r["ttl"],
                tuple(r["values"]),
                None
                if r["alias"] is None
                else (by_dns.get(r["alias"]["dns_name"].rstrip("."), "?"), r["alias"]["hosted_zone_id"]),
            )
            for r in table
        )
        for zone_id, table in snap["records"].items()
    }
    return {"chains": {k: sorted(v) for k, v in chains.items()}, "records": records}


def event_multiset(fleet) -> collections.Counter:
    events, _ = fleet.cluster.list("Event")
    return collections.Counter(
        (
            e.involved_object.kind,
            f"{e.involved_object.namespace}/{e.involved_object.name}",
            e.reason,
        )
        for e in events
    )


@pytest.fixture(scope="module")
def threads_before():
    """The threads alive before this module's Managers start: a test
    file run earlier in the same process may leave its own behind."""
    import threading

    return set(threading.enumerate())


@pytest.fixture(scope="module")
def worlds(smoke, threads_before):
    return _converge(smoke, "agac_tpu"), _converge(smoke, "agac_tpu_torch")


def test_both_managers_converge_the_fleet(worlds):
    for fleet in worlds:
        assert fleet.converged()
        chains, records, bound = fleet.progress()
        assert records == 2 * (N_SERVICES + fleet.n_ing)
        assert bound == fleet.n_egb == 2


def test_canonical_state_is_equal(worlds):
    ref, port = (canonical_state(fleet) for fleet in worlds)
    # the fleet's controllers own one chain per Service and Ingress,
    # besides the binding targets' out-of-band chains
    assert len(ref["chains"]) == N_SERVICES + 2 + 2
    assert all(len(chain) == 1 for chain in ref["chains"].values())
    assert port["chains"] == ref["chains"]
    assert port["records"] == ref["records"]
    assert port["bindings"] == ref["bindings"]


def test_event_multisets_are_equal(worlds):
    ref, port = (event_multiset(fleet) for fleet in worlds)
    reasons = collections.Counter(reason for _, _, reason in ref.elements())
    assert reasons["GlobalAcceleratorCreated"] == N_SERVICES + 2
    assert port == ref


def test_managers_leave_no_thread_running(worlds, threads_before):
    """``converge`` stops each Manager and joins what it started."""
    import threading

    leftover = [
        t.name
        for t in set(threading.enumerate()) - threads_before
        if "-worker-" in t.name or t.name.endswith("-controller")
    ]
    assert leftover == []
