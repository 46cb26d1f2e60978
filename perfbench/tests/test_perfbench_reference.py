"""The plain reference against tiny worlds built by hand, in the frozen
in-memory AWS and API server, read back by the benchmark's reader."""

from __future__ import annotations

import ast
import copy
import pathlib

import pytest

from perfbench import reference
from perfbench.world import fake_aws, population as pop, read
from perfbench.world.fake_cluster import FakeCluster

HERITAGE = '"heritage=aws-global-accelerator-controller,cluster=default,{}"'


def tiny_record() -> dict:
    population = pop.Population({"zones": 2}, "default")
    record = population.record(2, 2, 1)
    return record


def build(record: dict, weight_of_binding: int | None = None) -> read.InMemoryReader:
    """The world a correct controller leaves for ``record``, made by hand
    through the frozen fake's API."""
    from agac_tpu_torch.cloudprovider.aws import types as t

    aws, cluster = fake_aws.FakeAWSBackend(quota_accelerators=50), FakeCluster()
    zones = {}
    for k in range(2):
        zone = aws.add_hosted_zone(f"z{k}.bench.example.com")
        zones[zone.name.rstrip(".")] = zone.id

    def chain(owner: str, lb_name: str, host: str, ports: list[int], extra: list = ()):
        lb = aws.add_load_balancer(lb_name, pop.REGION, host)
        accelerator = aws.create_accelerator(lb_name, "IPV4", True, [t.Tag(read.OWNER_TAG, owner)])
        listener = aws.create_listener(
            accelerator.accelerator_arn, [t.PortRange(p, p) for p in ports], "TCP", "NONE")
        endpoints = [t.EndpointConfiguration(endpoint_id=lb.load_balancer_arn)] + list(extra)
        group = aws.create_endpoint_group(listener.listener_arn, pop.REGION, endpoints)
        return accelerator, group

    def records(hostname: str, owner: str, accelerator) -> None:
        zone = zones[hostname.split(".", 1)[1]]
        aws.change_resource_record_sets(zone, [
            t.Change("CREATE", t.ResourceRecordSet(
                name=hostname, type="TXT", ttl=300, resource_records=[t.ResourceRecord(HERITAGE.format(owner))])),
            t.Change("CREATE", t.ResourceRecordSet(
                name=hostname, type="A", alias_target=t.AliasTarget(
                    dns_name=accelerator.dns_name, evaluate_target_health=True, hosted_zone_id="Z2BJ6XQ5FK7U4H"))),
        ])

    lbs = {}
    for key, entry in record["services"].items():
        accelerator, _ = chain(f"service/{key}", entry["lb"], entry["lb_host"], entry["ports"])
        lbs[entry["name"]] = aws._load_balancers[entry["lb"]].load_balancer_arn
        records(entry["hostname"], f"service/{key}", accelerator)
    for key, entry in record["ingresses"].items():
        accelerator, _ = chain(f"ingress/{key}", entry["alb"], entry["alb_host"], reference.ingress_ports(entry))
        records(entry["hostname"], f"ingress/{key}", accelerator)
    for group_name in record["external"]:
        extra = [
            t.EndpointConfiguration(endpoint_id=lbs[b["service"]],
                                    weight=b["weight"] if weight_of_binding is None else weight_of_binding)
            for b in record["bindings"].values() if b["group"] == group_name
        ]
        chain(f"service/external/{group_name}", group_name, pop.external_host(group_name), [80], extra)
    from agac_tpu_torch.apis import endpointgroupbinding as egb
    from agac_tpu_torch.cluster import objects as o

    for key, entry in record["bindings"].items():
        obj = egb.EndpointGroupBinding(
            metadata=o.ObjectMeta(name=entry["name"], namespace=entry["namespace"]),
            spec=egb.EndpointGroupBindingSpec(endpoint_group_arn="x", weight=entry["weight"],
                                              service_ref=egb.ServiceReference(name=entry["service"])),
        )
        obj.status.endpoint_ids = [lbs[entry["service"]]]
        cluster.create("EndpointGroupBinding", obj)
    return read.InMemoryReader(aws, cluster)


def verdict(expected: dict, actual: dict) -> tuple[int, int, int]:
    v = reference.compare(expected, actual)
    return v["mismatched"], v["leftover"], v["duplicates"]


def test_a_correct_world_matches():
    record = tiny_record()
    assert verdict(reference.expected_world(record), build(record).read()) == (0, 0, 0)


def test_ingress_ports_from_the_annotation_or_the_rules():
    assert reference.ingress_ports({"listen_ports": '[{"HTTP": 80}, {"HTTPS": 443}]'}) == [80, 443]
    assert reference.ingress_ports({"listen_ports": None, "default_port": 8080, "rule_ports": [80, 80]}) == [80, 8080]


def test_a_wrong_weight_is_mismatched():
    record = tiny_record()
    assert verdict(reference.expected_world(record), build(record, weight_of_binding=7).read()) == (1, 0, 0)


def test_a_deleted_object_left_behind_is_leftover():
    record = tiny_record()
    world = build(record).read()
    gone = copy.deepcopy(record)
    change = {"op": "delete", "section": "services", "key": "ns1/bench0001"}
    reference.apply_change(gone, change)
    # the chain and the record pair of the deleted Service remain
    assert verdict(reference.expected_world(gone), world) == (0, 2, 0)


def test_a_duplicate_accelerator_is_counted():
    record = tiny_record()
    reader = build(record)
    from agac_tpu_torch.cloudprovider.aws import types as t

    reader.aws.create_accelerator("dup", "IPV4", True, [t.Tag(read.OWNER_TAG, "service/ns0/bench0000")])
    assert verdict(reference.expected_world(record), reader.read())[2] == 1


def test_partial_reads_agree_with_whole_ones():
    record = tiny_record()
    reader = build(record)
    whole = reader.read()
    wanted = set(reference.expected_world(record))
    assert reader.read(wanted) == {item: whole.get(item) for item in wanted}


def test_the_stale_control_fails_every_kind_of_change():
    record = tiny_record()
    changes = [
        {"op": "edit", "section": "services", "key": "ns0/bench0000", "set": {"ports": [443]}},
        {"op": "delete", "section": "services", "key": "ns1/bench0001"},
        {"op": "edit", "section": "bindings", "key": "ns0/binding0000", "set": {"weight": 9}},
    ]
    after = copy.deepcopy(record)
    for change in changes:
        reference.apply_change(after, change)
    assert verdict(reference.expected_world(after), reference.stale_world(record, changes)) == (2, 2, 0)


def test_the_reference_imports_nothing_of_the_program():
    tree = ast.parse(pathlib.Path(reference.__file__).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "copy", "json"}, names


def test_the_shaping_model_is_bench_py_s():
    """``perfbench/world/shaping.py``'s tables are ``bench.py``'s, read
    from its source (it imports the JAX package, so it is not imported)."""
    from perfbench.world import shaping

    source = (pathlib.Path(reference.__file__).parents[1] / "bench.py").read_text()
    tables: dict = {}
    exec(source[source.index("REAL_LATENCY = {"):source.index("def _progress")], tables)
    assert tables["REAL_LATENCY"] == shaping.REAL_LATENCY
    assert tables["OP_FAMILY"] == shaping.OP_FAMILY
    scaled = {f: (rate * 10, burst * 10) for f, (rate, burst) in shaping.REAL_QUOTAS.items()}
    assert tables["QUOTAS"] == scaled
