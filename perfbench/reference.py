"""The plain reference: the world the controllers should leave behind.

It works the expected state out again from the benchmark's own record of
what it created, edited and deleted, and judges a world read against it.
Plain Python: it imports nothing of the program (nor ``jax``, nor the
JAX package), and takes nothing the program made.  The semantics are
those the configuration states (``docs/operations.md``, the controller's
API reference):

- every managed Service and ALB Ingress owns exactly one enabled
  accelerator, tagged ``aws-global-accelerator-owner=<kind>/<ns>/<name>``,
  with one listener (an Ingress's is TCP; a Service's takes the protocol
  of its last TCP or UDP port) with a port range of one port for each of
  the object's ports, and one endpoint group that holds its load
  balancer alone, at no weight of its own;
- an Ingress listens on the ports its ``alb.ingress.kubernetes.io/listen-ports``
  annotation names (each ``HTTP`` and ``HTTPS`` entry), or, without the
  annotation, on the ports of its default backend and of every rule
  path's backend;
- a hostname-annotated object owns a TXT record carrying the heritage
  value ``"heritage=aws-global-accelerator-controller,cluster=<c>,<kind>/<ns>/<name>"``
  and an A alias to its accelerator, in the zone one label up;
- an EndpointGroupBinding puts its Service's load balancer into its
  endpoint group at its weight, keeps no other endpoint of its own there,
  and reports that load balancer in its status;
- a deleted object leaves nothing behind: no accelerator, no record, no
  endpoint, and no object held back by a finalizer.

A world is a dict of items, ``(section, key) -> value``; a value of None
means the item must be absent.  Sections: ``chain`` (key: owner tag),
``record`` (key: hostname), ``binding`` (key: ``ns/name``; value: the
load balancers in its status) and ``object`` (key: ``kind/ns/name`` of
an object still present with a deletion timestamp).
"""

from __future__ import annotations

import copy
import json

HERITAGE = '"heritage=aws-global-accelerator-controller,cluster={cluster},{owner}"'
EXTERNAL_NAMESPACE = "external"


def owner(kind: str, key: str) -> str:
    """The owner tag of ``kind`` (``service`` or ``ingress``) ``ns/name``."""
    return f"{kind}/{key}"


def ingress_ports(entry: dict) -> list[int]:
    """The ports an ALB Ingress listens on (see the module docstring)."""
    raw = entry.get("listen_ports")
    ports: list[int] = []
    if raw is not None:
        for listen in json.loads(raw):
            for protocol in ("HTTP", "HTTPS"):
                if listen.get(protocol):
                    ports.append(int(listen[protocol]))
        return sorted(set(ports))
    if entry.get("default_port") is not None:
        ports.append(entry["default_port"])
    ports.extend(entry.get("rule_ports", ()))
    return sorted(set(ports))


def chain_view(ports: list[int], protocol: str, endpoints: list) -> dict:
    """A complete chain as the world reader renders one."""
    return {
        "n": 1,
        "enabled": True,
        "listeners": [[protocol, [[port, port] for port in sorted(set(ports))]]],
        "groups": [sorted(endpoints, key=endpoint_order)],
    }


def endpoint_order(endpoint: list) -> tuple:
    name, weight = endpoint
    return (name, -1 if weight is None else weight)


def service_items(record: dict, key: str, entry: dict | None, was: dict | None = None) -> dict:
    """The items of Service ``key``: ``entry`` live, or gone (``was``)."""
    spec = entry if entry is not None else was
    tag = owner("service", key)
    items = {("chain", tag): None}
    if entry is not None:
        protocol = "TCP"
        for port_protocol in entry.get("protocols", ["TCP"] * len(entry["ports"])):
            if port_protocol.upper() in ("TCP", "UDP"):
                protocol = port_protocol.upper()
        items[("chain", tag)] = chain_view(entry["ports"], protocol, [[entry["lb"], None]])
    if spec.get("hostname"):
        items[("record", spec["hostname"])] = (
            None if entry is None else record_view(record["cluster"], tag)
        )
    return items


def ingress_items(record: dict, key: str, entry: dict | None, was: dict | None = None) -> dict:
    spec = entry if entry is not None else was
    tag = owner("ingress", key)
    items = {("chain", tag): None}
    if entry is not None:
        items[("chain", tag)] = chain_view(ingress_ports(entry), "TCP", [[entry["alb"], None]])
    if spec.get("hostname"):
        items[("record", spec["hostname"])] = (
            None if entry is None else record_view(record["cluster"], tag)
        )
    return items


def record_view(cluster: str, tag: str) -> dict:
    return {"TXT": [HERITAGE.format(cluster=cluster, owner=tag)], "A": tag}


def group_items(record: dict, group: str) -> dict:
    """The out-of-band chain behind load balancer ``group``: its own
    endpoint, plus one per binding into it."""
    chain = record["external"][group]
    endpoints = [[group, None]]
    for binding in record["bindings"].values():
        if binding["group"] == group:
            service = record["services"][f"{binding['namespace']}/{binding['service']}"]
            endpoints.append([service["lb"], binding["weight"]])
    tag = owner("service", f"{EXTERNAL_NAMESPACE}/{group}")
    return {("chain", tag): chain_view(chain["ports"], "TCP", endpoints)}


def binding_items(record: dict, key: str, entry: dict | None, was: dict | None = None) -> dict:
    spec = entry if entry is not None else was
    items = group_items(record, spec["group"])
    if entry is None:
        items[("binding", key)] = None
    else:
        service = record["services"][f"{entry['namespace']}/{entry['service']}"]
        items[("binding", key)] = [service["lb"]]
    return items


ITEMS = {"services": service_items, "ingresses": ingress_items, "bindings": binding_items}


def object_items(record: dict, section: str, key: str, was: dict | None = None) -> dict:
    """The items of one object as ``record`` has it now; ``was`` is its
    last entry when it has been deleted."""
    return ITEMS[section](record, key, record[section].get(key), was)


def expected_world(record: dict) -> dict:
    """Every item the world should hold, none absent."""
    items: dict = {}
    for group in record["external"]:
        items.update(group_items(record, group))
    for section in ("services", "ingresses", "bindings"):
        for key in record[section]:
            items.update(object_items(record, section, key))
    return items


def apply_change(record: dict, change: dict) -> tuple[str, str, dict | None]:
    """Apply one change of the traffic to ``record`` in place; returns
    the object's section, key and its entry before a delete."""
    section, key, op = change["section"], change["key"], change["op"]
    table = record[section]
    if op == "create":
        table[key] = copy.deepcopy(change["entry"])
        return section, key, None
    if op == "delete":
        return section, key, table.pop(key)
    table[key].update(copy.deepcopy(change["set"]))
    return section, key, None


def change_items(record: dict, change: dict) -> dict:
    """Apply ``change`` to ``record``; the items the world shows once it
    has taken effect."""
    section, key, was = apply_change(record, change)
    return object_items(record, section, key, was)


def compare(expected: dict, actual: dict, examples: int = 8) -> dict:
    """Judge a whole-world read against the expected world.

    ``mismatched``: expected items missing or different; ``leftover``:
    items the world holds that nothing expects (a deleted object's chain
    or record, a binding or an object held by a finalizer);
    ``duplicates``: accelerators beyond the first for one owner."""
    mismatched = leftover = duplicates = 0
    diffs: list[str] = []
    for item, want in expected.items():
        have = actual.get(item)
        if item[0] == "chain" and have is not None:
            duplicates += max(0, have["n"] - 1)
        if want is None:
            if have is not None:
                leftover += 1
                if len(diffs) < examples:
                    diffs.append(f"{item}: left behind {have}")
        elif have != want:
            mismatched += 1
            if len(diffs) < examples:
                diffs.append(f"{item}: want {want}, have {have}")
    for item, have in actual.items():
        if item in expected or have is None:
            continue
        leftover += 1
        if item[0] == "chain":
            duplicates += max(0, have["n"] - 1)
        if len(diffs) < examples:
            diffs.append(f"{item}: unexpected {have}")
    return {"mismatched": mismatched, "leftover": leftover, "duplicates": duplicates, "diffs": diffs}


def stale_world(record_before: dict, changes: list[dict]) -> dict:
    """The control: the world a controller that never applies the last
    change of any object would leave, from the record before the window
    and the window's changes.  It breaks the configuration's guarantee
    that every acknowledged change converges."""
    last = {}
    for index, change in enumerate(changes):
        last[(change["section"], change["key"])] = index
    record = copy.deepcopy(record_before)
    for index, change in enumerate(changes):
        if last[(change["section"], change["key"])] != index:
            apply_change(record, change)
    return expected_world(record)
