"""Reads of the world the controllers act on, as the reference's items.

The benchmark reads its own world: the frozen in-memory AWS and API
server of an in-process deployment, or the durable fake account's state
file (read-only, without its lock: every save replaces the file whole)
and the frozen API server of a deployment of processes.  A read renders
what it finds as ``perfbench/reference.py``'s items, so one comparison
judges both.
"""

from __future__ import annotations

import json

OWNER_TAG = "aws-global-accelerator-owner"
KINDS = ("Service", "Ingress", "EndpointGroupBinding")


class _Raw:
    """One consistent read, in plain values: per accelerator its owner,
    enabled flag and listeners ``(arn, protocol, [[from, to]])``; endpoint
    groups by listener; load balancer names by arn; records by hostname."""

    def __init__(self):
        self.accelerators: dict[str, list] = {}  # owner -> [(enabled, listeners)]
        self.owner_by_dns: dict[str, str] = {}
        self.groups: dict[str, list] = {}  # listener arn -> [[(endpoint id, weight)]]
        self.lb_names: dict[str, str] = {}
        self.records: dict[str, dict] = {}  # hostname -> type -> (values, alias dns)


def _chain(raw: _Raw, accelerators: list) -> dict:
    enabled, listeners = accelerators[0]
    groups = []
    for listener_arn, _, _ in listeners:
        for endpoints in raw.groups.get(listener_arn, ()):
            groups.append(sorted(
                ([raw.lb_names.get(eid, eid), weight] for eid, weight in endpoints),
                key=lambda e: (e[0], -1 if e[1] is None else e[1]),
            ))
    return {
        "n": len(accelerators),
        "enabled": all(e for e, _ in accelerators),
        "listeners": sorted([protocol, sorted(ranges)] for _, protocol, ranges in listeners),
        "groups": sorted(groups, key=repr),
    }


def _record(raw: _Raw, types: dict) -> dict:
    view = {}
    for rtype, (values, alias) in types.items():
        if alias is not None:
            dns = alias.rstrip(".")
            view[rtype] = raw.owner_by_dns.get(dns, f"dns:{dns}")
        else:
            view[rtype] = sorted(values)
    return view


def render(raw: _Raw, cluster, wanted: set | None) -> dict:
    """The items of ``raw`` and the API server ``cluster``: those in
    ``wanted`` (absent ones as None), or every item present."""
    items: dict = {}
    if wanted is None:
        for owner, accelerators in raw.accelerators.items():
            items[("chain", owner)] = _chain(raw, accelerators)
        for host, types in raw.records.items():
            items[("record", host)] = _record(raw, types)
        for kind in KINDS:
            for obj in cluster.list(kind)[0]:
                key = f"{obj.metadata.namespace}/{obj.metadata.name}"
                if obj.metadata.deletion_timestamp:
                    items[("object", f"{kind}/{key}")] = True
                if kind == "EndpointGroupBinding":
                    items[("binding", key)] = _binding(raw, obj)
        return items
    for section, key in wanted:
        value = None
        if section == "chain":
            accelerators = raw.accelerators.get(key)
            value = _chain(raw, accelerators) if accelerators else None
        elif section == "record":
            types = raw.records.get(key)
            value = _record(raw, types) if types else None
        elif section == "binding":
            namespace, name = key.split("/", 1)
            obj = _get(cluster, "EndpointGroupBinding", namespace, name)
            value = _binding(raw, obj) if obj is not None else None
        items[(section, key)] = value
    return items


def _get(cluster, kind: str, namespace: str, name: str):
    try:
        return cluster.get(kind, namespace, name)
    except Exception as err:  # the API server's NotFoundError
        if type(err).__name__ == "NotFoundError":
            return None
        raise


def _binding(raw: _Raw, obj) -> list:
    return [raw.lb_names.get(eid, eid) for eid in obj.status.endpoint_ids]


class InMemoryReader:
    """Reads the frozen in-memory fake (``perfbench/world/fake_aws.py``)
    under its lock, and the frozen ``FakeCluster``."""

    def __init__(self, aws, cluster):
        self.aws, self.cluster = aws, cluster

    def read(self, wanted: set | None = None) -> dict:
        aws = self.aws
        raw = _Raw()
        owners = None if wanted is None else {k for s, k in wanted if s == "chain"}
        hosts = None if wanted is None else {k for s, k in wanted if s == "record"}
        with aws._lock:
            raw.lb_names = {lb.load_balancer_arn: name for name, lb in aws._load_balancers.items()}
            for state in aws._accelerators.values():
                owner = next((t.value for t in state.tags if t.key == OWNER_TAG), None)
                accelerator = state.accelerator
                raw.owner_by_dns[accelerator.dns_name.rstrip(".")] = owner
                if owner is None or (owners is not None and owner not in owners):
                    continue
                listeners = []
                for listener in state.listeners.values():
                    ranges = [[p.from_port, p.to_port] for p in listener.port_ranges]
                    listeners.append((listener.listener_arn, listener.protocol, ranges))
                    raw.groups[listener.listener_arn] = [
                        [(d.endpoint_id, d.weight) for d in aws._endpoint_groups[arn].endpoint_descriptions]
                        for arn in aws._egs_by_listener.get(listener.listener_arn, ())
                    ]
                raw.accelerators.setdefault(owner, []).append((accelerator.enabled, listeners))
            for zone_id, table in aws._records.items():
                for (name, rtype), rrs in table.items():
                    host = name.rstrip(".")
                    if hosts is not None and host not in hosts:
                        continue
                    alias = rrs.alias_target.dns_name if rrs.alias_target else None
                    raw.records.setdefault(host, {})[rtype] = (
                        [r.value for r in rrs.resource_records], alias,
                    )
        return render(raw, self.cluster, wanted)


def raw_from_state(data: dict) -> _Raw:
    """A ``_Raw`` from the durable fake account's state document."""
    raw = _Raw()
    raw.lb_names = {lb["load_balancer_arn"]: lb["load_balancer_name"] for lb in data.get("load_balancers", [])}
    for group in data.get("endpoint_groups", []):
        raw.groups.setdefault(group["parent"], []).append(
            [(e["endpoint_id"], e.get("weight")) for e in group.get("endpoints", [])]
        )
    for entry in data.get("accelerators", []):
        accelerator = entry["accelerator"]
        owner = next((v for k, v in entry.get("tags", []) if k == OWNER_TAG), None)
        raw.owner_by_dns[accelerator["dns_name"].rstrip(".")] = owner
        if owner is None:
            continue
        listeners = [
            (l["listener_arn"], l["protocol"], [list(r) for r in l["port_ranges"]])
            for l in entry.get("listeners", [])
        ]
        raw.accelerators.setdefault(owner, []).append((accelerator["enabled"], listeners))
    for records in data.get("records", {}).values():
        for r in records:
            alias = r["alias"]["dns_name"] if r.get("alias") else None
            raw.records.setdefault(r["name"].rstrip("."), {})[r["type"]] = (r["values"], alias)
    return raw


class StateFileReader:
    """Reads the durable fake account's state file read-only, and the
    frozen API server's ``FakeCluster``."""

    def __init__(self, state_path: str, cluster):
        self.state_path, self.cluster = state_path, cluster

    def read(self, wanted: set | None = None) -> dict:
        try:
            with open(self.state_path) as f:
                data = json.load(f)
        except FileNotFoundError:
            data = {}
        return render(raw_from_state(data), self.cluster, wanted)
