"""An in-process deployment: the port's ``Manager.run`` (all three
controllers over ``AWSDriver``) against the benchmark's own world, the
frozen in-memory AWS behind the shaping proxy and the frozen in-memory
API server.

The controllers run with the settings of ``bench.py``'s tuned phase
(``bench.py:1950-1970``), which the configuration file states.
"""

from __future__ import annotations

import importlib
import logging
import threading
import time
import types

from perfbench import breakdown, reference
from perfbench.world import fake_aws, population as pop, read, shaping
from perfbench.world.fake_cluster import FakeCluster


def load_port() -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"agac_tpu_torch.{name}")
    return types.SimpleNamespace(
        apis=mod("apis"), egb=mod("apis.endpointgroupbinding"), objects=mod("cluster.objects"),
        aws=mod("cloudprovider.aws"), awstypes=mod("cloudprovider.aws.types"),
        batcher=mod("cloudprovider.aws.batcher"), pending=mod("reconcile.pending"),
        controllers=mod("controllers"), manager=mod("manager"), metrics=mod("observability.metrics"),
        klog=mod("klog"), errors=mod("errors"),
    )


KINDS = {"services": "Service", "ingresses": "Ingress", "bindings": "EndpointGroupBinding"}


class World:
    """One in-process deployment of ``config``, its world built for the
    population ``record`` and the objects ``changes`` will create."""

    def __init__(self, config: dict, population: pop.Population, record: dict, changes: list[dict]):
        self.config = config
        port = self.port = load_port()
        port.klog.init(verbosity=-1)
        logging.getLogger("agac").setLevel(logging.CRITICAL)
        settings = config["settings"]
        entries = list(record["services"].values()) + list(record["ingresses"].values())
        entries += [c["entry"] for c in changes if c["op"] == "create" and c["section"] != "bindings"]
        self.aws = fake_aws.FakeAWSBackend(
            settle_describes=settings["settle_describes"],
            quota_accelerators=len(entries) + len(record["external"]) + 50,
        )
        self.shaped = shaping.ShapedAWS(self.aws, fake_aws.API_OPS, config["time_compression"])
        self.cluster = FakeCluster()
        self.reader = read.InMemoryReader(self.aws, self.cluster)
        for entry in entries:
            if "lb" in entry:
                self.aws.add_load_balancer(entry["lb"], pop.REGION, entry["lb_host"])
            else:
                self.aws.add_load_balancer(entry["alb"], pop.REGION, entry["alb_host"], lb_type="application")
        for k in range(population.zones):
            self.aws.add_hosted_zone(f"z{k}.bench.example.com")
        self.group_arns = {group: self._external_chain(group) for group in record["external"]}
        self.stop = threading.Event()

    def _external_chain(self, name: str) -> str:
        """An out-of-band chain behind load balancer ``name``, tagged for
        another cluster, so the controllers never own it; its endpoint
        group's arn."""
        t = self.port.awstypes
        lb = self.aws.add_load_balancer(name, pop.REGION, pop.external_host(name))
        owner = reference.owner("service", f"{reference.EXTERNAL_NAMESPACE}/{name}")
        accelerator = self.aws.create_accelerator(name, "IPV4", True, [
            t.Tag(read.OWNER_TAG, owner), t.Tag("aws-global-accelerator-cluster", "external"),
        ])
        listener = self.aws.create_listener(accelerator.accelerator_arn, [t.PortRange(80, 80)], "TCP", "NONE")
        group = self.aws.create_endpoint_group(
            listener.listener_arn, pop.REGION,
            [t.EndpointConfiguration(endpoint_id=lb.load_balancer_arn, client_ip_preservation_enabled=False)],
        )
        return group.endpoint_group_arn

    # -- the program -----------------------------------------------------
    def start(self) -> None:
        port, s = self.port, self.config["settings"]
        c = port.controllers
        queue = dict(workers=s["workers"], queue_qps=s["queue_qps"], queue_burst=s["queue_burst"])
        config = port.manager.ControllerConfig(
            global_accelerator=c.GlobalAcceleratorConfig(**queue),
            route53=c.Route53Config(**queue),
            endpoint_group_binding=c.EndpointGroupBindingConfig(**queue),
            settle_poll_interval=s["settle_poll_s"],
        )
        aws_mod = port.aws
        discovery = aws_mod.DiscoveryCache(ttl=s["discovery_ttl_s"], tags_ttl=s["discovery_tags_ttl_s"])
        zones = aws_mod.HostedZoneCache(ttl=s["zone_ttl_s"])
        topology = aws_mod.AcceleratorTopologyCache(verify_ttl=s["read_plane_ttl_s"], full_ttl=3600.0)
        records = aws_mod.RecordSetCache(ttl=s["read_plane_ttl_s"])
        lbs = aws_mod.LoadBalancerCoalescer(ttl=s["read_plane_ttl_s"], batch_window=s["lb_batch_window_s"])
        settle_table = port.pending.PendingSettleTable()
        batcher = port.batcher.ChangeBatcher(max_changes=s["r53_batch_max"], linger=s["r53_batch_linger_s"])
        shaped = self.shaped

        def cloud(region):
            return aws_mod.AWSDriver(
                shaped, shaped, shaped,
                accelerator_missing_retry=s["accelerator_missing_retry_s"],
                discovery_cache=discovery, zone_cache=zones, topology_cache=topology,
                record_cache=records, lb_coalescer=lbs, settle_table=settle_table,
                change_batcher=batcher, stage_requeue=s["stage_requeue_s"],
                refresh_discovery_on_disable=s["refresh_discovery_on_disable"],
            )

        self.manager = port.manager.Manager(
            resync_period=s["resync_period_s"], metrics_registry=port.metrics.registry()
        )
        self.manager.run(self.cluster, config, self.stop, cloud_factory=cloud, block=False,
                         settle_table=settle_table)

    def close(self) -> None:
        self.stop.set()

    # -- the benchmark's side -------------------------------------------
    def create_base(self, record: dict) -> None:
        for section in ("services", "ingresses", "bindings"):
            for entry in record[section].values():
                self.cluster.create(KINDS[section], self._object(section, entry))

    def _object(self, section: str, entry: dict):
        if section == "services":
            return pop.service_object(self.port, entry)
        if section == "ingresses":
            return pop.ingress_object(self.port, entry)
        return pop.binding_object(self.port, entry, self.group_arns[entry["group"]])

    def apply(self, change: dict) -> None:
        apply_change(self.cluster, self.port, change, self._object)

    def arm(self, on: bool = True) -> None:
        self.shaped.arm(on)

    def settle(self, quiet_s: float = 1.0, limit_s: float = 15.0) -> None:
        """Wait until no AWS call has landed for ``quiet_s`` (at most
        ``limit_s``): the base population's trailing reads done."""
        end = time.monotonic() + limit_s
        last, since = sum(self.shaped.snapshot().values()), time.monotonic()
        while time.monotonic() < end:
            time.sleep(0.1)
            calls = sum(self.shaped.snapshot().values())
            if calls != last:
                last, since = calls, time.monotonic()
            elif time.monotonic() - since >= quiet_s:
                return

    def idle_gaps(self, start: dict, end: dict) -> list:
        return breakdown.idle_gaps(start, end)

    def sources(self) -> dict:
        """What the per-layer readers read at one instant."""
        return {
            "aws_calls": self.shaped.snapshot(),
            "aws_shaped_s": dict(self.shaped.shaped_s),
            "expositions": [self.port.metrics.registry().render()],
            "pids": [],
        }


def apply_change(cluster, port, change: dict, make) -> None:
    """Make one change of the traffic in the API server ``cluster``."""
    kind = KINDS[change["section"]]
    namespace, name = change["key"].split("/", 1)
    if change["op"] == "create":
        cluster.create(kind, make(change["section"], change["entry"]))
        return
    if change["op"] == "delete":
        cluster.delete(kind, namespace, name)
        return
    for _ in range(50):  # the controllers write finalizers and status beside us
        obj = cluster.get(kind, namespace, name)
        values = change["set"]
        if "ports" in values:
            o = port.objects
            obj.spec.ports = [o.ServicePort(name=f"p{p}", port=p, protocol="TCP") for p in values["ports"]]
        if "weight" in values:
            obj.spec.weight = values["weight"]
        if "service" in values:
            obj.spec.service_ref = port.egb.ServiceReference(name=values["service"])
        try:
            cluster.update(kind, obj)
            return
        except port.errors.ConflictError:
            time.sleep(0.01)
    raise RuntimeError(f"could not update {kind} {change['key']}: conflicts")
