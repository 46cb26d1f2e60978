"""The deployments' objects: the benchmark's record of them, and the
program's typed objects built from that record.

The record is plain data (``perfbench/reference.py`` reads it); the
shapes are ``bench.py``'s mixed fleet (``bench.py:418-510``) and its
sharded fleet (``bench.py:1289-1307``), as ``chip_smoke.py`` builds them.
"""

from __future__ import annotations

REGION = "us-west-2"
LISTEN_PORTS = '[{"HTTP": 80}, {"HTTPS": 443}]'


def lb_host(name: str) -> str:
    return f"{name}-0123456789abcdef.elb.{REGION}.amazonaws.com"


def alb_name(j: int) -> str:
    return f"k8s-ns{j % 10}-ing{j:04d}-0a1b2c3d4e"


def alb_host(name: str) -> str:
    return f"{name}-111222333.{REGION}.elb.amazonaws.com"


def external_host(name: str) -> str:
    return f"{name}-fedcba9876543210.elb.{REGION}.amazonaws.com"


class Population:
    """Names, shapes and counts of one configuration's objects."""

    def __init__(self, spec: dict, cluster: str):
        self.spec = spec
        self.cluster = cluster
        self.zones = spec.get("zones", 0)
        self.shared_lb = spec.get("shared_lb")
        self.namespace = spec.get("namespace")

    # -- entries -------------------------------------------------------
    def service(self, i: int) -> tuple[str, dict]:
        if self.shared_lb:
            name = f"shard{i:04d}"
            return f"{self.namespace}/{name}", {
                "namespace": self.namespace, "name": name, "lb": self.shared_lb,
                "lb_host": lb_host(self.shared_lb), "ports": [80], "hostname": None,
            }
        name = f"bench{i:04d}"
        hostname = f"{name}.z{i % self.zones}.bench.example.com" if self.zones else None
        return f"ns{i % 10}/{name}", {
            "namespace": f"ns{i % 10}", "name": name, "lb": name, "lb_host": lb_host(name),
            "ports": [80], "hostname": hostname,
        }

    def ingress(self, j: int) -> tuple[str, dict]:
        name = f"ing{j:04d}"
        alb = alb_name(j)
        return f"ns{j % 10}/{name}", {
            "namespace": f"ns{j % 10}", "name": name, "alb": alb, "alb_host": alb_host(alb),
            # even j names its ports in the listen-ports annotation,
            # odd j derives them from its rule backends
            "listen_ports": LISTEN_PORTS if j % 2 == 0 else None,
            "default_port": None, "rule_ports": [80],
            "hostname": f"{name}.z{j % self.zones}.bench.example.com",
        }

    def binding(self, k: int) -> tuple[str, dict]:
        name = f"binding{k:04d}"
        return f"ns{k % 10}/{name}", {
            "namespace": f"ns{k % 10}", "name": name, "group": f"ext{k:04d}",
            "weight": 100, "service": f"bench{k:04d}",
        }

    def record(self, services: int, ingresses: int, bindings: int) -> dict:
        """The record of a population of these sizes (bindings ``k`` bind
        Service ``k`` into out-of-band chain ``k``)."""
        record = {
            "cluster": self.cluster, "services": {}, "ingresses": {}, "bindings": {},
            "external": {f"ext{k:04d}": {"ports": [80]} for k in range(bindings)},
        }
        for i in range(services):
            key, entry = self.service(i)
            record["services"][key] = entry
        for j in range(ingresses):
            key, entry = self.ingress(j)
            record["ingresses"][key] = entry
        for k in range(bindings):
            key, entry = self.binding(k)
            record["bindings"][key] = entry
        return record


# -- the program's typed objects ---------------------------------------

def service_object(port, entry: dict):
    o, apis = port.objects, port.apis
    annotations = {
        apis.AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION: "true",
        apis.AWS_LOAD_BALANCER_TYPE_ANNOTATION: "external",
    }
    if entry.get("hostname"):
        annotations[apis.ROUTE53_HOSTNAME_ANNOTATION] = entry["hostname"]
    svc = o.Service(
        metadata=o.ObjectMeta(name=entry["name"], namespace=entry["namespace"], annotations=annotations),
        spec=o.ServiceSpec(
            type="LoadBalancer",
            ports=[
                o.ServicePort(name=f"p{port_number}", port=port_number, protocol="TCP")
                for port_number in entry["ports"]
            ],
        ),
    )
    svc.status.load_balancer.ingress.append(o.LoadBalancerIngress(hostname=entry["lb_host"]))
    return svc


def ingress_object(port, entry: dict):
    o, apis = port.objects, port.apis
    annotations = {
        apis.INGRESS_CLASS_ANNOTATION: "alb",
        apis.AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION: "true",
        apis.ROUTE53_HOSTNAME_ANNOTATION: entry["hostname"],
    }
    if entry.get("listen_ports") is not None:
        annotations[apis.ALB_LISTEN_PORTS_ANNOTATION] = entry["listen_ports"]
    paths = [
        o.HTTPIngressPath(
            path="/",
            backend=o.IngressBackend(
                service=o.IngressServiceBackend(name="backend", port=o.ServiceBackendPort(number=p))
            ),
        )
        for p in entry["rule_ports"]
    ]
    ing = o.Ingress(
        metadata=o.ObjectMeta(name=entry["name"], namespace=entry["namespace"], annotations=annotations),
        spec=o.IngressSpec(
            ingress_class_name="alb",
            rules=[
                o.IngressRule(
                    host=f"{entry['name']}.bench.example.com",
                    http=o.HTTPIngressRuleValue(paths=paths),
                )
            ],
        ),
    )
    ing.status.load_balancer.ingress.append(o.IngressLoadBalancerIngress(hostname=entry["alb_host"]))
    return ing


def binding_object(port, entry: dict, group_arn: str):
    egb = port.egb
    return egb.EndpointGroupBinding(
        metadata=port.objects.ObjectMeta(name=entry["name"], namespace=entry["namespace"]),
        spec=egb.EndpointGroupBindingSpec(
            endpoint_group_arn=group_arn,
            weight=entry["weight"],
            service_ref=egb.ServiceReference(name=entry["service"]),
        ),
    )
