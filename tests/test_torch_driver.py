"""Differential check of the port's cloud driver layer: one scripted
ensure / update / cleanup sequence goes through each package's
``AWSDriver`` over its own ``FakeAWSBackend``, and the two backends
must end in equal state with equal call logs.

The fake backend derives every ARN from a uuid5 over its own serial,
so the same calls in the same order give the same ARNs and the
comparison is exact.  Both packages are imported inside the tests:
the port is not first-party to the repository's import linter."""

from __future__ import annotations

import collections
import importlib
import types

NLB_NAME = "testlb"
NLB_REGION = "us-west-2"
NLB_HOSTNAME = "testlb-0123456789abcdef.elb.us-west-2.amazonaws.com"
ALB_NAME = "k8s-default-testing-0a1b2c3d4e"
ALB_HOSTNAME = f"{ALB_NAME}-111222333.us-west-2.elb.amazonaws.com"
CLUSTER = "default"


def _package(name: str) -> types.SimpleNamespace:
    """The modules the script uses, from ``agac_tpu`` or its port."""
    return types.SimpleNamespace(
        apis=importlib.import_module(f"{name}.apis"),
        objects=importlib.import_module(f"{name}.cluster.objects"),
        aws=importlib.import_module(f"{name}.cloudprovider.aws"),
    )


def _service(pkg, ports):
    o = pkg.objects
    svc = o.Service(
        metadata=o.ObjectMeta(
            name="web",
            namespace="default",
            annotations={
                pkg.apis.AWS_LOAD_BALANCER_TYPE_ANNOTATION: "external",
                pkg.apis.AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION: "true",
            },
        ),
        spec=o.ServiceSpec(
            type="LoadBalancer",
            ports=[
                o.ServicePort(name=f"p{port}", port=port, protocol="TCP")
                for port in ports
            ],
        ),
    )
    svc.status.load_balancer.ingress.append(o.LoadBalancerIngress(hostname=NLB_HOSTNAME))
    return svc


def _ingress(pkg):
    """An ALB Ingress whose listen-ports annotation names two ports."""
    o = pkg.objects
    ing = o.Ingress(
        metadata=o.ObjectMeta(
            name="webapp",
            namespace="default",
            annotations={
                pkg.apis.INGRESS_CLASS_ANNOTATION: "alb",
                pkg.apis.AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION: "true",
                pkg.apis.ALB_LISTEN_PORTS_ANNOTATION: '[{"HTTP": 80}, {"HTTPS": 443}]',
            },
        ),
        spec=o.IngressSpec(
            ingress_class_name="alb",
            rules=[
                o.IngressRule(
                    host="app.example.com",
                    http=o.HTTPIngressRuleValue(
                        paths=[
                            o.HTTPIngressPath(
                                path="/",
                                backend=o.IngressBackend(
                                    service=o.IngressServiceBackend(
                                        name="backend",
                                        port=o.ServiceBackendPort(number=80),
                                    )
                                ),
                            )
                        ]
                    ),
                )
            ],
        ),
    )
    ing.status.load_balancer.ingress.append(
        o.IngressLoadBalancerIngress(hostname=ALB_HOSTNAME)
    )
    return ing


def _backend(pkg):
    backend = pkg.aws.FakeAWSBackend()
    backend.add_load_balancer(NLB_NAME, NLB_REGION, NLB_HOSTNAME)
    backend.add_load_balancer(ALB_NAME, NLB_REGION, ALB_HOSTNAME)
    backend.add_hosted_zone("example.com")
    return backend


def _driver(pkg, backend):
    return pkg.aws.AWSDriver(
        backend, backend, backend, poll_interval=0.001, poll_timeout=1.0
    )


def _chain(driver, arn):
    listener = driver.get_listener(arn)
    group = driver.get_endpoint_group(listener.listener_arn)
    return (
        [(p.from_port, p.to_port) for p in listener.port_ranges],
        listener.protocol,
        [d.endpoint_id for d in group.endpoint_descriptions],
    )


def _script(pkg, backend) -> list:
    """Ensure, update and clean up a Service chain, an Ingress chain on
    two listen ports and a Route53 TXT+A pair; every step's result."""
    driver = _driver(pkg, backend)
    out = []
    svc = _service(pkg, (80,))
    svc_lbi = svc.status.load_balancer.ingress[0]
    svc_arn, created, retry = driver.ensure_global_accelerator_for_service(
        svc, svc_lbi, CLUSTER, NLB_NAME, NLB_REGION
    )
    out.append(("ensure-service", svc_arn, created, retry, _chain(driver, svc_arn)))
    # an update: the Service gains a port, the listener must follow
    svc = _service(pkg, (80, 443))
    out.append(
        ("update-service",)
        + driver.ensure_global_accelerator_for_service(
            svc, svc_lbi, CLUSTER, NLB_NAME, NLB_REGION
        )
        + (_chain(driver, svc_arn),)
    )
    ing = _ingress(pkg)
    ing_lbi = ing.status.load_balancer.ingress[0]
    ing_arn, created, retry = driver.ensure_global_accelerator_for_ingress(
        ing, ing_lbi, CLUSTER, ALB_NAME, NLB_REGION
    )
    out.append(("ensure-ingress", ing_arn, created, retry, _chain(driver, ing_arn)))
    out.append(
        ("route53-service",)
        + driver.ensure_route53_for_service(svc, svc_lbi, ["app.example.com"], CLUSTER)
    )
    out.append(
        ("route53-ingress",)
        + driver.ensure_route53_for_ingress(ing, ing_lbi, ["webapp.example.com"], CLUSTER)
    )
    out.append(
        ("route53-service-again",)
        + driver.ensure_route53_for_service(svc, svc_lbi, ["app.example.com"], CLUSTER)
    )
    out.append(("snapshot-before-cleanup", backend.snapshot_state()))
    driver.cleanup_record_set(CLUSTER, "service", "default", "web")
    driver.cleanup_global_accelerator(svc_arn)
    out.append(("owned-records", sorted(driver.list_owned_record_owners(CLUSTER))))
    out.append(("accelerators", sorted(backend.all_accelerator_arns())))
    return out


def _step(steps: list, name: str) -> tuple:
    return next(step[1:] for step in steps if step[0] == name)


def _op_counts(backend) -> collections.Counter:
    return collections.Counter(call[0] for call in backend.calls)


def test_scripted_sequence_gives_equal_state_and_calls():
    ref, port = _package("agac_tpu"), _package("agac_tpu_torch")
    ref_backend, port_backend = _backend(ref), _backend(port)
    ref_steps = _script(ref, ref_backend)
    port_steps = _script(port, port_backend)

    assert port_steps == ref_steps
    assert port_backend.snapshot_state() == ref_backend.snapshot_state()
    assert _op_counts(port_backend) == _op_counts(ref_backend)
    assert port_backend.calls == ref_backend.calls
    # the script exercised what it claims: both chains, both record
    # pairs, and a cleanup that left only the Ingress chain
    snapshot = _step(ref_steps, "snapshot-before-cleanup")[0]
    assert len(snapshot["accelerators"]) == 2
    ports = sorted(
        tuple(tuple(p) for p in entry["listeners"][0]["port_ranges"])
        for entry in snapshot["accelerators"]
    )
    assert ports == [((80, 80), (443, 443)), ((80, 80), (443, 443))]
    records = [r for table in snapshot["records"].values() for r in table]
    assert sorted((r["name"], r["type"]) for r in records) == [
        ("app.example.com.", "A"),
        ("app.example.com.", "TXT"),
        ("webapp.example.com.", "A"),
        ("webapp.example.com.", "TXT"),
    ]
    assert len(_step(ref_steps, "accelerators")[0]) == 1
    assert _op_counts(ref_backend)["DeleteAccelerator"] == 1


def test_reference_snapshot_round_trips_through_the_port():
    ref, port = _package("agac_tpu"), _package("agac_tpu_torch")
    ref_backend = _backend(ref)
    ref_steps = _script(ref, ref_backend)
    mid_run = _step(ref_steps, "snapshot-before-cleanup")[0]
    final = ref_backend.snapshot_state()

    port_backend = port.aws.FakeAWSBackend()
    port_backend.restore_state(mid_run)
    assert port_backend.snapshot_state() == mid_run
    port_backend.restore_state(final)
    assert port_backend.snapshot_state() == final

    # the restored world behaves as the reference's: the same cleanup
    # from the same restored state gives the same state and calls
    ref_again = ref.aws.FakeAWSBackend()
    ref_again.restore_state(mid_run)
    port_backend.restore_state(mid_run)
    for pkg, backend in ((ref, ref_again), (port, port_backend)):
        driver = _driver(pkg, backend)
        driver.cleanup_record_set(CLUSTER, "ingress", "default", "webapp")
        for arn in backend.all_accelerator_arns():
            driver.cleanup_global_accelerator(arn)
    assert port_backend.snapshot_state() == ref_again.snapshot_state()
    assert port_backend.calls == ref_again.calls
    assert port_backend.all_accelerator_arns() == []
