"""The port's EndpointGroupBinding weight sync against its fake AWS.

The reference resends the spec's weight after every pass (a describe and
an ``UpdateEndpointGroup`` per bound endpoint, ``reconcile.go:195-202``),
even where its own ``AddEndpoints`` has just set it. The port writes an
endpoint's weight only where the state the pass already holds (the add's
response, or the describe the pass made) shows another weight, or where
the pass applies an edit of a converged binding's spec. Each case
drives the controller's ``reconcile`` by hand, counts the endpoint-group
calls the fake records for one pass and the
``agac_binding_weight_sync_total`` outcomes, and checks the group the
pass leaves: every bound endpoint at the spec's weight, every other
endpoint as it was.

The port is imported inside functions: the repository's linter treats
only ``agac_tpu``, ``tests`` and ``bench`` as first party."""

from __future__ import annotations

import dataclasses
import importlib

import pytest

NAMESPACE = "default"
REGION = "us-west-2"
KIND = "EndpointGroupBinding"
# the calls that touch an endpoint group's membership or weights
GROUP_OPS = frozenset({"DescribeEndpointGroup", "AddEndpoints", "UpdateEndpointGroup", "RemoveEndpoints"})
DESCRIBE, ADD, UPDATE = "DescribeEndpointGroup", "AddEndpoints", "UpdateEndpointGroup"
SEED_WEIGHT = 128


def _port(name: str):
    return importlib.import_module(f"agac_tpu_torch.{name}")


def _hostname(name: str) -> str:
    return f"{name}-0123456789abcdef.elb.{REGION}.amazonaws.com"


def _counted(outcome: str) -> float:
    metric = _port("observability.metrics").registry().get("agac_binding_weight_sync_total")
    return 0.0 if metric is None else metric.labels(outcome=outcome).value()


def _aws_default_weight_backend():
    """The port's fake, answering an endpoint given no weight as real AWS
    does: with the default weight, 128."""
    aws = _port("cloudprovider.aws")

    def defaulted(configs):
        return [
            dataclasses.replace(c, weight=SEED_WEIGHT if c.weight is None else c.weight)
            for c in configs
        ]

    class AWSDefaultWeightBackend(aws.FakeAWSBackend):
        def add_endpoints(self, arn, endpoint_configurations):
            return super().add_endpoints(arn, defaulted(endpoint_configurations))

        def update_endpoint_group(self, arn, endpoint_configurations):
            return super().update_endpoint_group(arn, defaulted(endpoint_configurations))

    return AWSDefaultWeightBackend()


class World:
    """One out-of-band endpoint group (its own load balancer bound at
    weight 128), the bindings' Services and load balancers, and the
    binding controller over the port's fake cluster and fake AWS."""

    def __init__(self, backend=None, drift: bool = False):
        aws = _port("cloudprovider.aws")
        cluster = _port("cluster")
        controller = _port("controllers.endpointgroupbinding")
        self.aws = backend if backend is not None else aws.FakeAWSBackend()
        driver = aws.AWSDriver(self.aws, self.aws, self.aws)
        self.aws.add_load_balancer("seed", REGION, _hostname("seed"))
        seed = self._service("seed")
        arn, _, _ = driver.ensure_global_accelerator_for_service(
            seed, seed.status.load_balancer.ingress[0], "other", "seed", REGION
        )
        group = driver.get_endpoint_group(driver.get_listener(arn).listener_arn)
        self.group_arn = group.endpoint_group_arn
        (self.seed_endpoint,) = [d.endpoint_id for d in group.endpoint_descriptions]
        self.aws.update_endpoint_group(self.group_arn, [
            aws.EndpointConfiguration(endpoint_id=self.seed_endpoint, weight=SEED_WEIGHT)
        ])
        self.cluster = cluster.FakeCluster()
        self.factory = cluster.SharedInformerFactory(self.cluster)
        self.controller = controller.EndpointGroupBindingController(
            self.cluster,
            self.factory,
            controller.EndpointGroupBindingConfig(drift_resync_period=30.0 if drift else 0.0),
            cloud_factory=lambda region: driver,
        )

    def close(self) -> None:
        self.controller.workqueue.shutdown()
        self.controller.recorder.shutdown()

    @staticmethod
    def _service(name: str):
        objects = _port("cluster.objects")
        svc = objects.Service(
            metadata=objects.ObjectMeta(name=name, namespace=NAMESPACE),
            spec=objects.ServiceSpec(
                type="LoadBalancer", ports=[objects.ServicePort(name="p80", port=80, protocol="TCP")]
            ),
        )
        svc.status.load_balancer.ingress.append(objects.LoadBalancerIngress(hostname=_hostname(name)))
        return svc

    def serve(self, name: str) -> None:
        """A Service behind a load balancer of its own."""
        self.aws.add_load_balancer(name, REGION, _hostname(name))
        self.cluster.create("Service", self._service(name))
        self.factory.informer("Service").sync_once()

    def bind(self, name: str, weight):
        """The Service ``name`` and a binding of it into the group at
        ``weight``; its finalizer pass run."""
        v1alpha1 = _port("apis.endpointgroupbinding.v1alpha1")
        objects = _port("cluster.objects")
        self.serve(name)
        self.cluster.create(KIND, v1alpha1.EndpointGroupBinding(
            metadata=objects.ObjectMeta(name=name, namespace=NAMESPACE),
            spec=v1alpha1.EndpointGroupBindingSpec(
                endpoint_group_arn=self.group_arn,
                weight=weight,
                service_ref=v1alpha1.ServiceReference(name=name),
            ),
        ))
        assert self.measure(name) == ([], 0, 0)  # the finalizer, no AWS call

    def measure(self, name: str) -> tuple[list[str], float, float]:
        """One pass of the binding ``name``: its endpoint-group calls and
        its (written, skipped) weight-sync outcomes."""
        before = len(self.aws.calls), _counted("written"), _counted("skipped")
        result = self.controller.reconcile(self.cluster.get(KIND, NAMESPACE, name))
        assert not result.requeue
        ops = [call[0] for call in self.aws.calls[before[0]:] if call[0] in GROUP_OPS]
        return ops, _counted("written") - before[1], _counted("skipped") - before[2]

    def edit_weight(self, name: str, weight, service: str | None = None) -> None:
        """Set the binding's weight and, given ``service``, its serviceRef."""
        obj = self.cluster.get(KIND, NAMESPACE, name)
        obj.spec.weight = weight
        if service is not None:
            obj.spec.service_ref = _port("apis.endpointgroupbinding.v1alpha1").ServiceReference(name=service)
        self.cluster.update(KIND, obj)

    def endpoint(self, name: str) -> str:
        (endpoint_id,) = self.cluster.get(KIND, NAMESPACE, name).status.endpoint_ids
        return endpoint_id

    def weights(self) -> dict:
        group = self.aws.describe_endpoint_group(self.group_arn)
        return {d.endpoint_id: d.weight for d in group.endpoint_descriptions}

    def tamper_weight(self, endpoint_id: str, weight: int) -> None:
        aws = _port("cloudprovider.aws")
        group = self.aws.describe_endpoint_group(self.group_arn)
        self.aws.update_endpoint_group(self.group_arn, [
            aws.EndpointConfiguration(
                endpoint_id=d.endpoint_id,
                weight=weight if d.endpoint_id == endpoint_id else d.weight,
                client_ip_preservation_enabled=d.client_ip_preservation_enabled,
            )
            for d in group.endpoint_descriptions
        ])


# ---------------------------------------------------------------------------
# the cases: each returns the binding whose pass was measured, the pass's
# (calls, written, skipped) and the group's weights after it
# ---------------------------------------------------------------------------


def _new_binding(world):
    world.bind("a", 100)
    return world.measure("a")


def _weight_edit(world):
    world.bind("a", 100)
    assert world.measure("a") == ([DESCRIBE, ADD], 0, 1)
    world.edit_weight("a", 200)
    return world.measure("a")


def _service_swap_with_weight_edit(world):
    # the churn of bench.py: a new weight and another Service in one
    # edit; the add carries the new weight, and the edit still writes it
    world.bind("a", 100)
    world.measure("a")
    old = world.endpoint("a")
    world.serve("a2")
    world.edit_weight("a", 50, service="a2")
    measured = world.measure("a")
    assert old not in world.weights()
    return measured


def _service_moved_to_another_load_balancer(world):
    # no edit of the binding: the Service's status names a new load
    # balancer, whose add carries the spec's weight
    world.bind("a", 100)
    world.measure("a")
    old = world.endpoint("a")
    world.aws.add_load_balancer("moved", REGION, _hostname("moved"))
    service = world.cluster.get("Service", NAMESPACE, "a")
    service.status.load_balancer.ingress[0].hostname = _hostname("moved")
    world.cluster.update_status("Service", service)
    world.factory.informer("Service").sync_once()
    measured = world.measure("a")
    assert old not in world.weights()
    return measured


def _drift_endpoint_removed(world):
    world.bind("a", 100)
    world.measure("a")
    world.aws.remove_endpoints(world.group_arn, [world.endpoint("a")])
    return world.measure("a")


def _drift_weight_tampered(world):
    world.bind("a", 100)
    world.measure("a")
    world.tamper_weight(world.endpoint("a"), 7)
    return world.measure("a")


def _no_weight(world):
    world.bind("a", None)
    return world.measure("a")


def _second_binding(world):
    world.bind("a", 100)
    world.measure("a")
    world.bind("b", 50)
    return world.measure("b")


def _first_of_two_edited(world):
    _second_binding(world)
    world.edit_weight("a", 200)
    return world.measure("a")


def _second_of_two_edited(world):
    _second_binding(world)
    world.edit_weight("b", 200)
    return world.measure("b")


CASES = {
    # id: (case, backend, drift on, calls, written, skipped, {binding: its weight after})
    "new-binding-skips-the-write": (_new_binding, None, False, [DESCRIBE, ADD], 0, 1, {"a": 100}),
    "weight-edit-writes": (_weight_edit, None, False, [DESCRIBE, DESCRIBE, UPDATE], 1, 0, {"a": 200}),
    "service-swap-edit-writes": (
        _service_swap_with_weight_edit, None, False, [DESCRIBE, "RemoveEndpoints", ADD, DESCRIBE, UPDATE], 1, 0,
        {"a": 50},
    ),
    "load-balancer-move-skips-the-write": (
        _service_moved_to_another_load_balancer, None, False, [DESCRIBE, "RemoveEndpoints", ADD], 0, 1, {"a": 100}
    ),
    "drift-readd-skips-the-write": (_drift_endpoint_removed, None, True, [DESCRIBE, ADD], 0, 1, {"a": 100}),
    "drift-tampered-weight-writes": (_drift_weight_tampered, None, True, [DESCRIBE, DESCRIBE, UPDATE], 1, 0, {"a": 100}),
    "no-weight-reported-none-skips": (_no_weight, None, False, [DESCRIBE, ADD], 0, 1, {"a": None}),
    "no-weight-reported-128-writes": (
        _no_weight, _aws_default_weight_backend, False, [DESCRIBE, ADD, DESCRIBE, UPDATE], 1, 0, {"a": SEED_WEIGHT}
    ),
    "second-binding-in-the-group": (_second_binding, None, False, [DESCRIBE, ADD], 0, 1, {"a": 100, "b": 50}),
    "first-of-two-edited": (_first_of_two_edited, None, False, [DESCRIBE, DESCRIBE, UPDATE], 1, 0, {"a": 200, "b": 50}),
    "second-of-two-edited": (_second_of_two_edited, None, False, [DESCRIBE, DESCRIBE, UPDATE], 1, 0, {"a": 100, "b": 200}),
}


@pytest.mark.parametrize("case_id", list(CASES))
def test_a_pass_writes_a_weight_only_where_it_saw_another(case_id):
    case, backend, drift, calls, written, skipped, bound = CASES[case_id]
    world = World(backend() if backend is not None else None, drift=drift)
    try:
        assert case(world) == (calls, written, skipped)
        weights = world.weights()
        assert weights == {
            world.seed_endpoint: SEED_WEIGHT,
            **{world.endpoint(name): weight for name, weight in bound.items()},
        }
        for name, weight in bound.items():
            # the pass left the binding converged: a second one is a no-op
            binding = world.cluster.get(KIND, NAMESPACE, name)
            assert binding.status.observed_generation == binding.metadata.generation
            assert world.measure(name) == (([DESCRIBE] if drift else []), 0, 0)
    finally:
        world.close()
