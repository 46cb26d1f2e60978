"""A staged create trusts the chain it is building: the port's
``AWSDriver`` with a topology cache and ``stage_requeue`` > 0 creates an
accelerator, its listener and its endpoint group in three passes with no
read between them, where the reference reads the chain back on each
resumed pass (``ListListeners``, then ``ListEndpointGroups``).

After its ``CreateAccelerator`` the driver opens a pending-create record
in the topology cache (``AcceleratorTopologyCache.begin_create``), and
the resumed passes answer from it.  The record ends at the endpoint
group's write, at a create call that raises, at ``invalidate``,
``remove`` or ``invalidate_all``, and ``verify_ttl`` after the chain's
last write; what it leaves is the write-through seed, not verified, so a
converge of the finished chain pays its one ``ListEndpointGroups`` as
drift verification demands.  Each case drives both packages' drivers
over their own ``FakeAWSBackend`` on a fake clock, a fresh driver per
pass over shared caches as the factory builds them, and fails against
the reference's code.

The packages are imported inside functions: the repository's linter
treats only ``agac_tpu``, ``tests`` and ``bench`` as first party."""

from __future__ import annotations

import collections
import importlib
import types

import pytest

from .test_torch_manager import canonical_aws

REF, PORT = "agac_tpu", "agac_tpu_torch"
NLB_NAME = "testlb"
REGION = "us-west-2"
NLB_HOSTNAME = "testlb-0123456789abcdef.elb.us-west-2.amazonaws.com"
CLUSTER = "default"
N = 3
VERIFY_TTL = 15.0
STAGE_REQUEUE = 0.01
# the calls of a chain's ensure: everything but the discovery snapshot's
# (ListAccelerators, ListTagsForResource) and the load balancer lookup
CHAIN_OPS = frozenset({
    "CreateAccelerator", "DescribeAccelerator", "UpdateAccelerator", "TagResource",
    "ListListeners", "CreateListener", "UpdateListener",
    "ListEndpointGroups", "CreateEndpointGroup", "UpdateEndpointGroup",
})
STAGED = ["CreateAccelerator", "CreateListener", "CreateEndpointGroup"]
REREAD = ["CreateAccelerator", "ListListeners", "CreateListener",
          "ListEndpointGroups", "CreateEndpointGroup"]
SKIPPED = "agac_chain_create_reads_skipped_total"


def _skipped(stage: str) -> float:
    metric = importlib.import_module(f"{PORT}.observability.metrics").registry().get(SKIPPED)
    return 0.0 if metric is None else metric.labels(stage=stage).value()


class Clock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self) -> float:
        return self.now


class World:
    """One package's fake account (one NLB), the shared read-plane
    caches on a fake clock, and a fresh staged driver per pass."""

    def __init__(self, package: str, backend=None):
        self.package = package
        self.objects = importlib.import_module(f"{package}.cluster.objects")
        self.apis = importlib.import_module(f"{package}.apis")
        aws = self.aws = importlib.import_module(f"{package}.cloudprovider.aws")
        cache = importlib.import_module(f"{package}.cloudprovider.aws.cache")
        self.errors = importlib.import_module(f"{package}.cloudprovider.aws.errors")
        self.backend = backend if backend is not None else aws.FakeAWSBackend()
        self.backend.add_load_balancer(NLB_NAME, REGION, NLB_HOSTNAME)
        self.clock = Clock()
        self.discovery = cache.DiscoveryCache(ttl=30.0, clock=self.clock)
        self.topology = cache.AcceleratorTopologyCache(
            verify_ttl=VERIFY_TTL, full_ttl=900.0, clock=self.clock
        )

    def driver(self):
        return self.aws.AWSDriver(
            self.backend, self.backend, self.backend,
            poll_interval=0.001, poll_timeout=1.0,
            discovery_cache=self.discovery, topology_cache=self.topology,
            stage_requeue=STAGE_REQUEUE,
        )

    def service(self, name: str):
        o = self.objects
        svc = o.Service(
            metadata=o.ObjectMeta(
                name=name,
                namespace="default",
                annotations={
                    self.apis.AWS_LOAD_BALANCER_TYPE_ANNOTATION: "external",
                    self.apis.AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION: "true",
                },
            ),
            spec=o.ServiceSpec(
                type="LoadBalancer",
                ports=[o.ServicePort(name="p80", port=80, protocol="TCP")],
            ),
        )
        svc.status.load_balancer.ingress.append(o.LoadBalancerIngress(hostname=NLB_HOSTNAME))
        return svc

    def ensure(self, name: str) -> types.SimpleNamespace:
        """One pass of ``name``'s reconcile: its result and the chain
        calls it made."""
        svc = self.service(name)
        before = len(self.backend.calls)
        arn, created, retry = self.driver().ensure_global_accelerator_for_service(
            svc, svc.status.load_balancer.ingress[0], CLUSTER, NLB_NAME, REGION
        )
        return types.SimpleNamespace(arn=arn, created=created, retry=retry, ops=self.ops(before))

    def ops(self, since: int) -> list[str]:
        return [call[0] for call in self.backend.calls[since:] if call[0] in CHAIN_OPS]

    def count(self, op: str) -> int:
        return sum(1 for call in self.backend.calls if call[0] == op)

    def world(self) -> dict:
        return canonical_aws(self.backend.snapshot_state())


def _names(n: int = N) -> list[str]:
    return [f"svc{i}" for i in range(n)]


def _storm(world: World, names: list[str]) -> dict[str, list[str]]:
    """Every object's staged create, interleaved as a creation storm
    runs them: each pass of every object, then the next pass; the chain
    calls of each object's create."""
    ops = collections.defaultdict(list)
    pending = list(names)
    while pending:
        still = []
        for name in pending:
            step = world.ensure(name)
            ops[name] += step.ops
            if step.retry > 0:
                still.append(name)
        world.clock.now += 1.0
        pending = still
    return dict(ops)


def test_a_staged_create_makes_no_read_between_its_creates():
    """N staged creates: the port's chain calls per create are its three
    creates, the reference's read the chain back twice between them;
    the worlds end equal, the counter reads N per stage, and the
    discovery snapshot is neither invalidated nor reloaded by it."""
    ref, port = World(REF), World(PORT)
    listener0, group0 = _skipped("listener"), _skipped("endpoint_group")
    ref_ops, port_ops = _storm(ref, _names()), _storm(port, _names())
    assert ref_ops == {name: REREAD for name in _names()}
    assert port_ops == {name: STAGED for name in _names()}
    assert port.world() == ref.world()
    assert len(port.world()["chains"]) == N
    assert _skipped("listener") - listener0 == N
    assert _skipped("endpoint_group") - group0 == N
    for stat in ("misses", "tag_full_refreshes"):
        assert port.discovery.stats()[stat] == ref.discovery.stats()[stat], stat
    for op in ("ListAccelerators", "ListTagsForResource"):
        assert port.count(op) == ref.count(op), op


def test_a_converge_of_a_finished_chain_pays_one_read():
    """The finished chain is the write-through seed, not verified: the
    next converge reads its tail once, right after the create as after
    ``verify_ttl`` (the reference's create reads the chain back, so its
    converge inside that window reads nothing)."""
    world = World(PORT)
    _storm(world, ["web"])
    assert world.ensure("web").ops == ["ListEndpointGroups"]
    assert world.ensure("web").ops == []
    world.clock.now += VERIFY_TTL + 1.0
    assert world.ensure("web").ops == ["ListEndpointGroups"]


def test_a_drift_tick_after_staged_creates_still_reads_every_chain():
    """A tick right after N staged creates verifies every chain by
    reading it: this process's own writes never count as verified."""
    world = World(PORT)
    _storm(world, _names())
    before = world.count("ListEndpointGroups")
    for name in _names():
        assert world.ensure(name).retry == 0
    assert world.count("ListEndpointGroups") - before >= N
    assert world.count("ListListeners") == 0


def _end_invalidate_all(world: World, arn: str) -> None:
    world.topology.invalidate_all()


def _end_remove(world: World, arn: str) -> None:
    world.topology.remove(arn)


def _end_invalidate(world: World, arn: str) -> None:
    world.topology.invalidate(arn)


def _end_ttl(world: World, arn: str) -> None:
    world.clock.now += VERIFY_TTL


ENDINGS = {
    "invalidate_all": _end_invalidate_all,
    "remove": _end_remove,
    "invalidate": _end_invalidate,
    "verify_ttl": _end_ttl,
}


# (stage the record ends before, ending) -> the chain calls of the pass
# that follows: a record dropped with its entry leaves nothing to verify,
# so the pass relists the chain; one that outlived its last write leaves
# the listener's seed, which one read verifies
RESUMED = {
    "listener": ["ListListeners", "CreateListener"],
    "endpoint_group": ["ListListeners", "ListEndpointGroups", "CreateEndpointGroup"],
    ("endpoint_group", "verify_ttl"): ["ListEndpointGroups", "CreateEndpointGroup"],
}


@pytest.mark.parametrize("ending", sorted(ENDINGS))
@pytest.mark.parametrize("stage", ["listener", "endpoint_group"])
def test_the_record_ends_and_the_next_pass_reads(stage, ending):
    """Two worlds, one create each: where the record ended before the
    ``stage``'s create, that pass reads the chain as the reference
    does; where it did not, the pass reads nothing.  Both chains end
    complete and equal."""
    ended, kept = World(PORT), World(PORT)
    arns = [world.ensure("web").arn for world in (ended, kept)]
    if stage == "endpoint_group":
        for world in (ended, kept):
            assert world.ensure("web").ops == ["CreateListener"]
    ENDINGS[ending](ended, arns[0])
    assert ended.ensure("web").ops == RESUMED.get((stage, ending), RESUMED[stage])
    resumed = ["CreateEndpointGroup"] if stage == "endpoint_group" else ["CreateListener"]
    assert kept.ensure("web").ops == resumed
    for world in (ended, kept):
        step = world.ensure("web")
        while step.retry > 0:
            step = world.ensure("web")
    assert ended.world() == kept.world()


def test_the_record_outlives_a_slow_stage_that_keeps_writing():
    """``verify_ttl`` counts from the chain's last write: a create whose
    stages are each some seconds apart, but under ``verify_ttl``, reads
    nothing."""
    world = World(PORT)
    assert world.ensure("web").ops == ["CreateAccelerator"]
    world.clock.now += VERIFY_TTL - 1.0
    assert world.ensure("web").ops == ["CreateListener"]
    world.clock.now += VERIFY_TTL - 1.0
    assert world.ensure("web").ops == ["CreateEndpointGroup"]


class _FailOnce:
    """A fake account whose first call of ``op`` raises a throttle, as
    AWS may answer any call."""

    def __init__(self, package: str, op: str):
        aws = importlib.import_module(f"{package}.cloudprovider.aws")
        errors = importlib.import_module(f"{package}.cloudprovider.aws.errors")
        failing = {"armed": False}

        class Backend(aws.FakeAWSBackend):
            pass

        def fail_once(self, *args, **kwargs):
            if failing["armed"]:
                failing["armed"] = False
                raise errors.AWSAPIError("ThrottlingException", "Rate exceeded")
            return getattr(aws.FakeAWSBackend, op)(self, *args, **kwargs)

        setattr(Backend, op, fail_once)
        self.backend = Backend()
        self.failing = failing


@pytest.mark.parametrize(
    "op, before, after",
    [
        ("create_listener", [], ["ListListeners", "CreateListener"]),
        ("create_endpoint_group", ["CreateListener"], ["ListEndpointGroups", "CreateEndpointGroup"]),
    ],
    ids=["listener", "endpoint-group"],
)
def test_a_create_call_that_raises_ends_the_record(op, before, after):
    """A create of the chain that raises ends the record: the retried
    pass reads what AWS holds, and the chain ends complete."""
    failing = _FailOnce(PORT, op)
    world = World(PORT, backend=failing.backend)
    assert world.ensure("web").ops == ["CreateAccelerator"]
    if before:
        assert world.ensure("web").ops == before
    failing.failing["armed"] = True
    start = len(world.backend.calls)
    with pytest.raises(world.errors.AWSAPIError):
        world.ensure("web")
    assert world.ops(start) == []  # no read before the create that raised
    retried = world.ensure("web")
    assert retried.ops == after
    while retried.retry > 0:
        retried = world.ensure("web")
    reference = World(REF)
    _storm(reference, ["web"])
    assert world.world() == reference.world()


def test_an_accelerator_deleted_between_the_stages_is_created_again():
    """An accelerator deleted out of band after its create: the pass
    that resumes the chain fails at its CreateListener, which ends the
    record; the next pass reads AWS as the reference does, and once
    the discovery snapshot expires the object gets a chain of its own,
    the same world the reference ends in."""
    ends = {}
    for package in (PORT, REF):
        world = World(package)
        first = world.ensure("web")
        world.backend.update_accelerator(first.arn, enabled=False)
        world.backend.delete_accelerator(first.arn)
        world.clock.now += 1.0
        calls = []
        for _ in range(4):
            before = len(world.backend.calls)
            with pytest.raises(world.errors.AWSAPIError):
                world.ensure("web")
            calls.append(world.ops(before))
            world.clock.now += 1.0
        world.clock.now += 30.0  # past the discovery snapshot's ttl
        step = world.ensure("web")
        assert step.created and step.arn != first.arn
        while step.retry > 0:
            step = world.ensure("web")
        ends[package] = (calls, world.world())
    port_calls, port_world = ends[PORT]
    ref_calls, ref_world = ends[REF]
    assert port_calls[0] == []  # its CreateListener failed: no read before it
    assert port_calls[1:] == ref_calls[1:] == [["ListListeners"]] * 3
    assert ref_calls[0] == ["ListListeners"]
    assert port_world == ref_world
    assert list(port_world["chains"]) == ["service/default/web"]
