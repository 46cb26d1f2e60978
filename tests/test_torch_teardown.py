"""Teardown and the orphan sweeper over processes, held against the
reference and to the faults the port fixes on this path.

- ``test_teardown_fleets_agree_with_the_reference``: ``chip_smoke.teardown_fleet``
  through ``python -m agac_tpu controller`` and ``python -m agac_tpu_torch
  controller`` at 20 Services (two hostname-annotated kept, two
  deleted), two replicas at ``--shard-count 2`` with the sweeper on:
  half the fleet is deleted, the holder of a shard is killed
  mid-teardown, and the survivor's sweeper must mop its orphans up.
  ``teardown_fleet`` holds each run to the phase's bounds (the end
  state, no false positive at any read of the account, the mop-up
  bound, no second disable, the quota, explain and journeys); here
  both end with equal canonical AWS state, ARNs replaced by owner
  keys.  The killed replica holds shard 1, the heavier one at this
  size: with shard 0 killed, the reference's survivor counts itself
  overloaded against the dead holder's stale load and never steals
  (a fault of ``ROADMAP.md`` Queue 3 that the port fixes).
- ``test_a_sweep_hands_at_most_its_budget_to_teardown_workers``: with
  every teardown parking on its settle wait, a sweep over 25 orphans
  starts 10 teardowns (``--gc-max-deletes``), each resumed from the
  pending-settle table and disabled once.  The reference's sweep tears
  every eligible orphan down inline, counts a parked one as failed and
  charges it nothing, so one sweep starts all 25.
- ``test_a_disable_keeps_the_discovery_snapshot``: after a teardown's
  disable, the command line's driver finds the next owner without
  reading any accelerator's tags again.  The reference drops the
  snapshot at every disable, and its next lookup re-reads every tag.
- ``test_an_adoption_reloads_the_discovery_snapshot_once``: after an
  adoption the discovery snapshot is listed anew but keeps the tags of
  the accelerators it knew, and the resync that follows keeps the
  reloaded snapshot.  The reference drops everything at the adoption
  and again at the resync, and re-reads every accelerator's tags.
- ``test_a_drain_sees_every_accelerator_while_another_process_deletes``:
  the durable fake account's ListAccelerators pages by cursor, so a
  drain misses nothing while another process deletes.  The reference
  pages by offset and skips the accelerator that crosses the page
  boundary.
- ``test_the_gc_block_counts_each_shard_once``: after a replica adopts
  shard 0 beside shard 1, its ``/healthz`` gc block merges the last
  report of each shard once.  The reference adds the stale ``"1"`` and
  ``"none"`` reports to the new ``"0,1"`` one for ever.

The port, the reference and ``chip_smoke`` are imported inside the
tests only (the repository's linter treats the port as third party)."""

from __future__ import annotations

import concurrent.futures
import importlib
import os
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from .test_torch_manager import canonical_aws

PORT = "agac_tpu_torch"
PACKAGES = ("agac_tpu", PORT)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SERVICES = 20
# one hostname per five Services: two kept, two deleted
HOSTNAME_EVERY = 5
# the teardown must outlast the watch's 0.1 s reads, so the kill lands
# while it runs
LATENCY = 0.2


def _port(name: str):
    return importlib.import_module(f"{PORT}.{name}")


def _settled(canon: dict) -> dict:
    """``canonical_aws`` without the accelerators' status: how many
    reads of the fake account an accelerator took to settle depends on
    which process read it when, not on what the controllers did."""
    chains = {
        owner: sorted(chain[:2] + chain[3:] for chain in entries)
        for owner, entries in canon["chains"].items()
    }
    return {**canon, "chains": chains}


@pytest.fixture(scope="module")
def smoke():
    return importlib.import_module("chip_smoke")


@pytest.fixture(scope="module")
def fleets(smoke, tmp_path_factory):
    # made before the threads: two first calls at once race on the base directory
    workdirs = {package: tmp_path_factory.mktemp(package) for package in PACKAGES}

    def run(package: str) -> dict:
        return smoke.teardown_fleet(
            smoke.load(package), package, N_SERVICES, LATENCY,
            workdirs[package], hostname_every=HOSTNAME_EVERY, victim_shard=1,
        )

    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        futures = {package: pool.submit(run, package) for package in PACKAGES}
        return {package: future.result() for package, future in futures.items()}


def test_teardown_fleets_agree_with_the_reference(fleets):
    for run in fleets.values():
        assert run["hostnames"] == {"kept": 2, "deleted": 2}
        assert run["kill"]["owned"] == [1] and run["kill"]["victim_orphans"] > 0
        assert run["gc_survivor"]["deleted_total"] >= run["kill"]["victim_orphans"]
        assert run["mop_up_s"] <= run["mop_up_bound_s"]
        assert run["exit"] == 0
    ref, port = (_settled(canonical_aws(fleets[p]["aws_state"])) for p in PACKAGES)
    kept = {f"service/default/shard{i:04d}" for i in range(1, N_SERVICES, 2)}
    assert set(port["chains"]) == kept
    assert all(len(chain) == 1 for chain in port["chains"].values())
    assert port == ref


class _Orphans:
    """An in-process Manager over a fake cluster and a fake account
    whose accelerators settle through two reads, with ``n`` complete
    accelerator chains whose owner Services do not exist."""

    def __init__(self, n: int):
        from agac_tpu_torch.cloudprovider.aws import AWSDriver, FakeAWSBackend
        from agac_tpu_torch.cluster import FakeCluster
        from agac_tpu_torch.controllers import GarbageCollectorConfig
        from agac_tpu_torch.manager import ControllerConfig, Manager
        from agac_tpu_torch.reconcile.pending import PendingSettleTable

        hostname = "lb-0123456789abcdef.elb.us-west-2.amazonaws.com"
        self.aws = FakeAWSBackend(settle_describes=2, quota_accelerators=n + 10)
        self.aws.add_load_balancer("lb", "us-west-2", hostname)
        table = PendingSettleTable()
        driver = AWSDriver(
            self.aws, self.aws, self.aws, poll_interval=0.01, poll_timeout=5.0,
            settle_table=table,
        )
        objects, apis = _port("cluster.objects"), _port("apis")
        for i in range(n):
            svc = objects.Service(
                metadata=objects.ObjectMeta(
                    name=f"ghost{i:02d}", namespace="default",
                    annotations={apis.AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION: "true",
                                 apis.AWS_LOAD_BALANCER_TYPE_ANNOTATION: "external"},
                ),
                spec=objects.ServiceSpec(
                    type="LoadBalancer",
                    ports=[objects.ServicePort(name="http", port=80, protocol="TCP")],
                ),
            )
            svc.status.load_balancer.ingress.append(objects.LoadBalancerIngress(hostname=hostname))
            driver.ensure_global_accelerator_for_service(
                svc, svc.status.load_balancer.ingress[0], "default", "lb", "us-west-2"
            )
        assert self.aws.chain_counts() == (n, n, n)
        self.stop = threading.Event()
        config = ControllerConfig(
            garbage_collector=GarbageCollectorConfig(
                interval=3600.0, grace_sweeps=2, max_deletes=10, cluster_name="default"
            ),
            settle_poll_interval=0.05,
        )
        for part in (config.global_accelerator, config.route53):
            part.cluster_name = "default"
        self.manager = Manager(resync_period=30.0)
        self.manager.gc_hands_over = True
        self.manager.run(
            FakeCluster(), config, self.stop, cloud_factory=lambda region: driver,
            block=False, settle_table=table,
        )

    def count(self, op: str) -> int:
        return sum(1 for call in list(self.aws.calls) if call[0] == op)


def _wait_until(predicate, timeout: float = 20.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.05)
    return predicate()


def test_a_sweep_hands_at_most_its_budget_to_teardown_workers():
    world = _Orphans(25)
    try:
        assert _wait_until(lambda: world.manager.gc_sweep().get("skipped_unsynced") is False)
        second = world.manager.gc_sweep()
        assert second["deleted"]["accelerators"] == 10
        assert second["budget_deferred"] == 15
        # the ten handed over come down on the workers, parked once each
        assert _wait_until(lambda: len(world.aws.all_accelerator_arns()) == 15)
        time.sleep(0.5)
        assert world.count("DeleteEndpointGroup") == 10
        updates = [call[1] for call in world.aws.calls if call[0] == "UpdateAccelerator"]
        assert len(updates) == len(set(updates)) == 10
        third = world.manager.gc_sweep()
        assert third["deleted"]["accelerators"] == 10
        assert _wait_until(lambda: len(world.aws.all_accelerator_arns()) == 5)
    finally:
        world.stop.set()


_LOOKUP_SCRIPT = textwrap.dedent(
    """
    import json, sys
    from {package}.cloudprovider.aws import factory
    from {package}.cloudprovider.aws.types import PortRange, Tag
    from {package}.reconcile.pending import SettleWait

    backend = factory.shared_fake_backend()
    arns = []
    for i in range(30):
        tags = [Tag("aws-global-accelerator-controller-managed", "true"),
                Tag("aws-global-accelerator-cluster", "default"),
                Tag("aws-global-accelerator-owner", f"service/default/svc{{i}}")]
        arn = backend.create_accelerator(f"a{{i}}", "IPV4", True, tags).accelerator_arn
        backend.create_listener(arn, [PortRange(80, 80)], "TCP", "NONE")
        for _ in range(3):
            backend.describe_accelerator(arn)
        arns.append(arn)
    driver = factory.real_cloud_factory("us-west-2")
    owner = lambda i: driver.list_global_accelerator_by_resource("default", "service", "default", f"svc{{i}}")
    assert [a.accelerator_arn for a in owner(0)] == [arns[0]]
    try:
        driver.cleanup_global_accelerator(arns[0])
    except SettleWait:
        pass
    tags_before = sum(1 for c in backend.calls if c[0] == "ListTagsForResource")
    found = owner(0) + owner(1)
    tags_after = sum(1 for c in backend.calls if c[0] == "ListTagsForResource")
    print(json.dumps({{"tag_reads": tags_after - tags_before,
                      "found": [(a.accelerator_arn == arns[0], a.enabled) for a in found]}}))
    """
)


def _run_script(script: str, **env) -> str:
    run = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(
            os.environ, AGAC_CLOUD="fake", AGAC_FAKE_QUOTA_ACCELERATORS="100",
            POD_NAMESPACE="kube-system", **env,
        ),
    )
    assert run.returncode == 0, run.stderr[-3000:]
    return run.stdout.strip().splitlines()[-1]


def test_a_disable_keeps_the_discovery_snapshot():
    import json

    out = json.loads(_run_script(_LOOKUP_SCRIPT.format(package=PORT), AGAC_FAKE_SETTLE="2"))
    # the disabled accelerator is still found, as disabled, and the
    # other owner's lookup reads no tags
    assert out == {"tag_reads": 0, "found": [[True, False], [False, True]]}


_ADOPTION_SCRIPT = textwrap.dedent(
    """
    import json
    from {package}.cloudprovider.aws import factory
    from {package}.cloudprovider.aws.types import Tag

    backend = factory.shared_fake_backend()
    def create(i):
        tags = [Tag("aws-global-accelerator-controller-managed", "true"),
                Tag("aws-global-accelerator-cluster", "default"),
                Tag("aws-global-accelerator-owner", f"service/default/svc{{i}}")]
        backend.create_accelerator(f"a{{i}}", "IPV4", True, tags)
    for i in range(30):
        create(i)
    driver = factory.real_cloud_factory("us-west-2")
    lookup = lambda i: driver.list_global_accelerator_by_resource("default", "service", "default", f"svc{{i}}")
    count = lambda op: sum(1 for c in backend.calls if c[0] == op)
    reads = lambda: (count("ListAccelerators"), count("ListTagsForResource"))
    lookup(0)
    # the command line's wiring: the reference's drops the read plane at both
    hooks = getattr(factory, "adoption_hooks", lambda: (factory.invalidate_read_plane,) * 2)
    on_adopt, on_reshard = hooks()
    create(30)  # another process's create, unseen by this one
    before = reads()
    on_adopt()
    found = len(lookup(30))
    after_adopt = reads()
    on_reshard()
    lookup(0)
    after_resync = reads()
    print(json.dumps([found, [a - b for a, b in zip(after_adopt, before)],
                      [a - b for a, b in zip(after_resync, after_adopt)]]))
    """
)


def test_an_adoption_reloads_the_discovery_snapshot_once():
    """After an adoption the next lookup lists every accelerator again
    and finds the one another process created, reading the tags of
    that one alone; the resync's lookup after it reads nothing."""
    import json

    found, adopt, resync = json.loads(_run_script(_ADOPTION_SCRIPT.format(package=PORT)))
    assert found == 1
    assert adopt == [1, 1]
    assert resync == [0, 0]


def test_a_drain_sees_every_accelerator_while_another_process_deletes(tmp_path):
    fake = _port("cloudprovider.aws.fake_backend")
    types = _port("cloudprovider.aws.types")
    state = str(tmp_path / "aws-state.json")
    writer = fake.FileBackedFakeAWSBackend(state, quota_accelerators=200)
    reader = fake.FileBackedFakeAWSBackend(state)
    for i in range(150):
        writer.create_accelerator(f"a{i}", "IPV4", False, [types.Tag("n", str(i))])
    first, token = reader.list_accelerators(100, None)
    assert len(first) == 100 and token
    writer.delete_accelerator(first[10].accelerator_arn)
    time.sleep(reader.READ_RELOAD_INTERVAL * 2)
    second, token = reader.list_accelerators(100, token)
    assert token is None
    seen = {a.accelerator_arn for a in first + second}
    assert set(writer.all_accelerator_arns()) <= seen
    assert len(seen) == 150


def test_the_gc_block_counts_each_shard_once():
    from agac_tpu_torch.cloudprovider.aws import AWSDriver, FakeAWSBackend
    from agac_tpu_torch.cloudprovider.aws.types import Tag
    from agac_tpu_torch.cluster import FakeCluster, SharedInformerFactory
    from agac_tpu_torch.controllers import GarbageCollector, GarbageCollectorConfig
    from agac_tpu_torch.sharding import HashRing, ShardFilter

    aws = FakeAWSBackend(quota_accelerators=50)
    ring = HashRing(2)
    names = {0: [], 1: []}
    for i in range(40):
        names[ring.shard_for_key(f"default/ghost{i}")].append(f"ghost{i}")
    for shard in (0, 1):
        for name in names[shard][:3]:
            aws.create_accelerator(name, "IPV4", True, [
                Tag("aws-global-accelerator-controller-managed", "true"),
                Tag("aws-global-accelerator-cluster", "default"),
                Tag("aws-global-accelerator-owner", f"service/default/{name}"),
            ])
    stop = threading.Event()
    factory = SharedInformerFactory(FakeCluster(), resync_period=30.0)
    factory.informer("Service")
    factory.informer("Ingress")
    factory.start(stop)
    try:
        assert factory.wait_for_cache_sync(stop)
        driver = AWSDriver(aws, aws, aws, poll_interval=0.01, poll_timeout=2.0)
        owned = {"shards": frozenset()}
        gc = GarbageCollector(
            factory, GarbageCollectorConfig(interval=1.0, grace_sweeps=5, max_deletes=10),
            lambda region: driver, shard_filter=ShardFilter(ring, lambda: owned["shards"]),
        )
        gc.sweep_once()  # owns nothing: skipped
        owned["shards"] = frozenset({1})
        gc.sweep_once()
        owned["shards"] = frozenset({0, 1})
        last = gc.sweep_once()
        status = gc.status()
        assert sorted(status["per_shard"]) == ["0,1"]
        assert status["last_sweep"]["candidates"] == last["candidates"] == {
            "accelerators": 6, "records": 0,
        }
        assert "skipped_no_shards" not in status["last_sweep"]
    finally:
        stop.set()
