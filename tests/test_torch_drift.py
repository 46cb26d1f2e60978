"""Drift resync over processes, held against the reference, and the
faults of the port's sharding plane, durable fake account and watch
that this path fixes.

- ``test_drift_fleets_agree_with_the_reference``: ``chip_smoke.drift_fleet``
  through ``python -m agac_tpu controller`` and ``python -m agac_tpu_torch
  controller`` at 20 Services (4 hostname-annotated, 2 Ingresses, 4
  EndpointGroupBindings into out-of-band chains), two replicas at
  ``--shard-count 2 --drift-resync-period 3``: in each shard a listener
  is deleted and a binding's endpoint removed out of band, the holder of
  shard 1 is killed at its shard's first repair, and the survivor must
  repair the rest; then the bindings are deleted and their finalizers
  remove their endpoints.  ``drift_fleet`` holds each run to the
  phase's bounds; here both end with equal canonical AWS state.  Shard
  1's holder is the victim: with shard 0 killed at this size the
  reference's survivor never steals (``ROADMAP.md`` Queue 3).
- ``test_both_command_lines_give_the_same_stage_catalog``: the stage
  accountant's stages in the replicas' ``/metrics`` of those runs, the
  same but for the port's ``drift-tick``, to which its ticker charges
  its enqueue loop.
- ``test_drift_reports_count_each_shard_once_across_a_takeover``: two
  in-process Managers on one fake cluster, one shard each, tick drift;
  an open circuit marks one's report partial; after it releases its
  shard the other adopts it and ticks again.  Its merged report counts
  each shard once; the reference's adds the stale report of the shard
  it held before (a deliberate difference, ``PERF.md`` §7).
- ``test_a_shed_lease_is_renewed_while_its_reconcile_runs``: a replica
  sheds a shard while a worker sits inside a reconcile of one of its
  keys for longer than the lease duration, a peer ready to claim.  The
  peer must not hold the lease before the reconcile returns.  The
  reference releases the lease at once (the case fails against its
  code).
- ``test_a_shutdown_leaves_a_busy_lease_to_expire``: a replica shuts
  down while a worker is still inside a reconcile past the renew
  deadline.  The lease of that key's shard is left to expire, not
  released, so a peer cannot claim it at once (the reference releases
  it).
- ``test_a_settle_counts_reads_from_both_writers``: two instances of the
  durable fake account on one state file, one reading an accelerator
  that settles after three reads while the other writes.  It must
  settle at the third read; the reference's count restarts at every
  reload of the other's write and never settles.
- ``test_an_idle_watch_resumes_without_a_relist``: a watch over HTTP
  that idles past several read timeouts must still deliver the next
  event.  The reference's stream dies at the second timeout (CPython
  refuses every read after one), so each idle informer relists every
  five seconds.
- ``test_the_apiserver_ends_a_watch_its_client_closed``: the test
  apiserver's thread serving a watch must end once its client closes
  the connection.  The reference's polls the store until the watch's
  240 s timeout, so each idle informer left one such thread every five
  seconds, up to 48 per informer.
- ``test_a_slow_enqueue_loop_does_not_push_the_next_tick_later``: a
  ticker whose enqueue loop takes most of a period must still tick a
  period apart.  The reference waits a whole period after each loop, so
  its ticks drift by the loop's length each time (seconds a tick over
  1,200 objects while busy workers hold the interpreter).
- ``test_a_repaired_disable_keeps_the_discovery_snapshot``: an
  accelerator disabled out of band and repaired by the ensure path
  leaves the discovery snapshot loaded, the repair folded in with the
  tags AWS then holds.  The reference drops the snapshot, so its next
  lookup re-reads every accelerator's tags (1,200 reads a repaired
  disable on the documented fleet).

The port, the reference and ``chip_smoke`` are imported inside the
tests only (the repository's linter treats the port as third party)."""

from __future__ import annotations

import concurrent.futures
import importlib
import threading
import time

import pytest

from .test_torch_manager import canonical_aws

PORT = "agac_tpu_torch"
PACKAGES = ("agac_tpu", PORT)
N_SERVICES = 20
HOSTNAME_EVERY = 5
N_BINDINGS = 4
PERIOD = 3.0
LATENCY = 0.05


def _module(package: str, name: str):
    return importlib.import_module(f"{package}.{name}")


def _port(name: str):
    return _module(PORT, name)


@pytest.fixture(scope="module")
def smoke():
    return importlib.import_module("chip_smoke")


@pytest.fixture(scope="module")
def fleets(smoke, tmp_path_factory):
    # made before the threads: two first calls at once race on the base directory
    workdirs = {package: tmp_path_factory.mktemp(package) for package in PACKAGES}

    def run(package: str) -> dict:
        return smoke.drift_fleet(
            smoke.load(package), package, N_SERVICES, LATENCY, workdirs[package],
            period=PERIOD, hostname_every=HOSTNAME_EVERY, tampers=("listener", "endpoint"),
            victim_shard=1, n_bindings=N_BINDINGS,
        )

    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        futures = {package: pool.submit(run, package) for package in PACKAGES}
        return {package: future.result() for package, future in futures.items()}


def test_drift_fleets_agree_with_the_reference(fleets):
    for run in fleets.values():
        assert (run["services"], run["ingresses"], run["bindings"]) == (20, 2, 4)
        assert run["kill"]["owned"] == [1] and run["kill"]["open"]
        assert sorted((r["kind"], r["shard"]) for r in run["repairs"]) == [
            ("endpoint", 0), ("endpoint", 1), ("listener", 0), ("listener", 1),
        ]
        assert all(r["repair_s"] <= r["bound_s"] for r in run["repairs"])
        assert run["exit"] == 0
    ref, port = (canonical_aws(fleets[p]["aws_state"]) for p in PACKAGES)
    external = {f"service/external/ext{k:04d}" for k in range(N_BINDINGS)}
    assert external <= set(port["chains"])
    assert len(port["chains"]) == N_SERVICES + 2 + N_BINDINGS
    assert port == ref


def test_both_command_lines_give_the_same_stage_catalog(fleets):
    catalogs = {p: fleets[p]["stages"]["catalog"] for p in PACKAGES}
    assert {"driver-mutate", "queue-pop", "self-tax"} <= set(catalogs[PORT])
    # the port's ticker charges its enqueue loop to the drift-tick stage
    # (the reference's charges it to none); the port's bindings make no
    # UpdateEndpointGroup here, where each add and each re-add that
    # repairs a removed endpoint has set the spec's weight (the
    # reference writes it again); every other stage is shared
    assert "drift-tick" in catalogs[PORT] and "drift-tick" not in catalogs["agac_tpu"]
    resent = "aws:globalaccelerator.update_endpoint_group"
    assert resent in catalogs["agac_tpu"] and resent not in catalogs[PORT]
    assert [stage for stage in catalogs[PORT] if stage != "drift-tick"] == [
        stage for stage in catalogs["agac_tpu"] if stage != resent
    ]


def _reports(package: str) -> dict:
    """Two Managers of ``package``, one shard each, through drift ticks,
    an open route53 circuit on the first, and the second's adoption of
    the first's shard after a clean release."""
    objects, apis = _module(package, "cluster.objects"), _module(package, "apis")
    manager_mod, sharding = _module(package, "manager"), _module(package, "sharding")
    health = _module(package, "cloudprovider.aws.health")
    cluster = _module(package, "cluster.fake").FakeCluster()
    for i in range(12):
        annotations = {
            apis.AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION: "true",
            apis.AWS_LOAD_BALANCER_TYPE_ANNOTATION: "external",
        }
        if i % 3 == 0:
            annotations[apis.ROUTE53_HOSTNAME_ANNOTATION] = f"svc{i}.example.com"
        svc = objects.Service(
            metadata=objects.ObjectMeta(name=f"svc{i:02d}", namespace="default", annotations=annotations),
            spec=objects.ServiceSpec(
                type="LoadBalancer", ports=[objects.ServicePort(name="http", port=80, protocol="TCP")]
            ),
        )
        svc.status.load_balancer.ingress.append(
            objects.LoadBalancerIngress(hostname="lb-0123456789abcdef.elb.us-west-2.amazonaws.com")
        )
        cluster.create("Service", svc)
    stop = threading.Event()
    managers, trackers = [], []
    try:
        for identity in ("a", "b"):
            tracker = health.HealthTracker(
                health.HealthConfig(window=10.0, min_calls=2, open_duration=600.0, aimd_qps=0),
                sleep=lambda s: None,
            )
            trackers.append(tracker)
            manager = manager_mod.Manager(health=tracker)
            config = manager_mod.ControllerConfig(
                sharding=sharding.ShardingConfig(shard_count=2, shards_per_replica=2, identity=identity)
            )
            factory = manager.build(cluster, config)
            factory.start(stop)
            assert factory.wait_for_cache_sync(stop)
            managers.append(manager)
        a, b = managers
        a.shard_membership.tick(cluster)
        b.shard_membership.tick(cluster)
        owned = [sorted(m.shard_membership.owned_shards()) for m in managers]
        a.drift_tick()
        b.drift_tick()
        circuit = trackers[0].service("route53")
        circuit.record("server-error")
        circuit.record("server-error")
        a.drift_tick()
        a.shard_membership.release_all(cluster)
        b.shard_membership.tick(cluster)
        adopted = sorted(b.shard_membership.owned_shards())
        b.drift_tick()
        return {
            "owned": owned, "adopted": adopted, "a": a.last_drift_report,
            "b": b.last_drift_report, "b_tokens": sorted(b.last_drift_reports),
        }
    finally:
        stop.set()


def test_drift_reports_count_each_shard_once_across_a_takeover():
    port, ref = _reports(PORT), _reports("agac_tpu")
    assert port["owned"] == ref["owned"] == [[0], [1]]
    assert port["adopted"] == ref["adopted"] == [0, 1]
    # the replica with the open circuit skips the route53 controller
    # and says so; the same report in both packages
    assert port["a"]["partial"] is True
    assert port["a"]["skipped"] == {"route53-controller": ["route53"]}
    assert port["a"] == ref["a"]
    # the adopter's report counts each of the 12 Services (4 with a
    # hostname) once
    assert port["b_tokens"] == ["0,1"]
    assert port["b"]["partial"] is False
    assert port["b"]["enqueued"] == {
        "global-accelerator-controller": 12, "route53-controller": 4,
        "endpoint-group-binding-controller": 0,
    }
    # the reference keeps the report of the shard it held before and
    # counts that shard's keys twice
    assert ref["b_tokens"] == ["0,1", "1"]
    assert all(
        ref["b"]["enqueued"][name] > count for name, count in port["b"]["enqueued"].items() if count
    )


def _memberships(rebalance_cooldown_ticks: int = 6):
    sharding = _port("sharding")
    leaderelection = _port("leaderelection")
    lease = leaderelection.LeaderElectionConfig(lease_duration=15.0, renew_deadline=1.0, retry_period=0.5)
    now = [1000.0]

    def member(identity: str):
        config = sharding.ShardingConfig(
            shard_count=2, shards_per_replica=2, lease=lease, rebalance_hysteresis_keys=1,
            rebalance_cooldown_ticks=rebalance_cooldown_ticks,
        )
        membership = sharding.ShardMembership(config, identity=identity, clock=lambda: now[0])
        membership.fleet_key_counts = lambda: {0: 10, 1: 2}
        return membership

    return member("donor"), member("peer"), now


def _key_on(shard: int) -> str:
    ring = _port("sharding.ring").HashRing(2)
    return next(f"default/svc-{i}" for i in range(100) if ring.shard_for_key(f"default/svc-{i}") == shard)


def _held(membership, key: str):
    """A worker of ``membership`` inside a reconcile of ``key`` until the
    returned event is set."""
    common = _port("controllers.common")
    inside, release = threading.Event(), threading.Event()

    def reconcile(arg):
        inside.set()
        assert release.wait(60)

    worker = threading.Thread(target=common.with_shard_guard(membership.filter, reconcile), args=(key,))
    worker.start()
    assert inside.wait(30)
    return worker, release


def test_a_shed_lease_is_renewed_while_its_reconcile_runs():
    cluster = _port("cluster.fake").FakeCluster()
    # the cooldown keeps the donor from claiming back what it shed
    donor, peer, now = _memberships(rebalance_cooldown_ticks=200)
    for _ in range(3):
        donor.tick(cluster)
        now[0] += 0.5
    assert donor.owned_shards() == {0, 1}
    worker, release = _held(donor, _key_on(1))
    try:
        # 40 s of ticks, more than two lease durations: the donor sheds
        # shard 1 at once, and the peer, below its capacity, is ready
        for _ in range(80):
            now[0] += 0.5
            donor.tick(cluster)
            peer.tick(cluster)
            assert 1 not in peer.owned_shards()
        assert donor.owned_shards() == {0}
    finally:
        release.set()
        worker.join(30)
    for _ in range(4):
        now[0] += 0.5
        donor.tick(cluster)
        peer.tick(cluster)
    assert peer.owned_shards() == {1} and donor.owned_shards() == {0}


def test_a_shutdown_leaves_a_busy_lease_to_expire():
    cluster = _port("cluster.fake").FakeCluster()
    donor, peer, now = _memberships()
    for _ in range(3):
        donor.tick(cluster)
        now[0] += 0.5
    assert donor.owned_shards() == {0, 1}
    worker, release = _held(donor, _key_on(1))
    try:
        started = time.monotonic()
        donor.release_all(cluster)  # waits the 1 s renew deadline out
        assert time.monotonic() - started < 5
        # shard 0 is released and claimed at once; shard 1 only once
        # its lease has expired, one lease duration later
        for _ in range(28):
            now[0] += 0.5
            peer.tick(cluster)
            assert 1 not in peer.owned_shards()
        assert peer.owned_shards() == {0}
    finally:
        release.set()
        worker.join(30)
    # expired now: the peer takes it once its availability grace passes
    for _ in range(20):
        now[0] += 0.5
        peer.tick(cluster)
    assert peer.owned_shards() == {0, 1}


def test_a_settle_counts_reads_from_both_writers(tmp_path):
    fake = _port("cloudprovider.aws.fake_backend")
    types = _port("cloudprovider.aws.types")
    state = str(tmp_path / "aws-state.json")
    writer = fake.FileBackedFakeAWSBackend(state, settle_describes=3, quota_accelerators=20)
    reader = fake.FileBackedFakeAWSBackend(state, settle_describes=3, quota_accelerators=20)
    arn = writer.create_accelerator("a", "IPV4", True, [types.Tag("n", "a")]).accelerator_arn
    time.sleep(2 * reader.READ_RELOAD_INTERVAL)
    statuses = []
    for i in range(5):
        statuses.append(reader.describe_accelerator(arn).status)
        writer.create_accelerator(f"b{i}", "IPV4", True, [types.Tag("n", str(i))])
        time.sleep(2 * reader.READ_RELOAD_INTERVAL)
    assert statuses == ["IN_PROGRESS", "IN_PROGRESS", "DEPLOYED", "DEPLOYED", "DEPLOYED"]
    assert fake.FileBackedFakeAWSBackend(state).describe_accelerator(arn).status == "DEPLOYED"


def test_an_idle_watch_resumes_without_a_relist():
    objects = _port("cluster.objects")
    rest = _port("cluster.rest")
    server = _port("cluster.testserver").TestApiServer().start()
    stop, ended = threading.Event(), threading.Event()
    events = []
    try:
        client = rest.RestClusterClient(server.url)
        client.WATCH_POLL_INTERVAL = 0.2

        def consume():
            for event in client.watch("Service", "0", stop.is_set):
                events.append((event.type, event.obj.metadata.name))
                stop.set()
            ended.set()

        threading.Thread(target=consume, daemon=True).start()
        time.sleep(1.0)  # several idle read timeouts
        assert not ended.is_set(), "the watch ended while idle: the informer would relist"
        rest.RestClusterClient(server.url).create(
            "Service", objects.Service(metadata=objects.ObjectMeta(name="late", namespace="default"))
        )
        assert ended.wait(10)
        assert events == [("ADDED", "late")]
    finally:
        stop.set()
        server.stop()


def test_the_apiserver_ends_a_watch_its_client_closed():
    import http.client

    server = _port("cluster.testserver").TestApiServer().start()
    try:
        host, port = server.url.split("//", 1)[1].split(":")
        before = threading.active_count()
        connections = []
        for _ in range(3):
            connection = http.client.HTTPConnection(host, int(port), timeout=10)
            connection.request("GET", "/api/v1/services?watch=true&resourceVersion=0&timeoutSeconds=240")
            assert connection.getresponse().status == 200
            connections.append(connection)
        assert threading.active_count() >= before + 3
        for connection in connections:
            connection.close()
        deadline = time.monotonic() + 5
        while threading.active_count() > before and time.monotonic() < deadline:
            time.sleep(0.05)
        assert threading.active_count() <= before
    finally:
        server.stop()


def test_a_slow_enqueue_loop_does_not_push_the_next_tick_later(package=PORT):
    period, loop_s = 0.5, 0.35
    ticks = []

    class Lister:
        def list(self):
            ticks.append(time.monotonic())
            return ["key"]

    stop = threading.Event()
    thread = _module(package, "controllers.common").start_drift_resync(
        "cadence-test", stop, period, [(Lister(), lambda obj: True, lambda obj: time.sleep(loop_s))]
    )
    try:
        deadline = time.monotonic() + 10.0
        while len(ticks) < 5:
            assert time.monotonic() < deadline, ticks
            time.sleep(0.01)
    finally:
        stop.set()
        thread.join(5.0)
    assert not thread.is_alive()
    gaps = [later - earlier for earlier, later in zip(ticks, ticks[1:])]
    assert all(abs(gap - period) < 0.2 for gap in gaps), gaps


def test_a_repaired_disable_keeps_the_discovery_snapshot(package=PORT):
    smoke = importlib.import_module("chip_smoke")
    pkg = smoke.load(package)
    aws = pkg.aws.FakeAWSBackend(quota_accelerators=20)
    now = [1000.0]
    discovery = pkg.aws.DiscoveryCache(ttl=60.0, tags_ttl=600.0, clock=lambda: now[0])
    driver = pkg.aws.AWSDriver(aws, aws, aws, discovery_cache=discovery)
    services = []
    for i in range(5):
        name, host = smoke.service_lb(i)
        aws.add_load_balancer(name, "us-west-2", host)
        services.append(smoke.make_service(pkg, i))

    def ensure(svc):
        ingress = svc.status.load_balancer.ingress[0]
        return driver.ensure_global_accelerator_for_service(
            svc, ingress, "default", svc.metadata.name, "us-west-2"
        )

    arns = [ensure(svc)[0] for svc in services]
    aws.update_accelerator(arns[0], enabled=False)  # out of band
    now[0] += 61.0  # the snapshot expires; its reload sees the disable
    ensure(services[0])
    assert aws.describe_accelerator(arns[0]).enabled
    before = len(aws.calls)
    for svc in services[1:]:
        ensure(svc)
    reads = [call[0] for call in aws.calls[before:]]
    assert "ListTagsForResource" not in reads and "ListAccelerators" not in reads, reads
    ((accelerator, tags),) = [entry for entry in discovery.peek() if entry[0].accelerator_arn == arns[0]]
    assert accelerator.enabled
    assert sorted(map(repr, tags)) == sorted(map(repr, aws.list_tags_for_resource(arns[0])))
