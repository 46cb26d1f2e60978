"""The live elastic resize, held to its guarantee in the port: no key is
ever mutated by two replicas, because a donor's reconciles return
before its drain ack and an adopter's reads see every write made
before it.

- ``test_drain_ack_waits_for_a_reconcile_in_flight``: a worker of the
  donor sits inside a reconcile of a key that moves while both
  replicas' memberships tick (threads, a fake clock, ``FakeCluster``).
  The donor must stop serving the key at once, but write no
  ``drained-<i>`` marker, and the gainer must not adopt, until the
  worker returns.  The reference writes the marker at the first tick
  whose gainers are claimed (the case fails against its code).
- ``test_inflight_keys_hold_under_contention``: the in-flight
  registry the fence reads, under more workers than cores.
- ``test_a_reader_waits_for_a_reload_in_progress``: one thread of a
  process reloads the shared fake account's state file while another
  reads it.  The second read must not serve the state from before an
  older commit of another process than the documented 0.05 s allow.
  The reference's reader returns the process's last loaded state, of
  any age (the case fails against its code).
- ``test_port_fleet_resizes_without_duplicates``: ``chip_smoke.resize_fleet``
  through ``python -m agac_tpu_torch`` at 20 Services (grow 2 -> 4
  under load, shrink 4 -> 2 with the holder of shard 0 killed), held
  to the phase's hard bounds.

The port and ``chip_smoke`` are imported inside the tests only (the
repository's linter treats the port as third party)."""

from __future__ import annotations

import importlib
import os
import sys
import threading
import time

import pytest

PORT = "agac_tpu_torch"
N_SERVICES = 20
LATENCY = 0.05


def _port(name: str):
    return importlib.import_module(f"{PORT}.{name}")


def _moving_key(old: int, new: int, source: int, target: int) -> str:
    """A ``default/svc-<i>`` key on shard ``source`` of the ``old``
    ring that the ``new`` ring puts on shard ``target``."""
    ring = _port("sharding.ring")
    rings = ring.HashRing(old), ring.HashRing(new)
    for i in range(10_000):
        key = f"default/svc-{i}"
        if (rings[0].shard_for_key(key), rings[1].shard_for_key(key)) == (source, target):
            return key
    raise AssertionError(f"no key moves from shard {source} to shard {target}")


def test_drain_ack_waits_for_a_reconcile_in_flight():
    sharding = _port("sharding")
    membership_mod = _port("sharding.membership")
    common = _port("controllers.common")
    cluster = _port("cluster.fake").FakeCluster()
    now = [1000.0]

    def member(identity: str):
        config = sharding.ShardingConfig(shard_count=2, shards_per_replica=4)
        return sharding.ShardMembership(config, identity=identity, clock=lambda: now[0])

    donor, other = member("donor"), member("other")
    donor.tick(cluster)  # claims shard 0
    other.tick(cluster)  # claims shard 1
    assert (donor.owned_shards(), other.owned_shards()) == ({0}, {1})

    # gainers are claimed first, one per tick, so the donor (ticking
    # first) takes shard 2 and the other replica shard 3
    key = _moving_key(2, 4, 0, 3)
    inside, release = threading.Event(), threading.Event()
    seen: list[str] = []

    def reconcile(arg):
        seen.append(arg)
        inside.set()
        assert release.wait(30)

    process = common.with_shard_guard(donor.filter, reconcile)
    worker = threading.Thread(target=process, args=(key,), name="donor-worker")
    worker.start()
    assert inside.wait(30) and seen == [key]

    def ring_annotations() -> dict:
        lease = cluster.get("Lease", "kube-system", membership_mod.ring_lease_name())
        return dict(lease.metadata.annotations or {})

    def tick_both(rounds: int) -> None:
        for _ in range(rounds):
            now[0] += 0.5
            donor.tick(cluster)
            other.tick(cluster)

    try:
        assert sharding.request_resize(cluster, 4) == 1
        tick_both(6)  # enter the transition, claim the gainers 2 and 3
        assert (donor.owned_shards(), other.owned_shards()) == ({0, 2}, {1, 3})
        # the donor stopped serving the moving key at once ...
        assert not donor.filter.owns_key(key)
        assert donor.resize_status()["state"] == "draining"
        # ... but neither acks its drain nor lets the gainer adopt
        # while its worker is inside the reconcile
        assert f"{membership_mod.ANN_DRAINED}0" not in ring_annotations()
        assert 3 not in other.resync_pending()
        assert not other.filter.owns_key(key)
    finally:
        release.set()
        worker.join(30)
    tick_both(3)
    assert ring_annotations()[f"{membership_mod.ANN_DRAINED}0"] == "1"
    assert other.filter.owns_key(key) and not donor.filter.owns_key(key)


def test_inflight_keys_hold_under_contention():
    """More workers than cores through one guarded process func, the
    interpreter switching threads every microsecond: a key is in the
    filter's ``inflight_keys`` whenever a worker is inside its
    reconcile, and the list is empty once they all return."""
    sharding = _port("sharding")
    common = _port("controllers.common")
    cluster = _port("cluster.fake").FakeCluster()
    membership = sharding.ShardMembership(
        sharding.ShardingConfig(shard_count=2, shards_per_replica=2), identity="a",
        clock=lambda: 1000.0,
    )
    membership.tick(cluster)
    membership.tick(cluster)
    assert membership.owned_shards() == {0, 1}
    keys = [f"default/svc-{i}" for i in range(4)]
    missing: list[str] = []

    def reconcile(key):
        if key not in membership.filter.inflight_keys:
            missing.append(key)

    process = common.with_shard_guard(membership.filter, reconcile)

    def worker(offset: int) -> None:
        for i in range(300):
            process(keys[(i + offset) % len(keys)])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(target=worker, args=(n,)) for n in range(4 * (os.cpu_count() or 2))
        ]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(thread.is_alive() for thread in threads)
    assert missing == [] and membership.filter.inflight_keys == []


def test_a_reader_waits_for_a_reload_in_progress(tmp_path):
    fake_backend = _port("cloudprovider.aws.fake_backend")
    types = _port("cloudprovider.aws.types")
    path = str(tmp_path / "aws-state.json")
    writer = fake_backend.FileBackedFakeAWSBackend(path)
    reader = fake_backend.FileBackedFakeAWSBackend(path)
    assert reader.list_accelerators(100, None)[0] == []
    tags = [types.Tag(key="aws-global-accelerator-owner", value="service/default/svc-0")]
    writer.create_accelerator("svc-0", "IPV4", True, tags)
    time.sleep(2 * reader.READ_RELOAD_INTERVAL)  # the commit is older than the bound

    in_reload, go_on = threading.Event(), threading.Event()
    file_serial = reader._file_serial

    def slow_file_serial():
        in_reload.set()
        assert go_on.wait(30)
        return file_serial()

    reader._file_serial = slow_file_serial
    results: dict[str, list] = {}

    def read(name: str) -> None:
        results[name] = reader.list_accelerators(100, None)[0]

    reloading = threading.Thread(target=read, args=("reloading",))
    reloading.start()
    assert in_reload.wait(30)
    reader._file_serial = file_serial  # only the first reload is slow
    second = threading.Thread(target=read, args=("second",))
    second.start()
    second.join(0.5)  # a read that returns now serves the state of before the commit
    go_on.set()
    reloading.join(30)
    second.join(30)
    assert [a.name for a in results["second"]] == ["svc-0"]
    assert [a.name for a in results["reloading"]] == ["svc-0"]


@pytest.fixture(scope="module")
def smoke():
    return importlib.import_module("chip_smoke")


def test_port_fleet_resizes_without_duplicates(smoke, tmp_path):
    run = smoke.resize_fleet(smoke.load(PORT), PORT, N_SERVICES, LATENCY, tmp_path)
    assert run["create_accelerator"] == N_SERVICES
    assert run["grown_owned"] and sorted(s for o in run["grown_owned"] for s in o) == [0, 1, 2, 3]
    assert run["grow_journeys"]["resize"] > 0
    assert run["kill"]["states"] and set(run["kill"]["states"]) & {"draining", "adopting"}
    assert 0 in run["kill"]["owned"]
    assert run["exit"] == 0
    assert run["watch"]["polls"] > 0 and run["watch"]["max_gap_s"] <= smoke.RESIZE_POLL_BOUND
    assert all(v <= smoke.SHARD_BUDGET_QPS * 1.001 for v in run["aimd_ceiling_sums_max"].values())
    assert run["moved_keys_grow"]["ring"] == smoke.moved_keys(smoke.load(PORT), N_SERVICES, 2, 4)
