"""The SLO autoscaler as a fleet of processes runs it, held in the port:
every replica runs its own loop over its own signals, so each must
honour the fleet's last resize, and a replica that stops serving keys
must not keep their journeys open.

- ``test_every_replica_honours_the_fleets_cooldown``: two autoscaler
  loops over one ring lease on a fake clock.  Replica A burns and
  executes 2 -> 4; replica B has headroom all along and must not scale
  in until cooldown-in has passed since it saw the ring epoch change.
  The reference's policy starts the cooldown only from its own
  executed resize, so B scales in at once (the case fails against its
  code).
- ``test_quota_slices_stay_within_the_budget_through_a_shrink``: four
  replicas of one shard each shrink 4 -> 2; the sum of their quota
  fractions (AIMD ceilings over the global budget) stays at most 1
  after every single replica's tick.  The reference's donors of the
  dropped shards keep their quarter until their own tick completes
  the transition (the case fails against its code).
- ``test_donor_closes_the_journeys_of_keys_it_hands_over``: a threaded
  two-replica handoff (``FakeCluster``, memberships ticking on a
  thread) while a key that moves sits in the donor's queue with its
  journey open in the donor's own tracker.  After the handoff and the
  worker's skip of the key, the donor's tracker holds nothing in
  flight.  The reference leaves the journey open for good (the case
  fails against its code).
- ``test_port_fleet_autoscales``: ``chip_smoke.autoscale_runs`` through
  ``python -m agac_tpu_torch`` at a small size (admission halved, a
  wave of 80, the twin started with the acting run), the acting run and
  its observe-only twin held to the phase's hard bounds.

The port and ``chip_smoke`` are imported inside the tests only (the
repository's linter treats the port as third party)."""

from __future__ import annotations

import importlib
import threading
import time

import pytest

PORT = "agac_tpu_torch"
INTERVAL = 5.0
COOLDOWN_OUT, COOLDOWN_IN = 90.0, 120.0


def _port(name: str):
    return importlib.import_module(f"{PORT}.{name}")


class _Burn:
    """An SLO engine stand-in: one GA objective burning at ``rate`` in
    both production windows."""

    def __init__(self, rate: float):
        slo = _port("observability.slo")
        self.rate = rate
        self.objectives = (slo.SLOObjective("ga_converge_p99", 120.0, slo.GA_CONTROLLERS),)

    def burn_snapshot(self) -> dict:
        return {"ga_converge_p99": {300.0: self.rate, 3600.0: self.rate}}


def test_every_replica_honours_the_fleets_cooldown():
    sharding = _port("sharding")
    autoscaler = _port("autoscaler")
    metrics = _port("observability.metrics")
    recorder = _port("observability.recorder")
    cluster = _port("cluster.fake").FakeCluster()
    now = [1000.0]

    def clock() -> float:
        return now[0]

    def member(identity: str):
        config = sharding.ShardingConfig(shard_count=2, shards_per_replica=4)
        return sharding.ShardMembership(config, identity=identity, clock=clock)

    def loop(membership, rate: float):
        return autoscaler.AutoscalerLoop(
            autoscaler.ScaleSignals(
                slo_engine=_Burn(rate), resize_status=membership.resize_status, clock=clock
            ),
            autoscaler.ScalePolicy(autoscaler.ScalePolicyConfig(
                min_shards=2, max_shards=4,
                cooldown_out_seconds=COOLDOWN_OUT, cooldown_in_seconds=COOLDOWN_IN,
            )),
            execute=lambda target: sharding.request_resize(cluster, target),
            registry=metrics.MetricsRegistry(),
            flight_recorder=recorder.FlightRecorder(capacity=256, clock=clock),
        )

    a, b = member("a"), member("b")

    def tick_both(rounds: int) -> None:
        for _ in range(rounds):
            now[0] += 0.5
            for membership in (a, b):
                membership.tick(cluster)
                if membership.resync_pending():  # a manager's resync
                    membership.ack_adoptions(cluster)

    tick_both(2)
    assert a.owned_shards() | b.owned_shards() == {0, 1}
    loop_a, loop_b = loop(a, 2.0), loop(b, 0.0)
    # B evaluates with headroom for a while first: at 2 shards its
    # scale-in is held at the floor, and its streak is long
    for _ in range(10):
        held = loop_b.tick()
        assert not held.executed
        tick_both(10)
    assert (held.action, held.rails) == ("scale-in", ("at-min",))
    first = loop_a.tick()
    assert (first.action, first.executed, first.target_shards) == ("scale-out", True, 4)
    assert sharding.ring_status(cluster)["epoch"] == 1

    seen_at = scale_in_at = None
    for _ in range(80):
        tick_both(10)
        loop_a.tick()
        decision = loop_b.tick()
        if seen_at is None and b.resize_status()["epoch"] == 1:
            seen_at = decision.time
        if decision.executed:
            assert decision.action == "scale-in"
            scale_in_at = decision.time
            break
    assert seen_at is not None and scale_in_at is not None
    # not before cooldown-in has passed since B saw the epoch change ...
    assert scale_in_at - seen_at >= COOLDOWN_IN
    # ... and soon after it: B's own streak re-earned meanwhile
    assert scale_in_at - seen_at <= COOLDOWN_IN + 2 * INTERVAL
    assert sharding.ring_status(cluster)["epoch"] == 2


def test_quota_slices_stay_within_the_budget_through_a_shrink():
    """Four replicas, one shard each, shrink 4 -> 2 on a fake clock,
    ticking one replica at a time: after every tick the replicas' quota
    fractions (each one's AIMD ceiling over the global budget) sum to at
    most 1.  The reference's donors of the two dropped shards keep a
    quarter each until their own tick completes the transition, while
    the first adopter to complete already takes half (the case fails
    against its code: 1.5)."""
    sharding = _port("sharding")
    cluster = _port("cluster.fake").FakeCluster()
    now = [1000.0]
    members = [
        sharding.ShardMembership(
            sharding.ShardingConfig(shard_count=4, shards_per_replica=1),
            identity=f"r{i}", clock=lambda: now[0],
        )
        for i in range(4)
    ]

    def tick_each(rounds: int, order: list, sums: list) -> None:
        for _ in range(rounds):
            now[0] += 0.5
            for membership in order:
                membership.tick(cluster)
                if membership.resync_pending():  # a manager's resync
                    membership.ack_adoptions(cluster)
                sums.append(sum(m.quota_fraction() for m in members))

    tick_each(4, members, [])
    assert sorted(s for m in members for s in m.owned_shards()) == [0, 1, 2, 3]
    # processes tick at their own pace: here the adopters (the holders
    # of shards 0 and 1) twice for each tick of the donors
    adopters = [m for m in members if m.owned_shards() & {0, 1}]
    donors = [m for m in members if m not in adopters]
    assert sharding.request_resize(cluster, 2) == 1
    sums: list[float] = []
    tick_each(20, adopters + adopters + donors, sums)
    assert all(m.resize_status()["ring"] == "2x64" for m in members)
    assert sorted(s for m in members for s in m.owned_shards()) == [0, 1]
    assert max(sums) <= 1.0 + 1e-9, sorted(set(sums))
    assert sum(m.quota_fraction() for m in members) == 1.0


def test_donor_closes_the_journeys_of_keys_it_hands_over():
    sharding = _port("sharding")
    common = _port("controllers.common")
    journey = _port("observability.journey")
    metrics = _port("observability.metrics")
    workqueue = _port("reconcile.workqueue")
    ring = _port("sharding.ring")
    result = _port("reconcile.result")
    cluster = _port("cluster.fake").FakeCluster()

    def member(identity: str, capacity: int):
        config = sharding.ShardingConfig(shard_count=2, shards_per_replica=capacity)
        return sharding.ShardMembership(config, identity=identity)

    # the donor holds one shard at most, so the other replica gains
    # both new shards and every key the donor hands over
    donor, other = member("donor", 1), member("other", 4)
    donor.tick(cluster)  # claims shard 0
    other.tick(cluster)  # claims shard 1
    assert (donor.owned_shards(), other.owned_shards()) == ({0}, {1})
    rings = ring.HashRing(2), ring.HashRing(4)
    moving = next(
        f"default/svc-{i}" for i in range(10_000)
        if rings[0].shard_for_key(f"default/svc-{i}") == 0
        and rings[1].shard_for_key(f"default/svc-{i}") not in (0, 1)
    )

    # the donor's own tracker, as in its own process, released the way
    # the port's command line wires it (Manager.release_journeys)
    tracker = journey.JourneyTracker(registry=metrics.MetricsRegistry())
    previous = journey.install(tracker)

    def release(key=None) -> None:
        tracker.release(lambda k: (key is None or k == key) and not donor.filter.owns_key(k))

    donor.on_release = release
    controller = "global-accelerator-controller-service"
    queue = workqueue.RateLimitingQueue(name=controller)
    stop = threading.Event()
    reconciled: list[str] = []
    try:
        tracker.observe_enqueued(controller, moving)
        queue.add_after(moving, 5.0)  # popped once the handoff is done

        def membership_loop() -> None:
            while not stop.is_set():
                for membership in (donor, other):
                    membership.tick(cluster)
                    if membership.resync_pending():  # a manager's resync
                        membership.ack_adoptions(cluster)
                stop.wait(0.05)

        ticker = threading.Thread(target=membership_loop, name="memberships")
        ticker.start()
        assert sharding.request_resize(cluster, 4) == 1
        workers = common.run_workers(
            controller, queue, workers=1, stop=stop, key_to_obj=lambda key: key,
            process_delete=lambda key: None,
            process_create_or_update=common.with_shard_guard(
                donor.filter, lambda key: reconciled.append(key) or result.Result()
            ),
        )
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not (
            donor.resize_status()["ring"] == "4x64" and other.resize_status()["ring"] == "4x64"
            and len(queue) == 0 and not donor.filter.inflight_keys
        ):
            time.sleep(0.05)
        time.sleep(6.0)  # past the key's delay: the worker popped and skipped it
        assert donor.resize_status()["state"] == "stable"
        assert not donor.filter.owns_key(moving) and reconciled == []
        assert tracker.inflight() == 0, tracker.inflight_keys()
    finally:
        stop.set()
        queue.shutdown()
        journey.install(previous)
    ticker.join(10)
    for worker in workers:
        worker.join(10)


@pytest.fixture(scope="module")
def smoke():
    return importlib.import_module("chip_smoke")


def test_port_fleet_autoscales(smoke, tmp_path, monkeypatch):
    monkeypatch.setattr(smoke, "AUTOSCALE_QUEUE", ("0.5", "5"))
    monkeypatch.setattr(smoke, "AUTOSCALE_HOLD_S", 15.0)
    monkeypatch.setattr(smoke, "AUTOSCALE_TWIN_DELAY", 0.0)
    runs = smoke.autoscale_runs(smoke.load(PORT), PORT, 8, 80, smoke.SHARD_LATENCY, tmp_path)
    acting, twin = runs["acting"], runs["observe-only"]
    assert acting["scale_out"]["reason"] in ("age-growth", "burn")
    assert acting["scale_out"]["reaction_s"] <= smoke.AUTOSCALE_REACTION_BOUND
    assert "1" in acting["stable_s"] and twin["epochs_s"].keys() == {"0"}
    for run in (acting, twin):
        assert run["create_accelerator"] == 88
        assert run["settle_s"] is not None and run["settle_s"] <= smoke.AUTOSCALE_SETTLE_S
        assert set(run["exits"].values()) == {0}
        assert run["watch"]["polls"] > 0
    assert twin["target_shards_max"] == 4
