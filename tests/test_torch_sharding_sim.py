"""The sharded sim, held against the reference: ``chip_smoke.shard_soak``
(``TestTwoShardSoak``'s configuration: two live replicas over two
shards, a replica killed at virtual hour 3) ends through ``agac_tpu``
and ``agac_tpu_torch`` with clean oracles and SLOs, the same
ownership, generations and final AWS world, the same mutations and
statistics but for the counts of AWS calls and events: the port's
staged create reads nothing between its creates, so its trace is its
own (``chip_smoke.PORT_SHARD_SOAK_PINS``).

One case holds the port to a fix the reference lacks: a survivor more
than the rebalance hysteresis above a dead replica's last published
load must still take the dead replica's lease once it expires.

The port, the reference and ``chip_smoke`` are imported inside the
tests only (the repository's linter treats the port as third party)."""

from __future__ import annotations

import importlib

import pytest

from .test_torch_sim import played_fleet, same_outcome

REF, PORT = "agac_tpu", "agac_tpu_torch"
SOAK_N = 1_000


@pytest.fixture(scope="module")
def smoke():
    return importlib.import_module("chip_smoke")


def test_shard_soak_matches_the_reference(smoke):
    port, port_run = played_fleet(smoke, PORT, smoke.shard_soak, SOAK_N)
    ref, ref_run = played_fleet(smoke, REF, smoke.shard_soak, SOAK_N)
    for result in (port, ref):
        assert result["quiescent"]
        assert result["violations"] == result["slo_violations"] == []
        assert result["converged_total"] >= SOAK_N and result["inflight"] == 0
        assert result["accelerators"] == SOAK_N
        assert list(result["ownership"].values()) == [[0, 1]]
        assert result["generations"] >= 2
    same_outcome(port_run, ref_run)
    for key in ("converged_total", "ownership", "generations"):
        assert port[key] == ref[key], key


def _skewed_fleet(package: str, light: int, heavy: int) -> tuple[list[int], list[int], int]:
    """Service slots whose keys ``svc<slot>`` hash to shard 0 (``light``
    of them) and shard 1 (``heavy``), and one more slot on shard 0."""
    ring = importlib.import_module(f"{package}.sharding.ring").HashRing(2)
    slots: dict[int, list[int]] = {0: [], 1: []}
    want = {0: light + 1, 1: heavy}
    i = 0
    while any(len(slots[shard]) < want[shard] for shard in want):
        shard = ring.shard_for("default", f"svc{i}")
        if len(slots[shard]) < want[shard]:
            slots[shard].append(i)
        i += 1
    return slots[0][:light], slots[1], slots[0][light]


def test_overloaded_survivor_takes_a_dead_replicas_lease(smoke):
    """4 keys on shard 0, 20 on shard 1: the holder of shard 0 is killed
    after publishing its load of 4 on its lease, so the survivor (20
    keys) stays more than the hysteresis of 8 above that stale load.
    The survivor must still steal the expired lease, adopt shard 0 and
    converge a Service created there after the kill."""
    mod = lambda name: importlib.import_module(f"{PORT}.{name}")
    harness_mod, fuzz = mod("sim.harness"), mod("sim.fuzz")
    light, heavy, late = _skewed_fleet(PORT, 4, 20)
    config = harness_mod.SimHarnessConfig(
        replicas=2,
        shard_count=2,
        shards_per_replica=2,
        lease=mod("leaderelection").LeaderElectionConfig(
            lease_duration=60.0, renew_deadline=15.0, retry_period=5.0
        ),
    )
    with harness_mod.SimHarness(config=config) as harness:
        for slot in [*light, *heavy, late]:
            harness.aws.add_load_balancer(f"lb{slot}", smoke.REGION, fuzz._nlb_hostname(slot))
        for slot in [*light, *heavy]:
            harness.cluster.create("Service", fuzz._make_service(f"svc{slot}", slot, False))
        harness.run_for(600.0)
        assert harness.run_until_quiescent(3600.0, settle_window=60.0), harness.stats()
        ownership = harness.shard_ownership()
        assert sorted(map(sorted, ownership.values())) == [[0], [1]]
        (victim,) = [identity for identity, owned in ownership.items() if 0 in owned]
        harness.kill_shard_replica(victim)
        harness.cluster.create("Service", fuzz._make_service(f"svc{late}", late, False))
        harness.run_for(600.0)
        assert harness.run_until_quiescent(3600.0, settle_window=60.0), harness.stats()
        assert list(harness.shard_ownership().values()) == [frozenset({0, 1})]
        assert len(harness.aws.all_accelerator_arns()) == len(light) + len(heavy) + 1
        assert mod("sim.oracles").standard_oracles(harness) == []


@pytest.mark.slow
def test_pinned_port_shard_soak_hash_is_the_port(smoke):
    """The port's 10,000-Service pin, which ``chip_smoke.py``'s sim
    phase holds the port to on the card (about 80 s of host time)."""
    assert smoke.PORT_SHARD_SOAK_PINS.keys() == smoke.SHARD_SOAK_PINS.keys()
    for n, pinned in smoke.PORT_SHARD_SOAK_PINS.items():
        result = smoke.shard_soak(smoke.load(PORT), n)
        assert result["quiescent"] and result["violations"] == []
        assert result["accelerators"] == n
        assert result["trace_hash"] == pinned


@pytest.mark.slow
def test_pinned_shard_soak_hash_is_the_reference(smoke):
    """The 10,000-Service pin, recomputed with the reference (about 80 s
    of host time)."""
    for n, pinned in smoke.SHARD_SOAK_PINS.items():
        result = smoke.shard_soak(smoke.load(REF), n)
        assert result["quiescent"] and result["violations"] == []
        assert result["trace_hash"] == pinned
