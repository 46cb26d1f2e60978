"""Differential check of the port's simulation slice against the
reference: hash for hash where no chain is torn down, outcome for
outcome where one is.

The sim runs the whole Manager on one thread in virtual time and folds
every dispatched event into a SHA-256 trace hash, so two packages that
give the same hash for the same seeded scenario made the same calls,
saw the same outcomes and dispatched the same events in the same
order.  The checks here drive both packages through the same entry
points (``chip_smoke.py``'s scenario runner and rollout, the capture
recorder and ``replay_capture``).

The port's accelerator teardown leaves out two ``DescribeAccelerator``
re-reads the reference makes, and its staged create reads nothing
between its three creates where the reference lists the listeners and
then the endpoint groups, so every fuzz scenario and the rollout, each
of which creates chains, have traces of their own in the port.  Those
are held to the reference's result instead: both oracle verdict lists
empty, an equal final AWS world in canonical form (ARNs replaced by
owner keys), equal counts of every mutating call, and fewer chain
reads in the port.  The hashes ``chip_smoke.py`` pins for the
reference (``FUZZ_PINS``, ``ROLLOUT_PINS``) must be the reference's,
those it pins for the port (``PORT_FUZZ_PINS``, ``PORT_ROLLOUT_PINS``)
the port's; and the port's hashes must not depend on
``PYTHONHASHSEED``.

A capture records what its controller did, so a replay re-derives it
only where the replaying controller makes the same calls.  The port's
recorder marks its captures as made with pending-create records
(``sim.capture.PENDING_CREATES``); the port replays a capture without
the mark, such as the checked-in one the reference recorded, with the
reference's reads, byte-identically.  The reference replays the port's
capture of the same scenario as its own run of it: the checked-in
capture's hash, split from the port's at the first read the port's
create left out."""

from __future__ import annotations

import collections
import dataclasses
import functools
import importlib
import os
import pathlib
import re
import subprocess
import sys
import types

import pytest

from .test_torch_manager import canonical_aws

REPO = pathlib.Path(__file__).resolve().parent.parent
BASELINE = REPO / "tests" / "captures" / "converge-baseline.jsonl"
REF, PORT = "agac_tpu", "agac_tpu_torch"
ROLLOUT_N = 200
# the scenarios both packages play here: the standard scenario's first
# two seeds and seed 1 of every other scenario, at the tier-1 profile
MINI_SCENARIOS = [
    ("standard", 1, "mini"),
    ("standard", 2, "mini"),
    ("resize", 1, "mini"),
    ("autoscale", 1, "mini"),
    ("autoscale-brownout", 1, "mini"),
]
# the captures README's scenario: one NLB Service converging
NLB_NAME, NLB_REGION = "testlb", "us-west-2"
NLB_HOSTNAME = "testlb-0123456789abcdef.elb.us-west-2.amazonaws.com"


@pytest.fixture(scope="module")
def smoke():
    return importlib.import_module("chip_smoke")


# the fake backend's call names of the operations that change AWS
MUTATING = ("Create", "Update", "Delete", "Add", "Remove", "Change", "Tag", "Untag")


@dataclasses.dataclass(frozen=True)
class _Played:
    trace_hash: str
    violations: list
    stats: dict
    world: dict  # the final AWS world, canonical
    ops: collections.Counter  # every call to the fake account, by name

    def mutating(self) -> dict:
        return {op: n for op, n in self.ops.items() if op.startswith(MUTATING)}


def _harness_ends(base) -> tuple[type, list]:
    """A subclass of the sim harness ``base`` that notes, as it closes,
    its canonical AWS world and its calls to the fake account by name."""
    ends = []

    class Harness(base):
        def __exit__(self, *exc):
            ends.append(
                (
                    canonical_aws(self.aws.snapshot_state()),
                    collections.Counter(call[0] for call in self.aws.calls),
                )
            )
            return super().__exit__(*exc)

    return Harness, ends


@functools.lru_cache(maxsize=None)
def _fuzz(package: str, scenario: str, seed: int, profile: str) -> _Played:
    """One scenario through ``package``, with the AWS world and call
    counts its harness ends with (read as the harness closes)."""
    smoke = importlib.import_module("chip_smoke")
    fuzz = importlib.import_module(f"{package}.sim.fuzz")
    Harness, ends = _harness_ends(fuzz.SimHarness)
    plain, fuzz.SimHarness = fuzz.SimHarness, Harness
    try:
        result = smoke.run_fuzz(smoke.load(package), scenario, seed, profile)
    finally:
        fuzz.SimHarness = plain
    ((world, ops),) = ends
    return _Played(result.trace_hash, result.violations, result.stats, world, ops)


def played_fleet(smoke, package: str, run, n: int) -> tuple[dict, _Played]:
    """``run`` (``chip_smoke.rollout`` or ``shard_soak``) of ``n``
    Services through ``package``: its result, and what its harness
    ended with."""
    pkg = smoke.load(package)
    Harness, ends = _harness_ends(pkg.harness.SimHarness)
    pkg.harness = types.SimpleNamespace(
        SimHarness=Harness, SimHarnessConfig=pkg.harness.SimHarnessConfig
    )
    result = run(pkg, n)
    ((world, ops),) = ends
    violations = result["violations"] + result.get("slo_violations", [])
    return result, _Played(result["trace_hash"], violations, result["stats"], world, ops)


def same_outcome(port: _Played, ref: _Played) -> None:
    """The port's run ends as the reference's: clean, the same world,
    the same mutations, fewer chain reads (each staged create lists no
    listener and no endpoint group), and the same run statistics but
    for the counts of AWS calls and of dispatched events (the fake
    settles a disable by counting reads, so without the reference's
    re-read a parked teardown may wait one poll more)."""
    assert port.violations == ref.violations == []
    assert port.world == ref.world
    assert port.mutating() == ref.mutating()
    assert ref.ops["CreateAccelerator"] > 0
    assert port.ops["ListListeners"] < ref.ops["ListListeners"]
    assert port.ops["ListEndpointGroups"] < ref.ops["ListEndpointGroups"]
    assert port.ops["DescribeAccelerator"] <= ref.ops["DescribeAccelerator"]
    assert port.stats["aws_calls"] < ref.stats["aws_calls"]
    counts = {"aws_calls": None, "events": None}
    assert {**port.stats, **counts} == {**ref.stats, **counts}


def _same_outcome(port: _Played, ref: _Played) -> None:
    """``same_outcome``, for a scenario that also tears chains down:
    the port's teardown reads the accelerator fewer times."""
    same_outcome(port, ref)
    assert ref.ops["DeleteAccelerator"] > 0
    assert port.ops["DescribeAccelerator"] < ref.ops["DescribeAccelerator"]


def _replay(package: str, path: pathlib.Path):
    replay = importlib.import_module(f"{package}.sim.replay")
    return replay.replay_capture(path)


def _same_replay(ours, theirs) -> None:
    assert ours.identical and theirs.identical
    assert (ours.recorded_events, ours.recorded_hash, ours.replay_hash) == (
        theirs.recorded_events,
        theirs.recorded_hash,
        theirs.replay_hash,
    )
    assert ours.violations == theirs.violations == []


def test_checked_in_capture_replays_like_the_reference():
    _same_replay(_replay(PORT, BASELINE), _replay(REF, BASELINE))


@pytest.mark.parametrize("scenario", MINI_SCENARIOS, ids=lambda s: f"{s[0]}-{s[1]}-{s[2]}")
def test_scenario_matches_the_reference(scenario):
    _same_outcome(_fuzz(PORT, *scenario), _fuzz(REF, *scenario))


def test_pinned_scenario_hashes_are_the_reference(smoke):
    computed = {key: _fuzz(REF, *key).trace_hash for key in smoke.FUZZ_PINS}
    assert computed == smoke.FUZZ_PINS


def test_pinned_port_scenario_hashes_are_the_port(smoke):
    """``chip_smoke.py``'s sim phase holds the port to these on the
    card; each pinned scenario ends as the reference's."""
    assert smoke.PORT_FUZZ_PINS.keys() == smoke.FUZZ_PINS.keys()
    computed = {key: _fuzz(PORT, *key).trace_hash for key in smoke.PORT_FUZZ_PINS}
    assert computed == smoke.PORT_FUZZ_PINS
    for key in smoke.PORT_FUZZ_PINS:
        _same_outcome(_fuzz(PORT, *key), _fuzz(REF, *key))


def test_rollout_matches_the_reference(smoke):
    """The rollout creates every chain through the staged create: the
    port ends as the reference does, with fewer chain reads.  (The sim
    resumes most of this rollout's creates a whole verify window after
    their last write, where the port's record has ended and it reads as
    the reference does.)"""
    port, port_run = played_fleet(smoke, PORT, smoke.rollout, ROLLOUT_N)
    ref, ref_run = played_fleet(smoke, REF, smoke.rollout, ROLLOUT_N)
    for result in (port, ref):
        assert result["quiescent"]
        assert result["violations"] == result["incomplete_chains"] == []
        assert result["missing_records"] == []
    same_outcome(port_run, ref_run)


def _record_readme_scenario(package: str, path: pathlib.Path) -> None:
    """Record the captures README's scenario through ``package``: one
    managed NLB Service, created after 30 virtual seconds, run to
    quiescence."""
    mod = lambda name: importlib.import_module(f"{package}.{name}")
    objects, apis = mod("cluster.objects"), mod("apis")
    lease = mod("leaderelection").LeaderElectionConfig(
        lease_duration=60.0, renew_deadline=15.0, retry_period=5.0
    )
    harness_mod = mod("sim.harness")
    config = harness_mod.SimHarnessConfig(replicas=2, lease=lease, capture_path=str(path))
    service = objects.Service(
        metadata=objects.ObjectMeta(
            name="web",
            namespace="default",
            annotations={
                apis.AWS_LOAD_BALANCER_TYPE_ANNOTATION: "external",
                apis.AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION: "true",
            },
        ),
        spec=objects.ServiceSpec(
            type="LoadBalancer",
            ports=[objects.ServicePort(name="p80", port=80, protocol="TCP")],
        ),
    )
    service.status.load_balancer.ingress.append(objects.LoadBalancerIngress(hostname=NLB_HOSTNAME))
    with harness_mod.SimHarness(config=config) as harness:
        harness.aws.add_load_balancer(NLB_NAME, NLB_REGION, NLB_HOSTNAME)
        harness.run_for(30.0)
        harness.cluster.create("Service", service)
        harness.run_for(30.0)
        assert harness.run_until_quiescent(3600.0, settle_window=60.0), harness.stats()


@pytest.mark.parametrize(
    "recorder, replayer", [(PORT, REF), (REF, PORT)], ids=["port-to-ref", "ref-to-port"]
)
def test_capture_cross_replays(tmp_path, recorder, replayer):
    """A capture of the checked-in capture's scenario, recorded by one
    package and replayed by both.  The reference's replays
    byte-identically through the port, with the same result as its own
    replay and the checked-in capture's hash chain.  The port's replays
    byte-identically through the port, two reads shorter than the
    reference's; the reference replays it as its own run, the
    checked-in capture's hash, split from the port's at the
    ``ListListeners`` the port's create left out."""
    path = tmp_path / "capture.jsonl"
    _record_readme_scenario(recorder, path)
    across, own = _replay(replayer, path), _replay(recorder, path)
    baseline = _replay(REF, BASELINE)
    if recorder == REF:
        _same_replay(across, own)
        assert (across.recorded_events, across.recorded_hash) == (
            baseline.recorded_events,
            baseline.recorded_hash,
        )
        return
    assert own.identical and own.violations == []
    assert own.recorded_events == baseline.recorded_events - 2
    assert across.violations == []
    assert across.replay_hash == baseline.recorded_hash
    assert across.divergence is not None and across.divergence.reason == "hash-split"
    assert across.divergence.replayed["data"]["op"] == "list_listeners"


def test_port_hash_does_not_depend_on_the_hash_seed():
    """Set iteration order follows ``PYTHONHASHSEED``; the port's trace
    must not."""
    command = [sys.executable, "-m", "agac_tpu_torch.sim.fuzz", "--seeds", "1", "--profile", "mini"]
    runs = [
        subprocess.Popen(
            command,
            cwd=REPO,
            env={**os.environ, "PYTHONHASHSEED": seed},
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            text=True,
        )
        for seed in ("1", "2")
    ]
    try:
        outputs = [run.communicate(timeout=120)[0] for run in runs]
    finally:
        for run in runs:
            run.kill()
    assert [run.returncode for run in runs] == [0, 0], outputs
    traces = [re.findall(r"trace=([0-9a-f]{16})", out) for out in outputs]
    expected = _fuzz(PORT, "standard", 1, "mini").trace_hash[:16]
    assert traces == [[expected], [expected]]


@pytest.mark.slow
def test_pinned_port_rollout_hash_is_the_port(smoke):
    """The port's 10,000-Service pin, which ``chip_smoke.py``'s sim
    phase holds the port to on the card (about a minute of host time)."""
    assert smoke.PORT_ROLLOUT_PINS.keys() == smoke.ROLLOUT_PINS.keys()
    for n, pinned in smoke.PORT_ROLLOUT_PINS.items():
        result = smoke.rollout(smoke.load(PORT), n)
        assert result["quiescent"] and result["violations"] == []
        assert result["incomplete_chains"] == result["missing_records"] == []
        assert result["trace_hash"] == pinned


@pytest.mark.slow
def test_pinned_rollout_hash_is_the_reference(smoke):
    """The 10,000-Service pin, recomputed with the reference (about a
    minute of host time)."""
    for n, pinned in smoke.ROLLOUT_PINS.items():
        result = smoke.rollout(smoke.load(REF), n)
        assert result["quiescent"] and result["violations"] == []
        assert result["trace_hash"] == pinned
