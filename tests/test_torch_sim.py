"""Differential check of the port's simulation slice against the
reference, hash for hash.

The sim runs the whole Manager on one thread in virtual time and folds
every dispatched event into a SHA-256 trace hash, so two packages that
give the same hash for the same seeded scenario made the same calls,
saw the same outcomes and dispatched the same events in the same
order.  The checks here drive both packages through the same entry
points (``chip_smoke.py``'s scenario runner and rollout, the capture
recorder and ``replay_capture``) and require equal hashes, equal
oracle verdicts and equal run statistics; captures must cross-replay
byte-identically in both directions; the hashes ``chip_smoke.py``
pins must be the reference's; and the port's hashes must not depend
on ``PYTHONHASHSEED``."""

from __future__ import annotations

import functools
import importlib
import os
import pathlib
import re
import subprocess
import sys

import pytest

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


@functools.lru_cache(maxsize=None)
def _fuzz(package: str, scenario: str, seed: int, profile: str) -> tuple:
    smoke = importlib.import_module("chip_smoke")
    result = smoke.run_fuzz(smoke.load(package), scenario, seed, profile)
    return result.trace_hash, result.violations, result.stats


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
    port_hash, port_violations, port_stats = _fuzz(PORT, *scenario)
    ref_hash, ref_violations, ref_stats = _fuzz(REF, *scenario)
    assert port_hash == ref_hash
    assert port_violations == ref_violations == []
    assert port_stats == ref_stats


def test_pinned_scenario_hashes_are_the_reference(smoke):
    computed = {key: _fuzz(REF, *key)[0] for key in smoke.FUZZ_PINS}
    assert computed == smoke.FUZZ_PINS


def test_rollout_matches_the_reference(smoke):
    port = smoke.rollout(smoke.load(PORT), ROLLOUT_N)
    ref = smoke.rollout(smoke.load(REF), ROLLOUT_N)
    for result in (port, ref):
        assert result["quiescent"]
        assert result["violations"] == result["incomplete_chains"] == []
        assert result["missing_records"] == []
        del result["wall_s"]
    assert port == ref
    assert port["stats"]["aws_calls"] > 0


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
    """A capture recorded by one package replays byte-identically
    through the other, with the same result as its own replay; the
    scenario is the checked-in capture's, so its hash chain is too."""
    path = tmp_path / "capture.jsonl"
    _record_readme_scenario(recorder, path)
    across, own = _replay(replayer, path), _replay(recorder, path)
    _same_replay(across, own)
    baseline = _replay(recorder, BASELINE)
    assert (across.recorded_events, across.recorded_hash) == (
        baseline.recorded_events,
        baseline.recorded_hash,
    )


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
    expected = _fuzz(REF, "standard", 1, "mini")[0][:16]
    assert traces == [[expected], [expected]]


@pytest.mark.slow
def test_pinned_rollout_hash_is_the_reference(smoke):
    """The 10,000-Service pin, recomputed with the reference (about a
    minute of host time)."""
    for n, pinned in smoke.ROLLOUT_PINS.items():
        result = smoke.rollout(smoke.load(REF), n)
        assert result["quiescent"] and result["violations"] == []
        assert result["trace_hash"] == pinned
