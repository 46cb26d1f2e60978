"""The sharded deployment over processes, held against the reference:
``chip_smoke.shard_fleet`` runs ``bench.py``'s sharded fleet (20
Services on one NLB, 0.05 s fake AWS latency) through ``python -m
agac_tpu controller`` and ``python -m agac_tpu_torch controller`` at
widths 1 and 2.  Both must pass the fleet's hard bounds (disjoint
shard leases, exactly one complete chain per Service, the 400/s
per-service budget in call rates and AIMD ceilings, a spec journey
per Service) and leave equal canonical AWS state, in which every ARN is
replaced by its owner's key.  The width-2 run that SIGKILLs the holder
of shard 0 halfway runs through the port: its survivor must own both
shards and leave the state the unbroken fleet leaves.

``test_the_state_watch_raises_each_fault`` plants state files under the
drills' one state-file watcher (``chip_smoke.StateWatch``): an
accelerator owner tag repeated, a second disable start under the
teardown view, and a stalled watcher's gap between reads must each end
in ``PhaseError``.

The port, the reference and ``chip_smoke`` are imported inside the
tests only (the repository's linter treats the port as third party)."""

from __future__ import annotations

import importlib
import json
import os
import signal
import time

import pytest

from .test_torch_manager import canonical_aws

PACKAGES = ("agac_tpu", "agac_tpu_torch")
WIDTHS = (1, 2)
N_SERVICES = 20
LATENCY = 0.05


@pytest.fixture(scope="module")
def smoke():
    return importlib.import_module("chip_smoke")


@pytest.fixture(scope="module")
def fleets(smoke, tmp_path_factory):
    return {
        (package, width): smoke.shard_fleet(
            smoke.load(package), package, N_SERVICES, width, LATENCY,
            tmp_path_factory.mktemp(f"{package}-{width}"),
        )
        for package in PACKAGES
        for width in WIDTHS
    }


@pytest.mark.parametrize("width", WIDTHS)
def test_both_fleets_divide_the_budget_alike(smoke, fleets, width):
    """``shard_fleet`` holds each run to its bounds; here the quota
    division itself: every replica's AIMD ceiling is its share of the
    budget, so they sum to the budget for every service family the
    fleet called, in both packages."""
    runs = [fleets[(package, width)] for package in PACKAGES]
    for run in runs:
        assert sorted(shard for shards in run["owned"] for shard in shards) == list(range(width))
        assert set(run["aimd_ceiling_sums"]) == set(run["aws_calls"]) == {
            "elbv2", "globalaccelerator", "route53"
        }
        assert all(
            total == pytest.approx(smoke.SHARD_BUDGET_QPS)
            for total in run["aimd_ceiling_sums"].values()
        )
    assert [run["journeys"]["spec"] for run in runs] == [N_SERVICES, N_SERVICES]


@pytest.mark.parametrize("width", WIDTHS)
def test_aws_state_equals_the_reference(fleets, width):
    ref = canonical_aws(fleets[("agac_tpu", width)]["aws_state"])
    port = canonical_aws(fleets[("agac_tpu_torch", width)]["aws_state"])
    assert len(port["chains"]) == N_SERVICES
    assert all(len(chain) == 1 for chain in port["chains"].values())
    assert port == ref


def test_port_survivor_adopts_the_killed_replicas_shard(smoke, fleets, tmp_path):
    run = smoke.shard_fleet(
        smoke.load("agac_tpu_torch"), "agac_tpu_torch", N_SERVICES, 2, LATENCY, tmp_path,
        kill_at=smoke.SHARD_KILL_AT,
    )
    kill = run["kill"]
    assert 0 in kill["owned"] and kill["survivor_owned"] == [0, 1]
    assert kill["chains"][2] >= smoke.SHARD_KILL_AT * N_SERVICES
    assert list(run["exits"].values()) == [0]
    assert run["journeys"]["spec"] <= N_SERVICES
    unbroken = fleets[("agac_tpu_torch", 2)]["aws_state"]
    assert canonical_aws(run["aws_state"]) == canonical_aws(unbroken)


OWNER = "service/default/shard0000"


def _accelerator(arn: str, enabled: bool = True, status: str = "DEPLOYED") -> dict:
    """An accelerator entry of the fake account's state file, owned by ``OWNER``."""
    return {
        "accelerator": {"accelerator_arn": arn, "enabled": enabled, "status": status},
        "tags": [["aws-global-accelerator-owner", OWNER]],
        "pending_describes": 0,
        "listeners": [],
    }


def _plant(path, *accelerators) -> None:
    """Save a state file holding ``accelerators``, replaced atomically as
    the fake account saves it."""
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps({"accelerators": list(accelerators), "endpoint_groups": [], "records": {}}))
    os.replace(tmp, path)


def _repeated_owner(smoke, state, workdir):
    _plant(state, _accelerator("arn:a"), _accelerator("arn:b"))
    watch = smoke.StateWatch("duplicate", str(state), smoke.duplicate_view, workdir,
                             shared={"sent": ("i", 2)})
    with watch:  # entered once the first read is done
        pass
    return watch, rf"owners repeated \['{OWNER}'\]"


def _second_disable(smoke, state, workdir):
    plan = {"kept": {}, "doomed": [OWNER], "kept_hosts": [], "doomed_hosts": []}
    shared = {"disabled": ("i", 0), "gone": ("i", 0), "left": ("i", -1),
              "cleared_at": ("d", 0.0), "killed_at": ("d", 0.0)}
    _plant(state, _accelerator("arn:a", enabled=False, status="IN_PROGRESS"))
    with smoke.StateWatch("teardown", str(state), smoke.teardown_view, workdir,
                          plan=plan, shared=shared) as watch:
        for enabled in (True, False):  # enabled again, then a second disable
            _plant(state, _accelerator("arn:a", enabled, "DEPLOYED" if enabled else "IN_PROGRESS"))
            deadline = time.monotonic() + 30
            while watch.read()["disabled"] != (not enabled):
                assert time.monotonic() < deadline, "the watch never read the planted state"
                time.sleep(0.02)
    return watch, "arn:a disabled 2 times"


def _read_gap(smoke, state, workdir):
    _plant(state)
    with smoke.StateWatch("duplicate", str(state), smoke.duplicate_view, workdir,
                          shared={"sent": ("i", 0)}) as watch:
        pid = watch._process.pid
        os.kill(pid, signal.SIGSTOP)
        try:
            time.sleep(2 * smoke.RESIZE_POLL_BOUND)
        finally:
            os.kill(pid, signal.SIGCONT)
        time.sleep(5 * smoke.RESIZE_POLL)  # a read after the stall measures it
    return watch, "between reads"


@pytest.mark.parametrize("drill", [_repeated_owner, _second_disable, _read_gap],
                         ids=["repeated-owner", "second-disable", "read-gap"])
def test_the_state_watch_raises_each_fault(smoke, tmp_path, drill):
    watch, fault = drill(smoke, tmp_path / "aws-state.json", tmp_path)
    with pytest.raises(smoke.PhaseError, match=fault):
        watch.check()
