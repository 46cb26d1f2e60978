"""The comparison deciding ``correct`` fails a broken timed path: each
fault is planted under a run of the cell at toy size, on the CPU, and
the run must come out not correct.  Faults, as a cell can have them:

- ``unchanged``: a mutating call answers success and leaves the state
  as it was;
- ``half``: half of a call's batch (record changes, endpoint
  configurations) left out;
- ``altered``: an answer altered where it is produced (a port, a
  weight).

No cell spans chips, so none has an exchange between chips to leave out;
the fleet's calls carry no batch.  The fleet's AWS lives in its replica
processes, so its faults are planted there, through ``sitecustomize``,
and armed when the window starts.
"""

from __future__ import annotations

import dataclasses
import pathlib

import pytest

from helpers import ROOT, run_cell, toy_root

RATES = {"mixed-1200.storm": 1.0, "sharded-2x2.churn": 2.0}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy_root(tmp_path_factory.mktemp("faults"), rates=RATES)


def plant(op: str, wrap):
    """Replace ``op`` of the world's in-memory AWS by ``wrap(original)``."""

    def planted(world):
        original = getattr(world.aws, op)
        setattr(world.aws, op, wrap(original))
        world.shaped._wrapped.clear()

    return planted


def unchanged_add(original):
    def add_endpoints(arn, endpoint_configurations):
        return []
    return add_endpoints


def half_records(original):
    def change_resource_record_sets(zone_id, changes):
        changes = list(changes)
        return original(zone_id, changes[: max(1, len(changes) // 2)])
    return change_resource_record_sets


def altered_alias(original):
    def change_resource_record_sets(zone_id, changes):
        altered = []
        for change in changes:
            record = change.record_set
            if record.alias_target is not None:
                alias = dataclasses.replace(record.alias_target, dns_name="x" + record.alias_target.dns_name)
                change = dataclasses.replace(change, record_set=dataclasses.replace(record, alias_target=alias))
            altered.append(change)
        return original(zone_id, altered)
    return change_resource_record_sets


IN_PROCESS = [
    ("mixed-1200.storm", "unchanged", "add_endpoints", unchanged_add),
    ("mixed-1200.storm", "half", "change_resource_record_sets", half_records),
    ("mixed-1200.storm", "altered", "change_resource_record_sets", altered_alias),
]


@pytest.mark.parametrize("cell,fault,op,wrap", IN_PROCESS, ids=[f"{c}-{f}" for c, f, _, _ in IN_PROCESS])
def test_a_planted_fault_is_not_correct(root, cell, fault, op, wrap):
    code, result, printed = run_cell(root, cell, plant=plant(op, wrap))
    assert code == 0, printed[-3000:]
    assert result["correct"] is False, printed[-3000:]


SITE = '''
import os
import sys
sys.path.insert(0, {root!r})
from agac_tpu_torch.cloudprovider.aws import fake_backend as _fb
_original = _fb.FakeAWSBackend.{op}
{body}
def _armed(self, *args):
    # the fault starts when the run's window does (the test's plant)
    if os.path.exists({armed!r}):
        return _planted(self, *args)
    return _original(self, *args)
_fb.FakeAWSBackend.{op} = _armed
'''

FLEET = {
    "unchanged": ("delete_accelerator", (
        "def _planted(self, arn):\n"
        "    return None\n")),
    "altered": ("create_endpoint_group", (
        "import dataclasses\n"
        "def _planted(self, listener_arn, region, endpoint_configurations):\n"
        "    weighted = [dataclasses.replace(c, weight=7) for c in endpoint_configurations]\n"
        "    return _original(self, listener_arn, region, weighted)\n")),
}


@pytest.mark.parametrize("fault", sorted(FLEET))
def test_a_fault_planted_in_the_replicas_is_not_correct(root, fault, tmp_path, monkeypatch):
    op, body = FLEET[fault]
    site = tmp_path / "site"
    site.mkdir()
    armed = tmp_path / "armed"
    (site / "sitecustomize.py").write_text(SITE.format(root=str(ROOT), op=op, body=body, armed=str(armed)))
    monkeypatch.setenv("PYTHONPATH", str(site))
    code, result, printed = run_cell(root, "sharded-2x2.churn", plant=lambda world: armed.touch())
    assert code == 0, printed[-3000:]
    assert result["correct"] is False, printed[-3000:]
