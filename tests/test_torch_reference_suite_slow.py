"""The reference's slow tiers, run against the port through the import
alias of ``test_torch_reference_suite.py`` with ``-m slow``.

The wall-clock tiers (``test_resilience_e2e.py``: kill/restart
generations over one fake world; ``test_soak_e2e.py``: a churn soak to
quiescence with no residue) take well under a minute together, so they
run in tier-1.  The sim soaks (the 7-virtual-day soak at 10,000
Services, the 50,000-Service two-shard soak with a mid-run failover and
the autoscaler's scenarios) take minutes of host time each and run as
``slow`` cases.  A failure of one of them is a fault of the port only
where the reference passes the same case in the same run."""

from __future__ import annotations

import pytest

from .test_torch_reference_suite import assert_passed, run_through_alias, started_runs

# reference files in which every test is marked slow
WALL_CLOCK_FILES = [
    "test_resilience_e2e.py",
    "test_soak_e2e.py",
]
# reference files whose slow tests are sim soaks
SIM_SOAK_FILES = [
    "test_sim_e2e.py",
    "test_sharding_sim.py",
    "test_autoscaler_sim.py",
]
# the 50,000-Service soak's own budget is 900 s
SIM_SOAK_TIMEOUT = 1800


@pytest.fixture(scope="module")
def runs():
    """Started one at a time: the churn soak waits on wall-clock
    deadlines, and running beside it would only add load."""
    yield from started_runs(WALL_CLOCK_FILES, 1, marker="slow")


@pytest.mark.parametrize("test_file", WALL_CLOCK_FILES)
def test_reference_slow_file_passes_against_the_port(runs, test_file):
    assert_passed(runs[test_file].result())


@pytest.mark.slow
@pytest.mark.parametrize("test_file", SIM_SOAK_FILES)
def test_reference_sim_soak_passes_against_the_port(test_file):
    assert_passed(run_through_alias(test_file, timeout=SIM_SOAK_TIMEOUT, marker="slow"))
