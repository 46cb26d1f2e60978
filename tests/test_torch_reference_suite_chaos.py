"""The reference's chaos tier and the files that build on it, run
against the port through the import alias of
``test_torch_reference_suite.py``: the chaos drills, whose autouse
fixture holds the racecheck watchdog's lock edges and stage accesses
against the static lock graph and footprint table of the package the
code runs from; the sim end-to-end, sharding-sim and capture-replay
tiers, which import it; and ``bench.py``'s output tier, whose
``python bench.py`` children inherit the alias through ``PYTHONPATH``
and so run the port.

Reference files left out, and why, are listed in ``ROADMAP.md``."""

from __future__ import annotations

import pytest

from .test_torch_reference_suite import assert_passed, started_runs

# reference files whose imports close over the analysis slice
REFERENCE_FILES = [
    "test_bench_output.py",
    "test_chaos_e2e.py",
    "test_sim_e2e.py",
    "test_sharding_sim.py",
    "test_capture_replay.py",
]


@pytest.fixture(scope="module")
def runs():
    """Two at a time: ``bench.py``'s runs take most of the suite's time,
    and the others fit beside them."""
    yield from started_runs(REFERENCE_FILES, 2)


@pytest.mark.parametrize("test_file", REFERENCE_FILES)
def test_reference_file_passes_against_the_port(runs, test_file):
    assert_passed(runs[test_file].result())
