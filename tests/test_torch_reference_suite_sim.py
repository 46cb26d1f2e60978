"""The reference's own tests for the simulation slice, run against the
port through the import alias of ``test_torch_reference_suite.py``
(one file per slice, so that ``--dist loadfile`` spreads the work).

Reference files of this slice left out, and why, are listed in
``ROADMAP.md``."""

from __future__ import annotations

import pytest

from .test_torch_reference_suite import assert_passed, started_runs

# reference files whose imports close over the sim slice
REFERENCE_FILES = [
    "test_serde.py",
    "test_r53_batching.py",
    "test_autoscaler.py",
    "test_sim_runtime.py",
    "test_autoscaler_sim.py",
]


@pytest.fixture(scope="module")
def runs():
    """Started one at a time: these files are short, and running them
    side by side would only add load beside the wall-clock tests of the
    other test workers."""
    yield from started_runs(REFERENCE_FILES, 1)


@pytest.mark.parametrize("test_file", REFERENCE_FILES)
def test_reference_file_passes_against_the_port(runs, test_file):
    assert_passed(runs[test_file].result())
