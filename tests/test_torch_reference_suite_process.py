"""The reference's own process tests, run against the port through the
import alias of ``test_torch_reference_suite.py``: the apiserver over
HTTP, the webhook end to end, the command line and the manifests, and
the process drills, which spawn controllers as ``python -m agac_tpu``.
The alias reaches those children through ``PYTHONPATH``, so they run
the port too.

Reference files of this slice left out, and the drills deselected, are
listed in ``ROADMAP.md`` (and the drills in ``DESELECT``)."""

from __future__ import annotations

import pytest

from .test_torch_reference_suite import assert_passed, started_runs

# reference files whose imports close over the process slice
REFERENCE_FILES = [
    "test_envtest_e2e.py",
    "test_webhook_e2e.py",
    "test_cli_and_manifests.py",
    "test_process_e2e.py",
]


@pytest.fixture(scope="module")
def runs():
    """Started one at a time: the drills wait on wall-clock deadlines,
    and running them side by side would only add load beside them."""
    yield from started_runs(REFERENCE_FILES, 1)


@pytest.mark.parametrize("test_file", REFERENCE_FILES)
def test_reference_file_passes_against_the_port(runs, test_file):
    assert_passed(runs[test_file].result())
