"""The reference's own tests for the static analyses, run against the
port through the import alias of ``test_torch_reference_suite.py``:
the per-file linter and its rules, the whole-program analyses (lock
order, census, determinism, confinement) and their gate, the workflow
lint, and the property tests of the ported modules (serde, SigV4,
sharding, workqueue, driver).

Through the alias ``agac_tpu.__file__`` lies in the port's directory,
so a program the tests build over it names its modules
``agac_tpu_torch.…``.  The few cases that pin a module name of the
reference package are deselected (``DESELECT``), each with its reason,
and run with the name mapped in ``tests/test_torch_analysis.py``.  Reference
files left out, and why, are listed in ``ROADMAP.md``."""

from __future__ import annotations

import pytest

from .test_torch_reference_suite import assert_passed, started_runs

# reference files whose imports close over the analysis slice
REFERENCE_FILES = [
    "test_analysis_lint.py",
    "test_program_analysis.py",
    "test_confinement_analysis.py",
    "test_workflows_lint.py",
    "test_properties.py",
]


@pytest.fixture(scope="module")
def runs():
    yield from started_runs(REFERENCE_FILES, 2)


@pytest.mark.parametrize("test_file", REFERENCE_FILES)
def test_reference_file_passes_against_the_port(runs, test_file):
    assert_passed(runs[test_file].result())
