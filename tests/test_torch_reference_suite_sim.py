"""The reference's own tests for the simulation slice, run against the
port through the import alias of ``test_torch_reference_suite.py``
(one file per slice, so that ``--dist loadfile`` spreads the work).

Reference files of this slice left out, and why, are listed in
``ROADMAP.md``."""

from __future__ import annotations

import concurrent.futures

import pytest

from .test_torch_reference_suite import run_through_alias

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
    """Every file's run, started on first use, one at a time: these
    files are short, and running them side by side would only add load
    beside the wall-clock tests of the other test workers."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    try:
        yield {name: pool.submit(run_through_alias, name) for name in REFERENCE_FILES}
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


@pytest.mark.parametrize("test_file", REFERENCE_FILES)
def test_reference_file_passes_against_the_port(runs, test_file):
    result = runs[test_file].result()
    tail = (result.stdout + result.stderr)[-4000:]
    assert result.returncode == 0, tail
    assert " passed" in result.stdout, tail
