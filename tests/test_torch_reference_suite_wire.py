"""The reference's own tests for the wire slice (SigV4, the real AWS
backend's wire format, the health plane, the REST client, the dynamic
client, the webhook, the metric catalog and the profiling plane), run
against the port through the import alias of
``test_torch_reference_suite.py``.

Reference files of this slice left out, and why, are listed in
``ROADMAP.md``."""

from __future__ import annotations

import pytest

from .test_torch_reference_suite import PARALLEL, assert_passed, started_runs

# reference files whose imports close over the wire slice
REFERENCE_FILES = [
    "test_sigv4_aws_vectors.py",
    "test_credentials.py",
    "test_wire_golden.py",
    "test_real_aws_backend.py",
    "test_health_plane.py",
    "test_rest_client.py",
    "test_dynamic.py",
    "test_webhook.py",
    "test_observability.py",
    "test_profiling.py",
]


@pytest.fixture(scope="module")
def runs():
    yield from started_runs(REFERENCE_FILES, PARALLEL)


@pytest.mark.parametrize("test_file", REFERENCE_FILES)
def test_reference_file_passes_against_the_port(runs, test_file):
    assert_passed(runs[test_file].result())
