"""The reference's own tests, run against the port.

Each reference test file whose ``agac_tpu`` imports all fall inside the
ported slice runs in a pytest subprocess that first installs an import
alias: a ``sys.meta_path`` finder that answers every import of
``agac_tpu`` or ``agac_tpu.<sub>`` with the module
``agac_tpu_torch.<sub>``.  The reference package itself is then never
loaded in that process, so its tests exercise the port alone.  The port
must pass whatever the reference passes: every file listed here passes
under the repository's tier-1 options, all of it but the few tests
``DESELECT`` names.

Reference files left out, and why, are listed in ``ROADMAP.md``.
"""

from __future__ import annotations

import concurrent.futures
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the files run a few at a time, so the whole suite takes about a
# third of their summed time
PARALLEL = 3

# reference files whose imports close over the slice
REFERENCE_FILES = [
    "test_errors.py",
    "test_load_balancer.py",
    "test_fake_cluster.py",
    "test_workqueue.py",
    "test_reconcile.py",
    "test_informer.py",
    "test_driver.py",
    "test_ga_helpers.py",
    "test_route53_helpers.py",
    "test_fake_backend_validation.py",
    "test_discovery_cache.py",
    "test_read_plane.py",
    "test_pending_settle.py",
    "test_leaderelection.py",
    "test_controllers_e2e.py",
    "test_gc_sweeper.py",
    "test_drift_resync.py",
    "test_drift_call_budget.py",
    "test_sharding.py",
    "test_journey_slo.py",
    "test_explain.py",
    "test_analysis_racecheck.py",
]

# single tests left out of a listed file (here or in a later slice's
# suite): each imports a module beyond the ported slices
DESELECT = {
    "test_drift_resync.py": [
        # imports tests/test_chaos_e2e.py, which needs analysis.confinement
        "TestTamperStorm::test_fleet_reconverges_after_out_of_band_tampering",
    ],
    "test_serde.py": [
        # imports cluster.rest, the wire slice
        "test_fuzz_round_trip_every_registered_kind",
    ],
}

ALIAS_BOOTSTRAP = textwrap.dedent(
    """
    import importlib
    import importlib.abc
    import importlib.util
    import sys

    SOURCE, TARGET = "agac_tpu", "agac_tpu_torch"


    class PortAlias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
        \"\"\"Serve ``agac_tpu[.sub]`` with the module ``agac_tpu_torch[.sub]``.\"\"\"

        own_specs = {}

        def find_spec(self, fullname, path=None, target=None):
            if fullname == SOURCE or fullname.startswith(SOURCE + "."):
                return importlib.util.spec_from_loader(fullname, self)
            return None

        def create_module(self, spec):
            module = importlib.import_module(TARGET + spec.name[len(SOURCE):])
            self.own_specs[spec.name] = module.__spec__
            return module

        def exec_module(self, module):
            # the port module ran when create_module imported it; give
            # it back the spec the import system replaced with the
            # alias's, so its relative imports resolve in the port
            module.__spec__ = self.own_specs.pop(module.__spec__.name)


    sys.meta_path.insert(0, PortAlias())

    import pytest

    rc = pytest.main(sys.argv[1:])
    leaked = sorted(
        name for name, mod in sys.modules.items()
        if name.split(".")[0] == SOURCE
        and not getattr(mod, "__name__", "").startswith(TARGET)
    )
    if leaked:
        print("reference modules loaded despite the alias:", leaked)
        rc = rc or 99
    sys.exit(rc)
    """
)


def run_through_alias(test_file: str, timeout: float = 300) -> subprocess.CompletedProcess:
    path = os.path.join("tests", test_file)
    deselect = [
        arg for test in DESELECT.get(test_file, ()) for arg in ("--deselect", f"{path}::{test}")
    ]
    return subprocess.run(
        [
            sys.executable, "-c", ALIAS_BOOTSTRAP, path,
            "-q", "-m", "not slow", "-p", "no:cacheprovider", "-p", "no:randomly",
            "-p", "no:xdist", *deselect,
        ],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=timeout,
    )


@pytest.fixture(scope="module")
def runs():
    """Every file's run, started together on first use, a few at a time."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=PARALLEL)
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
