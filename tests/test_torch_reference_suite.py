"""The reference's own tests, run against the port.

Each reference test file whose ``agac_tpu`` imports all fall inside the
ported slice runs in a pytest subprocess with an import alias: a
``sys.meta_path`` finder that answers every import of ``agac_tpu`` or
``agac_tpu.<sub>`` with the module ``agac_tpu_torch.<sub>``, and runs
the port's ``__main__`` for ``python -m agac_tpu``.  The finder is
installed by a ``sitecustomize`` module on ``PYTHONPATH``, so every
interpreter the tests spawn (controllers, webhooks, the command line)
installs it too.  The reference package itself is then never loaded,
so its tests exercise the port alone.  The port
must pass whatever the reference passes: every file listed here passes
under the repository's tier-1 options, all of it but the few tests
``DESELECT`` names.

Reference files left out, and why, are listed in ``ROADMAP.md``.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import functools
import os
import shutil
import subprocess
import sys
import tempfile
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
# suite), each with its reason
DESELECT = {
    "test_confinement_analysis.py": [
        # each pins "agac_tpu.cloudprovider.aws.fake_backend::FakeAWSBackend"
        # against a program built over the package the alias serves, whose
        # modules are named after the port's directory; each runs with the
        # name mapped in tests/test_torch_analysis.py
        "TestFootprintTableGolden::test_api_family_covers_backend_implementations",
        "TestRuntimeCrosscheck::test_covered_write_passes",
        "TestRuntimeCrosscheck::test_any_active_stage_covering_suffices",
        "TestRuntimeCrosscheck::test_api_stage_names_normalize_to_family",
    ],
    "test_process_e2e.py": [
        # two wall-clock drills that fail now and then on the reference
        # itself (see ROADMAP.md); a flaky case would cost passes at random
        "TestKillRecoveryDrills::test_kill_mid_teardown_sweeper_mops_up",
        "TestElasticResizeProcessDrill::test_live_resize_2_to_4_then_kill_mid_shrink",
    ],
}

# the alias, written as ``sitecustomize.py`` into a directory that goes
# first on ``PYTHONPATH``: every interpreter the run starts (pytest's, and
# the controllers, webhooks and CLIs its tests spawn as ``python -m
# agac_tpu``) installs it at start-up, so no process of the run loads
# the reference package
ALIAS_SITECUSTOMIZE = textwrap.dedent(
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
            if fullname != SOURCE and not fullname.startswith(SOURCE + "."):
                return None
            own = importlib.util.find_spec(TARGET + fullname[len(SOURCE):])
            if own is None:
                return None
            if fullname.rpartition(".")[2] == "__main__":
                # ``python -m agac_tpu``: runpy asks the loader for the
                # code and runs it itself, so serve the port's own source
                # under the alias name; its relative imports then resolve
                # through the alias
                return importlib.util.spec_from_file_location(fullname, own.origin)
            return importlib.util.spec_from_loader(
                fullname, self, origin=own.origin,
                is_package=own.submodule_search_locations is not None,
            )

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
    """
)

ALIAS_BOOTSTRAP = textwrap.dedent(
    """
    import sys

    SOURCE, TARGET = "agac_tpu", "agac_tpu_torch"
    if not any(type(f).__name__ == "PortAlias" for f in sys.meta_path):
        sys.exit("the port alias is not installed: is its directory on PYTHONPATH?")

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


@functools.cache
def _alias_dir() -> str:
    directory = tempfile.mkdtemp(prefix="agac-port-alias-")
    atexit.register(shutil.rmtree, directory, ignore_errors=True)
    with open(os.path.join(directory, "sitecustomize.py"), "w") as f:
        f.write(ALIAS_SITECUSTOMIZE)
    return directory


def alias_env() -> dict[str, str]:
    """This process's environment with the alias first on ``PYTHONPATH``;
    children of a process started with it inherit it."""
    path = [_alias_dir(), *filter(None, [os.environ.get("PYTHONPATH")])]
    return dict(os.environ, PYTHONPATH=os.pathsep.join(path))


def run_through_alias(
    test_file: str, timeout: float = 300, marker: str = "not slow"
) -> subprocess.CompletedProcess:
    """``test_file`` under pytest with the alias installed, selecting
    the tests ``marker`` matches (tier-1's ``not slow`` by default)."""
    path = os.path.join("tests", test_file)
    deselect = [
        arg for test in DESELECT.get(test_file, ()) for arg in ("--deselect", f"{path}::{test}")
    ]
    return subprocess.run(
        [
            sys.executable, "-c", ALIAS_BOOTSTRAP, path,
            "-q", "-m", marker, "-p", "no:cacheprovider", "-p", "no:randomly",
            "-p", "no:xdist", *deselect,
        ],
        cwd=REPO,
        env=alias_env(),
        capture_output=True,
        text=True,
        timeout=timeout,
    )


def started_runs(files: list[str], parallel: int, marker: str = "not slow"):
    """A module fixture's body: every file's run, started together on
    first use, ``parallel`` at a time."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=parallel)
    try:
        yield {name: pool.submit(run_through_alias, name, marker=marker) for name in files}
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def assert_passed(result: subprocess.CompletedProcess) -> None:
    tail = (result.stdout + result.stderr)[-4000:]
    assert result.returncode == 0, tail
    assert " passed" in result.stdout, tail


@pytest.fixture(scope="module")
def runs():
    yield from started_runs(REFERENCE_FILES, PARALLEL)


@pytest.mark.parametrize("test_file", REFERENCE_FILES)
def test_reference_file_passes_against_the_port(runs, test_file):
    assert_passed(runs[test_file].result())
