"""The port stands alone: nothing under ``agac_tpu_torch/`` and
nothing in ``chip_smoke.py`` imports the reference package or JAX, and
only ``graft_entry.py`` imports ``torch``.  The reference keeps
process-global state behind hooks (the clock seam, the metrics
registry, the journey and SLO installs, the racecheck watchdog); a port
that mixed modules from both packages would split that state.  Every
port module keeps its counterpart path under ``agac_tpu/`` so that the
reference's tests run against it through an import alias, and that
alias reaches the interpreters those tests spawn."""

from __future__ import annotations

import ast
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "agac_tpu_torch"
PORT_ONLY = {"graft_entry.py"}


def _port_files() -> list[pathlib.Path]:
    return sorted(p for p in PORT.rglob("*.py") if "__pycache__" not in p.parts)


def _top_level_imports(path: pathlib.Path) -> set[str]:
    """Every absolute import's top-level name, at any depth of the
    module (function-level imports included)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _scanned() -> list[pathlib.Path]:
    return _port_files() + [REPO / "chip_smoke.py"]


def test_port_has_the_slice():
    files = {p.relative_to(PORT).as_posix() for p in _port_files()}
    assert {"manager.py", "cloudprovider/aws/driver.py", "graft_entry.py"} <= files
    assert {
        "sim/harness.py",
        "sim/replay.py",
        "autoscaler/policy.py",
        "cloudprovider/aws/batcher.py",
    } <= files
    assert {
        "__main__.py",
        "cmd/root.py",
        "cluster/rest.py",
        "cluster/testserver.py",
        "cloudprovider/aws/factory.py",
        "cloudprovider/aws/real_backend.py",
        "webhook/server.py",
        "manifests/generate.py",
        "observability/catalog.py",
        "signals.py",
    } <= files
    assert {
        f"analysis/{name}.py"
        for name in (
            "program", "rules", "lint", "lockorder", "census", "determinism", "confinement",
        )
    } <= files
    assert (REPO / "chip_smoke.py").is_file()


def test_capture_seam_is_the_ports_own():
    """The driver hook records every AWS call outcome through
    ``sim.capture``; the seam imports it plainly, with no stand-in that
    would hide a broken import by recording nothing."""
    from agac_tpu_torch.observability import instruments
    from agac_tpu_torch.sim import capture

    assert instruments._capture_mod() is capture
    assert not hasattr(instruments, "_NoCapture")


@pytest.mark.parametrize("name", ["agac_tpu", "jax", "jaxlib", "bench"])
def test_no_import_of_the_reference_or_jax(name):
    offenders = [
        p.relative_to(REPO).as_posix() for p in _scanned() if name in _top_level_imports(p)
    ]
    assert offenders == []


def test_torch_only_in_graft_entry():
    importers = {
        p.relative_to(REPO).as_posix()
        for p in _scanned()
        if "torch" in _top_level_imports(p)
    }
    assert importers <= {"agac_tpu_torch/graft_entry.py", "chip_smoke.py"}
    assert "agac_tpu_torch/graft_entry.py" in importers


def test_the_port_covers_every_reference_module():
    reference = REPO / "agac_tpu"
    missing = sorted(
        p.relative_to(reference).as_posix()
        for p in reference.rglob("*.py")
        if "__pycache__" not in p.parts and not (PORT / p.relative_to(reference)).is_file()
    )
    assert missing == []


def test_every_port_module_has_a_reference_counterpart():
    missing = [
        p.relative_to(PORT).as_posix()
        for p in _port_files()
        if p.name not in PORT_ONLY
        and not (REPO / "agac_tpu" / p.relative_to(PORT)).is_file()
    ]
    assert missing == []


def test_port_imports_without_the_reference(tmp_path):
    """Importing the whole slice loads no module of ``agac_tpu`` and no
    JAX (checked in a fresh interpreter, since this one has both)."""
    code = (
        "import sys\n"
        "import agac_tpu_torch.manager, agac_tpu_torch.cloudprovider.aws, "
        "agac_tpu_torch.controllers, agac_tpu_torch.sim.fuzz, agac_tpu_torch.sim.replay, "
        "agac_tpu_torch.cmd, agac_tpu_torch.cluster.testserver, agac_tpu_torch.cluster.dynamic, "
        "agac_tpu_torch.cloudprovider.aws.factory, agac_tpu_torch.webhook, "
        "agac_tpu_torch.manifests, agac_tpu_torch.observability.catalog, agac_tpu_torch.signals, "
        "agac_tpu_torch.analysis.lint, agac_tpu_torch.analysis.program, "
        "agac_tpu_torch.analysis.lockorder, agac_tpu_torch.analysis.census, "
        "agac_tpu_torch.analysis.determinism, agac_tpu_torch.analysis.confinement\n"
        "assert len(agac_tpu_torch.analysis.program._load_analyses()) == 4\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('agac_tpu', 'jax'))\n"
        "assert not bad, bad\n"
        "assert 'torch' not in sys.modules\n"
    )
    result = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert result.returncode == 0, result.stderr


def test_alias_reaches_spawned_interpreters():
    """In the environment the reference suites run in, an interpreter
    that a reference test spawns runs the port: ``python -m agac_tpu``
    executes the port's ``__main__`` and loads no file of the reference,
    and ``import agac_tpu.cmd.root`` gives the port's module."""
    from .test_torch_reference_suite import alias_env

    env = alias_env()
    ran = subprocess.run(
        [sys.executable, "-v", "-m", "agac_tpu", "version"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert ran.returncode == 0, ran.stderr[-4000:]
    assert "Version : 0.1.0" in ran.stdout
    loaded = re.findall(r"^# code object from '?([^'\n]+)", ran.stderr, re.M)
    assert any(re.search(r"agac_tpu_torch/(__pycache__/)?__main__", path) for path in loaded)
    assert [path for path in loaded if "/agac_tpu/" in path] == []
    imported = subprocess.run(
        [sys.executable, "-c", "import agac_tpu.cmd.root as r; print(r.__file__)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert imported.returncode == 0, imported.stderr
    assert pathlib.Path(imported.stdout.strip()) == PORT / "cmd" / "root.py"


def test_alias_reaches_the_bench_script():
    """``tests/test_bench_output.py`` runs ``python bench.py`` with the
    suite's environment: in it the script's imports load the port's
    files and none of the reference's."""
    from .test_torch_reference_suite import alias_env

    ran = subprocess.run(
        [sys.executable, "-v", "-c", "import bench, agac_tpu.analysis.lockorder"],
        cwd=REPO, env=alias_env(), capture_output=True, text=True, timeout=120,
    )
    assert ran.returncode == 0, ran.stderr[-4000:]
    loaded = re.findall(r"^# code object from '?([^'\n]+)", ran.stderr, re.M)
    assert any("agac_tpu_torch/manager" in path for path in loaded)
    assert any("agac_tpu_torch/analysis/lockorder" in path for path in loaded)
    assert [path for path in loaded if "/agac_tpu/" in path] == []
