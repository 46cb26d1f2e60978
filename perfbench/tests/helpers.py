"""A benchmark checkout at toy sizes, for the CPU tests."""

from __future__ import annotations

import io
import json
import pathlib
import shutil
import contextlib

ROOT = pathlib.Path(__file__).resolve().parents[2]

TOY_SIZES = {
    "mixed-1200": {"services": 40, "ingresses": 4, "bindings": 4, "zones": 10},
    "sharded-2x2": {"services": 12, "shared_lb": "shardlb", "namespace": "default"},
}


def toy_root(tmp: pathlib.Path, sizes: dict = TOY_SIZES, rates: dict | None = None) -> pathlib.Path:
    """A copy of the benchmark with the configurations cut to ``sizes``
    and the mixes' rates set from ``rates`` (cell -> changes/s), and a
    link to the port beside it."""
    root = tmp / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "agac_tpu_torch").symlink_to(ROOT / "agac_tpu_torch")
    for name, size in sizes.items():
        path = root / "perfbench" / "configs" / f"{name}.json"
        config = json.loads(path.read_text())
        config["population"] = size
        if "wave_services" in config:
            config["wave_services"] = 30
        config["limits"] = {"base_s": 60.0, "drain_s": 15.0, "unshaped_drain_s": 5.0}
        path.write_text(json.dumps(config))
    for cell, rate in (rates or {}).items():
        config, traffic = cell.split(".")
        path = root / "perfbench" / "traffic" / traffic / f"{config}.json"
        mix = json.loads(path.read_text())
        if "rate" in mix:
            mix["rate"] = rate
        path.write_text(json.dumps(mix))
    return root


def run_cell(root: pathlib.Path, workload: str, seconds: float = 3.0, trace: int = 0,
             seed: int = 2_200_000_017, plant=None) -> tuple[int, dict | None, str]:
    """One run of ``workload`` with the card stood in for; the exit code,
    the result line and everything the run printed."""
    from perfbench import run
    from perfbench.devices import NoDevice

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = run.main(
            ["--workload", workload, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
            root=root, device=NoDevice(), plant=plant,
        )
    lines = out.getvalue().strip().splitlines()
    result = json.loads(lines[-1]) if code == 0 and lines else None
    return code, result, out.getvalue() + err.getvalue()
