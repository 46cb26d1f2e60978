"""Every cell's path, run on the CPU at toy sizes with the card stood in
for; a toy configuration, mix and metric found by name; and the modules
a run loads."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from helpers import ROOT, run_cell, toy_root

RATES = {"mixed-1200.storm": 1.0, "sharded-2x2.churn": 2.0}
CELLS = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy_root(tmp_path_factory.mktemp("bench"), rates=RATES)


@pytest.mark.parametrize("cell", [c["name"] for c in CELLS])
@pytest.mark.parametrize("trace", [0, 1])
def test_every_cell_runs_correct_on_the_cpu(root, cell, trace):
    code, result, printed = run_cell(root, cell, trace=trace)
    assert code == 0, printed[-3000:]
    assert result["correct"] is True, printed[-3000:]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    section = "per_layer" if trace else "end_to_end"
    wanted = {m["name"] for m in bench[section] if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == wanted, printed[-2000:]
    assert all(m["value"] >= 0 for m in result["metrics"].values())
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    root = toy_root(tmp_path, rates=RATES)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    toy = json.loads((root / "perfbench" / "configs" / "mixed-1200.json").read_text())
    toy["population"] = {"services": 24, "ingresses": 2, "bindings": 2, "zones": 3}
    (root / "perfbench" / "configs" / "toy-30.json").write_text(json.dumps(toy))
    (root / "perfbench" / "traffic" / "edits").mkdir()
    (root / "perfbench" / "traffic" / "edits" / "toy-30.json").write_text(json.dumps(
        {"generator": "open_loop", "rate": 3.0, "ops": {"service_port_edit": 0.5, "binding_weight": 0.5}}))
    (root / "perfbench" / "metrics" / "edits_seen.py").write_text(
        "def read(run):\n    return float(run.changes)\n")
    bench["configs"].append({"name": "toy-30", "source": "a test", "file": "perfbench/configs/toy-30.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy-30.edits", "config": "toy-30", "traffic": "edits",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "edits_seen", "unit": "changes", "better": "higher",
                               "source": "program_counter", "layer": "a test",
                               "moves": "converge_p50_s.edit", "workloads": ["toy-30.edits"]})
    bench["end_to_end"][0]["workloads"].append("toy-30.edits")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code, result, printed = run_cell(root, "toy-30.edits", seconds=3.0, trace=1)
    assert code == 0 and result["correct"], printed[-3000:]
    assert result["metrics"]["edits_seen"]["value"] == 9.0


def test_a_mix_kills_the_holder_of_a_shard_and_the_survivor_converges(tmp_path):
    root = toy_root(tmp_path, rates=RATES)
    path = root / "perfbench" / "traffic" / "churn" / "sharded-2x2.json"
    mix = json.loads(path.read_text())
    mix["actions"] = [{"at": 0.25, "act": "kill_shard_holder", "args": {"shard": 0}}]
    # a Service deleted while its holder is down leaves its chain to the
    # orphan sweeper, which this deployment does not run
    mix["ops"] = {"service_create": 0.5, "service_port_edit": 0.5}
    mix.pop("warmup_s", None)
    path.write_text(json.dumps(mix))
    config_path = root / "perfbench" / "configs" / "sharded-2x2.json"
    config = json.loads(config_path.read_text())
    config["limits"]["drain_s"] = 60.0
    config["settings"]["shards_per_replica"] = 2  # so that the survivor may hold both shards
    config_path.write_text(json.dumps(config))
    code, result, printed = run_cell(root, "sharded-2x2.churn", seconds=4.0, trace=1)
    assert code == 0 and result["correct"] and result["failed"] == 0, printed[-3000:]
    details = json.loads(printed.splitlines()[0])["details"]
    assert [a[:2] for a in details["actions"]] == [["kill_shard_holder", 1.0]]
    assert result["metrics"]["replica_cpu_ms_per_change"]["value"] > 0


def test_a_run_loads_no_jax_and_not_the_jax_package(root):
    script = (
        "import sys, json, pathlib\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "sys.path.insert(0, str(pathlib.Path('perfbench/tests').resolve()))\n"
        "from helpers import run_cell\n"
        f"code, result, printed = run_cell(pathlib.Path({str(root)!r}), 'mixed-1200.storm')\n"
        "print(json.dumps([code, sorted({m.split('.')[0] for m in sys.modules})]))\n"
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True, timeout=300)
    code, names = json.loads(out.stdout.strip().splitlines()[-1])
    assert code == 0, out.stderr[-3000:]
    assert "agac_tpu_torch" in names
    assert not {"jax", "jaxlib", "flax", "agac_tpu"} & set(names)


def test_without_the_port_a_run_gives_no_result(tmp_path):
    alone = tmp_path / "alone"
    shutil.copytree(ROOT / "perfbench", alone / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", alone / "BENCHMARK.json")
    script = (
        "import sys\nsys.path.insert(0, '.')\n"
        "from perfbench import run\nfrom perfbench.devices import NoDevice\n"
        "sys.exit(run.main(['--workload', 'mixed-1200.storm', '--seed', '1', '--seconds', '1',"
        " '--trace', '0'], device=NoDevice()))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script], cwd=alone, capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_without_a_card_the_command_gives_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "mixed-1200.storm", "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.card
def test_a_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "mixed-1200.storm", "--seed", "2200000003",
         "--seconds", "30", "--trace", "1"], cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
