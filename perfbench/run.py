"""Run one cell of the benchmark of ``agac_tpu_torch`` once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run brings up the cell's deployment, converges its base population,
then drives the cell's traffic for ``--seconds`` as an open loop (or one
wave), timing each change from when it was due to the first read of the
world that shows it applied.  After the window it keeps the shaping on
until every change has converged or the drain limit has passed (a change
still open then has failed), then drains the rest unshaped, compares the
whole world with the plain reference (``perfbench/reference.py``), and
prints one JSON line last.  With ``--trace 0`` the line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics and
the card's busy seconds.

Everything is found by name from ``BENCHMARK.json``: the configuration's
file, the mix at ``perfbench/traffic/<traffic>/<config>.json`` with its
generator, operations and actions (``perfbench/generate.py``), the kind
of deployment at ``perfbench/worlds/<world>.py`` and each metric's reader
at ``perfbench/metrics/<metric>.py`` (or, for ``<metric>.<variant>``
without a file of its own, ``perfbench/metrics/<metric>.py`` read for
that variant).

It exits without a result when the cell's CUDA devices are not there,
and when ``jax``, ``jaxlib``, ``flax`` or the JAX package ``agac_tpu``
is loaded once the window has closed.
"""

from __future__ import annotations

import time

STARTED = time.monotonic()

import argparse  # noqa: E402
import copy  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import byname, exposition, generate, reference  # noqa: E402
from perfbench.window import Window, percentile  # noqa: E402
from perfbench.world.population import Population  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "agac_tpu")
BASE_POLL_S = 0.25


class Run:
    """What the metric readers read: the window's latencies, each
    change's operation (create / delete / edit), counts, and
    ``start``/``end``, the world's sources at the measured span's two
    ends (the window's start, the end of the shaped drain)."""

    def __init__(self, setup_s: float, window: Window, drain_s: float, start: dict, end: dict):
        self.setup_s = setup_s
        self.changes = len(window.changes)
        self.ops = [change["op"] for change in window.changes]
        self.latencies, self.failed = window.latencies(drain_s)
        closed = [t for t in window.closed_at if t is not None]
        self.makespan_s = max(closed) if closed and not self.failed else None
        self.start, self.end = start, end

    def latencies_of(self, op: str | None = None) -> list[float]:
        """The latencies of the changes of operation ``op``, or of all."""
        return [lat for lat, o in zip(self.latencies, self.ops) if op in (None, o)]

    def latencies_of(self, op: str | None = None) -> list[float]:
        """The latencies of the changes of operation ``op``, or of all."""
        return [lat for lat, o in zip(self.latencies, self.ops) if op in (None, o)]


def load_json(path: pathlib.Path):
    with open(path) as f:
        return json.load(f)


def reader(root: pathlib.Path, metric: str):
    """``read(run)`` of ``perfbench/metrics/<metric>.py``; for a metric
    ``<name>.<variant>`` without a file of its own, ``read(run, variant)``
    of ``perfbench/metrics/<name>.py``."""
    if byname.path(root, "metrics", metric).is_file() or "." not in metric:
        return byname.load(root, "metrics", metric).read
    name, variant = metric.split(".", 1)
    read = byname.load(root, "metrics", name).read
    return lambda run: read(run, variant)


def cell_metrics(bench: dict, section: str, workload: str) -> list[dict]:
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


class Plan:
    """A run's changes, all drawn from the seed: the warm-up's (the mix
    at its rate for ``warmup_s`` before the window, from a stream of the
    seed's own, so the window finds the deployment as a long-running one
    is, its caches and snapshots loaded) and the window's; with the
    reference's items for each, and the records before the window and
    at its end."""

    def __init__(self, root: pathlib.Path, traffic: dict, population: Population, config: dict,
                 record0: dict, seed: int, seconds: float):
        record = copy.deepcopy(record0)
        self.warmup = []
        if traffic.get("warmup_s"):
            self.warmup = generate.schedule(root, traffic, population, config, record, f"{seed}/warmup",
                                            traffic["warmup_s"])
        self.warm_expects = [reference.change_items(record, change) for change in self.warmup]
        self.before = copy.deepcopy(record)
        self.changes = generate.schedule(root, traffic, population, config, self.before, seed, seconds)
        self.expects = [reference.change_items(record, change) for change in self.changes]
        self.actions = generate.actions(traffic, seconds)
        self.final = record


def load_cell(root: pathlib.Path, workload: str) -> tuple[dict, dict, dict, dict]:
    """``BENCHMARK.json``, the cell's entry, its configuration and mix."""
    bench = load_json(root / "BENCHMARK.json")
    (cell,) = [w for w in bench["workloads"] if w["name"] == workload]
    (config_entry,) = [c for c in bench["configs"] if c["name"] == cell["config"]]
    config = load_json(root / config_entry["file"])
    traffic = load_json(root / "perfbench" / "traffic" / cell["traffic"] / f"{cell['config']}.json")
    return bench, cell, config, traffic


def wait_converged(world, expected: dict, deadline_s: float, what: str) -> dict:
    """Poll whole-world reads until one matches ``expected``; the last
    comparison."""
    end = time.monotonic() + deadline_s
    while True:
        verdict = reference.compare(expected, world.reader.read())
        if not (verdict["mismatched"] or verdict["leftover"] or verdict["duplicates"]):
            return verdict
        if time.monotonic() > end:
            print(f"perfbench: {what} did not converge in {deadline_s} s: {verdict}", file=sys.stderr)
            return verdict
        time.sleep(BASE_POLL_S)


def main(argv=None, root: pathlib.Path = ROOT, device=None, plant=None) -> int:
    """``device`` and ``plant`` are for the CPU tests: a stand-in for the
    card, and a function that breaks the world before the window."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    started = STARTED if device is None else time.monotonic()

    bench, cell, config, traffic = load_cell(root, args.workload)
    # every cache a library may write goes inside the checkout, at a fixed path
    cache = root / ".perfbench-cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    if device is None:
        from perfbench.devices import Card, NoCard

        try:
            device = Card(cell["chips"], args.seed)
        except NoCard as exit_:
            return int(exit_.code)

    population = Population(config["population"], config["cluster"])
    record0 = generate.base_record(root, traffic, population, config)
    plan = Plan(root, traffic, population, config, record0, args.seed, args.seconds)
    warmup, changes, record = plan.warmup, plan.changes, plan.final
    world_mod = importlib.import_module(f"perfbench.worlds.{config['world']}")
    world = world_mod.World(config, population, record0, warmup + changes)
    limits = config["limits"]
    try:
        world.create_base(record0)
        world.start()
        base = wait_converged(world, reference.expected_world(record0), limits["base_s"], "the base population")
        if base["mismatched"] or base["leftover"] or base["duplicates"]:
            return 5
        if warmup:
            world.arm()
            Window(world, warmup, plan.warm_expects).run(traffic["warmup_s"], limits["drain_s"])
            warm = wait_converged(world, reference.expected_world(plan.before), limits["base_s"], "the warm-up")
            if warm["mismatched"] or warm["leftover"] or warm["duplicates"]:
                return 5
        world.settle()
        if plant is not None:
            plant(world)
        setup_s = time.monotonic() - started

        world.arm()
        start = world.sources()
        window = Window(world, changes, plan.expects, actions=plan.actions,
                        act=lambda action: generate.act(root, world, action))
        with device.tracer() as trace:
            device.step()
            drain_s = window.run(args.seconds, limits["drain_s"])
            end = world.sources()
        world.arm(False)
        final = wait_converged(world, reference.expected_world(record), limits["unshaped_drain_s"], "the final world")
        memory_peak = device.memory_peak_bytes()
    finally:
        world.close()
    loaded = sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"perfbench: modules loaded that the port must not load: {loaded}", file=sys.stderr)
        return 4

    run = Run(setup_s, window, drain_s, start, end)
    section = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for metric in cell_metrics(bench, section, args.workload):
        value = reader(root, metric["name"])(run)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    checks = {
        name: {"value": final[name], "limit": 0} for name in ("mismatched", "leftover", "duplicates")
    }
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device_info = {"platform": device.platform, "kind": device.kind, "count": device.count,
                   "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": run.changes, "failed": run.failed,
              "metrics": metrics, "device": device_info}
    if args.trace:
        device_info["busy_s"] = trace.busy_s
        device_info["window_s"] = trace.window_s
        result["breakdown"] = {
            "device_ops": [[name, s] for name, s in trace.device_ops],
            "idle_gaps": world.idle_gaps(start, end),
        }
    result["checks"] = checks
    lateness = sorted(window.lateness) or [0.0]
    if start.get("aws_calls") is not None:
        calls = {op: n - start["aws_calls"].get(op, 0) for op, n in end["aws_calls"].items()}
    else:  # a deployment of processes: the replicas' own count
        at = [exposition.by_label(s["expositions"], "agac_aws_api_calls_total", "op") for s in (start, end)]
        calls = {op: n - at[0].get(op, 0.0) for op, n in at[1].items()}
    details = {
        "workload": args.workload, "seed": args.seed, "changes": run.changes, "failed": run.failed,
        "setup_s": setup_s, "drain_s": drain_s, "window_reads": window.reads,
        "window_read_s": window.read_s, "actions": window.acted, "generator_lateness_p50_s": lateness[len(lateness) // 2],
        "generator_lateness_max_s": lateness[-1], "diffs": final["diffs"],
        "p50_by_op": {
            name: percentile([lat for lat, c in zip(run.latencies, changes) if c["name"] == name], 0.5)
            for name in sorted({c["name"] for c in changes})
        },
        "p50_by_10s": [
            percentile([lat for lat, c in zip(run.latencies, changes) if k <= c["due"] < k + 10] or [0.0], 0.5)
            for k in range(0, int(args.seconds), 10)
        ],
        "p95_by_10s": [
            percentile([lat for lat, c in zip(run.latencies, changes) if k <= c["due"] < k + 10] or [0.0], 0.95)
            for k in range(0, int(args.seconds), 10)
        ],
        "aws_calls": {op: n for op, n in sorted(calls.items()) if n},
    }
    print(json.dumps({"details": details}), flush=True)
    for name, check in checks.items():
        print(f"check {name} {check['value']} limit {check['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
