"""Find a cell's knee: the highest offered rate its deployment sustains.

    python3 perfbench/sweep.py --workload <cell> --seed <n> --seconds <s> --rates 4,6,8

One process brings the cell's deployment up once, then offers its mix at
each rate in turn for ``--seconds``, drains it with the shaping on, and
prints one JSON line per rate: the changes, the convergence p50 and p95,
those still open when the window closed and after the drain, and the
drain's length.  Past the knee the backlog grows through the window, so
the p95 climbs with the rate and the drain lengthens.  The cell's rate in
its mix file is set once from a sweep on the chip, at about four fifths
of the knee.
"""

from __future__ import annotations

import argparse
import copy
import importlib
import json
import sys
import time

from run import ROOT, load_cell, wait_converged  # noqa: E402  (sets sys.path)

from perfbench import generate, reference
from perfbench.window import Window, percentile
from perfbench.world.population import Population


def main(argv=None, root=ROOT) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--rates", required=True)
    parser.add_argument("--drain", type=float, default=40.0)
    args = parser.parse_args(argv)
    _, _, config, traffic = load_cell(root, args.workload)
    population = Population(config["population"], config["cluster"])
    record0 = generate.base_record(root, traffic, population, config)
    rates = [float(r) for r in args.rates.split(",")]
    record, plans, everything = copy.deepcopy(record0), [], []
    for k, rate in enumerate(rates):
        changes = generate.schedule(root, {**traffic, "rate": rate}, population, config, record, args.seed + k,
                                    args.seconds)
        expects = [reference.change_items(record, change) for change in changes]
        plans.append((rate, changes, expects, copy.deepcopy(record)))
        everything += changes
    world = importlib.import_module(f"perfbench.worlds.{config['world']}").World(
        config, population, record0, everything)
    try:
        world.create_base(record0)
        world.start()
        wait_converged(world, reference.expected_world(record0), config["limits"]["base_s"], "the base population")
        world.settle()
        world.arm()
        for rate, changes, expects, after in plans:
            window = Window(world, changes, expects)
            started = time.monotonic()
            drain = window.run(args.seconds, args.drain)
            latencies, failed = window.latencies(drain)
            open_at_close = sum(
                1 for c, t in zip(changes, window.closed_at) if t is None or t > args.seconds
            )
            verdict = wait_converged(world, reference.expected_world(after), 60.0, f"rate {rate}")
            print(json.dumps({
                "workload": args.workload, "rate": rate, "changes": len(changes),
                "p50_s": percentile(latencies, 0.5), "p95_s": percentile(latencies, 0.95),
                "open_at_close": open_at_close, "failed": failed, "drain_s": drain,
                "settled_s": time.monotonic() - started,
                "world": {k: verdict[k] for k in ("mismatched", "leftover", "duplicates")},
            }), flush=True)
    finally:
        world.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
