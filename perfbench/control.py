"""The control that the comparison deciding ``correct`` must fail.

    python3 perfbench/control.py --workload <cell> --seconds <s> --seeds 1,2,3

This system computes no floating-point result, so there is no lower
precision to run.  The control instead breaks a guarantee the
configuration states, that every acknowledged change converges: it is
the reference put in the program's place with each object's last change
in the window never applied (a stale answer where the guarantee asks the
exact one).  For each seed it prints the comparison's readings for the
control's world against the expected one; each must exceed its limit
of 0 for the comparison to be worth anything.
"""

from __future__ import annotations

import argparse
import json
import sys

from run import ROOT, Plan, load_cell  # noqa: E402  (sets sys.path)

from perfbench import generate, reference
from perfbench.world.population import Population


def readings(root, workload: str, seed: int, seconds: float) -> dict:
    _, _, config, traffic = load_cell(root, workload)
    population = Population(config["population"], config["cluster"])
    record0 = generate.base_record(root, traffic, population, config)
    plan = Plan(root, traffic, population, config, record0, seed, seconds)
    verdict = reference.compare(reference.expected_world(plan.final), reference.stale_world(plan.before, plan.changes))
    return {k: verdict[k] for k in ("mismatched", "leftover", "duplicates")} | {"changes": len(plan.changes)}


def main(argv=None, root=ROOT) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", required=True)
    args = parser.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **readings(root, args.workload, seed, args.seconds)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
