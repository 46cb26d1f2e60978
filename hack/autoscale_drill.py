#!/usr/bin/env python3
"""Run the autoscaler canary over controller processes, off the card.

    python3 hack/autoscale_drill.py [--tail 30] [--acting-only]
                                    [--out DIR] [--checkout PATH]

Runs ``chip_smoke.autoscale_runs`` (the acting run and its observe-only
twin) or, with ``--acting-only``, the acting run alone, at the
``autoscale`` phase's size through ``python -m agac_tpu_torch`` of the
checkout at ``--checkout`` (default: this one).  ``--tail`` holds the
acting run that many seconds past its scale-in's stable ring: a long
tail shows whether the fleet flips back.  A run that fails its bounds is
recorded, not fatal.  Prints one JSON line: the ring epochs and when
they appeared, the decisions executed per replica and each run's drain
time.  The run's logs stay under ``--out``.  No card is needed.
"""

from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import shutil
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tail", type=float, default=None)
    parser.add_argument("--acting-only", action="store_true", help="no observe-only twin")
    parser.add_argument("--out", default="autoscale-drill")
    parser.add_argument("--checkout", default=str(pathlib.Path(__file__).resolve().parent.parent))
    args = parser.parse_args(argv)
    checkout = pathlib.Path(args.checkout).resolve()
    sys.path.insert(0, str(checkout))
    smoke = importlib.import_module("chip_smoke")
    if args.tail is not None:
        smoke.AUTOSCALE_TAIL_S = args.tail
    pkg = smoke.load(smoke.PORT)
    run = pathlib.Path(args.out).resolve()
    shutil.rmtree(run, ignore_errors=True)  # a state file left over would be reused
    run.mkdir(parents=True)
    sizes = (smoke.AUTOSCALE_BASE, smoke.AUTOSCALE_WAVE, smoke.SHARD_LATENCY)
    start = time.monotonic()
    try:
        if args.acting_only:
            result = {"acting": smoke.autoscale_fleet(pkg, smoke.PORT, *sizes, run, False)}
        else:
            result = smoke.autoscale_runs(pkg, smoke.PORT, *sizes, run)
        outcome = {"ok": True, "busy_cores_max": result.get("busy_cores_max"), **{
            name: {key: result[name][key] for key in (
                "epochs_s", "stable_s", "scale_out", "scale_in", "drain_s", "settle_s",
                "replicas", "journeys", "replica_cores_busy",
            )}
            for name in ("acting", "observe-only") if name in result
        }}
    except smoke.PhaseError as err:
        outcome = {"ok": False, "error": str(err)[:2000]}
    print(json.dumps({"checkout": str(checkout), "seconds": time.monotonic() - start,
                      **outcome}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
