#!/usr/bin/env python3
"""Audit the live resize for keys that two replicas mutate.

    python3 hack/resize_audit.py [--runs 3] [--services 200] [--latency 0.3]
                                 [--out DIR] [--checkout PATH]

Runs ``chip_smoke.resize_fleet`` through ``python -m agac_tpu_torch`` of
the checkout at ``--checkout`` (default: this one) ``--runs`` times, each
controller keeping an incident capture (``AGAC_CAPTURE_PATH``).  A run
that fails its bounds is recorded, not fatal.  From each run's captures
and logs it then counts:

- late mutations: AWS mutations a replica made on a key after logging
  the drain of the key's old shard (``resize epoch E: shard S
  drained``), when the key moved to a shard another replica adopted;
- duplicate creates: keys whose accelerator more than one replica
  created.

Prints one JSON line per run; each run's directory (logs, captures,
state file) stays under ``--out``.  No card is needed.
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import json
import os
import pathlib
import re
import sys

MUTATING = ("create_", "update_", "delete_", "tag_", "untag_")
HANDOFF = re.compile(
    r"^I\d{4} (\d\d):(\d\d):(\d\d)\.(\d{3}) \S+ resize epoch (\d+): shard (\d+) "
    r"(drained|adopting)\b"
)
CAPTURE = re.compile(r"incident capture armed: \S*capture-(\d+)\.jsonl")
RINGS = {1: (2, 4), 2: (4, 2)}  # resize_fleet's epochs: old and new shard counts


def _key(name: str) -> str:
    return "default/" + name.split("service-default-", 1)[1]


def audit(ring_mod, run: pathlib.Path) -> dict:
    """Late mutations and duplicate creates of one run's directory."""
    rings = {e: (ring_mod.HashRing(o), ring_mod.HashRing(n)) for e, (o, n) in RINGS.items()}
    calls: dict[str, list] = {}
    drains: dict[tuple, float] = {}
    adopts: set[tuple] = set()
    for err in sorted(run.glob("controller-*.stderr")):
        text = err.read_text(errors="replace")
        pid = CAPTURE.search(text).group(1)
        records = [
            json.loads(line)
            for line in (run / f"capture-{pid}.jsonl").read_text().splitlines()
            if line.strip()
        ]
        header = records[0]
        day = datetime.datetime.fromtimestamp(header["wall"])
        for line in text.splitlines():
            match = HANDOFF.match(line)
            if match is None:
                continue
            h, m, s, ms, epoch, shard, what = match.groups()
            wall = day.replace(
                hour=int(h), minute=int(m), second=int(s), microsecond=int(ms) * 1000
            ).timestamp()
            if what == "drained":
                drains[(pid, int(epoch), int(shard))] = header["monotonic"] + wall - header["wall"]
            else:
                adopts.add((pid, int(epoch), int(shard)))
        calls[pid] = [r for r in records[1:] if r.get("kind") == "aws"]
    owner_of = {}  # accelerator arn -> key
    for records in calls.values():
        for r in records:
            data = r["data"]
            if data["op"] == "create_accelerator" and data.get("outcome") == "success":
                owner_of[data["result"]["fields"]["acceleratorArn"]] = _key(data["args"][0])
    late, creators = [], {}
    for pid, records in calls.items():
        for r in records:
            data = r["data"]
            if not data["op"].startswith(MUTATING):
                continue
            args = data["args"]
            if data["op"] == "create_accelerator":
                key = _key(args[0])
                creators.setdefault(key, []).append((pid, r["t"]))
            elif args and isinstance(args[0], str):
                key = owner_of.get(args[0].split("/listener/")[0])
            else:
                key = None
            if key is None:
                continue
            start = r["t"] - data.get("duration", 0.0)
            for (donor, epoch, shard), drained_at in drains.items():
                old, new = rings[epoch]
                target = new.shard_for_key(key)
                if (
                    donor == pid
                    and old.shard_for_key(key) == shard
                    and target != shard
                    and (pid, epoch, target) not in adopts
                    and start > drained_at
                ):
                    late.append({"key": key, "pid": pid, "op": data["op"],
                                 "s_after_drain": start - drained_at})
    duplicates = {k: v for k, v in creators.items() if len({pid for pid, _ in v}) > 1}
    return {
        "late_mutations": len(late),
        "late_keys": len({x["key"] for x in late}),
        "max_s_after_drain": max((x["s_after_drain"] for x in late), default=0.0),
        "late_examples": sorted(late, key=lambda x: -x["s_after_drain"])[:3],
        "duplicate_creates": duplicates,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=3)
    parser.add_argument("--services", type=int, default=200)
    parser.add_argument("--latency", type=float, default=0.3)
    parser.add_argument("--out", default="resize-audit")
    parser.add_argument("--checkout", default=str(pathlib.Path(__file__).resolve().parent.parent))
    args = parser.parse_args(argv)
    checkout = pathlib.Path(args.checkout).resolve()
    sys.path.insert(0, str(checkout))
    smoke = importlib.import_module("chip_smoke")
    package = smoke.PORT
    pkg = smoke.load(package)
    for k in range(args.runs):
        run = pathlib.Path(args.out).resolve() / f"run-{k}"
        run.mkdir(parents=True, exist_ok=True)
        os.environ["AGAC_CAPTURE_PATH"] = str(run / "capture-%p.jsonl")
        try:
            result = smoke.resize_fleet(pkg, package, args.services, args.latency, run)
            outcome = {"ok": True, "grow_s": result["grow_s"], "shrink_s": result["shrink_s"]}
        except smoke.PhaseError as err:
            outcome = {"ok": False, "error": str(err)[:300]}
        print(json.dumps({"run": k, "checkout": str(checkout), **outcome,
                          **audit(pkg.ring, run)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
