"""The drift cell (``mixed-1200-drift.tamper``) on the CPU at a toy size:
population, period and read-plane windows cut here only, and a
tamper's target beyond the toy's Services moved onto its last one.  A
run ends correct with exactly two ticks in its measured span; with the
tickers off (the period at 0) the tampers stay and the run is not
correct; a tamper goes to the in-memory AWS, never through the shaping
proxy."""

from __future__ import annotations

import json
import time

import pytest

from helpers import run_cell, toy_root

CELL = "mixed-1200-drift.tamper"
SECONDS = 9.0  # ticks at 1 s and 7 s; the next at 13 s, after the span
TOY = {"services": 40, "ingresses": 8, "bindings": 4, "zones": 10}
PERIOD = 6.0


def drift_root(tmp, period: float = PERIOD):
    root = toy_root(tmp)
    path = root / "perfbench" / "configs" / "mixed-1200-drift.json"
    config = json.loads(path.read_text())
    config["population"] = TOY
    settings = config["settings"]  # the discovery TTL keeps its share of the period
    ttl = PERIOD * settings["discovery_ttl_s"] / settings["drift_resync_period_s"]
    settings.update(drift_resync_period_s=period, discovery_ttl_s=ttl, read_plane_ttl_s=2.0,
                    accelerator_missing_retry_s=1.0)
    config["phase_lock"] = {"tick_index": 2, "first_tick_s": 1.0}
    config["limits"] = {"base_s": 60.0, "drain_s": 15.0, "unshaped_drain_s": 15.0}
    path.write_text(json.dumps(config))
    # a target beyond the toy's Services becomes its last one, as late in a tick
    path = root / "perfbench" / "traffic" / "tamper" / "mixed-1200-drift.json"
    mix = json.loads(path.read_text())
    last = TOY["services"] - 1
    for action in mix["actions"]:
        target = action["args"]["target"]
        if target.startswith("service/") and int(target[-4:]) > last:
            action["args"]["target"] = f"service/ns{last % 10}/bench{last:04d}"
    path.write_text(json.dumps(mix))
    return root


def drift_line(printed: str) -> dict:
    (line,) = [l for l in printed.splitlines() if l.startswith("perfbench: drift ")]
    return json.loads(line[len("perfbench: drift "):])


def test_the_cell_ends_correct_with_two_ticks_in_its_span(tmp_path):
    code, result, printed = run_cell(drift_root(tmp_path), CELL, seconds=SECONDS, trace=1)
    assert code == 0, printed[-3000:]
    assert result["correct"] is True and result["failed"] == 0, printed[-3000:]
    details = json.loads(printed.splitlines()[0])["details"]
    assert [a[0] for a in details["actions"]] == ["tamper"] * 12
    drift = drift_line(printed)
    assert len(drift["ticks_s"]) == 3, drift
    for controller, ticks in drift["ticks_s"].items():
        in_span = [t for t in ticks if 0.0 <= t <= details["drain_s"]]
        assert len(in_span) == 2, (controller, ticks, details["drain_s"])
        assert in_span[0] == pytest.approx(1.0, abs=1.0) and in_span[1] == pytest.approx(7.0, abs=1.0)
    metrics = result["metrics"]
    # a round: 48 keys each for the Global Accelerator and Route53 controllers, 4 bindings
    assert metrics["drift_keys_per_tick"]["value"] == 100.0
    assert 0.0 < metrics["drift_tick_drain_s"]["value"] < PERIOD


def test_with_the_tickers_off_the_tampers_stay_and_the_run_is_not_correct(tmp_path):
    code, result, printed = run_cell(drift_root(tmp_path, period=0.0), CELL, seconds=SECONDS)
    assert code == 0, printed[-3000:]
    assert result["correct"] is False, printed[-3000:]
    assert result["checks"]["mismatched"]["value"] >= 1


def test_a_tamper_goes_around_the_shaping_proxy(tmp_path):
    from perfbench import byname, generate, reference
    from perfbench.world.population import Population
    from perfbench.worlds import inprocess_drift

    root = drift_root(tmp_path)
    config = json.loads((root / "perfbench" / "configs" / "mixed-1200-drift.json").read_text())
    mix = json.loads((root / "perfbench" / "traffic" / "tamper" / "mixed-1200-drift.json").read_text())
    population = Population(config["population"], config["cluster"])
    record = population.record(TOY["services"], TOY["ingresses"], TOY["bindings"])
    world = inprocess_drift.World(config, population, record, [])
    expected = reference.expected_world(record)
    world.create_base(record)
    world.start()
    try:
        deadline = time.monotonic() + 60.0
        while reference.compare(expected, world.reader.read())["mismatched"]:
            assert time.monotonic() < deadline
            time.sleep(0.25)
    finally:
        world.close()  # the program stops: every call after this is the tampers'
    time.sleep(0.5)
    counted, logged = world.shaped.snapshot(), len(world.aws.calls)
    for action in generate.actions(mix, 1.0):
        byname.load(root, "actions", action["act"]).run(world, **action["args"])
    assert world.shaped.snapshot() == counted
    assert len(world.aws.calls) > logged
    items = {t["item"] for t in world.tampers}
    assert len(items) == 12
    seen = world.reader.read(items)
    assert all(seen[item] != expected[item] for item in items), seen
