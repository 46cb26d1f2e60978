"""The generators: a seed gives one schedule, and every seed the same work
in another order."""

from __future__ import annotations

import collections
import json

import pytest

from perfbench import generate
from perfbench.world.population import Population

from helpers import ROOT

MIXES = [("churn", "mixed-1200"), ("weights", "mixed-1200"), ("churn", "sharded-2x2"), ("storm", "mixed-1200")]


def schedule(traffic: str, config: str, seed: int, seconds: float = 20.0, root=ROOT, **params) -> list[dict]:
    conf = json.loads((root / "perfbench" / "configs" / f"{config}.json").read_text())
    mix = json.loads((root / "perfbench" / "traffic" / traffic / f"{config}.json").read_text()) | params
    population = Population(conf["population"], conf["cluster"])
    record = generate.base_record(root, mix, population, conf)
    return generate.schedule(root, mix, population, conf, record, seed, seconds)


def gaps(changes: list[dict]) -> list[float]:
    dues = [0.0] + [c["due"] for c in changes]
    return sorted(round(b - a, 9) for a, b in zip(dues, dues[1:]))


@pytest.mark.parametrize("traffic,config", MIXES)
def test_a_seed_gives_one_schedule(traffic, config):
    assert schedule(traffic, config, 2**31 + 11) == schedule(traffic, config, 2**31 + 11)


@pytest.mark.parametrize("traffic,config", MIXES)
def test_seeds_offer_the_same_work_in_another_order(traffic, config):
    a, b = schedule(traffic, config, 2**31 + 5), schedule(traffic, config, 2**31 + 6)
    assert collections.Counter(c["name"] for c in a) == collections.Counter(c["name"] for c in b)
    assert gaps(a) == pytest.approx(gaps(b))
    if traffic != "storm":
        assert [c["name"] for c in a] != [c["name"] for c in b]
        assert [c["due"] for c in a] != [c["due"] for c in b]
        assert [c["key"] for c in a] != [c["key"] for c in b]


def test_open_loop_fills_the_window_at_its_rate():
    mix = json.loads((ROOT / "perfbench" / "traffic" / "churn" / "mixed-1200.json").read_text())
    changes = schedule("churn", "mixed-1200", 1, 30.0)
    assert len(changes) == round(mix["rate"] * 30.0)
    assert 0.0 < changes[0]["due"] and changes[-1]["due"] < 30.0
    assert all(x["due"] <= y["due"] for x, y in zip(changes, changes[1:]))


def test_the_wave_is_the_configurations_cut():
    conf = json.loads((ROOT / "perfbench" / "configs" / "mixed-1200.json").read_text())
    changes = schedule("storm", "mixed-1200", 1)
    n = conf["wave_services"]
    assert "wave_services" in conf["reduced"]
    assert collections.Counter(c["section"] for c in changes) == {
        "services": n, "ingresses": n // 10, "bindings": n // 10}
    assert {c["due"] for c in changes} == {0.0}


def test_churn_never_touches_a_bound_service():
    bound = {f"ns{k % 10}/bench{j:04d}" for k in range(100) for j in (k, k + 10)}
    for change in schedule("churn", "mixed-1200", 3):
        assert change["key"] not in bound


def test_a_created_name_is_never_reused():
    created = [c["key"] for c in schedule("churn", "sharded-2x2", 9, 40.0) if c["op"] == "create"]
    assert len(created) == len(set(created))
    assert not set(created) & {f"default/shard{i:04d}" for i in range(200)}


def test_a_weight_edit_always_changes_the_weight():
    changes = schedule("weights", "mixed-1200", 4)
    weights = {}
    for change in changes:
        if change["name"] == "binding_weight":
            assert change["set"]["weight"] != weights.get(change["key"], 100)
            assert 0 <= change["set"]["weight"] <= 255
            weights[change["key"]] = change["set"]["weight"]


def test_a_skew_puts_the_edits_on_the_first_keys():
    def top_share(changes):
        counts = collections.Counter(c["key"] for c in changes)
        return sum(n for _, n in counts.most_common(10)) / len(changes)

    uniform = schedule("weights", "mixed-1200", 7, 30.0)
    skewed = schedule("weights", "mixed-1200", 7, 30.0, target_skew=1.2)
    assert top_share(skewed) > 0.5 > 0.2 > top_share(uniform)


def test_actions_fall_at_their_share_of_the_window():
    mix = {"actions": [{"at": 0.5, "act": "kill_shard_holder", "args": {"shard": 1}},
                       {"at": 0.25, "act": "noop"}]}
    assert generate.actions(mix, 40.0) == [
        {"due": 10.0, "act": "noop", "args": {}},
        {"due": 20.0, "act": "kill_shard_holder", "args": {"shard": 1}},
    ]


def test_an_operation_and_a_generator_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    (root / "perfbench" / "ops").mkdir(parents=True)
    (root / "perfbench" / "generators").mkdir()
    for name in ("configs", "traffic"):
        (root / "perfbench" / name).symlink_to(ROOT / "perfbench" / name)
    (root / "perfbench" / "ops" / "service_touch.py").write_text(
        "def draw(ctx):\n"
        "    key = ctx.pick('services')\n"
        "    return {'op': 'edit', 'section': 'services', 'key': key, 'set': {'ports': [81]}}\n")
    (root / "perfbench" / "generators" / "every_second.py").write_text(
        "def schedule(ctx, seconds):\n"
        "    return [ctx.draw(ctx.traffic['op'], float(t)) for t in range(int(seconds))]\n")
    changes = schedule("churn", "sharded-2x2", 3, 5.0, root=root, generator="every_second", op="service_touch")
    assert [(c["due"], c["name"], c["set"]) for c in changes] == [
        (float(t), "service_touch", {"ports": [81]}) for t in range(5)]
