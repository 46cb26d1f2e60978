"""Traffic: from a mix, a configuration and ``--seed`` to a run's changes.

A mix is a data file of parameters, ``perfbench/traffic/<mix>/<config>.json``.
Its ``generator`` names the module that turns it into a schedule,
``perfbench/generators/<generator>.py``; each operation a generator draws
is ``perfbench/ops/<operation>.py``; each action on the world a mix asks
for (``actions``) is ``perfbench/actions/<action>.py``.  All are found by
name, so a new mix, operation or action is a new file.  Nothing is drawn
anywhere but from the seed: the same seed gives the same schedule.

A generator module has ``schedule(ctx, seconds)``, the changes due in a
window of ``seconds``, and may have ``base(traffic, population, config)``,
the population the window starts from (the configuration's by default).
An operation module has ``draw(ctx)``, one change or None when the mix
has nothing for it to touch.  A change is a dict: ``due`` (s from the
window's start), ``op`` (create / delete / edit), ``section`` and ``key``
of the object, and ``entry`` (create) or ``set`` (edit); ``name`` is the
mix's operation.  An action is ``{"due", "act", "args"}``; it changes
the deployment, not the objects the reference judges, and is not timed.
"""

from __future__ import annotations

import copy
import math
import random

from perfbench import byname, reference


def counts_by_share(shares: dict, n: int) -> dict:
    """Exactly ``n`` operations split by ``shares`` (largest remainder)."""
    raw = {op: shares[op] * n for op in sorted(shares)}
    counts = {op: math.floor(v) for op, v in raw.items()}
    left = n - sum(counts.values())
    for op in sorted(raw, key=lambda o: (counts[o] - raw[o], o))[:left]:
        counts[op] += 1
    return counts


def arrival_times(rate: float, n: int, seconds: float, rng: random.Random) -> list[float]:
    """``n`` arrival times in [0, seconds): the quantiles of the
    exponential gaps of a Poisson process at ``rate``, in an order
    ``rng`` draws, scaled to fill the window.  Every seed offers the same
    gaps, in another order."""
    gaps = [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]
    rng.shuffle(gaps)
    scale = seconds / (sum(gaps) + 1.0 / rate)
    times, t = [], 0.0
    for gap in gaps:
        t += gap
        times.append(t * scale)
    return times


def bound_services(record: dict) -> set:
    """``bench.py``'s ``swap_partner``: binding ``k`` may bind Service ``k``
    or Service ``k + 10``, of its own namespace; the keys of both."""
    keys = set()
    for binding in record["bindings"].values():
        keys.update(f"{binding['namespace']}/{name}" for name in partners(binding))
    return keys


def partners(binding: dict) -> tuple[str, str]:
    k = int(binding["name"][len("binding"):])
    return f"bench{k:04d}", f"bench{k + 10:04d}"


class Draw:
    """What an operation draws from: the live record as the schedule
    unfolds (``record``), the seed's stream (``rng``), the population's
    names (``population``), the mix's parameters (``traffic``).

    ``traffic`` may set ``target_skew``: an operation on a live object
    picks the object of rank r (its key's place in sorted order) with a
    weight of 1 / (r + 1) ** skew; 0, the default, is uniform.  With
    ``protect_bound_services`` the Services bindings refer to, or may
    swap to, are never deleted or edited: a binding to a missing Service
    is a user's fault the controller reports, not a change that
    converges."""

    def __init__(self, root, traffic: dict, population, config: dict, record: dict, seed):
        self.root, self.traffic, self.population, self.config = root, traffic, population, config
        self.record = copy.deepcopy(record)
        self.rng = random.Random(seed)
        self.protected = bound_services(self.record) if traffic.get("protect_bound_services") else set()
        self._next = {section: _next_index(self.record[section]) for section in ("services", "ingresses")}

    def take(self, section: str) -> int:
        """The next index of a new object of ``section``; never reused."""
        index = self._next[section]
        self._next[section] += 1
        return index

    def pick(self, section: str) -> str | None:
        """A live object of ``section`` to change, or None."""
        keys = sorted(k for k in self.record[section] if k not in self.protected)
        if not keys:
            return None
        skew = self.traffic.get("target_skew", 0)
        if not skew:
            return self.rng.choice(keys)
        return self.rng.choices(keys, weights=[1.0 / (r + 1) ** skew for r in range(len(keys))])[0]

    def draw(self, name: str, due: float) -> dict | None:
        """Operation ``name`` due at ``due``, applied to the live record."""
        change = byname.load(self.root, "ops", name).draw(self)
        if change is None:
            return None
        change["due"], change["name"] = due, name
        reference.apply_change(self.record, change)
        return change


def _next_index(table: dict) -> int:
    return 1 + max((int("".join(c for c in e["name"] if c.isdigit())) for e in table.values()), default=-1)


def generator(root, traffic: dict):
    return byname.load(root, "generators", traffic["generator"])


def base_record(root, traffic: dict, population, config: dict) -> dict:
    """The population the window starts from."""
    module = generator(root, traffic)
    if hasattr(module, "base"):
        return module.base(traffic, population, config)
    size = config["population"]
    return population.record(size["services"], size.get("ingresses", 0), size.get("bindings", 0))


def schedule(root, traffic: dict, population, config: dict, record: dict, seed, seconds: float) -> list[dict]:
    """The changes of one window of ``seconds``.  ``record`` is the
    population before the window; it is not modified."""
    ctx = Draw(root, traffic, population, config, record, seed)
    return generator(root, traffic).schedule(ctx, seconds)


def actions(traffic: dict, seconds: float) -> list[dict]:
    """The mix's actions on the deployment, each at its share ``at`` of
    the window: ``{"at": 0.33, "act": "kill_shard_holder", "args": {...}}``."""
    return sorted(
        ({"due": a["at"] * seconds, "act": a["act"], "args": dict(a.get("args", {}))}
         for a in traffic.get("actions", [])),
        key=lambda a: a["due"],
    )


def act(root, world, action: dict) -> None:
    """Carry out one action on ``world``."""
    byname.load(root, "actions", action["act"]).run(world, **action["args"])
