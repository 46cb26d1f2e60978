"""One wave: ``bench.py``'s mixed fleet created at once at t = 0 on an
empty cluster.  Its size is the configuration's ``wave_services``
Services, with a tenth as many Ingresses and bindings; the out-of-band
chains the bindings need are built in set-up.  The seed draws nothing:
every seed offers the same wave."""


def _sizes(config: dict) -> tuple[int, int]:
    n = config["wave_services"]
    return n, max(1, n // 10)


def base(traffic: dict, population, config: dict) -> dict:
    record = population.record(0, 0, 0)
    record["external"] = {f"ext{k:04d}": {"ports": [80]} for k in range(_sizes(config)[1])}
    return record


def schedule(ctx, seconds: float) -> list[dict]:
    n, m = _sizes(ctx.config)
    wave = ctx.population.record(n, m, m)
    changes = []
    for section in ("services", "ingresses", "bindings"):
        for key, entry in wave[section].items():
            changes.append({"due": 0.0, "name": f"{section}_create", "op": "create",
                            "section": section, "key": key, "entry": entry})
    return changes
