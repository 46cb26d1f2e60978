"""A live Service's port set to another of the mix's ``ports``."""

PORTS = [80, 443, 8080, 8443]


def draw(ctx):
    key = ctx.pick("services")
    if key is None:
        return None
    entry = ctx.record["services"][key]
    choices = [p for p in ctx.traffic.get("ports", PORTS) if [p] != entry["ports"]]
    return {"op": "edit", "section": "services", "key": key, "set": {"ports": [ctx.rng.choice(choices)]}}
