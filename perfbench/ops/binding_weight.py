"""A live binding's weight set to any weight in 0-255 but its own."""


def draw(ctx):
    key = ctx.pick("bindings")
    if key is None:
        return None
    weight = ctx.rng.randrange(0, 255)
    weight += weight >= ctx.record["bindings"][key]["weight"]
    return {"op": "edit", "section": "bindings", "key": key, "set": {"weight": weight}}
