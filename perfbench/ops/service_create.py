"""A new Service, by the population's next name."""


def draw(ctx):
    key, entry = ctx.population.service(ctx.take("services"))
    return {"op": "create", "section": "services", "key": key, "entry": entry}
