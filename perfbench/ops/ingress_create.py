"""A new ALB Ingress, by the population's next name."""


def draw(ctx):
    key, entry = ctx.population.ingress(ctx.take("ingresses"))
    return {"op": "create", "section": "ingresses", "key": key, "entry": entry}
