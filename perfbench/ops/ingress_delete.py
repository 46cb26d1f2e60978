"""A live Ingress deleted."""


def draw(ctx):
    key = ctx.pick("ingresses")
    return None if key is None else {"op": "delete", "section": "ingresses", "key": key}
