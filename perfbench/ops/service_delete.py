"""A live Service deleted."""


def draw(ctx):
    key = ctx.pick("services")
    return None if key is None else {"op": "delete", "section": "services", "key": key}
