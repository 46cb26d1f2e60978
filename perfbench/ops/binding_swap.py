"""A live binding's serviceRef swapped to its partner of the same
namespace (``bench.py``'s ``swap_partner``: Service k and Service k + 10)."""

from perfbench.generate import partners


def draw(ctx):
    key = ctx.pick("bindings")
    if key is None:
        return None
    entry = ctx.record["bindings"][key]
    own, partner = partners(entry)
    return {"op": "edit", "section": "bindings", "key": key,
            "set": {"service": partner if entry["service"] == own else own}}
