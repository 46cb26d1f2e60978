"""An open loop: ``rate`` changes per second for the window, each due at
its time whatever the system does.

Parameters: ``rate``; ``ops``, the share of each operation (summing to
1); those of ``perfbench/generate.py``'s ``Draw`` (``target_skew``,
``protect_bound_services``) and of the operations (``ports``).  The
arrivals are the quantiles of the exponential gaps of a Poisson process
at ``rate``, and each operation comes exactly its share of times; the
seed draws the order of both, the targets and the values an edit sets.
So every seed offers the same work in another order."""

from perfbench.generate import arrival_times, counts_by_share


def schedule(ctx, seconds: float) -> list[dict]:
    traffic = ctx.traffic
    n = max(1, round(traffic["rate"] * seconds))
    counts = counts_by_share(traffic["ops"], n)
    names = [op for op in sorted(counts) for _ in range(counts[op])]
    ctx.rng.shuffle(names)
    times = arrival_times(traffic["rate"], n, seconds, ctx.rng)
    changes = [ctx.draw(name, due) for due, name in zip(times, names)]
    return [change for change in changes if change is not None]
