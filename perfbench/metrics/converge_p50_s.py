"""converge_p50_s: the median, over every change due in the window, of
its due time to the first world read that shows it applied; a change
still open at the drain limit counts as that long.
``converge_p50_s.<op>`` takes the changes of one operation alone
(``create``, ``delete`` or ``edit``)."""

from perfbench.window import percentile


def read(run, op=None):
    latencies = run.latencies_of(op)
    return percentile(latencies, 0.50) if latencies else None
