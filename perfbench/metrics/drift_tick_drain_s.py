"""drift_tick_drain_s: the mean, over the drift ticks whose drain ended in
the measured span, of the seconds from a tick's start until every key it
enqueued had finished a reconcile begun after its enqueue
(``agac_drift_tick_drain_seconds``, sum over count, every controller)."""

from perfbench.exposition import delta


def read(run):
    drained = delta(run, "agac_drift_tick_drain_seconds_sum")
    ticks = delta(run, "agac_drift_tick_drain_seconds_count")
    if drained is None or not ticks:
        return None
    return drained / ticks
