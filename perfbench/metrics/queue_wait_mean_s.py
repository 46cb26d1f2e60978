"""queue_wait_mean_s: the mean seconds an item waited in a workqueue
before a worker took it (``agac_workqueue_queue_duration_seconds``, sum
over count), over the measured span."""

from perfbench.exposition import delta


def read(run):
    waited = delta(run, "agac_workqueue_queue_duration_seconds_sum")
    items = delta(run, "agac_workqueue_queue_duration_seconds_count")
    if waited is None or not items:
        return None
    return waited / items
