"""reconcile_cpu_ms_per_change: the stage accountant's thread-CPU
seconds, summed over every stage and controller
(``agac_profile_stage_cpu_seconds``), over the measured span, per change.
The thread clock ticks in 10 ms steps, so it is read window-long only."""

from perfbench.exposition import delta


def read(run):
    cpu = delta(run, "agac_profile_stage_cpu_seconds_sum")
    if cpu is None or not run.changes:
        return None
    return 1000.0 * cpu / run.changes
