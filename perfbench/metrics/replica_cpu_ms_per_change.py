"""replica_cpu_ms_per_change: the controller processes' CPU (user and
system, from ``/proc/<pid>/stat``, read by the harness) over the measured
span, per change."""


def read(run):
    start, end = run.start.get("cpu_s"), run.end.get("cpu_s")
    if not end or not run.changes:
        return None
    return 1000.0 * (sum(end.values()) - sum(start.values())) / run.changes
