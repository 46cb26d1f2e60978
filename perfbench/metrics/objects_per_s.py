"""objects_per_s: the objects a run created over the seconds from the
window's start to the last of its changes converged (a wave's makespan);
nothing when a change failed."""


def read(run):
    if run.failed or not run.makespan_s:
        return None
    return run.changes / run.makespan_s
