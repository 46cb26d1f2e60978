"""discovery_stall_s_per_change: the worker-seconds the discovery
snapshot held workers, over the measured span, per change: the
leaders' load seconds (``agac_read_plane_load_seconds``) plus the
seconds the callers parked behind them waited
(``agac_read_plane_wait_seconds``), ``cache="discovery"``, summed over
the replicas."""

from perfbench.walltime import seconds_per_change


def read(run):
    parts = [seconds_per_change(run, family, 'cache="discovery"')
             for family in ("agac_read_plane_load_seconds", "agac_read_plane_wait_seconds")]
    if None in parts:
        return None
    return sum(parts)
