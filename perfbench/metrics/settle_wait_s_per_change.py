"""settle_wait_s_per_change: the seconds items stayed parked in the
pending-settle table, park to leaving it as ready, failed or expired
(``agac_pending_settle_wait_seconds``), over the measured span, per
change; 0.0 where nothing parked."""

from perfbench.walltime import seconds_per_change


def read(run):
    return seconds_per_change(run, "agac_pending_settle_wait_seconds")
