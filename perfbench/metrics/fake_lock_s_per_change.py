"""fake_lock_s_per_change: the seconds the replicas waited for and held
the durable fake account's interprocess lock
(``agac_fake_aws_lock_seconds``, both phases), summed over the
replicas, over the measured span, per change: what the stand-in for
AWS adds to its calls beyond their latency."""

from perfbench.walltime import seconds_per_change


def read(run):
    return seconds_per_change(run, "agac_fake_aws_lock_seconds")
