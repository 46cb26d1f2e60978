"""aws_calls_per_change.sharded: the AWS calls the replicas' drivers
count (``agac_aws_api_calls_total``, summed over replicas) over the
measured span, per change.  The program's own count: the deployment of
processes has no benchmark-owned AWS to count at."""

from perfbench.exposition import delta


def read(run):
    if run.end.get("aws_calls") is not None:
        return None  # an in-process cell counts at its own proxy
    calls = delta(run, "agac_aws_api_calls_total")
    if calls is None or not run.changes:
        return None
    return calls / run.changes
