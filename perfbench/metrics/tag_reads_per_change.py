"""tag_reads_per_change: the replicas' ``ListTagsForResource`` calls
(``agac_aws_api_calls_total``, summed over replicas) over the measured
span, per change.  Each discovery snapshot reload (every 30 s, the
discovery cache's TTL) reads the tags of every accelerator the replica
has not seen, those the other replicas created among them; every worker
that needs discovery waits for it."""

from perfbench.exposition import delta


def read(run):
    if run.end.get("aws_calls") is not None:
        return None  # an in-process cell counts at its own proxy
    if not run.changes:
        return None
    # no sample yet: no replica has read a tag since it started
    return (delta(run, "agac_aws_api_calls_total", 'op="list_tags_for_resource"') or 0.0) / run.changes
