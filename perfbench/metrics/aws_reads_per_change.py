"""aws_reads_per_change: the shaping proxy's count of the read plane's
calls (Global Accelerator reads, ELBv2 and Route53) over the measured
span, per change."""

from perfbench.world.shaping import OP_FAMILY


def read(run):
    start, end = run.start.get("aws_calls"), run.end.get("aws_calls")
    if end is None or not run.changes:
        return None
    ops = [op for op in end if OP_FAMILY.get(op) in ("ga_read", "elbv2", "route53")]
    return sum(end[op] - start.get(op, 0) for op in ops) / run.changes
