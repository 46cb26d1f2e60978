"""aws_calls_per_change: every AWS call the benchmark's shaping proxy
counted from the window's start to the end of the shaped drain, over the
changes due in the window."""


def read(run):
    start, end = run.start.get("aws_calls"), run.end.get("aws_calls")
    if end is None or not run.changes:
        return None
    return (sum(end.values()) - sum(start.values())) / run.changes
