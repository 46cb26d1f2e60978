"""The host side of a traced run's breakdown: where the time went while
the card sat idle."""

from __future__ import annotations

from perfbench.exposition import by_label


def idle_gaps(start: dict, end: dict, top: int = 10) -> list[list]:
    """The stages that took most controller CPU over the measured span
    (``cpu:<stage>``, from the stage accountant) and, where the world
    shapes AWS, the operations that took most shaped wall time
    (``aws:<op>``, from the benchmark's proxy): seconds each."""
    name = "agac_profile_stage_cpu_seconds_sum"
    before = by_label(start["expositions"], name, "stage")
    after = by_label(end["expositions"], name, "stage")
    stages = sorted(((s, v - before.get(s, 0.0)) for s, v in after.items()), key=lambda kv: -kv[1])
    shaped = end.get("aws_shaped_s")
    if shaped is None:
        return [[f"cpu:{s}", v] for s, v in stages[:top]]
    was = start.get("aws_shaped_s", {})
    ops = sorted(((op, v - was.get(op, 0.0)) for op, v in shaped.items()), key=lambda kv: -kv[1])
    half = top // 2
    return [[f"cpu:{s}", v] for s, v in stages[:half]] + [[f"aws:{op}", v] for op, v in ops[:top - half]]
