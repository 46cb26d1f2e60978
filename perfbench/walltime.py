"""Per-change seconds of the program's wall-time histograms, for the
per-layer readers of the port's waits (read plane, settle table, wire,
the durable fake's lock)."""

from __future__ import annotations

from perfbench.exposition import delta


def seconds_per_change(run, family: str, where: str = "") -> float | None:
    """The ``_sum`` of histogram ``family`` over the measured span (the
    series whose labels contain ``where``, summed over every
    exposition), per change: 0.0 where the family has no sample yet;
    None where no exposition declares the family (a program without
    the instrument) or the window had no change."""
    if not run.changes or not any(f"# TYPE {family} " in text for text in run.end["expositions"]):
        return None
    return (delta(run, f"{family}_sum", where) or 0.0) / run.changes
