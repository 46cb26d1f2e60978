"""Sums over Prometheus text expositions, for the per-layer readers.

The benchmark's own parser: a sample line is ``name{labels} value``."""

from __future__ import annotations


def samples(text: str) -> list[tuple[str, str, float]]:
    """(metric name, label text, value) for every sample line."""
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        head, _, value = line.rpartition(" ")
        name, _, labels = head.partition("{")
        out.append((name, labels.rstrip("}"), float(value)))
    return out


def total(texts: list[str], name: str, where: str = "") -> float | None:
    """The sum of sample ``name`` over every exposition in ``texts``
    whose labels contain ``where``; None when no exposition has it."""
    found, value = False, 0.0
    for text in texts:
        for sample, labels, v in samples(text):
            if sample == name and where in labels:
                found, value = True, value + v
    return value if found else None


def delta(run, name: str, where: str = "") -> float | None:
    """``total`` at the end of the measured span minus at its start."""
    end = total(run.end["expositions"], name, where)
    start = total(run.start["expositions"], name, where)
    if end is None:
        return None
    return end - (start or 0.0)


def by_label(texts: list[str], name: str, label: str) -> dict[str, float]:
    """The sum of sample ``name`` by the value of ``label``."""
    out: dict[str, float] = {}
    for text in texts:
        for sample, labels, v in samples(text):
            if sample != name:
                continue
            for part in labels.split(","):
                key, _, value = part.partition("=")
                if key == label:
                    out[value.strip('"')] = out.get(value.strip('"'), 0.0) + v
    return out
