"""Metric-catalog generator: ``python -m agac_tpu_torch.observability.catalog``.

Regenerates the metric table in docs/operations.md (between the
``<!-- metrics-catalog:begin -->`` / ``end`` markers) from the live
registry: ``instruments.register_all()`` on a fresh registry yields
every metric the code can emit, so the documented catalog structurally
cannot drift from the instrumented code.  ``--check`` exits non-zero
when the committed doc differs from the regenerated one — the CI
invariants job runs it, ``make metrics-catalog`` rewrites.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .instruments import register_all
from .metrics import MetricsRegistry

BEGIN = "<!-- metrics-catalog:begin (generated by `make metrics-catalog`; do not edit by hand) -->"
END = "<!-- metrics-catalog:end -->"


def render_table() -> str:
    reg = register_all(MetricsRegistry())
    lines = [
        "| Metric | Type | Labels | Meaning |",
        "|---|---|---|---|",
    ]
    for desc in reg.describe():
        labels = ", ".join(f"`{l}`" for l in desc["labels"]) or "—"
        help_text = desc["help"].replace("|", "\\|").replace("\n", " ")
        lines.append(
            f"| `{desc['name']}` | {desc['type']} | {labels} | {help_text} |"
        )
    return "\n".join(lines)


def rewrite(doc_path: Path) -> tuple[str, str]:
    """(old_text, new_text) with the marker block regenerated."""
    text = doc_path.read_text()
    begin = text.find(BEGIN)
    end = text.find(END)
    if begin < 0 or end < 0 or end < begin:
        raise SystemExit(
            f"{doc_path}: catalog markers not found — the doc must contain "
            f"{BEGIN!r} and {END!r}"
        )
    new = text[: begin + len(BEGIN)] + "\n" + render_table() + "\n" + text[end:]
    return text, new


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="metrics-catalog",
        description="regenerate the docs metric catalog from the registry",
    )
    parser.add_argument(
        "doc", nargs="?", default="docs/operations.md",
        help="markdown file carrying the catalog markers",
    )
    parser.add_argument(
        "--check", action="store_true",
        help="exit 1 if the committed catalog differs from the regenerated one",
    )
    args = parser.parse_args(argv)
    doc_path = Path(args.doc)
    old, new = rewrite(doc_path)
    if args.check:
        if old != new:
            print(
                f"{doc_path}: metric catalog is stale — run `make metrics-catalog`",
                file=sys.stderr,
            )
            return 1
        print(f"{doc_path}: metric catalog is current")
        return 0
    if old != new:
        doc_path.write_text(new)
        print(f"{doc_path}: metric catalog regenerated")
    else:
        print(f"{doc_path}: metric catalog already current")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
