"""Invariant linter CLI/driver: ``python -m agac_tpu_torch.analysis.lint``.

Walks the given files/packages, runs every registered rule
(``rules.RULES``) over each module's AST, honors inline suppressions,
and exits non-zero on any violation.  Stdlib-only by design — the CI
``invariants`` job runs it on a bare checkout.

Usage::

    python -m agac_tpu_torch.analysis.lint agac_tpu_torch

The CI-installed dependency set (for ``unguarded-optional-import``) is
parsed from ``pip install`` lines across ``.github/workflows/*.yml``
of the repo containing the first lint target; pass ``--workflows-dir``
to point elsewhere, or ``--installed name,name`` to pin the set.
"""

from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path
from typing import Iterable, Optional

from .program import ParseCache, ParsedModule, iter_python_files, shared_cache
from .rules import RULES, LintContext, Violation, apply_suppressions

# pip "project name" -> import name, for the handful of deps whose
# names differ; everything else maps to itself (lowercased, - -> _)
_PIP_IMPORT_NAMES = {
    "pyyaml": "yaml",
    "pillow": "PIL",
    "beautifulsoup4": "bs4",
}

_PIP_LINE_RE = re.compile(r"pip3?\s+install\s+(.+)$")


def parse_ci_installed(workflows_dir: Path) -> frozenset[str]:
    """Import names installed by any `pip install` line in any workflow."""
    installed: set[str] = set()
    if not workflows_dir.is_dir():
        return frozenset()
    for wf in sorted(workflows_dir.glob("*.yml")) + sorted(workflows_dir.glob("*.yaml")):
        for line in wf.read_text().splitlines():
            m = _PIP_LINE_RE.search(line)
            if not m:
                continue
            for token in m.group(1).split():
                if token.startswith("-"):
                    continue  # flags (-e, --upgrade, -r ...)
                # strip extras and version specifiers: pkg[x]>=1.2
                name = re.split(r"[\[<>=!~;]", token, 1)[0].strip()
                if not name:
                    continue
                key = name.lower()
                installed.add(_PIP_IMPORT_NAMES.get(key, key.replace("-", "_")))
    return frozenset(installed)


def lint_source(
    source: str,
    path: Path,
    ci_installed: frozenset[str],
    first_party: Optional[frozenset[str]] = None,
    cache: Optional[ParseCache] = None,
) -> list[Violation]:
    cache = shared_cache() if cache is None else cache
    try:
        parsed = cache.parse(path, source)
    except SyntaxError as err:
        return [
            Violation("syntax-error", str(path), err.lineno or 1, str(err.msg))
        ]
    return lint_parsed(parsed, ci_installed, first_party)


def lint_parsed(
    parsed: ParsedModule,
    ci_installed: frozenset[str],
    first_party: Optional[frozenset[str]] = None,
) -> list[Violation]:
    """Run every rule over an already-parsed module.  The context
    carries the tree, a lazily materialized node list, and the shared
    import-provenance map — rules no longer re-walk independently."""
    ctx = LintContext(
        path=parsed.path,
        source_lines=parsed.source_lines,
        ci_installed=ci_installed,
        tree=parsed.tree,
    )
    if first_party is not None:
        ctx.first_party = first_party
    violations: list[Violation] = []
    for rule in RULES:
        violations.extend(rule.check(parsed.tree, ctx))
    kept, suppression_errors = apply_suppressions(violations, ctx)
    return sorted(
        kept + suppression_errors, key=lambda v: (v.path, v.line, v.rule)
    )


def lint_paths(
    targets: Iterable[Path],
    workflows_dir: Optional[Path] = None,
    ci_installed: Optional[frozenset[str]] = None,
    cache: Optional[ParseCache] = None,
    jobs: Optional[int] = None,
) -> list[Violation]:
    targets = [Path(t) for t in targets]
    if ci_installed is None:
        if workflows_dir is None:
            root = _find_repo_root(targets)
            workflows_dir = root / ".github" / "workflows"
        ci_installed = parse_ci_installed(workflows_dir)
    cache = shared_cache() if cache is None else cache
    paths = list(iter_python_files(targets))
    try:
        # parallel read+parse into the cache shared with the program
        # analyses: one ast.parse per file across BOTH runners
        cache.parse_many(paths, jobs=jobs)
    except SyntaxError:
        pass  # surfaced per-file below as a syntax-error violation
    violations: list[Violation] = []
    for path in paths:
        parsed = cache.latest(path)
        if parsed is None:
            try:
                parsed = cache.parse(path)
            except SyntaxError as err:
                violations.append(
                    Violation("syntax-error", str(path), err.lineno or 1, str(err.msg))
                )
                continue
        violations.extend(lint_parsed(parsed, ci_installed))
    return violations


def _find_repo_root(targets: list[Path]) -> Path:
    probe = (targets[0] if targets else Path.cwd()).resolve()
    if probe.is_file():
        probe = probe.parent
    for candidate in (probe, *probe.parents):
        if (candidate / ".github").is_dir() or (candidate / ".git").exists():
            return candidate
    return Path.cwd()


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="agac-lint", description="controller invariant linter"
    )
    parser.add_argument("targets", nargs="*", help="files or package dirs")
    parser.add_argument(
        "--workflows-dir",
        type=Path,
        default=None,
        help="where to read CI pip-install lines from",
    )
    parser.add_argument(
        "--installed",
        default=None,
        help="comma-separated import names to treat as CI-installed "
        "(overrides workflow parsing)",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the rule registry and exit"
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in RULES:
            print(f"{rule.id}: {rule.summary}")
        return 0
    if not args.targets:
        parser.error("the following arguments are required: targets")

    ci_installed = (
        frozenset(n.strip() for n in args.installed.split(",") if n.strip())
        if args.installed is not None
        else None
    )
    violations = lint_paths(
        [Path(t) for t in args.targets],
        workflows_dir=args.workflows_dir,
        ci_installed=ci_installed,
    )
    for violation in violations:
        print(violation.render())
    if violations:
        print(
            f"\n{len(violations)} invariant violation(s); suppress a "
            "justified exception with `# agac-lint: ignore[rule] -- reason`",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
