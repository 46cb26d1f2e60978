"""Whole-program analysis engine.

The per-file linter sees one module at a time; the invariants the multi-core
worker runtime needs (lock ordering, shared-state confinement,
determinism) only mean something over the WHOLE program.  This module
is the shared core the program-wide analyses are built on:

- ``ParseCache`` — every module is read and ``ast.parse``d exactly
  once per content hash, in parallel across a thread pool.  The legacy
  per-file linter (``lint.py``) and every program analysis share one
  cache, so the per-file lint and the program analyses never
  re-parse a file (the single-parse invariant is pinned in tests).
- ``Program`` — the whole-program view: per-module symbol tables,
  import provenance (``ImportMap``: local name → dotted origin), and
  an approximate call graph (name/method resolution, deliberately
  over-approximate where the receiver is dynamic) with memoized
  transitive-callee queries.
- ``ProgramRule`` — the registry API for program-wide analyses,
  alongside the per-file ``Rule`` API in ``rules.py``.  Analyses yield
  ``Finding``s with STABLE keys (no line numbers) so a committed
  baseline survives unrelated edits.
- ``Baseline`` — grandfathers pre-existing findings with per-finding
  reasons; the gate fails only on NEW findings, and a baseline entry
  whose code no longer exists is itself a failure (stale entries rot).

The CLI (``python -m agac_tpu_torch.analysis.program``) runs the registered
analyses (``lockorder``/``census``/``determinism``), writes the
machine-readable ``analysis_report.json``, applies the baseline, and
exits non-zero on regressions.  Stdlib-only by design, like the rest of
``agac_tpu_torch.analysis``.
"""

from __future__ import annotations

import argparse
import ast
import hashlib
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterable, Iterator, Optional


# ---------------------------------------------------------------------------
# parse cache — one ast.parse per (path, content-hash), parallel fill
# ---------------------------------------------------------------------------


@dataclass
class ParsedModule:
    path: Path
    source: str
    source_lines: list[str]
    tree: ast.Module
    sha: str


class ParseCache:
    """Content-hash-keyed AST cache.  ``parse_counts`` records how many
    times each path actually hit ``ast.parse`` — the single-parse-per-
    file invariant the lint's wall time rests on."""

    def __init__(self):
        self._cache: dict[tuple[str, str], ParsedModule] = {}
        self._latest: dict[str, ParsedModule] = {}
        self.parse_counts: dict[str, int] = {}

    def parse(self, path: Path, source: Optional[str] = None) -> ParsedModule:
        if source is None:
            source = path.read_text()
        sha = hashlib.sha256(source.encode()).hexdigest()
        key = (str(path), sha)
        cached = self._cache.get(key)
        if cached is not None:
            self._latest[str(path)] = cached
            return cached
        self.parse_counts[str(path)] = self.parse_counts.get(str(path), 0) + 1
        tree = ast.parse(source, filename=str(path))
        parsed = ParsedModule(path, source, source.splitlines(), tree, sha)
        self._cache[key] = parsed
        self._latest[str(path)] = parsed
        return parsed

    def latest(self, path: Path) -> Optional[ParsedModule]:
        """Most recent parse for ``path``, sparing a re-read when the
        caller already warmed the cache via ``parse_many``."""
        return self._latest.get(str(path))

    def parse_many(
        self, paths: Iterable[Path], jobs: Optional[int] = None
    ) -> list[ParsedModule]:
        """Parse every path (cached), fanning reads+parses across a
        thread pool.  Syntax errors propagate from the failing path."""
        paths = list(paths)
        if jobs is None:
            jobs = min(8, max(1, len(paths)))
        if jobs <= 1 or len(paths) <= 1:
            return [self.parse(p) for p in paths]
        with ThreadPoolExecutor(max_workers=jobs) as pool:
            return list(pool.map(self.parse, paths))


_shared_cache = ParseCache()


def shared_cache() -> ParseCache:
    """The process-wide cache lint.py and the program analyses share."""
    return _shared_cache


# ---------------------------------------------------------------------------
# import provenance — the ONE import tracker every rule/analysis uses
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ImportBinding:
    local: str       # the name usable in this module
    module: str      # source module text as written ('' for bare import)
    attr: Optional[str]  # from-imported attr, None for plain `import x`
    level: int       # relative-import level (0 = absolute)

    @property
    def origin(self) -> str:
        """Dotted origin, leading relative dots stripped: `from
        .metrics import Counter` → ``metrics.Counter``."""
        if self.attr is None:
            return self.module
        return f"{self.module}.{self.attr}" if self.module else self.attr


class ImportMap:
    """Local name → import origin for one module.  This replaces the
    per-rule import walkers the early rules each grew (the shared
    provenance infra)."""

    def __init__(self, tree: ast.Module):
        self.bindings: dict[str, ImportBinding] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    # `import a.b` binds `a`; `import a.b as c` binds c→a.b
                    module = alias.name if alias.asname else alias.name.split(".")[0]
                    self.bindings[local] = ImportBinding(local, module, None, 0)
            elif isinstance(node, ast.ImportFrom):
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    self.bindings[local] = ImportBinding(
                        local, node.module or "", alias.name, node.level
                    )

    def resolve(self, name: str) -> Optional[str]:
        """Dotted origin of a local name, or None if not import-bound."""
        binding = self.bindings.get(name)
        return binding.origin if binding else None

    def resolves_to(self, name: str, *suffixes: str) -> bool:
        """True when ``name`` is import-bound and its origin ends with
        any of the dotted suffixes (suffix match covers both absolute
        and relative spellings of the same module)."""
        origin = self.resolve(name)
        if origin is None:
            return False
        return any(
            origin == suffix or origin.endswith("." + suffix) for suffix in suffixes
        )

    def resolve_call_target(self, func: ast.expr) -> Optional[str]:
        """Dotted origin of a call target expression: ``Name`` resolves
        directly; ``Attribute`` chains resolve their base then append
        the attribute path (``m.Counter`` → ``…metrics.Counter``)."""
        parts: list[str] = []
        node = func
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        base = self.resolve(node.id)
        if base is None:
            return None
        return ".".join([base, *reversed(parts)]) if parts else base


# ---------------------------------------------------------------------------
# symbol table + call graph
# ---------------------------------------------------------------------------


@dataclass
class FunctionInfo:
    fqn: str                      # "<modname>::<Class.>fn"
    local_qual: str               # "<Class.>fn" (nesting flattened with .)
    name: str
    node: ast.FunctionDef | ast.AsyncFunctionDef
    module: "ModuleInfo"
    class_name: Optional[str] = None


@dataclass
class ClassInfo:
    name: str
    node: ast.ClassDef
    module: "ModuleInfo"
    methods: dict[str, FunctionInfo] = field(default_factory=dict)


@dataclass
class ModuleInfo:
    modname: str
    parsed: ParsedModule
    imports: ImportMap
    functions: dict[str, FunctionInfo] = field(default_factory=dict)
    classes: dict[str, ClassInfo] = field(default_factory=dict)

    @property
    def path(self) -> Path:
        return self.parsed.path

    @property
    def tree(self) -> ast.Module:
        return self.parsed.tree


def iter_python_files(targets: Iterable[Path]) -> Iterator[Path]:
    for target in targets:
        if target.is_file() and target.suffix == ".py":
            yield target
        elif target.is_dir():
            for path in sorted(target.rglob("*.py")):
                # hidden and cache directories below the target only: a
                # target inside a hidden directory (a checkout under
                # ``.cache/``) still has every module analysed
                if any(
                    part.startswith(".") or part == "__pycache__"
                    for part in path.relative_to(target).parts
                ):
                    continue
                yield path


# The package roots whose files the path-scoped rules and analyses
# treat as the controller's own code: this package's and that of the
# package it ports, so that a scope such as ``sim/`` or
# ``clockseam.py`` gives the same answer on either tree.
PACKAGE_ROOTS = ("agac_tpu", "agac_tpu_torch")


def package_paths(path: str | Path) -> list[str]:
    """``path`` below each package root among its parts, as posix
    strings: ``…/agac_tpu_torch/sim/runtime.py`` gives
    ``["sim/runtime.py"]``, a path outside every root ``[]``."""
    parts = Path(str(path).replace("\\", "/")).parts
    return [
        "/".join(parts[i + 1:])
        for i, part in enumerate(parts[:-1])
        if part in PACKAGE_ROOTS
    ]


def in_package(path: str | Path, prefixes: tuple[str, ...]) -> bool:
    """True when ``path`` lies below a package root at one of the
    root-relative ``prefixes`` (``"sim/"``, ``"clockseam.py"``)."""
    return any(rel.startswith(prefixes) for rel in package_paths(path))


def _modname_for(path: Path, target: Path) -> str:
    """Dotted module name relative to the target's parent: target dir
    ``agac_tpu_torch`` yields ``agac_tpu_torch.x.y`` names."""
    root = target.parent if target.is_dir() else target.parent
    rel = path.resolve().relative_to(root.resolve())
    parts = list(rel.parts)
    parts[-1] = parts[-1][: -len(".py")]
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts) if parts else path.stem


class Program:
    """The whole-program view: every module parsed once, symbols and
    import provenance indexed, and an approximate call graph."""

    def __init__(self, cache: Optional[ParseCache] = None):
        self.cache = cache or ParseCache()
        self.modules: dict[str, ModuleInfo] = {}
        self.functions: dict[str, FunctionInfo] = {}
        # method/function name -> fqns defining it (the over-approximate
        # fallback when a receiver is dynamic)
        self.by_name: dict[str, list[str]] = {}
        self._callees: dict[tuple[str, bool], frozenset[str]] = {}

    # ---- construction --------------------------------------------------
    @classmethod
    def build(
        cls,
        targets: Iterable[Path],
        cache: Optional[ParseCache] = None,
        jobs: Optional[int] = None,
    ) -> "Program":
        program = cls(cache)
        targets = [Path(t) for t in targets]
        path_names: dict[Path, str] = {}
        for target in targets:
            for path in iter_python_files([target]):
                path_names.setdefault(path, _modname_for(path, target))
        parsed = program.cache.parse_many(path_names, jobs=jobs)
        for parsed_module in parsed:
            program._index_module(
                path_names[parsed_module.path], parsed_module
            )
        return program

    def _index_module(self, modname: str, parsed: ParsedModule) -> None:
        minfo = ModuleInfo(modname, parsed, ImportMap(parsed.tree))
        self.modules[modname] = minfo

        def index_body(body, prefix: str, class_name: Optional[str], cinfo):
            for node in body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    local_qual = f"{prefix}{node.name}"
                    finfo = FunctionInfo(
                        f"{modname}::{local_qual}",
                        local_qual,
                        node.name,
                        node,
                        minfo,
                        class_name,
                    )
                    minfo.functions[local_qual] = finfo
                    self.functions[finfo.fqn] = finfo
                    self.by_name.setdefault(node.name, []).append(finfo.fqn)
                    if cinfo is not None:
                        cinfo.methods[node.name] = finfo
                    # nested defs (closures, thread bodies) are their
                    # own functions; calls inside belong to them
                    index_body(node.body, f"{local_qual}.", class_name, None)
                elif isinstance(node, ast.ClassDef):
                    new_cinfo = ClassInfo(node.name, node, minfo)
                    minfo.classes[node.name] = new_cinfo
                    index_body(node.body, f"{node.name}.", node.name, new_cinfo)

        index_body(parsed.tree.body, "", None, None)

    # ---- call resolution ----------------------------------------------
    # names so ubiquitous that a by-name fallback match would wire most
    # of the program together and drown every path-sensitive analysis
    _FALLBACK_CAP = 12
    # collection- and io-protocol names: `d.get()` / `s.add()` on a
    # plain dict or set — or `f.write()` / `f.flush()` / `f.close()`
    # on a file handle — would otherwise fallback-match every program
    # method of the same name, wiring unrelated lock scopes together
    # (the incident capture's `self._file.flush()` under its ring lock
    # must not resolve to EventRecorder.flush)
    _FALLBACK_DENY = frozenset(
        {
            "get", "add", "pop", "update", "clear", "append", "remove",
            "discard", "extend", "insert", "setdefault", "popitem",
            "keys", "values", "items", "copy", "sort", "index", "count",
            "put", "write", "flush", "close",
        }
    )

    def resolve_call(
        self, caller: FunctionInfo, call: ast.Call, fallback: bool = True
    ) -> frozenset[str]:
        """Approximate callee set for one call site.  Resolution order:
        local/module symbol → import provenance → same-class method →
        program-wide method-name match (over-approximate, capped).
        ``fallback=False`` skips the last step — precise-only edges for
        analyses (the census) where a false connection is worse than a
        missed one."""
        minfo = caller.module
        func = call.func
        if isinstance(func, ast.Name):
            # closure call: a def nested in this function or an
            # enclosing one, then module-level functions
            scope = caller.local_qual
            while scope:
                nested = minfo.functions.get(f"{scope}.{func.id}")
                if nested is not None:
                    return frozenset({nested.fqn})
                scope = scope.rpartition(".")[0]
            local = minfo.functions.get(func.id)
            if local is not None:
                return frozenset({local.fqn})
            cinfo = minfo.classes.get(func.id)
            if cinfo is not None:
                init = cinfo.methods.get("__init__")
                return frozenset({init.fqn} if init else ())
            origin = minfo.imports.resolve(func.id)
            if origin is not None:
                return self._resolve_origin(origin)
            return frozenset()
        if isinstance(func, ast.Attribute):
            # self.meth() — same-class first
            if (
                isinstance(func.value, ast.Name)
                and func.value.id in ("self", "cls")
                and caller.class_name is not None
            ):
                cinfo = minfo.classes.get(caller.class_name)
                if cinfo is not None and func.attr in cinfo.methods:
                    return frozenset({cinfo.methods[func.attr].fqn})
            origin = minfo.imports.resolve_call_target(func)
            if origin is not None:
                # the receiver import-resolves; if it's not a program
                # symbol it's an external call (subprocess.run, …) and
                # MUST NOT fall back by name onto program methods
                return self._resolve_origin(origin)
            # dynamic receiver: every program function of that name,
            # capped so `get`-tier names don't wire the world together
            if fallback and func.attr not in self._FALLBACK_DENY:
                candidates = self.by_name.get(func.attr, [])
                if 0 < len(candidates) <= self._FALLBACK_CAP:
                    return frozenset(candidates)
        return frozenset()

    def _resolve_origin(self, origin: str) -> frozenset[str]:
        """Map a dotted import origin to program functions: an exact
        module::fn match, a class constructor, or (for relative
        imports) a suffix match on the module path."""
        module_path, _, leaf = origin.rpartition(".")
        for modname, minfo in self.modules.items():
            if not (
                modname == module_path
                or modname.endswith("." + module_path)
                or module_path == ""
            ):
                continue
            target = minfo.functions.get(leaf)
            if target is not None:
                return frozenset({target.fqn})
            cinfo = minfo.classes.get(leaf)
            if cinfo is not None:
                init = cinfo.methods.get("__init__")
                return frozenset({init.fqn} if init else ())
        return frozenset()

    def direct_callees(self, fqn: str, fallback: bool = True) -> frozenset[str]:
        key = (fqn, fallback)
        cached = self._callees.get(key)
        if cached is not None:
            return cached
        finfo = self.functions.get(fqn)
        if finfo is None:
            self._callees[key] = frozenset()
            return self._callees[key]
        out: set[str] = set()
        for node in walk_function(finfo.node):
            if isinstance(node, ast.Call):
                out |= self.resolve_call(finfo, node, fallback=fallback)
        self._callees[key] = frozenset(out)
        return self._callees[key]

    def transitive_callees(self, fqn: str, fallback: bool = True) -> frozenset[str]:
        seen: set[str] = set()
        stack = [fqn]
        while stack:
            current = stack.pop()
            for callee in self.direct_callees(current, fallback=fallback):
                if callee not in seen:
                    seen.add(callee)
                    stack.append(callee)
        return frozenset(seen)


def walk_function(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> Iterator[ast.AST]:
    """ast.walk over a function body WITHOUT descending into nested
    function/class definitions — their statements belong to the nested
    symbol, not this one."""
    stack: list[ast.AST] = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


# ---------------------------------------------------------------------------
# ProgramRule registry + findings
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Finding:
    """One program-analysis result.  ``key`` is the STABLE identity the
    baseline matches on — derived from symbols, never line numbers, so
    unrelated edits don't churn the baseline."""

    analysis: str
    rule: str
    path: str
    line: int
    key: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_json(self) -> dict:
        return {
            "analysis": self.analysis,
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "key": self.key,
            "message": self.message,
        }


@dataclass(frozen=True)
class ProgramRule:
    id: str
    summary: str
    check: Callable[[Program], "object"]  # -> (findings, report_block)


PROGRAM_RULES: list[ProgramRule] = []


def program_rule(id: str, summary: str):
    def register(fn):
        PROGRAM_RULES.append(ProgramRule(id, summary, fn))
        return fn

    return register


# ---------------------------------------------------------------------------
# baseline — grandfather existing findings, flag stale entries
# ---------------------------------------------------------------------------


class Baseline:
    """``{"findings": [{"key": ..., "reason": ...}, ...]}``.  Every
    entry carries a mandatory reason; applying the baseline partitions
    current findings into new vs grandfathered and reports entries that
    match nothing (dead code must shed its baseline line)."""

    def __init__(self, entries: Optional[dict[str, str]] = None):
        self.entries: dict[str, str] = dict(entries or {})

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        if not path.exists():
            return cls()
        data = json.loads(path.read_text())
        entries: dict[str, str] = {}
        for item in data.get("findings", []):
            key, reason = item.get("key"), item.get("reason", "")
            if not key or not reason.strip():
                raise ValueError(
                    f"baseline entry {item!r} must carry both a key and a "
                    "non-empty reason"
                )
            entries[key] = reason
        return cls(entries)

    def save(self, path: Path) -> None:
        payload = {
            "findings": [
                {"key": key, "reason": reason}
                for key, reason in sorted(self.entries.items())
            ]
        }
        path.write_text(json.dumps(payload, indent=2) + "\n")

    def apply(
        self, findings: list[Finding]
    ) -> tuple[list[Finding], list[Finding], list[str]]:
        """(new, grandfathered, stale_keys)."""
        current = {f.key for f in findings}
        new = [f for f in findings if f.key not in self.entries]
        old = [f for f in findings if f.key in self.entries]
        stale = sorted(k for k in self.entries if k not in current)
        return new, old, stale


# ---------------------------------------------------------------------------
# report + gate
# ---------------------------------------------------------------------------

REPORT_SCHEMA_VERSION = 2


def run_analyses(
    program: Program, rules: Optional[list[ProgramRule]] = None
) -> tuple[list[Finding], dict]:
    """Run every registered ProgramRule; returns (all findings, the
    per-analysis report blocks keyed by rule id)."""
    findings: list[Finding] = []
    blocks: dict[str, dict] = {}
    for rule in PROGRAM_RULES if rules is None else rules:
        rule_findings, block = rule.check(program)
        findings.extend(rule_findings)
        blocks[rule.id] = block
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.key))
    return findings, blocks


def build_report(
    program: Program,
    findings: list[Finding],
    blocks: dict[str, dict],
    baseline: Baseline,
) -> dict:
    new, grandfathered, stale = baseline.apply(findings)
    unsafe = [
        entry
        for entry in blocks.get("census", {}).get("census", [])
        if entry.get("bucket") == "UNSAFE"
    ]
    # an unportable verdict on a roadmap-marked multi-core candidate
    # stage gates exactly like an UNSAFE census entry: no baseline path
    confinement_block = blocks.get("confinement", {})
    unportable = [
        {"stage": name, **info}
        for name, info in sorted(confinement_block.get("stages", {}).items())
        if info.get("verdict") == "unportable"
        and name in confinement_block.get("multi_core_candidates", [])
    ]
    return {
        "schema": REPORT_SCHEMA_VERSION,
        "generated_by": "agac_tpu_torch.analysis.program",
        "modules": len(program.modules),
        "parse": {
            "files": len(program.modules),
            "parses": sum(program.cache.parse_counts.values()),
            # the single-parse invariant, inline: every path parsed more
            # than once (a double-parse regression) is named
            "reparsed": sorted(
                path
                for path, count in program.cache.parse_counts.items()
                if count > 1
            ),
        },
        "analyses": blocks,
        "findings": [f.to_json() for f in findings],
        "baseline": {
            "entries": len(baseline.entries),
            "grandfathered": [f.key for f in grandfathered],
            "stale": stale,
        },
        "gate": {
            "new_findings": [f.to_json() for f in new],
            "unsafe_census": unsafe,
            "unportable_stages": unportable,
            "stale_baseline": stale,
            "clean": not new and not unsafe and not unportable and not stale,
        },
    }


def gate_failures(report: dict) -> list[str]:
    """Human-readable gate failures; empty means the gate is green."""
    failures: list[str] = []
    gate = report["gate"]
    for item in gate["new_findings"]:
        failures.append(
            f"{item['path']}:{item['line']}: [{item['rule']}] "
            f"{item['message']} (key: {item['key']})"
        )
    for entry in gate["unsafe_census"]:
        failures.append(
            f"{entry['path']}:{entry['line']}: [census] {entry['name']} is "
            "UNSAFE — guard it with a lock, gate it behind a seam, or "
            "suppress inline with "
            "`# agac-lint: ignore[shared-state-census] -- reason`"
        )
    for entry in gate.get("unportable_stages", []):
        failures.append(
            f"[confinement] multi-core candidate stage {entry['stage']!r} is "
            f"unportable: {entry['why']} — apply the discipline playbook "
            "(lock-guard, seam-gate, or confine; docs/development.md)"
        )
    for key in gate["stale_baseline"]:
        failures.append(
            f"baseline entry {key!r} matches no current finding — the code "
            "it grandfathered is gone; remove the entry"
        )
    return failures


# ---------------------------------------------------------------------------
# CLI — `python -m agac_tpu_torch.analysis.program`
# ---------------------------------------------------------------------------


def _load_analyses() -> list[ProgramRule]:
    """Import the analysis modules so their @program_rule registrations
    land; deferred so `import program` alone stays cycle-free.  Returns
    the CANONICAL registry: under ``python -m`` this file runs as
    ``__main__`` while the analyses register into the
    ``agac_tpu_torch.analysis.program`` import of it — two distinct module
    objects, two ``PROGRAM_RULES`` lists."""
    from agac_tpu_torch.analysis import (  # noqa: F401
        census,
        confinement,
        determinism,
        lockorder,
    )
    from agac_tpu_torch.analysis import program as canonical

    return canonical.PROGRAM_RULES


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="agac-program", description="whole-program invariant analyses"
    )
    parser.add_argument("targets", nargs="+", help="package dirs / files")
    parser.add_argument(
        "--report", type=Path, default=Path("analysis_report.json"),
        help="where to write the machine-readable report",
    )
    parser.add_argument(
        "--baseline", type=Path, default=None,
        help="baseline JSON grandfathering existing findings",
    )
    parser.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite the baseline to cover every current finding "
        "(reasons for new entries must then be filled in by hand)",
    )
    parser.add_argument("--jobs", type=int, default=None, help="parallel parse width")
    args = parser.parse_args(argv)

    rules = _load_analyses()
    program = Program.build(
        [Path(t) for t in args.targets], cache=shared_cache(), jobs=args.jobs
    )
    findings, blocks = run_analyses(program, rules)
    baseline = Baseline.load(args.baseline) if args.baseline else Baseline()
    if args.update_baseline and args.baseline:
        for f in findings:
            baseline.entries.setdefault(f.key, "TODO: justify this entry")
        baseline.entries = {
            k: v for k, v in baseline.entries.items()
            if k in {f.key for f in findings}
        }
        baseline.save(args.baseline)
    report = build_report(program, findings, blocks, baseline)
    args.report.write_text(json.dumps(report, indent=2, sort_keys=True) + "\n")
    failures = gate_failures(report)
    for line in failures:
        print(line)
    if failures:
        print(
            f"\n{len(failures)} program-analysis gate failure(s); report "
            f"written to {args.report}",
            file=sys.stderr,
        )
        return 1
    print(
        f"program analyses clean over {len(program.modules)} modules "
        f"({len(findings)} finding(s), all grandfathered); report: {args.report}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
