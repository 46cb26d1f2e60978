"""Static lock-order analysis (program analysis 1 of 4).

Discovers every ``threading.Lock/RLock/Condition`` and
``racecheck.make_lock/make_rlock`` construction site in the program,
attributes acquisitions (``with`` statements and bare ``.acquire()``
calls) to lock IDENTITIES (one ordering class per construction site:
``mod.Class.attr``), and builds the static acquisition graph by
propagating may-acquire sets through the approximate call graph: an
edge A→B means some path acquires B while holding A.  Findings:

- ``lock-order-inversion`` — both A→B and B→A exist statically: two
  code paths disagree on ordering, the classic deadlock shape;
- ``lock-order-cycle`` — a longer cycle (A→B→C→A) in the graph;
- ``bare-acquire`` — an ``.acquire()`` call on a known lock outside
  ``with`` and outside an adjacent try/finally release.

The static graph and the runtime ``racecheck`` watchdog validate each
other: ``unmatched_runtime_edges`` maps the watchdog's observed edges
(lock NAMES, e.g. ``workqueue.gagroup``) back onto static identities
via each ``make_lock`` site's name prefix, and reports any runtime
edge the static graph missed — armed in the chaos tier, so a call-
graph blind spot fails loudly instead of silently shrinking coverage.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Iterator, Optional

from .program import (
    Finding,
    FunctionInfo,
    ModuleInfo,
    Program,
    program_rule,
    walk_function,
)

ANALYSIS = "lock-order"

_THREADING_LOCKS = ("threading.Lock", "threading.RLock")
_THREADING_CONDITION = ("threading.Condition",)
_RACECHECK_FACTORIES = ("racecheck.make_lock", "racecheck.make_rlock")


@dataclass
class LockSite:
    identity: str          # "mod.Class.attr" | "mod.attr" | "mod.fn.name"
    attr: str              # terminal name the code acquires it through
    kind: str              # "Lock" | "RLock" | "Condition"
    path: str
    line: int
    module: str
    class_name: Optional[str]
    runtime_prefix: Optional[str] = None  # make_lock literal/f-string prefix

    def to_json(self) -> dict:
        return {
            "identity": self.identity,
            "attr": self.attr,
            "kind": self.kind,
            "path": self.path,
            "line": self.line,
            "runtime_prefix": self.runtime_prefix,
        }


def _suffix_match(origin: Optional[str], suffixes: tuple[str, ...]) -> bool:
    if origin is None:
        return False
    return any(
        origin == s or origin.endswith("." + s) for s in suffixes
    )


def _static_name_prefix(arg: ast.expr) -> Optional[str]:
    """The static prefix of a make_lock name argument: a literal is
    itself; an f-string contributes its leading constant."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    if isinstance(arg, ast.JoinedStr) and arg.values:
        first = arg.values[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            return first.value
    return None


def _terminal_attr(expr: ast.expr) -> Optional[str]:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


class LockIndex:
    """Every lock construction site in the program, with the lookup
    structure acquisition attribution runs against."""

    def __init__(self, program: Program):
        self.program = program
        self.sites: list[LockSite] = []
        # (module, class, attr) / (module, None, attr) -> site
        self._scoped: dict[tuple[str, Optional[str], str], LockSite] = {}
        # attr name -> sites (the unique-name fallback)
        self._by_attr: dict[str, list[LockSite]] = {}
        for minfo in program.modules.values():
            self._discover_module(minfo)

    # ---- discovery -----------------------------------------------------
    def _register(self, site: LockSite) -> None:
        self.sites.append(site)
        self._scoped[(site.module, site.class_name, site.attr)] = site
        self._by_attr.setdefault(site.attr, []).append(site)

    def _discover_module(self, minfo: ModuleInfo) -> None:
        # first pass: plain locks; second: conditions (which may alias
        # a lock constructed earlier in the same class)
        conditions: list[tuple] = []
        for ctx in _assignments_with_context(minfo):
            class_name, func, target, value = ctx
            if not isinstance(value, ast.Call):
                continue
            origin = minfo.imports.resolve_call_target(value.func)
            attr = _terminal_attr(target)
            if attr is None:
                continue
            if _suffix_match(origin, _THREADING_LOCKS) or _suffix_match(
                origin, _RACECHECK_FACTORIES
            ):
                kind = "RLock" if (origin or "").endswith(
                    ("RLock", "make_rlock")
                ) else "Lock"
                prefix = None
                if _suffix_match(origin, _RACECHECK_FACTORIES) and value.args:
                    prefix = _static_name_prefix(value.args[0])
                self._register(
                    LockSite(
                        _identity(minfo, class_name, func, target, attr),
                        attr,
                        kind,
                        str(minfo.path),
                        value.lineno,
                        minfo.modname,
                        class_name,
                        prefix,
                    )
                )
            elif _suffix_match(origin, _THREADING_CONDITION):
                conditions.append(ctx)
        for class_name, func, target, value in conditions:
            attr = _terminal_attr(target)
            underlying = None
            if value.args:
                under_attr = _terminal_attr(value.args[0])
                if under_attr is not None:
                    underlying = self._scoped.get(
                        (minfo.modname, class_name, under_attr)
                    ) or self._scoped.get((minfo.modname, None, under_attr))
            if underlying is not None:
                # the condition shares its lock's ordering class:
                # acquiring the condition IS acquiring the lock
                alias = LockSite(
                    underlying.identity,
                    attr,
                    "Condition",
                    str(minfo.path),
                    value.lineno,
                    minfo.modname,
                    class_name,
                    underlying.runtime_prefix,
                )
                self.sites.append(alias)
                self._scoped[(minfo.modname, class_name, attr)] = alias
                self._by_attr.setdefault(attr, []).append(alias)
            else:
                self._register(
                    LockSite(
                        _identity(minfo, class_name, func, target, attr),
                        attr,
                        "Condition",
                        str(minfo.path),
                        value.lineno,
                        minfo.modname,
                        class_name,
                        None,
                    )
                )
        # local-name lock rebound onto an attribute in the same scope
        # (``lock = make_rlock(...); self._lock = lock``): give the
        # attribute spelling the same identity
        for ctx in _assignments_with_context(minfo):
            class_name, func, target, value = ctx
            if not (isinstance(value, ast.Name) and isinstance(target, ast.Attribute)):
                continue
            site = self._scoped.get((minfo.modname, class_name, value.id))
            if site is None or site.attr != value.id:
                continue
            alias = LockSite(
                site.identity,
                target.attr,
                site.kind,
                str(minfo.path),
                target.lineno,
                minfo.modname,
                class_name,
                site.runtime_prefix,
            )
            self.sites.append(alias)
            self._scoped[(minfo.modname, class_name, target.attr)] = alias
            self._by_attr.setdefault(target.attr, []).append(alias)

    # ---- attribution ---------------------------------------------------
    def match(self, finfo: FunctionInfo, expr: ast.expr) -> Optional[LockSite]:
        """The lock identity an acquisition expression refers to, or
        None when no construction site plausibly matches."""
        attr = _terminal_attr(expr)
        if attr is None:
            return None
        mod = finfo.module.modname
        site = self._scoped.get((mod, finfo.class_name, attr))
        if site is not None:
            return site
        site = self._scoped.get((mod, None, attr))
        if site is not None:
            return site
        candidates = self._by_attr.get(attr, [])
        identities = {s.identity for s in candidates}
        if len(identities) == 1 and candidates:
            return candidates[0]
        return None

    def runtime_site(self, runtime_name: str) -> Optional[LockSite]:
        """Longest runtime-prefix match for a watchdog lock name."""
        best: Optional[LockSite] = None
        for site in self.sites:
            if site.runtime_prefix and runtime_name.startswith(site.runtime_prefix):
                if best is None or len(site.runtime_prefix) > len(
                    best.runtime_prefix or ""
                ):
                    best = site
        return best


def _identity(
    minfo: ModuleInfo,
    class_name: Optional[str],
    func: Optional[str],
    target: ast.expr,
    attr: str,
) -> str:
    if isinstance(target, ast.Attribute):
        scope = class_name or func
        return f"{minfo.modname}.{scope}.{attr}" if scope else f"{minfo.modname}.{attr}"
    if func is not None:
        return f"{minfo.modname}.{func}.{attr}"
    return f"{minfo.modname}.{attr}"


def _assignments_with_context(
    minfo: ModuleInfo,
) -> Iterator[tuple[Optional[str], Optional[str], ast.expr, ast.expr]]:
    """(enclosing class, enclosing function, target, value) for every
    single-target assignment in the module."""

    def visit(body, class_name, func):
        for node in body:
            if isinstance(node, ast.ClassDef):
                yield from visit(node.body, node.name, func)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from visit(node.body, class_name, node.name)
            else:
                for inner in ast.walk(node):
                    if isinstance(inner, ast.Assign) and len(inner.targets) == 1:
                        yield class_name, func, inner.targets[0], inner.value
                    elif isinstance(inner, ast.AnnAssign) and inner.value is not None:
                        yield class_name, func, inner.target, inner.value

    yield from visit(minfo.tree.body, None, None)


# ---------------------------------------------------------------------------
# acquisition graph
# ---------------------------------------------------------------------------


@dataclass
class _FunctionLocks:
    acquires: set[str]                       # identities acquired anywhere
    held_calls: list[tuple[tuple[str, ...], ast.Call]]  # (held, call site)
    nested: list[tuple[str, str, int]]       # (held identity, acquired, line)
    bare: list[tuple[str, int]]              # (identity, line) bare acquire()


def _collect_function(
    index: LockIndex, finfo: FunctionInfo
) -> _FunctionLocks:
    out = _FunctionLocks(set(), [], [], [])

    def visit(nodes, held: tuple[str, ...]):
        for node in nodes:
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue  # nested defs are their own functions
            if isinstance(node, (ast.With, ast.AsyncWith)):
                new_held = list(held)
                for item in node.items:
                    site = index.match(finfo, item.context_expr)
                    if site is not None:
                        out.acquires.add(site.identity)
                        for h in new_held:
                            if h != site.identity:
                                out.nested.append((h, site.identity, node.lineno))
                        new_held.append(site.identity)
                visit(node.body, tuple(new_held))
                # withitem context expressions may contain calls too
                for item in node.items:
                    visit_expr(item.context_expr, held)
                continue
            if isinstance(node, ast.Call):
                visit_call(node, held)
            visit(list(ast.iter_child_nodes(node)), held)

    def visit_expr(expr, held):
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                visit_call(node, held)

    def visit_call(node: ast.Call, held: tuple[str, ...]):
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in ("acquire", "release"):
            site = index.match(finfo, func.value)
            if site is not None:
                if func.attr == "acquire":
                    out.acquires.add(site.identity)
                    for h in held:
                        if h != site.identity:
                            out.nested.append((h, site.identity, node.lineno))
                    out.bare.append((site.identity, node.lineno))
                return
        if held:
            out.held_calls.append((held, node))

    visit(finfo.node.body, ())
    return out


def _try_finally_releases(
    finfo: FunctionInfo, identity_attr: str, line: int
) -> bool:
    """True when the bare acquire at ``line`` is covered by a
    try/finally that releases the same terminal name — either the
    acquire is inside the try body, or the try immediately follows it."""
    for node in walk_function(finfo.node):
        if not isinstance(node, ast.Try) or not node.finalbody:
            continue
        releases = any(
            isinstance(inner, ast.Call)
            and isinstance(inner.func, ast.Attribute)
            and inner.func.attr == "release"
            and _terminal_attr(inner.func.value) == identity_attr
            for stmt in node.finalbody
            for inner in ast.walk(stmt)
        )
        if not releases:
            continue
        start = node.lineno
        end = getattr(node, "end_lineno", None) or node.lineno
        # inside the try, or acquired on the line(s) just before it
        if start <= line <= end or 0 <= start - line <= 2:
            return True
    return False


def build_lock_graph(program: Program) -> tuple[LockIndex, dict, list[Finding]]:
    """(index, report block, findings) for the whole program."""
    index = LockIndex(program)
    per_function: dict[str, _FunctionLocks] = {}
    for fqn, finfo in program.functions.items():
        per_function[fqn] = _collect_function(index, finfo)

    # may-acquire fixpoint over the call graph
    may_acquire: dict[str, set[str]] = {
        fqn: set(fl.acquires) for fqn, fl in per_function.items()
    }
    callees = {fqn: program.direct_callees(fqn) for fqn in per_function}
    changed = True
    while changed:
        changed = False
        for fqn, callee_set in callees.items():
            bucket = may_acquire[fqn]
            before = len(bucket)
            for callee in callee_set:
                bucket |= may_acquire.get(callee, set())
            if len(bucket) != before:
                changed = True

    # edges: direct nesting + locks acquired by calls made while held
    edges: dict[tuple[str, str], dict] = {}

    def add_edge(before: str, after: str, path: str, line: int, via: str):
        if before == after:
            return
        edges.setdefault(
            (before, after), {"path": path, "line": line, "via": via}
        )

    for fqn, fl in per_function.items():
        finfo = program.functions[fqn]
        for before, after, line in fl.nested:
            add_edge(before, after, str(finfo.module.path), line, fqn)
        for held, call in fl.held_calls:
            for callee in program.resolve_call(finfo, call):
                for after in may_acquire.get(callee, ()):
                    for before in held:
                        add_edge(
                            before, after, str(finfo.module.path),
                            call.lineno, f"{fqn} -> {callee}",
                        )

    findings: list[Finding] = []
    # inversions: both directions present
    seen_pairs: set[frozenset] = set()
    for before, after in sorted(edges):
        if (after, before) not in edges:
            continue
        pair = frozenset((before, after))
        if pair in seen_pairs:
            continue
        seen_pairs.add(pair)
        a, b = sorted((before, after))
        meta = edges[(a, b)]
        findings.append(
            Finding(
                ANALYSIS,
                "lock-order-inversion",
                meta["path"],
                meta["line"],
                f"lock-order-inversion::{a}<->{b}",
                f"locks {a!r} and {b!r} are acquired in both orders "
                f"({meta['via']} vs {edges[(b, a)]['via']}) — potential "
                "deadlock",
            )
        )
    # longer cycles
    for cycle in _find_cycles(edges):
        if len(cycle) <= 3:
            continue  # 2-cycles already reported as inversions
        nodes = cycle[:-1]
        meta = edges[(cycle[0], cycle[1])]
        findings.append(
            Finding(
                ANALYSIS,
                "lock-order-cycle",
                meta["path"],
                meta["line"],
                "lock-order-cycle::" + "->".join(sorted(nodes)),
                "lock acquisition order forms a cycle: " + " -> ".join(cycle),
            )
        )
    # bare acquires not covered by try/finally
    for fqn, fl in per_function.items():
        finfo = program.functions[fqn]
        for identity, line in fl.bare:
            attr = identity.rsplit(".", 1)[-1]
            if _try_finally_releases(finfo, attr, line):
                continue
            findings.append(
                Finding(
                    ANALYSIS,
                    "bare-acquire",
                    str(finfo.module.path),
                    line,
                    f"bare-acquire::{fqn}::{identity}",
                    f"bare {attr}.acquire() in {fqn} without with/try-finally "
                    "— the lock leaks on any exception path",
                )
            )

    block = {
        "locks": [s.to_json() for s in index.sites],
        "identities": sorted({s.identity for s in index.sites}),
        "edges": sorted([list(k) for k in edges]),
        "findings": [f.to_json() for f in findings],
    }
    return index, block, findings


def _find_cycles(edges: dict) -> list[list[str]]:
    graph: dict[str, list[str]] = {}
    for before, after in edges:
        graph.setdefault(before, []).append(after)
    cycles: list[list[str]] = []
    state: dict[str, int] = {}
    path: list[str] = []

    def visit(node: str) -> None:
        state[node] = 1
        path.append(node)
        for nxt in sorted(graph.get(node, ())):
            if state.get(nxt, 0) == 1:
                cycles.append(path[path.index(nxt):] + [nxt])
            elif state.get(nxt, 0) == 0:
                visit(nxt)
        path.pop()
        state[node] = 2

    for node in sorted(graph):
        if state.get(node, 0) == 0:
            visit(node)
    return cycles


# ---------------------------------------------------------------------------
# runtime cross-check (racecheck <-> static graph)
# ---------------------------------------------------------------------------


def unmatched_runtime_edges(
    index: LockIndex,
    static_edges: set[tuple[str, str]],
    runtime_edges: list[tuple[str, str]],
) -> tuple[list[str], list[str]]:
    """Compare the racecheck watchdog's observed acquisition edges
    (lock NAMES) against the static identity graph.  Returns
    ``(violations, unmapped)``: violations are runtime edges whose both
    endpoints map to static identities but whose edge the static graph
    lacks — a static-analysis blind spot; unmapped names (locks created
    outside the analyzed program, e.g. test-local) are reported
    separately for diagnostics, not failure."""
    violations: list[str] = []
    unmapped: list[str] = []
    closure = _transitive_closure(static_edges)
    for before_name, after_name in runtime_edges:
        before = index.runtime_site(before_name)
        after = index.runtime_site(after_name)
        if before is None or after is None:
            missing = before_name if before is None else after_name
            unmapped.append(missing)
            continue
        if before.identity == after.identity:
            continue  # two instances of one ordering class
        if (before.identity, after.identity) in closure:
            continue
        violations.append(
            f"runtime edge {before_name!r} -> {after_name!r} "
            f"({before.identity} -> {after.identity}) is missing from the "
            "static acquisition graph — the call-graph attribution has a "
            "blind spot"
        )
    return violations, sorted(set(unmapped))


_CROSSCHECK_CACHE: Optional[tuple["LockIndex", set]] = None


def runtime_crosscheck(
    runtime_edges: list[tuple[str, str]],
) -> tuple[list[str], list[str]]:
    """One-call bridge for the chaos/soak tiers: build the static lock
    graph over the installed ``agac_tpu_torch`` package (once per process,
    via the shared parse cache) and compare the racecheck watchdog's
    observed edges against it.  Returns ``(violations, unmapped)`` as
    :func:`unmatched_runtime_edges` does."""
    global _CROSSCHECK_CACHE
    if _CROSSCHECK_CACHE is None:
        from pathlib import Path

        from .program import shared_cache

        pkg_root = Path(__file__).resolve().parent.parent
        program = Program.build([pkg_root], shared_cache())
        index, block, _ = build_lock_graph(program)
        _CROSSCHECK_CACHE = (index, {tuple(e) for e in block["edges"]})
    index, static_edges = _CROSSCHECK_CACHE
    return unmatched_runtime_edges(index, static_edges, runtime_edges)


def _transitive_closure(edges: set[tuple[str, str]]) -> set[tuple[str, str]]:
    graph: dict[str, set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    closure: set[tuple[str, str]] = set()
    for start in graph:
        stack = list(graph[start])
        seen: set[str] = set()
        while stack:
            node = stack.pop()
            if node in seen:
                continue
            seen.add(node)
            closure.add((start, node))
            stack.extend(graph.get(node, ()))
    return closure


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------


@program_rule(
    "lock-order",
    "static lock discovery, acquisition-graph construction, order-inversion "
    "and bare-acquire detection, cross-checked against racecheck at runtime",
)
def check_lock_order(program: Program):
    _, block, findings = build_lock_graph(program)
    return findings, block
