"""Shared-mutable-state census (program analysis 2 of 4).

The multi-core worker runtime will move reconcile execution across
process/interpreter boundaries; every piece of shared mutable state is
either a hazard to that refactor or a work-list item for it.  This
analysis classifies:

- every MODULE-LEVEL mutable (dicts/lists/sets, ``threading.local``,
  instances of program classes) and every site that mutates it,
  program-wide through import provenance;
- every INSTANCE ATTRIBUTE mutated from more than one thread-spawning
  path (thread target functions resolved through the call graph).

Each entry lands in exactly one bucket:

- ``lock-guarded`` — all mutations run under a lock (lexically inside
  a ``with <lock>`` / the object is an instance of a class that owns a
  discovered lock);
- ``seam-gated`` — only rebound through an install/reset/enable seam
  (flipped once around a sim world, never mid-flight — the clockseam
  contract);
- ``confined`` — never mutated after module init, mutated only at
  module top level, thread-local by construction, or reachable from at
  most one thread-spawning path;
- ``suppressed`` — an inline ``# agac-lint:
  ignore[shared-state-census] -- reason`` on the definition/mutation
  line (the reason is mandatory);
- ``UNSAFE`` — everything else.  The gate requires this bucket EMPTY:
  unlike lock-order/determinism findings it cannot be baselined,
  because every entry is exactly the state the multi-core PR would
  silently corrupt.

The census JSON block in ``analysis_report.json`` is the multi-core
PR's work list: what must become per-process, message-passed, or
explicitly shared.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Optional

from .lockorder import LockIndex, _terminal_attr
from .program import Finding, ModuleInfo, Program, in_package, program_rule, walk_function

ANALYSIS = "census"

_MUTABLE_LITERALS = (ast.Dict, ast.List, ast.Set, ast.ListComp, ast.SetComp, ast.DictComp)
_MUTABLE_BUILTINS = (
    "dict", "list", "set", "collections.defaultdict", "collections.deque",
    "collections.OrderedDict", "collections.Counter", "defaultdict", "deque",
    "OrderedDict",
)
_THREAD_LOCAL = ("threading.local",)
_MUTATOR_METHODS = frozenset(
    {
        "append", "extend", "insert", "add", "update", "setdefault", "pop",
        "popitem", "popleft", "appendleft", "remove", "discard", "clear",
    }
)
_SEAM_FN = re.compile(
    r"^_?(install|reset|enable|disable|set_[a-z_]+|configure[a-z_]*"
    r"|add_[a-z_]+|remove_[a-z_]+|register[a-z_]*|unregister[a-z_]*)$"
)
# constructors whose instances synchronize internally — mutating calls
# on them are not shared-state hazards
_THREADSAFE_TYPES = (
    "threading.Event", "threading.Semaphore", "threading.BoundedSemaphore",
    "threading.Barrier", "queue.Queue", "queue.SimpleQueue",
    "queue.LifoQueue", "queue.PriorityQueue", "collections.deque",
)
_LOCKISH = re.compile(r"(lock|mutex|cond|sem|_mu)", re.IGNORECASE)
_SUPPRESS_RE = re.compile(
    r"#\s*agac-lint:\s*ignore\[shared-state-census\]\s*--\s*(?P<why>.*\S)"
)


@dataclass
class StateEntry:
    name: str                # "mod.NAME" or "mod.Class.attr"
    kind: str                # "module-global" | "instance-attr"
    value_type: str          # "dict" / "list" / "instance:Class" / ...
    path: str
    line: int
    bucket: str = "confined"
    reason: str = ""
    mutation_sites: list[str] = field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "value_type": self.value_type,
            "path": self.path,
            "line": self.line,
            "bucket": self.bucket,
            "reason": self.reason,
            "mutations": self.mutation_sites,
        }


@dataclass
class _Mutation:
    fqn: str          # function performing it ("" = module top level)
    line: int
    guarded: bool     # lexically under a with-lock
    rebinding: bool   # global-rebind (vs container mutation)
    seam: bool        # inside a seam function


# below a package root (PACKAGE_ROOTS)
_SINGLE_THREADED = ("sim/", "analysis/")


def _single_threaded_module(path: str) -> bool:
    return in_package(path, _SINGLE_THREADED)


def _suppression(minfo: ModuleInfo, line: int) -> Optional[str]:
    lines = minfo.parsed.source_lines
    if 1 <= line <= len(lines):
        m = _SUPPRESS_RE.search(lines[line - 1])
        if m:
            return m.group("why")
    return None


def _value_type(minfo: ModuleInfo, value: ast.expr, program: Program) -> Optional[str]:
    """The mutable type of a module-level initializer, or None when the
    value is immutable/unknown."""
    if isinstance(value, _MUTABLE_LITERALS):
        return type(value).__name__.replace("Comp", "").lower().replace("ast.", "")
    if isinstance(value, ast.Call):
        origin = minfo.imports.resolve_call_target(value.func)
        name = None
        if isinstance(value.func, ast.Name):
            name = value.func.id
        if origin is None and name is not None:
            origin = name  # builtins aren't import-bound
        if origin is None:
            return None
        for suffix in _THREAD_LOCAL:
            if origin == suffix or origin.endswith("." + suffix):
                return "threading.local"
        for suffix in _MUTABLE_BUILTINS:
            if origin == suffix or origin.endswith("." + suffix):
                return suffix.rsplit(".", 1)[-1]
        # instance of a program class?
        if name is not None and name in minfo.classes:
            return f"instance:{name}"
        module_path, _, leaf = origin.rpartition(".")
        for modname, other in program.modules.items():
            if leaf in other.classes and (
                modname == module_path or modname.endswith("." + module_path)
            ):
                return f"instance:{leaf}"
    return None


def _class_of_instance(
    program: Program, minfo: ModuleInfo, value_type: str
) -> Optional[tuple[ModuleInfo, str]]:
    if not value_type.startswith("instance:"):
        return None
    cls = value_type.split(":", 1)[1]
    if cls in minfo.classes:
        return minfo, cls
    for other in program.modules.values():
        if cls in other.classes:
            return other, cls
    return None


def _class_has_lock(index: LockIndex, modname: str, cls: str) -> bool:
    return any(
        s.module == modname and s.class_name == cls for s in index.sites
    )


def _is_immutable_const(value: ast.expr) -> bool:
    if isinstance(value, ast.Constant):
        return True
    if isinstance(value, ast.Tuple):
        return all(_is_immutable_const(elt) for elt in value.elts)
    return False


def _class_is_stateless(minfo: ModuleInfo, cls: str) -> bool:
    """True when a shared instance of ``cls`` is structurally immutable:
    no bases (nothing inherited), empty ``__slots__`` (instance attrs
    impossible), class-level assigns limited to immutable constants,
    and no method writes ``self.X``.  Null-object singletons
    (``_NULL_SCOPE`` / ``_NULL_STAGE``) earn ``confined`` this way —
    safe to share across threads AND processes by construction."""
    cinfo = minfo.classes.get(cls)
    if cinfo is None or cinfo.node.bases or cinfo.node.keywords:
        return False
    has_empty_slots = False
    for stmt in cinfo.node.body:
        if isinstance(stmt, ast.Assign):
            if not _is_immutable_const(stmt.value):
                return False
            for target in stmt.targets:
                if (
                    isinstance(target, ast.Name)
                    and target.id == "__slots__"
                    and isinstance(stmt.value, ast.Tuple)
                    and not stmt.value.elts
                ):
                    has_empty_slots = True
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None and not _is_immutable_const(stmt.value):
                return False
    if not has_empty_slots:
        return False
    for method in cinfo.methods.values():
        if _self_attr_mutations(method):
            return False
    return True


# ---------------------------------------------------------------------------
# mutation scanning
# ---------------------------------------------------------------------------


def _is_guard_with(item: ast.withitem) -> bool:
    attr = _terminal_attr(item.context_expr)
    return attr is not None and bool(_LOCKISH.search(attr))


def _scan_function_mutations(
    finfo, names: set[str]
) -> list[tuple[str, int, bool, bool]]:
    """(name, line, guarded, rebinding) for every mutation of a tracked
    module-global name inside one function."""
    out: list[tuple[str, int, bool, bool]] = []
    declared_global: set[str] = set()
    for node in walk_function(finfo.node):
        if isinstance(node, (ast.Global, ast.Nonlocal)):
            declared_global.update(node.names)

    def visit(nodes, guarded: bool):
        for node in nodes:
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            if isinstance(node, (ast.With, ast.AsyncWith)):
                inner_guarded = guarded or any(
                    _is_guard_with(item) for item in node.items
                )
                visit(node.body, inner_guarded)
                continue
            _match_mutation(node, guarded)
            visit(list(ast.iter_child_nodes(node)), guarded)

    def _match_mutation(node, guarded: bool):
        if isinstance(node, ast.Assign):
            for target in node.targets:
                _match_target(target, node.lineno, guarded)
        elif isinstance(node, ast.AugAssign):
            _match_target(node.target, node.lineno, guarded)
        elif isinstance(node, ast.Delete):
            for target in node.targets:
                _match_target(target, node.lineno, guarded)
        elif isinstance(node, ast.Call):
            func = node.func
            if (
                isinstance(func, ast.Attribute)
                and func.attr in _MUTATOR_METHODS
                and isinstance(func.value, ast.Name)
                and func.value.id in names
            ):
                out.append((func.value.id, node.lineno, guarded, False))

    def _match_target(target, line, guarded: bool):
        if isinstance(target, ast.Name) and target.id in names:
            if target.id in declared_global:
                out.append((target.id, line, guarded, True))
        elif isinstance(target, ast.Subscript):
            base = target.value
            if isinstance(base, ast.Name) and base.id in names:
                out.append((base.id, line, guarded, False))

    visit(finfo.node.body, False)
    return out


def _module_top_level_mutations(minfo: ModuleInfo, names: set[str]) -> set[str]:
    """Names mutated by module top-level statements (after their
    definition) — init-time fills, confined by construction."""
    mutated: set[str] = set()
    for node in minfo.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        for inner in ast.walk(node):
            if isinstance(inner, ast.Call):
                func = inner.func
                if (
                    isinstance(func, ast.Attribute)
                    and func.attr in _MUTATOR_METHODS
                    and isinstance(func.value, ast.Name)
                    and func.value.id in names
                ):
                    mutated.add(func.value.id)
            elif isinstance(inner, (ast.Assign, ast.AugAssign)):
                targets = (
                    inner.targets if isinstance(inner, ast.Assign) else [inner.target]
                )
                for target in targets:
                    if (
                        isinstance(target, ast.Subscript)
                        and isinstance(target.value, ast.Name)
                        and target.value.id in names
                    ):
                        mutated.add(target.value.id)
    return mutated


# ---------------------------------------------------------------------------
# thread roots
# ---------------------------------------------------------------------------


def thread_roots(program: Program) -> dict[str, str]:
    """fqn of every thread target function -> the spawn site that
    starts it (``threading.Thread(target=...)`` resolved through
    provenance + the call graph)."""
    roots: dict[str, str] = {}
    for fqn, finfo in program.functions.items():
        minfo = finfo.module
        for node in walk_function(finfo.node):
            if not isinstance(node, ast.Call):
                continue
            origin = minfo.imports.resolve_call_target(node.func)
            if origin is None and isinstance(node.func, ast.Attribute):
                if node.func.attr == "Thread":
                    origin = "threading.Thread"
            if not (origin and (origin == "threading.Thread" or origin.endswith(".Thread"))):
                continue
            target_expr = next(
                (kw.value for kw in node.keywords if kw.arg == "target"), None
            )
            if target_expr is None:
                continue
            fake_call = ast.Call(func=target_expr, args=[], keywords=[])
            ast.copy_location(fake_call, node)
            for resolved in program.resolve_call(finfo, fake_call):
                roots.setdefault(resolved, f"{fqn}:{node.lineno}")
    return roots


# ---------------------------------------------------------------------------
# the census
# ---------------------------------------------------------------------------


def build_census(program: Program) -> tuple[dict, list[Finding]]:
    index = LockIndex(program)
    entries: list[StateEntry] = []

    # ---- module-level mutables ----------------------------------------
    for minfo in program.modules.values():
        if _single_threaded_module(str(minfo.path)):
            continue
        globals_here: dict[str, StateEntry] = {}
        for node in minfo.tree.body:
            target = None
            value = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target, value = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                target, value = node.target, node.value
            if not isinstance(target, ast.Name):
                continue
            vtype = _value_type(minfo, value, program)
            if vtype is None:
                continue
            entry = StateEntry(
                f"{minfo.modname}.{target.id}",
                "module-global",
                vtype,
                str(minfo.path),
                node.lineno,
            )
            globals_here[target.id] = entry
            entries.append(entry)
        if not globals_here:
            continue
        names = set(globals_here)
        mutations: dict[str, list[_Mutation]] = {n: [] for n in names}
        # defining module's functions
        for finfo in minfo.functions.values():
            seam = bool(_SEAM_FN.match(finfo.name))
            for name, line, guarded, rebinding in _scan_function_mutations(
                finfo, names
            ):
                mutations[name].append(
                    _Mutation(finfo.fqn, line, guarded, rebinding, seam)
                )
        # importing modules (provenance-tracked)
        mod_tail = minfo.modname.rsplit(".", 1)[-1]
        for other in program.modules.values():
            if other is minfo:
                continue
            aliased = {
                b.local
                for b in other.imports.bindings.values()
                if b.attr in names
                and (
                    b.module == minfo.modname
                    or b.module.endswith("." + mod_tail)
                    or b.module == mod_tail
                )
            }
            if not aliased:
                continue
            local_to_orig = {
                b.local: b.attr
                for b in other.imports.bindings.values()
                if b.local in aliased
            }
            for finfo in other.functions.values():
                seam = bool(_SEAM_FN.match(finfo.name))
                for name, line, guarded, rebinding in _scan_function_mutations(
                    finfo, set(local_to_orig)
                ):
                    mutations[local_to_orig[name]].append(
                        _Mutation(finfo.fqn, line, guarded, rebinding, seam)
                    )
        top_level = _module_top_level_mutations(minfo, names)
        # classify
        for name, entry in globals_here.items():
            muts = mutations[name]
            suppression = _suppression(minfo, entry.line)
            entry.mutation_sites = [f"{m.fqn}:{m.line}" for m in muts]
            cls_ref = _class_of_instance(program, minfo, entry.value_type)
            if suppression is not None:
                entry.bucket, entry.reason = "suppressed", suppression
            elif entry.value_type == "threading.local":
                entry.bucket, entry.reason = "confined", "thread-local by construction"
            elif not muts:
                if name in top_level:
                    entry.bucket, entry.reason = (
                        "confined",
                        "mutated only at module init",
                    )
                elif cls_ref is not None and _class_has_lock(
                    index, cls_ref[0].modname, cls_ref[1]
                ):
                    entry.bucket, entry.reason = (
                        "lock-guarded",
                        f"instance of internally locked {cls_ref[1]}",
                    )
                elif cls_ref is not None and _class_is_stateless(
                    cls_ref[0], cls_ref[1]
                ):
                    entry.bucket, entry.reason = (
                        "confined",
                        f"stateless instance of {cls_ref[1]}: empty "
                        "__slots__, immutable class attrs, no self-writes",
                    )
                elif cls_ref is not None:
                    entry.bucket, entry.reason = (
                        "UNSAFE",
                        f"shared instance of {cls_ref[1]}, which owns no lock",
                    )
                else:
                    entry.bucket, entry.reason = (
                        "confined",
                        "never mutated after definition",
                    )
            elif all(m.seam for m in muts):
                entry.bucket, entry.reason = (
                    "seam-gated",
                    "mutated only through install/configure-style seams",
                )
            elif all(m.guarded for m in muts):
                entry.bucket, entry.reason = (
                    "lock-guarded",
                    "every mutation runs under a with-lock",
                )
            elif cls_ref is not None and _class_has_lock(
                index, cls_ref[0].modname, cls_ref[1]
            ):
                entry.bucket, entry.reason = (
                    "lock-guarded",
                    f"instance of internally locked {cls_ref[1]}",
                )
            else:
                entry.bucket, entry.reason = (
                    "UNSAFE",
                    "mutated outside any lock/seam: "
                    + ", ".join(entry.mutation_sites[:4]),
                )

    # ---- instance attributes mutated from >1 thread path --------------
    # Reachability runs PRECISE (no by-name fallback): a false edge here
    # brands single-writer state as multi-threaded, and an UNSAFE bucket
    # full of noise is a gate nobody keeps green.  The sim and analysis
    # packages are single-threaded by contract (virtual time / offline
    # tooling) and sit outside the audit entirely.
    roots = thread_roots(program)
    reach: dict[str, frozenset[str]] = {
        root: frozenset({root}) | program.transitive_callees(root, fallback=False)
        for root in roots
    }
    # (module, class, attr) -> mutation records
    attr_muts: dict[tuple[str, str, str], list[_Mutation]] = {}
    for fqn, finfo in program.functions.items():
        if finfo.class_name is None or finfo.name == "__init__":
            continue
        if _single_threaded_module(str(finfo.module.path)):
            continue
        for attr, line, guarded in _self_attr_mutations(finfo):
            key = (finfo.module.modname, finfo.class_name, attr)
            attr_muts.setdefault(key, []).append(
                _Mutation(fqn, line, guarded, False, False)
            )
    safe_attrs = _threadsafe_primitive_attrs(program)
    for (modname, cls, attr), muts in sorted(attr_muts.items()):
        mutating_fqns = {m.fqn for m in muts}
        spawning_paths = {
            root for root, reachable in reach.items()
            if mutating_fqns & reachable
        }
        if len(spawning_paths) < 2:
            continue  # single-threaded path: confined, not listed
        minfo = program.modules[modname]
        entry = StateEntry(
            f"{modname}.{cls}.{attr}",
            "instance-attr",
            "attribute",
            str(minfo.path),
            muts[0].line,
            mutation_sites=[f"{m.fqn}:{m.line}" for m in muts],
        )
        suppression = _suppression(minfo, muts[0].line)
        if suppression is not None:
            entry.bucket, entry.reason = "suppressed", suppression
        elif (modname, cls, attr) in safe_attrs:
            entry.bucket, entry.reason = (
                "lock-guarded",
                "internally synchronized threading/queue primitive",
            )
        elif all(m.guarded for m in muts):
            entry.bucket, entry.reason = (
                "lock-guarded",
                "every mutation runs under a with-lock",
            )
        elif _class_has_lock(index, modname, cls) and any(m.guarded for m in muts):
            # mixed: some sites guarded, some not — the unguarded ones
            # are exactly the hazard
            unguarded = [f"{m.fqn}:{m.line}" for m in muts if not m.guarded]
            entry.bucket, entry.reason = (
                "UNSAFE",
                f"mutated from {len(spawning_paths)} thread paths with "
                f"unguarded sites: {', '.join(unguarded[:4])}",
            )
        else:
            entry.bucket, entry.reason = (
                "UNSAFE",
                f"mutated from {len(spawning_paths)} thread-spawning paths "
                "with no lock",
            )
        entries.append(entry)

    entries.sort(key=lambda e: (e.path, e.line, e.name))
    buckets: dict[str, int] = {}
    for entry in entries:
        buckets[entry.bucket] = buckets.get(entry.bucket, 0) + 1
    findings = [
        Finding(
            ANALYSIS,
            "shared-state-census",
            e.path,
            e.line,
            f"shared-state-census::{e.name}",
            f"{e.name} is UNSAFE: {e.reason}",
        )
        for e in entries
        if e.bucket == "UNSAFE"
    ]
    block = {
        "census": [e.to_json() for e in entries],
        "buckets": buckets,
        "thread_roots": {fqn: site for fqn, site in sorted(roots.items())},
    }
    return block, findings


def _threadsafe_primitive_attrs(program: Program) -> set[tuple[str, str, str]]:
    """(module, class, attr) for every ``self.X = threading.Event()``-
    style assignment: primitives that synchronize internally."""
    out: set[tuple[str, str, str]] = set()
    for finfo in program.functions.values():
        if finfo.class_name is None:
            continue
        minfo = finfo.module
        for node in walk_function(finfo.node):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                continue
            target, value = node.targets[0], node.value
            if not (
                isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"
                and isinstance(value, ast.Call)
            ):
                continue
            origin = minfo.imports.resolve_call_target(value.func)
            if origin is not None and any(
                origin == t or origin.endswith("." + t)
                for t in _THREADSAFE_TYPES
            ):
                out.add((minfo.modname, finfo.class_name, target.attr))
    return out


def _self_attr_mutations(finfo) -> list[tuple[str, int, bool]]:
    """(attr, line, guarded) for every ``self.X`` mutation in a method
    — assignment, augmented assignment, or container-mutator call."""
    out: list[tuple[str, int, bool]] = []

    def visit(nodes, guarded: bool):
        for node in nodes:
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            if isinstance(node, (ast.With, ast.AsyncWith)):
                inner = guarded or any(_is_guard_with(i) for i in node.items)
                visit(node.body, inner)
                continue
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign) else [node.target]
                )
                for target in targets:
                    base = target
                    if isinstance(base, ast.Subscript):
                        base = base.value
                    if (
                        isinstance(base, ast.Attribute)
                        and isinstance(base.value, ast.Name)
                        and base.value.id == "self"
                    ):
                        out.append((base.attr, node.lineno, guarded))
            elif isinstance(node, ast.Call):
                func = node.func
                if (
                    isinstance(func, ast.Attribute)
                    and func.attr in _MUTATOR_METHODS
                    and isinstance(func.value, ast.Attribute)
                    and isinstance(func.value.value, ast.Name)
                    and func.value.value.id == "self"
                ):
                    out.append((func.value.attr, node.lineno, guarded))
            visit(list(ast.iter_child_nodes(node)), guarded)

    visit(finfo.node.body, False)
    return out


@program_rule(
    "census",
    "shared-mutable-state census: classify every module-level mutable and "
    "multi-thread-mutated attribute into lock-guarded / seam-gated / "
    "confined / UNSAFE — the UNSAFE bucket gates CI and the census is the "
    "multi-core refactor's work list",
)
def check_census(program: Program):
    block, findings = build_census(program)
    return findings, block
