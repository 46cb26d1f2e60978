"""Cross-process confinement analyzer (program analysis 4 of 4).

The census names every piece of shared mutable state; the
stage accountant names the hot stages.  This analysis
connects them, because the multi-core worker runtime needs the join:
WHICH stages touch WHICH shared state, and what would break the moment
a stage body runs in a different process.

Four passes over the shared ``Program``:

- **Stage footprint table** — for every entry point of the 10-stage
  catalog (``queue-pop`` … ``r53-batch-flush``) plus the dynamic
  ``aws:{service}.{op}`` family, the transitive (over-approximate,
  ``fallback=True`` — toward ``write-shared`` is the safe direction)
  read/write footprint over every census entry, with a per-stage
  verdict:

  - ``confined`` — the closure touches no census entry: the stage body
    can move to a worker process as-is;
  - ``read-shared`` — reads shared state but never writes it: portable
    with a snapshot/ship-inputs design;
  - ``write-shared`` — writes census entries: portable only with a
    result-message protocol (the writes must come back to the parent);
  - ``unportable`` — writes UNSAFE state, spawns threads outside the
    ``clockseam.threads_enabled`` gate, or ships an unpicklable
    callable across an executor boundary: must be refactored before
    the multi-core PR touches it.

  The table IS the multi-core executor's dispatch plan, and an
  ``unportable`` verdict on a roadmap-marked candidate stage gate-fails
  (``unportable_stages`` in the report gate, mirroring
  ``unsafe_census``: it cannot be baselined).

- **Escape analysis** — objects constructed in worker/reconcile scope
  (the union of stage closures) that flow into module globals, shared
  instance attributes, or thread spawns.  An escape into an UNSAFE
  census entry is a finding (``worker-scope-escape``).

- **Picklability audit** — ``pool.submit``/``pool.map`` call sites
  whose callable a process pool could not ship: lambdas (pickled by
  reference), bound methods of lock/socket/generator-holding classes,
  closures over enclosing state.  Submissions already gated on
  ``clockseam.threads_enabled()`` are recorded but not findings — the
  seam is exactly what keeps them off the process-pool path.

- **Runtime cross-check** — ``runtime_footprint_crosscheck`` compares
  racecheck's stage-tagged observed mutations (which guarded table was
  written under which stage brackets) against the static table: an
  observed write whose owning class appears in NO active stage's
  closure is a call-graph blind spot, same contract as
  ``lockorder.runtime_crosscheck``.

Stdlib-only, like the rest of ``agac_tpu_torch.analysis``.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterable, Optional

from .census import (
    _single_threaded_module,
    _value_type,
    build_census,
)
from .determinism import _THREAD_SANCTIONED, _calls_threads_enabled, _sanctioned
from .lockorder import LockIndex
from .program import Finding, FunctionInfo, Program, program_rule, walk_function

ANALYSIS = "confinement"

# ---------------------------------------------------------------------------
# the stage catalog — literal copy of observability/profile.py STAGES
# (the analyzer never imports the package it analyzes, the
# rules.py _STAGE_NAMES precedent); tests/test_confinement_analysis.py
# pins the two sets equal.
# ---------------------------------------------------------------------------

STAGE_CATALOG: tuple[str, ...] = (
    "queue-pop",
    "shard-filter",
    "informer-lookup",
    "serialize",
    "driver-mutate",
    "settle-park",
    "self-tax",
    "drift-tick",
    "gc-sweep",
    "r53-batch-flush",
)

# the dynamic per-AWS-call family (``profile.api_stage(service, op)``)
# collapses into one table row — individual op names are unbounded
API_STAGE_FAMILY = "aws:*"

# stages ROADMAP.md marks as multi-core executor candidates: the
# reconcile body the process pool would ship out.  An ``unportable``
# verdict on any of these gate-fails (and cannot be baselined).
MULTI_CORE_CANDIDATES: tuple[str, ...] = (
    "serialize",
    "driver-mutate",
    "r53-batch-flush",
)

VERDICTS = ("confined", "read-shared", "write-shared", "unportable")

# entry points the call graph cannot discover from ``stage(...)``
# bracket sites alone: ``_dispatch`` invokes the controllers' process
# funcs through PARAMETERS (``process_delete(key)``), so the
# driver-mutate closure must be seeded with the process funcs
# themselves.  Patterns are regexes over function fqns; a test pins
# every hint non-vacuous (each matches at least one function).
STAGE_ENTRY_HINTS: dict[str, tuple[str, ...]] = {
    "driver-mutate": (
        r"controllers\.[a-z0-9_]+::[A-Za-z_]+\."
        r"(process_(service|ingress)_(delete|create_or_update)|reconcile)$",
    ),
}

# the ``aws:*`` family's only bracket site is the InstrumentedAPI
# ``observed`` closure, whose ``attr(*args)`` dispatches through
# ``getattr(self._inner, name)`` — a hop no call graph follows.  The
# wrapper is typed against the abstract service interfaces below, so
# the dispatch targets ARE statically enumerable: every subclass of an
# API ABC contributes its op methods (names declared abstract on the
# ABC; non-op attributes pass through the wrapper un-bracketed) as
# ``aws:*`` entry points.  The chaos/soak runtime cross-check caught
# exactly this blind spot before the seeding existed.
_API_ABC_MODULE = "cloudprovider.aws.api"
_API_ABC_NAMES = ("GlobalAcceleratorAPI", "ELBv2API", "Route53API")

_SUPPRESS_RE = re.compile(
    r"#\s*agac-lint:\s*ignore\[cross-boundary-capture\]\s*--\s*(?P<why>.*\S)"
)
_POOLISH = re.compile(r"(pool|executor)", re.IGNORECASE)
_SUBMISSION_METHODS = frozenset({"submit", "map"})


# ---------------------------------------------------------------------------
# stage entry-point discovery
# ---------------------------------------------------------------------------


def _api_backend_entry_points(program: Program) -> set[str]:
    """Fqns of AWS-API op implementations — the methods the
    ``aws:{service}.{op}`` bracket dynamically dispatches into.  Op
    names come from the ABCs' abstract methods; implementations are
    classes whose bases resolve (via each module's import map) to one
    of the ABCs.  Helper methods a backend defines beyond the op set
    stay out: the wrapper never brackets them."""
    op_names: set[str] = set()
    for minfo in program.modules.values():
        if not minfo.modname.endswith(_API_ABC_MODULE):
            continue
        for cls_name in _API_ABC_NAMES:
            cls = minfo.classes.get(cls_name)
            if cls is not None:
                op_names.update(cls.methods)
    if not op_names:
        return set()
    fqns: set[str] = set()
    for minfo in program.modules.values():
        for cls in minfo.classes.values():
            is_impl = any(
                isinstance(base, (ast.Name, ast.Attribute))
                and (origin := minfo.imports.resolve_call_target(base))
                is not None
                and any(
                    origin == f"{_API_ABC_MODULE}.{n}"
                    or origin.endswith(f"{_API_ABC_MODULE}.{n}")
                    or origin == f"api.{n}"
                    or origin.endswith(f".api.{n}")
                    for n in _API_ABC_NAMES
                )
                for base in cls.node.bases
            )
            if not is_impl:
                continue
            for local_qual, finfo in cls.methods.items():
                if finfo.name in op_names:
                    fqns.add(finfo.fqn)
    return fqns


def stage_entry_points(program: Program) -> dict[str, set[str]]:
    """Stage name -> fqns whose bodies bracket it: every
    ``profile.stage("<literal>")`` / ``api_stage(...)`` call site's
    enclosing function, plus the ``STAGE_ENTRY_HINTS`` seeds."""
    entries: dict[str, set[str]] = {name: set() for name in STAGE_CATALOG}
    entries[API_STAGE_FAMILY] = set()
    for fqn, finfo in program.functions.items():
        minfo = finfo.module
        for node in walk_function(finfo.node):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            attr = None
            if isinstance(func, ast.Attribute):
                attr = func.attr
            elif isinstance(func, ast.Name):
                attr = func.id
            if attr == "api_stage":
                entries[API_STAGE_FAMILY].add(fqn)
                continue
            if attr != "stage":
                continue
            origin = minfo.imports.resolve_call_target(func)
            if origin is not None and not origin.endswith("profile.stage"):
                continue  # journey.stage(...) and friends
            name_arg = node.args[0] if node.args else None
            if (
                isinstance(name_arg, ast.Constant)
                and isinstance(name_arg.value, str)
                and name_arg.value in entries
            ):
                entries[name_arg.value].add(fqn)
    for stage_name, patterns in STAGE_ENTRY_HINTS.items():
        for pattern in patterns:
            rx = re.compile(pattern)
            for fqn in program.functions:
                if rx.search(fqn):
                    entries[stage_name].add(fqn)
    entries[API_STAGE_FAMILY] |= _api_backend_entry_points(program)
    return entries


# ---------------------------------------------------------------------------
# census-entry access index: who reads / writes each entry
# ---------------------------------------------------------------------------


def _entry_access_index(
    program: Program, census_entries: list[dict]
) -> dict[str, dict[str, set[str]]]:
    """Entry name -> {"writes": fqns, "reads": fqns}.  Writes come from
    the census's own mutation sites; reads are loads of the entry in
    its defining module (bare ``NAME``), through a from-import alias
    (``NAME``), through a module alias (``mod.NAME``), or as a
    ``self.attr`` load in the owning class's methods."""
    access: dict[str, dict[str, set[str]]] = {
        e["name"]: {"writes": set(), "reads": set()} for e in census_entries
    }
    globals_by_mod: dict[str, dict[str, str]] = {}
    attrs_by_cls: dict[tuple[str, str], dict[str, str]] = {}
    for e in census_entries:
        for site in e["mutations"]:
            access[e["name"]]["writes"].add(site.rsplit(":", 1)[0])
        if e["kind"] == "module-global":
            mod, var = e["name"].rsplit(".", 1)
            globals_by_mod.setdefault(mod, {})[var] = e["name"]
        elif e["kind"] == "instance-attr":
            parts = e["name"].rsplit(".", 2)
            if len(parts) == 3:
                attrs_by_cls.setdefault((parts[0], parts[1]), {})[parts[2]] = e[
                    "name"
                ]

    def _mods_matching(origin: str) -> list[str]:
        return [
            mod
            for mod in globals_by_mod
            if mod == origin or mod.endswith("." + origin)
        ]

    for fqn, finfo in program.functions.items():
        minfo = finfo.module
        # bare names visible here: the defining module's own globals,
        # plus from-imported entries (``from .profile import _agg``)
        tracked: dict[str, str] = dict(globals_by_mod.get(minfo.modname, {}))
        # module aliases: local name -> {var -> entry} for bindings that
        # resolve to a module owning entries (``profile._agg`` reads)
        mod_aliases: dict[str, dict[str, str]] = {}
        for binding in minfo.imports.bindings.values():
            origin = binding.origin
            if not origin:
                continue
            if binding.attr is not None:
                mod, _, var = origin.rpartition(".")
                if mod:
                    for owner in _mods_matching(mod):
                        if var in globals_by_mod[owner]:
                            tracked[binding.local] = globals_by_mod[owner][var]
            for owner in _mods_matching(origin):
                mod_aliases.setdefault(binding.local, {}).update(
                    globals_by_mod[owner]
                )
        own_attrs = (
            attrs_by_cls.get((minfo.modname, finfo.class_name), {})
            if finfo.class_name is not None
            else {}
        )
        if not tracked and not mod_aliases and not own_attrs:
            continue
        for node in walk_function(finfo.node):
            if isinstance(node, ast.Name) and node.id in tracked:
                access[tracked[node.id]]["reads"].add(fqn)
            elif isinstance(node, ast.Attribute) and isinstance(
                node.value, ast.Name
            ):
                base = node.value.id
                if base in ("self", "cls") and node.attr in own_attrs:
                    access[own_attrs[node.attr]]["reads"].add(fqn)
                elif base in mod_aliases and node.attr in mod_aliases[base]:
                    access[mod_aliases[base][node.attr]]["reads"].add(fqn)
    return access


# ---------------------------------------------------------------------------
# thread spawns outside the seam (the portability disqualifier)
# ---------------------------------------------------------------------------


def _is_thread_construction(finfo: FunctionInfo, node: ast.Call) -> bool:
    origin = finfo.module.imports.resolve_call_target(node.func)
    if origin is None and isinstance(node.func, ast.Attribute):
        if node.func.attr == "Thread":
            origin = "threading.Thread"
    return bool(
        origin and (origin == "threading.Thread" or origin.endswith(".Thread"))
    )


def unseamed_spawners(program: Program) -> dict[str, int]:
    """fqn -> line of every function constructing a ``threading.Thread``
    where neither the function nor a direct caller consults
    ``clockseam.threads_enabled()`` — the functions a process-pool
    worker must never reach (a worker cannot honor the seam it never
    checked).  Drained to empty by the seam-gating refactors;
    any regression reappears here AND in the unseamed-thread gate."""
    gated = {
        fqn
        for fqn, finfo in program.functions.items()
        if _calls_threads_enabled(finfo)
    }
    callers: dict[str, set[str]] = {}
    for fqn in program.functions:
        for callee in program.direct_callees(fqn):
            callers.setdefault(callee, set()).add(fqn)
    out: dict[str, int] = {}
    for fqn, finfo in program.functions.items():
        if _sanctioned(str(finfo.module.path), _THREAD_SANCTIONED):
            continue
        spawn_line = None
        for node in walk_function(finfo.node):
            if isinstance(node, ast.Call) and _is_thread_construction(finfo, node):
                spawn_line = node.lineno
                break
        if spawn_line is None:
            continue
        if fqn in gated or (callers.get(fqn, set()) & gated):
            continue
        out[fqn] = spawn_line
    return out


# ---------------------------------------------------------------------------
# picklability / closure-capture audit
# ---------------------------------------------------------------------------


def _class_unpicklable_state(
    program: Program, index: LockIndex, modname: str, cls: Optional[str]
) -> Optional[str]:
    """Why shipping an instance of ``cls`` across a process boundary
    fails (it holds a lock/socket/generator), or None."""
    if cls is None:
        return None
    if any(s.module == modname and s.class_name == cls for s in index.sites):
        return f"{cls} owns a lock"
    minfo = program.modules.get(modname)
    if minfo is None or cls not in minfo.classes:
        return None
    init = minfo.classes[cls].methods.get("__init__")
    if init is None:
        return None
    for node in walk_function(init.node):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        target, value = node.targets[0], node.value
        if not (
            isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"
        ):
            continue
        if isinstance(value, ast.GeneratorExp):
            return f"{cls}.{target.attr} holds a generator"
        if isinstance(value, ast.Call):
            origin = minfo.imports.resolve_call_target(value.func)
            if origin is not None:
                if origin.startswith("socket.") or origin.endswith(".socket"):
                    return f"{cls}.{target.attr} holds a socket"
                if origin.endswith((".Lock", ".RLock", ".Condition")) or origin.endswith(
                    ("make_lock", "make_rlock")
                ):
                    return f"{cls}.{target.attr} holds a lock"
    return None


def _classify_submission_callable(
    program: Program,
    index: LockIndex,
    finfo: FunctionInfo,
    expr: Optional[ast.expr],
) -> Optional[tuple[str, str]]:
    """(kind, why) when a process pool could not ship ``expr``; None
    when it is (or must be presumed) picklable."""
    if expr is None:
        return None
    minfo = finfo.module
    if isinstance(expr, ast.Lambda):
        return (
            "lambda",
            "a lambda pickles by reference, not value — a process-pool "
            "submission would fail to reconstruct it in the worker",
        )
    if isinstance(expr, ast.Attribute):
        if isinstance(expr.value, ast.Name) and expr.value.id in ("self", "cls"):
            holds = _class_unpicklable_state(
                program, index, minfo.modname, finfo.class_name
            )
            if holds is not None:
                return (
                    "bound-method",
                    f"bound method drags its instance across the boundary and "
                    f"{holds}",
                )
            return (
                "bound-method",
                "bound method drags its whole instance across the boundary",
            )
        return (
            "bound-method",
            "bound method drags its receiver across the boundary",
        )
    if isinstance(expr, ast.Name):
        scope = finfo.local_qual
        while scope:
            nested = minfo.functions.get(f"{scope}.{expr.id}")
            if nested is not None:
                return (
                    "closure",
                    "nested function — its closure cells cannot cross a "
                    "process boundary",
                )
            scope = scope.rpartition(".")[0]
    return None


def picklability_audit(
    program: Program, index: LockIndex
) -> tuple[list[dict], list[Finding]]:
    """Every executor submission site (``<pool|executor>.submit/map``)
    with an unpicklable callable.  Sites whose enclosing function
    consults ``clockseam.threads_enabled()`` are seam-gated (recorded,
    not findings); an inline ``# agac-lint:
    ignore[cross-boundary-capture] -- reason`` suppresses both this
    audit and the per-file lint rule with one comment."""
    sites: list[dict] = []
    findings: list[Finding] = []
    for fqn, finfo in sorted(program.functions.items()):
        minfo = finfo.module
        if _single_threaded_module(str(minfo.path)):
            continue
        seam_gated = _calls_threads_enabled(finfo)
        for node in walk_function(finfo.node):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if (
                not isinstance(func, ast.Attribute)
                or func.attr not in _SUBMISSION_METHODS
            ):
                continue
            recv = func.value
            recv_name = None
            if isinstance(recv, ast.Name):
                recv_name = recv.id
            elif isinstance(recv, ast.Attribute):
                recv_name = recv.attr
            if recv_name is None or not _POOLISH.search(recv_name):
                continue
            classified = _classify_submission_callable(
                program, index, finfo, node.args[0] if node.args else None
            )
            if classified is None:
                continue
            kind, why = classified
            lines = minfo.parsed.source_lines
            suppressed = None
            if 1 <= node.lineno <= len(lines):
                m = _SUPPRESS_RE.search(lines[node.lineno - 1])
                if m:
                    suppressed = m.group("why")
            sites.append(
                {
                    "fqn": fqn,
                    "path": str(minfo.path),
                    "line": node.lineno,
                    "receiver": recv_name,
                    "kind": kind,
                    "why": why,
                    "seam_gated": seam_gated,
                    "suppressed": suppressed,
                }
            )
            if seam_gated or suppressed is not None:
                continue
            findings.append(
                Finding(
                    ANALYSIS,
                    "unpicklable-boundary",
                    str(minfo.path),
                    node.lineno,
                    f"unpicklable-boundary::{fqn}::{kind}",
                    f"{fqn} submits a {kind} to {recv_name}.{func.attr} — {why}"
                    " (gate the submission on clockseam.threads_enabled() or "
                    "pass a module-level function)",
                )
            )
    return sites, findings


# ---------------------------------------------------------------------------
# escape analysis: worker-scope constructions flowing into shared state
# ---------------------------------------------------------------------------


def _local_mutable_bindings(
    program: Program, finfo: FunctionInfo
) -> dict[str, str]:
    """Local name -> mutable value type for fresh constructions bound
    in this function (``obj = {}``, ``batch = SomeClass()``, …)."""
    out: dict[str, str] = {}
    for node in walk_function(finfo.node):
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
        ):
            vtype = _value_type(finfo.module, node.value, program)
            if vtype is not None:
                out[node.targets[0].id] = vtype
    return out


def _escaping_value(
    program: Program, finfo: FunctionInfo, locals_m: dict[str, str], expr: ast.expr
) -> Optional[str]:
    """The mutable value type when ``expr`` is a locally-constructed
    object (directly, or a local bound to one), else None."""
    if isinstance(expr, ast.Name):
        return locals_m.get(expr.id)
    return _value_type(finfo.module, expr, program)


def escape_analysis(
    program: Program,
    worker_fqns: set[str],
    census_entries: list[dict],
) -> tuple[list[dict], list[Finding]]:
    """Constructions inside worker scope that escape into census
    entries (module globals / shared instance attrs) or thread spawns.
    Escapes into UNSAFE entries are findings; the rest document the
    publication points the multi-core result protocol must cover."""
    bucket_of = {e["name"]: e["bucket"] for e in census_entries}
    globals_by_mod: dict[str, dict[str, str]] = {}
    attrs_by_cls: dict[tuple[str, str], dict[str, str]] = {}
    for e in census_entries:
        if e["kind"] == "module-global":
            mod, var = e["name"].rsplit(".", 1)
            globals_by_mod.setdefault(mod, {})[var] = e["name"]
        elif e["kind"] == "instance-attr":
            parts = e["name"].rsplit(".", 2)
            if len(parts) == 3:
                attrs_by_cls.setdefault((parts[0], parts[1]), {})[parts[2]] = e[
                    "name"
                ]

    escapes: list[dict] = []
    findings: list[Finding] = []

    def record(finfo: FunctionInfo, kind: str, target: str, line: int, vtype: str):
        escapes.append(
            {
                "function": finfo.fqn,
                "kind": kind,
                "target": target,
                "line": line,
                "value_type": vtype,
            }
        )
        if bucket_of.get(target) == "UNSAFE":
            findings.append(
                Finding(
                    ANALYSIS,
                    "worker-scope-escape",
                    str(finfo.module.path),
                    line,
                    f"worker-scope-escape::{finfo.fqn}::{target}",
                    f"{finfo.fqn} publishes a locally constructed {vtype} "
                    f"into UNSAFE shared state {target} — confine it, or "
                    "guard/seam the target first",
                )
            )

    for fqn in sorted(worker_fqns):
        finfo = program.functions.get(fqn)
        if finfo is None:
            continue
        minfo = finfo.module
        if _single_threaded_module(str(minfo.path)) or _sanctioned(
            str(minfo.path), _THREAD_SANCTIONED
        ):
            continue
        own_globals = globals_by_mod.get(minfo.modname, {})
        own_attrs = (
            attrs_by_cls.get((minfo.modname, finfo.class_name), {})
            if finfo.class_name is not None
            else {}
        )
        locals_m = _local_mutable_bindings(program, finfo)
        declared_global: set[str] = set()
        for node in walk_function(finfo.node):
            if isinstance(node, (ast.Global, ast.Nonlocal)):
                declared_global.update(node.names)
        for node in walk_function(finfo.node):
            if isinstance(node, ast.Assign):
                for target in node.targets:
                    vtype = _escaping_value(program, finfo, locals_m, node.value)
                    if vtype is None:
                        continue
                    base = target
                    if isinstance(base, ast.Subscript):
                        base = base.value
                    if isinstance(base, ast.Name):
                        if base.id in own_globals and (
                            base.id in declared_global
                            or isinstance(target, ast.Subscript)
                        ):
                            record(
                                finfo,
                                "module-global",
                                own_globals[base.id],
                                node.lineno,
                                vtype,
                            )
                    elif (
                        isinstance(base, ast.Attribute)
                        and isinstance(base.value, ast.Name)
                        and base.value.id in ("self", "cls")
                        and base.attr in own_attrs
                    ):
                        record(
                            finfo,
                            "shared-attr",
                            own_attrs[base.attr],
                            node.lineno,
                            vtype,
                        )
            elif isinstance(node, ast.Call):
                func = node.func
                if (
                    isinstance(func, ast.Attribute)
                    and func.attr in ("append", "add", "update", "setdefault")
                    and isinstance(func.value, ast.Name)
                    and func.value.id in own_globals
                ):
                    for arg in node.args:
                        vtype = _escaping_value(program, finfo, locals_m, arg)
                        if vtype is not None:
                            record(
                                finfo,
                                "module-global",
                                own_globals[func.value.id],
                                node.lineno,
                                vtype,
                            )
                            break
                elif _is_thread_construction(finfo, node):
                    target_expr = next(
                        (kw.value for kw in node.keywords if kw.arg == "target"),
                        None,
                    )
                    if isinstance(target_expr, ast.Lambda):
                        record(
                            finfo, "thread-capture", "<lambda>", node.lineno, "lambda"
                        )
                    elif isinstance(target_expr, ast.Name):
                        scope = finfo.local_qual
                        while scope:
                            if minfo.functions.get(f"{scope}.{target_expr.id}"):
                                record(
                                    finfo,
                                    "thread-capture",
                                    target_expr.id,
                                    node.lineno,
                                    "closure",
                                )
                                break
                            scope = scope.rpartition(".")[0]
    return escapes, findings


# ---------------------------------------------------------------------------
# the footprint table
# ---------------------------------------------------------------------------


def build_confinement(program: Program) -> tuple[dict, list[Finding]]:
    census_block, _ = build_census(program)
    census_entries = census_block["census"]
    index = LockIndex(program)
    entry_points = stage_entry_points(program)
    access = _entry_access_index(program, census_entries)
    spawners = unseamed_spawners(program)
    pickle_sites, pickle_findings = picklability_audit(program, index)
    unsafe_names = {e["name"] for e in census_entries if e["bucket"] == "UNSAFE"}
    # unpicklable, unsuppressed, unseamed submission sites by fqn
    hard_pickle_fqns = {
        s["fqn"]
        for s in pickle_sites
        if not s["seam_gated"] and s["suppressed"] is None
    }

    stages: dict[str, dict] = {}
    findings: list[Finding] = list(pickle_findings)
    worker_fqns: set[str] = set()
    for stage_name in (*STAGE_CATALOG, API_STAGE_FAMILY):
        fqns = entry_points[stage_name]
        closure: set[str] = set(fqns)
        for fqn in fqns:
            closure |= program.transitive_callees(fqn, fallback=True)
        worker_fqns |= closure
        writes = sorted(
            name
            for name, acc in access.items()
            if acc["writes"] & closure
        )
        reads = sorted(
            name
            for name, acc in access.items()
            if (acc["reads"] & closure) and name not in writes
        )
        touched_classes = sorted(
            {
                f"{program.functions[fqn].module.modname}::"
                f"{program.functions[fqn].class_name}"
                for fqn in closure
                if fqn in program.functions
                and program.functions[fqn].class_name is not None
            }
        )
        spawns_here = sorted(f for f in spawners if f in closure)
        pickles_here = sorted(f for f in hard_pickle_fqns if f in closure)
        unsafe_written = sorted(n for n in writes if n in unsafe_names)
        why_parts: list[str] = []
        if unsafe_written:
            why_parts.append(f"writes UNSAFE state: {', '.join(unsafe_written)}")
        if spawns_here:
            why_parts.append(
                "spawns threads outside the clockseam gate: "
                + ", ".join(spawns_here[:3])
            )
        if pickles_here:
            why_parts.append(
                "ships unpicklable callables at executor boundaries: "
                + ", ".join(pickles_here[:3])
            )
        if why_parts:
            verdict = "unportable"
            why = "; ".join(why_parts)
        elif writes:
            verdict = "write-shared"
            why = (
                f"writes {len(writes)} census entr"
                f"{'y' if len(writes) == 1 else 'ies'} — portable only with "
                "a result-message protocol"
            )
        elif reads:
            verdict = "read-shared"
            why = (
                f"reads {len(reads)} census entr"
                f"{'y' if len(reads) == 1 else 'ies'} — portable with "
                "snapshot/ship-inputs"
            )
        else:
            verdict = "confined"
            why = "touches no census entry"
        stages[stage_name] = {
            "entry_points": sorted(fqns),
            "closure_size": len(closure),
            "reads": reads,
            "writes": writes,
            "touched_classes": touched_classes,
            "verdict": verdict,
            "why": why,
        }
        # an unportable verdict on a MULTI_CORE_CANDIDATES stage gates
        # via the report's ``unportable_stages`` key (build_report), the
        # unsafe_census precedent: it cannot be baselined away

    escapes, escape_findings = escape_analysis(
        program, worker_fqns, census_entries
    )
    findings.extend(escape_findings)
    block = {
        "stages": stages,
        "multi_core_candidates": list(MULTI_CORE_CANDIDATES),
        "worker_scope": len(worker_fqns),
        "unseamed_spawners": {fqn: line for fqn, line in sorted(spawners.items())},
        "picklability": pickle_sites,
        "escapes": escapes,
    }
    return block, findings


# ---------------------------------------------------------------------------
# runtime cross-check (racecheck stage-tagged accesses <-> static table)
# ---------------------------------------------------------------------------


def crosscheck_stage_accesses(
    stages: dict[str, dict],
    index: LockIndex,
    accesses: Iterable[tuple[tuple[str, ...], str]],
) -> tuple[list[str], list[str]]:
    """Compare racecheck's observed ``(active stage brackets, guarded
    table name)`` mutation records against the static footprint table.
    A write is covered when ANY active stage's closure touches the
    class owning the guarded table (stages nest: the innermost bracket
    is often an ``aws:*`` child of ``driver-mutate``).  Returns
    ``(violations, unmapped)``; unmapped names/stages are diagnostics,
    not failures — the ``lockorder.runtime_crosscheck`` contract."""
    violations: list[str] = []
    unmapped: list[str] = []
    for stage_names, table_name in accesses:
        site = index.runtime_site(table_name)
        if site is None or site.class_name is None:
            unmapped.append(table_name)
            continue
        owner = f"{site.module}::{site.class_name}"
        known = [
            API_STAGE_FAMILY
            if name.startswith("aws:")
            else name
            for name in stage_names
        ]
        footprints = [stages.get(name) for name in known]
        if not footprints or any(fp is None for fp in footprints):
            unmapped.extend(n for n, fp in zip(known, footprints) if fp is None)
            continue
        if any(owner in fp["touched_classes"] for fp in footprints):
            continue
        violations.append(
            f"observed write to {table_name!r} (owned by {owner}) under stage "
            f"bracket(s) {list(stage_names)!r}, but no active stage's static "
            "closure touches that class — the footprint table has a "
            "call-graph blind spot"
        )
    return violations, sorted(set(unmapped))


_CROSSCHECK_CACHE: Optional[tuple[dict, LockIndex]] = None


def runtime_footprint_crosscheck(
    accesses: Iterable[tuple[tuple[str, ...], str]],
) -> tuple[list[str], list[str]]:
    """One-call bridge for the chaos/soak teardowns: build the static
    footprint table over the installed ``agac_tpu_torch`` package (once per
    process, shared parse cache) and verify every stage-tagged observed
    mutation lands inside some active stage's declared footprint."""
    global _CROSSCHECK_CACHE
    if _CROSSCHECK_CACHE is None:
        from .program import shared_cache

        pkg_root = Path(__file__).resolve().parent.parent
        program = Program.build([pkg_root], shared_cache())
        block, _ = build_confinement(program)
        _CROSSCHECK_CACHE = (block["stages"], LockIndex(program))
    stages, index = _CROSSCHECK_CACHE
    return crosscheck_stage_accesses(stages, index, accesses)


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------


@program_rule(
    "confinement",
    "cross-process confinement: per-stage shared-state footprints (the "
    "multi-core dispatch plan), worker-scope escape analysis, and the "
    "picklability audit over executor submission boundaries",
)
def check_confinement(program: Program):
    block, findings = build_confinement(program)
    return findings, block
