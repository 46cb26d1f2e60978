"""Controller-invariant lint rules (the registry ``lint.py`` walks).

Each rule is a small AST pass over one module.  These are the
invariants that have actually broken (or would break) this controller
stack — the classes ruff's pyflakes-tier cannot express:

- ``raw-backend-call`` — controllers must reach AWS through the
  rate-limited ``AWSDriver`` handed out by the cloud factory, never a
  backend implementation directly; a raw call bypasses shaping,
  retry/backoff and the call-accounting every bench/e2e tier relies on.
- ``bare-lock-acquire`` — ``threading`` locks/conditions are acquired
  with ``with``; a bare ``.acquire()`` without a ``finally`` release
  leaks the lock on any exception path and deadlocks the fleet.
- ``blocking-reconcile`` — no ``time.sleep`` inside a reconcile/process
  handler: workers are a fixed pool, so a sleeping handler stalls every
  other key; requeue with ``Result(requeue_after=...)`` or inject a
  deadline-bounded sleep seam instead.
- ``reconcile-returns-result`` — a handler annotated ``-> Result`` must
  return one on every path; a fall-through returns ``None`` and the
  retry policy silently treats the item as synced.
- ``unguarded-optional-import`` — a module-level import of a
  third-party package CI never pip-installs (hypothesis imported at
  module scope, installed nowhere) breaks collection on
  every push while working locally.  Guard it (function scope /
  try-ImportError / importorskip) or add it to the workflow install.
- ``drift-read-outside-read-plane`` — driver code may not issue raw
  per-item ``list_*``/``describe_*`` service reads outside the
  coalesced read plane's loader/sanctioned functions: a
  stray raw read in an ensure/verify path silently reintroduces the
  O(N)-calls-per-tick regression the read plane exists to kill, and
  nothing else fails — the fleet just pays 4x the quota again.
- ``unbounded-poll-loop`` — any while/sleep poll loop in
  ``cloudprovider/`` or ``controllers/`` must consult a deadline or
  the health plane: an unbounded poll against a wedged
  backend holds its worker forever with no signal — exactly the
  180 s-settle-poll wedge the reconcile deadline exists to cut.
- ``unregistered-metric`` — Counter/Gauge/Histogram primitives must be
  built through the shared observability registry with literal names
  and label tuples: a directly constructed metric silently
  never reaches ``/metrics`` (the exact private-counter drift the
  observability plane deletes), and a computed label set is how a
  key/error-text cardinality explosion melts the scrape.
- ``unseamed-clock`` — direct ``time.time()`` / ``time.monotonic()`` /
  ``time.sleep()`` / ``threading.Timer`` outside the clock seam
  (``clockseam.py``), the sim runtime and the sanctioned
  real-I/O edges: one raw wall-clock read in a reconcile
  path silently de-virtualizes the deterministic simulation runtime —
  scenarios stop replaying byte-identically and the 7-day virtual
  soak quietly waits on the real clock.
- ``delete-without-ownership-check`` — teardown calls reachable from
  the GC sweeper (``controllers/garbagecollector.py``) must flow
  through an ownership-verification helper: the sweeper is
  the only controller that deletes resources NOBODY asked it to touch,
  so a deletion decided on stale/cached claims alone would be the
  worst bug this codebase can ship — destroying a live cluster's
  resources with no event trail.

- ``journey-stage-without-stamp`` — reconcile-loop paths that requeue,
  park, or drop an item (``add_rate_limited``/``add_after``/``park``
  in ``reconcile/reconcile.py``/``reconcile/pending.py``) must record
  a journey stage: the convergence-latency SLO derives its
  end-to-end measurement from these stamps, so an unstamped movement
  is latency the /slo drill-down can never explain — exactly the slow
  path the plane exists to surface.

- ``cross-shard-sweep`` — GC sweeps and drift-tick enumeration paths
  (``controllers/garbagecollector.py``'s ``_sweep_*`` phases,
  ``manager.py``'s ``drift_tick``/``reshard_resync``, every
  controller's ``drift_resync_sources``) must consult the shard
  filter: these are the paths that enumerate the WHOLE
  fleet, so one that forgets the ownership predicate silently makes
  every replica work (or worse, sweep) every key — the exact
  duplicate-mutation/foreign-deletion class sharding must exclude.
  Single-shard deployments are covered by the same filter
  (``OWNS_ALL``); a genuinely single-process enumeration path carries
  a sanctioned suppression instead.

- ``unattributed-stage`` — ``profile.stage(...)`` calls must pass a
  literal stage name present in the catalog in
  ``observability/profile.py``: stage names are metric
  labels, so a computed name is a cardinality risk and an uncataloged
  one is CPU the attribution table, docs and bench rails silently
  never account for.  Dynamic per-AWS-op stages flow through
  ``profile.api_stage(service, op)`` instead.

- ``unexplained-requeue`` — requeue/park/skip decisions in
  ``reconcile/`` and ``controllers/`` (``add_rate_limited`` /
  ``add_after`` / ``park`` calls, and ``Result`` values carrying
  ``requeue``/``requeue_after``/``skip``) must attach a literal reason
  code from the explain catalog in ``observability/explain.py``:
  the explain plane classifies a blocked object from the
  structured reason recorded where its fate was decided, so an
  unexplained (or computed) movement is a key ``/debug/explain`` can
  only shrug at — exactly the ``unknown`` verdict the catalog forbids.

- ``untapped-external-input`` — the seams where external inputs enter
  the process (informer event delivery via ``apply_event``, AWS call
  outcome classification via ``record_call``, signal registration via
  ``signal.signal``) must route through the incident-capture tap
  (``sim/capture.py``): the replay tape is only as complete
  as its taps, so an input consumed past the tap turns every captured
  incident into an unexplained divergence at replay time.

Suppression: append ``# agac-lint: ignore[rule-id] -- justification``
to the offending line.  The justification is mandatory.
"""

from __future__ import annotations

import ast
import builtins
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterator, Optional

from .program import PACKAGE_ROOTS, ImportMap, in_package, package_paths


@dataclass(frozen=True)
class Violation:
    rule: str
    path: str
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class LintContext:
    """Everything a rule may need beyond the AST."""

    path: Path
    source_lines: list[str]
    # import names CI installs (pip lines across .github/workflows/*)
    ci_installed: frozenset[str]
    # top-level import names that belong to this repo
    first_party: frozenset[str] = frozenset({*PACKAGE_ROOTS, "tests", "bench"})
    # the module tree, set by the driver; rules walk it via walk()
    tree: Optional[ast.Module] = None
    imports: Optional[ImportMap] = None
    _nodes: Optional[list[ast.AST]] = field(default=None, repr=False)

    def walk(self) -> list[ast.AST]:
        """Materialized ``ast.walk`` of the module, computed once and
        shared by every rule — previously each of the 13 rules re-walked
        the tree independently, dominating lint-invariants wall time."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes

    def import_map(self) -> ImportMap:
        """Shared import-provenance map (replaces the per-rule import
        walkers the early rules each grew)."""
        if self.imports is None:
            self.imports = ImportMap(self.tree)
        return self.imports


@dataclass(frozen=True)
class Rule:
    id: str
    summary: str
    check: Callable[[ast.Module, LintContext], Iterator[Violation]]


RULES: list[Rule] = []


def rule(id: str, summary: str):
    def register(fn):
        RULES.append(Rule(id, summary, fn))
        return fn

    return register


# ---------------------------------------------------------------------------
# raw-backend-call
# ---------------------------------------------------------------------------

# the raw service operations (cloudprovider/aws/api.py) —
# kept as a literal so the linter never imports the package it lints
RAW_API_OPS = frozenset(
    {
        "list_accelerators", "describe_accelerator", "create_accelerator",
        "update_accelerator", "delete_accelerator", "list_tags_for_resource",
        "tag_resource", "list_listeners", "create_listener", "update_listener",
        "delete_listener", "list_endpoint_groups", "describe_endpoint_group",
        "create_endpoint_group", "update_endpoint_group",
        "delete_endpoint_group", "add_endpoints", "remove_endpoints",
        "describe_load_balancers", "list_hosted_zones",
        "list_hosted_zones_by_name", "list_resource_record_sets",
        "change_resource_record_sets",
    }
)

_BACKEND_MODULES = ("fake_backend", "real_backend")
_BACKEND_NAMES = ("FakeAWSBackend", "RealAWSBackend")
# receiver names that denote a raw service handle rather than the
# driver: the driver's own api attributes (driver.ga / .elbv2 /
# .route53) and the obvious spellings of a smuggled backend object.
# The driver mirrors several op names as shaped wrapper methods
# (cloud.describe_endpoint_group), so the op name alone is not enough.
_RAW_RECEIVERS = re.compile(r"^(ga|elbv2|route53)$|backend|aws_api", re.IGNORECASE)


def _in_controllers(ctx: LintContext) -> bool:
    return "controllers" in ctx.path.parts


@rule(
    "raw-backend-call",
    "controllers must call AWS through the driver (cloud_factory seam), "
    "never a backend implementation or raw service op",
)
def check_raw_backend_call(tree: ast.Module, ctx: LintContext) -> Iterator[Violation]:
    if not _in_controllers(ctx):
        return
    for node in ctx.walk():
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            module = getattr(node, "module", "") or ""
            names = [a.name for a in node.names]
            pieces = module.split(".") + [n for name in names for n in name.split(".")]
            hit = next(
                (p for p in pieces if p in _BACKEND_MODULES or p in _BACKEND_NAMES),
                None,
            )
            if hit:
                yield Violation(
                    "raw-backend-call",
                    str(ctx.path),
                    node.lineno,
                    f"controller imports backend {hit!r}; inject an AWSDriver "
                    "via cloud_factory instead",
                )
        elif isinstance(node, ast.Call):
            func = node.func
            if not (isinstance(func, ast.Attribute) and func.attr in RAW_API_OPS):
                continue
            receiver = _terminal_name(func.value)
            if receiver is None or not _RAW_RECEIVERS.search(receiver):
                continue
            yield Violation(
                "raw-backend-call",
                str(ctx.path),
                node.lineno,
                f"raw AWS service op {receiver}.{func.attr}() called from a "
                "controller; go through the rate-limited driver",
            )


# ---------------------------------------------------------------------------
# bare-lock-acquire
# ---------------------------------------------------------------------------

_LOCKISH = re.compile(r"(lock|mutex|cond|sem)", re.IGNORECASE)


def _terminal_name(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


@rule(
    "bare-lock-acquire",
    "threading locks must be acquired via `with`; bare acquire()/release() "
    "leaks the lock on exception paths",
)
def check_bare_lock_acquire(tree: ast.Module, ctx: LintContext) -> Iterator[Violation]:
    for node in ctx.walk():
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        if node.func.attr not in ("acquire", "release"):
            continue
        target = _terminal_name(node.func.value)
        if target is None or not _LOCKISH.search(target):
            continue
        yield Violation(
            "bare-lock-acquire",
            str(ctx.path),
            node.lineno,
            f"bare {target}.{node.func.attr}() — use `with {target}:` so every "
            "exit path releases",
        )


# ---------------------------------------------------------------------------
# blocking-reconcile
# ---------------------------------------------------------------------------

_RECONCILE_NAME = re.compile(r"^_?(process_|reconcile|sync_)")


@rule(
    "blocking-reconcile",
    "no time.sleep inside reconcile/process handlers — requeue with "
    "Result(requeue_after=...) or inject a deadline-bounded sleep seam",
)
def check_blocking_reconcile(tree: ast.Module, ctx: LintContext) -> Iterator[Violation]:
    for fn in ctx.walk():
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not _RECONCILE_NAME.match(fn.name):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if (
                isinstance(func, ast.Attribute)
                and func.attr == "sleep"
                and isinstance(func.value, ast.Name)
                and func.value.id == "time"
            ):
                yield Violation(
                    "blocking-reconcile",
                    str(ctx.path),
                    node.lineno,
                    f"time.sleep inside reconcile handler {fn.name!r} stalls "
                    "a shared worker; use requeue_after or an injected sleep",
                )


# ---------------------------------------------------------------------------
# reconcile-returns-result
# ---------------------------------------------------------------------------


def _returns_result(fn: ast.FunctionDef) -> bool:
    ann = fn.returns
    if isinstance(ann, ast.Name):
        return ann.id == "Result"
    if isinstance(ann, ast.Attribute):
        return ann.attr == "Result"
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.split(".")[-1] == "Result"
    return False


def _terminates(stmts: list[ast.stmt]) -> bool:
    """Conservative all-paths-return/raise check over a statement list."""
    for stmt in stmts:
        if isinstance(stmt, (ast.Return, ast.Raise)):
            return True
        if isinstance(stmt, ast.If):
            if stmt.orelse and _terminates(stmt.body) and _terminates(stmt.orelse):
                return True
        elif isinstance(stmt, ast.Try):
            handlers_ok = all(_terminates(h.body) for h in stmt.handlers)
            body_ok = _terminates(stmt.body + stmt.orelse)
            if stmt.finalbody and _terminates(stmt.finalbody):
                return True
            if body_ok and handlers_ok:
                return True
        elif isinstance(stmt, ast.With):
            if _terminates(stmt.body):
                return True
        elif isinstance(stmt, ast.While):
            # `while True:` with no break never falls through
            is_true = isinstance(stmt.test, ast.Constant) and stmt.test.value is True
            if is_true and not any(
                isinstance(n, ast.Break)
                for n in ast.walk(stmt)
                if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            ):
                return True
        elif isinstance(stmt, ast.Match):
            cases = stmt.cases
            has_catch_all = any(
                isinstance(c.pattern, ast.MatchAs) and c.pattern.pattern is None
                for c in cases
            )
            if has_catch_all and all(_terminates(c.body) for c in cases):
                return True
    return False


@rule(
    "reconcile-returns-result",
    "a handler annotated `-> Result` must return a Result on every path",
)
def check_reconcile_returns_result(
    tree: ast.Module, ctx: LintContext
) -> Iterator[Violation]:
    for fn in ctx.walk():
        if not isinstance(fn, ast.FunctionDef) or not _returns_result(fn):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Return) and node.value is None:
                yield Violation(
                    "reconcile-returns-result",
                    str(ctx.path),
                    node.lineno,
                    f"bare `return` in {fn.name!r} yields None where a Result "
                    "is promised",
                )
        if not _terminates(fn.body):
            yield Violation(
                "reconcile-returns-result",
                str(ctx.path),
                fn.lineno,
                f"{fn.name!r} can fall off the end without returning a Result",
            )


# ---------------------------------------------------------------------------
# unguarded-optional-import
# ---------------------------------------------------------------------------

_STDLIB = frozenset(sys.stdlib_module_names) | {"__future__"}


@rule(
    "unguarded-optional-import",
    "module-level import of a third-party package CI never installs — "
    "works locally, breaks collection on every push",
)
def check_unguarded_optional_import(
    tree: ast.Module, ctx: LintContext
) -> Iterator[Violation]:
    # only statements at true module scope: imports inside functions,
    # try/except ImportError, or `if` guards are by definition guarded
    for stmt in tree.body:
        if isinstance(stmt, ast.Import):
            names = [a.name.split(".")[0] for a in stmt.names]
        elif isinstance(stmt, ast.ImportFrom):
            if stmt.level:  # relative import — first-party
                continue
            names = [(stmt.module or "").split(".")[0]]
        else:
            continue
        for name in names:
            if not name or name in _STDLIB or name in ctx.first_party:
                continue
            if name in ctx.ci_installed:
                continue
            yield Violation(
                "unguarded-optional-import",
                str(ctx.path),
                stmt.lineno,
                f"module-level import of {name!r}, which no CI workflow "
                "pip-installs; guard it or add it to the install line",
            )


# ---------------------------------------------------------------------------
# drift-read-outside-read-plane
# ---------------------------------------------------------------------------

# The driver functions sanctioned to issue raw service reads
# (``self.ga.* / self.elbv2.* / self.route53.*``):
#
# - read-plane loaders (single-flight cache fill / verify reads):
#   the discovery snapshot, the chain lookups `_verified_chain`
#   composes, the per-zone record drain, the batched LB describe, and
#   the hosted-zone walks;
# - teardown and read-modify-write paths that are NOT drift-tick reads:
#   `_list_related`/`_delete_accelerator` (cleanup orchestration) and
#   `update_endpoint_weight` (full-set weight write needs the current
#   set);
# - `describe_endpoint_group`: the EndpointGroupBinding verify read —
#   one call per binding per tick, keyed by an arn the topology cache
#   cannot resolve, and GA offers no batch variant.
# - `verify_accelerator_orphan`: the GC sweeper's pre-deletion
#   ownership verify — one live tag read per confirmed
#   orphan, deliberately OUTSIDE the caches: a deletion decision must
#   never rest on a cached ownership claim.
#
# Anything else in driver.py touching a raw list_*/describe_* op is a
# coalescing regression and must either go through the read plane or
# carry a justified suppression.
_READ_PLANE_FUNCS = frozenset(
    {
        "_list_accelerators", "_load_discovery_snapshot",
        "get_listener", "get_endpoint_group",
        "_fetch_record_sets", "_describe_load_balancers",
        "_list_all_hosted_zones", "_walk_hosted_zone",
        "_list_related", "_delete_accelerator", "_blocking_settle_poll",
        "update_endpoint_weight", "describe_endpoint_group",
        "verify_accelerator_orphan",
    }
)

_RAW_READ_OP = re.compile(r"^(list_|describe_)")
_RAW_SERVICE_HANDLES = frozenset({"ga", "elbv2", "route53"})


def _is_aws_driver_module(ctx: LintContext) -> bool:
    return "cloudprovider" in ctx.path.parts and ctx.path.name == "driver.py"


@rule(
    "drift-read-outside-read-plane",
    "driver code must route per-item list_*/describe_* service reads "
    "through the coalesced read plane's loaders, not issue them raw",
)
def check_drift_read_outside_read_plane(
    tree: ast.Module, ctx: LintContext
) -> Iterator[Violation]:
    if not _is_aws_driver_module(ctx):
        return
    sanctioned: set[int] = set()  # ids of Call nodes inside sanctioned defs
    for fn in ctx.walk():
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if fn.name in _READ_PLANE_FUNCS:
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    sanctioned.add(id(node))
    for node in ctx.walk():
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        func = node.func
        if not _RAW_READ_OP.match(func.attr):
            continue
        receiver = _terminal_name(func.value)
        if receiver not in _RAW_SERVICE_HANDLES:
            continue
        if id(node) in sanctioned:
            continue
        yield Violation(
            "drift-read-outside-read-plane",
            str(ctx.path),
            node.lineno,
            f"raw {receiver}.{func.attr}() outside the read plane's "
            "sanctioned loaders — route it through the coalesced caches "
            "(AcceleratorTopologyCache / RecordSetCache / "
            "LoadBalancerCoalescer) or add it to _READ_PLANE_FUNCS with "
            "justification",
        )


# ---------------------------------------------------------------------------
# unbounded-poll-loop
# ---------------------------------------------------------------------------

# sleep-ish call targets: time.sleep, an injected self._sleep seam, a
# bare sleep(...) name
_SLEEPISH = re.compile(r"sleep", re.IGNORECASE)
# what counts as consulting a bound: a deadline variable/comparison
# (`deadline`, `check_deadline`, `deadline_remaining`) or the health
# plane (`health`, `api_health`, a breaker/circuit handle)
_DEADLINEISH = re.compile(r"deadline|health|circuit|breaker", re.IGNORECASE)


def _call_target_name(node: ast.Call) -> Optional[str]:
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    if isinstance(node.func, ast.Name):
        return node.func.id
    return None


@rule(
    "unbounded-poll-loop",
    "a while/sleep poll loop in cloudprovider/ or controllers/ must consult "
    "a deadline or the health plane — an unbounded poll wedges its worker",
)
def check_unbounded_poll_loop(tree: ast.Module, ctx: LintContext) -> Iterator[Violation]:
    parts = ctx.path.parts
    if "cloudprovider" not in parts and "controllers" not in parts:
        return
    for node in ctx.walk():
        if not isinstance(node, ast.While):
            continue
        sleeps = any(
            isinstance(inner, ast.Call)
            and (name := _call_target_name(inner)) is not None
            and _SLEEPISH.search(name)
            for inner in ast.walk(node)
        )
        if not sleeps:
            continue
        consults = any(
            (isinstance(inner, ast.Name) and _DEADLINEISH.search(inner.id))
            or (isinstance(inner, ast.Attribute) and _DEADLINEISH.search(inner.attr))
            for inner in ast.walk(node)
        )
        if consults:
            continue
        yield Violation(
            "unbounded-poll-loop",
            str(ctx.path),
            node.lineno,
            "poll loop sleeps without consulting a deadline or the health "
            "plane — a wedged backend holds this worker forever; check "
            "`api_health.check_deadline(...)` (or a local deadline) each turn",
        )


# ---------------------------------------------------------------------------
# blocking-settle-in-worker
# ---------------------------------------------------------------------------

# a settle loop re-checks remote state between sleeps: the read half
_SETTLE_RECHECK = re.compile(r"^(describe_|list_)")


@rule(
    "blocking-settle-in-worker",
    "settle/wait loops (sleep + describe/list re-check) may not run in "
    "process_next_work_item-reachable code — park the item in the "
    "pending-settle table (reconcile/pending.py) instead of holding a worker",
)
def check_blocking_settle_in_worker(
    tree: ast.Module, ctx: LintContext
) -> Iterator[Violation]:
    """The async mutation pipeline exists so workers never
    sleep through AWS wait states.  Any ``while`` loop that both
    sleeps AND re-reads remote state (``describe_*``/``list_*``) in
    ``cloudprovider/``, ``controllers/`` or ``reconcile/`` is a settle
    poll holding a worker — it must raise ``SettleWait`` and let the
    poll-tick scheduler re-check parked chains coalesced.  The
    scheduler itself (``reconcile/pending.py``) is the one sanctioned
    home; the driver's reference-parity fallback carries an explicit
    justified suppression."""
    parts = ctx.path.parts
    if (
        "cloudprovider" not in parts
        and "controllers" not in parts
        and "reconcile" not in parts
    ):
        return
    if ctx.path.name == "pending.py" and "reconcile" in parts:
        return  # the pending-settle scheduler is the sanctioned home
    for node in ctx.walk():
        if not isinstance(node, ast.While):
            continue
        sleeps = any(
            isinstance(inner, ast.Call)
            and (name := _call_target_name(inner)) is not None
            and _SLEEPISH.search(name)
            for inner in ast.walk(node)
        )
        if not sleeps:
            continue
        rechecks = any(
            isinstance(inner, ast.Call)
            and (name := _call_target_name(inner)) is not None
            and _SETTLE_RECHECK.match(name)
            for inner in ast.walk(node)
        )
        if not rechecks:
            continue
        yield Violation(
            "blocking-settle-in-worker",
            str(ctx.path),
            node.lineno,
            "settle loop (sleep + describe/list re-check) holds a worker — "
            "raise SettleWait so the pending-settle scheduler re-checks the "
            "parked chain in its coalesced poll tick instead",
        )


# ---------------------------------------------------------------------------
# delete-without-ownership-check
# ---------------------------------------------------------------------------

# the teardown operations the GC sweeper can reach: the drivers'
# cleanup orchestrations plus the raw service deletes and the
# record-change op (a DELETE change batch)
_GC_DELETE_OPS = frozenset(
    {
        "cleanup_global_accelerator", "cleanup_record_set",
        "delete_accelerator", "delete_listener", "delete_endpoint_group",
        "change_resource_record_sets",
    }
)

# what counts as an ownership-verification helper: a call (or the
# containing function itself) named like the GC module's verify
# funnels — verify_accelerator_orphan_ownership,
# verify_record_orphan_ownership, verify_accelerator_orphan, ...
_OWNERSHIP_VERIFYISH = re.compile(r"verify_\w*(ownership|orphan)", re.IGNORECASE)


def _is_gc_module(ctx: LintContext) -> bool:
    return "controllers" in ctx.path.parts and ctx.path.name == "garbagecollector.py"


@rule(
    "delete-without-ownership-check",
    "teardown calls in the GC sweeper must flow through an "
    "ownership-verification helper — the sweeper deletes on its own "
    "initiative, so unverified deletion is the worst shippable bug",
)
def check_delete_without_ownership_check(
    tree: ast.Module, ctx: LintContext
) -> Iterator[Violation]:
    if not _is_gc_module(ctx):
        return
    for fn in ctx.walk():
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if _OWNERSHIP_VERIFYISH.search(fn.name):
            continue  # the verify helper itself is the sanctioned site
        verifies = any(
            isinstance(node, ast.Call)
            and (name := _call_target_name(node)) is not None
            and _OWNERSHIP_VERIFYISH.search(name)
            for node in ast.walk(fn)
        )
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _call_target_name(node)
            if name not in _GC_DELETE_OPS:
                continue
            if verifies:
                continue
            yield Violation(
                "delete-without-ownership-check",
                str(ctx.path),
                node.lineno,
                f"{name}() reachable from the GC sweeper without an "
                "ownership-verification helper in the same function — "
                "route the deletion through "
                "verify_*_orphan_ownership(...) first",
            )


# ---------------------------------------------------------------------------
# cross-shard-sweep
# ---------------------------------------------------------------------------

# the fleet-enumeration entry points the sharding plane partitions: a
# GC sweep phase, the manager's drift/reshard enumerations, and every
# controller's drift re-enqueue wiring.  Anything matching here must
# reference the shard filter somewhere in its body.
_SHARD_SWEEP_FUNCTIONS = re.compile(
    r"^(_sweep_\w+|drift_tick|reshard_resync|drift_resync_sources)$"
)
# what counts as consulting the filter: any name/attribute containing
# "shard" (self._shards.owns..., self.shard_filter.token(), a `shards`
# parameter) — the wiring idiom this repo standardizes on
_SHARDISH = re.compile(r"shard", re.IGNORECASE)


def _is_shard_enumeration_module(ctx: LintContext) -> bool:
    if ctx.path.name == "manager.py":
        return True
    return "controllers" in ctx.path.parts


@rule(
    "cross-shard-sweep",
    "GC/drift fleet-enumeration paths must consult the shard filter — "
    "an unfiltered sweep makes every replica work (or sweep) every "
    "key, the duplicate-mutation class sharding exists to exclude",
)
def check_cross_shard_sweep(
    tree: ast.Module, ctx: LintContext
) -> Iterator[Violation]:
    if not _is_shard_enumeration_module(ctx):
        return
    for fn in ctx.walk():
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not _SHARD_SWEEP_FUNCTIONS.match(fn.name):
            continue
        consults_filter = any(
            (isinstance(node, ast.Attribute) and _SHARDISH.search(node.attr))
            or (isinstance(node, ast.Name) and _SHARDISH.search(node.id))
            for node in ast.walk(fn)
        )
        if consults_filter:
            continue
        yield Violation(
            "cross-shard-sweep",
            str(ctx.path),
            fn.lineno,
            f"{fn.name}() enumerates the fleet without consulting the "
            "shard filter — gate the enumeration on the ownership "
            "predicate (self._shards.owns(...) / shard_filter), or "
            "suppress with justification if this path is genuinely "
            "single-process",
        )


# ---------------------------------------------------------------------------
# journey-stage-without-stamp
# ---------------------------------------------------------------------------

# the reconcile-loop item movements a journey must witness: requeues
# (rate-limited or delayed) and parks.  ``forget``/``add`` alone are
# bookkeeping; these three change an item's fate.
_JOURNEY_MOVES = frozenset({"add_rate_limited", "add_after", "park"})
_JOURNEYISH = re.compile(r"journey", re.IGNORECASE)
# the queue implementation itself is mechanism (its internal re-adds
# are not lifecycle decisions), and result.py holds no control flow
_JOURNEY_EXEMPT_FILES = frozenset({"workqueue.py", "result.py", "__init__.py"})


def _is_reconcile_loop_module(ctx: LintContext) -> bool:
    return (
        "reconcile" in ctx.path.parts
        and ctx.path.name not in _JOURNEY_EXEMPT_FILES
    )


@rule(
    "journey-stage-without-stamp",
    "reconcile-loop paths that requeue, park, or drop an item must record "
    "a journey stage — an unstamped movement makes the convergence-latency "
    "SLO blind to exactly the slow paths it exists to measure",
)
def check_journey_stage_without_stamp(
    tree: ast.Module, ctx: LintContext
) -> Iterator[Violation]:
    """The convergence SLO plane derives end-to-end latency
    from journey stamps.  Any function in the reconcile package
    (``reconcile.py``/``pending.py`` — the loop and the pending-settle
    scheduler; the workqueue is exempt mechanism) that moves an item
    (``add_rate_limited``/``add_after``/``park``) without touching the
    journey plane silently drops a lifecycle stage: latency keeps
    accruing with no stage to explain it, and /slo's drill-down loses
    the path."""
    if not _is_reconcile_loop_module(ctx):
        return
    for fn in ctx.walk():
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        moves = [
            node
            for node in ast.walk(fn)
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _JOURNEY_MOVES
        ]
        if not moves:
            continue
        stamps = any(
            (isinstance(node, ast.Attribute) and _JOURNEYISH.search(node.attr))
            or (isinstance(node, ast.Name) and _JOURNEYISH.search(node.id))
            for node in ast.walk(fn)
        )
        if stamps:
            continue
        first = moves[0]
        yield Violation(
            "journey-stage-without-stamp",
            str(ctx.path),
            first.lineno,
            f"{fn.name}() moves an item ({first.func.attr}) without "
            "recording a journey stage — stamp it via "
            "journey.tracker().stage(...) (or close it with "
            "converged()/deleted()/drop()) so the convergence SLO sees "
            "this path",
        )


# ---------------------------------------------------------------------------
# unregistered-metric
# ---------------------------------------------------------------------------

# the metric primitive class names exported by the observability
# registry module — constructing one directly bypasses registration
# (the series silently never reaches /metrics) and skips the
# registry's label-cardinality cap
_METRIC_CLASSES = frozenset({"Counter", "Gauge", "Histogram", "Metric"})
# the registry's factory method names; calls to these are the
# sanctioned construction path, but their name/label arguments must be
# literals — a dynamic label tuple is exactly how unbounded
# cardinality (keys, error text) sneaks into a metric
_REGISTRY_FACTORIES = frozenset({"counter", "gauge", "histogram"})


def _metric_class_origin(origin: Optional[str]) -> Optional[str]:
    """The metric class a call target's import origin denotes, or None.
    Provenance (via the shared ``ImportMap``) keeps ``collections.
    Counter`` and every other unrelated Counter out of scope; suffix
    matching covers both the absolute and relative spellings of the
    metrics module."""
    if origin is None:
        return None
    for cls in _METRIC_CLASSES:
        if origin.endswith(f"metrics.{cls}") or origin.endswith(f"observability.{cls}"):
            return cls
    return None


def _is_metrics_module(ctx: LintContext) -> bool:
    return "observability" in ctx.path.parts and ctx.path.name == "metrics.py"


def _literal_str(node: ast.expr) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, str)


def _literal_str_sequence(node: ast.expr) -> bool:
    return isinstance(node, (ast.Tuple, ast.List)) and all(
        _literal_str(elt) for elt in node.elts
    )


@rule(
    "unregistered-metric",
    "Counter/Gauge/Histogram must be built through the shared registry "
    "(registry.counter(...)) with literal names and label tuples — a direct "
    "construction never reaches /metrics, and dynamic label names are an "
    "unbounded-cardinality risk",
)
def check_unregistered_metric(tree: ast.Module, ctx: LintContext) -> Iterator[Violation]:
    if _is_metrics_module(ctx):
        return  # the registry module is where the primitives live
    imports = ctx.import_map()
    for node in ctx.walk():
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        # direct construction: Counter(...) / metrics.Counter(...)
        called = _metric_class_origin(imports.resolve_call_target(func))
        if called is not None:
            yield Violation(
                "unregistered-metric",
                str(ctx.path),
                node.lineno,
                f"direct {called}(...) construction bypasses the registry — "
                "use registry.counter/gauge/histogram(...) so the series is "
                "exported and cardinality-capped",
            )
            continue
        # registry factory call: name + labels must be literal
        if not (isinstance(func, ast.Attribute) and func.attr in _REGISTRY_FACTORIES):
            continue
        if not node.args and not any(k.arg == "name" for k in node.keywords):
            continue  # not a metric declaration shape (e.g. itertools.count)
        name_arg = node.args[0] if node.args else next(
            (k.value for k in node.keywords if k.arg == "name"), None
        )
        if name_arg is not None and not _literal_str(name_arg):
            yield Violation(
                "unregistered-metric",
                str(ctx.path),
                node.lineno,
                f".{func.attr}(...) with a non-literal metric name — computed "
                "names make the exported series set unreviewable",
            )
        labels_arg = next(
            (k.value for k in node.keywords if k.arg == "labels"),
            node.args[2] if len(node.args) > 2 else None,
        )
        if labels_arg is not None and not _literal_str_sequence(labels_arg):
            yield Violation(
                "unregistered-metric",
                str(ctx.path),
                node.lineno,
                f".{func.attr}(...) with non-literal label names — label "
                "NAMES must be a fixed literal tuple (values vary, names "
                "never do); a dynamic label set is an unbounded-cardinality "
                "risk",
            )


# ---------------------------------------------------------------------------
# unseamed-clock
# ---------------------------------------------------------------------------

# the wall-clock reads/sleeps the seam routes; time.strftime/gmtime
# (pure formatting) stay unflagged
_CLOCK_ATTRS = frozenset({"time", "monotonic", "sleep", "time_ns", "perf_counter"})

_CLOCK_SEAM_SUGGESTION = {
    "time": "clockseam.time()",
    "time_ns": "clockseam.time()",
    "monotonic": "clockseam.monotonic()",
    "perf_counter": "clockseam.monotonic()",
    "sleep": "clockseam.sleep()",
}

# modules whose business IS real time: the seam itself, the sim
# runtime built on it, and the real-I/O edges where wall clock is
# semantically required (OAuth token expiry over real HTTP, SigV4
# request signing, real-AWS retry pacing, the subprocess apiserver
# test harness) — virtual time there would sign invalid requests or
# turn real-socket timeouts into hangs; each path is relative to a
# package root (PACKAGE_ROOTS)
_CLOCK_SANCTIONED = (
    "clockseam.py",
    "sim/",
    "cluster/rest.py",
    "cluster/testserver.py",
    "cloudprovider/aws/real_backend.py",
    "cloudprovider/aws/sigv4.py",
)


def _clock_rule_applies(ctx: LintContext) -> bool:
    if not package_paths(ctx.path):
        return False  # tests and bench drive real threads on purpose
    return not in_package(ctx.path, _CLOCK_SANCTIONED)


@rule(
    "unseamed-clock",
    "direct time.time()/time.monotonic()/time.sleep()/threading.Timer outside "
    "the clock seam — wall-clock reads and sleeps must route through "
    "clockseam.py (or an injected clock) so the deterministic "
    "simulation runtime can run the whole subsystem on virtual time",
)
def check_unseamed_clock(tree: ast.Module, ctx: LintContext) -> Iterator[Violation]:
    if not _clock_rule_applies(ctx):
        return
    # provenance via the shared ImportMap covers every spelling at
    # once: `time.sleep`, `import time as _time`, `from time import
    # sleep as pause`, `from threading import Timer as T`
    imports = ctx.import_map()
    for node in ctx.walk():
        if not isinstance(node, ast.Call):
            continue
        origin = imports.resolve_call_target(node.func)
        if origin is None:
            continue
        if origin == "threading.Timer":
            yield _timer_violation(ctx, node)
            continue
        attr = origin[len("time."):] if origin.startswith("time.") else None
        if attr in _CLOCK_ATTRS:
            yield Violation(
                "unseamed-clock",
                str(ctx.path),
                node.lineno,
                f"direct time.{attr}() stalls virtual time under the sim "
                f"runtime — read {_CLOCK_SEAM_SUGGESTION[attr]} or accept an "
                "injected clock/sleep",
            )


def _timer_violation(ctx: LintContext, node: ast.Call) -> Violation:
    return Violation(
        "unseamed-clock",
        str(ctx.path),
        node.lineno,
        "threading.Timer fires on the real clock and escapes the "
        "deterministic scheduler — use a seam-driven tick (injected "
        "sleep loop or the sim scheduler's timers) instead",
    )


# ---------------------------------------------------------------------------
# unattributed-stage
# ---------------------------------------------------------------------------

# literal copy of the stage accountant's catalog
# (observability/profile.py STAGES) — the linter never imports the
# package it lints (the RAW_API_OPS precedent), and a sync test pins
# the two sets equal.  Dynamic per-AWS-op names flow through
# profile.api_stage(service, op) instead, which this rule does not
# (and must not) check.
_STAGE_NAMES = frozenset({
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
})


def _is_profile_module(ctx: LintContext) -> bool:
    return "observability" in ctx.path.parts and ctx.path.name == "profile.py"


@rule(
    "unattributed-stage",
    "profile.stage(...) must be called with a literal stage name from the "
    "catalog in observability/profile.py — a computed or uncataloged name is "
    "a metric-label series the attribution table, docs and bench rails never "
    "account for (the stage-name analogue of unregistered-metric)",
)
def check_unattributed_stage(tree: ast.Module, ctx: LintContext) -> Iterator[Violation]:
    if _is_profile_module(ctx):
        return  # the catalog module is where stage() lives
    imports = ctx.import_map()
    for node in ctx.walk():
        if not isinstance(node, ast.Call):
            continue
        origin = imports.resolve_call_target(node.func)
        if origin is None or not origin.endswith("profile.stage"):
            continue
        name_arg = node.args[0] if node.args else next(
            (k.value for k in node.keywords if k.arg == "name"), None
        )
        if name_arg is None or not _literal_str(name_arg):
            yield Violation(
                "unattributed-stage",
                str(ctx.path),
                node.lineno,
                "profile.stage(...) with a computed stage name — stage names "
                "are metric labels and must be literal; per-AWS-op names go "
                "through profile.api_stage(service, op)",
            )
            continue
        if name_arg.value not in _STAGE_NAMES:
            yield Violation(
                "unattributed-stage",
                str(ctx.path),
                node.lineno,
                f"profile.stage({name_arg.value!r}) names a stage missing "
                "from the catalog in observability/profile.py — add it to "
                "STAGES (with a description) so the attribution table, "
                "metrics docs and bench rails account for it",
            )


# ---------------------------------------------------------------------------
# unexplained-requeue
# ---------------------------------------------------------------------------

# literal copy of the explain plane's call-site reason catalog
# (observability/explain.py REASON_CODES) — the linter never imports
# the package it lints (the RAW_API_OPS / _STAGE_NAMES precedent), and
# a sync test pins the two sets equal
_REQUEUE_REASON_CODES = frozenset({
    "in-flight",
    "backoff",
    "circuit-open",
    "quota-paced",
    "parked-settle",
    "shed",
    "not-owner",
})

# the item movements that must carry a structured reason: the same
# fate-changing moves the journey-stamp rule watches, plus the Result
# kwargs that *cause* them one frame up the loop
_EXPLAIN_MOVES = frozenset({"add_rate_limited", "add_after", "park"})
_RESULT_FATE_KWARGS = frozenset({"requeue", "requeue_after", "skip"})
# the queue implementation re-adds items internally (mechanism, not a
# decision) and result.py is the dataclass itself
_EXPLAIN_EXEMPT_FILES = frozenset({"workqueue.py", "result.py", "__init__.py"})


def _in_explain_scope(ctx: LintContext) -> bool:
    return (
        ("reconcile" in ctx.path.parts or "controllers" in ctx.path.parts)
        and ctx.path.name not in _EXPLAIN_EXEMPT_FILES
    )


def _explained_reason(node: ast.expr) -> Optional[str]:
    """None when the reason expression is acceptable; otherwise the
    complaint.  Acceptable: a literal from the catalog, or a
    ``<something>.reason`` attribute (a Result's structured reason
    flowing through the loop unchanged)."""
    if isinstance(node, ast.Attribute) and node.attr == "reason":
        return None
    if not _literal_str(node):
        return (
            "computed reason string — the explain verdict catalog is "
            "closed, so reasons must be literals from "
            "observability/explain.py REASON_CODES (or a Result's "
            "``.reason`` passed through)"
        )
    if node.value not in _REQUEUE_REASON_CODES:
        return (
            f"reason {node.value!r} is not in the explain call-site "
            "catalog (observability/explain.py REASON_CODES) — an "
            "uncataloged reason is a verdict /debug/explain can never "
            "map, i.e. exactly the 'unknown' the plane forbids"
        )
    return None


@rule(
    "unexplained-requeue",
    "requeue/park/skip sites in reconcile/ and controllers/ must carry a "
    "literal reason code from the explain catalog — an unexplained movement "
    "is a blocked object /debug/explain cannot diagnose",
)
def check_unexplained_requeue(tree: ast.Module, ctx: LintContext) -> Iterator[Violation]:
    """The explain plane classifies a blocked object from
    the structured reason attached where its fate was decided — at the
    ``add_rate_limited``/``add_after``/``park`` call, or on the
    ``Result`` that requests the requeue/skip.  A site that omits the
    reason (or computes it) degrades the verdict to a bare ``backoff``
    guess, which is precisely the diagnostic gap the plane exists to
    close."""
    if not _in_explain_scope(ctx):
        return
    for node in ctx.walk():
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in _EXPLAIN_MOVES:
            reason_kw = next(
                (k.value for k in node.keywords if k.arg == "reason"), None
            )
            if reason_kw is None:
                yield Violation(
                    "unexplained-requeue",
                    str(ctx.path),
                    node.lineno,
                    f".{func.attr}(...) without a reason= code — attach a "
                    "literal from observability/explain.py REASON_CODES so "
                    "/debug/explain can say why this key is waiting",
                )
                continue
            complaint = _explained_reason(reason_kw)
            if complaint is not None:
                yield Violation(
                    "unexplained-requeue", str(ctx.path), node.lineno,
                    f".{func.attr}(...): {complaint}",
                )
            continue
        # Result(requeue=..., requeue_after=..., skip=...) one frame up
        if not (isinstance(func, ast.Name) and func.id == "Result"):
            continue
        kwargs = {k.arg for k in node.keywords}
        if not kwargs & _RESULT_FATE_KWARGS:
            continue
        reason_kw = next(
            (k.value for k in node.keywords if k.arg == "reason"), None
        )
        if reason_kw is None:
            fate = ", ".join(sorted(kwargs & _RESULT_FATE_KWARGS))
            yield Violation(
                "unexplained-requeue",
                str(ctx.path),
                node.lineno,
                f"Result({fate}=...) without a reason= code — the loop "
                "forwards Result.reason to the workqueue, so an empty one "
                "leaves /debug/explain guessing 'backoff'",
            )
            continue
        complaint = _explained_reason(reason_kw)
        if complaint is not None:
            yield Violation(
                "unexplained-requeue", str(ctx.path), node.lineno,
                f"Result(...): {complaint}",
            )


# ---------------------------------------------------------------------------
# cross-boundary-capture
# ---------------------------------------------------------------------------

# receivers that look like executors; the submission methods that ship
# a callable into them; Thread's target kwarg is the same boundary
_POOLISH_RECEIVER = re.compile(r"(pool|executor)", re.IGNORECASE)
_SUBMISSION_METHODS = frozenset({"submit", "map"})
# analysis/ and sim/ are single-threaded offline tooling by contract
# (the census's _SINGLE_THREADED); the parse cache's pool.map of a
# bound method there is not a worker-runtime boundary
_CAPTURE_EXEMPT_PARTS = frozenset({"analysis", "sim"})


def _capture_rule_applies(ctx: LintContext) -> bool:
    parts = set(ctx.path.parts)
    return bool(package_paths(ctx.path)) and not (parts & _CAPTURE_EXEMPT_PARTS)


def _module_scope_names(tree: ast.Module) -> set[str]:
    """Names bound at module top level (defs, classes, imports, assigns)
    — references to these from a nested def are not closure captures."""
    names: set[str] = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                names.add(alias.asname or alias.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            for alias in node.names:
                names.add(alias.asname or alias.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for target in targets:
                if isinstance(target, ast.Name):
                    names.add(target.id)
    return names


_BUILTIN_NAMES = frozenset(dir(builtins))


def _free_names(
    fn: ast.FunctionDef | ast.AsyncFunctionDef, module_names: set[str]
) -> list[str]:
    """Names a nested def loads but binds neither locally nor at module
    scope — the closure cells a process boundary cannot ship."""
    args = fn.args
    bound = {
        a.arg
        for a in (
            *args.posonlyargs, *args.args, *args.kwonlyargs,
            *((args.vararg,) if args.vararg else ()),
            *((args.kwarg,) if args.kwarg else ()),
        )
    }
    loaded: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name):
            if isinstance(node.ctx, ast.Load):
                loaded.add(node.id)
            else:
                bound.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if node is not fn:
                bound.add(node.name)
    return sorted(loaded - bound - module_names - _BUILTIN_NAMES)


@rule(
    "cross-boundary-capture",
    "thread/executor submission sites may not capture enclosing state in "
    "lambdas, bound methods, or closures — the multi-core executor swaps "
    "these pools for process pools, and a capture that pickles by reference "
    "(or drags a lock-holding instance along) fails exactly there",
)
def check_cross_boundary_capture(
    tree: ast.Module, ctx: LintContext
) -> Iterator[Violation]:
    """The confinement analyzer (``analysis/confinement.py``) audits the
    same boundary whole-program; this per-file rule catches the capture
    at the PR diff, before the footprint table ever reruns.  One
    inline ``# agac-lint: ignore[cross-boundary-capture] -- reason``
    silences both (the analyzer honors the same comment)."""
    if not _capture_rule_applies(ctx):
        return
    module_names = _module_scope_names(tree)
    # innermost enclosing function of every call: ast.walk is BFS, so a
    # nested def's pass over its own calls runs after (and overrides)
    # every enclosing function's
    enclosing_fn: dict[int, ast.FunctionDef] = {}
    for fn_node in ast.walk(tree):
        if isinstance(fn_node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for node in ast.walk(fn_node):
                if isinstance(node, ast.Call):
                    enclosing_fn[id(node)] = fn_node

    def describe(callable_expr: ast.expr, fn: Optional[ast.FunctionDef]) -> Optional[str]:
        if isinstance(callable_expr, ast.Lambda):
            return (
                "a lambda — it pickles by reference, so a process-pool "
                "submission cannot reconstruct it in the worker; pass a "
                "module-level function (or partial over picklable args)"
            )
        if isinstance(callable_expr, ast.Attribute) and isinstance(
            callable_expr.value, ast.Name
        ) and callable_expr.value.id in ("self", "cls"):
            return (
                f"the bound method {callable_expr.value.id}."
                f"{callable_expr.attr} — it drags the whole instance "
                "(locks, sockets, caches and all) across the boundary"
            )
        if isinstance(callable_expr, ast.Name) and fn is not None:
            # a def nested in the submitting function: flag only when it
            # actually closes over enclosing state
            for node in ast.walk(fn):
                if (
                    isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node is not fn
                    and node.name == callable_expr.id
                ):
                    captured = _free_names(node, module_names)
                    if captured:
                        return (
                            f"the nested function {callable_expr.id!r}, "
                            "which closes over "
                            f"{', '.join(repr(c) for c in captured[:4])} — "
                            "closure cells cannot cross a process boundary"
                        )
                    return None
        return None

    for node in ctx.walk():
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        callable_expr: Optional[ast.expr] = None
        via = ""
        if isinstance(func, ast.Attribute) and func.attr in _SUBMISSION_METHODS:
            recv = func.value
            recv_name = recv.id if isinstance(recv, ast.Name) else (
                recv.attr if isinstance(recv, ast.Attribute) else None
            )
            if recv_name is None or not _POOLISH_RECEIVER.search(recv_name):
                continue
            callable_expr = node.args[0] if node.args else None
            via = f"{recv_name}.{func.attr}"
        elif (
            isinstance(func, ast.Attribute) and func.attr == "Thread"
        ) or (isinstance(func, ast.Name) and func.id == "Thread"):
            target = next(
                (k.value for k in node.keywords if k.arg == "target"), None
            )
            if not isinstance(target, ast.Lambda):
                # nested-def / bound-method thread targets are the
                # unseamed-thread analysis's jurisdiction; only the
                # flat-out lambda is always a capture smell here
                continue
            callable_expr = target
            via = "Thread(target=...)"
        if callable_expr is None:
            continue
        complaint = describe(callable_expr, enclosing_fn.get(id(node)))
        if complaint is not None:
            yield Violation(
                "cross-boundary-capture",
                str(ctx.path),
                node.lineno,
                f"{via} ships {complaint}",
            )


# ---------------------------------------------------------------------------
# untapped-external-input
# ---------------------------------------------------------------------------

# The seams where external inputs enter the process, and the tap
# methods (sim/capture.py) that must see them.  An input consumed
# past the tap is a hole in the incident tape: a captured run whose
# replay can only discover the miss as an unexplained divergence.
# The anchor is the consuming call; the discharge is any reference to
# the matching tap surface in the same function (nested defs count —
# the handler closure in setup_signal_handler is the canonical shape).
_EXTERNAL_INPUT_SEAMS: tuple[tuple[str, tuple[str, ...], str], ...] = (
    (
        "apply_event",
        ("record_informer_batch", "record_informer", "informer_feed"),
        "informer event delivery",
    ),
    (
        "record_call",
        ("record_aws_call",),
        "AWS call outcome classification",
    ),
    (
        "signal",
        ("record_signal",),
        "signal handler registration",
    ),
)

# the tap's own module (and the replay driving it) discharge by being
# the capture plane
_UNTAPPED_EXEMPT_FILES = frozenset({"capture.py", "replay.py"})


def _untapped_rule_applies(ctx: LintContext) -> bool:
    return bool(package_paths(ctx.path)) and ctx.path.name not in _UNTAPPED_EXEMPT_FILES


def _referenced_names(fn: ast.AST) -> set[str]:
    names: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name):
            names.add(node.id)
        elif isinstance(node, ast.Attribute):
            names.add(node.attr)
    return names


@rule(
    "untapped-external-input",
    "external-input seams (informer event delivery, AWS outcome "
    "classification, signal registration) must route through the "
    "incident-capture tap — an input the tape never sees makes every "
    "capture of that run unreplayable",
)
def check_untapped_external_input(
    tree: ast.Module, ctx: LintContext
) -> Iterator[Violation]:
    if not _untapped_rule_applies(ctx):
        return
    # innermost enclosing function per call (BFS walk: nested defs
    # override their enclosers), so the discharge scope is the whole
    # consuming function including its nested handlers
    top_fn: dict[int, ast.AST] = {}
    for fn_node in ast.walk(tree):
        if isinstance(fn_node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for node in ast.walk(fn_node):
                if isinstance(node, ast.Call) and id(node) not in top_fn:
                    top_fn[id(node)] = fn_node
    for node in ctx.walk():
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if not isinstance(func, ast.Attribute):
            continue
        for anchor, taps, what in _EXTERNAL_INPUT_SEAMS:
            if func.attr != anchor:
                continue
            if anchor == "signal":
                # only the stdlib registration call, not arbitrary
                # .signal() methods
                recv = func.value
                if not (isinstance(recv, ast.Name) and recv.id == "signal"):
                    continue
            fn = top_fn.get(id(node))
            scope = fn if fn is not None else tree
            referenced = _referenced_names(scope)
            if referenced & set(taps) or "capture" in referenced:
                continue
            yield Violation(
                "untapped-external-input",
                str(ctx.path),
                node.lineno,
                f"{what} ({func.attr}) consumed without feeding the "
                f"incident-capture tap; call {taps[0]} (or route through "
                "the installed capture) so a recorded run can replay "
                "this input",
            )


# ---------------------------------------------------------------------------
# suppression
# ---------------------------------------------------------------------------

_SUPPRESS_RE = re.compile(
    r"#\s*agac-lint:\s*ignore\[(?P<rules>[a-z0-9,\s-]+)\]\s*(?:--\s*(?P<why>.*\S))?"
)


def suppression_on_line(source_lines: list[str], line: int) -> Optional[re.Match]:
    if 1 <= line <= len(source_lines):
        return _SUPPRESS_RE.search(source_lines[line - 1])
    return None


def apply_suppressions(
    violations: list[Violation], ctx: LintContext
) -> tuple[list[Violation], list[Violation]]:
    """Drop violations whose line carries a justified suppression for
    their rule; an unjustified suppression is itself a violation."""
    kept: list[Violation] = []
    errors: list[Violation] = []
    for v in violations:
        m = suppression_on_line(ctx.source_lines, v.line)
        if m is None:
            kept.append(v)
            continue
        rules = {r.strip() for r in m.group("rules").split(",")}
        if v.rule not in rules:
            kept.append(v)
            continue
        if not m.group("why"):
            errors.append(
                Violation(
                    "suppression-needs-justification",
                    v.path,
                    v.line,
                    f"suppression of [{v.rule}] must carry a justification: "
                    "`# agac-lint: ignore[rule] -- reason`",
                )
            )
    return kept, errors
