"""The stage accountant: per-stage CPU/wall attribution.

The roadmap's next perf item — breaking the single-core wall — begins
with "profile the per-reconcile CPU path", and nothing in the stack
could attribute *CPU* cost to stages: the workqueue/reconcile
histograms measure wall clock, the journey plane
measures end-to-end latency, and both hide where a core actually goes
between queue pop and queue done.  This module is the attribution
layer every later performance change reads first.

Mechanics:

- ``stage(name)`` is a context manager charging the bracketed code's
  CPU (``clockseam.thread_cpu()``, i.e. ``time.thread_time`` in
  production and the virtual clock under the sim) and wall time to the
  named stage.  Stages nest; a parent is charged its EXCLUSIVE time
  only (children's inclusive time is subtracted), so the per-stage
  table sums to the measured total instead of double-counting.
- Stage NAMES are closed over by the ``STAGES`` catalog below; the
  ``unattributed-stage`` lint rule (``analysis/rules.py``) rejects a
  ``stage(...)`` call whose literal name is not catalogued, exactly
  like ``unregistered-metric`` does for metric names.  The one dynamic
  family — per-AWS-call attribution — goes through ``api_stage`` and
  is namespaced ``aws:{service}.{op}``.
- ``reconcile_scope(controller)`` brackets one work item: stages
  closed inside it accumulate into the scope and are flushed on exit
  into the ``agac_profile_stage_cpu_seconds`` /
  ``..._wall_seconds{stage,controller}`` histograms plus the
  per-reconcile cpu/wall ratio gauge.  Stages closed OUTSIDE a scope
  (drift tick, GC sweep, batcher flush on a non-worker thread) flush
  immediately under the stage's own name.
- Everything also lands in a process-global aggregate the bench's
  ``profiling`` phase snapshots into its ranked attribution table
  (``attribution_table``); the same table shape can be computed from a
  (possibly fleet-merged) ``/metrics`` exposition via
  ``attribution_from_exposition`` — stage histograms are ordinary
  registry histograms, so the fleet-merge path sums them across
  shard replicas with no extra code.

The accountant is ON by default: its hot-path cost is two clock reads
per stage plus dict arithmetic, and the bench's profiling phase
asserts the measured overhead stays ≤ 5% of headline obj/s.
``--profile-stages=off`` (cmd/root) or ``configure(stages=False)``
turns every bracket into a shared no-op context manager.
"""

from __future__ import annotations

import re
import threading
from typing import Callable, Optional

from .. import clockseam
from . import instruments

# ---------------------------------------------------------------------------
# the stage catalog — every static stage name the accountant may be
# handed, with the one-line meaning an operator reads in docs.  The
# ``unattributed-stage`` lint rule carries a literal copy of these
# names (the linter never imports the package it lints);
# tests/test_profiling.py pins the two sets equal.
# ---------------------------------------------------------------------------

STAGES: dict[str, str] = {
    "queue-pop": "popping the next item from the workqueue (wall time "
    "includes idle wait; CPU is the pop bookkeeping itself)",
    "shard-filter": "pop-time shard-ownership re-check (hash-ring "
    "lookup behind the ShardFilter memo)",
    "informer-lookup": "resolving the key to its cached object through "
    "the lister",
    "serialize": "deep-copying the cached object before mutation (the "
    "reference's DeepCopy) plus any hashing of it",
    "driver-mutate": "the controller's process func: ensure/verify "
    "logic and driver calls (per-call CPU splits out into aws:* "
    "child stages)",
    "settle-park": "parking the item in the pending-settle table "
    "after an AWS wait state",
    "self-tax": "the observability plane's own cost: metric "
    "increments, journey stamps, trace annotation, flight-recorder "
    "writes",
    "drift-tick": "one drift-resync round: walking every controller's "
    "drift sources and re-enqueueing managed objects",
    "gc-sweep": "one orphan-GC sweep: AWS/apiserver cross-checks and "
    "grace bookkeeping",
    "r53-batch-flush": "committing one gathered Route53 change batch "
    "(merge, wire call, ticket fan-out)",
}

# dynamic per-AWS-call stages are namespaced under this prefix
# (``aws:globalaccelerator.create_accelerator`` and friends); they are
# created by ``api_stage`` only, so the lint rule's literal-name check
# never sees them
API_STAGE_PREFIX = "aws:"

# the controller label immediate-flush (out-of-reconcile) stages carry
# unless the call site passes its own
DEFAULT_CONTROLLER = "manager"

_enabled = True


def configure(stages: Optional[bool] = None) -> None:
    """Arm/disarm the stage accountant (cmd/root's ``--profile-stages``)."""
    global _enabled
    if stages is not None:
        _enabled = bool(stages)


def stages_enabled() -> bool:
    return _enabled


# ---------------------------------------------------------------------------
# thread-local stage stack + per-reconcile scope
# ---------------------------------------------------------------------------

_tls = threading.local()


class _Frame:
    __slots__ = ("name", "cpu0", "wall0", "child_cpu", "child_wall")

    def __init__(self, name: str, cpu0: float, wall0: float):
        self.name = name
        self.cpu0 = cpu0
        self.wall0 = wall0
        self.child_cpu = 0.0
        self.child_wall = 0.0


class _Scope:
    """One reconcile's stage totals: {stage: [cpu, wall, hits]}."""

    __slots__ = ("controller", "totals")

    def __init__(self, controller: str):
        self.controller = controller
        self.totals: dict[str, list[float]] = {}

    def add(self, name: str, cpu: float, wall: float) -> None:
        entry = self.totals.get(name)
        if entry is None:
            self.totals[name] = [cpu, wall, 1.0]
        else:
            entry[0] += cpu
            entry[1] += wall
            entry[2] += 1.0

    def breakdown_us(self) -> dict[str, int]:
        """{stage: exclusive CPU microseconds} of the stages closed so
        far — the trace-annotation view ("where did this reconcile's
        time go" on one flight-recorder line)."""
        return {
            name: int(entry[0] * 1e6) for name, entry in sorted(self.totals.items())
        }


class _NullScope:
    # no instance state: the singleton is shared across every thread,
    # and empty __slots__ makes that structurally true (the confinement
    # census proves it stateless rather than trusting the comment)
    __slots__ = ()

    controller = ""

    def breakdown_us(self) -> dict[str, int]:
        return {}


_NULL_SCOPE = _NullScope()


class _NullStage:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_STAGE = _NullStage()


class _StageContext:
    __slots__ = ("_name", "_controller", "_frame")

    def __init__(self, name: str, controller: str):
        self._name = name
        self._controller = controller

    def __enter__(self):
        stack = getattr(_tls, "frames", None)
        if stack is None:
            stack = _tls.frames = []
        self._frame = _Frame(
            self._name, clockseam.thread_cpu(), clockseam.monotonic()
        )
        stack.append(self._frame)
        return self

    def __exit__(self, *exc):
        frame = self._frame
        incl_cpu = clockseam.thread_cpu() - frame.cpu0
        incl_wall = clockseam.monotonic() - frame.wall0
        stack = _tls.frames
        stack.pop()
        if stack:
            parent = stack[-1]
            parent.child_cpu += incl_cpu
            parent.child_wall += incl_wall
        excl_cpu = max(0.0, incl_cpu - frame.child_cpu)
        excl_wall = max(0.0, incl_wall - frame.child_wall)
        scope = getattr(_tls, "scope", None)
        if scope is not None:
            scope.add(frame.name, excl_cpu, excl_wall)
        else:
            _flush_stage(frame.name, self._controller, excl_cpu, excl_wall)
        return False


def stage(name: str, controller: str = DEFAULT_CONTROLLER):
    """Charge the bracketed code to ``name``.  ``controller`` labels
    the flush only when no reconcile scope is active (the scope's own
    controller wins inside one)."""
    if not _enabled:
        return _NULL_STAGE
    return _StageContext(name, controller)


def api_stage(service: str, op: str):
    """The dynamic per-AWS-call stage (``aws:{service}.{op}``) the
    driver's instrumented handles bracket each call with — a child of
    ``driver-mutate``, so per-op CPU splits out of the process func's
    exclusive time."""
    if not _enabled:
        return _NULL_STAGE
    return _StageContext(f"{API_STAGE_PREFIX}{service}.{op}", DEFAULT_CONTROLLER)


class _ReconcileScope:
    __slots__ = ("_controller", "_scope", "_prev", "_cpu0", "_wall0")

    def __init__(self, controller: str):
        self._controller = controller

    def __enter__(self) -> _Scope:
        self._scope = _Scope(self._controller)
        self._prev = getattr(_tls, "scope", None)
        _tls.scope = self._scope
        self._cpu0 = clockseam.thread_cpu()
        self._wall0 = clockseam.monotonic()
        return self._scope

    def __exit__(self, *exc):
        total_cpu = clockseam.thread_cpu() - self._cpu0
        total_wall = clockseam.monotonic() - self._wall0
        _tls.scope = self._prev
        _flush_scope(self._scope, total_cpu, total_wall)
        return False


def reconcile_scope(controller: str):
    """Bracket one work item: stages closed inside accumulate into the
    yielded scope and flush to the histograms + aggregate on exit."""
    if not _enabled:
        return _NullReconcileScope()
    return _ReconcileScope(controller)


class _NullReconcileScope:
    __slots__ = ()

    def __enter__(self) -> _NullScope:
        return _NULL_SCOPE

    def __exit__(self, *exc):
        return False


def current_scope():
    """The thread's active reconcile scope (``_NULL_SCOPE`` outside
    one) — the seam the trace-annotation call site reads the stage-CPU
    breakdown from."""
    scope = getattr(_tls, "scope", None)
    return scope if scope is not None else _NULL_SCOPE


def current_stages() -> tuple[str, ...]:
    """Names of the thread's open stage brackets, outermost first
    (``("driver-mutate", "aws:ga.CreateAccelerator")`` inside an
    instrumented AWS call).  The runtime side of the confinement
    cross-check: racecheck tags observed shared-state mutations with
    this tuple so they can be matched against the static stage
    footprint table."""
    stack = getattr(_tls, "frames", None)
    if not stack:
        return ()
    return tuple(frame.name for frame in stack)


def current_stage() -> Optional[str]:
    """The innermost open stage bracket, or None outside any."""
    stack = getattr(_tls, "frames", None)
    return stack[-1].name if stack else None


# ---------------------------------------------------------------------------
# flush + process-global aggregate
# ---------------------------------------------------------------------------

_agg_lock = threading.Lock()
_agg: dict[str, list[float]] = {}  # stage -> [cpu, wall, hits]
_agg_reconciles = 0


def _flush_stage(name: str, controller: str, cpu: float, wall: float) -> None:
    metrics = instruments.profile_instruments()
    metrics.stage_cpu.labels(stage=name, controller=controller).observe(cpu)
    metrics.stage_wall.labels(stage=name, controller=controller).observe(wall)
    with _agg_lock:
        entry = _agg.get(name)
        if entry is None:
            _agg[name] = [cpu, wall, 1.0]
        else:
            entry[0] += cpu
            entry[1] += wall
            entry[2] += 1.0


def _flush_scope(scope: _Scope, total_cpu: float, total_wall: float) -> None:
    global _agg_reconciles
    metrics = instruments.profile_instruments()
    for name, (cpu, wall, hits) in scope.totals.items():
        metrics.stage_cpu.labels(stage=name, controller=scope.controller).observe(cpu)
        metrics.stage_wall.labels(stage=name, controller=scope.controller).observe(wall)
    if total_wall > 0:
        metrics.cpu_wall_ratio.labels(controller=scope.controller).set(
            min(1.0, total_cpu / total_wall)
        )
    metrics.reconciles.labels(controller=scope.controller).inc()
    with _agg_lock:
        _agg_reconciles += 1
        for name, (cpu, wall, hits) in scope.totals.items():
            entry = _agg.get(name)
            if entry is None:
                _agg[name] = [cpu, wall, hits]
            else:
                entry[0] += cpu
                entry[1] += wall
                entry[2] += hits


def reset_aggregate() -> None:
    """Zero the process-global attribution aggregate (bench phase
    boundaries; tests)."""
    global _agg_reconciles
    with _agg_lock:
        _agg.clear()
        _agg_reconciles = 0


def aggregate_snapshot() -> dict:
    """{"reconciles": N, "stages": {stage: {cpu_seconds, wall_seconds,
    hits}}} — the raw aggregate ``attribution_table`` ranks."""
    with _agg_lock:
        return {
            "reconciles": _agg_reconciles,
            "stages": {
                name: {
                    "cpu_seconds": entry[0],
                    "wall_seconds": entry[1],
                    "hits": int(entry[2]),
                }
                for name, entry in sorted(_agg.items())
            },
        }


def attribution_table(top: Optional[int] = None) -> list[dict]:
    """The ranked CPU attribution table off the process aggregate:
    one row per stage, hottest CPU first, each carrying total CPU/wall
    seconds, hit count, and ``cpu_ns_per_reconcile`` (the per-stage
    regression rail the bench pins — total stage CPU spread over every
    reconcile the accountant closed)."""
    snap = aggregate_snapshot()
    per = max(1, snap["reconciles"])
    rows = [
        {
            "stage": name,
            "cpu_seconds": round(entry["cpu_seconds"], 9),
            "wall_seconds": round(entry["wall_seconds"], 9),
            "hits": entry["hits"],
            "cpu_ns_per_reconcile": int(entry["cpu_seconds"] / per * 1e9),
        }
        for name, entry in snap["stages"].items()
    ]
    rows.sort(key=lambda r: (-r["cpu_seconds"], r["stage"]))
    return rows[:top] if top else rows


# ---------------------------------------------------------------------------
# exposition-based attribution (fleet-merged view)
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^agac_profile_stage_(?P<kind>cpu|wall)_seconds_(?P<part>sum|count)"
    r"\{(?P<labels>[^}]*)\}\s+(?P<value>\S+)$"
)
_STAGE_LABEL_RE = re.compile(r'stage="((?:[^"\\]|\\.)*)"')


def attribution_from_exposition(text: str, top: Optional[int] = None) -> list[dict]:
    """The same ranked table computed from a Prometheus text
    exposition — pointed at ``/metrics/fleet`` this is the
    fleet-merged attribution across every shard replica (the
    merge path sums the stage histograms sample-by-sample, so summing
    per-stage ``_sum``/``_count`` over controllers here completes the
    merge)."""
    stages: dict[str, dict[str, float]] = {}
    for line in text.splitlines():
        m = _SAMPLE_RE.match(line.strip())
        if m is None:
            continue
        label_m = _STAGE_LABEL_RE.search(m.group("labels"))
        if label_m is None:
            continue
        name = label_m.group(1)
        entry = stages.setdefault(
            name, {"cpu_sum": 0.0, "wall_sum": 0.0, "count": 0.0}
        )
        value = float(m.group("value"))
        if m.group("kind") == "cpu":
            if m.group("part") == "sum":
                entry["cpu_sum"] += value
            else:
                entry["count"] += value
        elif m.group("part") == "sum":
            entry["wall_sum"] += value
    rows = [
        {
            "stage": name,
            "cpu_seconds": round(entry["cpu_sum"], 9),
            "wall_seconds": round(entry["wall_sum"], 9),
            "hits": int(entry["count"]),
            "cpu_ns_per_hit": (
                int(entry["cpu_sum"] / entry["count"] * 1e9) if entry["count"] else 0
            ),
        }
        for name, entry in stages.items()
    ]
    rows.sort(key=lambda r: (-r["cpu_seconds"], r["stage"]))
    return rows[:top] if top else rows
