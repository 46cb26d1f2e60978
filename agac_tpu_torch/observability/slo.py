"""The convergence SLO engine: declared objectives, multi-window burn
rates, and burn-gated shedding of deferrable load.

Arcturus (arxiv 2507.10928) attributes global-accelerator stability to
continuously monitored, budget-gated control actions; Swift (arxiv
2501.19051) shows control-plane TAIL latency is what bites at elastic
scale.  This engine turns the journey tracker's convergence-latency
histograms (``observability/journey.py``) into exactly that control
signal:

- **Objectives** are declarative: "99% of spec-triggered
  GlobalAccelerator journeys converge within 120 s"
  (``ga_converge_p99 < 120s``).  Thresholds MUST sit on a
  ``JOURNEY_BUCKETS`` bound — "good" journeys are counted straight off
  the histogram's cumulative buckets, so there is nothing to sample
  and nothing to store per journey.
- **Burn rates** are computed over sliding windows (default 5 m and
  1 h) from periodic snapshots of each objective's cumulative
  (good, total) counters: ``burn = bad_fraction / error_budget``.
  1.0 burns the budget exactly at the sustainable rate; the classic
  multi-window rule (BOTH windows burning) separates a real sustained
  regression from a transient blip.
- **Shedding**: while every window burns past ``shed_burn``, the
  engine flags ``shedding`` — consumers (the GC sweeper, the drift
  resync ticker, ``Manager.drift_tick``/``gc_sweep``) skip their next
  deferrable round and count it in ``agac_slo_sheds_total``.  The shed
  order doctrine: GC sweeps first (pure background), then drift
  resync pacing (repair latency degrades, correctness does not);
  user-facing event reconciles are NEVER shed — they are the very
  thing the budget protects.  Hysteresis clears shedding once the
  short window cools to half the trip threshold.

Everything exports as metrics, rides ``/healthz`` as a summary block,
and serves in full (objectives, burn rates, slowest in-flight
journeys) on the new ``/slo`` endpoint.

One process-global engine slot (``engine()``/``install_engine()``):
``cmd/root`` installs the production engine, the sim harness installs
a per-scenario one on virtual time, and the default (no engine) makes
every gate a no-op — exactly the tracer/recorder pattern.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from .. import clockseam
from . import instruments
from . import journey as journey_mod
from . import metrics as metrics_mod
from .instruments import JOURNEY_BUCKETS
from .metrics import MetricsRegistry

# the controller queue labels the three controllers stamp journeys
# under (worker-spec names == workqueue names == reconcile labels)
GA_CONTROLLERS = (
    "global-accelerator-controller-service",
    "global-accelerator-controller-ingress",
)
RECORD_CONTROLLERS = (
    "route53-controller-service",
    "route53-controller-ingress",
)
BINDING_CONTROLLERS = ("endpoint-group-binding-controller",)
ALL_CONTROLLERS = GA_CONTROLLERS + RECORD_CONTROLLERS + BINDING_CONTROLLERS

DEFAULT_WINDOWS = (300.0, 3600.0)
# both windows past this burn rate trips shedding; the short window
# cooling below half of it clears (hysteresis)
DEFAULT_SHED_BURN = 1.0


@dataclass(frozen=True)
class SLOObjective:
    """One declared objective: ``target`` of the selected journeys
    must converge within ``threshold_seconds`` (a JOURNEY_BUCKETS
    bound).  ``controllers`` selects histogram series; ``trigger``
    narrows to one journey trigger ("" = all)."""

    name: str
    threshold_seconds: float
    controllers: tuple[str, ...]
    trigger: str = journey_mod.TRIGGER_SPEC
    target: float = 0.99

    def __post_init__(self):
        if self.threshold_seconds not in JOURNEY_BUCKETS:
            raise ValueError(
                f"objective {self.name!r}: threshold "
                f"{self.threshold_seconds} must be one of the journey "
                f"histogram bucket bounds {JOURNEY_BUCKETS}"
            )


def default_objectives() -> tuple[SLOObjective, ...]:
    """The shipped objective set (docs/operations.md "Convergence
    SLOs"): GA chains within 2 minutes, Route53 records and bindings
    within 1 minute, drift repairs within 2 minutes — each at p99."""
    return (
        SLOObjective("ga_converge_p99", 120.0, GA_CONTROLLERS),
        SLOObjective("record_converge_p99", 60.0, RECORD_CONTROLLERS),
        SLOObjective("binding_converge_p99", 60.0, BINDING_CONTROLLERS),
        SLOObjective(
            "drift_repair_p99", 120.0, ALL_CONTROLLERS,
            trigger=journey_mod.TRIGGER_DRIFT,
        ),
    )


def estimate_quantile(
    buckets: list[tuple[float, float]], count: float, q: float
) -> float:
    """Linear-interpolated quantile from cumulative (le, count)
    buckets — Prometheus's histogram_quantile, for the /slo view."""
    if count <= 0:
        return 0.0
    rank = q * count
    prev_bound, prev_cum = 0.0, 0.0
    for bound, cum in buckets:
        if cum >= rank:
            span = cum - prev_cum
            if span <= 0:
                return bound
            return prev_bound + (bound - prev_bound) * (rank - prev_cum) / span
        prev_bound, prev_cum = bound, cum
    return buckets[-1][0] if buckets else 0.0


@dataclass
class _Snapshot:
    time: float
    # objective name -> (good, total)
    counts: dict[str, tuple[float, float]] = field(default_factory=dict)


class SLOEngine:
    """Periodically ``tick()``-ed evaluator over the journey converge
    histogram in ``registry`` (where the active tracker writes)."""

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        objectives: Optional[tuple[SLOObjective, ...]] = None,
        clock: Callable[[], float] = clockseam.monotonic,
        windows: tuple[float, ...] = DEFAULT_WINDOWS,
        shed_burn: float = DEFAULT_SHED_BURN,
        journey_tracker: Optional["journey_mod.JourneyTracker"] = None,
        shed_gates: bool = True,
    ):
        self._clock = clock
        self._registry = registry
        self.objectives = (
            objectives if objectives is not None else default_objectives()
        )
        self.windows = tuple(sorted(windows))
        self.shed_burn = shed_burn
        self._journey = journey_tracker
        self._lock = threading.Lock()
        self._history: deque[_Snapshot] = deque()
        self._burn: dict[str, dict[float, float]] = {}
        self.shedding = False
        self.shed_activations = 0
        # False = observe-only: the burn state machine (and its
        # metrics) still run, but should_shed() never defers work —
        # the sim harness's default, so scenario timing only changes
        # when a scenario opts into shedding
        self.shed_gates = shed_gates
        self._metrics = instruments.slo_instruments(registry)
        self._metrics.shedding.set_function(lambda: 1.0 if self.shedding else 0.0)

    # ------------------------------------------------------------------
    # histogram reads
    # ------------------------------------------------------------------
    def _converge_metric(self):
        registry = (
            self._registry
            if self._registry is not None
            else metrics_mod.registry()
        )
        return registry.get("agac_journey_converge_seconds")

    def _objective_counts(self, objective: SLOObjective) -> tuple[float, float]:
        """Cumulative (good, total) for one objective off the journey
        histogram's bucket counters — good = journeys ≤ threshold."""
        metric = self._converge_metric()
        if metric is None:
            return 0.0, 0.0
        bucket_index = metric.buckets.index(objective.threshold_seconds)
        good = total = 0.0
        with metric._lock:
            children = list(metric._children.items())
        for values, child in children:
            labels = dict(zip(metric.label_names, values))
            if labels.get("controller") not in objective.controllers:
                continue
            if objective.trigger and labels.get("trigger") != objective.trigger:
                continue
            counts, _sum, count = child.histogram_snapshot()
            good += counts[bucket_index]
            total += count
        return good, total

    def _objective_buckets(self, objective: SLOObjective) -> tuple[list, float]:
        """Merged cumulative (le, count) buckets for the quantile
        estimate."""
        metric = self._converge_metric()
        if metric is None:
            return [], 0.0
        merged = [0.0] * len(metric.buckets)
        total = 0.0
        with metric._lock:
            children = list(metric._children.items())
        for values, child in children:
            labels = dict(zip(metric.label_names, values))
            if labels.get("controller") not in objective.controllers:
                continue
            if objective.trigger and labels.get("trigger") != objective.trigger:
                continue
            counts, _sum, count = child.histogram_snapshot()
            for i, c in enumerate(counts):
                merged[i] += c
            total += count
        return list(zip(metric.buckets, merged)), total

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def tick(self) -> dict:
        """One evaluation round: snapshot cumulative counts, compute
        per-window burn rates, update gauges and the shed state.
        Returns the burn map (tests/logging)."""
        now = self._clock()
        snapshot = _Snapshot(time=now)
        for objective in self.objectives:
            snapshot.counts[objective.name] = self._objective_counts(objective)
        with self._lock:
            self._history.append(snapshot)
            horizon = now - self.windows[-1] - 60.0
            while len(self._history) > 2 and self._history[1].time <= horizon:
                self._history.popleft()
            burn = {
                objective.name: {
                    window: self._burn_rate_locked(objective, window, snapshot)
                    for window in self.windows
                }
                for objective in self.objectives
            }
            self._burn = burn
            worst = {
                window: max(
                    (burn[obj.name][window] for obj in self.objectives),
                    default=0.0,
                )
                for window in self.windows
            }
            if not self.shedding and all(
                rate >= self.shed_burn for rate in worst.values()
            ):
                self.shedding = True
                self.shed_activations += 1
            elif self.shedding and worst[self.windows[0]] < self.shed_burn / 2:
                self.shedding = False
        for objective in self.objectives:
            good, total = snapshot.counts[objective.name]
            healthy = total == 0 or good / total >= objective.target
            self._metrics.healthy.labels(objective=objective.name).set(
                1.0 if healthy else 0.0
            )
            buckets, count = self._objective_buckets(objective)
            self._metrics.p99.labels(objective=objective.name).set(
                estimate_quantile(buckets, count, objective.target)
            )
            for window in self.windows:
                self._metrics.burn_rate.labels(
                    objective=objective.name, window=f"{window:g}s"
                ).set(burn[objective.name][window])
        self._metrics.evaluations.inc()
        return burn

    def _burn_rate_locked(
        self, objective: SLOObjective, window: float, latest: _Snapshot
    ) -> float:
        """bad_fraction over the window / the objective's error budget
        (1 - target); 0 with no observations in the window."""
        base: Optional[_Snapshot] = None
        cutoff = latest.time - window
        for snapshot in self._history:
            if snapshot.time <= cutoff:
                base = snapshot
            else:
                break
        if base is None:
            base = self._history[0]
        good0, total0 = base.counts.get(objective.name, (0.0, 0.0))
        good1, total1 = latest.counts.get(objective.name, (0.0, 0.0))
        total_delta = total1 - total0
        if total_delta <= 0:
            return 0.0
        bad_delta = max(0.0, total_delta - (good1 - good0))
        budget = max(1e-9, 1.0 - objective.target)
        return (bad_delta / total_delta) / budget

    # ------------------------------------------------------------------
    # gates + views
    # ------------------------------------------------------------------
    def should_shed(self, action: str) -> bool:
        """The deferrable-load gate: True while shedding (and gates
        are armed), counting the skipped action."""
        if not self.shed_gates or not self.shedding:
            return False
        self._metrics.sheds.labels(action=action).inc()
        return True

    def burn_snapshot(self) -> dict[str, dict[float, float]]:
        """The last ``tick()``'s burn map, copied under the lock:
        ``{objective name: {window seconds: burn rate}}``.  This is
        the stable in-process read the autoscaler's signal collector
        consumes — identical numbers to the ``/slo`` endpoint's
        ``burn`` blocks, but keyed by the raw float window (no string
        formatting) and safe to call from any thread.  Empty until
        the first tick."""
        with self._lock:
            return {name: dict(per) for name, per in self._burn.items()}

    def violations(self) -> list[str]:
        """Objectives whose CUMULATIVE good fraction misses the target
        — the sim/fuzz oracle's verdict (a whole-run property, not a
        window)."""
        out = []
        for objective in self.objectives:
            good, total = self._objective_counts(objective)
            if total > 0 and good / total < objective.target:
                out.append(
                    f"slo: {objective.name} violated — "
                    f"{total - good:.0f}/{total:.0f} journeys exceeded "
                    f"{objective.threshold_seconds:g}s "
                    f"(good {good / total:.4f} < target {objective.target})"
                )
        return out

    def status(self) -> dict:
        """The /slo endpoint body + the /healthz summary block."""
        with self._lock:
            burn = {
                name: {f"{window:g}s": round(rate, 3) for window, rate in per.items()}
                for name, per in self._burn.items()
            }
            shedding = self.shedding
            activations = self.shed_activations
        objectives = []
        for objective in self.objectives:
            good, total = self._objective_counts(objective)
            buckets, count = self._objective_buckets(objective)
            objectives.append(
                {
                    "name": objective.name,
                    "threshold_s": objective.threshold_seconds,
                    "target": objective.target,
                    "trigger": objective.trigger,
                    "journeys": int(total),
                    "good_fraction": round(good / total, 5) if total else None,
                    "estimated_quantile_s": round(
                        estimate_quantile(buckets, count, objective.target), 3
                    ),
                    "burn": burn.get(objective.name, {}),
                    "healthy": total == 0 or good / total >= objective.target,
                }
            )
        status = {
            "enabled": True,
            "objectives": objectives,
            "windows_s": list(self.windows),
            "shed_burn": self.shed_burn,
            "shed_gates": self.shed_gates,
            "shedding": shedding,
            "shed_activations": activations,
        }
        if self._journey is not None:
            status["journeys"] = self._journey.stats()
            status["slowest_unconverged"] = self._journey.slowest()
        return status


# ---------------------------------------------------------------------------
# the process-global engine slot: None by default (every gate no-ops),
# installed by cmd/root (production) and the sim harness (virtual time)
# ---------------------------------------------------------------------------

_engine: Optional[SLOEngine] = None


def engine() -> Optional[SLOEngine]:
    return _engine


def install_engine(new_engine: Optional[SLOEngine]) -> Optional[SLOEngine]:
    global _engine
    previous = _engine
    _engine = new_engine
    return previous


def should_shed(action: str) -> bool:
    """The global deferrable-load gate the GC sweeper and drift
    tickers consult: False when no engine is installed."""
    current = _engine
    return current is not None and current.should_shed(action)


def status_or_disabled() -> dict:
    current = _engine
    return current.status() if current is not None else {"enabled": False}
