"""The autoscaler's signal collector: one ``collect()`` call per
evaluation, reading every input through a stable in-process API —
never by scraping the process's own endpoints.

The sources (and their accessors):

- the installed SLO engine — per-objective multi-window burn rates
  (``SLOEngine.burn_snapshot()``) and the objective declarations
  themselves (``SLOEngine.objectives``, from which the collector
  derives which AWS service each objective's burn depends on);
- the journey tracker — live backlog (``inflight()``) and the
  single-wedged-object signal
  (``JourneyTracker.oldest_unconverged_age()``);
- the ring-lease plane — shard count / resize transition state and
  epoch (``resize_status()``-shaped callable) and the per-shard keys-owned
  census (the load board's input);
- the API health plane — services whose circuit is currently open
  (``HealthTracker.open_services()``-shaped callable), feeding the
  policy's brownout exclusion;
- the fleet — live replica count.

Everything lands in one immutable-ish ``SignalSnapshot`` stamped with
the seam clock, so the policy evaluates a self-consistent instant and
the flight record can reproduce exactly what the policy saw.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

from .. import clockseam

# the two AWS service families the controllers' objectives ride on
# (HealthTracker circuit names)
SERVICE_ROUTE53 = "route53"
SERVICE_GA = "globalaccelerator"


def services_for_controllers(controllers: Iterable[str]) -> frozenset[str]:
    """Which AWS services an objective's controllers call: route53
    controllers hit the Route53 API, everything else (GA chains,
    endpoint-group bindings) hits Global Accelerator."""
    return frozenset(
        SERVICE_ROUTE53 if name.startswith("route53") else SERVICE_GA
        for name in controllers
    )


@dataclass
class SignalSnapshot:
    """Everything one policy evaluation sees, at one seam-clock
    instant."""

    time: float
    shard_count: int
    resize_state: str
    handoff_pending: int = 0
    # objective name -> {window seconds -> burn rate}
    burn: dict = field(default_factory=dict)
    # objective name -> frozenset of AWS services its burn depends on
    objective_services: dict = field(default_factory=dict)
    oldest_age: float = 0.0
    inflight: int = 0
    # shard index (str) -> managed keys owned, from the load board
    keys_by_shard: dict = field(default_factory=dict)
    replica_count: int = 0
    open_circuits: frozenset = frozenset()
    # the ring lease's resize epoch as this replica last read it (None
    # when the source does not carry one)
    epoch: Optional[int] = None

    def to_dict(self) -> dict:
        return {
            "time": round(self.time, 3),
            "shard_count": self.shard_count,
            "resize_state": self.resize_state,
            "handoff_pending": self.handoff_pending,
            "burn": {
                name: {f"{w:g}s": round(r, 3) for w, r in per.items()}
                for name, per in sorted(self.burn.items())
            },
            "oldest_unconverged_age_s": round(self.oldest_age, 3),
            "inflight": self.inflight,
            "keys_by_shard": dict(self.keys_by_shard),
            "replica_count": self.replica_count,
            "open_circuits": sorted(self.open_circuits),
        }


class ScaleSignals:
    """Injected-accessor collector.  Every source degrades to a
    harmless default when absent or briefly broken (a replica mid
    shutdown, a lease read racing a CAS): a snapshot that produces a
    hold is always better than an autoscaler that dies."""

    def __init__(
        self,
        slo_engine=None,
        journey_tracker=None,
        resize_status: Optional[Callable[[], dict]] = None,
        keys_by_shard: Optional[Callable[[], dict]] = None,
        replica_count: Optional[Callable[[], int]] = None,
        open_circuits: Optional[Callable[[], Iterable[str]]] = None,
        clock: Callable[[], float] = clockseam.monotonic,
    ):
        self._slo = slo_engine
        self._journey = journey_tracker
        self._resize_status = resize_status
        self._keys_by_shard = keys_by_shard
        self._replica_count = replica_count
        self._open_circuits = open_circuits
        self._clock = clock

    @staticmethod
    def _safe(fn, default):
        if fn is None:
            return default
        try:
            value = fn()
        except Exception:
            return default
        return value if value is not None else default

    def collect(self) -> SignalSnapshot:
        status = self._safe(self._resize_status, {})
        burn: dict = {}
        objective_services: dict = {}
        if self._slo is not None:
            try:
                burn = self._slo.burn_snapshot()
                objective_services = {
                    obj.name: services_for_controllers(obj.controllers)
                    for obj in self._slo.objectives
                }
            except Exception:
                burn, objective_services = {}, {}
        oldest_age, inflight = 0.0, 0
        if self._journey is not None:
            try:
                oldest_age = self._journey.oldest_unconverged_age()
                inflight = self._journey.inflight()
            except Exception:
                oldest_age, inflight = 0.0, 0
        epoch = status.get("epoch")
        return SignalSnapshot(
            time=self._clock(),
            shard_count=int(status.get("shard_count") or 1),
            resize_state=str(status.get("state", "stable")),
            handoff_pending=int(status.get("handoff_pending") or 0),
            burn=burn,
            objective_services=objective_services,
            oldest_age=oldest_age,
            inflight=inflight,
            keys_by_shard=dict(self._safe(self._keys_by_shard, {})),
            replica_count=int(self._safe(self._replica_count, 0)),
            open_circuits=frozenset(self._safe(self._open_circuits, ())),
            epoch=int(epoch) if epoch is not None else None,
        )
