"""The autoscaler loop: collect → evaluate → record → (maybe) act.

One ``tick()`` is the whole control loop: take a ``SignalSnapshot``
from the collector, run it through the ``ScalePolicy``, stamp the
verdict into the metrics and the flight recorder (EVERY decision,
acted or suppressed, with its full evidence), keep it in the bounded
decision history the ``/debug/autoscaler`` endpoint serves, and — only
when the policy says ``executed`` — call the injected resize executor
(production: ``Manager.request_resize`` through the ring-lease CAS
path; sim: the harness's traced ``request_resize``) and hand the epoch
it returns back to the policy, which tells its own resizes from the
fleet's by it.

The driver is environment-shaped, the loop is not: ``cmd/root`` runs
``run()`` on a daemon thread beside the SLO engine's, the sim harness
schedules ``tick()`` on its virtual-time scheduler.  An executor
exception is captured onto the decision (rail ``execute-error``,
``executed`` flipped back off) and never escapes — the policy's
cooldown still starts, so a persistently failing resize cannot
hot-loop.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Optional

from .. import klog
from ..observability import instruments
from ..observability import recorder as obs_recorder
from .policy import RAIL_EXECUTE_ERROR, ScalePolicy
from .signals import ScaleSignals

RECORD_KIND = "autoscale"
DEFAULT_HISTORY = 256
DEFAULT_INTERVAL = 30.0


class AutoscalerLoop:
    def __init__(
        self,
        signals: ScaleSignals,
        policy: ScalePolicy,
        execute: Optional[Callable[[int], object]] = None,
        registry=None,
        flight_recorder=None,
        history_limit: int = DEFAULT_HISTORY,
    ):
        self.signals = signals
        self.policy = policy
        self._execute = execute
        self._recorder = (
            flight_recorder
            if flight_recorder is not None
            else obs_recorder.flight_recorder()
        )
        self._metrics = instruments.autoscaler_instruments(registry)
        self._lock = threading.Lock()
        self._history: deque = deque(maxlen=max(1, history_limit))
        self.ticks = 0
        self.executed_total = 0
        self.last_decision = None

    # ------------------------------------------------------------------
    # the control loop body
    # ------------------------------------------------------------------
    def tick(self):
        """One full evaluation; returns the (recorded) Decision."""
        snapshot = self.signals.collect()
        decision = self.policy.evaluate(snapshot)
        if decision.executed:
            try:
                self.policy.note_executed(self._execute_target(decision.target_shards))
            except Exception as err:
                decision.executed = False
                decision.rails = decision.rails + (RAIL_EXECUTE_ERROR,)
                decision.error = str(err)
                klog.errorf(
                    "autoscaler: resize to %d failed: %s",
                    decision.target_shards, err,
                )
        with self._lock:
            self.ticks += 1
            if decision.executed:
                self.executed_total += 1
            self.last_decision = decision
            self._history.append(decision)
        self._metrics.target_shards.set(float(decision.target_shards))
        self._metrics.decisions.labels(
            action=decision.action, reason=decision.reason
        ).inc()
        for rail in decision.rails:
            self._metrics.suppressed.labels(rail=rail).inc()
        self._recorder.record(RECORD_KIND, **decision.to_dict())
        return decision

    def _execute_target(self, target: int):
        if self._execute is None:
            raise RuntimeError("autoscaler has no resize executor wired")
        return self._execute(target)

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------
    def status(self) -> dict:
        """The /healthz ``autoscaler`` block."""
        cfg = self.policy.config
        with self._lock:
            last = self.last_decision
            ticks = self.ticks
            executed = self.executed_total
        status = {
            "enabled": cfg.enabled,
            "observe_only": cfg.observe_only,
            "min_shards": cfg.min_shards,
            "max_shards": cfg.max_shards,
            "evaluations": ticks,
            "executed_total": executed,
        }
        if last is not None:
            status["last_decision"] = {
                "time": round(last.time, 3),
                "action": last.action,
                "reason": last.reason,
                "target_shards": last.target_shards,
                "executed": last.executed,
                "rails": list(last.rails),
            }
        return status

    def history(self, limit: int = 0) -> list[dict]:
        """Decisions oldest → newest (``limit`` > 0 keeps the most
        recent that many) — the /debug/autoscaler body."""
        with self._lock:
            decisions = list(self._history)
        if limit > 0:
            decisions = decisions[-limit:]
        return [decision.to_dict() for decision in decisions]

    # ------------------------------------------------------------------
    # the threaded driver (production; the sim schedules tick() itself)
    # ------------------------------------------------------------------
    def run(self, stop: threading.Event, interval: float = DEFAULT_INTERVAL) -> None:
        while not stop.wait(interval):
            try:
                self.tick()
            except Exception as err:  # the loop must outlive any tick
                klog.errorf("autoscaler: evaluation failed: %s", err)
