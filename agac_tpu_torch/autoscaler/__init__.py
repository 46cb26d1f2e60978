"""SLO-driven shard autoscaler: closes the control loop
from the convergence SLO plane's burn rates and journey ages,
through an evidence-railed scale policy, to the sharding plane's live
``resize-shards`` two-phase transition.

Three layers, composed by the caller:

- :class:`ScaleSignals` (``signals.py``) — collects one
  :class:`SignalSnapshot` per evaluation from stable in-process APIs;
- :class:`ScalePolicy` (``policy.py``) — the pure, fake-clock-testable
  evidence → :class:`Decision` state machine with the hard rails;
- :class:`AutoscalerLoop` (``loop.py``) — drives evaluations, stamps
  metrics, flight-records every decision, executes through the
  injected resize path.
"""

from .loop import DEFAULT_INTERVAL, RECORD_KIND, AutoscalerLoop
from .policy import (
    ACTION_HOLD,
    ACTION_IN,
    ACTION_OUT,
    RAIL_AT_MAX,
    RAIL_AT_MIN,
    RAIL_COOLDOWN_IN,
    RAIL_COOLDOWN_OUT,
    RAIL_DISABLED,
    RAIL_EXECUTE_ERROR,
    RAIL_OBSERVE_ONLY,
    RAIL_TRANSITION,
    REASON_AGE,
    REASON_BURN,
    REASON_HEADROOM,
    REASON_STEADY,
    Decision,
    ScalePolicy,
    ScalePolicyConfig,
)
from .signals import ScaleSignals, SignalSnapshot, services_for_controllers

__all__ = [
    "ACTION_HOLD",
    "ACTION_IN",
    "ACTION_OUT",
    "AutoscalerLoop",
    "DEFAULT_INTERVAL",
    "Decision",
    "RAIL_AT_MAX",
    "RAIL_AT_MIN",
    "RAIL_COOLDOWN_IN",
    "RAIL_COOLDOWN_OUT",
    "RAIL_DISABLED",
    "RAIL_EXECUTE_ERROR",
    "RAIL_OBSERVE_ONLY",
    "RAIL_TRANSITION",
    "REASON_AGE",
    "REASON_BURN",
    "REASON_HEADROOM",
    "REASON_STEADY",
    "RECORD_KIND",
    "ScalePolicy",
    "ScalePolicyConfig",
    "ScaleSignals",
    "SignalSnapshot",
    "services_for_controllers",
]
