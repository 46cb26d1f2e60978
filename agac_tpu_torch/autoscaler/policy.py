"""The scale policy: sustained SLO signals in, a railed shard-count
decision out.

Swift (arxiv 2501.19051) argues elastic control planes live or die on
fast but *safe* scale decisions; Arcturus (arxiv 2507.10928) credits
global-accelerator stability to gradual, evidence-driven adjustment.
This engine encodes both doctrines as a pure, fake-clock-testable
state machine over ``SignalSnapshot``s:

- **Scale out** when the error budget is burning in BOTH windows for
  any admissible objective (the classic multi-window rule — a real
  sustained regression, not a blip), or when the oldest unconverged
  journey's age keeps growing across K consecutive evaluations (a
  wedge the burn windows have not caught yet).
- **Scale in** only on sustained headroom: every objective's burn
  under ``headroom_burn`` AND no old unconverged journey, across a
  longer consecutive-evaluation window than scale-out needs.
- **Brownout exclusion**: an objective whose controllers talk to a
  service with an OPEN circuit is excluded from scale-out evidence —
  burn caused by a provider outage is not a capacity problem, and
  doubling the fleet would double the retry pressure on a browned-out
  API.  Oldest-age growth is likewise ignored while any circuit is
  open (wedged journeys during an outage are the outage's fault).

Every desire then passes the hard rails, in order: global kill
switch, transition-in-progress (never resize while the ring is mid
drain/handoff), per-direction cooldowns measured from the last
EXECUTED resize (sized to outlast the placement hysteresis of the
membership plane and any in-flight transition), min/max clamping of
the ±1-doubling step, and observe-only.  A suppressed decision is
still a decision: the caller flight-records it with the full
evidence snapshot either way.

Every replica of a fleet runs its own loop over its own signals, and
any of them may execute a resize.  The last executed resize is the
FLEET's: a ring epoch this loop sees advance without having requested
it (another replica's decision, an operator's ``resize-shards``)
starts both cooldowns and resets the streaks as this loop's own
executed step does.  The loop reports the epochs it requested through
``note_executed``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .signals import SignalSnapshot

# decision actions
ACTION_OUT = "scale-out"
ACTION_IN = "scale-in"
ACTION_HOLD = "hold"

# evidence reasons (decisions_total's second label)
REASON_BURN = "burn"
REASON_AGE = "age-growth"
REASON_HEADROOM = "headroom"
REASON_STEADY = "steady"

# suppression rails (suppressed_total's label), in consultation order
RAIL_DISABLED = "disabled"
RAIL_TRANSITION = "transition-in-progress"
RAIL_COOLDOWN_OUT = "cooldown-out"
RAIL_COOLDOWN_IN = "cooldown-in"
RAIL_AT_MAX = "at-max"
RAIL_AT_MIN = "at-min"
RAIL_OBSERVE_ONLY = "observe-only"
# stamped by the loop when Manager.request_resize raised
RAIL_EXECUTE_ERROR = "execute-error"

RESIZE_STABLE = "stable"


@dataclass(frozen=True)
class ScalePolicyConfig:
    """Policy knobs + hard rails.  The cooldown defaults deliberately
    outlast the membership plane's placement hysteresis
    (``rebalance_cooldown_ticks`` × retry period ≈ 30 s) and any
    in-flight resize transition, so the autoscaler can never chase its
    own rebalance wake."""

    min_shards: int = 1
    max_shards: int = 8
    # both-window burn at/above this on any admissible objective is
    # scale-out evidence (1.0 = burning the budget exactly at the
    # sustainable rate)
    burn_threshold: float = 1.0
    # oldest-unconverged-age growth across this many CONSECUTIVE
    # evaluations is scale-out evidence, provided the age has cleared
    # the floor (young backlogs are normal churn, not starvation)
    age_growth_evals: int = 3
    age_floor_seconds: float = 60.0
    # scale-in wants sustained headroom: every burn under
    # headroom_burn and oldest age under the floor, across this many
    # consecutive evaluations (a longer window than scale-out needs)
    headroom_evals: int = 8
    headroom_burn: float = 0.25
    # per-direction cooldowns, measured from the fleet's last EXECUTED
    # resize in either direction
    cooldown_out_seconds: float = 120.0
    cooldown_in_seconds: float = 600.0
    # how long after a service's circuit RE-CLOSES its objectives stay
    # excluded from scale-out evidence: an outage's wedged journeys
    # only close (and burn) after the restore, so the burn attributable
    # to the outage arrives while the circuit is already healthy again
    brownout_hold_seconds: float = 300.0
    # global kill switch: evaluate + record, never act
    enabled: bool = True
    # observe-only: evaluate + record the recommendation, never act
    observe_only: bool = False

    def __post_init__(self):
        if self.min_shards < 1:
            raise ValueError("min_shards must be >= 1")
        if self.max_shards < self.min_shards:
            raise ValueError(
                f"max_shards {self.max_shards} < min_shards {self.min_shards}"
            )
        if self.headroom_evals < 1 or self.age_growth_evals < 1:
            raise ValueError("evaluation streaks must be >= 1")


@dataclass
class Decision:
    """One evaluation's verdict, suppressed or not — the flight-record
    payload.  ``executed`` is True only when the action cleared every
    rail (the loop flips it back off if the resize call then raises)."""

    time: float
    action: str
    reason: str
    current_shards: int
    target_shards: int
    executed: bool
    rails: tuple[str, ...] = ()
    evidence: dict = field(default_factory=dict)
    error: Optional[str] = None

    def to_dict(self) -> dict:
        out = {
            "time": round(self.time, 3),
            "action": self.action,
            "reason": self.reason,
            "current_shards": self.current_shards,
            "target_shards": self.target_shards,
            "executed": self.executed,
            "rails": list(self.rails),
            "evidence": self.evidence,
        }
        if self.error is not None:
            out["error"] = self.error
        return out


class ScalePolicy:
    """The evidence → decision state machine.  ``evaluate`` is driven
    off ``snapshot.time`` (never a wall clock), so the unit tier runs
    it on a fake clock and the sim on virtual time."""

    def __init__(self, config: Optional[ScalePolicyConfig] = None):
        self.config = config if config is not None else ScalePolicyConfig()
        self._last_resize_time: Optional[float] = None
        # the highest ring epoch seen or requested by this loop (None
        # until a snapshot carries one)
        self._ring_epoch: Optional[int] = None
        self._prev_oldest_age: Optional[float] = None
        self._age_growth_streak = 0
        self._headroom_streak = 0
        # service -> time until which its objectives stay excluded
        # (open circuit sightings extend it by brownout_hold_seconds)
        self._circuit_hold: dict[str, float] = {}

    # ------------------------------------------------------------------
    # evidence
    # ------------------------------------------------------------------
    def _effective_open(self, snapshot: SignalSnapshot) -> frozenset[str]:
        """Open circuits plus circuits that closed less than
        ``brownout_hold_seconds`` ago.  The hold matters because an
        outage's wedged journeys only complete (and hit the burn
        windows) AFTER the provider recovers — without it the policy
        would scale out on the outage's echo."""
        now = snapshot.time
        for service in snapshot.open_circuits:
            self._circuit_hold[service] = now + self.config.brownout_hold_seconds
        held = {s for s, until in self._circuit_hold.items() if until > now}
        return frozenset(snapshot.open_circuits) | held

    def _burn_evidence(
        self, snapshot: SignalSnapshot, effective_open: frozenset[str]
    ) -> tuple[list, list]:
        """(objectives burning in EVERY window, objectives excluded by
        an open-or-recently-open circuit on a service their
        controllers call)."""
        tripped, excluded = [], []
        for name, per_window in sorted(snapshot.burn.items()):
            services = snapshot.objective_services.get(name, frozenset())
            if services & effective_open:
                excluded.append(name)
                continue
            if per_window and all(
                rate >= self.config.burn_threshold
                for rate in per_window.values()
            ):
                tripped.append(name)
        return tripped, excluded

    def _update_streaks(
        self, snapshot: SignalSnapshot, effective_open: frozenset[str]
    ) -> None:
        cfg = self.config
        age = snapshot.oldest_age
        # age growth: above the floor AND strictly growing since the
        # previous evaluation; any open (or recently open) circuit
        # voids the evidence (wedged journeys during a brownout are
        # the provider's fault)
        growing = (
            age > cfg.age_floor_seconds
            and self._prev_oldest_age is not None
            and age > self._prev_oldest_age
            and not effective_open
        )
        self._age_growth_streak = self._age_growth_streak + 1 if growing else 0
        self._prev_oldest_age = age
        # headroom: every objective's every-window burn cool AND no
        # old unconverged journey
        cool = age < cfg.age_floor_seconds and all(
            rate < cfg.headroom_burn
            for per_window in snapshot.burn.values()
            for rate in per_window.values()
        )
        self._headroom_streak = self._headroom_streak + 1 if cool else 0

    def _observe_epoch(self, snapshot: SignalSnapshot) -> None:
        """A ring epoch past every one this loop has seen or requested
        is a resize someone else executed: it starts the cooldowns and
        resets the streaks, as this loop's own executed step does.  The
        first epoch seen is the baseline; a lower one (a replica that
        has not read the ring lease yet) is ignored."""
        epoch = snapshot.epoch
        if epoch is None:
            return
        if self._ring_epoch is not None and epoch > self._ring_epoch:
            self._last_resize_time = snapshot.time
            self._age_growth_streak = 0
            self._headroom_streak = 0
        self._ring_epoch = max(epoch, self._ring_epoch or 0)

    def note_executed(self, epoch) -> None:
        """The ring epoch this loop's executed resize produced (the
        executor's return; anything but an int is ignored)."""
        if isinstance(epoch, int):
            self._ring_epoch = max(epoch, self._ring_epoch or 0)

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def evaluate(self, snapshot: SignalSnapshot) -> Decision:
        cfg = self.config
        now = snapshot.time
        self._observe_epoch(snapshot)
        current = max(1, snapshot.shard_count)
        effective_open = self._effective_open(snapshot)
        tripped, excluded = self._burn_evidence(snapshot, effective_open)
        self._update_streaks(snapshot, effective_open)
        age_streak = self._age_growth_streak
        headroom_streak = self._headroom_streak

        if tripped:
            action, reason = ACTION_OUT, REASON_BURN
        elif age_streak >= cfg.age_growth_evals:
            action, reason = ACTION_OUT, REASON_AGE
        elif headroom_streak >= cfg.headroom_evals:
            action, reason = ACTION_IN, REASON_HEADROOM
        else:
            action, reason = ACTION_HOLD, REASON_STEADY

        # max-step: one doubling (or halving) per decision
        if action == ACTION_OUT:
            target = min(current * 2, cfg.max_shards)
        elif action == ACTION_IN:
            target = max(current // 2, cfg.min_shards)
        else:
            target = current

        rails = []
        since_resize = (
            None
            if self._last_resize_time is None
            else now - self._last_resize_time
        )
        if action != ACTION_HOLD:
            if not cfg.enabled:
                rails.append(RAIL_DISABLED)
            if (
                snapshot.resize_state != RESIZE_STABLE
                or snapshot.handoff_pending > 0
            ):
                rails.append(RAIL_TRANSITION)
            if action == ACTION_OUT:
                if since_resize is not None and since_resize < cfg.cooldown_out_seconds:
                    rails.append(RAIL_COOLDOWN_OUT)
                if target <= current:
                    rails.append(RAIL_AT_MAX)
            else:
                if since_resize is not None and since_resize < cfg.cooldown_in_seconds:
                    rails.append(RAIL_COOLDOWN_IN)
                if target >= current:
                    rails.append(RAIL_AT_MIN)
            if cfg.observe_only and not rails:
                rails.append(RAIL_OBSERVE_ONLY)

        executed = action != ACTION_HOLD and not rails
        if executed:
            self._last_resize_time = now
            # an executed step resets the evidence streaks: the next
            # decision must re-earn its evidence under the new ring
            self._age_growth_streak = 0
            self._headroom_streak = 0

        evidence = {
            "burn": {
                name: {f"{window:g}s": round(rate, 3) for window, rate in per.items()}
                for name, per in sorted(snapshot.burn.items())
            },
            "burn_threshold": cfg.burn_threshold,
            "tripped_objectives": tripped,
            "excluded_objectives": excluded,
            "open_circuits": sorted(snapshot.open_circuits),
            "recently_open_circuits": sorted(
                effective_open - snapshot.open_circuits
            ),
            "oldest_unconverged_age_s": round(snapshot.oldest_age, 3),
            "age_floor_s": cfg.age_floor_seconds,
            "age_growth_streak": age_streak,
            "age_growth_evals": cfg.age_growth_evals,
            "headroom_streak": headroom_streak,
            "headroom_evals": cfg.headroom_evals,
            "headroom_burn": cfg.headroom_burn,
            "inflight": snapshot.inflight,
            "replica_count": snapshot.replica_count,
            "keys_by_shard": snapshot.keys_by_shard,
            "resize_state": snapshot.resize_state,
            "handoff_pending": snapshot.handoff_pending,
            "since_last_resize_s": (
                round(since_resize, 3) if since_resize is not None else None
            ),
            "cooldown_out_s": cfg.cooldown_out_seconds,
            "cooldown_in_s": cfg.cooldown_in_seconds,
            "min_shards": cfg.min_shards,
            "max_shards": cfg.max_shards,
        }
        return Decision(
            time=now,
            action=action,
            reason=reason,
            current_shards=current,
            target_shards=target,
            executed=executed,
            rails=tuple(rails),
            evidence=evidence,
        )
