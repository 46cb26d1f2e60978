"""Scenario fuzzer over the sim harness.

One integer seed fully determines a scenario: the churn stream
(create / delete / toggle-managed / flip-hostname / racing spec
edits), the fault composition (throttle bursts × brownout outages ×
ambiguous-commit chaos × one-shot crash faults × leader churn), and
their timing — all drawn from one ``random.Random(seed)`` and played
on the deterministic scheduler.  Same seed ⇒ identical event-trace
hash ⇒ byte-identical replay, which is the whole debugging story: a
CI failure artifact is just ``{seed, profile}``.

After the active phase every fault is lifted, the world runs to
quiescence, and the invariant-oracle battery (``sim/oracles.py``)
plus the continuous GC/circuit oracles decide pass/fail.  The
runtime race/lock-order watchdog (``analysis/racecheck.py``) is armed
for the whole run.

``canary=`` deliberately seeds a bug (used by the mutation test that
proves the fuzzer CAN catch what it claims to catch):

- ``drop-txt-delete`` — record cleanup "forgets" to delete owner TXT
  records, splitting the atomic TXT+A pair: caught by the
  record-atomicity and convergence oracles.
- ``gc-stale-owner-cache`` — the GC sweeper's owner cross-check
  trusts a (broken) cache claiming every owner absent, and the grace
  period is disabled: live owners' accelerators get reaped — caught
  by the live-owner deletion oracle and convergence.  (This is the
  exact bug class the sweeper's apiserver re-verify rail and the
  ``delete-without-ownership-check`` lint rule exist to prevent.)

CLI (the CI ``sim`` job's corpus runner)::

    python -m agac_tpu_torch.sim.fuzz --seeds 1,2,3 --profile quick \
        --artifacts artifacts/

exits non-zero on any violation, writing one JSON artifact per
failing seed (violations + trace tail + replay instructions).
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass, field
from typing import Optional

from .. import apis, klog
from ..analysis import racecheck
from ..autoscaler import (
    ACTION_IN,
    ACTION_OUT,
    RAIL_OBSERVE_ONLY,
    ScalePolicyConfig,
)
from ..cloudprovider.aws.health import GA_OPS, ROUTE53_OPS, HealthConfig
from .harness import SimHarness, SimHarnessConfig
from .oracles import (
    CircuitBudgetOracle,
    GCDeletionOracle,
    arm_explain_probes,
    check_explain,
    check_resize_handoffs,
    check_slo,
    standard_oracles,
)

# ops the brownout composition can black out, grouped by service
_SERVICE_OPS = {
    "route53": ROUTE53_OPS,
    "globalaccelerator": GA_OPS,
}

# ops worth throttling / crashing (mutating chain + hot reads)
_FAULTABLE_OPS = [
    "create_accelerator", "update_accelerator", "delete_accelerator",
    "create_listener", "create_endpoint_group", "add_endpoints",
    "describe_accelerator", "list_accelerators",
    "describe_load_balancers", "change_resource_record_sets",
    "list_resource_record_sets", "list_hosted_zones",
]

_CRASHABLE_OPS = [
    "create_accelerator", "update_accelerator", "delete_accelerator",
    "create_listener", "create_endpoint_group",
    "change_resource_record_sets",
]

CANARIES = (
    "drop-txt-delete", "gc-stale-owner-cache", "slo-brownout", "explain-lie",
)

# the slo-brownout / explain-lie canaries' scripted GA outage window
# (virtual seconds) — the explain oracle fuzzes its checkpoints inside
_BROWNOUT_WINDOW = (60.0, 660.0)


@dataclass
class FuzzProfile:
    service_slots: int = 10
    ingress_slots: int = 3
    churn_ops: int = 60
    # virtual length of the active (churn + faults) phase
    active_seconds: float = 2400.0
    heal_seconds: float = 7200.0
    fault_compositions: int = 4
    max_leader_churn: int = 2
    chaos_budget: int = 0  # randomized retryable faults on every op
    hostname_fraction: float = 0.4


PROFILES = {
    # tier-1 shape: one scenario in single-digit wall seconds, still
    # big enough that every canary bug is observable (records exist
    # and get deleted, GC sweeps run inside the active window)
    "mini": FuzzProfile(
        service_slots=6,
        ingress_slots=0,
        churn_ops=30,
        active_seconds=900.0,
        heal_seconds=3600.0,
        fault_compositions=2,
        max_leader_churn=1,
        hostname_fraction=0.6,
    ),
    "quick": FuzzProfile(),
    "deep": FuzzProfile(
        service_slots=25,
        ingress_slots=6,
        churn_ops=220,
        active_seconds=14400.0,
        heal_seconds=14400.0,
        fault_compositions=10,
        max_leader_churn=4,
        chaos_budget=25,
    ),
}


@dataclass
class ScenarioResult:
    seed: int
    profile: str
    canary: Optional[str]
    trace_hash: str
    violations: list[str]
    stats: dict
    trace_tail: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations


def _nlb_hostname(i: int) -> str:
    return f"lb{i}-0123456789abcdef.elb.us-west-2.amazonaws.com"


def _install_canary(harness: SimHarness, canary: str) -> None:
    if canary == "drop-txt-delete":
        original = harness.aws.change_resource_record_sets

        def buggy(zone_id, changes):
            kept = [
                change
                for change in changes
                if not (
                    change.action == "DELETE"
                    and change.record_set.type == "TXT"
                )
            ]
            if not kept:
                return None
            return original(zone_id, kept)

        # instance attribute shadows the class method; the backend's
        # fault wrapper still applies on top
        harness.aws.change_resource_record_sets = buggy
    elif canary == "gc-stale-owner-cache":
        # the sweeper's owner cross-check reads a broken cache that
        # says every owner is gone, and grace is off: candidates are
        # "confirmed" and deleted while their owners live
        harness.controller_config.garbage_collector.grace_sweeps = 0

        def break_owner_check(h, stack):
            gc = stack.manager.gc
            if gc is not None:
                gc._owner_exists = lambda resource, ns, name: False

        harness.on_stack_built = break_owner_check
    elif canary == "slo-brownout":
        # the SLO oracle's mutation test: a sustained GA
        # outage far longer than the convergence objective — journeys
        # opened during it converge only after restore, burning the
        # error budget.  The oracle must flag the objectives AND the
        # burn-gated shedding (gates armed here, observe-only
        # elsewhere) must be observed deferring GC/drift work.
        harness.slo_engine.shed_gates = True
        ops = sorted(GA_OPS)
        harness.after(
            _BROWNOUT_WINDOW[0],
            lambda: harness.fault_plan.outage(*ops),
            "canary:slo-brownout",
        )
        harness.after(
            _BROWNOUT_WINDOW[1],
            lambda: harness.fault_plan.restore(*ops),
            "canary:slo-brownout-end",
        )
    elif canary == "explain-lie":
        # the explain oracle's mutation test: the same GA
        # brownout as slo-brownout, but every stack's classifier is
        # wrapped to swear everything is converged.  check_explain
        # must catch the lie (unconverged objects vouched for) — a
        # scenario where this canary passes means the oracle is blind.
        ops = sorted(GA_OPS)
        harness.after(
            _BROWNOUT_WINDOW[0],
            lambda: harness.fault_plan.outage(*ops),
            "canary:explain-lie",
        )
        harness.after(
            _BROWNOUT_WINDOW[1],
            lambda: harness.fault_plan.restore(*ops),
            "canary:explain-lie-end",
        )

        def lie(h, stack):
            engine = stack.manager.explain_engine
            if engine is None:
                return

            def lying_classify(controller, key, _orig=engine.classify):
                answer = _orig(controller, key)
                answer["verdict"] = "converged"
                return answer

            engine.classify = lying_classify

        harness.on_stack_built = lie
    else:
        raise ValueError(f"unknown canary {canary!r} (have {CANARIES})")


def _make_service(name: str, slot: int, hostname_annotated: bool):
    from ..cluster import ObjectMeta, Service, ServicePort
    from ..cluster.objects import LoadBalancerIngress, ServiceSpec

    annotations = {
        apis.AWS_LOAD_BALANCER_TYPE_ANNOTATION: "external",
        apis.AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION: "true",
    }
    if hostname_annotated:
        annotations[apis.ROUTE53_HOSTNAME_ANNOTATION] = f"app{slot}.example.com"
    svc = Service(
        metadata=ObjectMeta(
            name=name, namespace="default", annotations=annotations
        ),
        spec=ServiceSpec(
            type="LoadBalancer",
            ports=[ServicePort(name="p80", port=80, protocol="TCP")],
        ),
    )
    svc.status.load_balancer.ingress.append(
        LoadBalancerIngress(hostname=_nlb_hostname(slot))
    )
    return svc


def run_scenario(
    seed: int,
    profile: str = "quick",
    canary: Optional[str] = None,
    no_faults: bool = False,
) -> ScenarioResult:
    """Play one fully seeded scenario; returns the oracle verdicts and
    the replayable trace hash.

    ``no_faults`` drops every fault composition (and the chaos
    budget), keeping only the churn stream — the configuration under
    which the convergence-SLO oracle is ARMED: a fault-free run that
    misses an objective is a real regression, while fault-injected
    runs carry their SLO report in ``stats`` without failing on it
    (blowing the tail under a brownout is what the error budget is
    for; the ``slo-brownout`` canary proves the oracle catches when
    it must)."""
    shape = PROFILES[profile]
    rng = random.Random(seed)
    config = SimHarnessConfig(
        replicas=2,
        resync_period=600.0,
        drift_tick_period=900.0,
        gc_sweep_period=450.0,
        gc_grace_sweeps=2,
        health=HealthConfig(
            window=30.0,
            min_calls=6,
            failure_ratio=0.5,
            open_duration=15.0,
            probe_budget=1,
            aimd_qps=50.0,
        ),
        lease=_fast_lease(),
    )
    watchdog = racecheck.enable()
    try:
        with SimHarness(config=config) as harness:
            for slot in range(shape.service_slots):
                harness.aws.add_load_balancer(
                    f"lb{slot}", "us-west-2", _nlb_hostname(slot)
                )
            harness.aws.add_hosted_zone("example.com")
            if canary is not None:
                _install_canary(harness, canary)
            if canary in ("slo-brownout", "explain-lie"):
                # explain checkpoints, fuzzed inside the
                # scripted outage: mid-brownout every unconverged
                # object must classify to a brownout-shaped verdict
                probe_times = sorted(
                    rng.uniform(
                        _BROWNOUT_WINDOW[0] + 90.0,
                        _BROWNOUT_WINDOW[1] - 30.0,
                    )
                    for _ in range(3)
                )
                arm_explain_probes(
                    harness, probe_times, context={"outage": _BROWNOUT_WINDOW}
                )
            gc_oracle = GCDeletionOracle(config.cluster_name).attach(harness)
            harness.run_for(15.0)  # leadership + initial sync
            gc_oracle.prime()
            if shape.chaos_budget and not no_faults:
                harness.fault_plan.chaos(
                    rng.randrange(1 << 30), shape.chaos_budget, p=0.08,
                    ambiguous=0.3,
                )

            circuit_oracles: list[CircuitBudgetOracle] = []
            harness.spawn(
                _churn_actor(harness, rng, shape), "churn"
            )
            if not no_faults:
                _schedule_faults(harness, rng, shape, circuit_oracles)

            harness.run_for(shape.active_seconds)
            # lift standing faults (outages + chaos); any scripted
            # one-shots still queued fire as transients during heal
            harness.fault_plan.restore()
            harness.fault_plan.refill(0)
            quiesced = harness.run_until_quiescent(
                shape.heal_seconds, settle_window=3 * 60.0
            )

            violations = list(harness.violations)
            if not quiesced:
                violations.append(
                    "quiescence: world still busy after "
                    f"{shape.heal_seconds}s virtual heal window"
                )
            violations += standard_oracles(harness, config.cluster_name)
            violations += gc_oracle.violations
            for oracle in circuit_oracles:
                violations += oracle.violations
            # the convergence-SLO oracle: armed for
            # fault-free runs and for the canary built to trip it;
            # fault-injected runs carry the report in stats only
            harness.slo_engine.tick()  # final window advance
            slo_violations = check_slo(harness)
            if no_faults or canary == "slo-brownout":
                violations += slo_violations
            if canary in ("slo-brownout", "explain-lie"):
                violations += check_explain(harness)
            try:
                watchdog.assert_clean()
            except AssertionError as err:
                violations.append(f"racecheck: {err}")
            stats = harness.stats()
            stats["slo"] = {
                "violations": slo_violations,
                "shedding": harness.slo_engine.shedding,
                "shed_activations": harness.slo_engine.shed_activations,
                "journeys": harness.journey.stats(),
            }
            return ScenarioResult(
                seed=seed,
                profile=profile,
                canary=canary,
                trace_hash=harness.trace_hash(),
                violations=violations,
                stats=stats,
                trace_tail=list(harness.scheduler.trace_tail)[-200:],
            )
    finally:
        racecheck.disable()


def run_resize_scenario(
    seed: int,
    profile: str = "mini",
    no_faults: bool = False,
) -> ScenarioResult:
    """The resize-under-faults canary: a sharded fleet
    (2 shards, 3 replicas) churns while a mid-run live resize to 4
    shards is composed with replica death (kill -9 semantics: the
    closest sharded analog of leader churn) and a seeded service
    brownout.  Oracles armed: the standard battery PLUS key-level
    exclusive ownership through the transition and the handoff-window
    oracle — and the scenario itself asserts the transition COMPLETED
    despite the faults (a wedged resize is a failure even when nothing
    else broke)."""
    shape = PROFILES[profile]
    rng = random.Random(seed)
    config = SimHarnessConfig(
        replicas=3,
        shard_count=2,
        shards_per_replica=4,
        resync_period=600.0,
        drift_tick_period=900.0,
        # the GC sweeper mops up deletes whose events died with a
        # killed replica or landed in a handoff gap — the same
        # level-triggered safety net the standard scenario runs
        gc_sweep_period=450.0,
        gc_grace_sweeps=2,
        health=HealthConfig(
            window=30.0,
            min_calls=6,
            failure_ratio=0.5,
            open_duration=15.0,
            probe_budget=1,
            aimd_qps=50.0,
        ),
        lease=_fast_lease(),
    )
    watchdog = racecheck.enable()
    try:
        with SimHarness(config=config) as harness:
            for slot in range(shape.service_slots):
                harness.aws.add_load_balancer(
                    f"lb{slot}", "us-west-2", _nlb_hostname(slot)
                )
            harness.aws.add_hosted_zone("example.com")
            harness.run_for(15.0)  # membership + initial sync
            harness.spawn(_churn_actor(harness, rng, shape), "churn")
            resize_at = rng.uniform(0.25, 0.45) * shape.active_seconds
            harness.after(
                resize_at, lambda: harness.request_resize(4), "resize-to-4"
            )
            # explain checkpoints fuzzed into and past the
            # transition window: each replica's answer must agree with
            # its own shard filter (owners never disclaim, non-owners
            # answer not-owner/unowned-resize) while keys are moving
            probe_times = sorted(
                resize_at + rng.uniform(2.0, 150.0) for _ in range(3)
            )
            arm_explain_probes(
                harness, probe_times, context={"sharded": True}
            )
            if not no_faults:
                # replica death composed INTO the transition window
                kill_at = resize_at + rng.uniform(
                    0.0, 3 * config.lease.retry_period
                )
                harness.after(
                    kill_at,
                    lambda: harness.kill_shard_replica(replace=True),
                    "kill-replica-mid-resize",
                )
                service = rng.choice(sorted(_SERVICE_OPS))
                window = rng.uniform(60.0, 180.0)
                _schedule_brownout(
                    harness,
                    resize_at + rng.uniform(0.0, 60.0),
                    service,
                    window,
                    [],
                )
            harness.run_for(shape.active_seconds)
            harness.fault_plan.restore()
            harness.fault_plan.refill(0)
            quiesced = harness.run_until_quiescent(
                shape.heal_seconds, settle_window=3 * 60.0
            )
            # orphans whose delete events died with a killed replica
            # (or in a handoff gap) clear only through GC grace — give
            # the sweeper its grace_sweeps+1 intervals, then re-settle
            harness.run_for(3 * 450.0)
            quiesced = quiesced and harness.run_until_quiescent(
                shape.heal_seconds, settle_window=3 * 60.0
            )
            violations = list(harness.violations)
            if not quiesced:
                violations.append(
                    "quiescence: world still busy after "
                    f"{shape.heal_seconds}s virtual heal window"
                )
            violations += standard_oracles(harness, config.cluster_name)
            violations += check_explain(harness)
            if not harness.resize_settled(4):
                violations.append(
                    f"resize: fleet never settled at 4 shards under faults: "
                    f"{harness.resize_states()}"
                )
            try:
                watchdog.assert_clean()
            except AssertionError as err:
                violations.append(f"racecheck: {err}")
            stats = harness.stats()
            stats["resize"] = {
                identity: status
                for identity, status in harness.resize_states().items()
            }
            stats["handoff_violations"] = check_resize_handoffs(harness)
            return ScenarioResult(
                seed=seed,
                profile=profile,
                canary="resize",
                trace_hash=harness.trace_hash(),
                violations=violations,
                stats=stats,
                trace_tail=list(harness.scheduler.trace_tail)[-200:],
            )
    finally:
        racecheck.disable()


# --- the SLO-driven autoscaler scenarios -----------------------
#
# Sim-scale burn windows: the production 5 m / 1 h windows would let a
# load wave poison scale-in headroom for an hour of virtual time after
# it ended; 2 m / 10 m keeps trip AND decay inside one mini run.
AUTOSCALE_WINDOWS = (120.0, 600.0)
# the load wave: a burst of GA-managed services big enough to saturate
# per-replica workqueue admission (the scarce resource queue_qps
# models), and a post-reaction "echo" burst that must converge fast on
# the scaled-out fleet
_WAVE_SIZE = 28
_ECHO_SIZE = 8
_WAVE_AT = 180.0


def _autoscale_objectives():
    from ..observability.slo import GA_CONTROLLERS, SLOObjective

    # one fast-tripping objective: GA chains within 60 s (a
    # JOURNEY_BUCKETS bound) at a target relaxed enough that the
    # cumulative good fraction can recover above it after the
    # autoscaler reacts — keeping check_slo meaningful post-scale
    return (
        SLOObjective("ga_converge_wave_p99", 60.0, GA_CONTROLLERS, target=0.7),
    )


def _autoscale_policy(
    observe_only: bool = False, brownout_hold: float = 600.0
) -> ScalePolicyConfig:
    # production-shaped rails scaled to the mini profile's 900 s active
    # window; cooldowns still outlast the membership plane's ~30 s
    # placement hysteresis by 3x/15x
    return ScalePolicyConfig(
        min_shards=2,
        max_shards=4,
        burn_threshold=1.0,
        age_growth_evals=3,
        age_floor_seconds=90.0,
        headroom_evals=4,
        headroom_burn=0.25,
        cooldown_out_seconds=90.0,
        cooldown_in_seconds=450.0,
        brownout_hold_seconds=brownout_hold,
        observe_only=observe_only,
    )


def _autoscale_config(
    observe_only: bool = False, brownout_hold: float = 600.0
) -> SimHarnessConfig:
    return SimHarnessConfig(
        replicas=4,
        shard_count=2,
        shards_per_replica=2,
        resync_period=1800.0,
        gc_sweep_period=450.0,
        gc_grace_sweeps=2,
        # per-replica workqueue admission is the scarce resource the
        # wave saturates: more shards spread across more replicas =
        # more aggregate admission capacity, which is exactly the
        # lever the autoscaler pulls.  0.1 qps/burst 2 means a
        # 14-key-per-owner wave queues for ~2 minutes at 2 shards but
        # ~1 minute at 4 — the difference the objective sees
        queue_qps=0.1,
        queue_burst=2,
        health=HealthConfig(
            window=30.0,
            min_calls=6,
            failure_ratio=0.5,
            open_duration=15.0,
            probe_budget=1,
            aimd_qps=50.0,
        ),
        lease=_fast_lease(),
        slo_objectives=_autoscale_objectives(),
        slo_windows=AUTOSCALE_WINDOWS,
        autoscale=True,
        autoscale_interval=30.0,
        autoscale_policy=_autoscale_policy(
            observe_only=observe_only, brownout_hold=brownout_hold
        ),
    )


def _autoscale_stats(harness: SimHarness) -> dict:
    decisions = harness.autoscaler.history()
    return {
        "status": harness.autoscaler.status(),
        "decisions": len(decisions),
        "executed": [
            (d["time"], d["action"], d["target_shards"])
            for d in decisions
            if d["executed"]
        ],
        "suppressed_recommendations": sum(
            1 for d in decisions if RAIL_OBSERVE_ONLY in d["rails"]
        ),
        "resize": dict(harness.resize_states()),
    }


def run_autoscale_scenario(
    seed: int,
    profile: str = "mini",
    no_faults: bool = False,
    observe_only: bool = False,
) -> ScenarioResult:
    """The closed-loop canary: a sharded fleet (2 shards, 4
    replicas) under background churn takes a load wave that saturates
    per-replica queue admission and blows the convergence objective.
    The autoscaler — not the scenario script — must notice the burn /
    age growth and execute the 2→4 resize within its evaluation
    budget; a replica kill is composed into the wave window (the CI
    canary: load wave × replica kill).  After the wave the fleet must
    scale back in on sustained headroom, with zero oscillation and
    every decision flight-recorded.  ``observe_only`` flips the policy
    to recommendation-only and instead asserts the wave produced a
    suppressed recommendation and NO resize was ever requested."""
    shape = PROFILES[profile]
    rng = random.Random(seed)
    config = _autoscale_config(observe_only=observe_only)
    watchdog = racecheck.enable()
    try:
        with SimHarness(config=config) as harness:
            for slot in range(shape.service_slots):
                harness.aws.add_load_balancer(
                    f"lb{slot}", "us-west-2", _nlb_hostname(slot)
                )
            wave_slots = list(range(100, 100 + _WAVE_SIZE))
            echo_slots = list(range(200, 200 + _ECHO_SIZE))
            for slot in wave_slots + echo_slots:
                harness.aws.add_load_balancer(
                    f"lb{slot}", "us-west-2", _nlb_hostname(slot)
                )
            harness.aws.add_hosted_zone("example.com")
            harness.run_for(15.0)  # membership + initial sync
            harness.spawn(_churn_actor(harness, rng, shape), "churn")

            def wave_actor():
                # a tight burst: arrival rate far above the per-owner
                # admission rate, so the backlog actually queues
                for slot in wave_slots:
                    harness.cluster.create(
                        "Service", _make_service(f"wavesvc{slot}", slot, False)
                    )
                    yield rng.uniform(0.5, 1.5)

            def echo_actor():
                for slot in echo_slots:
                    harness.cluster.create(
                        "Service", _make_service(f"echosvc{slot}", slot, False)
                    )
                    yield rng.uniform(2.0, 6.0)

            harness.after(
                _WAVE_AT,
                lambda: harness.spawn(wave_actor(), "load-wave"),
                "load-wave-start",
            )
            # the echo burst lands after the reaction budget: it must
            # converge fast on the scaled-out fleet, which is what
            # pulls the cumulative good fraction back over target
            harness.after(
                _WAVE_AT + 480.0,
                lambda: harness.spawn(echo_actor(), "echo-wave"),
                "echo-wave-start",
            )
            # observe-only runs the SAME wave + fault as the acting run:
            # the whole point is proving the identical evidence produces
            # a suppressed recommendation instead of a resize
            if not no_faults:
                harness.after(
                    _WAVE_AT + 60.0,
                    lambda: harness.kill_shard_replica(replace=True),
                    "kill-replica-in-wave",
                )
            harness.run_for(shape.active_seconds)
            harness.fault_plan.restore()
            harness.fault_plan.refill(0)
            quiesced = harness.run_until_quiescent(
                shape.heal_seconds, settle_window=3 * 60.0
            )
            # the quiet the scale-in evidence needs: wave burn must
            # age out of the long window, then the headroom streak and
            # scale-in cooldown must elapse, then the 4→2 transition
            # itself must drain/hand off
            harness.run_for(900.0)
            quiesced = quiesced and harness.run_until_quiescent(
                shape.heal_seconds, settle_window=3 * 60.0
            )
            harness.run_for(3 * 450.0)  # GC grace for killed-replica orphans
            quiesced = quiesced and harness.run_until_quiescent(
                shape.heal_seconds, settle_window=3 * 60.0
            )

            violations = list(harness.violations)
            if not quiesced:
                violations.append(
                    "quiescence: world still busy after "
                    f"{shape.heal_seconds}s virtual heal window"
                )
            violations += standard_oracles(harness, config.cluster_name)
            decisions = harness.autoscaler.history()
            executed = [d for d in decisions if d["executed"]]
            outs = [d for d in executed if d["action"] == ACTION_OUT]
            ins = [d for d in executed if d["action"] == ACTION_IN]
            status = harness.autoscaler.status()
            recorded = harness.autoscaler_recorder.recorded_total
            if recorded != status["evaluations"]:
                violations.append(
                    f"autoscale: {status['evaluations']} evaluations but "
                    f"{recorded} flight-recorded decisions"
                )
            if observe_only:
                recommended = [
                    d for d in decisions if RAIL_OBSERVE_ONLY in d["rails"]
                ]
                if not recommended:
                    violations.append(
                        "autoscale: observe-only run never produced a "
                        "suppressed recommendation (proof is vacuous)"
                    )
                if executed or harness._resize_requests:
                    violations.append(
                        "autoscale: observe-only run requested a resize: "
                        f"{harness._resize_requests}"
                    )
                if not harness.resize_settled(2):
                    violations.append(
                        "autoscale: observe-only fleet left 2 shards: "
                        f"{harness.resize_states()}"
                    )
            else:
                if not outs:
                    violations.append(
                        "autoscale: load wave never produced an executed "
                        "scale-out"
                    )
                else:
                    reaction = outs[0]["time"] - _WAVE_AT
                    if reaction > 450.0:
                        violations.append(
                            "autoscale: scale-out reacted too slowly "
                            f"({reaction:.0f}s after the wave started)"
                        )
                    if outs[0]["target_shards"] != 4:
                        violations.append(
                            "autoscale: first scale-out targeted "
                            f"{outs[0]['target_shards']} shards, expected 4"
                        )
                if outs and not ins:
                    violations.append(
                        "autoscale: fleet never scaled back in after the wave"
                    )
                if not harness.resize_settled(2):
                    violations.append(
                        "autoscale: fleet did not return to 2 shards: "
                        f"{harness.resize_states()}"
                    )
                # post-reaction SLO verdict: cumulative good fraction
                # must have recovered over target — the whole point of
                # the reaction
                harness.slo_engine.tick()
                violations += check_slo(harness)
            try:
                watchdog.assert_clean()
            except AssertionError as err:
                violations.append(f"racecheck: {err}")
            stats = harness.stats()
            stats["autoscale"] = _autoscale_stats(harness)
            stats["slo"] = {
                "violations": check_slo(harness),
                "journeys": harness.journey.stats(),
            }
            return ScenarioResult(
                seed=seed,
                profile=profile,
                canary="autoscale-observe" if observe_only else "autoscale",
                trace_hash=harness.trace_hash(),
                violations=violations,
                stats=stats,
                trace_tail=list(harness.scheduler.trace_tail)[-200:],
            )
    finally:
        racecheck.disable()


def run_autoscale_brownout_scenario(
    seed: int, profile: str = "mini"
) -> ScenarioResult:
    """The brownout discrimination proof: a sustained GA
    outage wedges every journey opened during it; they converge — and
    burn the error budget — only AFTER the restore, when the circuit
    is already closed again.  The autoscaler must attribute that burn
    to the provider (open-circuit exclusion + the brownout hold) and
    execute ZERO scale-outs, and the proof must be non-vacuous: the
    decision history has to actually show both-window burn AND
    excluded objectives."""
    shape = PROFILES[profile]
    rng = random.Random(seed)
    config = _autoscale_config(brownout_hold=900.0)
    watchdog = racecheck.enable()
    try:
        with SimHarness(config=config) as harness:
            for slot in range(shape.service_slots):
                harness.aws.add_load_balancer(
                    f"lb{slot}", "us-west-2", _nlb_hostname(slot)
                )
            wedge_slots = list(range(100, 108))
            for slot in wedge_slots:
                harness.aws.add_load_balancer(
                    f"lb{slot}", "us-west-2", _nlb_hostname(slot)
                )
            harness.aws.add_hosted_zone("example.com")
            harness.run_for(15.0)
            harness.spawn(_churn_actor(harness, rng, shape), "churn")
            ops = sorted(GA_OPS)
            harness.after(
                120.0, lambda: harness.fault_plan.outage(*ops), "brownout"
            )

            def wedge_actor():
                # a burst INTO the outage: failing creates trip the
                # owner replicas' breakers and wedge enough journeys
                # that the post-restore burn is unmistakable
                for slot in wedge_slots:
                    harness.cluster.create(
                        "Service", _make_service(f"wavesvc{slot}", slot, False)
                    )
                    yield rng.uniform(1.0, 4.0)

            harness.after(
                130.0,
                lambda: harness.spawn(wedge_actor(), "wedge-wave"),
                "wedge-wave-start",
            )
            harness.after(
                420.0,
                lambda: harness.fault_plan.restore(*ops),
                "brownout-end",
            )
            harness.run_for(shape.active_seconds)
            harness.fault_plan.restore()
            harness.fault_plan.refill(0)
            quiesced = harness.run_until_quiescent(
                shape.heal_seconds, settle_window=3 * 60.0
            )
            violations = list(harness.violations)
            if not quiesced:
                violations.append(
                    "quiescence: world still busy after "
                    f"{shape.heal_seconds}s virtual heal window"
                )
            violations += standard_oracles(harness, config.cluster_name)
            decisions = harness.autoscaler.history()
            executed_out = [
                d
                for d in decisions
                if d["executed"] and d["action"] == ACTION_OUT
            ]
            if executed_out:
                violations.append(
                    "autoscale: scaled out on provider-outage burn at "
                    f"t={executed_out[0]['time']}"
                )
            if not any(
                d["evidence"].get("excluded_objectives") for d in decisions
            ):
                violations.append(
                    "autoscale: brownout never excluded an objective — "
                    "the no-scale-out assertion is vacuous"
                )

            def burning(decision):
                for per in decision["evidence"]["burn"].values():
                    if per and all(rate >= 1.0 for rate in per.values()):
                        return True
                return False

            if not any(burning(d) for d in decisions):
                violations.append(
                    "autoscale: outage never produced both-window burn — "
                    "the no-scale-out assertion is vacuous"
                )
            if not harness.resize_settled(2):
                violations.append(
                    "autoscale: brownout fleet left 2 shards: "
                    f"{harness.resize_states()}"
                )
            status = harness.autoscaler.status()
            recorded = harness.autoscaler_recorder.recorded_total
            if recorded != status["evaluations"]:
                violations.append(
                    f"autoscale: {status['evaluations']} evaluations but "
                    f"{recorded} flight-recorded decisions"
                )
            try:
                watchdog.assert_clean()
            except AssertionError as err:
                violations.append(f"racecheck: {err}")
            stats = harness.stats()
            stats["autoscale"] = _autoscale_stats(harness)
            return ScenarioResult(
                seed=seed,
                profile=profile,
                canary="autoscale-brownout",
                trace_hash=harness.trace_hash(),
                violations=violations,
                stats=stats,
                trace_tail=list(harness.scheduler.trace_tail)[-200:],
            )
    finally:
        racecheck.disable()


def _fast_lease():
    from ..leaderelection import LeaderElectionConfig

    # production shape scaled to scenario length (lease churn must be
    # observable inside the active window)
    return LeaderElectionConfig(
        lease_duration=60.0, renew_deadline=15.0, retry_period=5.0
    )


def _churn_actor(harness: SimHarness, rng: random.Random, shape: FuzzProfile):
    """Generator actor: one cluster mutation per step, spaced by
    seeded virtual delays.  Mixes creates, deletes, managed-annotation
    toggles, hostname flips, no-op touches, and racing double-edits."""
    live: dict[str, bool] = {}  # name -> hostname_annotated

    def step():
        slot = rng.randrange(shape.service_slots)
        name = f"svc{slot}"
        if name not in live:
            hostname = rng.random() < shape.hostname_fraction
            harness.cluster.create(
                "Service", _make_service(name, slot, hostname)
            )
            live[name] = hostname
            return
        roll = rng.random()
        if roll < 0.30:
            harness.cluster.delete("Service", "default", name)
            del live[name]
        elif roll < 0.50:  # toggle managed off/on
            obj = harness.cluster.get("Service", "default", name)
            if apis.AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION in obj.metadata.annotations:
                obj.metadata.annotations.pop(
                    apis.AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION
                )
                obj.metadata.annotations.pop(apis.ROUTE53_HOSTNAME_ANNOTATION, None)
                live[name] = False
            else:
                obj.metadata.annotations[
                    apis.AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION
                ] = "true"
            harness.cluster.update("Service", obj)
        elif roll < 0.70:  # flip the route53 hostname annotation
            obj = harness.cluster.get("Service", "default", name)
            if apis.ROUTE53_HOSTNAME_ANNOTATION in obj.metadata.annotations:
                obj.metadata.annotations.pop(apis.ROUTE53_HOSTNAME_ANNOTATION)
                live[name] = False
            elif (
                apis.AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION
                in obj.metadata.annotations
            ):
                obj.metadata.annotations[
                    apis.ROUTE53_HOSTNAME_ANNOTATION
                ] = f"app{slot}.example.com"
                live[name] = True
            harness.cluster.update("Service", obj)
        elif roll < 0.85:  # racing spec edits: two writes, same instant
            obj = harness.cluster.get("Service", "default", name)
            obj.metadata.labels["touched"] = str(rng.randrange(1 << 30))
            harness.cluster.update("Service", obj)
            obj = harness.cluster.get("Service", "default", name)
            obj.metadata.labels["touched"] = str(rng.randrange(1 << 30))
            harness.cluster.update("Service", obj)
        else:  # plain touch
            obj = harness.cluster.get("Service", "default", name)
            obj.metadata.labels["touched"] = str(rng.randrange(1 << 30))
            harness.cluster.update("Service", obj)

    spacing = shape.active_seconds * 0.75 / max(shape.churn_ops, 1)
    for _ in range(shape.churn_ops):
        step()
        yield rng.uniform(0.2 * spacing, 1.8 * spacing)


def _schedule_faults(
    harness: SimHarness,
    rng: random.Random,
    shape: FuzzProfile,
    circuit_oracles: list,
) -> None:
    """Compose fault primitives across the active window."""
    leader_churns = 0
    for index in range(shape.fault_compositions):
        at = rng.uniform(0.1, 0.8) * shape.active_seconds
        kind = rng.choice(["throttle", "brownout", "crash", "leader", "hang"])
        if kind == "throttle":
            op = rng.choice(_FAULTABLE_OPS)
            times = rng.randint(1, 5)
            harness.after(
                at,
                lambda op=op, times=times: harness.fault_plan.throttle(
                    op, times=times
                ),
                f"fault:throttle:{index}",
            )
        elif kind == "hang":
            op = rng.choice(_FAULTABLE_OPS)
            harness.after(
                at,
                lambda op=op: harness.fault_plan.hang_until_deadline(op),
                f"fault:hang:{index}",
            )
        elif kind == "brownout":
            service = rng.choice(sorted(_SERVICE_OPS))
            window = rng.uniform(60.0, 240.0)
            _schedule_brownout(
                harness, at, service, window, circuit_oracles
            )
        elif kind == "crash":
            op = rng.choice(_CRASHABLE_OPS)
            when = rng.choice(["before", "after-commit"])
            harness.after(
                at,
                lambda op=op, when=when: harness.fault_plan.crash(op, when=when),
                f"fault:crash:{index}",
            )
        elif kind == "leader" and leader_churns < shape.max_leader_churn:
            leader_churns += 1
            graceful = rng.random() < 0.5

            def churn(graceful=graceful):
                if harness.leader() is None:
                    return
                if graceful:
                    harness.demote_leader()
                else:
                    harness.kill_leader()

            harness.after(at, churn, f"fault:leader:{index}")


def _schedule_brownout(
    harness: SimHarness,
    at: float,
    service: str,
    window: float,
    circuit_oracles: list,
) -> None:
    ops = _SERVICE_OPS[service]
    oracle = CircuitBudgetOracle(harness, ops, service)
    circuit_oracles.append(oracle)
    health_config = harness.config.health

    def start():
        harness.fault_plan.outage(*sorted(ops))
        harness.scheduler.record("fault", f"brownout:{service}")
        # sample for the breaker trip a few times inside the window
        for i in range(1, 6):
            harness.after(
                i * window / 6.0, sample, f"brownout-probe:{service}"
            )

    def sample():
        if (
            harness.health is not None
            and harness.health.is_open(service)
            and oracle._open_observed_at_call_index is None
        ):
            oracle.circuit_opened()

    def end():
        harness.fault_plan.restore(*sorted(ops))
        harness.scheduler.record("fault", f"brownout-end:{service}")
        if health_config is not None:
            oracle.window_ended(
                health_config.open_duration, window, health_config.probe_budget
            )

    harness.after(at, start, f"fault:brownout:{service}")
    harness.after(at + window, end, f"fault:brownout-end:{service}")


# ---------------------------------------------------------------------------
# corpus runner (the CI `sim` job)
# ---------------------------------------------------------------------------


def replay_corpus(directory) -> int:
    """Replay every checked-in incident capture under ``directory``
    (the CI ``replay-corpus`` gate): each must re-run
    byte-identically and pass the oracle battery.  A capture that
    stops replaying identically means a behavior change reached the
    recorded external-input contract — either fix the regression or
    deliberately re-record the capture."""
    from .replay import replay_capture

    paths = sorted(directory.glob("*.jsonl"))
    if not paths:
        print(f"no captures under {directory}")
        return 0
    failures = 0
    for path in paths:
        try:
            result = replay_capture(path)
        except Exception as err:
            print(f"{path.name} FAIL replay crashed: {err!r}")
            failures += 1
            continue
        ok = result.identical and not result.violations
        print(
            f"{path.name} {'ok' if ok else 'FAIL'} "
            f"events={result.recorded_events} "
            f"hash={result.recorded_hash[:16]}"
        )
        if not ok:
            failures += 1
            if result.divergence is not None:
                print(result.divergence.describe())
            for violation in result.violations:
                print(f"  - {violation}")
            for note in result.notes:
                print(f"  note: {note}")
    return 1 if failures else 0


def main(argv: Optional[list[str]] = None) -> int:
    import argparse
    import pathlib

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seeds", default="1,2,3,4,5")
    parser.add_argument("--profile", default="quick", choices=sorted(PROFILES))
    parser.add_argument("--canary", default=None, choices=CANARIES)
    parser.add_argument(
        "--scenario", default="standard",
        choices=("standard", "resize", "autoscale", "autoscale-brownout"),
        help="'resize' plays the sharded resize-under-faults scenario "
        "(live 2→4 resize composed with replica death + brownout, "
        "key-level ownership and handoff oracles armed) instead of the "
        "single-leader churn scenario; 'autoscale' plays the "
        "closed-loop canary (load wave × replica kill — the autoscaler "
        "itself must execute the 2→4→2 resizes, no-oscillation + "
        "ownership oracles armed); 'autoscale-brownout' proves burn "
        "caused by a provider outage never scales the fleet out",
    )
    parser.add_argument(
        "--no-faults", action="store_true",
        help="churn only, no fault compositions — ARMS the "
        "convergence-SLO oracle (a fault-free run missing an "
        "objective is a regression)",
    )
    parser.add_argument("--artifacts", default=None)
    parser.add_argument(
        "--captures", default=None, metavar="DIR",
        help="replay-corpus mode: replay every incident capture "
        "(*.jsonl) under DIR through the ReplayHarness and require a "
        "byte-identical event-trace hash plus a clean oracle battery; "
        "exits non-zero on any divergence — the regression gate for "
        "checked-in captures (seeds are ignored in this mode)",
    )
    args = parser.parse_args(argv)

    if args.captures:
        return replay_corpus(pathlib.Path(args.captures))

    failures = 0
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        if args.scenario == "resize":
            result = run_resize_scenario(
                seed, profile=args.profile, no_faults=args.no_faults
            )
        elif args.scenario == "autoscale":
            result = run_autoscale_scenario(
                seed, profile=args.profile, no_faults=args.no_faults
            )
        elif args.scenario == "autoscale-brownout":
            result = run_autoscale_brownout_scenario(
                seed, profile=args.profile
            )
        else:
            result = run_scenario(
                seed, profile=args.profile, canary=args.canary,
                no_faults=args.no_faults,
            )
        status = "ok" if result.ok else "FAIL"
        print(
            f"seed {seed} [{args.profile}] {status} "
            f"trace={result.trace_hash[:16]} "
            f"virtual={result.stats['virtual_time']}s "
            f"calls={result.stats['aws_calls']}"
        )
        if not result.ok:
            failures += 1
            for violation in result.violations:
                print(f"  - {violation}")
            if args.artifacts:
                directory = pathlib.Path(args.artifacts)
                directory.mkdir(parents=True, exist_ok=True)
                artifact = directory / f"seed-{seed}.json"
                artifact.write_text(
                    json.dumps(
                        {
                            "seed": seed,
                            "profile": args.profile,
                            "canary": result.canary,
                            "trace_hash": result.trace_hash,
                            "violations": result.violations,
                            "stats": result.stats,
                            "trace_tail": result.trace_tail,
                            "replay": (
                                "python -m agac_tpu_torch.sim.fuzz "
                                f"--seeds {seed} --profile {args.profile}"
                            ),
                        },
                        indent=2,
                    )
                )
                klog.infof("wrote %s", artifact)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
