"""Invariant oracles for simulated scenarios.

Each oracle returns a list of violation strings (empty = clean), so a
scenario can accumulate every broken invariant instead of dying on
the first.  The final-state oracles assume the scenario has reached
quiescence (faults cleared, queues drained); the continuous oracles
(`gc_deletion_oracle`) hook into the harness mid-run, at the moment a
deletion decision lands.

The invariant list (the simulation's acceptance contract):

- **no orphan deletion of live owners** — whenever the GC sweeper
  deletes an accelerator or record owner, the Kubernetes owner object
  did not exist at that instant (checked against the cluster, the
  authority, synchronously inside the sweep event);
- **ownership-TXT/record atomicity** — at quiescence, every managed
  A-alias record has its owner TXT twin and vice versa: a half pair
  means a crash/batch path split the atomic submission;
- **pending-settle table drains** — nothing stays parked at
  quiescence, and nothing expired without resolution during a healthy
  (fault-free) run;
- **circuit-open call budget** — while a service's circuit is open,
  wire traffic to it is bounded by the half-open probe budget (no
  retry storms into a brownout);
- **eventual convergence to spec** — AWS state is exactly the image
  of the final cluster state: one complete chain per managed object
  with correct ownership, records matching surviving annotations,
  nothing for deleted/unmanaged objects.
"""

from __future__ import annotations

from .. import apis
from ..cloudprovider.aws.driver import parse_route53_owner_value
from ..controllers.globalaccelerator import is_managed_ingress, is_managed_service
from ..observability import explain as explain_plane

OWNER_TAG = "aws-global-accelerator-owner"
RR_TYPE_A = "A"
RR_TYPE_TXT = "TXT"


# ---------------------------------------------------------------------------
# expected state, derived from the cluster (the spec)
# ---------------------------------------------------------------------------


def expected_owners(cluster) -> set[str]:
    """Owner-tag values that SHOULD have an accelerator chain."""
    owners: set[str] = set()
    services, _ = cluster.list("Service")
    for svc in services:
        if is_managed_service(svc) and svc.status.load_balancer.ingress:
            owners.add(
                f"service/{svc.metadata.namespace}/{svc.metadata.name}"
            )
    ingresses, _ = cluster.list("Ingress")
    for ing in ingresses:
        if is_managed_ingress(ing) and ing.status.load_balancer.ingress:
            owners.add(
                f"ingress/{ing.metadata.namespace}/{ing.metadata.name}"
            )
    return owners


def expected_records(cluster) -> set[tuple[str, str]]:
    """(record name, type) pairs that SHOULD exist across zones."""
    records: set[tuple[str, str]] = set()
    for kind in ("Service", "Ingress"):
        objs, _ = cluster.list(kind)
        for obj in objs:
            hostnames = obj.metadata.annotations.get(
                apis.ROUTE53_HOSTNAME_ANNOTATION, ""
            )
            if not hostnames or not obj.status.load_balancer.ingress:
                continue
            if kind == "Service" and not is_managed_service(obj):
                # route53 records require the accelerator to exist;
                # an unmanaged service keeps no records
                continue
            for hostname in filter(None, hostnames.split(",")):
                records.add((hostname + ".", RR_TYPE_A))
                records.add((hostname + ".", RR_TYPE_TXT))
    return records


# ---------------------------------------------------------------------------
# final-state oracles
# ---------------------------------------------------------------------------


def check_convergence(harness) -> list[str]:
    """AWS state == image of the cluster spec (complete chains, exact
    owner set, exact record set)."""
    violations = []
    want_owners = expected_owners(harness.cluster)
    have_owners = {
        owner
        for owner in harness.aws.accelerator_owners().values()
        if owner is not None
    }
    missing = want_owners - have_owners
    extra = have_owners - want_owners
    if missing:
        violations.append(f"convergence: accelerators missing for {sorted(missing)}")
    if extra:
        violations.append(f"convergence: orphan accelerators for {sorted(extra)}")
    accelerators, listeners, endpoint_groups = harness.aws.chain_counts()
    if not (accelerators == listeners == endpoint_groups == len(want_owners)):
        violations.append(
            "convergence: incomplete chains "
            f"(accelerators={accelerators}, listeners={listeners}, "
            f"endpoint_groups={endpoint_groups}, want={len(want_owners)})"
        )
    want_records = expected_records(harness.cluster)
    have_records = {
        (record.name, record.type)
        for zone_id in harness.aws.all_hosted_zone_ids()
        for record in harness.aws.records_in_zone(zone_id)
        if record.type in (RR_TYPE_A, RR_TYPE_TXT)
    }
    if want_records != have_records:
        violations.append(
            f"convergence: records mismatch (missing "
            f"{sorted(want_records - have_records)}, extra "
            f"{sorted(have_records - want_records)})"
        )
    return violations


def check_record_atomicity(harness, cluster_name: str = "default") -> list[str]:
    """Every owner TXT has its A twin and vice versa — the atomic
    TXT+A submission was never split by any fault path."""
    violations = []
    for zone_id in harness.aws.all_hosted_zone_ids():
        records = harness.aws.records_in_zone(zone_id)
        a_names = {r.name for r in records if r.type == RR_TYPE_A}
        txt_names = set()
        for record in records:
            if record.type != RR_TYPE_TXT:
                continue
            values = [rr.value for rr in (record.resource_records or [])]
            if any(
                parse_route53_owner_value(v, cluster_name) is not None
                for v in values
            ):
                txt_names.add(record.name)
        for name in sorted(a_names - txt_names):
            violations.append(
                f"atomicity: A record {name!r} in {zone_id} has no owner TXT"
            )
        for name in sorted(txt_names - a_names):
            violations.append(
                f"atomicity: owner TXT {name!r} in {zone_id} has no A record"
            )
    return violations


def check_settle_drained(harness) -> list[str]:
    """Nothing parked at quiescence, across every live process-world
    (one settle table per sharded replica)."""
    violations = []
    for table in harness.settle_tables():
        depth = table.depth()
        if depth:
            violations.append(
                "pending-settle: "
                f"{depth} entries still parked at quiescence "
                f"({table.depth_by_group()})"
            )
    return violations


def check_no_residue(harness) -> list[str]:
    """Every workqueue of every live stack fully drained (ready AND
    delayed)."""
    violations = []
    for stack in harness.live_stacks():
        for entry in stack.workers:
            if len(entry.queue):
                violations.append(
                    f"residue: {stack.identity}/{entry.name} has ready items"
                )
            if entry.queue.next_delay_deadline() is not None:
                violations.append(
                    f"residue: {stack.identity}/{entry.name} has delayed items parked"
                )
    return violations


def check_exclusive_shard_ownership(harness) -> list[str]:
    """The no-key-owned-by-two-shards oracle, final-state
    form: live replicas' owned-shard sets are pairwise disjoint AND
    every violation the continuous per-tick check accumulated is
    surfaced.  (Key exclusivity follows: the ring is deterministic and
    shared, so disjoint shard sets ⇒ disjoint key sets.)"""
    violations = [
        v for v in harness.violations if v.startswith("exclusive-ownership")
    ]
    ownership = sorted(harness.shard_ownership().items())
    for i, (id_a, owned_a) in enumerate(ownership):
        for id_b, owned_b in ownership[i + 1:]:
            overlap = owned_a & owned_b
            if overlap:
                entry = (
                    f"exclusive-ownership: shards {sorted(overlap)} owned by "
                    f"BOTH {id_a} and {id_b} at quiescence"
                )
                if entry not in violations:
                    violations.append(entry)
    return violations


def check_resize_handoffs(harness) -> list[str]:
    """The live-resize handoff oracle: every moving key's
    unowned window stayed within the handoff budget while both sides
    of its handoff were alive, no transition is still in flight at
    quiescence, and every live replica settled on the same ring."""
    violations = list(getattr(harness, "handoff_violations", ()))
    states = harness.resize_states()
    for identity, status in sorted(states.items()):
        if status["state"] != "stable" or status["handoff_pending"]:
            violations.append(
                f"resize: {identity} still {status['state']} "
                f"({status['handoff_pending']} handoffs pending) at quiescence"
            )
    rings = {status["ring"] for status in states.values()}
    if len(rings) > 1:
        violations.append(
            f"resize: live replicas disagree on the ring at quiescence: "
            f"{sorted(rings)}"
        )
    return violations


def check_slo(harness) -> list[str]:
    """The convergence-SLO oracle: every declared objective's
    CUMULATIVE good fraction over the whole scenario meets its target.
    NOT part of ``standard_oracles`` — fault-injected scenarios
    legitimately blow convergence tails (that is what the budget is
    for), so callers arm this only for fault-free runs, for soaks
    whose faults the objectives are expected to absorb, and for the
    ``slo-brownout`` canary that proves the oracle can catch."""
    engine = getattr(harness, "slo_engine", None)
    if engine is None:
        return ["slo: harness has no SLO engine (slo_eval_interval 0?)"]
    return engine.violations()


def arm_explain_probes(harness, times, context=None) -> None:
    """Schedule the explain oracle's checkpoints: at each
    virtual time in ``times`` (fuzzed by the scenario), every managed
    object's fleet-merged ``/debug/explain`` verdict is checked against
    ground truth the probe derives independently — AWS state for
    convergence, the settle tables for parks, the shard filters for
    ownership.  Violations accumulate on the harness; ``check_explain``
    surfaces them at the end.

    ``context`` keys: ``outage`` — a ``(start, end)`` virtual-time
    window during which unconverged objects must classify to a
    brownout-shaped verdict; ``sharded`` — arm the per-replica
    ownership-consistency check."""
    context = dict(context or {})
    if not hasattr(harness, "explain_violations"):
        harness.explain_violations = []
        harness.explain_probes = 0

    def probe():
        harness.explain_probes += 1
        harness.explain_violations.extend(
            _explain_ground_truth_violations(harness, context)
        )

    for t in times:
        harness.after(max(0.0, float(t)), probe, name="explain-probe")


def check_explain(harness) -> list[str]:
    """The explain-plane oracle's final gate: every probe's violations,
    plus a guard that the armed probes actually fired (a scenario that
    quiesces before its checkpoints proves nothing)."""
    violations = list(getattr(harness, "explain_violations", []))
    if not getattr(harness, "explain_probes", 0):
        violations.append(
            "explain: probes were armed but none fired before the "
            "scenario ended"
        )
    return violations


# the brownout-shaped verdicts: what an unconverged object may look
# like while the backend is dark (everything except ownership /
# informer / terminal answers)
_BROWNOUT_VERDICTS = frozenset({
    explain_plane.VERDICT_CIRCUIT_OPEN,
    explain_plane.VERDICT_PARKED_SETTLE,
    explain_plane.VERDICT_QUOTA_PACED,
    explain_plane.VERDICT_BACKOFF,
    explain_plane.VERDICT_IN_FLIGHT,
    explain_plane.VERDICT_SHED,
})
# a parked key may simultaneously be circuit-blocked under another
# controller; most-blocking ranks those above parked-settle
_PARKED_OK_VERDICTS = frozenset({
    explain_plane.VERDICT_PARKED_SETTLE,
    explain_plane.VERDICT_CIRCUIT_OPEN,
    explain_plane.VERDICT_QUOTA_PACED,
})
_OWNERSHIP_VERDICTS = frozenset({
    explain_plane.VERDICT_NOT_OWNER,
    explain_plane.VERDICT_UNOWNED_RESIZE,
})


def _explain_ground_truth_violations(harness, context) -> list[str]:
    """One checkpoint's worth of explain-vs-ground-truth comparison."""
    violations: list[str] = []
    stacks = [
        stack
        for stack in harness.live_stacks()
        if getattr(stack.manager, "explain_engine", None) is not None
    ]
    if not stacks:
        return violations
    now = harness.scheduler.monotonic()
    stamp = f"t={now:.0f}"
    blocked = frozenset(explain_plane.BLOCKED_VERDICTS)

    def fleet_explain(key: str) -> tuple[dict, dict]:
        answers = {}
        for stack in stacks:
            try:
                answers[stack.identity] = stack.manager.explain_engine.explain(key)
            except Exception as err:  # an explain crash is itself a finding
                answers[stack.identity] = {"error": str(err)}
        return explain_plane.merge_fleet_explains(answers), answers

    # ground truth #1: AWS state — a managed object whose accelerator
    # chain is absent is unconverged, whatever the classifier claims
    want = expected_owners(harness.cluster)
    have = {
        owner
        for owner in harness.aws.accelerator_owners().values()
        if owner is not None
    }
    outage = context.get("outage")
    in_outage = bool(outage) and outage[0] <= now <= outage[1]
    brownout_evidence: list[str] = []
    for owner in sorted(want):
        _, namespace, name = owner.split("/", 2)
        key = f"{namespace}/{name}"
        merged, answers = fleet_explain(key)
        verdict = merged["verdict"]
        if verdict not in explain_plane.VERDICTS:
            violations.append(
                f"explain: {stamp} {key}: verdict {verdict!r} is outside "
                "the closed catalog"
            )
            continue
        unconverged = owner not in have
        if unconverged and verdict not in blocked:
            violations.append(
                f"explain: {stamp} {key} has no accelerator chain yet the "
                f"fleet-merged verdict is {verdict!r} — the classifier is "
                "vouching for convergence that has not happened"
            )
        if unconverged and in_outage and verdict not in _BROWNOUT_VERDICTS:
            violations.append(
                f"explain: {stamp} {key} is unconverged mid-brownout but "
                f"classifies {verdict!r}, not a brownout-shaped verdict "
                f"{sorted(_BROWNOUT_VERDICTS)}"
            )
        if unconverged and in_outage:
            brownout_evidence.append(verdict)
        # ground truth #3: per-replica ownership — a replica whose
        # shard filter disclaims the key must answer not-owner /
        # unowned-resize, and an owner must never disclaim it
        if context.get("sharded"):
            for stack in stacks:
                answer = answers.get(stack.identity)
                if not isinstance(answer, dict) or "error" in answer:
                    violations.append(
                        f"explain: {stamp} {key}: replica {stack.identity} "
                        f"failed to answer: {answer.get('error') if isinstance(answer, dict) else answer}"
                    )
                    continue
                shard_filter = stack.manager.shard_filter
                if shard_filter is None:
                    continue
                owned = shard_filter.owns_key(key)
                replica_verdict = answer.get("verdict")
                if owned and replica_verdict in _OWNERSHIP_VERDICTS:
                    violations.append(
                        f"explain: {stamp} {key}: {stack.identity} owns the "
                        f"key but answered {replica_verdict!r}"
                    )
                elif not owned and replica_verdict not in _OWNERSHIP_VERDICTS:
                    violations.append(
                        f"explain: {stamp} {key}: {stack.identity} does not "
                        f"own the key but answered {replica_verdict!r} "
                        "instead of not-owner/unowned-resize"
                    )

    # mid-brownout with circuits actually open, SOMETHING unconverged
    # must pin the blame on the breaker (or a park) — an explain plane
    # that never says circuit-open during an outage is not explaining
    if (
        in_outage
        and brownout_evidence
        and harness.world.health.open_services()
        and not any(
            v in (explain_plane.VERDICT_CIRCUIT_OPEN,
                  explain_plane.VERDICT_PARKED_SETTLE)
            for v in brownout_evidence
        )
    ):
        violations.append(
            f"explain: {stamp} circuits are open mid-brownout yet none of "
            f"{len(brownout_evidence)} unconverged objects classifies "
            f"circuit-open/parked-settle (saw {sorted(set(brownout_evidence))})"
        )

    # ground truth #2: the settle tables — a parked key IS parked
    for table in harness.settle_tables():
        for key in table.parked_keys():
            merged, _ = fleet_explain(key)
            if merged["verdict"] not in _PARKED_OK_VERDICTS:
                violations.append(
                    f"explain: {stamp} {key} is parked in the settle table "
                    f"but classifies {merged['verdict']!r}"
                )
    return violations


def check_autoscaler_oscillation(
    harness, max_flips: int = 2, window: float = 3600.0
) -> list[str]:
    """The no-oscillation oracle: EXECUTED scale decisions
    must not flip direction more than ``max_flips`` times within any
    sliding ``window`` of virtual seconds — a flapping autoscaler
    churns the keyspace through drain/handoff transitions for nothing
    and is strictly worse than no autoscaler.  A harness without an
    autoscaler is vacuously clean."""
    loop = getattr(harness, "autoscaler", None)
    if loop is None:
        return []
    executed = [d for d in loop.history() if d["executed"]]
    flips = [
        current["time"]
        for previous, current in zip(executed, executed[1:])
        if current["action"] != previous["action"]
    ]
    for i, start in enumerate(flips):
        in_window = [t for t in flips[i:] if t - start <= window]
        if len(in_window) > max_flips:
            return [
                f"autoscaler-oscillation: {len(in_window)} direction flips "
                f"within {window:g}s starting t={start:.0f} "
                f"(allowed {max_flips})"
            ]
    return []


def standard_oracles(harness, cluster_name: str = "default") -> list[str]:
    """The full final-state battery."""
    violations = (
        check_convergence(harness)
        + check_record_atomicity(harness, cluster_name)
        + check_settle_drained(harness)
        + check_no_residue(harness)
    )
    if getattr(harness, "_sharded", False):
        violations += check_exclusive_shard_ownership(harness)
        violations += check_resize_handoffs(harness)
    if getattr(harness, "autoscaler", None) is not None:
        violations += check_autoscaler_oscillation(harness)
    return violations


# ---------------------------------------------------------------------------
# continuous oracles
# ---------------------------------------------------------------------------


class GCDeletionOracle:
    """No orphan deletion of live owners: snapshots accelerator/record
    ownership before each sweep and verifies, for everything that
    vanished during the sweep, that the owner object was absent from
    the cluster at that moment.  Install via
    ``harness.on_gc_sweep = oracle.after_sweep`` plus a pre-sweep
    snapshot hook, or simply wrap ``attach(harness)``."""

    def __init__(self, cluster_name: str = "default"):
        self.cluster_name = cluster_name
        self.violations: list[str] = []
        self._harness = None

    def attach(self, harness) -> "GCDeletionOracle":
        self._harness = harness
        harness.on_gc_sweep_begin = self._before_sweep
        harness.on_gc_sweep = self._after_sweep
        self._before: dict = {}
        return self

    def _before_sweep(self, harness) -> None:
        # snapshot at the sweep boundary: deletions between sweeps are
        # the ordinary reconcile paths' business, not the sweeper's
        self._before["state"] = self._snapshot()

    def _snapshot(self):
        harness = self._harness
        owners = {
            owner
            for owner in harness.aws.accelerator_owners().values()
            if owner is not None
        }
        record_owners = set()
        for zone_id in harness.aws.all_hosted_zone_ids():
            for record in harness.aws.records_in_zone(zone_id):
                if record.type != RR_TYPE_TXT:
                    continue
                for rr in record.resource_records or []:
                    parsed = parse_route53_owner_value(rr.value, self.cluster_name)
                    if parsed is not None:
                        record_owners.add(parsed)
        return owners, record_owners

    def _owner_exists(self, resource: str, ns: str, name: str) -> bool:
        kind = "Service" if resource == "service" else "Ingress"
        try:
            self._harness.cluster.get(kind, ns, name)
            return True
        except Exception:
            return False

    def _after_sweep(self, harness, report: dict) -> None:
        owners_after, record_owners_after = self._snapshot()
        before_owners, before_record_owners = self._before.pop(
            "state", (owners_after, record_owners_after)
        )
        for owner in before_owners - owners_after:
            parts = owner.split("/")
            if len(parts) == 3 and self._owner_exists(*parts):
                self.violations.append(
                    f"gc: deleted accelerator for LIVE owner {owner!r} "
                    f"(sweep {report.get('sweep')})"
                )
        for owner in before_record_owners - record_owners_after:
            if self._owner_exists(*owner):
                self.violations.append(
                    f"gc: deleted records for LIVE owner {owner!r} "
                    f"(sweep {report.get('sweep')})"
                )

    def prime(self) -> None:
        """Take the initial snapshot (call once the world is built)."""
        self._before = {"state": self._snapshot()}


class CircuitBudgetOracle:
    """While a circuit is open, wire calls to the dead service must
    stay within the half-open probe budget — brownouts shed load
    instead of feeding retry storms.  Used by scenarios that schedule
    an outage window: call ``window_started``/``window_ended`` around
    it and the oracle bounds the calls made *after* the breaker
    opened."""

    def __init__(self, harness, service_ops: frozenset, label: str):
        self.harness = harness
        self.service_ops = {self._camel(op) for op in service_ops}
        self.label = label
        self.violations: list[str] = []
        self._open_observed_at_call_index = None

    @staticmethod
    def _camel(op: str) -> str:
        return "".join(part.capitalize() for part in op.split("_"))

    def _calls_to_service(self) -> int:
        return sum(
            1 for call in self.harness.aws.calls if call[0] in self.service_ops
        )

    def circuit_opened(self) -> None:
        self._open_observed_at_call_index = self._calls_to_service()

    def window_ended(self, open_duration: float, window: float, probe_budget: int):
        if self._open_observed_at_call_index is None:
            return  # breaker never opened — nothing to bound
        made = self._calls_to_service() - self._open_observed_at_call_index
        # one probe allowance per open_duration interval, plus slack
        # for the transition calls racing the trip
        allowed = probe_budget * (int(window / max(open_duration, 0.001)) + 2) + 5
        if made > allowed:
            self.violations.append(
                f"circuit-budget: {made} calls to {self.label} while its "
                f"circuit was open (allowed ~{allowed})"
            )
