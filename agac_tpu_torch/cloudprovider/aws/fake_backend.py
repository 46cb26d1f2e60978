"""In-memory AWS backend implementing all three service interfaces.

The test double the reference never had (SURVEY.md §4: "no fake AWS
client exists; methods on *AWS* are never unit-tested").  Behaviors
reproduced because the drivers depend on them:

- **Accelerator status settling**: create/update puts an accelerator
  into IN_PROGRESS; it becomes DEPLOYED after ``settle_describes``
  describe/list calls — so the disable → poll-until-DEPLOYED → delete
  orchestration (reference ``global_accelerator.go:724-765``) is
  actually exercised by tests.
- **Deletion ordering constraints**: an enabled accelerator or one
  with listeners cannot be deleted; a listener with endpoint groups
  cannot be deleted — making the endpoint-group → listener →
  accelerator teardown order (``global_accelerator.go:252-270``)
  observable.
- **Route53 change batches**: CREATE fails on an existing name+type,
  DELETE on a missing one, UPSERT always applies; record names are
  stored dot-terminated with ``*`` escaped as ``\\052`` the way
  Route53 does (``route53.go:369-371``).
- **Pagination** on every list operation, honoring max_results.
- **Documented AWS invariants** (a fake that
  accepts inputs real AWS rejects certifies nothing): accelerator
  name charset/length per the CreateAccelerator API reference, port
  ranges 1-65535, the default service quotas (accelerators per
  account, listeners per accelerator, port ranges per listener,
  endpoint groups per listener, endpoints per endpoint group, tags
  per resource), and Route53 change-batch limits — each rejected
  with the service's documented error code
  (InvalidArgumentException / InvalidPortRangeException /
  LimitExceededException / InvalidChangeBatch).  Quotas are
  constructor-tunable the way real accounts raise them.
"""

from __future__ import annotations

import inspect
import json
import os
import random
import re
import threading
import uuid
from collections import deque
from dataclasses import replace
from typing import Callable, Optional

from ... import clockseam
from ...analysis import racecheck
from ...observability import instruments
from .api import ELBv2API, GlobalAcceleratorAPI, Route53API
from .errors import (
    AWSAPIError,
    ERR_ACCELERATOR_NOT_DISABLED,
    ERR_ACCELERATOR_NOT_FOUND,
    ERR_ASSOCIATED_ENDPOINT_GROUP_FOUND,
    ERR_ASSOCIATED_LISTENER_FOUND,
    ERR_INVALID_ARGUMENT,
    ERR_INVALID_CHANGE_BATCH,
    ERR_INVALID_PORT_RANGE,
    ERR_LIMIT_EXCEEDED,
    ERR_LOAD_BALANCER_NOT_FOUND,
    ERR_NO_SUCH_HOSTED_ZONE,
    EndpointGroupNotFoundException,
    ListenerNotFoundException,
)
from .types import (
    ACCELERATOR_STATUS_DEPLOYED,
    ACCELERATOR_STATUS_IN_PROGRESS,
    CHANGE_ACTION_CREATE,
    CHANGE_ACTION_DELETE,
    CHANGE_ACTION_UPSERT,
    Accelerator,
    Change,
    EndpointDescription,
    EndpointGroup,
    HostedZone,
    Listener,
    LoadBalancer,
    PortRange,
    ResourceRecordSet,
    Tag,
)

_ACCOUNT = "123456789012"

# CreateAccelerator Name constraint (GA API reference): up to 64
# characters, only alphanumerics/periods/hyphens, must not begin or
# end with a hyphen or period
_ACCELERATOR_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9.-]{0,62}[A-Za-z0-9]$|^[A-Za-z0-9]$")

_VALID_PROTOCOLS = frozenset({"TCP", "UDP"})
_VALID_CLIENT_AFFINITY = frozenset({"NONE", "SOURCE_IP"})
_VALID_IP_ADDRESS_TYPES = frozenset({"IPV4", "DUAL_STACK"})
# Route53 record types the 2013-04-01 API accepts
_VALID_RR_TYPES = frozenset(
    {"A", "AAAA", "CAA", "CNAME", "DS", "MX", "NAPTR", "NS", "PTR",
     "SOA", "SPF", "SRV", "TXT"}
)
_MAX_TTL = 2_147_483_647  # Route53 TTL is a 32-bit signed int


def _validate_accelerator_name(name: str) -> None:
    if not _ACCELERATOR_NAME_RE.match(name or ""):
        raise AWSAPIError(
            ERR_INVALID_ARGUMENT,
            f"Accelerator name {name!r} must be 1-64 alphanumeric, period or "
            "hyphen characters and must not begin or end with a hyphen or period",
        )


def _validate_port_ranges(port_ranges, max_ranges: int) -> None:
    if not port_ranges:
        raise AWSAPIError(ERR_INVALID_ARGUMENT, "at least one port range is required")
    if len(port_ranges) > max_ranges:
        raise AWSAPIError(
            ERR_LIMIT_EXCEEDED,
            f"{len(port_ranges)} port ranges exceeds the {max_ranges} per-listener quota",
        )
    for port_range in port_ranges:
        from_port = getattr(port_range, "from_port", None)
        to_port = getattr(port_range, "to_port", None)
        if from_port is None or to_port is None:
            raise AWSAPIError(
                ERR_INVALID_ARGUMENT,
                f"port range {port_range!r} must carry FromPort and ToPort",
            )
        if not (1 <= from_port <= 65535 and 1 <= to_port <= 65535):
            raise AWSAPIError(
                ERR_INVALID_PORT_RANGE,
                f"port range {from_port}-{to_port} outside 1-65535",
            )
        if from_port > to_port:
            raise AWSAPIError(
                ERR_INVALID_PORT_RANGE,
                f"FromPort {from_port} greater than ToPort {to_port}",
            )


def _validate_listener_args(port_ranges, protocol, client_affinity, max_ranges) -> None:
    _validate_port_ranges(port_ranges, max_ranges)
    if protocol not in _VALID_PROTOCOLS:
        raise AWSAPIError(ERR_INVALID_ARGUMENT, f"invalid Protocol {protocol!r}")
    if client_affinity not in _VALID_CLIENT_AFFINITY:
        raise AWSAPIError(
            ERR_INVALID_ARGUMENT, f"invalid ClientAffinity {client_affinity!r}"
        )


def _paginate(items: list, max_results: int, next_token: Optional[str]):
    start = int(next_token) if next_token else 0
    page = items[start : start + max_results]
    token = str(start + max_results) if start + max_results < len(items) else None
    return page, token


# every method the drivers can reach — exactly the three API
# interfaces, so test helpers (add_load_balancer, records_in_zone, ...)
# stay fault-free under an installed FaultPlan
API_OPS = frozenset(
    name
    for cls in (GlobalAcceleratorAPI, ELBv2API, Route53API)
    for name, member in vars(cls).items()
    if inspect.isfunction(member) and not name.startswith("_")
)

_MUTATING_PREFIXES = (
    "create_", "update_", "delete_", "add_", "remove_", "tag_", "change_",
)
# the reads that count toward an accelerator's settle (``_settle``)
_SETTLING_READS = frozenset({"describe_accelerator", "list_accelerators"})


class SimulatedCrash(BaseException):
    """The process/worker died at this exact API-call boundary.

    Raised by ``FaultPlan.crash`` schedules.  A ``BaseException`` on
    purpose: the retry/requeue machinery catches ``Exception`` — a
    crash must never be absorbed into a backoff retry, because the
    whole point is that NOTHING after the death point runs.  The drill
    harness maps it to real death: in-process drills let it kill the
    worker thread; the subprocess drills (``AGAC_FAKE_CRASH``,
    factory.py) map it to ``os._exit`` — the ``kill -9`` analog."""

    def __init__(self, op: str, when: str):
        self.op = op
        self.when = when
        super().__init__(f"simulated crash {when} {op}")


class _SerialCounter:
    """``itertools.count`` with a readable current value, so durable
    backends can persist it and resume without ID collisions."""

    __slots__ = ("value",)

    def __init__(self, start: int = 1):
        self.value = start

    def __next__(self) -> int:
        value = self.value
        self.value += 1
        return value

    def __iter__(self) -> "_SerialCounter":
        return self


class _Fault:
    """One scripted fault: ``kind`` is fail / commit-then-fail / hang;
    ``remaining`` counts down to exhaustion."""

    __slots__ = ("kind", "code", "remaining")

    def __init__(self, kind: str, code: str, remaining: int):
        self.kind = kind
        self.code = code
        self.remaining = remaining


class FaultPlan:
    """First-class fault injection for ``FakeAWSBackend`` — the
    promotion of the chaos tier's ad-hoc ``__getattribute__`` subclass
    hooks into one scripted API.  Three layers,
    consulted in order for every API call from a non-exempt thread:

    1. **scripted schedules** per op (FIFO): ``throttle(op, times)``,
       ``fail(op, times, code)``, ``fail_after_commit(op, times)`` (the
       ambiguous-timeout shape: the change commits, the caller sees an
       error), ``hang_until_deadline(op)`` (the call blocks until the
       calling worker's reconcile deadline expires, then surfaces a
       timeout — the wedge shape the deadline machinery exists to cut),
       and ``crash(op, when="before"|"after-commit")`` (the caller DIES
       at the op boundary — a ``SimulatedCrash`` the kill-recovery
       drills map to worker/process death; ``after-commit`` commits the
       mutation first, the torn-write shape of a kill -9 mid-chain);
    2. **outages**: ``outage(*ops)`` fails every call until
       ``restore()`` — the sustained-brownout shape the circuit
       breaker reacts to;
    3. **chaos**: ``chaos(seed, fault_budget, p, ambiguous)`` — the
       seeded randomized mode the chaos e2e tier runs (finite budget,
       so every run terminates).

    The thread that builds the plan is exempt by default so test
    assertion predicates read clean truth through the same API.
    ``faults_served`` / ``served_by_op`` count injected faults —
    during an outage they equal the calls attempted against the dead
    service, which is what the brownout call-budget assertions bound.
    """

    def __init__(self, exempt_creator: bool = True):
        self._lock = threading.Lock()
        self._scripts: dict[str, deque[_Fault]] = {}
        self._outages: dict[str, str] = {}  # op -> error code
        self._rng: Optional[random.Random] = None
        self._p = 0.0
        self._ambiguous = 0.0
        self.fault_budget = 0
        self.faults_served = 0
        self.served_by_op: dict[str, int] = {}
        self._exempt: set = {threading.current_thread()} if exempt_creator else set()
        # safety valve for hang_until_deadline when no deadline is
        # armed: never block a call longer than this
        self.max_hang = 30.0
        # how a SimulatedCrash becomes death: None raises it (kills
        # the worker thread in in-process drills); the subprocess
        # drills set os._exit here — the kill -9 analog
        self.on_crash: Optional[Callable[[SimulatedCrash], None]] = None

    # -- scripted schedules -------------------------------------------------
    def _script(self, op: str, kind: str, code: str, times: int) -> "FaultPlan":
        if op not in API_OPS:
            raise ValueError(f"unknown API op {op!r}")
        with self._lock:
            self._scripts.setdefault(op, deque()).append(_Fault(kind, code, times))
        return self

    def throttle(self, op: str, times: int = 1, code: str = "ThrottlingException") -> "FaultPlan":
        return self._script(op, "fail", code, times)

    def fail(self, op: str, times: int = 1, code: str = "InternalFailure") -> "FaultPlan":
        return self._script(op, "fail", code, times)

    def fail_after_commit(self, op: str, times: int = 1, code: str = "RequestTimeout") -> "FaultPlan":
        return self._script(op, "commit-then-fail", code, times)

    def hang_until_deadline(self, op: str, times: int = 1) -> "FaultPlan":
        return self._script(op, "hang", "RequestTimeout", times)

    def crash(self, op: str, when: str = "before", times: int = 1) -> "FaultPlan":
        """Kill the caller at this op boundary: ``when="before"`` dies
        without committing (the op never ran), ``when="after-commit"``
        commits the change first (a durable backend has already flushed
        it) and THEN dies — the torn-write shape a ``kill -9``
        mid-mutation leaves behind.  The death is a ``SimulatedCrash``
        (a BaseException, so no retry path can absorb it); set
        ``on_crash`` to map it to real process death (the subprocess
        drills use ``os._exit``)."""
        if when not in ("before", "after-commit"):
            raise ValueError(f"crash when= must be 'before' or 'after-commit', got {when!r}")
        return self._script(op, f"crash-{when}", "SimulatedCrash", times)

    # -- sustained outage ---------------------------------------------------
    def outage(self, *ops: str, code: str = "ServiceUnavailable") -> "FaultPlan":
        unknown = [op for op in ops if op not in API_OPS]
        if unknown:
            raise ValueError(f"unknown API ops {unknown!r}")
        with self._lock:
            for op in ops:
                self._outages[op] = code
        return self

    def restore(self, *ops: str) -> "FaultPlan":
        """End an outage for the given ops (none = all)."""
        with self._lock:
            if ops:
                for op in ops:
                    self._outages.pop(op, None)
            else:
                self._outages.clear()
        return self

    # -- randomized chaos ---------------------------------------------------
    def chaos(
        self, seed: int, fault_budget: int, p: float = 0.25, ambiguous: float = 0.4
    ) -> "FaultPlan":
        """Any API call may fail with a retryable error at probability
        ``p`` while the budget lasts; mutating ops additionally fail
        *after* committing with conditional probability ``ambiguous``."""
        with self._lock:
            self._rng = random.Random(seed)
            self._p = p
            self._ambiguous = ambiguous
            self.fault_budget = fault_budget
        return self

    def refill(self, budget: int) -> None:
        with self._lock:
            self.fault_budget = budget

    # -- bookkeeping --------------------------------------------------------
    def exempt(self, thread: Optional[threading.Thread] = None) -> "FaultPlan":
        with self._lock:
            self._exempt.add(thread or threading.current_thread())
        return self

    def faults_for(self, *ops: str) -> int:
        with self._lock:
            return sum(self.served_by_op.get(op, 0) for op in ops)

    def _serve(self, op: str) -> None:
        self.faults_served += 1
        self.served_by_op[op] = self.served_by_op.get(op, 0) + 1

    # -- the engine ---------------------------------------------------------
    def _decide(self, op: str) -> Optional[tuple[str, str]]:
        """(kind, code) to inject for this call, or None."""
        if threading.current_thread() in self._exempt:
            return None
        with self._lock:
            schedule = self._scripts.get(op)
            while schedule:
                fault = schedule[0]
                if fault.remaining <= 0:
                    schedule.popleft()
                    continue
                fault.remaining -= 1
                self._serve(op)
                return fault.kind, fault.code
            code = self._outages.get(op)
            if code is not None:
                self._serve(op)
                return "fail", code
            if self._rng is not None and self.fault_budget > 0:
                if self._rng.random() < self._p:
                    self.fault_budget -= 1
                    self._serve(op)
                    if op.startswith(_MUTATING_PREFIXES) and self._rng.random() < self._ambiguous:
                        return "commit-then-fail", "RequestTimeout"
                    return "fail", "ThrottlingException"
        return None

    def _hang(self, op: str) -> None:
        """Block like a wedged backend call, bounded by the calling
        worker's reconcile deadline (health plane) or ``max_hang``,
        then surface the timeout shape a real stuck call produces."""
        from .health import deadline_remaining

        remaining = deadline_remaining()
        wait = self.max_hang if remaining is None else min(remaining + 0.05, self.max_hang)
        if wait > 0:
            # through the clock seam: a hang fault burns
            # VIRTUAL time under the sim runtime instead of stalling
            # the cooperative scheduler on a real Event wait
            clockseam.sleep(wait)
        raise AWSAPIError("RequestTimeout", f"fault plan: {op} hung past deadline")

    def _die(self, crash: SimulatedCrash) -> None:
        hook = self.on_crash
        if hook is not None:
            hook(crash)
        raise crash

    def wrap(self, op: str, call):
        def faulted(*args, **kwargs):
            fate = self._decide(op)
            if fate is None:
                return call(*args, **kwargs)
            kind, code = fate
            if kind == "hang":
                self._hang(op)
            if kind == "fail":
                raise AWSAPIError(code, f"fault plan: {op}")
            if kind == "crash-before":
                self._die(SimulatedCrash(op, "before"))
            result = call(*args, **kwargs)  # commit-then-fail / crash-after-commit
            del result
            if kind == "crash-after-commit":
                self._die(SimulatedCrash(op, "after-commit"))
            raise AWSAPIError(code, f"fault plan (after commit): {op}")

        return faulted


class _AcceleratorState:
    def __init__(self, accelerator: Accelerator, tags: list[Tag], settle: int):
        self.accelerator = accelerator
        self.tags = tags
        self.listeners: dict[str, Listener] = {}
        self.pending_describes = settle  # describes until DEPLOYED


class FakeAWSBackend(GlobalAcceleratorAPI, ELBv2API, Route53API):
    """One object implements all three services; hand it to the driver
    as ga_api, elb_api and route53_api."""

    def __init__(
        self,
        settle_describes: int = 0,
        # per-call wire latency in seconds (0 = instant): the
        # multi-process sharding bench shapes real
        # subprocesses with it so throughput is bound by each
        # process's worker pool x latency — the capacity model
        # sharding divides — instead of by raw fake-op speed.
        # Sleeps go through the clock seam (virtual under the sim).
        latency: float = 0.0,
        # the documented default service quotas; raise them the way a
        # real account requests quota increases (the bench's 1000-
        # accelerator fleet does)
        quota_accelerators: int = 20,
        quota_listeners_per_accelerator: int = 10,
        quota_port_ranges_per_listener: int = 10,
        quota_endpoint_groups_per_listener: int = 10,
        quota_endpoints_per_group: int = 10,
        quota_tags_per_resource: int = 50,
        quota_changes_per_batch: int = 1000,
    ):
        # racecheck seam: with the lock-order watchdog enabled (tests)
        # the backend lock participates in cycle detection and the
        # shared service tables below become guarded dicts that record
        # any mutation performed without this lock held — the fake is
        # hit concurrently by every controller worker plus test-side
        # tamper threads, exactly the surface Go's -race covered for
        # the reference.
        lock = racecheck.make_rlock("fake-backend")
        self._lock = lock
        self.settle_describes = settle_describes
        self.latency = max(0.0, latency)
        self.quota_accelerators = quota_accelerators
        self.quota_listeners_per_accelerator = quota_listeners_per_accelerator
        self.quota_port_ranges_per_listener = quota_port_ranges_per_listener
        self.quota_endpoint_groups_per_listener = quota_endpoint_groups_per_listener
        self.quota_endpoints_per_group = quota_endpoints_per_group
        self.quota_tags_per_resource = quota_tags_per_resource
        self.quota_changes_per_batch = quota_changes_per_batch
        # reads of self.* here would recurse into test subclasses'
        # __getattribute__ fault hooks before their own __init__ ran —
        # close over the local ``lock`` instead
        guard = lambda name: racecheck.guard_dict({}, lock, f"fake-backend.{name}")
        self._accelerators: dict[str, _AcceleratorState] = guard("_accelerators")
        # listener arn -> (accelerator arn); endpoint groups keyed by arn
        self._listener_parent: dict[str, str] = guard("_listener_parent")
        self._endpoint_groups: dict[str, EndpointGroup] = guard("_endpoint_groups")
        self._eg_parent: dict[str, str] = guard("_eg_parent")  # eg arn -> listener arn
        self._load_balancers: dict[str, LoadBalancer] = guard("_load_balancers")  # name -> LB
        self._zones: dict[str, HostedZone] = guard("_zones")  # id -> zone
        self._records: dict[str, dict[tuple[str, str], ResourceRecordSet]] = guard("_records")
        self._counter = _SerialCounter()
        # derived indexes (plain dicts, always mutated under the lock;
        # insertion-ordered so iteration stays deterministic for the
        # sim replay contract): arns still settling toward DEPLOYED —
        # so a ListAccelerators page settles O(pending), not O(fleet) —
        # and listener arn -> its endpoint-group arns, so per-chain
        # listing is O(chain), not a scan of every group in the fleet
        self._settling: dict[str, None] = {}
        self._egs_by_listener: dict[str, dict[str, None]] = {}
        # memoized ListAccelerators item list, dropped whenever any
        # accelerator payload changes — a paginated drain at N=10k is
        # ~100 page calls, and rebuilding the O(N) list per page made
        # every drain O(N^2/page) in the 7-day sim soak
        self._accel_list_cache: "Optional[list[Accelerator]]" = None
        # call log for assertions ("CreateAccelerator", arn), ...
        self.calls: list[tuple] = []
        # first-class fault injection (see FaultPlan); None = clean
        self.fault_plan: Optional[FaultPlan] = None
        # durability seam (see FileBackedFakeAWSBackend): wraps every
        # API op INSIDE the fault plan, so a commit is flushed to disk
        # before a commit-then-fail error or an after-commit crash
        # surfaces — exactly the ordering a real backend gives a dying
        # client
        self._persist_hook: Optional[Callable] = None

    def install_fault_plan(self, plan: Optional[FaultPlan] = None) -> FaultPlan:
        """Attach a FaultPlan (building one if not given) and return
        it; every subsequent API call from a non-exempt thread consults
        it.  Replaces the old pattern of ad-hoc ``__getattribute__``
        subclasses in the chaos/resilience tiers."""
        self.fault_plan = plan if plan is not None else FaultPlan()
        return self.fault_plan

    def __getattribute__(self, name):
        attr = super().__getattribute__(name)
        if name in API_OPS:
            # __dict__ lookup, not self.fault_plan: attribute access
            # here would recurse, and during __init__ the slots may not
            # exist yet
            state = super().__getattribute__("__dict__")
            persist = state.get("_persist_hook")
            if persist is not None:
                attr = persist(name, attr)
            plan = state.get("fault_plan")
            if plan is not None:
                attr = plan.wrap(name, attr)
            latency = state.get("latency", 0.0)
            if latency:
                inner = attr

                def paced(*args, __inner=inner, **kwargs):
                    clockseam.sleep(latency)
                    return __inner(*args, **kwargs)

                attr = paced
        return attr

    # ------------------------------------------------------------------
    # test helpers
    # ------------------------------------------------------------------
    def add_load_balancer(
        self,
        name: str,
        region: str,
        dns_name: str,
        state_code: str = "active",
        lb_type: str = "network",
        scheme: str = "internet-facing",
    ) -> LoadBalancer:
        with self._lock:
            # idempotent on (name, dns): a restarted process re-seeding
            # the same env-declared LB must not mint a new arn — the
            # durable state's endpoint groups reference the old one
            existing = self._load_balancers.get(name)
            if existing is not None and existing.dns_name == dns_name:
                return existing
            arn = (
                f"arn:aws:elasticloadbalancing:{region}:{_ACCOUNT}:"
                f"loadbalancer/{'net' if lb_type == 'network' else 'app'}/{name}/{next(self._counter):016x}"
            )
            lb = LoadBalancer(
                load_balancer_arn=arn,
                load_balancer_name=name,
                dns_name=dns_name,
                state_code=state_code,
                type=lb_type,
                scheme=scheme,
            )
            self._load_balancers[name] = lb
        return lb

    def set_load_balancer_state(self, name: str, state_code: str) -> None:
        with self._lock:
            self._load_balancers[name].state_code = state_code

    def add_hosted_zone(self, name: str) -> HostedZone:
        if not name.endswith("."):
            name += "."
        with self._lock:
            # idempotent by name (same rationale as add_load_balancer:
            # restart re-seeding must not duplicate the zone)
            for zone in self._zones.values():
                if zone.name == name:
                    return zone
            zone = HostedZone(id=f"/hostedzone/Z{next(self._counter):08X}", name=name)
            self._zones[zone.id] = zone
            self._records.setdefault(zone.id, {})
        return zone

    def records_in_zone(self, zone_id: str) -> list[ResourceRecordSet]:
        with self._lock:
            return list(self._records.get(zone_id, {}).values())

    def all_accelerator_arns(self) -> list[str]:
        with self._lock:
            return list(self._accelerators.keys())

    def chain_counts(self) -> tuple[int, int, int]:
        """(accelerators, listeners, endpoint groups) — the complete-
        chain convergence odometer.  With staged chains an
        accelerator exists passes before its listener/endpoint group
        do, so counting accelerators alone would declare convergence
        early."""
        with self._lock:
            return (
                len(self._accelerators),
                len(self._listener_parent),
                len(self._endpoint_groups),
            )

    def accelerator_owners(self) -> dict[str, Optional[str]]:
        """arn -> owner-tag value — a test/oracle helper read that is
        neither faulted nor call-counted (sim oracles snapshot GC
        ground truth through this without perturbing fault budgets or
        quiescence windows)."""
        with self._lock:
            return {
                arn: next(
                    (
                        t.value
                        for t in state.tags
                        # keep in sync with driver.OWNER_TAG_KEY (the
                        # fake never imports the driver)
                        if t.key == "aws-global-accelerator-owner"
                    ),
                    None,
                )
                for arn, state in self._accelerators.items()
            }

    def all_hosted_zone_ids(self) -> list[str]:
        """Every hosted-zone id (unfaulted helper; see above)."""
        with self._lock:
            return sorted(self._zones.keys())

    # ------------------------------------------------------------------
    # GlobalAcceleratorAPI
    # ------------------------------------------------------------------
    def _settle(self, state: _AcceleratorState) -> None:
        if state.pending_describes > 0:
            state.pending_describes -= 1
            if state.pending_describes == 0:
                state.accelerator = replace(
                    state.accelerator, status=ACCELERATOR_STATUS_DEPLOYED
                )
                self._settling.pop(state.accelerator.accelerator_arn, None)
                self._accel_list_cache = None

    def _get_state(self, arn: str) -> _AcceleratorState:
        state = self._accelerators.get(arn)
        if state is None:
            raise AWSAPIError(ERR_ACCELERATOR_NOT_FOUND, arn)
        return state

    def list_accelerators(self, max_results, next_token):
        with self._lock:
            self.calls.append(("ListAccelerators",))
            for arn in list(self._settling):
                state = self._accelerators.get(arn)
                if state is None:
                    self._settling.pop(arn, None)
                else:
                    self._settle(state)
            if self._accel_list_cache is None:
                self._accel_list_cache = [
                    s.accelerator for s in self._accelerators.values()
                ]
            return _paginate(self._accel_list_cache, max_results, next_token)

    def describe_accelerator(self, arn):
        with self._lock:
            self.calls.append(("DescribeAccelerator", arn))
            state = self._get_state(arn)
            self._settle(state)
            return state.accelerator

    def create_accelerator(self, name, ip_address_type, enabled, tags):
        _validate_accelerator_name(name)
        if ip_address_type not in _VALID_IP_ADDRESS_TYPES:
            raise AWSAPIError(
                ERR_INVALID_ARGUMENT, f"invalid IpAddressType {ip_address_type!r}"
            )
        with self._lock:
            if len(tags) > self.quota_tags_per_resource:
                raise AWSAPIError(
                    ERR_LIMIT_EXCEEDED,
                    f"{len(tags)} tags exceeds the {self.quota_tags_per_resource} "
                    "per-resource quota",
                )
            if len(self._accelerators) >= self.quota_accelerators:
                raise AWSAPIError(
                    ERR_LIMIT_EXCEEDED,
                    f"account quota of {self.quota_accelerators} accelerators reached",
                )
            # uuid5 over the serial counter, not uuid4: the ARN must be
            # re-derivable on incident replay (counter state travels in
            # the capture snapshot; random minting would diverge)
            arn = (
                f"arn:aws:globalaccelerator::{_ACCOUNT}:accelerator/"
                f"{uuid.uuid5(uuid.NAMESPACE_URL, f'agac/{_ACCOUNT}/{next(self._counter)}')}"
            )
            accelerator = Accelerator(
                accelerator_arn=arn,
                name=name,
                dns_name=f"a{next(self._counter):016x}.awsglobalaccelerator.com",
                enabled=enabled,
                status=(
                    ACCELERATOR_STATUS_IN_PROGRESS
                    if self.settle_describes
                    else ACCELERATOR_STATUS_DEPLOYED
                ),
                ip_address_type=ip_address_type,
            )
            self._accelerators[arn] = _AcceleratorState(
                accelerator, list(tags), self.settle_describes
            )
            self._accel_list_cache = None
            if self.settle_describes:
                self._settling[arn] = None
            self.calls.append(("CreateAccelerator", arn))
            return accelerator

    def update_accelerator(self, arn, name=None, enabled=None):
        if name is not None:
            _validate_accelerator_name(name)
        with self._lock:
            state = self._get_state(arn)
            changes = {}
            if name is not None:
                changes["name"] = name
            if enabled is not None:
                changes["enabled"] = enabled
            if self.settle_describes:
                changes["status"] = ACCELERATOR_STATUS_IN_PROGRESS
                state.pending_describes = self.settle_describes
                self._settling[arn] = None
            state.accelerator = replace(state.accelerator, **changes)
            self._accel_list_cache = None
            self.calls.append(("UpdateAccelerator", arn))
            return state.accelerator

    def delete_accelerator(self, arn):
        with self._lock:
            state = self._get_state(arn)
            if state.accelerator.enabled:
                raise AWSAPIError(
                    ERR_ACCELERATOR_NOT_DISABLED, "accelerator must be disabled"
                )
            if state.listeners:
                raise AWSAPIError(
                    ERR_ASSOCIATED_LISTENER_FOUND, "accelerator still has listeners"
                )
            del self._accelerators[arn]
            self._accel_list_cache = None
            self.calls.append(("DeleteAccelerator", arn))

    def list_tags_for_resource(self, arn):
        with self._lock:
            self.calls.append(("ListTagsForResource", arn))
            return list(self._get_state(arn).tags)

    def tag_resource(self, arn, tags):
        with self._lock:
            state = self._get_state(arn)
            merged = {t.key: t.value for t in state.tags}
            merged.update({t.key: t.value for t in tags})
            if len(merged) > self.quota_tags_per_resource:
                raise AWSAPIError(
                    ERR_LIMIT_EXCEEDED,
                    f"{len(merged)} tags exceeds the "
                    f"{self.quota_tags_per_resource} per-resource quota",
                )
            state.tags = [Tag(k, v) for k, v in merged.items()]
            self.calls.append(("TagResource", arn))

    def list_listeners(self, accelerator_arn, max_results, next_token):
        with self._lock:
            self.calls.append(("ListListeners", accelerator_arn))
            state = self._get_state(accelerator_arn)
            items = [
                Listener(
                    listener_arn=l.listener_arn,
                    protocol=l.protocol,
                    port_ranges=list(l.port_ranges),
                    client_affinity=l.client_affinity,
                )
                for l in state.listeners.values()
            ]
            return _paginate(items, max_results, next_token)

    def create_listener(self, accelerator_arn, port_ranges, protocol, client_affinity):
        _validate_listener_args(
            port_ranges, protocol, client_affinity,
            self.quota_port_ranges_per_listener,
        )
        with self._lock:
            state = self._get_state(accelerator_arn)
            if len(state.listeners) >= self.quota_listeners_per_accelerator:
                raise AWSAPIError(
                    ERR_LIMIT_EXCEEDED,
                    f"accelerator quota of {self.quota_listeners_per_accelerator} "
                    "listeners reached",
                )
            arn = f"{accelerator_arn}/listener/{next(self._counter):08x}"
            listener = Listener(
                listener_arn=arn,
                protocol=protocol,
                port_ranges=list(port_ranges),
                client_affinity=client_affinity,
            )
            state.listeners[arn] = listener
            self._listener_parent[arn] = accelerator_arn
            self.calls.append(("CreateListener", arn))
            return Listener(**{**vars(listener), "port_ranges": list(port_ranges)})

    def _get_listener(self, listener_arn: str) -> Listener:
        parent = self._listener_parent.get(listener_arn)
        if parent is None or parent not in self._accelerators:
            raise ListenerNotFoundException(listener_arn)
        return self._accelerators[parent].listeners[listener_arn]

    def update_listener(self, listener_arn, port_ranges, protocol, client_affinity):
        _validate_listener_args(
            port_ranges, protocol, client_affinity,
            self.quota_port_ranges_per_listener,
        )
        with self._lock:
            listener = self._get_listener(listener_arn)
            listener.port_ranges = list(port_ranges)
            listener.protocol = protocol
            listener.client_affinity = client_affinity
            self.calls.append(("UpdateListener", listener_arn))
            return Listener(**{**vars(listener), "port_ranges": list(port_ranges)})

    def delete_listener(self, arn):
        with self._lock:
            listener = self._get_listener(arn)
            if self._egs_by_listener.get(arn):
                raise AWSAPIError(
                    ERR_ASSOCIATED_ENDPOINT_GROUP_FOUND,
                    "listener still has endpoint groups",
                )
            parent = self._listener_parent.pop(arn)
            del self._accelerators[parent].listeners[arn]
            self.calls.append(("DeleteListener", arn))

    def list_endpoint_groups(self, listener_arn, max_results, next_token):
        with self._lock:
            self.calls.append(("ListEndpointGroups", listener_arn))
            self._get_listener(listener_arn)  # existence check
            items = [
                self._copy_eg(self._endpoint_groups[arn])
                for arn in self._egs_by_listener.get(listener_arn, ())
            ]
            return _paginate(items, max_results, next_token)

    @staticmethod
    def _copy_eg(eg: EndpointGroup) -> EndpointGroup:
        return EndpointGroup(
            endpoint_group_arn=eg.endpoint_group_arn,
            endpoint_group_region=eg.endpoint_group_region,
            endpoint_descriptions=[
                EndpointDescription(**vars(d)) for d in eg.endpoint_descriptions
            ],
        )

    def describe_endpoint_group(self, arn):
        with self._lock:
            self.calls.append(("DescribeEndpointGroup", arn))
            eg = self._endpoint_groups.get(arn)
            if eg is None:
                raise EndpointGroupNotFoundException(arn)
            return self._copy_eg(eg)

    def _validate_endpoint_configurations(self, configs) -> None:
        if len(configs) > self.quota_endpoints_per_group:
            raise AWSAPIError(
                ERR_LIMIT_EXCEEDED,
                f"{len(configs)} endpoints exceeds the "
                f"{self.quota_endpoints_per_group} per-group quota",
            )
        for config in configs:
            if not config.endpoint_id:
                raise AWSAPIError(ERR_INVALID_ARGUMENT, "EndpointId is required")
            if config.weight is not None and not (0 <= config.weight <= 255):
                raise AWSAPIError(
                    ERR_INVALID_ARGUMENT,
                    f"endpoint Weight {config.weight} outside 0-255",
                )

    def create_endpoint_group(self, listener_arn, endpoint_group_region, endpoint_configurations):
        if not endpoint_group_region:
            raise AWSAPIError(ERR_INVALID_ARGUMENT, "EndpointGroupRegion is required")
        self._validate_endpoint_configurations(endpoint_configurations)
        with self._lock:
            self._get_listener(listener_arn)
            groups_on_listener = len(self._egs_by_listener.get(listener_arn, ()))
            if groups_on_listener >= self.quota_endpoint_groups_per_listener:
                raise AWSAPIError(
                    ERR_LIMIT_EXCEEDED,
                    f"listener quota of {self.quota_endpoint_groups_per_listener} "
                    "endpoint groups reached",
                )
            arn = f"{listener_arn}/endpoint-group/{next(self._counter):08x}"
            eg = EndpointGroup(
                endpoint_group_arn=arn,
                endpoint_group_region=endpoint_group_region,
                endpoint_descriptions=[
                    EndpointDescription(
                        endpoint_id=c.endpoint_id,
                        weight=c.weight,
                        client_ip_preservation_enabled=c.client_ip_preservation_enabled,
                    )
                    for c in endpoint_configurations
                ],
            )
            self._endpoint_groups[arn] = eg
            self._eg_parent[arn] = listener_arn
            self._egs_by_listener.setdefault(listener_arn, {})[arn] = None
            self.calls.append(("CreateEndpointGroup", arn))
            return self._copy_eg(eg)

    def update_endpoint_group(self, arn, endpoint_configurations):
        """UpdateEndpointGroup treats the configuration list as the
        COMPLETE desired endpoint set (real AWS semantics) — callers
        updating one endpoint must send all of them."""
        self._validate_endpoint_configurations(endpoint_configurations)
        with self._lock:
            eg = self._endpoint_groups.get(arn)
            if eg is None:
                raise EndpointGroupNotFoundException(arn)
            eg.endpoint_descriptions = [
                EndpointDescription(
                    endpoint_id=c.endpoint_id,
                    weight=c.weight,
                    client_ip_preservation_enabled=c.client_ip_preservation_enabled,
                )
                for c in endpoint_configurations
            ]
            self.calls.append(("UpdateEndpointGroup", arn))
            return self._copy_eg(eg)

    def delete_endpoint_group(self, arn):
        with self._lock:
            if arn not in self._endpoint_groups:
                raise EndpointGroupNotFoundException(arn)
            del self._endpoint_groups[arn]
            parent = self._eg_parent.pop(arn)
            bucket = self._egs_by_listener.get(parent)
            if bucket is not None:
                bucket.pop(arn, None)
                if not bucket:
                    del self._egs_by_listener[parent]
            self.calls.append(("DeleteEndpointGroup", arn))

    def add_endpoints(self, arn, endpoint_configurations):
        self._validate_endpoint_configurations(endpoint_configurations)
        with self._lock:
            eg = self._endpoint_groups.get(arn)
            if eg is None:
                raise EndpointGroupNotFoundException(arn)
            new_ids = {c.endpoint_id for c in endpoint_configurations} - {
                d.endpoint_id for d in eg.endpoint_descriptions
            }
            if len(eg.endpoint_descriptions) + len(new_ids) > self.quota_endpoints_per_group:
                raise AWSAPIError(
                    ERR_LIMIT_EXCEEDED,
                    f"group quota of {self.quota_endpoints_per_group} endpoints reached",
                )
            added = []
            for c in endpoint_configurations:
                desc = EndpointDescription(
                    endpoint_id=c.endpoint_id,
                    weight=c.weight,
                    client_ip_preservation_enabled=c.client_ip_preservation_enabled,
                )
                existing = [d for d in eg.endpoint_descriptions if d.endpoint_id == c.endpoint_id]
                if existing:
                    existing[0].weight = c.weight
                    existing[0].client_ip_preservation_enabled = c.client_ip_preservation_enabled
                    added.append(existing[0])
                else:
                    eg.endpoint_descriptions.append(desc)
                    added.append(desc)
            self.calls.append(("AddEndpoints", arn))
            return [EndpointDescription(**vars(d)) for d in added]

    def remove_endpoints(self, arn, endpoint_ids):
        with self._lock:
            eg = self._endpoint_groups.get(arn)
            if eg is None:
                raise EndpointGroupNotFoundException(arn)
            eg.endpoint_descriptions = [
                d for d in eg.endpoint_descriptions if d.endpoint_id not in endpoint_ids
            ]
            self.calls.append(("RemoveEndpoints", arn))

    # ------------------------------------------------------------------
    # ELBv2API
    # ------------------------------------------------------------------
    def describe_load_balancers(self, names):
        with self._lock:
            # batch size in the log so the read-plane call-budget and
            # coalescer tests can assert wire-call counts AND widths
            self.calls.append(("DescribeLoadBalancers", len(names)))
            found = [
                LoadBalancer(**vars(self._load_balancers[n]))
                for n in names
                if n in self._load_balancers
            ]
            if not found:
                raise AWSAPIError(
                    ERR_LOAD_BALANCER_NOT_FOUND,
                    f"Load balancers '{names}' not found",
                )
            return found

    # ------------------------------------------------------------------
    # Route53API
    # ------------------------------------------------------------------
    @staticmethod
    def _wire_name(name: str) -> str:
        """Route53 stores names dot-terminated with ``*`` as ``\\052``."""
        if not name.endswith("."):
            name += "."
        return name.replace("*", "\\052", 1)

    def list_hosted_zones(self, max_items, marker):
        with self._lock:
            self.calls.append(("ListHostedZones",))
            zones = sorted(self._zones.values(), key=lambda z: z.name)
            return _paginate([HostedZone(**vars(z)) for z in zones], max_items, marker)

    def list_hosted_zones_by_name(self, dns_name, max_items):
        """Lexicographic from ``dns_name`` onward, like the real API."""
        if not dns_name.endswith("."):
            dns_name += "."
        with self._lock:
            self.calls.append(("ListHostedZonesByName", dns_name))
            # Route53 orders by reversed-label DNS name; plain name sort
            # is enough for the "does an exact zone exist" probe the
            # driver performs (reference route53.go:337-357).
            zones = sorted(self._zones.values(), key=lambda z: z.name)
            after = [HostedZone(**vars(z)) for z in zones if z.name >= dns_name]
            return after[:max_items]

    @staticmethod
    def _copy_rrs(r: ResourceRecordSet) -> ResourceRecordSet:
        from .types import AliasTarget, ResourceRecord

        return ResourceRecordSet(
            name=r.name,
            type=r.type,
            ttl=r.ttl,
            resource_records=[ResourceRecord(rr.value) for rr in r.resource_records],
            alias_target=AliasTarget(**vars(r.alias_target)) if r.alias_target else None,
        )

    def list_resource_record_sets(self, hosted_zone_id, max_items, start_record_name):
        with self._lock:
            self.calls.append(("ListResourceRecordSets", hosted_zone_id))
            if hosted_zone_id not in self._zones:
                raise AWSAPIError(ERR_NO_SUCH_HOSTED_ZONE, hosted_zone_id)
            records = sorted(
                self._records[hosted_zone_id].values(), key=lambda r: (r.name, r.type)
            )
            items = [self._copy_rrs(r) for r in records]
            return _paginate(items, max_items, start_record_name)

    def change_resource_record_sets(self, hosted_zone_id, changes: list[Change]):
        if not changes:
            raise AWSAPIError(
                ERR_INVALID_CHANGE_BATCH, "change batch must not be empty"
            )
        if len(changes) > self.quota_changes_per_batch:
            raise AWSAPIError(
                ERR_INVALID_CHANGE_BATCH,
                f"{len(changes)} changes exceeds the "
                f"{self.quota_changes_per_batch} per-batch limit",
            )
        with self._lock:
            if hosted_zone_id not in self._zones:
                raise AWSAPIError(ERR_NO_SUCH_HOSTED_ZONE, hosted_zone_id)
            table = self._records[hosted_zone_id]
            # validate the whole batch first: Route53 batches are atomic
            for change in changes:
                record_set = change.record_set
                if record_set.type not in _VALID_RR_TYPES:
                    raise AWSAPIError(
                        ERR_INVALID_CHANGE_BATCH,
                        f"invalid record type {record_set.type!r}",
                    )
                if not record_set.name:
                    raise AWSAPIError(
                        ERR_INVALID_CHANGE_BATCH, "record name is required"
                    )
                if record_set.ttl is not None and not (0 <= record_set.ttl <= _MAX_TTL):
                    raise AWSAPIError(
                        ERR_INVALID_CHANGE_BATCH,
                        f"TTL {record_set.ttl} outside 0-{_MAX_TTL}",
                    )
                if record_set.alias_target is None and record_set.ttl is None:
                    # a non-alias record set must carry a TTL
                    raise AWSAPIError(
                        ERR_INVALID_CHANGE_BATCH,
                        f"record {record_set.name!r} has neither AliasTarget nor TTL",
                    )
            for change in changes:
                record = change.record_set
                key = (self._wire_name(record.name), record.type)
                if change.action == CHANGE_ACTION_CREATE and key in table:
                    raise AWSAPIError(
                        ERR_INVALID_CHANGE_BATCH,
                        f"record {key} already exists",
                    )
                if change.action == CHANGE_ACTION_DELETE and key not in table:
                    raise AWSAPIError(
                        ERR_INVALID_CHANGE_BATCH,
                        f"record {key} does not exist",
                    )
                if change.action not in (
                    CHANGE_ACTION_CREATE,
                    CHANGE_ACTION_DELETE,
                    CHANGE_ACTION_UPSERT,
                ):
                    raise AWSAPIError(ERR_INVALID_CHANGE_BATCH, change.action)
            for change in changes:
                record = self._copy_rrs(change.record_set)
                record.name = self._wire_name(record.name)
                if record.alias_target and not record.alias_target.dns_name.endswith("."):
                    # Route53 returns alias DNSNames dot-terminated
                    # regardless of how they were submitted
                    record.alias_target.dns_name += "."
                key = (record.name, record.type)
                if change.action == CHANGE_ACTION_DELETE:
                    del table[key]
                else:
                    table[key] = record
            self.calls.append(("ChangeResourceRecordSets", hosted_zone_id))

    # -- serialization ---------------------------------------------------
    def _encode(self) -> dict:
        """The complete service state as JSON-able primitives (caller
        holds ``self._lock``)."""

        def encode_rrs(r: ResourceRecordSet) -> dict:
            return {
                "name": r.name,
                "type": r.type,
                "ttl": r.ttl,
                "values": [rr.value for rr in r.resource_records],
                "alias": dict(vars(r.alias_target)) if r.alias_target else None,
            }

        return {
            "counter": self._counter.value,
            "accelerators": [
                {
                    "accelerator": dict(vars(state.accelerator)),
                    "tags": [[t.key, t.value] for t in state.tags],
                    "pending_describes": state.pending_describes,
                    "listeners": [
                        {
                            "listener_arn": listener.listener_arn,
                            "protocol": listener.protocol,
                            "client_affinity": listener.client_affinity,
                            "port_ranges": [
                                [p.from_port, p.to_port] for p in listener.port_ranges
                            ],
                        }
                        for listener in state.listeners.values()
                    ],
                }
                for state in self._accelerators.values()
            ],
            "endpoint_groups": [
                {
                    "endpoint_group_arn": eg.endpoint_group_arn,
                    "region": eg.endpoint_group_region,
                    "parent": self._eg_parent[arn],
                    "endpoints": [dict(vars(d)) for d in eg.endpoint_descriptions],
                }
                for arn, eg in self._endpoint_groups.items()
            ],
            "load_balancers": [dict(vars(lb)) for lb in self._load_balancers.values()],
            "zones": [dict(vars(z)) for z in self._zones.values()],
            "records": {
                zone_id: [encode_rrs(r) for r in table.values()]
                for zone_id, table in self._records.items()
            },
        }

    def _apply_state(self, data: dict) -> None:
        """Replace in-memory state with ``data`` (caller holds
        ``self._lock``).  The guarded dicts are mutated in place so the
        racecheck instrumentation survives the reload."""
        from .types import AliasTarget, ResourceRecord

        self._counter.value = max(self._counter.value, int(data.get("counter", 1)))
        self._accelerators.clear()
        self._listener_parent.clear()
        self._settling.clear()
        self._egs_by_listener.clear()
        self._accel_list_cache = None
        for entry in data.get("accelerators", []):
            accelerator = Accelerator(**entry["accelerator"])
            state = _AcceleratorState(
                accelerator,
                [Tag(k, v) for k, v in entry["tags"]],
                int(entry.get("pending_describes", 0)),
            )
            for ldata in entry.get("listeners", []):
                listener = Listener(
                    listener_arn=ldata["listener_arn"],
                    protocol=ldata["protocol"],
                    client_affinity=ldata["client_affinity"],
                    port_ranges=[PortRange(f, t) for f, t in ldata["port_ranges"]],
                )
                state.listeners[listener.listener_arn] = listener
                self._listener_parent[listener.listener_arn] = (
                    accelerator.accelerator_arn
                )
            self._accelerators[accelerator.accelerator_arn] = state
            if state.pending_describes > 0:
                self._settling[accelerator.accelerator_arn] = None
        self._endpoint_groups.clear()
        self._eg_parent.clear()
        for entry in data.get("endpoint_groups", []):
            eg = EndpointGroup(
                endpoint_group_arn=entry["endpoint_group_arn"],
                endpoint_group_region=entry["region"],
                endpoint_descriptions=[
                    EndpointDescription(**d) for d in entry.get("endpoints", [])
                ],
            )
            self._endpoint_groups[eg.endpoint_group_arn] = eg
            self._eg_parent[eg.endpoint_group_arn] = entry["parent"]
            self._egs_by_listener.setdefault(entry["parent"], {})[
                eg.endpoint_group_arn
            ] = None
        self._load_balancers.clear()
        for entry in data.get("load_balancers", []):
            lb = LoadBalancer(**entry)
            self._load_balancers[lb.load_balancer_name] = lb
        self._zones.clear()
        self._records.clear()
        for entry in data.get("zones", []):
            zone = HostedZone(**entry)
            self._zones[zone.id] = zone
            self._records[zone.id] = {}
        for zone_id, records in data.get("records", {}).items():
            table = self._records.setdefault(zone_id, {})
            for rdata in records:
                record = ResourceRecordSet(
                    name=rdata["name"],
                    type=rdata["type"],
                    ttl=rdata["ttl"],
                    resource_records=[ResourceRecord(v) for v in rdata["values"]],
                    alias_target=(
                        AliasTarget(**rdata["alias"]) if rdata["alias"] else None
                    ),
                )
                table[(record.name, record.type)] = record

    def snapshot_state(self) -> dict:
        """The full service state, JSON-able — the incident capture's
        AWS seed: a replay restores it verbatim before
        re-deriving the recorded call stream."""
        with self._lock:
            return self._encode()

    def restore_state(self, data: dict) -> None:
        """Replace all service state with a ``snapshot_state()`` dump."""
        with self._lock:
            self._apply_state(data)


class FileBackedFakeAWSBackend(FakeAWSBackend):
    """Durable fake AWS: committed state survives process death.

    Every mutating API call is flushed to a JSON state file (written
    atomically: tmp + ``os.replace``), and every API call first reloads
    the file if another process changed it — so a controller process
    killed mid-mutation leaves behind EXACTLY the AWS state its
    committed calls created, and the next generation (a restarted
    controller, a standby manager, or the asserting test) reads that
    ground truth.  This is what makes real kill-and-restart
    convergence drills possible with ``AGAC_CLOUD=fake``: without it,
    the in-memory "AWS" dies with the process and crash consistency is
    unfalsifiable.

    The persistence seam sits INSIDE the fault plan (see
    ``FakeAWSBackend.__getattribute__``): a ``fail_after_commit`` or
    ``crash(op, when="after-commit")`` fires only after the commit hit
    disk, matching a real backend's view of a dying client.

    Multi-writer safe: sharded deployments run several
    concurrently-live controller processes against one "account", so
    every mutating op holds an interprocess ``flock`` on a sidecar
    lock file across reload → apply → save.  The state file is then a
    serialized op log — a committed mutation can never be clobbered by
    a concurrent writer's stale whole-file write (the lost-update race
    the old single-writer design tolerated because the leader-failover
    drill killed the old leader before the standby mutated).  Reads
    stay lock-free: atomic replace means a reload always sees a
    complete snapshot, just possibly a stale one — exactly AWS's
    read-after-write consistency model."""

    _SEED_HELPERS = frozenset(
        {"add_load_balancer", "add_hosted_zone", "set_load_balancer_state"}
    )

    # read-path reload throttle: with several live writers
    # the state file changes constantly, so an unthrottled read path
    # re-parses the whole JSON on nearly every API call — at 4-8
    # sharded subprocesses on one box that parse cost was a measurable
    # slice of the scaling curve.  Reads may serve state up to this
    # many seconds stale (mutations still force-reload under the
    # flock), which is exactly the read-after-write consistency model
    # the class docstring documents.  The bound counts from the start
    # of the last COMPLETED reload: readers that arrive while another
    # thread reloads wait for it rather than serve the state before it.
    READ_RELOAD_INTERVAL = 0.05

    def __init__(self, state_path: str, **kwargs):
        super().__init__(**kwargs)
        self._state_path = str(state_path)
        self._state_stamp: Optional[tuple] = None
        self._state_serial = 0
        self._last_reload_check = -1.0
        # reads after this time must re-check the file (invalidate_reads)
        self._fresh_after = float("-inf")
        # interprocess mutation arbitration (see class docstring);
        # thread-local depth makes driver orchestrations that issue
        # several ops reentrancy-safe within one thread
        self._ipc_lock_path = f"{self._state_path}.lock"
        self._ipc_depth = threading.local()
        # port-only: seconds waited for the flock and held, registered
        # only where a file-backed fake is built
        self._lock_seconds = instruments.fake_aws_lock_seconds()
        self._persist_hook = self._persisted
        self._reload_if_changed()

    def _interprocess_write_lock(self):
        backend = self

        class _Held:
            def __enter__(self):
                depth = getattr(backend._ipc_depth, "value", 0)
                backend._ipc_depth.value = depth + 1
                if depth:
                    self._f = None
                    return self
                import fcntl

                self._f = open(backend._ipc_lock_path, "a+")
                self._asked = clockseam.monotonic()
                fcntl.flock(self._f, fcntl.LOCK_EX)
                self._acquired = clockseam.monotonic()
                return self

            def __exit__(self, *exc):
                backend._ipc_depth.value -= 1
                if self._f is not None:
                    import fcntl

                    fcntl.flock(self._f, fcntl.LOCK_UN)
                    released = clockseam.monotonic()
                    self._f.close()
                    backend._lock_observed(self._asked, self._acquired, released)

        return _Held()

    def _lock_observed(self, asked: float, acquired: float, released: float) -> None:
        """Observe one outermost hold of the flock, once it is released
        (so the observation adds nothing inside it): the seconds waited
        for it and the seconds held."""
        self._lock_seconds.labels(phase="wait").observe(acquired - asked)
        self._lock_seconds.labels(phase="held").observe(released - acquired)

    # -- the API-op seam (installed via _persist_hook) ------------------
    def _persisted(self, name: str, call):
        mutating = name.startswith(_MUTATING_PREFIXES)
        settling = name in _SETTLING_READS

        def synced(*args, **kwargs):
            if not mutating:
                self._reload_if_changed()
                if not (settling and self._settling):
                    return call(*args, **kwargs)
                # a read that counts toward a settle changes shared
                # state: counted in memory alone, the next reload of
                # another process's write would put the file's count
                # back, and with two writers nothing would settle.  So
                # it reloads, counts and saves under the flock
                with self._interprocess_write_lock():
                    self._reload_if_changed(force=True)
                    before = self._settle_counts()
                    result = call(*args, **kwargs)
                    if self._settle_counts() != before:
                        self._save()
                return result
            # serialize reload → apply → save across processes: the
            # state file becomes an op log, never a lost update.  The
            # reload is FORCED, not stamp-gated: stat stamps are not
            # collision-proof here (mtime granularity, size ties, and
            # immediate inode recycling under os.replace all observed
            # on container filesystems), and a skipped reload in the
            # write path clobbers the other process's committed ops.
            with self._interprocess_write_lock():
                self._reload_if_changed(force=True)
                result = call(*args, **kwargs)
                self._save()
            return result

        return synced

    def _settle_counts(self) -> tuple:
        """The describes each settling accelerator still waits for."""
        with self._lock:
            return tuple(
                (arn, self._accelerators[arn].pending_describes)
                for arn in self._settling if arn in self._accelerators
            )

    # -- test helpers stay coherent across processes too ----------------
    def add_load_balancer(self, *args, **kwargs):
        with self._interprocess_write_lock():
            self._reload_if_changed(force=True)
            lb = super().add_load_balancer(*args, **kwargs)
            self._save()
        return lb

    def add_hosted_zone(self, *args, **kwargs):
        with self._interprocess_write_lock():
            self._reload_if_changed(force=True)
            zone = super().add_hosted_zone(*args, **kwargs)
            self._save()
        return zone

    def set_load_balancer_state(self, *args, **kwargs):
        with self._interprocess_write_lock():
            self._reload_if_changed(force=True)
            super().set_load_balancer_state(*args, **kwargs)
            self._save()

    def list_accelerators(self, max_results, next_token):
        """ListAccelerators with a cursor for its token (the last ARN
        of the page, pages in ARN order) where the in-memory account
        uses an offset: with another process deleting accelerators
        between two pages of a drain, an offset skips the accelerator
        that moves across the page boundary, and the drain misses it."""
        with self._lock:
            everything, _ = super().list_accelerators(max(1, len(self._accelerators)), None)
        ordered = sorted(everything, key=lambda a: a.accelerator_arn)
        if next_token:
            ordered = [a for a in ordered if a.accelerator_arn > next_token]
        page = ordered[:max_results]
        return page, (page[-1].accelerator_arn if len(ordered) > max_results else None)

    def records_in_zone(self, zone_id):
        self._reload_if_changed()
        return super().records_in_zone(zone_id)

    def all_accelerator_arns(self):
        self._reload_if_changed()
        return super().all_accelerator_arns()

    def chain_counts(self):
        self._reload_if_changed()
        return super().chain_counts()

    def accelerator_owners(self):
        self._reload_if_changed()
        return super().accelerator_owners()

    def all_hosted_zone_ids(self):
        self._reload_if_changed()
        return super().all_hosted_zone_ids()

    def zone_id_by_name(self, name: str) -> Optional[str]:
        """Resolve a zone id by name — the assertion-side lookup a
        fresh process needs (zone IDS are minted by whichever process
        seeded first)."""
        if not name.endswith("."):
            name += "."
        self._reload_if_changed()
        with self._lock:
            for zone in self._zones.values():
                if zone.name == name:
                    return zone.id
        return None

    # -- the file ---------------------------------------------------------
    def _stat_stamp(self) -> Optional[tuple]:
        try:
            stat = os.stat(self._state_path)
        except FileNotFoundError:
            return None
        # st_ino is the collision breaker: every _save replaces the
        # file with a fresh inode, so two different states can never
        # share a stamp even when mtime_ns granularity and byte size
        # collide (the lost-update the sharded multi-writer drill
        # caught — two processes' saves a few hundred µs apart)
        return (stat.st_mtime_ns, stat.st_size, stat.st_ino)

    def _save(self) -> None:
        with self._lock:
            # the write serial leads the payload so a reader can skip
            # the full parse+apply when the file still holds ITS OWN
            # last-synced state (serials are strictly increasing under
            # the flock, so equal serial == identical content); compact
            # separators because the dump runs inside the interprocess
            # flock — every byte is serialized time across the fleet
            self._state_serial = getattr(self, "_state_serial", 0) + 1
            body = {"serial": self._state_serial}
            body.update(self._encode())
            payload = json.dumps(body, separators=(",", ":"))
        tmp = f"{self._state_path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            # no fsync: the crash model is process death (kill -9 —
            # the drills' SIGKILL), which never loses OS-buffered
            # writes; rename atomicity below is what guards torn
            # files.  fsync only protects against POWER loss, which
            # nothing here simulates, and it cost ~10% of the flock
            # critical section at fleet scale.
            f.write(payload)
        # atomic replace: a reader (or a process killed mid-save) can
        # never observe a torn file
        os.replace(tmp, self._state_path)
        self._state_stamp = self._stat_stamp()

    def _file_serial(self) -> Optional[int]:
        """The leading write serial of the state file, read without
        parsing the body (48 bytes cover {"serial":<20 digits>,)."""
        try:
            with open(self._state_path) as f:
                prefix = f.read(48)
        except OSError:
            return None
        if not prefix.startswith('{"serial":'):
            return None
        digits = prefix[len('{"serial":'):].split(",", 1)[0]
        try:
            return int(digits)
        except ValueError:
            return None

    def invalidate_reads(self) -> None:
        """The next read re-checks the file, whatever the throttle
        says: for a process that starts serving keys another process
        wrote (a shard adoption), every read after this call sees each
        write that other process committed before it."""
        self._fresh_after = clockseam.monotonic()

    def _reload_if_changed(self, force: bool = False) -> None:
        # reloads (stat, parse, apply) hold the state lock, one at a
        # time: a reader that arrives during one waits for it instead
        # of serving the state before it, and an older file's apply can
        # never land after a newer one's
        with self._lock:
            if not force:
                # read path: throttle the stat+parse to the documented
                # staleness window (mutations always force through this)
                now = clockseam.monotonic()
                checked = self._last_reload_check
                if (
                    checked >= self._fresh_after
                    and 0.0 <= now - checked < self.READ_RELOAD_INTERVAL
                ):
                    return
                self._last_reload_check = now
            stamp = self._stat_stamp()
            if stamp is None:
                return
            if stamp == self._state_stamp and not force:
                return
            # serial short-circuit: stat stamps are not
            # collision-proof (the forced mutation path exists because of
            # that), but the embedded write serial IS — it only advances
            # under the flock.  When the file still carries the serial this
            # process last wrote/loaded, the ~4 ms parse+apply is skipped;
            # with N concurrent writers that converts 1/N of every flock
            # critical section into a 48-byte read.
            serial = self._file_serial()
            if serial is not None and serial == getattr(self, "_state_serial", None):
                self._state_stamp = stamp
                return
            with open(self._state_path) as f:
                data = json.load(f)
            self._apply_state(data)
            self._state_serial = int(data.get("serial", 0) or 0)
            self._state_stamp = stamp
