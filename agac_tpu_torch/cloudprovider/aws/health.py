"""The AWS API health plane: per-service circuit breakers,
AIMD adaptive throttling, reconcile deadlines, and worker heartbeats.

The rest of the stack is built for *transient* faults — in-client
retries (``real_backend.py``), rate-limited requeues (``workqueue.py``)
— which only delay convergence.  Nothing adapts to *sustained*
degradation: a Route53 brownout makes every worker burn its 3 retries
per call, the fixed-rate queues keep feeding the dying service, and a
wedged settle poll holds a worker with no deadline.  This module adds
the sensing layer (Arcturus' stability argument: the control plane
must *measure* backend health and shed load):

- every backend call outcome is **classified** (success / throttle /
  5xx / connection error) into a rolling window per service;
- a **circuit breaker** per service key (``globalaccelerator``,
  ``route53``, ``elbv2[<region>]``) trips on sustained failure:
  closed → open (calls rejected with a retry hint) → half-open
  (single probe calls per interval) → closed on probe success;
- an **AIMD limiter** layered on the workqueue's token bucket
  multiplicatively cuts the effective call rate on throttle
  classifications and additively recovers on success — backpressure
  instead of retry storms;
- a **reconcile deadline** is carried per worker (threading.local,
  set by the reconcile loop) and consulted by settle polls, in-client
  retry backoffs and AIMD pacing waits; expiry raises the retryable
  ``DeadlineExceeded`` instead of wedging the worker;
- a **worker heartbeat table** records what every worker is
  reconciling and since when, so a watchdog (and the manager's
  ``/healthz``) can surface stuck workers, and shutdown can name the
  key a straggler thread is wedged on.

Everything takes an injectable clock so the unit tier drives state
transitions without wall time.  Wiring lives in ``factory.py`` (env
knobs + ``--api-health-*`` flags); controllers translate
``CircuitOpenError`` into a circuit-aware requeue
(``controllers/common.py``).
"""

from __future__ import annotations

import inspect
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

from ... import clockseam, klog
from ...observability import instruments
from ...observability.metrics import MetricsRegistry
from .api import ELBv2API, GlobalAcceleratorAPI, Route53API
from .errors import AWSAPIError

# ---------------------------------------------------------------------------
# outcome classification
# ---------------------------------------------------------------------------

OUTCOME_SUCCESS = "success"
OUTCOME_THROTTLE = "throttle"
OUTCOME_SERVER_ERROR = "server-error"
OUTCOME_CONNECTION_ERROR = "connection-error"

# Throttle-shaped service codes (the SDK's throttling taxonomy — the
# subset of real_backend.RETRYABLE_CODES that means "slow down", which
# is what the AIMD limiter reacts to).
THROTTLE_CODES = frozenset(
    {
        "Throttling",
        "ThrottlingException",
        "ThrottledException",
        "TooManyRequestsException",
        "RequestThrottled",
        "RequestThrottledException",
        "RequestLimitExceeded",
        "SlowDown",
        "PriorRequestNotComplete",
    }
)

# 5xx-shaped service codes: the service answered but is failing.
SERVER_ERROR_CODES = frozenset(
    {
        "ServiceUnavailable",
        "ServiceUnavailableException",
        "InternalFailure",
        "InternalServiceError",
        "InternalServiceErrorException",
        "InternalError",
        "TransientFailure",
        "RequestTimeout",
        "RequestTimeoutException",
    }
)

# real_backend raises this after exhausting attempts on pure
# connection errors (refused/reset/DNS) — the service never answered.
CONNECTION_CODES = frozenset({"RequestError"})

_FAILURE_OUTCOMES = frozenset(
    {OUTCOME_THROTTLE, OUTCOME_SERVER_ERROR, OUTCOME_CONNECTION_ERROR}
)


class DeadlineExceeded(AWSAPIError):
    """The reconcile deadline expired mid-operation.  Retryable on
    purpose (NOT a NoRetryError): the item is requeued with backoff and
    the next attempt gets a fresh deadline — the point is to free the
    worker, not to abandon the object."""

    def __init__(self, message: str = "", paced: bool = False):
        # paced=True: the deadline was consumed by ADAPTIVE PACING
        # (AIMD quota backpressure), not by a slow call — the explain
        # plane classifies that requeue as quota-paced, not backoff
        self.paced = paced
        super().__init__("DeadlineExceeded", message)


class CircuitOpenError(AWSAPIError):
    """A call was rejected without touching the wire because the
    service's circuit is open.  ``retry_after`` is the breaker's hint
    for when a probe might be allowed — controllers requeue with it
    instead of burning a rate-limited retry against a dead service."""

    def __init__(self, service: str, retry_after: float):
        self.service = service
        self.retry_after = retry_after
        super().__init__(
            "CircuitOpen",
            f"{service}: circuit open, retry in {retry_after:.1f}s",
        )


def classify_error(err: BaseException) -> Optional[str]:
    """Map a raised backend error onto a health outcome; None means
    neutral (client-side errors — deadlines, circuit rejections, code
    bugs — say nothing about the service's health)."""
    if isinstance(err, (DeadlineExceeded, CircuitOpenError)):
        return None
    if not isinstance(err, AWSAPIError):
        return None
    if err.code in THROTTLE_CODES:
        return OUTCOME_THROTTLE
    if err.code in SERVER_ERROR_CODES:
        return OUTCOME_SERVER_ERROR
    if err.code in CONNECTION_CODES:
        return OUTCOME_CONNECTION_ERROR
    # any other service error (NotFound, InvalidArgument, ...) is a
    # definite answer: the service is healthy enough to reject us
    return OUTCOME_SUCCESS


# ---------------------------------------------------------------------------
# reconcile deadlines (threading.local: one per worker thread)
# ---------------------------------------------------------------------------

_deadline_state = threading.local()


def set_reconcile_deadline(
    timeout: float, clock: Optional[Callable[[], float]] = None
) -> None:
    """Arm this worker's reconcile deadline ``timeout`` seconds from
    now; 0/negative clears it."""
    if timeout <= 0:
        clear_reconcile_deadline()
        return
    clock = clock or clockseam.monotonic
    _deadline_state.deadline = clock() + timeout
    _deadline_state.clock = clock


def clear_reconcile_deadline() -> None:
    _deadline_state.deadline = None
    _deadline_state.clock = None


def reconcile_deadline() -> Optional[float]:
    return getattr(_deadline_state, "deadline", None)


def deadline_remaining() -> Optional[float]:
    """Seconds until this worker's deadline, None when unarmed."""
    deadline = reconcile_deadline()
    if deadline is None:
        return None
    clock = getattr(_deadline_state, "clock", None) or clockseam.monotonic
    return deadline - clock()


def check_deadline(what: str) -> None:
    """Raise the retryable DeadlineExceeded once the worker's deadline
    has passed — the seam every poll/retry loop consults so a wedged
    backend frees the worker instead of holding it."""
    remaining = deadline_remaining()
    if remaining is not None and remaining <= 0:
        raise DeadlineExceeded(f"reconcile deadline expired during {what}")


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half-open"


class CircuitBreaker:
    """Rolling-window circuit breaker.

    Closed: every call allowed; outcomes land in a sliding window.
    When the window holds >= ``min_calls`` outcomes and the failure
    ratio reaches ``failure_ratio``, the circuit opens.  Open: calls
    rejected with a retry hint until ``open_duration`` elapses, then
    half-open: ``probe_budget`` probe calls are allowed per
    ``open_duration`` interval.  A probe success closes the circuit
    (window reset); a probe failure reopens it.
    """

    def __init__(
        self,
        window: float = 30.0,
        min_calls: int = 10,
        failure_ratio: float = 0.5,
        open_duration: float = 15.0,
        probe_budget: int = 1,
        clock: Optional[Callable[[], float]] = None,
    ):
        self._window = window
        self._min_calls = max(1, min_calls)
        self._failure_ratio = failure_ratio
        self._open_duration = open_duration
        self._probe_budget = max(1, probe_budget)
        self._clock = clock or clockseam.monotonic
        self._lock = threading.Lock()
        self._state = STATE_CLOSED
        # (time, failed), append-only in clock order; pruning pops
        # from the left so a busy window costs O(evictions), not a
        # full rebuild per call (a 7-day sim soak hot spot)
        self._outcomes: deque[tuple[float, bool]] = deque()
        self._opened_at = 0.0
        self._probes_left = 0
        self._probe_interval_start = 0.0
        self.opened_total = 0  # times the circuit tripped (observability)
        self.rejected_total = 0  # calls shed while open

    def _prune(self, now: float) -> None:
        cutoff = now - self._window
        while self._outcomes and self._outcomes[0][0] <= cutoff:
            self._outcomes.popleft()

    def state(self) -> str:
        with self._lock:
            return self._effective_state(self._clock())

    def _effective_state(self, now: float) -> str:
        if self._state == STATE_OPEN and now - self._opened_at >= self._open_duration:
            self._state = STATE_HALF_OPEN
            self._probes_left = self._probe_budget
            self._probe_interval_start = now
        return self._state

    def allow(self) -> tuple[bool, float]:
        """(allowed, retry_after).  retry_after is 0 when allowed."""
        with self._lock:
            now = self._clock()
            state = self._effective_state(now)
            if state == STATE_CLOSED:
                return True, 0.0
            if state == STATE_HALF_OPEN:
                if now - self._probe_interval_start >= self._open_duration:
                    # a new probe interval: refill the budget
                    self._probes_left = self._probe_budget
                    self._probe_interval_start = now
                if self._probes_left > 0:
                    self._probes_left -= 1
                    return True, 0.0
                self.rejected_total += 1
                return False, max(
                    self._probe_interval_start + self._open_duration - now, 0.05
                )
            self.rejected_total += 1
            return False, max(self._opened_at + self._open_duration - now, 0.05)

    def record(self, failed: bool) -> None:
        with self._lock:
            now = self._clock()
            state = self._effective_state(now)
            if state == STATE_HALF_OPEN:
                if failed:
                    self._trip(now)
                else:
                    # probe succeeded: close with a clean window
                    self._state = STATE_CLOSED
                    self._outcomes.clear()
                return
            if state == STATE_OPEN:
                # stragglers that were in flight when the circuit
                # tripped; they don't move the (already open) state
                return
            self._outcomes.append((now, failed))
            self._prune(now)
            if not failed or len(self._outcomes) < self._min_calls:
                return
            failures = sum(1 for _, f in self._outcomes if f)
            if failures / len(self._outcomes) >= self._failure_ratio:
                self._trip(now)

    def _trip(self, now: float) -> None:
        self._state = STATE_OPEN
        self._opened_at = now
        self._outcomes.clear()
        self.opened_total += 1

    def snapshot(self) -> dict:
        with self._lock:
            now = self._clock()
            state = self._effective_state(now)
            failures = sum(1 for _, f in self._outcomes if f)
            return {
                "state": state,
                "window_calls": len(self._outcomes),
                "window_failures": failures,
                "opened_total": self.opened_total,
                "rejected_total": self.rejected_total,
            }


# ---------------------------------------------------------------------------
# AIMD adaptive limiter
# ---------------------------------------------------------------------------


class AIMDLimiter:
    """Adaptive call pacing layered on the workqueue's token bucket.

    The bucket enforces whatever rate is current; AIMD moves the rate:
    a throttle classification multiplicatively cuts it
    (``rate *= decrease``, floored), a success additively restores it
    (``rate += increase``, capped at the configured ceiling).  The
    result converges to just under the service's real capacity instead
    of hammering a fixed rate through a brownout.
    """

    def __init__(
        self,
        qps: float = 20.0,
        floor: float = 0.5,
        ceiling: Optional[float] = None,
        increase: float = 0.2,
        decrease: float = 0.5,
        burst: Optional[int] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        # the existing token bucket (reconcile.workqueue) is the
        # enforcement layer; imported lazily to keep this package free
        # of a module-level reconcile dependency
        from ...reconcile.workqueue import BucketRateLimiter

        self._floor = max(floor, 0.01)
        self._ceiling = ceiling if ceiling is not None else qps
        self._increase = increase
        self._decrease = decrease
        self._rate = min(max(qps, self._floor), self._ceiling)
        self._bucket = BucketRateLimiter(
            self._rate, burst if burst is not None else max(1, int(qps)), clock=clock
        )
        self._lock = threading.Lock()

    def rate(self) -> float:
        with self._lock:
            return self._rate

    def ceiling(self) -> float:
        with self._lock:
            return self._ceiling

    def set_ceiling(self, ceiling: float) -> None:
        """Retune the additive-restore cap in place — the sharding
        plane's quota-division seam: a replica owning k of N
        shards runs each service at ``base_qps * k/N``, so the fleet's
        aggregate ceiling never exceeds the global budget.  A cut takes
        effect immediately (the live rate is clamped down); growth is
        earned back additively through successes, like any AIMD
        recovery."""
        with self._lock:
            self._ceiling = max(ceiling, self._floor)
            if self._rate > self._ceiling:
                self._rate = self._ceiling
                self._bucket.set_qps(self._rate)

    def on_throttle(self) -> None:
        with self._lock:
            self._rate = max(self._floor, self._rate * self._decrease)
            self._bucket.set_qps(self._rate)

    def on_success(self) -> None:
        with self._lock:
            if self._rate >= self._ceiling:
                return
            self._rate = min(self._ceiling, self._rate + self._increase)
            self._bucket.set_qps(self._rate)

    def reserve(self) -> float:
        """Take one token; returns how long the caller must pace
        before issuing its call (0 when under the current rate)."""
        return self._bucket.when(None)


# ---------------------------------------------------------------------------
# per-service health + the guarded API proxy
# ---------------------------------------------------------------------------


@dataclass
class HealthConfig:
    window: float = 30.0
    min_calls: int = 10
    failure_ratio: float = 0.5
    open_duration: float = 15.0
    probe_budget: int = 1
    # AIMD: 0 disables pacing (circuit breaking only)
    aimd_qps: float = 20.0
    aimd_floor: float = 0.5
    aimd_increase: float = 0.2
    aimd_decrease: float = 0.5
    # never pace a single call longer than this — past it the caller
    # is better off requeueing than holding a worker
    max_pace_wait: float = 5.0


class ServiceHealth:
    """One service's breaker + limiter + counters."""

    def __init__(
        self,
        name: str,
        config: HealthConfig,
        clock: Optional[Callable[[], float]] = None,
        sleep: Optional[Callable[[float], None]] = None,
        registry: Optional[MetricsRegistry] = None,
    ):
        self.name = name
        self._config = config
        self._sleep = sleep or clockseam.sleep
        self.breaker = CircuitBreaker(
            window=config.window,
            min_calls=config.min_calls,
            failure_ratio=config.failure_ratio,
            open_duration=config.open_duration,
            probe_budget=config.probe_budget,
            clock=clock,
        )
        self.limiter = (
            AIMDLimiter(
                qps=config.aimd_qps,
                floor=config.aimd_floor,
                increase=config.aimd_increase,
                decrease=config.aimd_decrease,
                clock=clock,
            )
            if config.aimd_qps > 0
            else None
        )
        # outcome counters and circuit/AIMD views live in the metrics
        # registry — the registry children ARE the counters,
        # so /metrics, snapshot() and bench_detail read one source
        # instead of a privately maintained dict.  ``registry=None``
        # keeps a private registry (test isolation); the factory wires
        # the process-global one.
        metrics = instruments.health_instruments(
            registry if registry is not None else MetricsRegistry()
        )
        self._outcome_counters = {
            outcome: metrics.outcomes.labels(service=name, outcome=outcome)
            for outcome in (
                OUTCOME_SUCCESS,
                OUTCOME_THROTTLE,
                OUTCOME_SERVER_ERROR,
                OUTCOME_CONNECTION_ERROR,
            )
        }
        metrics.watch_service(self)

    def is_open(self) -> bool:
        return self.breaker.state() != STATE_CLOSED

    def before_call(self) -> None:
        """The pre-call gate: circuit check, then AIMD pacing (bounded
        by the worker's reconcile deadline)."""
        allowed, retry_after = self.breaker.allow()
        if not allowed:
            raise CircuitOpenError(self.name, retry_after)
        if self.limiter is None:
            return
        delay = min(self.limiter.reserve(), self._config.max_pace_wait)
        if delay <= 0:
            return
        remaining = deadline_remaining()
        if remaining is not None and remaining <= delay:
            raise DeadlineExceeded(
                f"{self.name}: {delay:.2f}s of adaptive pacing exceeds the "
                f"{remaining:.2f}s left on the reconcile deadline",
                paced=True,
            )
        self._sleep(delay)

    def record(self, outcome: Optional[str]) -> None:
        if outcome is None:
            return
        counter = self._outcome_counters.get(outcome)
        if counter is not None:
            counter.inc()
        self.breaker.record(outcome in _FAILURE_OUTCOMES)
        if self.limiter is not None:
            if outcome == OUTCOME_THROTTLE:
                self.limiter.on_throttle()
            elif outcome == OUTCOME_SUCCESS:
                self.limiter.on_success()

    def record_error(self, err: BaseException) -> None:
        self.record(classify_error(err))

    def snapshot(self) -> dict:
        # rendered FROM the registry children — /healthz, /readyz and
        # /metrics can never disagree about these counts
        counters = {
            outcome: int(counter.value())
            for outcome, counter in self._outcome_counters.items()
        }
        snap = {"circuit": self.breaker.snapshot(), "outcomes": counters}
        if self.limiter is not None:
            snap["aimd_rate"] = round(self.limiter.rate(), 3)
            snap["aimd_ceiling"] = round(self.limiter.ceiling(), 3)
        return snap

    def set_quota_fraction(self, fraction: float) -> None:
        """Scale this service's AIMD ceiling to a slice of the global
        budget (sharding quota division).  Clamped at the limiter's
        floor — a replica owning zero shards idles at floor qps, which
        is why the fleet-aggregate bound is stated over shard OWNERS
        (docs/operations.md "Horizontal sharding")."""
        if self.limiter is not None:
            self.limiter.set_ceiling(self._config.aimd_qps * fraction)


def _api_op_names(*interfaces) -> frozenset[str]:
    return frozenset(
        name
        for cls in interfaces
        for name, member in vars(cls).items()
        if inspect.isfunction(member) and not name.startswith("_")
    )


GA_OPS = _api_op_names(GlobalAcceleratorAPI)
ELBV2_OPS = _api_op_names(ELBv2API)
ROUTE53_OPS = _api_op_names(Route53API)
ALL_OPS = GA_OPS | ELBV2_OPS | ROUTE53_OPS


class HealthGuardedAPI:
    """Proxy one service handle through a ServiceHealth: the breaker
    gates every call, the AIMD limiter paces it, and the outcome is
    classified and recorded.  Non-API attributes pass through, so a
    guarded FakeAWSBackend keeps its test helpers."""

    def __init__(self, inner, health: ServiceHealth, ops: frozenset[str] = ALL_OPS):
        self._inner = inner
        self._health = health
        self._ops = ops

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name not in self._ops or not callable(attr):
            return attr
        health = self._health

        def guarded(*args, **kwargs):
            health.before_call()
            try:
                result = attr(*args, **kwargs)
            except Exception as err:
                health.record_error(err)
                raise
            health.record(OUTCOME_SUCCESS)
            return result

        return guarded


class HealthTracker:
    """Registry of per-service health.  Keys: ``globalaccelerator``,
    ``route53`` (global endpoints, like the drivers treat them) and
    ``elbv2[<region>]`` (regional); ``base_name`` matching strips the
    ``[...]`` suffix so callers can ask about "elbv2" as a whole."""

    def __init__(
        self,
        config: Optional[HealthConfig] = None,
        clock: Optional[Callable[[], float]] = None,
        sleep: Optional[Callable[[float], None]] = None,
        registry: Optional[MetricsRegistry] = None,
    ):
        self.config = config or HealthConfig()
        self._clock = clock or clockseam.monotonic
        self._sleep = sleep or clockseam.sleep
        # one registry for every service's counters/gauges; private by
        # default (tests build many trackers per process), the factory
        # passes the process-global registry so /metrics carries them
        self.registry = registry if registry is not None else MetricsRegistry()
        self._lock = threading.Lock()
        self._services: dict[str, ServiceHealth] = {}
        # the sharding plane's budget slice: 1.0 = the whole
        # global budget (single-process semantics); a sharded replica
        # runs at owned/shard_count, rebalanced on every membership
        # change — services created later inherit the current fraction
        self._quota_fraction = 1.0

    def service(self, name: str) -> ServiceHealth:
        with self._lock:
            health = self._services.get(name)
            fraction = self._quota_fraction
            if health is None:
                health = self._services[name] = ServiceHealth(
                    name, self.config, clock=self._clock, sleep=self._sleep,
                    registry=self.registry,
                )
                if fraction != 1.0:
                    health.set_quota_fraction(fraction)
            return health

    def set_quota_fraction(self, fraction: float) -> None:
        """Divide the configured AIMD budget: every service ceiling
        becomes ``aimd_qps * fraction``, now and for services created
        later.  The shard membership's on-change hook drives this, so
        budget follows lease ownership."""
        with self._lock:
            self._quota_fraction = max(0.0, min(1.0, fraction))
            services = list(self._services.values())
            fraction = self._quota_fraction
        for service_health in services:
            service_health.set_quota_fraction(fraction)

    def quota_fraction(self) -> float:
        with self._lock:
            return self._quota_fraction

    def guard(self, inner, name: str, ops: frozenset[str] = ALL_OPS):
        return HealthGuardedAPI(inner, self.service(name), ops)

    @staticmethod
    def _base(name: str) -> str:
        return name.split("[", 1)[0]

    def is_open(self, base_name: str) -> bool:
        with self._lock:
            services = list(self._services.values())
        return any(
            s.name == base_name or self._base(s.name) == base_name
            for s in services
            if s.is_open()
        )

    def open_services(self) -> list[str]:
        with self._lock:
            services = list(self._services.values())
        return sorted(s.name for s in services if s.is_open())

    def snapshot(self) -> dict:
        with self._lock:
            services = dict(self._services)
        return {name: health.snapshot() for name, health in sorted(services.items())}


# ---------------------------------------------------------------------------
# worker heartbeats + watchdog
# ---------------------------------------------------------------------------


class WorkerHeartbeats:
    """What every worker thread is reconciling and since when — the
    liveness table behind the stuck-worker watchdog, the manager's
    ``/healthz``, and shutdown's who-wedged-on-what logging."""

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._clock = clock or clockseam.monotonic
        self._lock = threading.Lock()
        self._table: dict[str, tuple[str, float]] = {}  # thread -> (key, since)

    def begin(self, key: str) -> None:
        with self._lock:
            self._table[threading.current_thread().name] = (key, self._clock())

    def done(self) -> None:
        with self._lock:
            self._table.pop(threading.current_thread().name, None)

    def current_key(self, thread_name: str) -> Optional[str]:
        with self._lock:
            entry = self._table.get(thread_name)
            return entry[0] if entry else None

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            now = self._clock()
            return {
                thread: {"key": key, "age": round(now - since, 3)}
                for thread, (key, since) in sorted(self._table.items())
            }

    def stuck(self, threshold: float) -> list[tuple[str, str, float]]:
        """(thread, key, age) for workers on one item longer than
        ``threshold`` seconds."""
        with self._lock:
            now = self._clock()
            return [
                (thread, key, now - since)
                for thread, (key, since) in sorted(self._table.items())
                if now - since >= threshold
            ]


_heartbeats = WorkerHeartbeats()


def worker_heartbeats() -> WorkerHeartbeats:
    """The process-wide heartbeat table (one reconcile loop per
    process; tests build their own WorkerHeartbeats)."""
    return _heartbeats


def start_worker_watchdog(
    stop: threading.Event,
    heartbeats: Optional[WorkerHeartbeats] = None,
    interval: float = 30.0,
    threshold: float = 300.0,
) -> Optional[threading.Thread]:
    """Daemon that periodically surfaces workers stuck on one item
    past ``threshold`` seconds (a wedged settle poll, a hung call):
    the log line names the worker and the reconcile key so the wedge
    is diagnosable while it is happening, not from a post-mortem.

    Under the sim's cooperative executor (``threads_enabled()`` false)
    this starts nothing and returns None — the sim owns every
    interleaving, and a wild watchdog thread would race virtual time."""
    if not clockseam.threads_enabled():
        return None
    table = heartbeats or worker_heartbeats()

    def loop():
        while not stop.wait(interval):
            for thread, key, age in table.stuck(threshold):
                klog.warningf(
                    "worker %s stuck reconciling %r for %.0fs (threshold %.0fs)",
                    thread, key, age, threshold,
                )

    thread = threading.Thread(target=loop, daemon=True, name="worker-watchdog")
    thread.start()
    return thread
