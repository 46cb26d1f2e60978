"""Shared controller machinery: predicates, tombstone unwrapping,
worker pools, and the cloud-factory seam.

The predicates replicate the reference's event filters:
``wasLoadBalancerService`` (``pkg/controller/globalaccelerator/service.go:18-26``),
``wasALBIngress`` (``ingress.go:19-27``), ``hasManagedAnnotation`` /
``managedAnnotationChanged`` (``controller.go:250-259``) and the
Route53 hostname-annotation pair (``route53/controller.go:243-252``).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Optional

from .. import apis, clockseam, klog
from ..cloudprovider.aws import AWSDriver, get_lb_name_from_hostname
from ..cloudprovider.aws.health import CircuitOpenError
from ..cluster.informer import Tombstone
from ..cluster.objects import meta_namespace_key
from ..observability import journey as obs_journey
from ..observability import profile as obs_profile
from ..observability import slo as obs_slo
from ..reconcile import RateLimitingQueue, Result, process_next_work_item

# One driver per region; GA/Route53 are global services pinned to
# us-west-2 in the reference (``pkg/cloudprovider/aws/aws.go:26-32``).
CloudFactory = Callable[[str], AWSDriver]
GLOBAL_REGION = "us-west-2"


def default_cloud_factory(region: str) -> AWSDriver:
    """Placeholder until a process wires a real backend; controllers
    always accept an injected factory (the testability seam the
    reference lacks, SURVEY.md §7 stage 3)."""
    raise RuntimeError(
        "no cloud factory configured: pass cloud_factory= to the controller "
        "(e.g. one backed by FakeAWSBackend, or a real AWS backend)"
    )


# ---------------------------------------------------------------------------
# predicates
# ---------------------------------------------------------------------------


def was_load_balancer_service(svc) -> bool:
    if svc.spec.type != "LoadBalancer":
        return False
    return (
        apis.AWS_LOAD_BALANCER_TYPE_ANNOTATION in svc.metadata.annotations
        or svc.spec.load_balancer_class is not None
    )


def was_alb_ingress(ingress) -> bool:
    if ingress.spec.ingress_class_name == "alb":
        return True
    return apis.INGRESS_CLASS_ANNOTATION in ingress.metadata.annotations


def has_annotation(obj, annotation: str) -> bool:
    return annotation in obj.metadata.annotations


def annotation_changed(old, new, annotation: str) -> bool:
    return (annotation in old.metadata.annotations) != (
        annotation in new.metadata.annotations
    )


def stamp_journey_enqueued(
    controller: str, obj: Any, trigger: str = obs_journey.TRIGGER_SPEC
) -> None:
    """The journey plane's opening stamp, from a
    controller's enqueue path: keyed by the worker label the reconcile
    loop will later close under, carrying the spec generation so a
    newer edit restarts the latency clock."""
    obs_journey.tracker().observe_enqueued(
        controller,
        meta_namespace_key(obj),
        generation=getattr(obj.metadata, "generation", 0) or 0,
        trigger=trigger,
    )


def unwrap_tombstone(obj: Any) -> Optional[Any]:
    """Deletions observed via relist arrive as Tombstones carrying the
    last known state (``cache.DeletedFinalStateUnknown`` handling,
    reference ``globalaccelerator/controller.go:113-127``)."""
    if isinstance(obj, Tombstone):
        if obj.obj is None:
            klog.errorf("error decoding object tombstone for %s", obj.key)
            return None
        klog.v(4).infof("Recovered deleted object %r from tombstone", obj.key)
        return obj.obj
    return obj


# ---------------------------------------------------------------------------
# worker pool
# ---------------------------------------------------------------------------


# floor on circuit-aware requeues: the breaker's hint can be tiny at
# the open→half-open boundary, and a sub-second requeue would spin the
# queue against a service that is still down
CIRCUIT_RETRY_FLOOR = 1.0


def with_circuit_backoff(process):
    """Wrap a process func so an open circuit (API health plane) is a
    clean degraded-mode requeue at the breaker's retry hint instead of
    an anonymous rate-limited failure: the item keeps its backoff
    state, the queue stops feeding the dead service, and the retry
    lands right when the breaker will admit a probe."""

    def wrapped(arg):
        try:
            return process(arg)
        except CircuitOpenError as err:
            klog.warningf(
                "%s circuit is open; degraded mode, requeueing in %.1fs",
                err.service, max(err.retry_after, CIRCUIT_RETRY_FLOOR),
            )
            return Result(
                requeue=True,
                requeue_after=max(err.retry_after, CIRCUIT_RETRY_FLOOR),
                reason="circuit-open",
            )

    wrapped.__name__ = getattr(process, "__name__", "process")
    return wrapped


def with_shard_guard(shard_filter, process):
    """Wrap a process func with a pop-time ownership re-check:
    enqueue gates keep foreign keys out of the queue, but a key
    can re-home BETWEEN enqueue and pop — a live-resize drain, or a
    lease lost to a steal.  Working such residue would race the new
    owner's reconcile of the same key (the double-mutation the
    drain/handoff protocol exists to prevent), so the worker skips it:
    ``Result(skip=True)`` forgets the item without closing its journey
    and without any AWS call having run; the filter's ``on_skip`` hears
    of the key first (a process whose journeys are its own closes the
    key's there).  ``OWNS_ALL`` short-circuits,
    so single-shard mode pays nothing.

    The check alone cannot stop a reconcile already past it: the
    worker's key stays in the filter's ``inflight_keys`` for the whole
    process func, entered BEFORE the check (a membership tick that
    stops serving the key either sees the worker there or is seen by
    the check), and the membership hands a key to another replica only
    once no worker here is inside it."""
    if shard_filter is None or shard_filter.all_shards:
        return process

    def guarded(arg):
        with obs_profile.stage("shard-filter"):
            key = arg if isinstance(arg, str) else meta_namespace_key(arg)
            shard_filter.inflight_keys.append(key)
            owned = shard_filter.owns_key(key)
        try:
            if not owned:
                if shard_filter.on_skip is not None:
                    shard_filter.on_skip(key)
                return Result(skip=True, reason="not-owner")
            return process(arg)
        finally:
            shard_filter.inflight_keys.remove(key)

    guarded.__name__ = getattr(process, "__name__", "process")
    return guarded


def run_workers(
    name: str,
    queue: RateLimitingQueue,
    workers: int = 1,
    stop: threading.Event = None,
    key_to_obj=None,
    process_delete=None,
    process_create_or_update=None,
    on_sync_result=None,
    reconcile_deadline: float | None = None,
    managed=None,
) -> list[threading.Thread]:
    """Launch ``workers`` worker threads looping
    ``process_next_work_item`` until queue shutdown (the analog of
    ``wait.Until(runWorker, time.Second, stopCh)``,
    reference ``globalaccelerator/controller.go:206-211``).

    The keyword shape matches the controllers' ``worker_specs()``
    entries exactly: ``run_workers(workers=n, stop=stop, **spec)`` —
    the same spec a sim harness steps cooperatively.

    Both process funcs are wrapped circuit-aware (see
    ``with_circuit_backoff``), and ``reconcile_deadline`` arms the
    per-item deadline the driver's poll loops and backend retries
    consult (health plane; None/0 disables).

    ``managed`` (a predicate over the cached object) is part of the
    worker-spec shape for the explain plane's not-managed verdict; the
    worker loop itself never consults it."""
    del managed
    if not clockseam.threads_enabled():
        raise RuntimeError(
            "run_workers spawns worker threads; under the sim's "
            "cooperative executor step worker_specs() explicitly"
        )
    process_delete = with_circuit_backoff(process_delete)
    process_create_or_update = with_circuit_backoff(process_create_or_update)

    def loop():
        while process_next_work_item(
            queue, key_to_obj, process_delete, process_create_or_update,
            on_sync_result, reconcile_deadline=reconcile_deadline,
        ):
            if stop.is_set():
                break

    threads = []
    for i in range(workers):
        t = threading.Thread(target=loop, daemon=True, name=f"{name}-worker-{i}")
        t.start()
        threads.append(t)
    return threads


# ---------------------------------------------------------------------------
# drift resync (beats the reference: both this framework and the
# reference skip resync updates where old == new — the reference via
# reflect.DeepEqual, ``globalaccelerator/controller.go:100-102`` — so
# AWS-side drift someone causes out-of-band (accelerator disabled or
# deleted, records edited) is NEVER repaired until the Kubernetes
# object itself changes.  Opt-in: a ticker that re-enqueues every
# managed object so the 3-level drift ensure runs against AWS
# periodically.  Default off = exact reference behavior.)
# ---------------------------------------------------------------------------


def start_drift_resync(
    name: str,
    stop: threading.Event,
    period: float,
    sources: list,
) -> Optional[threading.Thread]:
    """Start a daemon ticker re-enqueueing managed objects every
    ``period`` seconds; ``sources`` is ``[(lister, predicate,
    enqueue), ...]``.  Returns None (and starts nothing) when period
    is 0 — the reference-parity default.  Cost when on: the level-
    triggered reconcile of a converged item, ~4 AWS reads with the
    discovery cache warm (docs/operations.md "Steady-state cost")."""
    if period <= 0:
        return None
    if not clockseam.threads_enabled():
        # same contract as period=0: returns None and starts nothing —
        # sims drive drift verification by stepping tickers themselves
        return None

    def loop():
        while not stop.wait(period):
            if obs_slo.should_shed("drift-resync"):
                # burn-rate shedding: sustained convergence
                # SLO burn defers drift verification — repair latency
                # degrades before user-facing convergence does
                klog.warningf(
                    "drift resync %s: shed under SLO budget burn", name
                )
                continue
            for lister, predicate, enqueue in sources:
                try:
                    for obj in lister.list():
                        if predicate(obj):
                            enqueue(obj)
                except Exception as err:  # a bad tick must not kill the ticker
                    klog.errorf("drift resync %s failed: %s", name, err)

    thread = threading.Thread(
        target=loop, daemon=True, name=f"{name}-drift-resync"
    )
    thread.start()
    return thread


# ---------------------------------------------------------------------------
# user-visible sync-failure surfacing (the reference
# only logs reconcile errors, so a permanently failing item is
# invisible to ``kubectl get events``)
# ---------------------------------------------------------------------------

# after this many consecutive reconcile FAILURES of the same item,
# start warning.  Calibration, against the PRODUCTION per-item backoff
# (controller_rate_limiter's ItemExponentialFailureRateLimiter: 5 ms
# base, factor 2 — the client-go default shape): the waits between
# failures 1..10 sum to 5 ms x (2^9 - 1) ~= 2.6 s, so the 10th failure
# means ~3 s of wall clock plus nine failed reconcile attempts —
# clearly not transient.  Tests tune the queue faster/slower; this
# constant is deliberately NOT derived from any queue config.
SYNC_WARNING_RETRY_THRESHOLD = 10

# failures further apart than this are not "the same incident": the
# consecutive-failure count restarts (matches the recorder's
# aggregation window)
SYNC_WARNING_FAILURE_WINDOW = 600.0

_SYNC_WARNING_MAX_TRACKED = 4096


def lb_name_region_or_warn(recorder, obj, hostname: str):
    """Parse ``(lb_name, region)`` from a status hostname, or emit a
    ``UnparseableLoadBalancerHostname`` Warning Event and return None:
    a malformed LB hostname is permanent for that status entry —
    retrying can't fix it (the reference requeues forever with no
    telemetry); a status update re-enqueues."""
    try:
        return get_lb_name_from_hostname(hostname)
    except ValueError as err:
        recorder.eventf(
            obj, "Warning", "UnparseableLoadBalancerHostname",
            "cannot derive load balancer from status hostname %s: %s",
            hostname, err,
        )
        klog.error(err)
        return None


def make_sync_error_warner(recorder, key_to_obj, threshold=SYNC_WARNING_RETRY_THRESHOLD):
    """Build an ``on_sync_result`` hook that emits Warning Events for
    unreconcilable items: permanent (NoRetry) errors warn immediately
    with reason ``SyncFailedPermanently``; retryable errors warn with
    ``SyncFailing`` once the item has failed ``threshold`` times in a
    row, then on every further retry — the recorder aggregates the
    stable message into one Event whose count keeps climbing, and its
    spam filter bounds the persistence rate.

    The warner counts actual failure invocations (a successful sync —
    ``err is None`` — resets the streak) rather than trusting
    ``queue.num_requeues``, which is also bumped by ordinary
    notification enqueues (both here and in the reference,
    ``AddRateLimited`` on every event — ``controller.go:182``) and
    would warn early for a frequently-updated object.  Failures more
    than ``SYNC_WARNING_FAILURE_WINDOW`` apart restart the count, so a
    key whose object disappears doesn't pin stale state."""
    lock = threading.Lock()
    failures: "OrderedDict[str, tuple[int, float]]" = OrderedDict()

    def warn(
        key: str, err: "Exception | None", requeues: int, permanent: bool
    ) -> None:
        if err is None or permanent:
            # success ends the streak; permanent errors don't count
            # toward one either (they warn on their own below)
            with lock:
                failures.pop(key, None)
            if err is None:
                return
        else:
            now = clockseam.monotonic()
            with lock:
                count, last = failures.get(key, (0, -SYNC_WARNING_FAILURE_WINDOW))
                count = count + 1 if now - last < SYNC_WARNING_FAILURE_WINDOW else 1
                failures[key] = (count, now)
                failures.move_to_end(key)
                while len(failures) > _SYNC_WARNING_MAX_TRACKED:
                    failures.popitem(last=False)
            if count < threshold:
                return
        try:
            obj = key_to_obj(key)
        except Exception:
            return  # object is gone — nothing to attach the Event to
        if permanent:
            recorder.eventf(
                obj, "Warning", "SyncFailedPermanently",
                "reconcile failed and will not be retried until the object changes: %s",
                err,
            )
        else:
            recorder.eventf(
                obj, "Warning", "SyncFailing",
                "reconcile keeps failing and is being retried with backoff: %s",
                err,
            )

    return warn
