"""The level-triggered reconcile loop.

Capability parity with the reference's ``pkg/reconcile/reconcile.go``:
``process_next_work_item`` pops one key from a rate-limited workqueue,
resolves it to an object through ``key_to_obj`` (a lister/cache read),
dispatches to the delete path when the object is gone
(``reconcile.go:62-63``) or to the create-or-update path with a deep
copy of the cached object (``reconcile.go:67``), then applies the retry
policy (``reconcile.go:70-89``):

- processing raised → rate-limited requeue, unless the exception chain
  contains a ``NoRetryError`` (``pkg/errors/errors.go:33-39``);
- ``Result.requeue_after > 0`` → forget (reset backoff) then re-add
  after the fixed delay;
- ``Result.requeue`` → rate-limited requeue;
- success → forget.

Instead of Go's ``(Result, error)`` pairs, process functions here
return a ``Result`` and signal errors by raising; ``NotFoundError``
from ``key_to_obj`` selects the delete path, mirroring apimachinery's
``IsNotFound`` dispatch.
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Any, Callable

from .. import clockseam, klog
from ..cloudprovider.aws import health as api_health
from ..errors import NoRetryError, NotFoundError, is_no_retry
from ..observability import explain, instruments, journey, profile, recorder, trace
from .pending import SettleWait
from .result import Result
from .workqueue import RateLimitingQueue


def _controller_name() -> str:
    """The controller a worker thread belongs to, from the
    ``{controller}-worker-{i}`` naming ``run_workers`` applies — the
    per-controller label the reconcile metrics and traces share.
    Non-pool threads (tests, direct drivers) label as themselves."""
    name = threading.current_thread().name
    return name.rsplit("-worker-", 1)[0]

KeyToObjFunc = Callable[[str], Any]
ProcessDeleteFunc = Callable[[str], Result]
ProcessCreateOrUpdateFunc = Callable[[Any], Result]

# ---------------------------------------------------------------------------
# sync-duration observers — a process-global metrics seam (the analog of
# controller-runtime's global metrics registry; the reference only LOGS
# the per-item duration via its v4 defer, ``reconcile.go:44-47``).
# Observers receive (key, seconds, error_or_None) after every completed
# sync pass, on the worker thread; ``threading.current_thread().name``
# carries the controller name (``run_workers`` names its threads
# ``{controller}-worker-{i}``) for per-controller breakdowns.  Observer
# exceptions are contained like hook exceptions.
# ---------------------------------------------------------------------------
SyncDurationObserver = Callable[[str, float, "Exception | None"], None]
_sync_duration_observers: list[SyncDurationObserver] = []


def add_sync_duration_observer(fn: SyncDurationObserver) -> None:
    _sync_duration_observers.append(fn)


def remove_sync_duration_observer(fn: SyncDurationObserver) -> None:
    try:
        _sync_duration_observers.remove(fn)
    except ValueError:
        pass


def _observe_sync_duration(key: str, seconds: float, err: "Exception | None") -> None:
    for fn in list(_sync_duration_observers):
        try:
            fn(key, seconds, err)
        except Exception as obs_err:
            klog.errorf("sync duration observer failed for %r: %s", key, obs_err)
# (key, error_or_None, num_requeues, permanent) — observability hook
# fired after the retry policy has been applied.  ``error`` is None on
# a successful sync (so streak-tracking hooks can reset); ``permanent``
# is True for NoRetry errors (the item will NOT be retried).
SyncResultFunc = Callable[[str, "Exception | None", int, bool], None]


def process_next_work_item(
    queue: RateLimitingQueue,
    key_to_obj: KeyToObjFunc,
    process_delete: ProcessDeleteFunc,
    process_create_or_update: ProcessCreateOrUpdateFunc,
    on_sync_result: SyncResultFunc | None = None,
    reconcile_deadline: float | None = None,
) -> bool:
    """Process one queue item; False only when the queue shut down.

    The analog of ``ProcessNextWorkItem`` (reference
    ``pkg/reconcile/reconcile.go:26-42``): errors from the handler are
    logged and swallowed so the worker loop keeps running (crash
    containment, the analog of ``utilruntime.HandleError``).

    ``on_sync_result`` (absent in the reference, which only logs)
    lets controllers surface failing items to users,
    e.g. as Warning Events; it observes, never alters, the retry
    policy, and its own exceptions are contained.

    Each item is bracketed by the API health plane's seams: the
    worker-heartbeat table records (thread, key, since) for the
    watchdog/``/healthz``, and ``reconcile_deadline`` (seconds, None/0
    disables) arms the per-worker deadline the driver's poll loops and
    the backend's retry backoffs consult — expiry surfaces as the
    retryable DeadlineExceeded instead of a wedged worker.
    """
    controller = _controller_name()
    # stage accountant: the pop is charged outside the
    # reconcile scope — its wall time is dominated by idle queue wait,
    # which would drown the per-item cpu/wall ratio; its CPU side is
    # the pop bookkeeping itself
    with profile.stage("queue-pop", controller=controller):
        item, shutdown = queue.get()
    if shutdown:
        return False
    heartbeats = api_health.worker_heartbeats()
    heartbeats.begin(item if isinstance(item, str) else repr(item))
    if reconcile_deadline:
        api_health.set_reconcile_deadline(reconcile_deadline)
    # observability plane: a sampled item gets a trace whose
    # spans (queue wait here; AWS calls and settle polls via the
    # driver hooks) ride a thread-local — unsampled items carry None
    # and every tracing call site degrades to a no-op
    tracer = trace.tracer()
    with profile.reconcile_scope(controller):
        item_trace = tracer.start(
            controller,
            item if isinstance(item, str) else repr(item),
            queue_wait=getattr(queue, "last_pop_wait", lambda: None)(),
        )
        try:
            with trace.activate(item_trace):
                _reconcile_handler(
                    item, queue, key_to_obj, process_delete,
                    process_create_or_update, on_sync_result,
                )
        except Exception as err:  # containment: a bad item must not kill the worker
            klog.errorf("unhandled error reconciling %r: %s", item, err)
        finally:
            with profile.stage("self-tax"):
                tracer.finish(item_trace)
                if item_trace is not None:
                    instruments.reconcile_instruments().traces_sampled.labels(
                        controller=item_trace.controller
                    ).inc()
            api_health.clear_reconcile_deadline()
            heartbeats.done()
            queue.done(item)
    return True


def _reconcile_handler(
    key: Any,
    queue: RateLimitingQueue,
    key_to_obj: KeyToObjFunc,
    process_delete: ProcessDeleteFunc,
    process_create_or_update: ProcessCreateOrUpdateFunc,
    on_sync_result: SyncResultFunc | None = None,
) -> None:
    if not isinstance(key, str):
        queue.forget(key)
        klog.errorf("expected string in workqueue but got %r", key)
        return
    controller = _controller_name()
    # the journey plane: stamp the attempt, and capture the
    # journey's id BEFORE the result branches below can close it — the
    # flight-recorder entry must carry the id either way, so a slow
    # convergence in /slo is one grep away from its recorded attempts
    with profile.stage("self-tax"):
        journeys = journey.tracker()
        journeys.attempt(controller, key)
        journey_id = journeys.journey_id(controller, key)
    start = clockseam.monotonic()
    try:
        with trace.span("sync"):
            res, err, was_delete = _dispatch(
                key, key_to_obj, process_delete, process_create_or_update
            )
    finally:
        elapsed = clockseam.monotonic() - start
        klog.v(4).infof("Finished syncing %r (%.3fs)", key, elapsed)
    if _sync_duration_observers:
        _observe_sync_duration(key, elapsed, err)

    with profile.stage("self-tax"):
        reconcile_metrics = instruments.reconcile_instruments()
        reconcile_metrics.duration.labels(controller=controller).observe(elapsed)

    if isinstance(err, SettleWait) and err.table is not None:
        # the async mutation pipeline: the handler reached an
        # AWS wait state — park the item in the pending-settle table
        # and free the worker; the poll-tick scheduler requeues it when
        # the wait resolves (or its deadline expires).  Parking is not
        # a failure: backoff state is untouched, and the sync-result
        # hook sees a clean pass so failure streaks reset.
        result = instruments.RESULT_PARKED
        reason = "parked-settle"
        with profile.stage("settle-park"):
            err.table.park(key, queue, err, controller=controller,
                           reason="parked-settle")
        journeys.stage(controller, key, journey.STAGE_PARKED,
                       reason="parked-settle")
        klog.v(2).infof("Parked %r: %s", key, err)
        _notify(on_sync_result, key, None, 0, False)
        err = None
    elif err is not None:
        permanent = is_no_retry(err)
        if permanent:
            result = instruments.RESULT_PERMANENT_ERROR
            reason = ""
            # the item will NOT be retried: its journey can never
            # converge, so drop it (the stage counter still shows it)
            journeys.drop(controller, key)
            klog.errorf("error syncing %r: %s", key, err)
        else:
            result = instruments.RESULT_ERROR
            # the explain code for WHY the retry waits:
            # circuit rejections and pacing-vs-deadline losses are
            # backpressure, not failures — each gets its own verdict
            if isinstance(err, api_health.CircuitOpenError):
                reason = "circuit-open"
                queue.add_rate_limited(key, reason="circuit-open")
            elif (isinstance(err, api_health.DeadlineExceeded)
                    and getattr(err, "paced", False)):
                reason = "quota-paced"
                queue.add_rate_limited(key, reason="quota-paced")
            else:
                reason = "backoff"
                queue.add_rate_limited(key, reason="backoff")
            journeys.stage(controller, key, journey.STAGE_REQUEUED,
                           reason=reason)
            klog.errorf("error syncing %r, and requeued: %s", key, err)
        if isinstance(err, api_health.DeadlineExceeded):
            reconcile_metrics.deadline_exceeded.labels(controller=controller).inc()
        _notify(on_sync_result, key, err, queue.num_requeues(key), permanent)
    elif res.skip:
        # shard-guard skip: the key re-homed to another
        # replica after it was enqueued here — drop the residue item
        # without touching its journey and without any AWS work having
        # run.  Where journeys are fleet-wide (the sim) the new owner's
        # resync opened or will close it; a process whose journeys are
        # its own closed its copy from the membership's release hook
        result = instruments.RESULT_SKIPPED
        reason = res.reason
        queue.forget(key)
        klog.v(4).infof("Skipped %r: owned by another replica's shards", key)
        _notify(on_sync_result, key, None, 0, False)
    elif res.requeue_after > 0:
        result = instruments.RESULT_REQUEUE_AFTER
        reason = res.reason
        queue.forget(key)
        queue.add_after(key, res.requeue_after, reason=res.reason)
        journeys.stage(controller, key, journey.STAGE_REQUEUED,
                       reason=res.reason)
        klog.infof("Successfully synced %r, but requeued after %.1fs", key, res.requeue_after)
        _notify(on_sync_result, key, None, 0, False)
    elif res.requeue:
        result = instruments.RESULT_REQUEUE
        reason = res.reason
        queue.add_rate_limited(key, reason=res.reason)
        journeys.stage(controller, key, journey.STAGE_REQUEUED,
                       reason=res.reason)
        klog.infof("Successfully synced %r, but requeued", key)
        _notify(on_sync_result, key, None, 0, False)
    else:
        result = instruments.RESULT_SUCCESS
        reason = ""
        queue.forget(key)
        # a clean terminal pass closes the journey: the object's spec
        # is verified converged (or its teardown finished) — this is
        # the observation the convergence-latency histogram measures
        if was_delete:
            journeys.deleted(controller, key)
        else:
            journeys.converged(controller, key)
        klog.infof("Successfully synced %r", key)
        _notify(on_sync_result, key, None, 0, False)

    with profile.stage("self-tax"):
        reconcile_metrics.results.labels(controller=controller, result=result).inc()
        active_trace = trace.current()
        if active_trace is not None:
            # a sampled trace answers "where did this reconcile's time
            # go" on its own: journey id for the /slo drill-down plus
            # the stage-CPU breakdown closed so far
            active_trace.annotate(
                result=result,
                error=str(err) if err is not None else None,
                journey=journey_id or "",
                stage_cpu_us=profile.current_scope().breakdown_us(),
            )
        recorder.flight_recorder().record(
            "reconcile",
            controller=controller,
            key=key,
            result=result,
            reason=reason,
            ring_epoch=explain.ring_epoch(),
            duration=round(elapsed, 4),
            error=str(err) if err is not None else "",
            journey=journey_id or "",
        )


def _notify(hook, key, err, requeues, permanent) -> None:
    if hook is None:
        return
    try:
        hook(key, err, requeues, permanent)
    except Exception as hook_err:
        klog.errorf("on_sync_result hook failed for %r: %s", key, hook_err)


def _dispatch(
    key: str,
    key_to_obj: KeyToObjFunc,
    process_delete: ProcessDeleteFunc,
    process_create_or_update: ProcessCreateOrUpdateFunc,
) -> tuple[Result, Exception | None, bool]:
    """(result, error, was_delete) — the delete-path flag lets the
    journey plane close a finished teardown as ``deleted`` rather than
    ``converged``."""
    try:
        with profile.stage("informer-lookup"):
            obj = key_to_obj(key)
    except NotFoundError:
        try:
            with profile.stage("driver-mutate"):
                return process_delete(key), None, True
        except Exception as err:
            return Result(), err, True
    except Exception as err:
        # A store read failing for any reason other than NotFound is
        # logged without a requeue in the reference
        # (``reconcile.go:64-65`` returns before the retry policy);
        # NoRetryError reproduces exactly that.
        return (
            Result(),
            NoRetryError(f"Unable to retrieve {key!r} from store: {err}"),
            False,
        )
    try:
        # DeepCopy before mutation: the cache/lister owns ``obj``
        # (reference ``pkg/reconcile/reconcile.go:67``).
        with profile.stage("serialize"):
            obj_copy = copy.deepcopy(obj)
        with profile.stage("driver-mutate"):
            return process_create_or_update(obj_copy), None, False
    except Exception as err:
        return Result(), err, False
