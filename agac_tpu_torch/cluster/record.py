"""Event recorder — user-facing observability.

The analog of client-go's ``record.EventRecorder`` that every
controller in the reference constructs (e.g.
``pkg/controller/globalaccelerator/controller.go:55-58``) and emits
through (``GlobalAcceleratorCreated``/``GlobalAcceleratorDeleted``
events, ``service.go:82,117``).  Events are both logged and persisted
as ``Event`` objects through the cluster client, so tests and
operators can list them.

Shaped like client-go's correlator + broadcaster stack:

- **aggregation** — a repeat of the same (object, type, reason,
  message) within the aggregation window bumps ``count`` and
  ``lastTimestamp`` on the existing Event instead of creating a new
  object, so a requeue-repair loop shows as one Event with count=N;
- **spam filter** — a token bucket per involved object (25 burst, one
  refill per 5 minutes, client-go's defaults) drops pathological
  floods before they are logged or persisted;
- **async persistence** — apiserver writes happen on the recorder's
  own worker thread behind a bounded queue (the broadcaster analog:
  buffered channel, drop-if-full), so an apiserver stall never blocks
  the reconcile workers emitting events.

Correlation state lives under a lock that is never held across I/O.
"""

from __future__ import annotations

import copy
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable

from .. import clockseam, klog
from .client import ClusterClient
from .objects import Event, EventSource, ObjectMeta, ObjectReference

AGGREGATION_WINDOW = 600.0  # seconds; client-go's 10-minute window
SPAM_BURST = 25.0
SPAM_REFILL_PER_SECOND = 1.0 / 300.0  # one event per object per 5 min sustained
MAX_CACHE_ENTRIES = 4096  # client-go's LRU cache size
QUEUE_CAPACITY = 1000  # pending persistence actions (broadcaster buffer)


def _iso(now: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(now))


class _Series:
    __slots__ = ("event", "created", "last_seen", "dirty")

    def __init__(self, event: Event, last_seen: float):
        self.event = event
        self.created = False  # persisted at least once
        self.last_seen = last_seen
        self.dirty = False  # queued for persistence


class EventRecorder:
    def __init__(
        self,
        client: ClusterClient,
        component: str,
        clock: Callable[[], float] | None = None,
        monotonic: Callable[[], float] | None = None,
        sleep: Callable[[float], None] | None = None,
        synchronous: bool | None = None,
    ):
        self._client = client
        self._component = component
        # clock seam: wall clock stamps the events, the
        # monotonic/sleep pair bounds flush() — all virtual under sim
        self._clock = clock or clockseam.time
        self._monotonic = monotonic or clockseam.monotonic
        self._sleep = sleep or clockseam.sleep
        # threadless mode (sim runtime): persist inline on the emitting
        # thread instead of a worker thread, so apiserver writes land
        # at deterministic points in the cooperative schedule
        self._synchronous = (
            synchronous
            if synchronous is not None
            else not clockseam.threads_enabled()
        )
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        # true LRU: touched entries move to the end, eviction pops the
        # front — an actively flooding object is never evicted into a
        # fresh full-burst bucket
        self._series: OrderedDict[tuple, _Series] = OrderedDict()
        self._buckets: OrderedDict[tuple, tuple[float, float]] = OrderedDict()
        self._queue: deque[tuple] = deque()
        self._worker: threading.Thread | None = None
        self._stopped = False
        self._inflight = 0
        self._last_name_suffix = 0

    # ------------------------------------------------------------------
    # correlation (fast, lock-held, no I/O)
    # ------------------------------------------------------------------
    def _spam_filtered(self, obj_key: tuple, now: float) -> bool:
        tokens, last = self._buckets.get(obj_key, (SPAM_BURST, now))
        tokens = min(SPAM_BURST, tokens + (now - last) * SPAM_REFILL_PER_SECOND)
        filtered = tokens < 1.0
        self._buckets[obj_key] = (tokens if filtered else tokens - 1.0, now)
        self._buckets.move_to_end(obj_key)
        while len(self._buckets) > MAX_CACHE_ENTRIES:
            self._buckets.popitem(last=False)
        return filtered

    def _next_name_suffix(self, now: float) -> int:
        """Nanosecond-scale name suffix derived from the seamed wall
        clock, bumped past the previous one so two events in the same
        (virtual) instant still get distinct names."""
        self._last_name_suffix = max(int(now * 1e9), self._last_name_suffix + 1)
        return self._last_name_suffix

    def event(self, obj: Any, event_type: str, reason: str, message: str) -> None:
        meta = obj.metadata
        kind = getattr(obj, "KIND", type(obj).__name__)
        now = self._clock()
        obj_key = (kind, meta.namespace, meta.name)
        series_key = obj_key + (event_type, reason, message)
        with self._lock:
            if self._spam_filtered(obj_key, now):
                klog.v(2).infof(
                    "event for %s/%s dropped by spam filter", meta.namespace, meta.name
                )
                return
            series = self._series.get(series_key)
            if series is not None and now - series.last_seen < AGGREGATION_WINDOW:
                series.event.count += 1
                series.event.last_timestamp = _iso(now)
                series.last_seen = now
            else:
                ev = Event(
                    metadata=ObjectMeta(
                        # unique across recorder instances and process
                        # restarts, like client-go's UnixNano suffix —
                        # read through the clock seam (plus a strictly
                        # increasing floor for same-instant events) so
                        # sim replays mint identical names
                        name=f"{meta.name}.{self._next_name_suffix(now):x}",
                        namespace=meta.namespace or "default",
                    ),
                    involved_object=ObjectReference(
                        kind=kind,
                        namespace=meta.namespace,
                        name=meta.name,
                        uid=meta.uid,
                    ),
                    reason=reason,
                    message=message,
                    type=event_type,
                    source=EventSource(component=self._component),
                    first_timestamp=_iso(now),
                    last_timestamp=_iso(now),
                )
                series = _Series(ev, now)
                self._series[series_key] = series
            self._series.move_to_end(series_key)
            while len(self._series) > MAX_CACHE_ENTRIES:
                self._series.popitem(last=False)
            if not series.dirty:
                if len(self._queue) >= QUEUE_CAPACITY:
                    klog.errorf(
                        "event queue full; dropping event %s for %s/%s",
                        reason, meta.namespace, meta.name,
                    )
                    return
                series.dirty = True
                self._queue.append(series_key)
            if not self._synchronous:
                self._ensure_worker()
                self._wake.notify()
        if self._synchronous:
            while self._drain_step():
                pass
        klog.infof(
            'Event(%s/%s %s): type=%r reason=%r %s',
            meta.namespace, meta.name, kind, event_type, reason, message,
        )

    def eventf(self, obj: Any, event_type: str, reason: str, fmt: str, *args) -> None:
        self.event(obj, event_type, reason, fmt % args if args else fmt)

    # ------------------------------------------------------------------
    # persistence worker (all I/O happens here, never under the lock)
    # ------------------------------------------------------------------
    def _ensure_worker(self) -> None:
        # under a disabled seam the recorder must never spawn, even if
        # it was constructed synchronous=False before a sim flipped the
        # seam: events stay queued for the next explicit flush().  (No
        # inline drain HERE — this runs under self._lock and
        # _drain_step re-acquires it.)
        if not clockseam.threads_enabled():
            return
        if self._worker is None or not self._worker.is_alive():
            self._stopped = False
            self._worker = threading.Thread(
                target=self._drain_loop, daemon=True, name=f"event-recorder-{self._component}"
            )
            self._worker.start()

    def _drain_loop(self) -> None:
        while True:
            with self._lock:
                while not self._queue and not self._stopped:
                    self._wake.wait()
                if not self._queue and self._stopped:
                    return
            self._drain_step()

    def _drain_step(self) -> bool:
        """Persist at most one queued series; False when the queue is
        empty.  Shared by the worker thread and synchronous mode."""
        with self._lock:
            if not self._queue:
                return False
            series_key = self._queue.popleft()
            series = self._series.get(series_key)
            if series is None:
                return True
            series.dirty = False
            self._inflight += 1
            # snapshot what we persist — a COPY taken under the
            # lock, because event() keeps mutating count and
            # last_timestamp on the live object; serializing the
            # live reference outside the lock could persist a torn
            # view (new count, stale lastTimestamp).  Later bumps
            # re-queue via the dirty flag.
            snapshot = copy.deepcopy(series.event)
            created = series.created
        try:
            if created:
                stored = self._client.update("Event", snapshot)
            else:
                stored = self._client.create("Event", snapshot)
        except Exception as err:
            klog.errorf("failed to record event %s: %s", snapshot.reason, err)
            with self._lock:
                self._inflight -= 1
                # stale/lost: the next occurrence starts fresh
                if self._series.get(series_key) is series:
                    del self._series[series_key]
            return True
        with self._lock:
            self._inflight -= 1
            if self._series.get(series_key) is series:
                series.created = True
                series.event.metadata.resource_version = (
                    stored.metadata.resource_version
                )
        return True

    def flush(self, timeout: float = 5.0) -> bool:
        """Block until every queued event has been persisted (tests
        and shutdown use this; reconcile paths never need to)."""
        deadline = self._monotonic() + timeout
        while self._monotonic() < deadline:
            with self._lock:
                if not self._queue and self._inflight == 0:
                    return True
            if self._synchronous:
                while self._drain_step():
                    pass
                continue
            self._sleep(0.002)
        with self._lock:
            return not self._queue and self._inflight == 0

    def shutdown(self, timeout: float = 2.0) -> None:
        """Drain pending events and stop the worker (controllers call
        this on their way out, like broadcaster.Shutdown())."""
        self.flush(timeout)
        with self._lock:
            self._stopped = True
            worker = self._worker
            self._wake.notify_all()
        if worker is not None:
            worker.join(timeout)
