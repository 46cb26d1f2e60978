"""Shared informers and listers.

The analog of client-go's SharedInformerFactory machinery the
reference builds in its manager (``pkg/manager/manager.go:52-53``,
30 s resync) and consumes in every controller: a local cache kept in
sync by list+watch, event handlers with add/update/delete callbacks,
tombstones for deletions observed only through a relist
(``cache.DeletedFinalStateUnknown`` handling, reference
``pkg/controller/globalaccelerator/controller.go:113-127``), and
lister views for cheap cache reads.

One informer per kind is shared by all controllers (the factory
deduplicates), and all handler callbacks for a kind are delivered from
a single dispatch thread, preserving client-go's ordering guarantee.
The periodic resync re-lists and re-delivers every object as an
update(obj, obj) — the level-trigger safety net (SURVEY.md §5).

Lister reads return the cached objects themselves under the read-only
contract (the reconcile kernel deep-copies before mutation,
``agac_tpu_torch/reconcile/reconcile.py``), matching the reference's
lister semantics.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from dataclasses import dataclass
from typing import Any, Callable, Optional

from .. import clockseam, klog
from ..analysis import racecheck
from ..errors import NotFoundError
from ..observability import instruments
from .client import ClusterClient
from .objects import meta_namespace_key


@dataclass
class Tombstone:
    """Final-state-unknown marker for deletions observed via relist,
    the ``cache.DeletedFinalStateUnknown`` analog: handlers receive
    this instead of the live object and must unwrap ``.obj``."""

    key: str
    obj: Any


@dataclass
class _Handler:
    on_add: Optional[Callable[[Any], None]] = None
    on_update: Optional[Callable[[Any, Any], None]] = None
    on_delete: Optional[Callable[[Any], None]] = None


class SharedInformer:
    def __init__(
        self,
        client: ClusterClient,
        kind: str,
        resync_period: float = 30.0,
        clock: Optional[Callable[[], float]] = None,
    ):
        self._client = client
        self.kind = kind
        self._resync_period = resync_period
        # the clock seam: resync deadlines and the
        # resync-age gauge run on virtual time under the sim runtime
        self._clock = clock or clockseam.monotonic
        # racecheck seam: instrumented when the lock-order watchdog is
        # enabled — the store lock is acquired from the watch, dispatch
        # and every controller thread (via lister reads)
        self._lock = racecheck.make_lock(f"informer.{kind}")
        self._store: dict[str, Any] = {}
        self._handlers: list[_Handler] = []
        self._synced = threading.Event()
        # deltas flow through one queue to one dispatch thread so
        # handlers never run concurrently for the same informer
        self._deltas: queue_mod.Queue = queue_mod.Queue()
        self._started = False
        # observability: resync lag + store size as
        # collection-time views, list/watch failures as a counter.
        # -1 until the first successful relist — "never synced" must
        # not read as "freshly synced".
        self._last_relist = -1.0
        informer_metrics = instruments.informer_instruments()
        informer_metrics.resync_age.labels(kind=kind).set_function(
            lambda: (
                -1.0
                if self._last_relist < 0
                else max(0.0, self._clock() - self._last_relist)
            )
        )
        informer_metrics.items.labels(kind=kind).set_function(
            lambda: len(self._store)
        )
        self._m_listwatch_errors = informer_metrics.listwatch_errors.labels(kind=kind)

    # ---- registration --------------------------------------------------
    def add_event_handler(
        self,
        on_add: Optional[Callable[[Any], None]] = None,
        on_update: Optional[Callable[[Any, Any], None]] = None,
        on_delete: Optional[Callable[[Any], None]] = None,
    ) -> None:
        handler = _Handler(on_add, on_update, on_delete)
        # enqueue the synthetic adds while still holding the lock:
        # store mutation, handler snapshot and delta enqueue must be
        # atomic or a concurrently applied watch event can reach the
        # new handler before its (staler) synthetic add
        with self._lock:
            self._handlers.append(handler)
            for obj in self._store.values():
                self._deltas.put(("add", None, obj, [handler]))

    def has_synced(self) -> bool:
        return self._synced.is_set()

    # ---- lister reads --------------------------------------------------
    def get_by_key(self, key: str) -> Any:
        with self._lock:
            obj = self._store.get(key)
        if obj is None:
            raise NotFoundError(self.kind, key)
        return obj

    def list_all(self, namespace: Optional[str] = None) -> list[Any]:
        with self._lock:
            return [
                o
                for o in self._store.values()
                if namespace is None or o.metadata.namespace == namespace
            ]

    def lister(self) -> "Lister":
        return Lister(self)

    # ---- run loops -----------------------------------------------------
    def run(self, stop: threading.Event) -> None:
        """Start the watch and dispatch threads; returns immediately."""
        if not clockseam.threads_enabled():
            raise RuntimeError(
                "SharedInformer.run spawns watch/dispatch threads; under "
                "the sim's cooperative executor drive the informer with "
                "explicit relist/dispatch steps instead"
            )
        with self._lock:
            if self._started:
                return
            self._started = True
        threading.Thread(
            target=self._dispatch_loop, args=(stop,), daemon=True, name=f"informer-dispatch-{self.kind}"
        ).start()
        threading.Thread(
            target=self._watch_loop, args=(stop,), daemon=True, name=f"informer-watch-{self.kind}"
        ).start()

    def _watch_loop(self, stop: threading.Event) -> None:
        while not stop.is_set():
            try:
                rv = self._relist()
                self._synced.set()
                self._record_arrival(rv, (), relist=True)
                deadline = self._clock() + self._resync_period
                should_stop = lambda: stop.is_set() or self._clock() >= deadline
                for event in self._client.watch(self.kind, rv, should_stop):
                    self._apply(event.type, event.obj)
                    self._record_arrival(rv, (event,))
            except Exception as err:
                self._m_listwatch_errors.inc()
                klog.errorf("informer %s: list/watch failed: %s", self.kind, err)
                stop.wait(1.0)

    def _record_arrival(self, cursor: str, events: tuple, relist: bool = False) -> None:
        """Incident capture: list/watch arrivals are THE
        external input of the live informer plane — record them at the
        wire boundary, before dispatch fans out.  (The sim's
        cooperative pump records its own batches; this path only runs
        in the threaded live loop.)"""
        try:
            from ..sim.capture import active

            tap = active()
            if tap is not None:
                tap.record_informer_batch(
                    "live", self.kind, list(events),
                    cursor=cursor, relist=relist, delivered=len(events),
                )
        except Exception:
            pass  # the tap must never fail the watch loop

    def _relist(self) -> str:
        objs, rv = self._client.list(self.kind)
        fresh = {meta_namespace_key(o): o for o in objs}
        with self._lock:
            old = self._store
            self._store = fresh
            handlers = list(self._handlers)
            for key, obj in fresh.items():
                if key in old:
                    # resync: re-deliver as update(old, new) even if
                    # equal — the level-trigger safety net
                    self._deltas.put(("update", old[key], obj, handlers))
                else:
                    self._deltas.put(("add", None, obj, handlers))
            for key, obj in old.items():
                if key not in fresh:
                    self._deltas.put(("delete", None, Tombstone(key, obj), handlers))
        self._last_relist = self._clock()
        return rv

    def _apply(self, event_type: str, obj: Any) -> None:
        key = meta_namespace_key(obj)
        with self._lock:
            old = self._store.get(key)
            if event_type == "DELETED":
                self._store.pop(key, None)
            else:
                self._store[key] = obj
            handlers = list(self._handlers)
            if event_type == "DELETED":
                self._deltas.put(("delete", None, obj, handlers))
            elif old is None:
                self._deltas.put(("add", None, obj, handlers))
            else:
                self._deltas.put(("update", old, obj, handlers))

    def _dispatch_loop(self, stop: threading.Event) -> None:
        while not stop.is_set():
            try:
                delta = self._deltas.get(timeout=0.05)
            except queue_mod.Empty:
                continue
            self._dispatch_one(delta)

    def _dispatch_one(self, delta) -> None:
        action, old, obj, handlers = delta
        for h in handlers:
            try:
                if action == "add" and h.on_add:
                    h.on_add(obj)
                elif action == "update" and h.on_update:
                    h.on_update(old, obj)
                elif action == "delete" and h.on_delete:
                    h.on_delete(obj)
            except Exception as err:  # handler crash containment
                klog.errorf("informer %s: handler error: %s", self.kind, err)

    # ---- cooperative stepping (the sim runtime's seam) --------
    # The threaded run() above is wall-clock plumbing around exactly
    # these three steps; the sim scheduler calls them explicitly so
    # relist timing, event application and handler dispatch all happen
    # at deterministic points in virtual time.

    def sync_once(self) -> str:
        """One relist + synchronous handler dispatch; marks the
        informer synced and returns the list's resourceVersion (the
        watch cursor the sim pump resumes from)."""
        rv = self._relist()
        self._synced.set()
        self.drain_pending_deltas()
        return rv

    def apply_event(self, event) -> None:
        """Apply one watch event to the store and enqueue its handler
        delta (drained by ``drain_pending_deltas``)."""
        self._apply(event.type, event.obj)

    def drain_pending_deltas(self) -> int:
        """Dispatch every queued delta inline on the calling thread;
        returns how many were delivered."""
        delivered = 0
        while True:
            try:
                delta = self._deltas.get_nowait()
            except queue_mod.Empty:
                return delivered
            self._dispatch_one(delta)
            delivered += 1


class Lister:
    """Cache-backed reads, the client-go lister analog:
    ``lister.namespaced(ns).get(name)`` / ``.list()``."""

    def __init__(self, informer: SharedInformer, namespace: Optional[str] = None):
        self._informer = informer
        self._namespace = namespace

    def namespaced(self, namespace: str) -> "Lister":
        return Lister(self._informer, namespace)

    def get(self, name: str) -> Any:
        key = f"{self._namespace}/{name}" if self._namespace else name
        return self._informer.get_by_key(key)

    def list(self) -> list[Any]:
        return self._informer.list_all(self._namespace)


class SharedInformerFactory:
    """Deduplicates informers per kind and starts them together
    (the analog of ``informers.NewSharedInformerFactory`` +
    ``factory.Start``, reference ``pkg/manager/manager.go:52-72``)."""

    def __init__(
        self,
        client: ClusterClient,
        resync_period: float = 30.0,
        clock: Optional[Callable[[], float]] = None,
        sleep: Optional[Callable[[float], None]] = None,
    ):
        self._client = client
        self._resync_period = resync_period
        # clock/sleep seam: threaded through to every
        # informer and used by wait_for_cache_sync's poll below — the
        # last hard-coded time.sleep that would stall virtual time
        self._clock = clock or clockseam.monotonic
        self._sleep = sleep or clockseam.sleep
        self._informers: dict[str, SharedInformer] = {}
        self._lock = racecheck.make_lock("informer-factory")

    def informer(self, kind: str) -> SharedInformer:
        with self._lock:
            if kind not in self._informers:
                self._informers[kind] = SharedInformer(
                    self._client, kind, self._resync_period, clock=self._clock
                )
            return self._informers[kind]

    def informers(self) -> list[SharedInformer]:
        """Every informer built so far — the sim harness's pump walks
        them in deterministic (construction) order."""
        with self._lock:
            return list(self._informers.values())

    def start(self, stop: threading.Event) -> None:
        with self._lock:
            informers = list(self._informers.values())
        for inf in informers:
            inf.run(stop)

    def wait_for_cache_sync(self, stop: threading.Event, timeout: float = 30.0) -> bool:
        """Block until every started informer has synced
        (``cache.WaitForCacheSync`` analog)."""
        deadline = self._clock() + timeout
        with self._lock:
            informers = list(self._informers.values())
        for inf in informers:
            while not inf.has_synced():
                if stop.is_set() or self._clock() > deadline:
                    return False
                self._sleep(0.005)
        return True
