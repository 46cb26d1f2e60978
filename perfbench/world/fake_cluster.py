"""A frozen copy of the port's in-memory apiserver, ``cluster/fake.py``.

The benchmark owns the API server its in-process deployments act on, so
a later change to the program cannot change it.  Copied as it stood when
the benchmark was written; only the imports differ.

The test double the reference gets from its generated fake clientset
(``pkg/client/clientset/versioned/fake/clientset_generated.go:37``) and
kind clusters, but covering the full surface the framework needs:
typed CRUD with optimistic concurrency, finalizer-aware deletion,
generation/resourceVersion bookkeeping, and replayable watch streams —
enough to run whole controllers against it (SURVEY.md §7 stage 4's
"fake apiserver").

Apiserver behaviors reproduced because controllers depend on them:

- ``delete`` of an object with finalizers only sets
  ``metadata.deletionTimestamp`` (MODIFIED event); the object is
  removed once an ``update`` clears the last finalizer — the
  EndpointGroupBinding lifecycle (reference
  ``pkg/controller/endpointgroupbinding/reconcile.go:36-64``).
- ``metadata.generation`` increments only on spec changes;
  ``update_status`` never bumps it (ObservedGeneration bookkeeping,
  reference ``reconcile.go:89,157,208``).
- updates with a stale ``resourceVersion`` raise ``ConflictError``
  (leader-election lease races).
- ``watch`` replays history after the given resourceVersion, then
  streams live events.
"""

from __future__ import annotations

import bisect
import copy
import datetime
import queue as queue_mod
import threading
import uuid
from typing import Any, Callable, Iterator, Optional

from agac_tpu_torch.errors import AlreadyExistsError, ConflictError, NotFoundError
from agac_tpu_torch.cluster.client import ClusterClient, WatchEvent
from agac_tpu_torch.cluster.objects import meta_namespace_key

_HISTORY_LIMIT = 4096


def _now() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


class FakeCluster(ClusterClient):
    def __init__(self):
        self._lock = threading.Lock()
        self._store: dict[str, dict[str, Any]] = {}
        self._rv = 0
        self._history: dict[str, list[tuple[int, WatchEvent]]] = {}
        self._watchers: dict[str, list[queue_mod.Queue]] = {}
        # per-kind high-water mark of trimmed history: events at or
        # below this rv are no longer replayable (the "410 Gone" line
        # events_since reports so pollers know to relist)
        self._trimmed_rv: dict[str, int] = {}

    # ---- internals ----------------------------------------------------
    def _bump(self) -> int:
        self._rv += 1
        return self._rv

    def _kind_store(self, kind: str) -> dict[str, Any]:
        return self._store.setdefault(kind, {})

    def _broadcast(self, kind: str, event_type: str, obj: Any, rv: int) -> None:
        event = WatchEvent(event_type, copy.deepcopy(obj))
        history = self._history.setdefault(kind, [])
        history.append((rv, event))
        if len(history) > _HISTORY_LIMIT:
            trim = len(history) - _HISTORY_LIMIT
            self._trimmed_rv[kind] = history[trim - 1][0]
            del history[:trim]
        for q in self._watchers.get(kind, []):
            q.put((rv, event))

    # ---- ClusterClient -------------------------------------------------
    def get(self, kind: str, namespace: str, name: str) -> Any:
        key = f"{namespace}/{name}" if namespace else name
        with self._lock:
            obj = self._kind_store(kind).get(key)
            if obj is None:
                raise NotFoundError(kind, key)
            return copy.deepcopy(obj)

    def list(self, kind: str, namespace: Optional[str] = None) -> tuple[list[Any], str]:
        with self._lock:
            objs = [
                copy.deepcopy(o)
                for o in self._kind_store(kind).values()
                if namespace is None or o.metadata.namespace == namespace
            ]
            return objs, str(self._rv)

    def create(self, kind: str, obj: Any) -> Any:
        obj = copy.deepcopy(obj)
        key = meta_namespace_key(obj)
        with self._lock:
            store = self._kind_store(kind)
            if key in store:
                raise AlreadyExistsError(f"{kind} {key!r} already exists")
            rv = self._bump()
            obj.metadata.uid = obj.metadata.uid or str(uuid.uuid4())
            obj.metadata.resource_version = str(rv)
            obj.metadata.creation_timestamp = obj.metadata.creation_timestamp or _now()
            if hasattr(obj, "spec"):
                obj.metadata.generation = 1
            store[key] = obj
            self._broadcast(kind, "ADDED", obj, rv)
            return copy.deepcopy(obj)

    def update(self, kind: str, obj: Any) -> Any:
        obj = copy.deepcopy(obj)
        key = meta_namespace_key(obj)
        with self._lock:
            store = self._kind_store(kind)
            current = store.get(key)
            if current is None:
                raise NotFoundError(kind, key)
            if (
                obj.metadata.resource_version
                and obj.metadata.resource_version != current.metadata.resource_version
            ):
                raise ConflictError(
                    f"{kind} {key!r}: resourceVersion {obj.metadata.resource_version} "
                    f"is stale (current {current.metadata.resource_version})"
                )
            # status is a subresource: a plain update cannot change it
            if hasattr(current, "status"):
                obj.status = copy.deepcopy(current.status)
            rv = self._bump()
            if hasattr(obj, "spec") and obj.spec != current.spec:
                obj.metadata.generation = current.metadata.generation + 1
            else:
                obj.metadata.generation = current.metadata.generation
            obj.metadata.resource_version = str(rv)
            obj.metadata.uid = current.metadata.uid
            obj.metadata.creation_timestamp = current.metadata.creation_timestamp
            if current.metadata.deletion_timestamp:
                obj.metadata.deletion_timestamp = current.metadata.deletion_timestamp
            if obj.metadata.deletion_timestamp and not obj.metadata.finalizers:
                del store[key]
                self._broadcast(kind, "DELETED", obj, rv)
            else:
                store[key] = obj
                self._broadcast(kind, "MODIFIED", obj, rv)
            return copy.deepcopy(obj)

    def update_status(self, kind: str, obj: Any) -> Any:
        key = meta_namespace_key(obj)
        with self._lock:
            store = self._kind_store(kind)
            current = store.get(key)
            if current is None:
                raise NotFoundError(kind, key)
            if (
                obj.metadata.resource_version
                and obj.metadata.resource_version != current.metadata.resource_version
            ):
                raise ConflictError(f"{kind} {key!r}: resourceVersion is stale")
            updated = copy.deepcopy(current)
            updated.status = copy.deepcopy(obj.status)
            rv = self._bump()
            updated.metadata.resource_version = str(rv)
            store[key] = updated
            self._broadcast(kind, "MODIFIED", updated, rv)
            return copy.deepcopy(updated)

    def delete(self, kind: str, namespace: str, name: str) -> None:
        key = f"{namespace}/{name}" if namespace else name
        with self._lock:
            store = self._kind_store(kind)
            obj = store.get(key)
            if obj is None:
                raise NotFoundError(kind, key)
            rv = self._bump()
            obj.metadata.resource_version = str(rv)
            if obj.metadata.finalizers:
                obj.metadata.deletion_timestamp = _now()
                self._broadcast(kind, "MODIFIED", obj, rv)
            else:
                del store[key]
                self._broadcast(kind, "DELETED", obj, rv)

    # ---- incident capture & replay -------------------------
    def snapshot(self) -> tuple[list[tuple[str, Any]], int]:
        """Point-in-time copy of the store for a capture header:
        ``(kind, object)`` pairs ordered by resourceVersion (so a
        restore re-seeds in creation order) plus the rv counter."""
        with self._lock:
            objects = [
                (kind, copy.deepcopy(obj))
                for kind, store in self._store.items()
                for obj in store.values()
            ]
            objects.sort(key=lambda item: int(item[1].metadata.resource_version or 0))
            return objects, self._rv

    def restore(self, objects: list[tuple[str, Any]], resource_version: int) -> None:
        """Seed this (fresh) cluster from a capture-header snapshot:
        objects land verbatim — same uid/rv/generation, NO watch events
        — and the rv counter resumes where the recording's stood, so a
        replayed run mints the same resourceVersion stream the live
        run did."""
        with self._lock:
            for kind, obj in objects:
                key = meta_namespace_key(obj)
                self._kind_store(kind)[key] = copy.deepcopy(obj)
            self._rv = max(self._rv, int(resource_version))

    def events_since(
        self, kind: str, resource_version: str
    ) -> tuple[Optional[list[WatchEvent]], str]:
        """Non-blocking watch cursor (the sim runtime's pump):
        every event of ``kind`` after ``resource_version``, plus the
        new cursor to resume from.  Returns ``(None, cursor)`` when the
        requested window has been trimmed out of history — the
        apiserver's "410 Gone": the caller must relist (the sim pump
        calls the informer's ``sync_once``) instead of silently missing
        deltas."""
        with self._lock:
            since = int(resource_version or 0)
            if since < self._trimmed_rv.get(kind, 0):
                return None, str(self._rv)
            history = self._history.get(kind, [])
            # rvs are strictly increasing, so the cursor seek is a
            # bisect, not a scan — the pump calls this per informer per
            # round, and an O(history) scan each time was a measurable
            # slice of the 7-day sim soak's wall clock
            start = bisect.bisect_right(history, since, key=lambda item: item[0])
            events = [ev for _, ev in history[start:]]
            return events, str(self._rv)

    def watch(
        self, kind: str, resource_version: str, stop: Callable[[], bool]
    ) -> Iterator[WatchEvent]:
        q: queue_mod.Queue = queue_mod.Queue()
        with self._lock:
            since = int(resource_version or 0)
            backlog = [
                (rv, ev) for rv, ev in self._history.get(kind, []) if rv > since
            ]
            self._watchers.setdefault(kind, []).append(q)
        delivered = since
        try:
            for rv, ev in backlog:
                if stop():
                    return
                delivered = rv
                yield ev
            while not stop():
                try:
                    rv, ev = q.get(timeout=0.05)
                except queue_mod.Empty:
                    continue
                if rv <= delivered:  # already replayed from backlog
                    continue
                delivered = rv
                yield ev
        finally:
            with self._lock:
                watchers = self._watchers.get(kind, [])
                if q in watchers:
                    watchers.remove(q)
