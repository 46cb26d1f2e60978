"""The cluster client interface.

The seam between controllers and the apiserver — implemented by the
in-memory ``FakeCluster`` (tests, local e2e) and the REST client
(real clusters).  The reference talks to kube-apiserver through
client-go's clientset + the generated CRD clientset (SURVEY.md §2
rows 4, 17); this interface is the union of the operations the
framework actually uses: typed CRUD, status updates, list+watch for
informers, and event creation for the recorder.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional


@dataclass
class WatchEvent:
    """One watch-stream entry: type is ADDED | MODIFIED | DELETED."""

    type: str
    obj: Any


class ClusterClient(abc.ABC):
    """Typed object CRUD + watch against a cluster.

    ``kind`` is the object KIND string (e.g. "Service"); lookups raise
    ``agac_tpu_torch.errors.NotFoundError`` when the object does not exist.
    """

    @abc.abstractmethod
    def get(self, kind: str, namespace: str, name: str) -> Any: ...

    @abc.abstractmethod
    def list(self, kind: str, namespace: Optional[str] = None) -> tuple[list[Any], str]:
        """Returns (objects, resource_version) — the rv anchors a watch."""

    @abc.abstractmethod
    def create(self, kind: str, obj: Any) -> Any: ...

    @abc.abstractmethod
    def update(self, kind: str, obj: Any) -> Any:
        """Update spec/metadata.  Clearing the last finalizer of an
        object already marked for deletion completes the delete, as the
        real apiserver does (the EndpointGroupBinding finalizer flow,
        reference ``pkg/controller/endpointgroupbinding/reconcile.go:36-64``,
        depends on this)."""

    @abc.abstractmethod
    def update_status(self, kind: str, obj: Any) -> Any:
        """Update only the status subresource (spec/metadata unchanged),
        like the CRD's ``UpdateStatus`` (reference ``reconcile.go:207-209``)."""

    @abc.abstractmethod
    def delete(self, kind: str, namespace: str, name: str) -> None:
        """Delete, honoring finalizers: an object with finalizers gets
        ``metadata.deletionTimestamp`` set and is MODIFIED, not removed."""

    @abc.abstractmethod
    def watch(
        self, kind: str, resource_version: str, stop: Callable[[], bool]
    ) -> Iterator[WatchEvent]:
        """Stream events after ``resource_version`` until ``stop()``."""
