"""Horizontal sharding plane: partition the reconcile
keyspace across multiple concurrently-live controller replicas.

Three pieces, composed by the manager:

- ``ring``: a deterministic consistent-hash partitioner over
  ``namespace/name`` reconcile keys — a vnode ring, so resizing the
  shard count moves ~1/N of the keyspace instead of reshuffling it;
- ``membership``: per-shard Lease acquisition (N named leases
  ``agac-shard-<i>``), generalized from the single active-passive
  lease in ``leaderelection.py`` — each replica holds at most a
  configured number of shards, steals expired leases, and publishes
  the shard map it observes;
- ``ShardFilter``: the ``owns(namespace, name)`` predicate every
  enqueue funnel, drift tick and GC sweep consults, so a replica only
  ever works keys its shards own.

Swift (arxiv 2501.19051) is the reference shape: an elastic control
plane that scales out without serializing through one coordinator.

Elastic resharding makes the shard count itself a live,
drain/handoff-mediated target: ``request_resize`` CAS-writes the ring
lease, every membership tick advances the two-phase transition, and
``transition_plan`` is the exact donor/gainer movement plan both
sides coordinate on.
"""

from .membership import (
    OWNS_ALL,
    RESIZE_ADOPTING,
    RESIZE_DRAINING,
    RESIZE_STABLE,
    ShardFilter,
    ShardMembership,
    ShardingConfig,
    request_resize,
    resize_in_flight,
    ring_lease_name,
    ring_status,
)
from .ring import HashRing, RingTransition, transition_plan

__all__ = [
    "HashRing",
    "OWNS_ALL",
    "RESIZE_ADOPTING",
    "RESIZE_DRAINING",
    "RESIZE_STABLE",
    "RingTransition",
    "ShardFilter",
    "ShardMembership",
    "ShardingConfig",
    "request_resize",
    "resize_in_flight",
    "ring_lease_name",
    "ring_status",
    "transition_plan",
]
