"""Reconcile result contract.

Mirrors the reference's ``pkg/reconcile/reconcile.go:17-20``: a process
function reports whether the item should be requeued (rate-limited) or
re-scheduled after a fixed delay.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Result:
    requeue: bool = False
    requeue_after: float = 0.0  # seconds; > 0 wins over ``requeue``
    # the item was popped but belongs to another replica's shards
    # (a key re-homed between enqueue and pop — queue
    # residue across a drain/handoff or a lease steal): forget it
    # WITHOUT closing its journey — the new owner's resync carries it
    skip: bool = False
    # structured explain-catalog reason code (explain.REASON_CODES) for
    # WHY the requeue/skip happened — the explain plane's blocked-on
    # verdict reads it back from the queue/journey, never inferring.
    # The unexplained-requeue lint rule requires every requeue/skip
    # Result in controllers/ and reconcile/ to carry a literal code.
    reason: str = ""
