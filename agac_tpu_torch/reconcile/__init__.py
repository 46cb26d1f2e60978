"""The generic reconcile kernel: rate-limited workqueues plus the
level-triggered process-next-work-item loop.

Capability parity with the reference's ``pkg/reconcile/reconcile.go``
and the client-go ``util/workqueue`` machinery it builds on.
"""

from .pending import (
    SETTLE_FAILED,
    SETTLE_PENDING,
    SETTLE_READY,
    PendingSettleTable,
    SettleScheduler,
    SettleWait,
)
from .result import Result
from .workqueue import (
    BucketRateLimiter,
    ItemExponentialFailureRateLimiter,
    MaxOfRateLimiter,
    RateLimitingQueue,
    controller_rate_limiter,
    default_controller_rate_limiter,
)
from .reconcile import (
    add_sync_duration_observer,
    process_next_work_item,
    remove_sync_duration_observer,
)

__all__ = [
    "add_sync_duration_observer",
    "remove_sync_duration_observer",
    "Result",
    "RateLimitingQueue",
    "ItemExponentialFailureRateLimiter",
    "BucketRateLimiter",
    "MaxOfRateLimiter",
    "controller_rate_limiter",
    "default_controller_rate_limiter",
    "process_next_work_item",
    "PendingSettleTable",
    "SettleScheduler",
    "SettleWait",
    "SETTLE_PENDING",
    "SETTLE_READY",
    "SETTLE_FAILED",
]
