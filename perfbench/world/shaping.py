"""The benchmark's shaping proxy in front of its in-memory AWS.

The model is ``bench.py``'s (``REAL_LATENCY``, ``QUOTAS`` and
``OP_FAMILY``, copied here so that the program cannot change it): every
operation of the three API families sleeps its real-world latency,
scaled by ``1 / scale``, after a token bucket per family admits it, at
the real-world quota scaled by ``scale``.  A call that finds its bucket
empty waits its turn, as an SDK in standard-retry mode paces itself under
throttling.

The proxy counts every call by operation, armed or not, and the wall
seconds each operation spent in the bucket and in its latency while
armed.  These counts are the benchmark's own: ``aws_calls_per_change``
and the per-layer call metrics read them, never the program's counters.
"""

from __future__ import annotations

import threading
import time

# Real-world control-plane latencies (s) before scaling (bench.py:189-227)
REAL_LATENCY = {
    "create_accelerator": 1.5,
    "update_accelerator": 1.0,
    "delete_accelerator": 1.0,
    "create_listener": 0.5,
    "update_listener": 0.5,
    "delete_listener": 0.5,
    "create_endpoint_group": 0.5,
    "update_endpoint_group": 0.5,
    "delete_endpoint_group": 0.5,
    "add_endpoints": 0.3,
    "remove_endpoints": 0.3,
    "tag_resource": 0.2,
    "list_accelerators": 0.3,
    "describe_accelerator": 0.2,
    "list_tags_for_resource": 0.1,
    "list_listeners": 0.15,
    "list_endpoint_groups": 0.15,
    "describe_endpoint_group": 0.15,
    "describe_load_balancers": 0.2,
    "list_hosted_zones": 0.2,
    "list_hosted_zones_by_name": 0.2,
    "list_resource_record_sets": 0.25,
    "change_resource_record_sets": 0.5,
}

# API family -> real-world (requests/s, burst) before scaling
# (bench.py:229-237 states them after its x10: GA mutate 5/s, GA read
# 20/s, ELBv2 10/s, Route53 5/s, each with a burst of two seconds)
REAL_QUOTAS = {
    "ga_mutate": (5.0, 10),
    "ga_read": (20.0, 40),
    "elbv2": (10.0, 20),
    "route53": (5.0, 10),
}

OP_FAMILY = {
    op: (
        "elbv2" if op == "describe_load_balancers"
        else "route53" if "hosted_zone" in op or "record_sets" in op
        else "ga_read" if op.startswith(("list_", "describe_"))
        else "ga_mutate"
    )
    for op in REAL_LATENCY
}


class TokenBucket:
    """A token bucket that hands out reservations in arrival order: each
    call takes a token, and waits until the bucket would have held it."""

    def __init__(self, rate: float, burst: int):
        self.rate, self.burst = rate, burst
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._tokens = float(self.burst)
            self._stamp = time.monotonic()

    def reserve(self) -> float:
        """Take one token; the seconds to wait before using it."""
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self.burst, self._tokens + (now - self._stamp) * self.rate)
            self._stamp = now
            self._tokens -= 1.0
            return 0.0 if self._tokens >= 0 else -self._tokens / self.rate


class ShapedAWS:
    """Hand one to ``AWSDriver`` as its three APIs.  Off until ``arm()``:
    the base population converges unshaped, then the window is shaped."""

    def __init__(self, backend, ops, scale: float):
        self._backend = backend
        self._ops = frozenset(ops)
        self.scale = scale
        self.armed = False
        self._lock = threading.Lock()
        self.counts: dict[str, int] = {}
        self.shaped_s: dict[str, float] = {}
        self.buckets = {
            family: TokenBucket(rate * scale, int(burst * scale))
            for family, (rate, burst) in REAL_QUOTAS.items()
        }
        self._wrapped: dict = {}

    def arm(self, on: bool = True) -> None:
        for bucket in self.buckets.values():
            bucket.reset()
        self.armed = on

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self.counts)

    def __getattr__(self, name):
        attr = getattr(self._backend, name)
        if name not in self._ops:
            return attr
        wrapped = self._wrapped.get(name)
        if wrapped is None:
            wrapped = self._wrapped[name] = self._shape(name)
        return wrapped

    def _shape(self, name: str):
        call = getattr(self._backend, name)
        bucket = self.buckets[OP_FAMILY[name]]
        latency = REAL_LATENCY[name] / self.scale

        def shaped(*args, **kwargs):
            with self._lock:
                self.counts[name] = self.counts.get(name, 0) + 1
            if self.armed:
                start = time.monotonic()
                wait = bucket.reserve()
                time.sleep(wait + latency)
                with self._lock:
                    self.shaped_s[name] = self.shaped_s.get(name, 0.0) + time.monotonic() - start
            return call(*args, **kwargs)

        return shaped
