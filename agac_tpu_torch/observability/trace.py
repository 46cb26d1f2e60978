"""Per-reconcile trace spans with sampled structured emission.

A reconcile's latency hides in places a single duration metric cannot
separate: queue wait, the sync body, each AWS call (and its pacing /
retry time), settle polls, and the requeue decision.  This module
gives the reconcile loop a lightweight tracer:

- ``process_next_work_item`` starts a trace per work item (sampling
  decides up front, so an unsampled item costs one integer increment);
- the trace rides a thread-local, so the driver's call proxy and the
  settle poll attach spans without any parameter plumbing
  (``record_call`` / ``span``);
- a finished sampled trace is emitted as ONE structured JSON log line
  via klog — greppable, no collector dependency.

Sampling is deterministic (every Nth trace per tracer, from the
configured rate), so tests drive it without randomness and a fleet's
sampled volume is exactly rate * traffic.  The clock is injectable;
the default reads the process clock seam (``clockseam.monotonic``),
so spans run on virtual time under the simulation runtime.
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Optional

from .. import clockseam, klog


class Span:
    """One timed segment of a trace: name, [start, end) on the trace's
    clock, and a small attribute dict (op, outcome, arn, ...)."""

    __slots__ = ("name", "start", "end", "attrs")

    def __init__(self, name: str, start: float, end: float = 0.0,
                 attrs: Optional[dict] = None):
        self.name = name
        self.start = start
        self.end = end
        self.attrs = attrs or {}

    def duration(self) -> float:
        return max(0.0, self.end - self.start)

    def to_dict(self, origin: float) -> dict:
        d = {
            "name": self.name,
            "at": round(self.start - origin, 6),
            "dur": round(self.duration(), 6),
        }
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class Trace:
    """One work item's trace: controller + key + ordered spans + final
    attributes (result, error, requeue decision).  Only sampled items
    get a Trace at all — the unsampled path carries None."""

    __slots__ = ("controller", "key", "start", "end", "spans", "attrs", "_clock", "_lock")

    def __init__(self, controller: str, key: str, clock: Callable[[], float]):
        self.controller = controller
        self.key = key
        self._clock = clock
        self.start = clock()
        self.end = 0.0
        self.spans: list[Span] = []
        self.attrs: dict = {}
        self._lock = threading.Lock()

    def add_span(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)

    def annotate(self, **attrs) -> None:
        with self._lock:
            self.attrs.update(attrs)

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "controller": self.controller,
                "key": self.key,
                # the start on the process clock (clockseam.monotonic:
                # CLOCK_MONOTONIC in production), so a line from any
                # process of one host lines up with the others'
                "t0": round(self.start, 6),
                "dur": round(max(0.0, self.end - self.start), 6),
                "spans": [s.to_dict(self.start) for s in self.spans],
                **self.attrs,
            }


_active = threading.local()


def current() -> Optional[Trace]:
    """The thread's active trace, or None (unsampled / outside a
    reconcile) — the seam the driver hooks read."""
    return getattr(_active, "trace", None)


class _Activation:
    """Context manager installing a trace as the thread's current one.
    A None trace is a clean no-op, so call sites never branch."""

    __slots__ = ("_trace", "_prev")

    def __init__(self, trace: Optional[Trace]):
        self._trace = trace

    def __enter__(self):
        self._prev = getattr(_active, "trace", None)
        if self._trace is not None:
            _active.trace = self._trace
        return self._trace

    def __exit__(self, *exc):
        if self._trace is not None:
            _active.trace = self._prev
        return False


def activate(trace: Optional[Trace]) -> _Activation:
    return _Activation(trace)


class _SpanContext:
    """``with span("settle-poll", arn=...):`` — attaches a timed span
    to the current trace; no-op (zero allocation beyond self) when no
    trace is active."""

    __slots__ = ("_name", "_attrs", "_trace", "_start")

    def __init__(self, name: str, attrs: dict):
        self._name = name
        self._attrs = attrs
        self._trace = current()

    def __enter__(self):
        if self._trace is not None:
            self._start = self._trace._clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        trace = self._trace
        if trace is not None:
            attrs = dict(self._attrs)
            if exc is not None:
                attrs["error"] = repr(exc)
            trace.add_span(Span(self._name, self._start, trace._clock(), attrs))
        return False


def span(name: str, **attrs) -> _SpanContext:
    return _SpanContext(name, attrs)


def record_call(service: str, op: str, start: float, end: float, outcome: str) -> None:
    """Attach a completed AWS-call span to the current trace (the
    driver's instrumented handles call this with the same timestamps
    they feed the call-latency histogram)."""
    trace = current()
    if trace is None:
        return
    trace.add_span(Span(f"aws:{service}.{op}", start, end, {"outcome": outcome}))


def record(name: str, start: float, end: float, attrs: Optional[dict] = None) -> None:
    """Attach a completed span to the current trace: the read plane's
    loads and parked waits (``read-plane-load:<cache>``,
    ``read-plane-wait:<cache>``) and the API server's requests
    (``apiserver:<verb>``), timed by the caller with the timestamps it
    feeds its own histogram.  No trace, no allocation."""
    trace = current()
    if trace is None:
        return
    trace.add_span(Span(name, start, end, attrs))


def _default_emit(payload: dict) -> None:
    klog.infof("trace %s", json.dumps(payload, separators=(",", ":"), sort_keys=True))


class Tracer:
    """Sampling trace factory.  ``sample_rate`` in [0, 1]: 0 disables
    tracing entirely, 1 traces everything, anything between samples
    deterministically every ``round(1/rate)``-th started item (no RNG:
    reproducible in tests, exact volume in production)."""

    def __init__(
        self,
        sample_rate: float = 0.0,
        clock: Callable[[], float] = clockseam.monotonic,
        emit: Callable[[dict], None] = _default_emit,
    ):
        self._clock = clock
        self._emit = emit
        self._lock = threading.Lock()
        self._count = 0
        self.emitted_total = 0
        self.set_sample_rate(sample_rate)

    def set_sample_rate(self, rate: float) -> None:
        with self._lock:
            if rate <= 0:
                self._stride = 0
            else:
                self._stride = max(1, round(1.0 / min(rate, 1.0)))

    def sample_rate(self) -> float:
        with self._lock:
            return 0.0 if self._stride == 0 else 1.0 / self._stride

    def _should_sample(self) -> bool:
        with self._lock:
            if self._stride == 0:
                return False
            self._count += 1
            return self._count % self._stride == 0

    def start(self, controller: str, key: str, queue_wait: Optional[float] = None
              ) -> Optional[Trace]:
        """A Trace for a sampled work item, None otherwise.  The queue
        wait (known only to the workqueue) arrives as a pre-measured
        span so the trace covers the item's full queued lifetime."""
        if not self._should_sample():
            return None
        trace = Trace(controller, key, self._clock)
        if queue_wait is not None and queue_wait >= 0:
            trace.add_span(
                Span("queue-wait", trace.start - queue_wait, trace.start)
            )
        return trace

    def finish(self, trace: Optional[Trace]) -> None:
        """Close and emit a sampled trace; no-op on None.  Emission
        failures are contained — telemetry must never fail a
        reconcile."""
        if trace is None:
            return
        trace.end = trace._clock()
        try:
            self._emit(trace.to_dict())
        except Exception as err:
            klog.errorf("trace emission failed for %r: %s", trace.key, err)
        with self._lock:
            self.emitted_total += 1


# ---------------------------------------------------------------------------
# the process-global tracer, configured by --trace-sample (cmd/root.py);
# default rate 0 = tracing off (reference parity: no tracing existed)
# ---------------------------------------------------------------------------

_tracer = Tracer()


def tracer() -> Tracer:
    return _tracer


def configure(sample_rate: float) -> None:
    _tracer.set_sample_rate(sample_rate)
