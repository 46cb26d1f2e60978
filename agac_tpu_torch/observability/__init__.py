"""The observability plane + the convergence SLO plane
: metrics, trace spans, the flight recorder, object journeys,
SLO burn rates, and fleet-merged scrapes.

Dependency-free modules give the whole stack one telemetry surface
(Arcturus' stability argument applied to *this* control plane: you
cannot operate what you cannot measure):

- ``metrics``: a thread-safe Prometheus-style registry
  (Counter/Gauge/Histogram with bounded label cardinality and text
  exposition) — every subsystem's counters live here instead of in
  private dicts;
- ``trace``: sampled per-reconcile trace spans (queue wait, sync,
  each AWS call, settle polls, the requeue decision) emitted as
  structured log lines;
- ``recorder``: a fixed-size ring buffer of recent reconcile
  outcomes/errors, dumpable via ``/debug/flightrecorder`` and on
  SIGTERM — the post-mortem the logs have usually rotated away;
- ``journey``: per-object lifecycle stamps (enqueued → attempts →
  parks → handoffs → converged) feeding the end-to-end
  convergence-latency histograms — the only latency a *user* of the
  controller experiences;
- ``slo``: declared convergence objectives, multi-window error-budget
  burn rates, and the burn-gated shedding of deferrable load (GC
  sweeps, drift pacing) — served on ``/slo``;
- ``fleet``: merges shard replicas' scrapes (counters summed, gauges
  shard-labeled, journey histograms aggregated) into the one fleet
  view ``/metrics/fleet`` serves.

``instruments`` centralizes every metric declaration so the exposed
catalog (``python -m agac_tpu_torch.observability.catalog``) can never drift
from the instrumented code.
"""

from .journey import JourneyTracker
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, registry
from .recorder import FlightRecorder, flight_recorder
from .slo import SLOEngine, SLOObjective
from .trace import Span, Trace, Tracer, tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "registry",
    "FlightRecorder",
    "flight_recorder",
    "JourneyTracker",
    "SLOEngine",
    "SLOObjective",
    "Span",
    "Trace",
    "Tracer",
    "tracer",
]
