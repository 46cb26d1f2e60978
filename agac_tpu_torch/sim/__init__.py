"""Deterministic discrete-event simulation runtime.

Runs the ENTIRE controller manager — workqueue rate-limiter delays,
settle poll ticks, drift ticks, GC sweeps, health-plane AIMD/circuit
windows, leader-election lease renewals, informer resyncs, and the
Route53 batcher linger — on virtual time against the fake (or
file-backed fake) AWS backend, single-threaded and byte-replayable
from a seed.  A 10k-Service fleet converges and a 7-virtual-day soak
completes in minutes of wall clock.

- ``runtime``: ``SimClock``/``SimScheduler`` — the virtual clock, the
  event heap with a deterministic ready-queue order, cooperative
  generator actors, and the rolling event-trace hash;
- ``harness``: ``SimHarness`` — assembles a real ``Manager`` (via
  ``Manager.build``) on the sim clock and pumps informers, workers,
  settle polls, drift ticks, GC sweeps and leader electors
  cooperatively;
- ``oracles``: the invariant checks every scenario runs against;
- ``fuzz``: the hypothesis-compatible scenario fuzzer composing
  ``FaultPlan`` primitives (crash × throttle × brownout × racing spec
  edits × leader churn) with seed replay;
- ``capture``/``replay``: the incident time machine — the
  bounded external-input recording of a live or chaos run, and the
  harness that feeds it back through the real manager stack on
  virtual time with first-divergent-event bisection.
"""

from .capture import Capture, IncidentCapture, load_capture
from .runtime import SimClock, SimScheduler, installed
from .harness import SimHarness, SimHarnessConfig
from .replay import ReplayHarness, ReplayResult, replay_capture

__all__ = [
    "Capture",
    "IncidentCapture",
    "ReplayHarness",
    "ReplayResult",
    "SimClock",
    "SimScheduler",
    "SimHarness",
    "SimHarnessConfig",
    "installed",
    "load_capture",
    "replay_capture",
]
