"""The process-wide clock/sleep seam.

Every subsystem that measures or spends time — workqueue delays,
settle polls, drift/resync tickers, health-plane windows, informer
resync ages, leader-election freshness, the Route53 batcher linger —
must read time through this seam (or an explicitly injected clock)
instead of calling ``time.time()`` / ``time.monotonic()`` /
``time.sleep()`` directly.  Under production the seam is a
zero-indirection passthrough to the real clock; under the
deterministic simulation runtime (``agac_tpu_torch/sim/``) the sim installs
its virtual clock here and the ENTIRE manager runs on virtual time —
an N=50k fleet converges and a 7-virtual-day soak finishes in minutes
of wall clock, with every run byte-replayable from its seed.

The ``unseamed-clock`` lint rule (``analysis/rules.py``) pins the
invariant statically: a direct wall-clock call outside this module,
``agac_tpu_torch/sim/`` and the sanctioned real-I/O modules fails CI.

Four installable pieces:

- ``monotonic()`` — the interval clock (durations, deadlines, TTLs);
- ``time()`` — the wall clock (timestamps in persisted objects);
- ``sleep(d)`` — blocking delay; in the sim this ADVANCES virtual
  time instead of blocking a thread;
- ``thread_cpu()`` — per-thread CPU time (``time.thread_time``), the
  stage accountant's cost clock.  The sim installs its
  virtual monotonic here too, so under simulation CPU == wall and the
  profiling plane stays byte-replayable.

Plus one capability flag: ``threads_enabled()``.  The sim runtime is
a single-threaded cooperative executor — components that would
normally spawn helper threads (the workqueue's delay waker, the event
recorder's persistence worker) consult this flag at construction time
and fall back to synchronous, explicitly-pumped operation so every
interleaving decision belongs to the deterministic scheduler.

``install``/``reset`` are NOT thread-safe against concurrent
construction on purpose: the seam is flipped once, before a sim world
is built, and flipped back after — never mid-flight.
"""

from __future__ import annotations

import time as _time
from typing import Callable, Optional

_real_monotonic = _time.monotonic
_real_time = _time.time
_real_sleep = _time.sleep
_real_thread_cpu = _time.thread_time

_monotonic: Callable[[], float] = _real_monotonic
_wall: Callable[[], float] = _real_time
_sleep: Callable[[float], None] = _real_sleep
_thread_cpu: Callable[[], float] = _real_thread_cpu
_threads_enabled: bool = True


def monotonic() -> float:
    """Interval clock — the seam-routed ``time.monotonic()``."""
    return _monotonic()


def time() -> float:
    """Wall clock — the seam-routed ``time.time()``."""
    return _wall()


def sleep(seconds: float) -> None:
    """Seam-routed ``time.sleep()``; virtual-time advance in the sim."""
    _sleep(seconds)


def thread_cpu() -> float:
    """Per-thread CPU seconds — the seam-routed ``time.thread_time()``.
    The stage accountant (``observability/profile.py``) charges every
    stage's CPU through this; under the sim it reads virtual monotonic
    time so replay hashes never depend on host scheduling."""
    return _thread_cpu()


def monotonic_fn() -> Callable[[], float]:
    """The CURRENT monotonic callable, for components that capture a
    ``clock`` attribute at construction (``clock or
    clockseam.monotonic_fn()``).  Capturing the module function
    ``monotonic`` works too and additionally follows later installs;
    this accessor exists for call sites that want construction-time
    binding semantics made explicit."""
    return _monotonic


def sleep_fn() -> Callable[[float], None]:
    return _sleep


def threads_enabled() -> bool:
    """False while a simulation runtime is installed: helper threads
    (queue delay wakers, recorder persistence workers) must not be
    spawned — the sim's cooperative scheduler pumps their work
    explicitly so interleaving stays deterministic."""
    return _threads_enabled


def install(
    monotonic: Optional[Callable[[], float]] = None,
    wall: Optional[Callable[[], float]] = None,
    sleep: Optional[Callable[[float], None]] = None,
    threads: bool = True,
    thread_cpu: Optional[Callable[[], float]] = None,
) -> None:
    """Install a replacement clock (the sim runtime's entry point).
    Omitted pieces keep the real implementation — EXCEPT ``thread_cpu``,
    which defaults to the installed ``monotonic`` whenever that is
    replaced: a virtual world has no meaningful host-CPU counter, and
    CPU == wall keeps stage accounting deterministic under replay."""
    global _monotonic, _wall, _sleep, _thread_cpu, _threads_enabled
    _monotonic = monotonic if monotonic is not None else _real_monotonic
    _wall = wall if wall is not None else _real_time
    _sleep = sleep if sleep is not None else _real_sleep
    if thread_cpu is not None:
        _thread_cpu = thread_cpu
    elif monotonic is not None:
        _thread_cpu = monotonic
    else:
        _thread_cpu = _real_thread_cpu
    _threads_enabled = threads


def reset() -> None:
    """Restore the real clock (sim teardown; exception-safe via
    ``sim.runtime.installed`` context manager)."""
    install()
