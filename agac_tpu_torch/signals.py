"""Signal handling.

Capability parity with the reference's ``pkg/signals/signals.go:16-30``:
SIGINT/SIGTERM set the returned stop event; a second signal hard-exits
with code 1; installing the handler twice raises.
"""

from __future__ import annotations

import os
import signal
import threading

_installed = False


def setup_signal_handler() -> threading.Event:
    global _installed
    if _installed:
        raise RuntimeError("signal handler already installed")  # panics when called twice
    _installed = True

    stop = threading.Event()

    def handler(signum, frame):
        if stop.is_set():
            os._exit(1)  # second signal: exit directly
        # incident capture: the delivered signal is itself
        # an external input — it lands on the capture chain before the
        # post-mortems run, so a replay re-raises it at the same slot.
        # Strictly contained, like every tap.
        try:
            from .sim.capture import active

            tap = active()
            if tap is not None:
                tap.record_signal(signum)
        except Exception:
            pass
        # flight-recorder post-mortem: a terminating pod's
        # log is the one artifact the kubelet keeps, so the last
        # reconcile outcomes go there before shutdown begins.  Strictly
        # contained — telemetry must never block the stop signal.
        try:
            from .observability.recorder import flight_recorder

            flight_recorder().log_dump()
        except Exception:
            pass
        # continuous-profiling tail: whatever the sampler
        # accumulated rides out with the post-mortem — same containment.
        try:
            from .observability.stackprof import profiler

            profiler().log_top()
        except Exception:
            pass
        # blocked-on table: what the fleet was stuck on at
        # the moment of death — same containment.
        try:
            from .observability.explain import engine

            engine().log_top_blocked()
        except Exception:
            pass
        stop.set()

    signal.signal(signal.SIGINT, handler)
    signal.signal(signal.SIGTERM, handler)
    return stop
