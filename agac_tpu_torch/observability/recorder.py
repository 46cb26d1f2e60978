"""The flight recorder: a fixed-size ring buffer of recent reconcile
outcomes and errors.

Logs rotate and sampling drops most traces; what an operator actually
needs after a wedge or a crash is "what were the last few hundred
things this controller did, and which of them failed".  The recorder
keeps exactly that, bounded:

- every completed reconcile records one entry (controller, key,
  outcome, error text, duration, requeue count);
- drift ticks and GC sweeps record their reports;
- the buffer is a ``deque(maxlen=capacity)`` — O(1) append, oldest
  entries evicted, memory strictly bounded;
- ``dump()`` returns the entries oldest → newest for the
  ``/debug/flightrecorder`` endpoint, and ``log_dump()`` writes a
  compact tail to the log — wired to SIGTERM so a terminating pod
  leaves its last moments in the pod log where the kubelet keeps them.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import Callable

from .. import clockseam, klog

DEFAULT_CAPACITY = 512


class FlightRecorder:
    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        clock: Callable[[], float] = clockseam.time,
    ):
        self.capacity = max(1, capacity)
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: deque[dict] = deque(maxlen=self.capacity)
        self._seq = 0
        self.recorded_total = 0

    def record(self, kind: str, **fields) -> None:
        """Append one entry; never raises (telemetry must not fail the
        hot path) and never grows past capacity."""
        try:
            with self._lock:
                self._seq += 1
                self.recorded_total += 1
                entry = {"seq": self._seq, "time": round(self._clock(), 3), "kind": kind}
                entry.update(fields)
                self._entries.append(entry)
        except Exception as err:  # a bad field must not kill a worker
            klog.errorf("flight recorder: dropping entry: %s", err)

    def dump(self, limit: int = 0) -> list[dict]:
        """Entries oldest → newest; ``limit`` > 0 keeps only the most
        recent that many."""
        with self._lock:
            entries = list(self._entries)
        if limit > 0:
            entries = entries[-limit:]
        return entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def log_dump(self, limit: int = 64) -> None:
        """Write the most recent entries to the log as one compact
        JSON line each — the SIGTERM post-mortem (a terminating pod's
        log survives in the kubelet; its /debug endpoint does not)."""
        entries = self.dump(limit=limit)
        klog.infof(
            "flight recorder: dumping last %d of %d recorded entries",
            len(entries), self.recorded_total,
        )
        # the active incident capture's cursor: the dying
        # pod names the exact capture window — file, byte offset, last
        # event serial — so the post-mortem points straight at the
        # replayable artifact.  Contained like the rest of the dump.
        try:
            from ..sim.capture import active

            tap = active()
            if tap is not None:
                klog.infof(
                    "flight capture-cursor %s",
                    json.dumps(tap.cursor(), separators=(",", ":"), sort_keys=True),
                )
        except Exception:
            pass
        for entry in entries:
            try:
                klog.infof("flight %s", json.dumps(entry, separators=(",", ":"), sort_keys=True))
            except Exception:
                klog.infof("flight %r", entry)


# ---------------------------------------------------------------------------
# the process-global recorder (one reconcile plane per process; tests
# build their own FlightRecorder and pass it where they need isolation)
# ---------------------------------------------------------------------------

_recorder = FlightRecorder()


def flight_recorder() -> FlightRecorder:
    return _recorder
