"""Sampling wall/stack profiler.

The stage accountant (``profile.py``) answers "which stage costs CPU";
this module answers "which *code* is on-CPU (or parked) right now" —
a stdlib-only sampling profiler that walks every thread's frame via
``sys._current_frames()`` at a configurable hz and aggregates the
walks into folded-stack form (the ``root;caller;leaf count`` lines
flamegraph tooling eats) plus a ranked top-N function table
(self/cumulative sample counts).

Three consumers:

- ``/debug/profile?seconds=N`` (manager health server) runs a fresh
  timed capture in the handler thread and serves the folded text or a
  JSON top table — the on-demand "what is this replica doing" drill.
- The continuous sampler (``run`` on a daemon thread, armed by
  ``--profile-hz`` and gated on ``clockseam.threads_enabled()`` — the
  sim's cooperative executor must never see a wild thread) keeps a
  rolling aggregate whose top table the SIGTERM handler dumps into the
  log next to the FlightRecorder tail: a terminating pod's last
  artifact says where it was spending its time.
- Tests feed a synthetic ``frames_fn`` so folded-stack aggregation and
  top-N ranking are exercised deterministically with zero real
  threads.

The sampler thread's own frame is excluded from every walk.
"""

from __future__ import annotations

import sys
import threading
from typing import Callable, Dict, Optional

from .. import clockseam, klog
from ..analysis import racecheck

DEFAULT_HZ = 97.0  # prime-ish: avoids phase-locking with 10ms tickers
MAX_STACK_DEPTH = 64
TOP_DEFAULT = 20


def _frame_label(frame) -> str:
    code = frame.f_code
    return f"{code.co_name} ({code.co_filename}:{frame.f_lineno})"


class FoldedStacks:
    """Aggregated samples: {(root, ..., leaf): count} plus per-frame
    self/cumulative tallies.  Thread-safe (the continuous sampler
    writes while the endpoint reads)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[tuple, int] = {}
        self.samples = 0

    def add_frame(self, frame, max_depth: int = MAX_STACK_DEPTH) -> None:
        stack = []
        while frame is not None and len(stack) < max_depth:
            stack.append(_frame_label(frame))
            frame = frame.f_back
        if not stack:
            return
        key = tuple(reversed(stack))  # root first, leaf last
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + 1
            self.samples += 1

    def merge(self, other: "FoldedStacks") -> None:
        with other._lock:
            items = list(other._counts.items())
        with self._lock:
            for key, count in items:
                self._counts[key] = self._counts.get(key, 0) + count
                self.samples += count

    def folded(self) -> str:
        """One ``root;caller;leaf count`` line per distinct stack,
        deterministic order (count desc, then stack lexicographic)."""
        with self._lock:
            items = list(self._counts.items())
        items.sort(key=lambda kv: (-kv[1], kv[0]))
        return "\n".join(f"{';'.join(key)} {count}" for key, count in items)

    def top(self, n: int = TOP_DEFAULT) -> list[dict]:
        """Ranked per-function table: ``self`` = samples with the
        function on top of a stack, ``cum`` = samples with it anywhere
        (counted once per stack).  Deterministic: self desc, cum desc,
        then name."""
        self_counts: Dict[str, int] = {}
        cum_counts: Dict[str, int] = {}
        with self._lock:
            items = list(self._counts.items())
            total = self.samples
        for key, count in items:
            leaf = key[-1]
            self_counts[leaf] = self_counts.get(leaf, 0) + count
            for func in set(key):
                cum_counts[func] = cum_counts.get(func, 0) + count
        rows = [
            {
                "func": func,
                "self": self_counts.get(func, 0),
                "cum": cum,
                "self_pct": round(100.0 * self_counts.get(func, 0) / total, 2)
                if total
                else 0.0,
            }
            for func, cum in cum_counts.items()
        ]
        rows.sort(key=lambda r: (-r["self"], -r["cum"], r["func"]))
        return rows[:n]

    def clear(self) -> None:
        with self._lock:
            self._counts.clear()
            self.samples = 0


class StackProfiler:
    """The sampling loop.  ``frames_fn`` defaults to
    ``sys._current_frames``; tests inject a synthetic feed.  ``clock``
    and ``sleep`` ride the process seam so a capture's pacing is
    injectable too."""

    def __init__(
        self,
        hz: float = DEFAULT_HZ,
        frames_fn: Optional[Callable[[], dict]] = None,
        clock: Callable[[], float] = clockseam.monotonic,
        sleep: Callable[[float], None] = clockseam.sleep,
        max_depth: int = MAX_STACK_DEPTH,
    ):
        # guards hz and the continuous-sampler thread handle: the
        # process-global profiler is shared (configure() from cmd/root,
        # start() from the manager, capture() from health handlers), so
        # its mutable fields take the racecheck-visible lock — the
        # shared-state census classifies `_profiler` off this site
        self._mu = racecheck.make_lock("stackprof")
        self.hz = max(1.0, float(hz))
        self._frames_fn = frames_fn or sys._current_frames
        self._clock = clock
        self._sleep = sleep
        self._max_depth = max_depth
        # the rolling aggregate the continuous sampler feeds and the
        # SIGTERM dump reads
        self.aggregate = FoldedStacks()
        self._thread: Optional[threading.Thread] = None

    def sample_once(self, into: FoldedStacks, skip_threads: frozenset = frozenset()) -> None:
        for thread_id, frame in list(self._frames_fn().items()):
            if thread_id in skip_threads:
                continue
            into.add_frame(frame, self._max_depth)

    def capture(self, seconds: float, hz: Optional[float] = None) -> dict:
        """A fresh timed capture (blocking the calling thread — the
        /debug/profile handler runs on its own connection thread, so
        blocking there is free).  Returns the JSON-ready dict the
        endpoint serves."""
        rate = max(1.0, float(hz or self.hz))
        seconds = max(0.0, min(float(seconds), 60.0))
        stacks = FoldedStacks()
        skip = frozenset({threading.get_ident()})
        deadline = self._clock() + seconds
        interval = 1.0 / rate
        while True:
            self.sample_once(stacks, skip_threads=skip)
            if self._clock() >= deadline:
                break
            self._sleep(interval)
        return {
            "hz": rate,
            "seconds": seconds,
            "samples": stacks.samples,
            "folded": stacks.folded(),
            "top": stacks.top(),
        }

    # -- continuous mode ------------------------------------------------
    def run(self, stop: threading.Event) -> None:
        """The continuous sampling loop body (daemon thread target)."""
        skip = frozenset({threading.get_ident()})
        interval = 1.0 / self.hz
        while not stop.is_set():
            try:
                self.sample_once(self.aggregate, skip_threads=skip)
            except Exception:  # sampling must never kill the thread
                pass
            stop.wait(interval)

    def start(self, stop: threading.Event) -> Optional[threading.Thread]:
        """Start the continuous sampler — only when the runtime allows
        threads (the sim's cooperative executor must own every
        interleaving decision, so under it this is a refusal, not a
        fallback)."""
        if not clockseam.threads_enabled():
            return None
        with self._mu:
            existing = self._thread
            # ident is None while created-but-unstarted: a concurrent
            # starter must piggyback on it, not double-spawn
            if existing is not None and (
                existing.ident is None or existing.is_alive()
            ):
                return existing
            thread = threading.Thread(
                target=self.run, args=(stop,), daemon=True, name="stack-profiler"
            )
            self._thread = thread
        # started outside the lock: .start() never runs under _mu, so
        # the profiler's lock stays a leaf in the static lock order
        thread.start()
        return thread

    def set_rate(self, hz: float) -> None:
        with self._mu:
            self.hz = max(1.0, float(hz))

    def log_top(self, n: int = 10) -> None:
        """Dump the continuous aggregate's top table via klog — the
        SIGTERM post-mortem companion to the FlightRecorder tail."""
        rows = self.aggregate.top(n)
        if not rows:
            return
        klog.infof(
            "stack profiler top (of %d samples):", self.aggregate.samples
        )
        for row in rows:
            klog.infof(
                "  %5.1f%% self=%d cum=%d %s",
                row["self_pct"], row["self"], row["cum"], row["func"],
            )


# ---------------------------------------------------------------------------
# the process-global profiler, configured by --profile-hz (cmd/root)
# ---------------------------------------------------------------------------

_profiler = StackProfiler()


def profiler() -> StackProfiler:
    return _profiler


def configure(hz: Optional[float] = None) -> None:
    if hz is not None and hz > 0:
        _profiler.set_rate(hz)


def capture(seconds: float, hz: Optional[float] = None) -> dict:
    """Module-level capture off the global profiler (the default
    ``/debug/profile`` hook)."""
    return _profiler.capture(seconds, hz=hz)
