"""The measured window: an open loop of changes, each timed from when it
was due to the first read of the world that shows it applied."""

from __future__ import annotations

import math
import threading
import time


class Window:
    """Runs ``changes`` (due times in s from the window's start) against
    ``world``, with the ``actions`` on the deployment carried out through
    ``act`` at their times, and watches ``world.reader`` until every
    change has taken effect or ``drain_limit`` s have passed since the
    window closed.

    A change has taken effect when every item of ``expects[i]`` (the
    reference's items for it) reads as expected.  A change that a later
    change of the same object overtakes closes when that later one does.
    """

    def __init__(self, world, changes: list[dict], expects: list[dict], poll: float = 0.05,
                 actions: list[dict] = (), act=None):
        self.world, self.changes, self.expects, self.poll = world, changes, expects, poll
        self.actions, self.act = list(actions), act
        self.acted: list[list] = []  # [action, due, done at]
        self.applied_at: list[float | None] = [None] * len(changes)
        self.closed_at: list[float | None] = [None] * len(changes)
        self.lateness: list[float] = []
        self.reads = 0
        self.read_s = 0.0
        self._error: BaseException | None = None

    def _apply_all(self, t0: float) -> None:
        try:
            events = sorted([(c["due"], 0, i) for i, c in enumerate(self.changes)]
                            + [(a["due"], 1, j) for j, a in enumerate(self.actions)])
            for due, is_action, i in events:
                delay = t0 + due - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                if is_action:
                    self.act(self.actions[i])
                    self.acted.append([self.actions[i]["act"], due, time.monotonic() - t0])
                    continue
                change = self.changes[i]
                now = time.monotonic()
                self.lateness.append(now - t0 - change["due"])
                self.world.apply(change)
                self.applied_at[i] = time.monotonic() - t0
        except BaseException as err:  # surfaced by run()
            self._error = err

    def run(self, seconds: float, drain_limit: float) -> float:
        """Start the window now; returns the seconds from its start to
        the end of the drain (every change closed, or the limit)."""
        t0 = self.t0 = time.monotonic()
        applier = threading.Thread(target=self._apply_all, args=(t0,), name="perfbench-applier", daemon=True)
        applier.start()
        by_object: dict[tuple, list[int]] = {}
        for i, change in enumerate(self.changes):
            by_object.setdefault((change["section"], change["key"]), []).append(i)
        open_ = set(range(len(self.changes)))
        end = seconds + drain_limit
        while True:
            if self._error is not None:
                raise self._error
            now = time.monotonic() - t0
            ready = [i for i in open_ if self.applied_at[i] is not None]
            if ready:
                wanted = set().union(*(self.expects[i].keys() for i in ready))
                started = time.monotonic()
                items = self.world.reader.read(wanted)
                self.read_s += time.monotonic() - started
                self.reads += 1
                seen = started - t0
                for i in ready:
                    if all(items.get(item) == want for item, want in self.expects[i].items()):
                        change = self.changes[i]
                        for j in by_object[(change["section"], change["key"])]:
                            if j <= i and j in open_:
                                self.closed_at[j] = seen
                                open_.discard(j)
            if not open_ and now >= seconds and not applier.is_alive():
                break
            if now >= end:
                break
            time.sleep(self.poll)
        applier.join(timeout=5.0)
        return time.monotonic() - t0

    def latencies(self, failed_at: float) -> tuple[list[float], int]:
        """Every change's latency from its due time; a change still open
        counts as ``failed_at - due`` (it missed any limit shorter than
        that), and the count of those."""
        out, failed = [], 0
        for change, closed in zip(self.changes, self.closed_at):
            if closed is None:
                failed += 1
                out.append(failed_at - change["due"])
            else:
                out.append(closed - change["due"])
        return out, failed


def percentile(values: list[float], q: float) -> float:
    """The nearest-rank ``q`` quantile (0 < q <= 1)."""
    ordered = sorted(values)
    index = math.ceil(q * len(ordered) - 1e-9) - 1
    return ordered[min(len(ordered) - 1, max(0, index))]
