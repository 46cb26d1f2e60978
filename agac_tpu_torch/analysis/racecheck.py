"""Runtime lock-order watchdog and instrumented synchronization.

The Python analog of running the Go race detector over the reference's
controller stack: the core threaded modules (workqueue, informer,
leader election, fake backend) create their locks through
``make_lock``/``make_rlock`` below.  With the watchdog disabled (the
default) those return plain ``threading`` primitives — zero overhead,
identical semantics.  A test that calls ``enable()`` BEFORE
constructing the objects under test gets instrumented locks instead,
and the watchdog then records, per thread, the order in which locks
are acquired while other locks are held:

- an **inversion** (edge A→B observed when B→A was already on record)
  is a potential deadlock and is recorded immediately with both
  acquisition stacks;
- longer cycles (A→B→C→A) are found by the full graph walk in
  ``check()`` / ``assert_clean()``;
- ``guard_dict`` wraps a shared dict so any mutation performed without
  the owning instrumented lock held by the current thread is recorded
  with the offending stack (the fake backend guards its service tables
  this way).

Everything here is stdlib-only and must stay import-light: the core
modules import this at module load.
"""

from __future__ import annotations

import threading
import traceback
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class RaceViolation:
    kind: str  # "lock-order-inversion" | "lock-order-cycle" | "unlocked-mutation"
    message: str
    stacks: list[str] = field(default_factory=list)

    def render(self) -> str:
        parts = [f"[{self.kind}] {self.message}"]
        for stack in self.stacks:
            parts.append(stack.rstrip())
        return "\n".join(parts)


@dataclass
class _Edge:
    """First-seen acquisition of ``after`` while ``before`` was held."""

    before: str
    after: str
    count: int = 0
    stack: str = ""
    thread: str = ""


class LockOrderWatchdog:
    """Global acquisition-order graph across all instrumented locks.

    Edges are keyed by lock *name*, not instance: every workqueue of a
    controller shares one ordering class, so an inversion between two
    runs of the same code path is still caught.
    """

    def __init__(self):
        self._mu = threading.Lock()
        self._edges: dict[tuple[str, str], _Edge] = {}
        self._violations: list[RaceViolation] = []
        self._tls = threading.local()
        # (active profile-stage brackets, guarded-dict name) -> count:
        # the runtime half of the confinement footprint cross-check
        # (analysis/confinement.py); empty-stage mutations are skipped
        # (no stage claims them, so the table has nothing to contradict)
        self._stage_accesses: dict[tuple[tuple[str, ...], str], int] = {}

    # ---- per-thread held-lock stack -----------------------------------
    def _held(self) -> list:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = []
            self._tls.held = held
        return held

    # ---- instrumented-lock callbacks ----------------------------------
    def note_acquire(self, lock: "_InstrumentedBase") -> None:
        """Called before blocking on ``lock``; records ordering edges
        from every currently-held lock and flags 2-cycle inversions."""
        held = self._held()
        if not held or any(h is lock for h in held):
            return  # nothing held, or a reentrant re-acquire
        befores = []
        seen = set()
        for h in held:
            if h.name != lock.name and h.name not in seen:
                seen.add(h.name)
                befores.append(h.name)
        if not befores:
            return
        stack = None
        with self._mu:
            for before in befores:
                key = (before, lock.name)
                edge = self._edges.get(key)
                if edge is not None:
                    edge.count += 1
                    continue
                if stack is None:
                    stack = "".join(traceback.format_stack(limit=16))
                edge = _Edge(
                    before, lock.name, 1, stack, threading.current_thread().name
                )
                self._edges[key] = edge
                inverse = self._edges.get((lock.name, before))
                if inverse is not None:
                    self._violations.append(
                        RaceViolation(
                            "lock-order-inversion",
                            f"lock {lock.name!r} acquired while holding "
                            f"{before!r} (thread {edge.thread}), but the "
                            f"opposite order was seen on thread "
                            f"{inverse.thread} — potential deadlock",
                            [
                                f"--- {before} -> {lock.name} ---\n{edge.stack}",
                                f"--- {lock.name} -> {before} ---\n{inverse.stack}",
                            ],
                        )
                    )

    def note_acquired(self, lock: "_InstrumentedBase") -> None:
        self._held().append(lock)

    def note_release(self, lock: "_InstrumentedBase") -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is lock:
                del held[i]
                return

    def note_stage_access(self, name: str) -> None:
        """Tag a guarded-dict mutation with the thread's open profile-
        stage brackets.  Lazy import keeps this module import-light (the
        core modules load racecheck at module scope); a missing or
        stage-less profile module records nothing."""
        try:
            from ..observability import profile
        except ImportError:  # pragma: no cover - stdlib-only envs
            return
        stages = profile.current_stages()
        if not stages:
            return
        with self._mu:
            key = (stages, name)
            self._stage_accesses[key] = self._stage_accesses.get(key, 0) + 1

    def stage_accesses(self) -> list[tuple[tuple[str, ...], str]]:
        """Distinct (stage brackets, guarded-dict name) pairs observed —
        the input ``confinement.runtime_footprint_crosscheck`` takes."""
        with self._mu:
            return sorted(self._stage_accesses)

    def note_unlocked_mutation(self, name: str, op: str) -> None:
        stack = "".join(traceback.format_stack(limit=16))
        with self._mu:
            self._violations.append(
                RaceViolation(
                    "unlocked-mutation",
                    f"{op} on shared dict {name!r} without its lock held "
                    f"(thread {threading.current_thread().name})",
                    [stack],
                )
            )

    # ---- reporting -----------------------------------------------------
    @property
    def violations(self) -> list[RaceViolation]:
        with self._mu:
            return list(self._violations)

    def edges(self) -> list[tuple[str, str]]:
        with self._mu:
            return sorted(self._edges)

    def check(self) -> list[RaceViolation]:
        """Immediate violations plus cycles the 2-edge inversion check
        cannot see (A→B→C→A); returns all of them."""
        with self._mu:
            found = list(self._violations)
            edges = dict(self._edges)
        graph: dict[str, list[str]] = {}
        for before, after in edges:
            graph.setdefault(before, []).append(after)
        inverted = {(b, a) for (a, b) in edges}
        reported: set[frozenset] = set()
        # DFS with an explicit path for cycle extraction
        state: dict[str, int] = {}  # 0=unvisited 1=on-path 2=done
        path: list[str] = []

        def visit(node: str) -> Optional[list[str]]:
            state[node] = 1
            path.append(node)
            for nxt in graph.get(node, ()):
                if state.get(nxt, 0) == 1:
                    return path[path.index(nxt) :] + [nxt]
                if state.get(nxt, 0) == 0:
                    cycle = visit(nxt)
                    if cycle is not None:
                        return cycle
            path.pop()
            state[node] = 2
            return None

        for node in sorted(graph):
            if state.get(node, 0) == 0:
                cycle = visit(node)
                if cycle is None:
                    continue
                pairs = list(zip(cycle, cycle[1:]))
                if len(cycle) == 3 and {tuple(p) for p in pairs} & inverted:
                    break  # 2-cycle: already reported as an inversion
                key = frozenset(cycle)
                if key in reported:
                    continue
                reported.add(key)
                stacks = [
                    f"--- {a} -> {b} ---\n{edges[(a, b)].stack}" for a, b in pairs
                ]
                found.append(
                    RaceViolation(
                        "lock-order-cycle",
                        "lock acquisition order forms a cycle: "
                        + " -> ".join(cycle),
                        stacks,
                    )
                )
                break  # one cycle report is enough to fail a test
        return found

    def assert_clean(self) -> None:
        found = self.check()
        if found:
            raise AssertionError(
                f"{len(found)} race-check violation(s):\n\n"
                + "\n\n".join(v.render() for v in found)
            )


class _InstrumentedBase:
    """Shared acquire/release bookkeeping over a wrapped lock."""

    def __init__(self, inner, name: str, watchdog: LockOrderWatchdog):
        self._inner = inner
        self.name = name
        self._watchdog = watchdog
        self._owner: Optional[int] = None
        self._count = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._watchdog.note_acquire(self)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._owner = threading.get_ident()
            self._count += 1
            self._watchdog.note_acquired(self)
        return got

    def release(self) -> None:
        self._count -= 1
        if self._count == 0:
            self._owner = None
        self._inner.release()
        self._watchdog.note_release(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def _is_owned(self) -> bool:  # threading.Condition compatibility
        return self._owner == threading.get_ident()

    def held_by_current_thread(self) -> bool:
        return self._owner == threading.get_ident()

    def locked(self) -> bool:
        return self._inner.locked()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r} inner={self._inner!r}>"


class InstrumentedLock(_InstrumentedBase):
    def __init__(self, name: str, watchdog: LockOrderWatchdog):
        super().__init__(threading.Lock(), name, watchdog)


class InstrumentedRLock(_InstrumentedBase):
    def __init__(self, name: str, watchdog: LockOrderWatchdog):
        super().__init__(threading.RLock(), name, watchdog)


class GuardedDict(dict):
    """A dict whose mutations must happen with ``lock`` held by the
    calling thread; anything else is recorded as a race violation.
    Reads stay unchecked — the fake backend hands out copies under its
    lock, and read-vs-write races are what the mutation check exists
    to surface."""

    def __init__(self, data, lock: _InstrumentedBase, name: str, watchdog: LockOrderWatchdog):
        super().__init__(data)
        self._lock = lock
        self._name = name
        self._watchdog = watchdog

    def _check(self, op: str) -> None:
        self._watchdog.note_stage_access(self._name)
        if not self._lock.held_by_current_thread():
            self._watchdog.note_unlocked_mutation(self._name, op)

    def __setitem__(self, key, value):
        self._check("__setitem__")
        super().__setitem__(key, value)

    def __delitem__(self, key):
        self._check("__delitem__")
        super().__delitem__(key)

    def pop(self, *args):
        self._check("pop")
        return super().pop(*args)

    def popitem(self):
        self._check("popitem")
        return super().popitem()

    def clear(self):
        self._check("clear")
        super().clear()

    def update(self, *args, **kwargs):
        self._check("update")
        super().update(*args, **kwargs)

    def setdefault(self, key, default=None):
        self._check("setdefault")
        return super().setdefault(key, default)


# ---------------------------------------------------------------------------
# module-level switch — the seam the core modules create locks through
# ---------------------------------------------------------------------------

_active: Optional[LockOrderWatchdog] = None


def enable() -> LockOrderWatchdog:
    """Install a FRESH watchdog; locks created from now on (until
    ``disable``) are instrumented and report into it.  Locks created
    while disabled stay plain forever — enable before constructing the
    objects under test."""
    global _active
    _active = LockOrderWatchdog()
    return _active


def disable() -> None:
    global _active
    _active = None


def active() -> Optional[LockOrderWatchdog]:
    return _active


def make_lock(name: str):
    watchdog = _active
    if watchdog is None:
        return threading.Lock()
    return InstrumentedLock(name, watchdog)


def make_rlock(name: str):
    watchdog = _active
    if watchdog is None:
        return threading.RLock()
    return InstrumentedRLock(name, watchdog)


def guard_dict(data: Optional[dict], lock, name: str) -> dict:
    """Wrap ``data`` so mutations assert ``lock`` is held — only when
    the lock is instrumented (i.e., the watchdog was enabled when its
    owner was constructed); otherwise the dict passes through plain."""
    if data is None:
        data = {}
    if isinstance(lock, _InstrumentedBase):
        return GuardedDict(data, lock, name, lock._watchdog)
    return dict(data)
