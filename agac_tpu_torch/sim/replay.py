"""The incident time machine's replay half: feed a
recorded capture back through the REAL manager stack on virtual time
and bisect the first divergent input.

``capture.py`` taped every external input a run consumed; this module
reconstructs the run from that tape:

- the capture header's snapshot rebuilds the WORLD — the harness
  config (``decode_config``) and the cluster store (``FakeCluster.
  restore``, same objects, same resourceVersion counter);
- a ``ReplayAWSBackend`` substitutes recorded outcomes for the cloud:
  a recorded ERROR is re-raised as its typed exception without
  touching backend state (a brownout replays with no fault plan at
  all), a recorded SUCCESS executes against the deterministic inner
  fake so controller reads re-derive (or, with
  ``substitute_results=True``, returns the recorded payload verbatim
  — the mode for captures of non-fake backends);
- external control verbs, scenario cluster writes and delivered
  signals are re-injected at their recorded virtual instants
  (priority −1, so a same-instant harness tick never overtakes them);
  internal-origin control events (crash recovery, autoscaler resizes)
  are NOT re-injected — the replayed stack re-derives them;
- everything the replayed run observes lands in an in-memory SHADOW
  capture via the same taps, so the two input streams are directly
  comparable.

Divergence bisection is a chain walk: recompute the rolling hash over
the shadow stream (starting from the recorded header's chain) and
compare each step to the hash EMBEDDED in the recorded event at the
same position.  The first position where they split names the first
divergent input — the exact event where the replayed world stopped
being the recorded one.

Known limitation: a recorded ``fail_after_commit`` error replays as a
pre-commit failure (the recorded exception is raised without running
the inner op), so state written by the original half-commit is absent
from the replayed backend; the resulting read divergence IS the
bisection's report, deliberately.  Crash faults carry their boundary
(``when="after"`` executes the inner op before dying), so kill drills
replay exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional

from .. import klog
from ..cloudprovider.aws.fake_backend import FakeAWSBackend, SimulatedCrash
from ..cloudprovider.aws.health import ALL_OPS
from ..cluster import FakeCluster
from ..observability import explain as obs_explain
from . import capture as capture_mod
from .capture import Capture, IncidentCapture, load_capture
from .harness import SimHarness, decode_config


@dataclasses.dataclass
class Divergence:
    """The first event where the replayed input stream split from the
    recorded one."""

    serial: int
    index: int  # position in the recorded event list
    reason: str  # hash-split | replay-ended-early | replay-extra-events
    recorded: Optional[dict] = None
    replayed: Optional[dict] = None

    def describe(self) -> str:
        lines = [f"first divergent event: serial={self.serial} ({self.reason})"]
        if self.recorded is not None:
            lines.append(
                f"  recorded: kind={self.recorded.get('kind')} "
                f"t={self.recorded.get('t')} "
                f"data={capture_mod.canonical_form(self.recorded, 'real')[:240]}"
            )
        if self.replayed is not None:
            lines.append(
                f"  replayed: kind={self.replayed.get('kind')} "
                f"t={self.replayed.get('t')} "
                f"data={capture_mod.canonical_form(self.replayed, 'real')[:240]}"
            )
        return "\n".join(lines)


@dataclasses.dataclass
class ReplayResult:
    """One replay's verdict: the recorded vs replayed chains, the
    bisected divergence (None = byte-identical input streams), the
    oracle battery's violations, and the substitution ledger."""

    recorded_hash: str
    replay_hash: str
    replayed_events: int
    recorded_events: int
    divergence: Optional[Divergence]
    violations: list[str] = dataclasses.field(default_factory=list)
    notes: list[str] = dataclasses.field(default_factory=list)

    @property
    def identical(self) -> bool:
        return self.divergence is None and self.recorded_hash == self.replay_hash


def bisect_divergence(
    capture: Capture, shadow_events: list[dict]
) -> Optional[Divergence]:
    """Walk both streams in lockstep, advancing the recorded chain
    over the SHADOW events' canonical forms: the first position where
    the recomputed hash stops matching the recorded event's embedded
    hash is the first divergent input."""
    chain = capture.header.get("chain", capture_mod.GENESIS)
    mode = capture.clock_mode
    for index, recorded in enumerate(capture.events):
        if index >= len(shadow_events):
            return Divergence(
                serial=recorded.get("serial", index + 1),
                index=index,
                reason="replay-ended-early",
                recorded=recorded,
            )
        replayed = shadow_events[index]
        chain = capture_mod.advance_hash(
            chain, capture_mod.canonical_form(replayed, mode)
        )
        if chain != recorded.get("hash"):
            return Divergence(
                serial=recorded.get("serial", index + 1),
                index=index,
                reason="hash-split",
                recorded=recorded,
                replayed=replayed,
            )
    if len(shadow_events) > len(capture.events):
        extra = shadow_events[len(capture.events)]
        return Divergence(
            serial=capture.events[-1].get("serial", 0) + 1 if capture.events else 1,
            index=len(capture.events),
            reason="replay-extra-events",
            replayed=extra,
        )
    return None


def _rechain(capture: Capture, shadow_events: list[dict]) -> str:
    """The shadow stream's chain computed from the RECORDED genesis —
    comparable to ``capture.final_hash()`` regardless of the shadow's
    own base serial."""
    chain = capture.header.get("chain", capture_mod.GENESIS)
    for event in shadow_events:
        chain = capture_mod.advance_hash(
            chain, capture_mod.canonical_form(event, capture.clock_mode)
        )
    return chain


class ReplayAWSBackend:
    """The recorded AWS outcome stream standing in for the cloud.

    Service ops (``ALL_OPS``) consume the recorded ``aws`` events in
    strict global order: a recorded error re-raises as its typed
    exception (no inner-state mutation — the fault plan that produced
    it is not needed); a recorded success executes the deterministic
    inner fake (rederive mode, the default) or returns the recorded
    payload (``substitute_results=True``).  Everything else — the
    ``calls`` ledger, the oracle helper methods, ``install_fault_plan``
    — delegates to the inner fake so the whole assertion surface works
    on a replayed world."""

    def __init__(
        self,
        inner: FakeAWSBackend,
        recorded: list[dict],
        substitute_results: bool = False,
    ):
        self._inner = inner
        self._recorded = list(recorded)
        self._next = 0
        self._substitute = substitute_results
        self.notes: list[str] = []

    def __getattr__(self, name: str):
        if name in ALL_OPS:
            def op(*args, **kwargs):
                return self._call(name, args, kwargs)

            op.__name__ = name
            return op
        return getattr(self._inner, name)

    def _pop(self, op: str) -> Optional[dict]:
        if self._next >= len(self._recorded):
            self.notes.append(f"aws stream exhausted before {op}")
            return None
        event = self._recorded[self._next]
        data = event.get("data", {})
        if data.get("op") != op:
            # the replayed world asked a different question than the
            # recording answered — leave the stream in place; the
            # bisection names the split, the note names the call
            self.notes.append(
                f"aws stream skew: replay called {op}, recorded "
                f"serial={event.get('serial')} is {data.get('op')}"
            )
            return None
        self._next += 1
        return data

    def _call(self, op: str, args: tuple, kwargs: dict) -> Any:
        data = self._pop(op)
        if data is None:
            return getattr(self._inner, op)(*args, **kwargs)
        error = data.get("error")
        if error is not None:
            err = capture_mod.decode_error(error)
            if isinstance(err, SimulatedCrash) and err.when == "after":
                # the original died AFTER the commit: reproduce the
                # state change, then die at the same boundary
                getattr(self._inner, op)(*args, **kwargs)
            raise err
        if self._substitute:
            return capture_mod.decode_value(data.get("result"))
        return getattr(self._inner, op)(*args, **kwargs)

    def remaining(self) -> int:
        return len(self._recorded) - self._next


class ReplayInformerFeed:
    """Recorded watch batches standing in for the live pump (the
    ``substitute_results`` analog for informers): ``SimHarness.
    informer_feed`` duck-type.  Default (rederive) replays leave this
    unset — the restored cluster re-derives the same batches."""

    def __init__(self, recorded: list[dict]):
        self._by_stream: dict[tuple[str, str], list[dict]] = {}
        for event in recorded:
            data = event.get("data", {})
            key = (data.get("identity", ""), data.get("informerKind", ""))
            batch = dict(data)
            batch["t"] = event.get("t", 0.0)
            self._by_stream.setdefault(key, []).append(batch)

    def due(self, identity: str, kind: str, now: float) -> Iterator[dict]:
        stream = self._by_stream.get((identity, kind))
        while stream and stream[0]["t"] <= now + 1e-9:
            yield stream.pop(0)

    def decode_events(self, batch: dict) -> list:
        from ..cluster.client import WatchEvent

        events = []
        for entry in batch.get("events", ()):
            obj = capture_mod.decode_value(entry.get("obj"))
            events.append(WatchEvent(entry.get("type", "?"), obj))
        return events


# control actions a replay re-injects, by recorded name
_CONTROL_VERBS = (
    "kill_leader",
    "demote_leader",
    "kill_shard_replica",
    "stop_shard_replica",
    "add_shard_replica",
    "request_resize",
)


class ReplayHarness:
    """A recorded incident, re-run.  Use::

        with ReplayHarness(load_capture(path)) as rh:
            rh.run()                       # to the recorded stop instant
            result = rh.result()
            assert result.identical, result.divergence.describe()

    or stop mid-flight for as-of forensics::

        with ReplayHarness(cap) as rh:
            rh.run_to(t)                   # any past virtual instant
            print(rh.explain("default/web"))
    """

    def __init__(
        self,
        capture: Capture,
        substitute_results: bool = False,
        substitute_informers: bool = False,
        oracles: Optional[Callable[[SimHarness], list[str]]] = None,
    ):
        if capture.clock_mode != "virtual" and not substitute_results:
            # a real-clock capture's successes came from real AWS — the
            # inner fake cannot re-derive them
            substitute_results = True
        self.capture = capture
        self._oracles = oracles
        snapshot = capture.snapshot
        self.config = decode_config(snapshot.get("config") or {})
        opaque = (snapshot.get("config") or {}).get("__opaque__")
        self.notes: list[str] = []
        if opaque:
            self.notes.append(
                f"config fields {opaque} were not captured (callable-"
                "bearing); replaying with defaults"
            )
        cluster = FakeCluster()
        cluster_snap = snapshot.get("cluster") or {}
        restored = [
            (entry["kind"], capture_mod.decode_value(entry["obj"]))
            for entry in cluster_snap.get("objects", ())
        ]
        if restored or cluster_snap.get("resourceVersion"):
            cluster.restore(restored, cluster_snap.get("resourceVersion", 0))
        inner = FakeAWSBackend(
            quota_accelerators=self.config.quota_accelerators,
            settle_describes=self.config.settle_describes,
        )
        aws_snap = snapshot.get("aws")
        if aws_snap:
            inner.restore_state(aws_snap)
        self.aws = ReplayAWSBackend(
            inner,
            [
                event
                for event in capture.events_of("aws")
                # guard-level rejections (an open circuit failing fast,
                # a reconcile deadline expiring before the call) were
                # recorded at the instrument seam but never reached the
                # backend — the replay's own health guard re-derives
                # them, so they must not consume the backend stream
                if (event.get("data", {}).get("error") or {}).get("__err__")
                not in ("CircuitOpenError", "DeadlineExceeded")
            ],
            substitute_results=substitute_results,
        )
        self.shadow = IncidentCapture(
            clock_mode=capture.clock_mode, source="replay"
        )
        self.harness = SimHarness(
            cluster=cluster, aws=self.aws, config=self.config,
            capture=self.shadow,
            pending_creates=capture.header.get(capture_mod.PENDING_CREATES, False),
        )
        self._substitute_informers = substitute_informers
        self._entered = False
        self._closed = False
        self._stop_t = self._recorded_stop()

    def _recorded_stop(self) -> float:
        stop = 0.0
        for event in self.capture.events:
            data = event.get("data", {})
            if event.get("kind") == "clock" and data.get("label") == "stop":
                stop = max(stop, float(event.get("t", 0.0)))
        if stop:
            return stop
        if self.capture.events:
            return float(self.capture.events[-1].get("t", 0.0))
        return 0.0

    # ---- lifecycle ----------------------------------------------------
    def __enter__(self) -> "ReplayHarness":
        self.harness.__enter__()
        self._entered = True
        if self._substitute_informers:
            self.harness.informer_feed = ReplayInformerFeed(
                list(self.capture.events_of("informer"))
            )
        self._schedule_injections()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._entered and not self._closed:
            self._closed = True
            self.harness.__exit__(None, None, None)

    # ---- re-injection -------------------------------------------------

    # how many same-instant retries a gated injection tolerates before
    # force-firing (a diverged replay may never reproduce the events
    # the gate waits for; forcing keeps the run moving so the
    # bisection can name the split)
    _GATE_RETRY_LIMIT = 64

    def _schedule_injections(self) -> None:
        for index, event in enumerate(self.capture.events):
            kind = event.get("kind")
            data = event.get("data", {})
            t = float(event.get("t", 0.0))
            if kind == "cluster":
                fn = self._cluster_injector(data)
            elif kind == "control" and data.get("origin") == "external":
                fn = self._control_injector(data)
            elif kind == "signal":
                fn = self._signal_injector(event)
            else:
                continue
            self._schedule_gated(t, kind, fn, index)

    def _schedule_gated(
        self, t: float, kind: str, fn: Callable[[], None], index: int,
        attempts: int = 0,
    ) -> None:
        """Re-inject an external input at its recorded instant AND its
        recorded position in the event stream.  The instant alone is
        not enough: at a shared virtual instant the original run may
        have interleaved harness ticks (a lease renewal, an informer
        pump) BEFORE the scenario's action — the recorded serial
        captures that order exactly, so the injection waits until the
        shadow stream has re-recorded every preceding event.  First
        attempt fires at priority −1 (before co-timed ticks — the
        common case of scenario actions taken before the clock ran);
        when the gate finds preceding events missing it requeues
        itself at priority 2, AFTER the co-timed ticks that must
        produce them."""

        def gated() -> None:
            done = self.shadow.cursor()["serial"]
            if done < index and attempts < self._GATE_RETRY_LIMIT:
                self._schedule_gated(t, kind, fn, index, attempts + 1)
                return
            if done < index:
                self.notes.append(
                    f"injection gate gave up waiting for event {index} "
                    f"(shadow at {done}); forcing"
                )
            fn()

        self.harness.scheduler.call_at(
            t, gated, f"replay-inject:{kind}",
            priority=-1 if attempts == 0 else 2,
        )

    def _cluster_injector(self, data: dict) -> Callable[[], None]:
        method = data.get("method", "")
        kind = data.get("kind", "")

        def inject() -> None:
            cluster = self.harness.cluster
            try:
                if method == "delete":
                    cluster.delete(kind, data.get("namespace", ""), data.get("name", ""))
                else:
                    obj = capture_mod.decode_value(data.get("obj"))
                    getattr(cluster, method)(kind, obj)
            except Exception as err:
                # a failed re-injection is itself divergence evidence;
                # keep replaying so the bisection can report it
                self.notes.append(f"cluster {method} {kind} failed: {err}")
                klog.warningf("replay: cluster inject %s %s: %s", method, kind, err)

        return inject

    def _control_injector(self, data: dict) -> Callable[[], None]:
        action = data.get("action", "")

        def inject() -> None:
            harness = self.harness
            try:
                if action == "kill_leader":
                    harness.kill_leader()
                elif action == "demote_leader":
                    harness.demote_leader()
                elif action == "kill_shard_replica":
                    harness.kill_shard_replica(
                        identity=data.get("identity"),
                        replace=bool(data.get("replace")),
                    )
                elif action == "stop_shard_replica":
                    harness.stop_shard_replica(identity=data.get("identity"))
                elif action == "add_shard_replica":
                    harness.add_shard_replica()
                elif action == "request_resize":
                    harness.request_resize(int(data.get("target", 0)))
                elif action == "aws_seed":
                    args = capture_mod.decode_value(data.get("args")) or []
                    kwargs = capture_mod.decode_value(data.get("kwargs")) or {}
                    getattr(harness.aws, data.get("method", ""))(*args, **kwargs)
                else:
                    self.notes.append(f"unknown control action {action!r}")
            except Exception as err:
                self.notes.append(f"control {action} failed: {err}")
                klog.warningf("replay: control inject %s: %s", action, err)

        return inject

    def _signal_injector(self, event: dict) -> Callable[[], None]:
        def inject() -> None:
            # signals are not reproducible inputs — echo the recorded
            # event onto the shadow chain at its recorded slot
            self.shadow.echo(event)

        return inject

    # ---- running ------------------------------------------------------
    def run_to(self, t: float) -> None:
        """Advance the replayed world to virtual instant ``t`` (capped
        at the recorded stop)."""
        self.harness.run_until(min(t, self._stop_t))

    def run(self) -> None:
        """Replay end to end: to the recorded stop instant, then close
        the harness so the shadow records its stop at the same t."""
        self.harness.run_until(self._stop_t)
        self.close()

    # ---- verdicts -----------------------------------------------------
    def result(self) -> ReplayResult:
        shadow_events = self.shadow.events()
        divergence = bisect_divergence(self.capture, shadow_events)
        return ReplayResult(
            recorded_hash=self.capture.final_hash(),
            replay_hash=_rechain(self.capture, shadow_events),
            replayed_events=len(shadow_events),
            recorded_events=len(self.capture.events),
            divergence=divergence,
            notes=self.notes + self.aws.notes,
        )

    def run_oracles(self) -> list[str]:
        """The standard final-state battery over the replayed world
        (or the constructor's override)."""
        from . import oracles as oracle_mod

        if self._oracles is not None:
            return self._oracles(self.harness)
        return oracle_mod.standard_oracles(
            self.harness, self.config.cluster_name
        )

    def explain(self, key: str, controller: Optional[str] = None) -> dict:
        """The fleet-merged ``/debug/explain`` answer AS OF the
        replayed world's current virtual instant — the time-machine
        query: ``run_to(t)`` first, then ask."""
        answers = {}
        for stack in self.harness.live_stacks():
            engine = getattr(stack.manager, "explain_engine", None)
            if engine is not None:
                answers[stack.identity] = engine.explain(key, controller)
        if not answers:
            return {"key": key, "verdict": "no-live-stack", "controllers": {}}
        return obs_explain.merge_fleet_explains(answers)


def replay_capture(
    source,
    oracles: Optional[Callable[[SimHarness], list[str]]] = None,
    substitute_results: bool = False,
    run_oracles: bool = True,
) -> ReplayResult:
    """One-shot convenience: load (if given a path), replay end to
    end, bisect, and run the oracle battery."""
    capture = source if isinstance(source, Capture) else load_capture(source)
    with ReplayHarness(
        capture, substitute_results=substitute_results, oracles=oracles
    ) as rh:
        rh.run()
        result = rh.result()
        if run_oracles:
            try:
                result.violations = rh.run_oracles()
            except Exception as err:
                result.violations = [f"oracle battery failed: {err!r}"]
    return result


def explain_at(source, t: float, key: str, controller: Optional[str] = None) -> dict:
    """``explain --at``: the verdict for ``key`` at past virtual
    instant ``t`` of a replayed capture."""
    capture = source if isinstance(source, Capture) else load_capture(source)
    with ReplayHarness(capture) as rh:
        rh.run_to(t)
        return rh.explain(key, controller)
