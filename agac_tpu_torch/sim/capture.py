"""The incident time machine's recording half: a bounded,
versioned, append-only JSONL ring of every EXTERNAL input a running
controller consumed.

The sim runtime made a scenario byte-replayable *given its
script*; the explain plane made a wedged live fleet
*diagnosable*.  What neither gives an operator is reproduction: a
failed chaos drill or live incident could be read about but not re-run.
This module closes that gap by taping the full external-input stream —
everything nondeterministic a controller observes — so ``replay.py``
can feed it back through the REAL manager stack on virtual time:

- **informer batches** — every list/watch delivery with its cursor
  (and relists, the 410-Gone path), per stack identity;
- **AWS call outcomes** — every service call post-classification
  (the ``InstrumentedAPI`` hook): success payload or typed error,
  exactly as the driver saw it;
- **lease observations** — every leader-election acquire/renew
  verdict (``LeaderElection.try_acquire_or_renew``);
- **delivered signals** — SIGINT/SIGTERM arrivals;
- **clockseam reads at capture boundaries** — start/stop/rotation
  timestamps anchoring the window;
- **control verbs and external cluster mutations** — the scenario's
  own actions (chaos kills, resizes, object writes), so a drill's
  script rides inside its own capture.

Divergence bisection rides on a rolling hash: every event embeds
``hash_k = sha256(hash_{k-1} + canonical(event_k))``.  A replay
recomputes the same chain over what actually happened and the FIRST
serial where the chains split IS the first divergent input — the
nondeterminism the static determinism audit cannot see.

Ring discipline: the active segment rotates to ``<path>.1`` when it
exceeds ``max_bytes`` (or ``max_age``); each segment re-emits a header
carrying the chain state and a fresh cluster snapshot, and the loader
tolerates a torn trailing record (a crashed writer's partial line),
so the capture is crash-safe by construction.

The process-global seam (``install``/``active``) mirrors the journey
tracker's: the sim harness installs a virtual-clock capture for a
scenario's lifetime; ``--capture-path`` installs a wall-clock one for
a live controller.  Every ``record_*`` entry point is strictly
contained — telemetry must never fail the hot path it observes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
from typing import Any, Callable, Iterator, Optional

from .. import clockseam, klog
from ..cluster import serde

CAPTURE_VERSION = 1
DEFAULT_MAX_BYTES = 16 * 1024 * 1024
# the chain's genesis: a constant, NOT a hash of the header — the
# replay's shadow chain must be comparable to the recorded chain
# without reproducing the header (whose snapshot a replay consumes,
# not re-emits)
GENESIS = "0" * 64
# the header key that says the recording controller answered a staged
# create's own chain from pending-create records, with no read between
# its creates; a replay of a capture without it (one recorded by a
# controller that read there) reads there too
PENDING_CREATES = "pendingCreates"

# fields the canonical form never hashes: server-filled identity and
# wall-clock stamps the fake apiserver mints from the REAL clock
# (``FakeCluster._now``/uuid4), which differ between a capture and its
# replay without any behavioral divergence; ``duration`` is wall-ish
# latency bookkeeping, not an input
_SCRUB_KEYS = frozenset({"uid", "creationTimestamp", "deletionTimestamp", "duration"})
# in real-clock captures the boundary clock reads themselves are
# content that can never match a virtual-time replay
_REAL_MODE_SCRUB = frozenset({"monotonic", "wall"})


class CaptureFormatError(Exception):
    """The file is not a loadable capture (bad header, wrong version)."""


# ---------------------------------------------------------------------------
# value codec: dataclasses round-trip through the serde wire format
# with a class-name tag; typed errors round-trip as code+message
# ---------------------------------------------------------------------------

_classes: Optional[dict[str, type]] = None


def _registered_classes() -> dict[str, type]:
    """Every dataclass the codec can revive by name: the cluster kinds
    and the AWS wire types.  Built lazily so importing the seam from
    observability code never drags the whole object model in."""
    global _classes
    if _classes is None:
        from .. import leaderelection
        from ..cloudprovider.aws import health as aws_health
        from ..cloudprovider.aws import types as aws_types
        from ..cluster import objects as cluster_objects

        registry: dict[str, type] = {}
        for mod in (cluster_objects, aws_types, aws_health, leaderelection):
            for name in dir(mod):
                cls = getattr(mod, name)
                if isinstance(cls, type) and dataclasses.is_dataclass(cls):
                    registry[name] = cls
        _classes = registry
    return _classes


def encode_value(value: Any) -> Any:
    """JSON-able encoding of anything a tap may record: dataclasses
    (tagged with their class name), exceptions, containers, scalars.
    Unknown objects degrade to their repr — a capture must always
    write, even for payloads it cannot revive."""
    if isinstance(value, BaseException):
        return encode_error(value)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {"__dc__": type(value).__name__, "fields": serde.to_wire(value)}
    if isinstance(value, (list, tuple)):
        return [encode_value(v) for v in value]
    if isinstance(value, dict):
        return {str(k): encode_value(v) for k, v in value.items()}
    if value is None or isinstance(value, (str, int, float, bool)):
        return value
    return {"__repr__": repr(value)}


def decode_value(value: Any) -> Any:
    """Inverse of ``encode_value``; unknown class tags decode to their
    raw wire dicts rather than failing (forward compatibility)."""
    if isinstance(value, list):
        return [decode_value(v) for v in value]
    if isinstance(value, dict):
        if "__dc__" in value:
            cls = _registered_classes().get(value["__dc__"])
            if cls is None:
                return value.get("fields", value)
            return serde.from_wire(cls, value.get("fields") or {})
        if "__err__" in value:
            return decode_error(value)
        if "__repr__" in value:
            return value["__repr__"]
        return {k: decode_value(v) for k, v in value.items()}
    return value


def encode_error(err: BaseException) -> dict:
    out: dict[str, Any] = {"__err__": type(err).__name__, "message": str(err)}
    code = getattr(err, "code", None)
    if code:
        out["code"] = code
    # the fault plan's crash boundary (a BaseException) carries its
    # op/when so a replay re-raises the identical crash
    for attr in ("op", "when"):
        value = getattr(err, attr, None)
        if isinstance(value, str):
            out[attr] = value
    return out


def decode_error(data: dict) -> BaseException:
    """Revive a recorded error as the typed exception the driver saw:
    a ``SimulatedCrash`` by op/when, a known AWS error subclass by
    name, else a generic ``AWSAPIError`` carrying the recorded code."""
    name = data.get("__err__", "")
    if name == "SimulatedCrash":
        from ..cloudprovider.aws.fake_backend import SimulatedCrash

        return SimulatedCrash(data.get("op", "?"), data.get("when", "before"))
    from ..cloudprovider.aws import errors as aws_errors

    cls = getattr(aws_errors, name, None)
    code = data.get("code") or ""
    message = data.get("message", "")
    # the recorded message is str(err), which the AWSAPIError family
    # renders as "{code}: {body}" — strip the prefix before feeding a
    # constructor that re-applies it, so a revived error round-trips
    # to the identical wire form (the replay hash depends on it)
    body = message
    if code and message.startswith(code + ": "):
        body = message[len(code) + 2:]
    elif code and message == code:
        body = ""
    if (
        isinstance(cls, type)
        and issubclass(cls, BaseException)
        and cls is not aws_errors.AWSAPIError
    ):
        try:
            return cls(body)
        except TypeError:
            pass
    return aws_errors.AWSAPIError(code or name, body)


# ---------------------------------------------------------------------------
# the canonical form + rolling hash (the bisection substrate)
# ---------------------------------------------------------------------------


def _scrub(value: Any, extra: frozenset) -> Any:
    if isinstance(value, dict):
        return {
            k: _scrub(v, extra)
            for k, v in value.items()
            if k not in _SCRUB_KEYS and k not in extra
        }
    if isinstance(value, list):
        return [_scrub(v, extra) for v in value]
    return value


def canonical_form(event: dict, clock_mode: str) -> str:
    """The hashed view of one event: kind + payload (scrubbed of
    server-minted identity), plus the virtual timestamp in virtual-clock
    captures (timing IS behavior there) but not in real-clock ones
    (where only content can ever match a replay).  Serial and the
    embedded hash are excluded — alignment is positional, and the hash
    cannot cover itself."""
    body = {k: v for k, v in event.items() if k not in ("hash", "serial", "record")}
    extra = frozenset()
    if clock_mode != "virtual":
        body.pop("t", None)
        extra = _REAL_MODE_SCRUB
    return json.dumps(_scrub(body, extra), sort_keys=True, separators=(",", ":"))


def advance_hash(prev: str, canonical: str) -> str:
    return hashlib.sha256((prev + canonical).encode()).hexdigest()


# ---------------------------------------------------------------------------
# the capture tap
# ---------------------------------------------------------------------------


def _instruments():
    global _metrics
    if _metrics is None:
        from ..observability.instruments import capture_instruments

        _metrics = capture_instruments()
    return _metrics


_metrics = None


class IncidentCapture:
    """One recording: an append-only JSONL segment ring (or, with
    ``path=None``, an in-memory event list — the replay's shadow
    stream).  All ``record_*`` methods are contained: a serialization
    or I/O failure drops the event (counted) and never raises."""

    def __init__(
        self,
        path: Optional[str] = None,
        *,
        max_bytes: int = DEFAULT_MAX_BYTES,
        max_age: float = 0.0,
        clock_mode: str = "real",
        source: str = "live",
        clock: Callable[[], float] = clockseam.monotonic,
        snapshot_fn: Optional[Callable[[], dict]] = None,
        record_payloads: bool = True,
    ):
        self.path = path
        self.max_bytes = max(4096, int(max_bytes))
        self.max_age = max_age
        self.clock_mode = clock_mode
        self.source = source
        self.record_payloads = record_payloads
        self._clock = clock
        self._snapshot_fn = snapshot_fn
        self._lock = threading.Lock()
        self._serial = 0
        self._chain = GENESIS
        self._offset = 0
        self._segment_started = self._clock()
        self._closed = False
        self._rotate_pending = False
        self._file = None
        self._events: list[dict] = []  # in-memory mode only
        self.dropped = 0
        self.rotations = 0
        if path is not None:
            self._file = open(path, "w", encoding="utf-8")
            self._write_header(self._take_snapshot())

    # ---- ring mechanics ----------------------------------------------
    def _take_snapshot(self) -> dict:
        """Call the world-snapshot hook.  NEVER under ``self._lock``:
        the hook walks cluster/AWS state whose own paths record into
        this tap under their locks — snapshotting inside the capture
        lock would close a lock cycle (the lock-order gate catches
        exactly this pairing)."""
        if self._snapshot_fn is None:
            return {}
        try:
            return self._snapshot_fn()
        except Exception as err:
            klog.errorf("incident capture: snapshot failed: %s", err)
            return {"error": str(err)}

    def _header_record(self, snapshot: dict) -> dict:
        return {
            "record": "header",
            "version": CAPTURE_VERSION,
            "clockMode": self.clock_mode,
            "source": self.source,
            "baseSerial": self._serial,
            "chain": self._chain,
            "monotonic": round(clockseam.monotonic(), 6),
            "wall": round(clockseam.time(), 6),
            "snapshot": snapshot,
            PENDING_CREATES: True,
        }

    def _write_header(self, snapshot: dict) -> None:
        line = json.dumps(self._header_record(snapshot), sort_keys=True) + "\n"
        self._file.write(line)
        self._file.flush()
        self._offset = len(line.encode("utf-8"))

    def _rotate_locked(self, snapshot: dict) -> None:
        """Size/age cap reached: the active segment becomes ``.1``
        (evicting the previous rotation — the ring holds at most two
        segments) and a fresh segment opens with a header carrying the
        chain state, so each file verifies stand-alone.  ``snapshot``
        was taken by the caller before acquiring the lock."""
        self._file.close()
        os.replace(self.path, self.path + ".1")
        self.rotations += 1
        self._segment_started = self._clock()
        self._file = open(self.path, "w", encoding="utf-8")
        self._write_header(snapshot)
        try:
            _instruments().rotations.inc()
        except Exception:
            pass

    def _append_locked(self, event: dict) -> None:
        if self._file is not None:
            line = json.dumps(event, sort_keys=True) + "\n"
            data = line.encode("utf-8")
            self._file.write(line)
            self._file.flush()
            self._offset += len(data)
            aged = self.max_age > 0 and (
                self._clock() - self._segment_started > self.max_age
            )
            if self._offset >= self.max_bytes or aged:
                # rotation is DEFERRED to the next record: the fresh
                # header wants a world snapshot, and the snapshot hook
                # must run outside self._lock (see _take_snapshot) —
                # the crossing event stays in the old segment either
                # way, so the segmentation is unchanged
                self._rotate_pending = True
        else:
            self._events.append(event)

    # ---- the one true entry point ------------------------------------
    def record_event(self, kind: str, data: dict) -> None:
        if self._closed:
            return
        try:
            snapshot = None
            if self._rotate_pending:
                # racy read is fine: a concurrent recorder may have
                # rotated already (snapshot discarded below) or may
                # set the flag right after (rotation waits one event)
                snapshot = self._take_snapshot()
            with self._lock:
                if self._rotate_pending:
                    self._rotate_locked(
                        snapshot if snapshot is not None else {}
                    )
                    self._rotate_pending = False
                self._serial += 1
                event = {
                    "record": "event",
                    "serial": self._serial,
                    "t": round(self._clock(), 6),
                    "kind": kind,
                    "data": data,
                }
                self._chain = advance_hash(
                    self._chain, canonical_form(event, self.clock_mode)
                )
                event["hash"] = self._chain
                self._append_locked(event)
        except Exception as err:
            self.dropped += 1
            klog.errorf("incident capture: dropping %s event: %s", kind, err)
            try:
                _instruments().drops.inc()
            except Exception:
                pass
            return
        try:
            metrics = _instruments()
            metrics.events.labels(kind=kind).inc()
            metrics.last_serial.set(float(self._serial))
        except Exception:
            pass

    # ---- typed taps ---------------------------------------------------
    def record_aws_call(
        self,
        service: str,
        op: str,
        outcome: str,
        args: tuple = (),
        kwargs: Optional[dict] = None,
        result: Any = None,
        error: Optional[BaseException] = None,
        duration: Optional[float] = None,
    ) -> None:
        data: dict[str, Any] = {"service": service, "op": op, "outcome": outcome}
        if self.record_payloads:
            data["args"] = encode_value(list(args))
            if kwargs:
                data["kwargs"] = encode_value(kwargs)
        if error is not None:
            data["error"] = encode_error(error)
        elif self.record_payloads:
            data["result"] = encode_value(result)
        if duration is not None:
            data["duration"] = round(duration, 6)
        self.record_event("aws", data)

    def record_informer_batch(
        self,
        identity: str,
        kind: str,
        events: list,
        cursor: str,
        relist: bool = False,
        delivered: int = 0,
    ) -> None:
        data: dict[str, Any] = {
            "identity": identity,
            "informerKind": kind,
            "cursor": str(cursor),
            "relist": relist,
            "delivered": delivered,
        }
        encoded = []
        for event in events:
            entry: dict[str, Any] = {"type": getattr(event, "type", "?")}
            obj = getattr(event, "obj", None)
            meta = getattr(obj, "metadata", None)
            if meta is not None:
                entry["name"] = meta.name
                entry["namespace"] = meta.namespace
                entry["resourceVersion"] = meta.resource_version
            if self.record_payloads:
                entry["obj"] = encode_value(obj)
            encoded.append(entry)
        data["events"] = encoded
        self.record_event("informer", data)

    def record_lease_observation(
        self, lease: str, identity: str, acquired: bool, holder: str
    ) -> None:
        self.record_event(
            "lease",
            {
                "lease": lease,
                "identity": identity,
                "acquired": bool(acquired),
                "holder": holder or "",
            },
        )

    def record_signal(self, signum: int) -> None:
        self.record_event("signal", {"signal": int(signum)})

    def record_clock(self, label: str) -> None:
        self.record_event(
            "clock",
            {
                "label": label,
                "monotonic": round(clockseam.monotonic(), 6),
                "wall": round(clockseam.time(), 6),
            },
        )

    def record_control(self, action: str, origin: str = "external", **fields) -> None:
        data = {"action": action, "origin": origin}
        for key, value in fields.items():
            data[key] = encode_value(value)
        self.record_event("control", data)

    def record_cluster_mutation(
        self,
        method: str,
        kind: str,
        namespace: str = "",
        name: str = "",
        obj: Any = None,
    ) -> None:
        data: dict[str, Any] = {
            "method": method,
            "kind": kind,
            "namespace": namespace or "",
            "name": name or "",
        }
        if obj is not None and self.record_payloads:
            data["obj"] = encode_value(obj)
        self.record_event("cluster", data)

    def echo(self, event: dict) -> None:
        """Re-record a foreign event verbatim on THIS chain (the replay
        harness re-emitting a non-reproducible input — a signal — at
        its recorded slot, keeping the shadow stream aligned)."""
        self.record_event(event.get("kind", "?"), event.get("data", {}))

    # ---- observation surface -----------------------------------------
    def cursor(self) -> dict:
        """Where the recording stands: the post-mortem pointer the
        flight recorder and /debug/flightrecorder surface, naming the
        exact capture window to replay."""
        with self._lock:
            return {
                "file": self.path or "<memory>",
                "offset": self._offset,
                "serial": self._serial,
            }

    def trace_hash(self) -> str:
        with self._lock:
            return self._chain

    def events(self) -> list[dict]:
        """In-memory mode's event list (the replay's shadow stream)."""
        with self._lock:
            return list(self._events)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._file is not None:
                self._file.close()
                self._file = None


# ---------------------------------------------------------------------------
# the process-global seam (the journey-tracker install pattern)
# ---------------------------------------------------------------------------

_active: Optional[IncidentCapture] = None


def install(tap: Optional[IncidentCapture]) -> Optional[IncidentCapture]:
    """Install ``tap`` as the process's capture (None uninstalls);
    returns the previous one so scopes nest correctly."""
    global _active
    previous = _active
    _active = tap
    return previous


def active() -> Optional[IncidentCapture]:
    return _active


# ---------------------------------------------------------------------------
# loading (crash-tolerant) + verification
# ---------------------------------------------------------------------------


class Capture:
    """One loaded segment: header + events, oldest first."""

    def __init__(
        self, header: dict, events: list[dict], path: str = "", truncated: bool = False
    ):
        self.header = header
        self.events = events
        self.path = path
        self.truncated = truncated

    @property
    def clock_mode(self) -> str:
        return self.header.get("clockMode", "real")

    @property
    def snapshot(self) -> dict:
        return self.header.get("snapshot") or {}

    def final_hash(self) -> str:
        if self.events:
            return self.events[-1].get("hash", "")
        return self.header.get("chain", GENESIS)

    def events_of(self, *kinds: str) -> Iterator[dict]:
        for event in self.events:
            if event.get("kind") in kinds:
                yield event

    def verify(self) -> Optional[int]:
        """Recompute the rolling hash over the recorded events; returns
        the serial of the first event whose embedded hash does not
        match (a torn or tampered record), or None when the chain
        holds end to end."""
        chain = self.header.get("chain", GENESIS)
        for event in self.events:
            chain = advance_hash(chain, canonical_form(event, self.clock_mode))
            if event.get("hash") != chain:
                return event.get("serial")
        return None


def load_capture(path: str) -> Capture:
    """Load one segment, tolerating a torn trailing record (the
    partial line a crashed writer leaves): decoding stops at the first
    unparseable line and the capture is marked ``truncated``."""
    header: Optional[dict] = None
    events: list[dict] = []
    truncated = False
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            stripped = line.strip()
            if not stripped:
                continue
            if not line.endswith("\n"):
                truncated = True  # torn tail: no newline ever made it
                break
            try:
                record = json.loads(stripped)
            except ValueError:
                truncated = True
                break
            if header is None:
                if record.get("record") != "header":
                    raise CaptureFormatError(f"{path}: first record is not a header")
                if record.get("version") != CAPTURE_VERSION:
                    raise CaptureFormatError(
                        f"{path}: capture version {record.get('version')!r} "
                        f"(want {CAPTURE_VERSION})"
                    )
                header = record
            elif record.get("record") == "event":
                events.append(record)
    if header is None:
        raise CaptureFormatError(f"{path}: no header record")
    return Capture(header, events, path=path, truncated=truncated)
