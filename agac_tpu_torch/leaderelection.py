"""Lease-based leader election — single-active-controller HA.

Capability parity with the reference's ``pkg/leaderelection/`` (85
LoC), which wraps client-go's LeaseLock elector: a coordination Lease
object named after the controller, uuid identity, LeaseDuration 60 s /
RenewDeadline 15 s / RetryPeriod 5 s (``leaderelection.go:61-63``),
the run callback invoked only once leadership is acquired, and
``on_stopped_leading`` fired when the lease cannot be renewed within
the renew deadline — the reference exits the process there
(``leaderelection.go:70-73``) and the CLI layer here does the same.

The elector speaks to the apiserver only through ``ClusterClient``
(Lease get/create/update with optimistic concurrency), so it runs
against both the fake and the REST client.

Clock-skew independence (client-go semantics): the holder's
``renewTime`` written by the *other* replica is never compared against
this process's wall clock.  Instead the elector records, on the local
monotonic clock, when it last *observed the lease record change*
(holder/renewTime/acquireTime/transitions tuple).  The lease is
considered live until ``observed_time + lease_duration`` on the local
clock — so a holder whose wall clock is minutes ahead or behind still
keeps its lease as long as it keeps writing, and a crashed holder is
superseded one full lease_duration after its last observed write.
This mirrors the ``observedRecord``/``observedTime`` pair in client-go's
``leaderelection.go`` (as wrapped by the reference's
``pkg/leaderelection/leaderelection.go:47-73``).
"""

from __future__ import annotations

import threading
import uuid
from dataclasses import dataclass
from typing import Callable, Optional

from . import clockseam, klog
from .analysis import racecheck
from .cluster import ClusterClient, Lease
from .cluster.objects import LeaseSpec, ObjectMeta
from .errors import AlreadyExistsError, ConflictError, NotFoundError
from .observability import instruments


def _now_rfc3339() -> str:
    import datetime

    # through the wall-clock seam so lease timestamps are virtual
    # (and deterministic) under the sim runtime; freshness decisions
    # never read these — they use the local monotonic clock below
    return datetime.datetime.fromtimestamp(
        clockseam.time(), datetime.timezone.utc
    ).strftime("%Y-%m-%dT%H:%M:%S.%fZ")


@dataclass
class LeaderElectionConfig:
    lease_duration: float = 60.0
    renew_deadline: float = 15.0
    retry_period: float = 5.0


class LeaderElection:
    def __init__(
        self,
        name: str,
        namespace: str,
        config: Optional[LeaderElectionConfig] = None,
        identity: Optional[str] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.name = name
        self.namespace = namespace
        self.config = config or LeaderElectionConfig()
        self.identity = identity or str(uuid.uuid4())
        # optional annotations folded into every lease record this
        # elector writes (shard membership publishes its measured
        # keys-owned here for load-aware placement); None
        # (default) leaves lease metadata untouched
        self.annotation_provider: Optional[Callable[[], dict]] = None
        # the local monotonic clock all freshness decisions run on —
        # virtual under the sim runtime, where lease churn
        # plays out in virtual seconds
        self._clock = clock or clockseam.monotonic
        self._leading = threading.Event()
        # Observed-record tracking (client-go's observedRecord /
        # observedTime): the lease's last-seen content and the local
        # monotonic time at which it was first seen in that state.
        # The pair is touched from both the acquire loop and the renew
        # thread, so it gets its own (racecheck-instrumented) lock.
        self._observed_lock = racecheck.make_lock(f"leaderelection.{name}")
        self._observed_record: Optional[tuple] = None
        self._observed_time: float = 0.0
        # observability: the held gauge is a live view over
        # the leading event; takeovers count when this elector bumps
        # lease_transitions
        election_metrics = instruments.leaderelection_instruments()
        election_metrics.is_leader.labels(name=name).set_function(
            lambda: 1.0 if self._leading.is_set() else 0.0
        )
        self._m_transitions = election_metrics.transitions.labels(name=name)

    def is_leader(self) -> bool:
        return self._leading.is_set()

    def observed_holder(self) -> str:
        """The holder identity of the last lease record this elector
        observed ("" before any observation) — shard membership uses
        it to distinguish a steal from a first claim."""
        with self._observed_lock:
            if self._observed_record is None:
                return ""
            return self._observed_record[0] or ""

    def set_leading(self, leading: bool) -> None:
        """Flip the leading flag from a cooperative driver (sim
        elector actors own the acquire/renew state machine themselves;
        the threaded ``run`` path manages this flag internally)."""
        if leading:
            self._leading.set()
        else:
            self._leading.clear()

    # ------------------------------------------------------------------
    def run(
        self,
        client: ClusterClient,
        run_fn: Callable[[threading.Event], None],
        stop: threading.Event,
        on_stopped_leading: Optional[Callable[[], None]] = None,
        on_new_leader: Optional[Callable[[str], None]] = None,
    ) -> None:
        """Block until leadership, run ``run_fn(stop)``, and keep the
        lease renewed in the background; if renewal fails past the
        renew deadline, fire ``on_stopped_leading`` (process exit in
        the CLI) and set ``stop``."""
        if not clockseam.threads_enabled():
            raise RuntimeError(
                "LeaderElection.run spawns the lease-renew thread; under "
                "the sim's cooperative executor use a _SimElector actor "
                "with set_leading() instead"
            )
        klog.infof("leader election id: %s", self.identity)
        last_reported_leader = ""
        while not stop.is_set():
            acquired, holder = self._try_acquire_or_renew(client)
            if acquired:
                break
            if holder and holder != last_reported_leader:
                last_reported_leader = holder
                klog.infof("new leader elected: %s", holder)
                if on_new_leader:
                    on_new_leader(holder)
            stop.wait(self.config.retry_period)
        if stop.is_set():
            return

        self._leading.set()
        klog.infof("successfully acquired lease %s/%s", self.namespace, self.name)

        renew_failed = threading.Event()

        def renew_loop():
            deadline = self._clock() + self.config.renew_deadline
            while not stop.is_set():
                acquired, _ = self._try_acquire_or_renew(client)
                if acquired:
                    deadline = self._clock() + self.config.renew_deadline
                elif self._clock() >= deadline:
                    klog.infof("leader lost: %s", self.identity)
                    self._leading.clear()
                    renew_failed.set()
                    stop.set()
                    if on_stopped_leading:
                        on_stopped_leading()
                    return

                stop.wait(self.config.retry_period)

        renewer = threading.Thread(target=renew_loop, daemon=True, name="lease-renew")
        renewer.start()
        try:
            run_fn(stop)
        finally:
            stop.set()
            renewer.join(timeout=self.config.retry_period + 1)
            # ReleaseOnCancel, but only AFTER the run callback has fully
            # returned: releasing earlier would let a standby start
            # reconciling while this process's workers are still
            # draining (split-brain).  No release when the lease was
            # lost — someone else already holds it.
            if not renew_failed.is_set():
                self._release(client)
            self._leading.clear()

    # ------------------------------------------------------------------
    def try_acquire_or_renew(self, client: ClusterClient) -> tuple[bool, str]:
        """One acquire-or-renew attempt, public for cooperative
        drivers (the sim runtime's elector actors step this explicitly
        instead of running the threaded loops above)."""
        acquired, holder = self._try_acquire_or_renew(client)
        try:
            from .sim import capture as capture_mod

            tap = capture_mod.active()
            if tap is not None:
                tap.record_lease_observation(
                    f"{self.namespace}/{self.name}", self.identity,
                    acquired, holder,
                )
        except Exception:
            pass  # the capture tap must never fail an election tick
        return acquired, holder

    def _try_acquire_or_renew(self, client: ClusterClient) -> tuple[bool, str]:
        """Returns (we_are_leader, current_holder)."""
        now = _now_rfc3339()
        try:
            lease = client.get("Lease", self.namespace, self.name)
        except NotFoundError:
            lease = Lease(
                metadata=ObjectMeta(
                    name=self.name, namespace=self.namespace,
                    annotations=self._annotations(),
                ),
                spec=LeaseSpec(
                    holder_identity=self.identity,
                    lease_duration_seconds=int(self.config.lease_duration),
                    acquire_time=now,
                    renew_time=now,
                    lease_transitions=0,
                ),
            )
            try:
                client.create("Lease", lease)
                return True, self.identity
            except AlreadyExistsError:
                return False, ""
        except Exception as err:
            klog.errorf("error retrieving lease %s/%s: %s", self.namespace, self.name, err)
            return False, ""

        record = (
            lease.spec.holder_identity,
            lease.spec.renew_time,
            lease.spec.acquire_time,
            lease.spec.lease_transitions,
        )
        with self._observed_lock:
            if record != self._observed_record:
                self._observed_record = record
                self._observed_time = self._clock()
            observed_time = self._observed_time

        holder = lease.spec.holder_identity or ""
        took_over = False
        if holder != self.identity:
            if holder:
                # Freshness on the LOCAL monotonic clock only: the lease
                # is live until one lease_duration after we last saw its
                # record change.  The holder's own renewTime timestamp is
                # deliberately ignored here — comparing a remote wall
                # clock to ours can elect two leaders under skew.
                duration = (
                    lease.spec.lease_duration_seconds or self.config.lease_duration
                )
                if observed_time + duration > self._clock():
                    return False, holder  # lease is held and fresh
            lease.spec.lease_transitions += 1
            lease.spec.acquire_time = now
            took_over = True
        lease.spec.holder_identity = self.identity
        lease.spec.renew_time = now
        lease.spec.lease_duration_seconds = int(self.config.lease_duration)
        annotations = self._annotations()
        if annotations:
            if lease.metadata.annotations is None:
                lease.metadata.annotations = {}
            lease.metadata.annotations.update(annotations)
        try:
            client.update("Lease", lease)
            if took_over:
                self._m_transitions.inc()
            return True, self.identity
        except (ConflictError, NotFoundError):
            return False, holder
        except Exception as err:
            klog.errorf("error updating lease: %s", err)
            return False, holder

    def _annotations(self) -> dict:
        if self.annotation_provider is None:
            return {}
        try:
            return dict(self.annotation_provider())
        except Exception:
            return {}

    def release(self, client: ClusterClient) -> None:
        """Public release for cooperative drivers (shard membership,
        the sim electors): clear the holder on clean shutdown."""
        self._release(client)

    def _release(self, client: ClusterClient) -> None:
        """ReleaseOnCancel analog: clear the holder on clean shutdown."""
        try:
            lease = client.get("Lease", self.namespace, self.name)
            if lease.spec.holder_identity == self.identity:
                lease.spec.holder_identity = None
                client.update("Lease", lease)
        except Exception:
            pass
