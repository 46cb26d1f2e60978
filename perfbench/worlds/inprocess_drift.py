"""The in-process deployment with drift resync on: ``inprocess`` with
every controller's ticker at the configuration's period, a window that
starts at a fixed phase of the tickers, and tampers made in AWS behind
the controllers' back.

**Phase lock.**  The tickers start with the program, so tick k falls
about k periods after ``start()``.  ``settle()`` waits until
``tick_index`` + 1 periods less a lead have passed since then (or a
whole period more, where the base population converged later): the
window's first tick falls the lead into it, the next one a period
later.  The lead is ``first_tick_s``, or a quarter of the window where
that is less (the last change's due time stands for the window's
length), so that a short window holds a tick too.  Only the benchmark's
clock decides it, so a program without the ticker's instruments runs
the cell as well.  Before the wait, ``warm_profiler()`` takes the
profiler's cold start out of the gap between the lock and the window.
The configuration's discovery TTL, 5 s under the period, puts the
snapshot's reloads at a fixed phase of the ticks too: a disable made
between two ticks is seen by the second.

**Tampers** (``perfbench/actions/tamper.py``) edit the in-memory AWS
directly, not through the shaping proxy, as an operator in the console
would: the proxy's counts stay the program's own.  Each target is named
in the mix and the traffic never changes it, so its item is repaired
once it reads as the reference expects it from the base record.

On ``close()`` one line goes to standard error, ``perfbench: drift
{...}``: the seconds from the program's start to the base population
settled, to ``arm()`` and to the window's start (its first change's
apply less its due time); each controller's ticks in seconds from the
window's start (read from ``agac_drift_ticks_total`` where the program
has it); and each tamper's seconds to its repair, as the world read it
every ``REPAIR_POLL_S``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import re
import sys
import threading
import time
import types

from perfbench import reference
from perfbench.worlds import inprocess

TICKS = "agac_drift_ticks_total"
TICK_POLL_S = 0.05
REPAIR_POLL_S = 0.5
TAMPERED_WEIGHT = 7
TAMPERED_ALIAS = "tampered.example.net."
_CONTROLLER = re.compile(r'controller="([^"]*)"')


class World(inprocess.World):
    def __init__(self, config: dict, population, record: dict, changes: list[dict]):
        super().__init__(config, population, record, changes)
        self.period = config["settings"]["drift_resync_period_s"]
        lock = config["phase_lock"]
        self.tick_index = lock["tick_index"]
        self.lead = min(lock["first_tick_s"], max((c["due"] for c in changes), default=0.0) / 4)
        self.expected = reference.expected_world(record)
        self.record = record
        self.started = self.settled_at = self.armed_at = self.window_at = None
        self.ticks: dict[str, list[float]] = {}
        self.tampers: list[dict] = []
        self._watch = threading.Thread(target=self._watch_loop, name="perfbench-drift-watch", daemon=True)

    # -- the program -----------------------------------------------------
    def start(self) -> None:
        # the base world builds its three controller configurations from
        # these: each with the ticker at the configuration's period
        c = self.port.controllers
        self.port.controllers = types.SimpleNamespace(**{
            name: functools.partial(getattr(c, name), drift_resync_period=self.period)
            for name in ("GlobalAcceleratorConfig", "Route53Config", "EndpointGroupBindingConfig")
        })
        self.started = time.monotonic()
        super().start()
        self._watch.start()

    def settle(self, quiet_s: float = 1.0, limit_s: float = 15.0) -> None:
        super().settle(quiet_s, limit_s)
        self.settled_at = time.monotonic()
        if self.period <= 0:  # the tickers are off: no phase to lock to
            return
        warm_profiler()
        at = self.started + (self.tick_index + 1) * self.period - self.lead
        late = 0
        while time.monotonic() > at:
            at += self.period
            late += 1
        if late:
            print(f"perfbench: the base population converged after tick {self.tick_index}: "
                  f"the window starts {late} period(s) later", file=sys.stderr)
        time.sleep(at - time.monotonic())

    def arm(self, on: bool = True) -> None:
        super().arm(on)
        if on:
            self.armed_at, self.window_at = time.monotonic(), None

    def apply(self, change: dict) -> None:
        if self.window_at is None:  # the window's first change: its start, from its due time
            self.window_at = time.monotonic() - change["due"]
        super().apply(change)

    def close(self) -> None:
        super().close()
        if self._watch.ident is not None:  # started
            self._watch.join(timeout=5.0)
        at = self.window_at or self.started or time.monotonic()
        since = lambda t: None if t is None else round(t - self.started, 3)
        print("perfbench: drift " + json.dumps({
            "settled_s": since(self.settled_at),
            "armed_s": since(self.armed_at),
            "window_s": since(self.window_at),
            "ticks_s": {c: [round(t - at, 3) for t in ts] for c, ts in sorted(self.ticks.items())},
            "tampers": [
                {"kind": t["kind"], "target": t["target"], "at_s": round(t["at"] - at, 3),
                 "repaired_after_s": None if t["repaired"] is None else round(t["repaired"] - t["at"], 3)}
                for t in self.tampers
            ],
        }), file=sys.stderr)

    # -- what the world sees of the ticks and the repairs -----------------
    def _watch_loop(self) -> None:
        seen = self._tick_counts()  # an earlier run in this process counted some
        next_read = 0.0
        while not self.stop.wait(TICK_POLL_S):
            now = time.monotonic()
            for controller, value in self._tick_counts().items():
                if value > seen.get(controller, 0.0):
                    self.ticks.setdefault(controller, []).append(now)
                seen[controller] = value
            open_ = [t for t in list(self.tampers) if t["repaired"] is None]
            if open_ and now >= next_read:
                next_read = now + REPAIR_POLL_S
                items = self.reader.read({t["item"] for t in open_})
                for t in open_:
                    if items.get(t["item"]) == self.expected[t["item"]]:
                        t["repaired"] = now

    def _tick_counts(self) -> dict[str, float]:
        """``agac_drift_ticks_total{outcome="ran"}`` by controller; empty
        where the program has no such counter."""
        metric = self.port.metrics.registry().get(TICKS)
        return {
            _CONTROLLER.search(labels).group(1): value
            for _, labels, value in (metric.samples() if metric is not None else ())
            if 'outcome="ran"' in labels
        }

    # -- the tampers -----------------------------------------------------
    def tamper(self, kind: str, target: str) -> None:
        """Apply tamper ``kind`` to ``target``: an owner tag (``disable``,
        ``listener``), a binding's key (``weight``, ``endpoint``) or a
        hostname (``record-edit``, ``record-delete``)."""
        item = getattr(self, "_" + kind.replace("-", "_"))(target)
        self.tampers.append({"kind": kind, "target": target, "item": item, "at": time.monotonic(),
                             "repaired": None})

    def _accelerator(self, owner: str) -> str:
        (arn,) = [arn for arn, o in self.aws.accelerator_owners().items() if o == owner]
        return arn

    def _disable(self, owner: str) -> tuple:
        self.aws.update_accelerator(self._accelerator(owner), enabled=False)
        return ("chain", owner)

    def _listener(self, owner: str) -> tuple:
        """Delete the chain's listener, its endpoint groups first, as
        AWS requires."""
        listeners, _ = self.aws.list_listeners(self._accelerator(owner), 100, None)
        for listener in listeners:
            groups, _ = self.aws.list_endpoint_groups(listener.listener_arn, 100, None)
            for group in groups:
                self.aws.delete_endpoint_group(group.endpoint_group_arn)
            self.aws.delete_listener(listener.listener_arn)
        return ("chain", owner)

    def _binding(self, key: str) -> tuple[str, str, tuple]:
        """A binding's endpoint group, its Service's load balancer in it,
        and the group's chain item."""
        entry = self.record["bindings"][key]
        service = self.record["services"][f"{entry['namespace']}/{entry['service']}"]
        (lb,) = self.aws.describe_load_balancers([service["lb"]])
        tag = reference.owner("service", f"{reference.EXTERNAL_NAMESPACE}/{entry['group']}")
        return self.group_arns[entry["group"]], lb.load_balancer_arn, ("chain", tag)

    def _weight(self, key: str) -> tuple:
        group, endpoint, item = self._binding(key)
        t = self.port.awstypes
        self.aws.update_endpoint_group(group, [
            t.EndpointConfiguration(
                endpoint_id=d.endpoint_id,
                weight=TAMPERED_WEIGHT if d.endpoint_id == endpoint else d.weight,
                client_ip_preservation_enabled=d.client_ip_preservation_enabled,
            )
            for d in self.aws.describe_endpoint_group(group).endpoint_descriptions
        ])
        return item

    def _endpoint(self, key: str) -> tuple:
        group, endpoint, item = self._binding(key)
        self.aws.remove_endpoints(group, [endpoint])
        return item

    def _record(self, hostname: str, rtype: str):
        """The zone and the record set ``rtype`` of ``hostname``."""
        name = hostname + "."
        for zone in self.aws.all_hosted_zone_ids():
            for record in self.aws.records_in_zone(zone):
                if record.name == name and record.type == rtype:
                    return zone, record
        raise LookupError(f"no {rtype} record of {hostname}")

    def _record_edit(self, hostname: str) -> tuple:
        zone, record = self._record(hostname, "A")
        alias = dataclasses.replace(record.alias_target, dns_name=TAMPERED_ALIAS)
        edited = dataclasses.replace(record, alias_target=alias, resource_records=[])
        self.aws.change_resource_record_sets(zone, [self.port.awstypes.Change("UPSERT", edited)])
        return ("record", hostname)

    def _record_delete(self, hostname: str) -> tuple:
        zone, record = self._record(hostname, "TXT")
        self.aws.change_resource_record_sets(zone, [self.port.awstypes.Change("DELETE", record)])
        return ("record", hostname)


def warm_profiler() -> None:
    """Start and stop ``torch.profiler`` once, where the card is there.
    The harness starts it between the measured span's first reading and
    the window's first change (``perfbench/devices.py``); cold, that
    start sets up CUPTI and took 8-17 s on an NVIDIA H100 host, which would put the
    window that much behind the tickers' phase.  Warm, it takes
    milliseconds."""
    import torch

    if not torch.cuda.is_available():
        return
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities):
        pass
