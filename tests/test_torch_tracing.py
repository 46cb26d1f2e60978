"""The port's wall-time instruments, each driven where its wait happens:
the read plane's single-flight loads and the callers parked behind
them, the pending-settle table from park to leaving it, every request
on the wire to the API server, the durable fake account's interprocess
lock, the in-process drift ticker (its ticks, the keys each enqueues
and its drain), the binding's weight sync, and the sampled reconcile
trace that carries their spans and an absolute start ``t0``.  Each case reads the family a per-layer
metric of the benchmark reads (``perfbench/metrics/``)."""

from __future__ import annotations

import importlib
import io
import pathlib
import sys
import threading
import time

import pytest

JOIN_S = 10.0


class FakeClock:
    def __init__(self, now: float = 1000.0):
        self.now = now

    def __call__(self) -> float:
        return self.now

    def advance(self, seconds: float) -> None:
        self.now += seconds


def _port(name: str):
    return importlib.import_module(f"agac_tpu_torch.{name}")


def _reading(name: str, registry=None, **labels) -> tuple[int, float]:
    """(count, sum) of the histogram ``name``'s series ``labels``."""
    registry = registry or _port("observability.metrics").registry()
    metric = registry.get(name)
    if metric is None:
        return 0, 0.0
    _, total, count = metric.labels(**labels).histogram_snapshot()
    return count, total


def _wait_until(condition, what: str) -> None:
    deadline = time.monotonic() + JOIN_S
    while not condition():
        assert time.monotonic() < deadline, what
        time.sleep(0.001)


# ---------------------------------------------------------------------------
# the read plane: a leader's load and one caller parked behind it
# ---------------------------------------------------------------------------


def _zones(cache_mod, clock):
    cache = cache_mod.HostedZoneCache(ttl=60.0, clock=clock)
    return cache, lambda loader: cache.zones(loader)


def _discovery(cache_mod, clock):
    cache = cache_mod.DiscoveryCache(ttl=60.0, clock=clock)
    return cache, lambda loader: cache.get(loader)


def _topology(cache_mod, clock):
    cache = cache_mod.AcceleratorTopologyCache(verify_ttl=60.0, clock=clock)

    def call(loader):
        return cache.chain("arn:a", lambda arn: (loader(), None), lambda listener: None)

    return cache, call


def _record_sets(cache_mod, clock):
    cache = cache_mod.RecordSetCache(ttl=60.0, clock=clock)
    return cache, lambda loader: cache.get("/hostedzone/Z1", loader)


CACHES = {"zones": _zones, "discovery": _discovery, "topology": _topology, "record_sets": _record_sets}


@pytest.mark.parametrize("name", sorted(CACHES))
def test_a_single_flight_load_and_its_waiter_are_timed(name):
    cache_mod = _port("cloudprovider.aws.cache")
    clock = FakeClock()
    cache, call = CACHES[name](cache_mod, clock)
    loads0 = _reading("agac_read_plane_load_seconds", cache=name)
    waits0 = _reading("agac_read_plane_wait_seconds", cache=name)
    entered, release = threading.Event(), threading.Event()

    def loader():
        entered.set()
        assert release.wait(JOIN_S)
        return []

    leader = threading.Thread(target=call, args=(loader,))
    leader.start()
    assert entered.wait(JOIN_S)
    waiter = threading.Thread(target=call, args=(lambda: pytest.fail("a second load"),))
    waiter.start()
    _wait_until(lambda: cache.waits == 1, "the second caller did not park")
    clock.advance(2.5)
    release.set()
    leader.join(JOIN_S)
    waiter.join(JOIN_S)
    assert not leader.is_alive() and not waiter.is_alive()
    loads = _reading("agac_read_plane_load_seconds", cache=name)
    waits = _reading("agac_read_plane_wait_seconds", cache=name)
    assert (loads[0] - loads0[0], waits[0] - waits0[0]) == (1, 1)
    assert loads[1] - loads0[1] == pytest.approx(2.5)
    assert waits[1] - waits0[1] == pytest.approx(2.5)


def test_a_failed_load_is_timed_too():
    cache_mod = _port("cloudprovider.aws.cache")
    clock = FakeClock()
    cache = cache_mod.DiscoveryCache(ttl=60.0, clock=clock)
    before = _reading("agac_read_plane_load_seconds", cache="discovery")

    def loader():
        clock.advance(0.75)
        raise RuntimeError("throttled")

    with pytest.raises(RuntimeError):
        cache.get(loader)
    after = _reading("agac_read_plane_load_seconds", cache="discovery")
    assert after[0] - before[0] == 1
    assert after[1] - before[1] == pytest.approx(0.75)


# ---------------------------------------------------------------------------
# the pending-settle table: park to ready, failed, expired
# ---------------------------------------------------------------------------


class _Queue:
    name = "tracing-test"

    def __init__(self):
        self.added: list = []

    def add(self, key):
        self.added.append(key)

    def forget(self, key):
        pass

    def add_rate_limited(self, key, reason=""):
        self.added.append(key)


OUTCOMES = ("ready", "failed", "expired", "replaced", "discarded")


@pytest.mark.parametrize("exit_by", ["ready", "failed", "expired", "replaced", "discarded", "reset"])
def test_a_settle_entry_observes_its_wait_as_it_leaves(exit_by):
    pending = _port("reconcile.pending")
    metrics = _port("observability.metrics")
    registry, clock, queue = metrics.MetricsRegistry(), FakeClock(), _Queue()
    table = pending.PendingSettleTable(clock=clock, registry=registry)
    answers = {"ready": pending.SETTLE_READY, "failed": pending.SETTLE_FAILED}
    table.register_poller(
        "accelerator", lambda tokens: {t: answers.get(exit_by, pending.SETTLE_PENDING) for t in tokens})
    wait = pending.SettleWait("accelerator", "arn:a", timeout=30.0)
    table.park("ns/a", queue, wait)
    clock.advance(4.0)
    if exit_by == "replaced":
        table.park("ns/a", queue, wait)
    elif exit_by == "discarded":
        table.discard("ns/a")
    elif exit_by == "reset":
        table.reset()
    else:
        table.poll_once()
    if exit_by == "expired":
        assert queue.added == []
        clock.advance(40.0)
        table.poll_once()
    assert queue.added == (["ns/a"] if exit_by in ("ready", "failed", "expired") else [])
    outcome = "discarded" if exit_by == "reset" else exit_by
    count, total = _reading("agac_pending_settle_wait_seconds", registry, group="accelerator", outcome=outcome)
    assert count == 1
    assert total == pytest.approx(44.0 if outcome == "expired" else 4.0)
    assert sum(
        _reading("agac_pending_settle_wait_seconds", registry, group="accelerator", outcome=o)[0]
        for o in OUTCOMES
    ) == 1


# ---------------------------------------------------------------------------
# the wire to the API server
# ---------------------------------------------------------------------------


class _Transport:
    """Answers each request with the next status of ``statuses`` (an
    exception instance is raised), ``delay_s`` after it was sent."""

    def __init__(self, statuses, delay_s: float = 0.0, body: bytes = b'{"message": "x"}'):
        self.statuses = list(statuses)
        self.delay_s = delay_s
        self.body = body
        self.sent: list[tuple[str, bool]] = []

    def __call__(self, method, url, headers, body, timeout, stream):
        self.sent.append((method, stream))
        time.sleep(self.delay_s)
        status = self.statuses.pop(0)
        if isinstance(status, Exception):
            raise status
        if stream:
            return status, _SlowStream()
        return status, self.body


class _SlowStream(io.BytesIO):
    """A watch stream whose first read takes a while and ends it."""

    def readline(self, *args):
        time.sleep(0.2)
        return b""


class _Tokens:
    def __init__(self):
        self.invalidated = 0

    def __call__(self):
        return f"token-{self.invalidated}"

    def invalidate(self):
        self.invalidated += 1


def _get(client):
    try:
        client.get("Service", "default", "web")
    except Exception:
        pass


def _watch(client):
    list(client.watch("Service", "", stop=lambda: False))


def _delete(client):
    try:
        client.delete("Service", "default", "web")
    except Exception:
        pass


WIRE_CASES = {
    "get-2xx": ([200], _get, {("GET", "2xx"): 1}),
    "get-4xx": ([404], _get, {("GET", "4xx"): 1}),
    "delete-5xx": ([500], _delete, {("DELETE", "5xx"): 1}),
    "watch": ([200], _watch, {("WATCH", "2xx"): 1}),
    "retried-401": ([401, 200], _get, {("GET", "4xx"): 1, ("GET", "2xx"): 1}),
    "no-response": ([ConnectionRefusedError("refused")], _get, {("GET", "error"): 1}),
}
WIRE_KEYS = sorted({key for _, _, want in WIRE_CASES.values() for key in want})


@pytest.mark.parametrize("case", sorted(WIRE_CASES))
def test_every_wire_request_is_timed_by_verb_and_status_class(case):
    rest = _port("cluster.rest")
    statuses, call, want = WIRE_CASES[case]
    transport = _Transport(statuses, delay_s=0.02, body=b'{"metadata": {"name": "web"}}')
    tokens = _Tokens()
    client = rest.RestClusterClient("http://apiserver.test", transport=transport, token_provider=tokens)
    before = {key: _reading("agac_apiserver_request_duration_seconds", verb=key[0], code=key[1])
              for key in WIRE_KEYS}
    call(client)
    assert len(transport.sent) == sum(want.values())
    for key in WIRE_KEYS:
        count, total = _reading("agac_apiserver_request_duration_seconds", verb=key[0], code=key[1])
        assert count - before[key][0] == want.get(key, 0), key
        if key in want:
            # a watch is timed to its response headers: its stream's slow
            # read is not in the observation
            assert 0.02 * want[key] <= total - before[key][1] < 0.19 * want[key], key


# ---------------------------------------------------------------------------
# the durable fake account's interprocess lock
# ---------------------------------------------------------------------------


def _lock_reading():
    return {phase: _reading("agac_fake_aws_lock_seconds", phase=phase) for phase in ("wait", "held")}


def _lock_delta(before, after, phase):
    return after[phase][0] - before[phase][0], after[phase][1] - before[phase][1]


@pytest.mark.parametrize("call", ["mutating", "settling-read", "reentrant"])
def test_the_fake_accounts_lock_wait_and_hold_are_timed_at_depth_zero(tmp_path, call):
    fake = _port("cloudprovider.aws.fake_backend")
    types = _port("cloudprovider.aws.types")
    state = str(tmp_path / "aws-state.json")
    backend = fake.FileBackedFakeAWSBackend(state, settle_describes=2)
    other = fake.FileBackedFakeAWSBackend(state, settle_describes=2)
    arn = backend.create_accelerator("a", "IPV4", True, [types.Tag("n", "a")]).accelerator_arn
    holding, release = threading.Event(), threading.Event()

    def hold():
        # another writer of the account holds the lock for 0.2 s
        with other._interprocess_write_lock():
            holding.set()
            release.wait(JOIN_S)
            time.sleep(0.2)

    unheld = _lock_reading()
    holder = threading.Thread(target=hold)
    holder.start()
    assert holding.wait(JOIN_S)
    before = _lock_reading()
    # nothing is observed while the lock is held
    assert before == unheld
    release.set()
    if call == "mutating":
        backend.update_accelerator(arn, name="b")
    elif call == "settling-read":
        assert backend.describe_accelerator(arn).status == "IN_PROGRESS"
    else:
        with backend._interprocess_write_lock():
            backend.update_accelerator(arn, name="b")
            backend.update_accelerator(arn, name="c")
    holder.join(JOIN_S)
    after = _lock_reading()
    waits, waited = _lock_delta(before, after, "wait")
    holds, held = _lock_delta(before, after, "held")
    # one observation of each phase per outermost acquisition, made on
    # release: this call's and the holder's (another backend object, one
    # process)
    assert (waits, holds) == (2, 2)
    assert 0.1 <= waited < 5.0
    assert 0.2 <= held < 5.0


# ---------------------------------------------------------------------------
# the sampled per-item trace
# ---------------------------------------------------------------------------


def test_a_sampled_trace_carries_read_plane_and_apiserver_spans_and_t0():
    trace = _port("observability.trace")
    cache_mod = _port("cloudprovider.aws.cache")
    rest = _port("cluster.rest")
    clock, emitted = FakeClock(5000.125), []
    tracer = trace.Tracer(sample_rate=1.0, clock=clock, emit=emitted.append)
    zones = cache_mod.HostedZoneCache(ttl=60.0, clock=clock)
    client = rest.RestClusterClient("http://apiserver.test", transport=_Transport([200, 404]))
    started = clock()
    current = tracer.start("service", "ns/web", queue_wait=0.5)

    def loader():
        clock.advance(1.5)
        return []

    with trace.activate(current):
        zones.zones(loader)
        _get(client)
        _delete(client)
    clock.advance(0.25)
    tracer.finish(current)
    (payload,) = emitted
    assert payload["t0"] == started
    assert payload["dur"] == pytest.approx(1.75)
    spans = {s["name"]: s for s in payload["spans"]}
    assert spans["read-plane-load:zones"]["dur"] == pytest.approx(1.5)
    assert spans["read-plane-load:zones"]["at"] == pytest.approx(0.0)
    assert spans["apiserver:GET"]["attrs"] == {"code": "2xx"}
    assert spans["apiserver:DELETE"]["attrs"] == {"code": "4xx"}
    assert {"queue-wait", "read-plane-load:zones", "apiserver:GET", "apiserver:DELETE"} == set(spans)


def test_the_unsampled_path_allocates_no_span(monkeypatch):
    trace = _port("observability.trace")
    cache_mod = _port("cloudprovider.aws.cache")
    rest = _port("cluster.rest")
    made = []
    monkeypatch.setattr(trace, "Span", lambda *args, **kwargs: made.append(args))
    tracer = trace.Tracer(sample_rate=0.0)
    current = tracer.start("service", "ns/web")
    assert current is None
    zones = cache_mod.HostedZoneCache(ttl=60.0, clock=FakeClock())
    client = rest.RestClusterClient("http://apiserver.test", transport=_Transport([200]))
    with trace.activate(current):
        zones.zones(lambda: [])
        _get(client)
        trace.record("read-plane-wait:zones", 0.0, 1.0)
    tracer.finish(current)
    assert made == [] and tracer.emitted_total == 0


# ---------------------------------------------------------------------------
# the in-process drift ticker: ticks, keys per tick, the tick's drain
# ---------------------------------------------------------------------------

DRIFT_FAMILIES = ("agac_drift_ticks_total", "agac_drift_tick_keys_total", "agac_drift_tick_drain_seconds")


def _counted(name: str, **labels) -> float:
    metric = _port("observability.metrics").registry().get(name)
    return 0.0 if metric is None else metric.labels(**labels).value()


def test_a_ticks_drain_waits_for_a_reconcile_begun_after_its_enqueue():
    common = _port("controllers.common")
    workqueue = _port("reconcile.workqueue")
    name = "drift-drain-test"
    queue = workqueue.RateLimitingQueue(name=name)
    drains0 = _reading("agac_drift_tick_drain_seconds", controller=name)
    ran0 = _counted("agac_drift_ticks_total", controller=name, outcome="ran")
    keys0 = _counted("agac_drift_tick_keys_total", controller=name)
    queue.add("a")
    running, _ = queue.get()  # a reconcile of "a" begun before the tick
    tick = common._DriftTick(name)
    for key in ("a", "b"):
        queue.add(key)
    tick.close()
    queue.add("c")  # after the tick's enqueue loop: not the tick's
    queue.done(running)
    assert _reading("agac_drift_tick_drain_seconds", controller=name) == drains0
    b, _ = queue.get()
    time.sleep(0.2)  # the slowest of the tick's reconciles
    queue.done(b)
    assert (b, _reading("agac_drift_tick_drain_seconds", controller=name)) == ("b", drains0)
    c, _ = queue.get()
    assert c == "c"
    again, _ = queue.get()  # "a" again: requeued when its earlier reconcile ended
    assert again == "a"
    queue.done(again)
    count, total = _reading("agac_drift_tick_drain_seconds", controller=name)
    assert count - drains0[0] == 1
    assert 0.2 <= total - drains0[1] < 5.0
    queue.done(c)
    assert _reading("agac_drift_tick_drain_seconds", controller=name)[0] == count
    assert _counted("agac_drift_ticks_total", controller=name, outcome="ran") - ran0 == 1
    assert _counted("agac_drift_tick_keys_total", controller=name) - keys0 == 2
    queue.shutdown()


def test_a_ticks_drain_is_observed_once_under_concurrent_finishes():
    common = _port("controllers.common")
    name = "drift-stress-test"
    before = _reading("agac_drift_tick_drain_seconds", controller=name)[0]
    workers, per = 16, 400
    released = threading.Semaphore(0)
    tick = common._DriftTick(name)

    def finish():
        assert released.acquire(timeout=JOIN_S)
        for _ in range(per):
            tick.finished()

    threads = [threading.Thread(target=finish) for _ in range(workers)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for thread in threads:
            thread.start()
        # the ticker goes on enqueueing while workers finish earlier keys
        for i in range(workers * per):
            tick.expect()
            if i % per == per - 1:
                released.release()
        tick.close()
        for thread in threads:
            thread.join(JOIN_S)
    finally:
        sys.setswitchinterval(interval)
    assert not any(thread.is_alive() for thread in threads)
    assert _reading("agac_drift_tick_drain_seconds", controller=name)[0] - before == 1


def test_a_shed_tick_is_counted_as_shed(monkeypatch):
    common = _port("controllers.common")
    slo = _port("observability.slo")
    name = "drift-shed-test"
    monkeypatch.setattr(slo, "should_shed", lambda stage: stage == "drift-resync")
    enqueued = []
    stop = threading.Event()
    thread = common.start_drift_resync(name, stop, 0.01, [([1, 2], lambda obj: True, enqueued.append)])
    try:
        _wait_until(lambda: _counted("agac_drift_ticks_total", controller=name, outcome="shed") >= 2,
                    "no tick was shed")
    finally:
        stop.set()
        thread.join(JOIN_S)
    assert not thread.is_alive()
    assert enqueued == []
    assert _counted("agac_drift_ticks_total", controller=name, outcome="ran") == 0


def test_an_in_process_managers_ticks_enqueue_every_managed_object_and_drain_once():
    import chip_smoke

    pkg = chip_smoke.load("agac_tpu_torch")
    fleet = chip_smoke.Fleet(pkg, 20)
    period = 0.5
    queue = dict(workers=4, queue_qps=1000.0, queue_burst=1000, drift_resync_period=period)
    config = pkg.manager.ControllerConfig(
        global_accelerator=pkg.controllers.GlobalAcceleratorConfig(**queue),
        route53=pkg.controllers.Route53Config(**queue),
        endpoint_group_binding=pkg.controllers.EndpointGroupBindingConfig(**queue),
    )
    managed = {
        "global-accelerator-controller": fleet.n + fleet.n_ing,
        "route53-controller": fleet.n + fleet.n_ing,
        "endpoint-group-binding-controller": fleet.n_egb,
    }
    before = {
        c: (_counted("agac_drift_ticks_total", controller=c, outcome="ran"),
            _counted("agac_drift_tick_keys_total", controller=c),
            _reading("agac_drift_tick_drain_seconds", controller=c)[0])
        for c in managed
    }

    def delta(controller):
        ticks, keys, drains = before[controller]
        return (_counted("agac_drift_ticks_total", controller=controller, outcome="ran") - ticks,
                _counted("agac_drift_tick_keys_total", controller=controller) - keys,
                _reading("agac_drift_tick_drain_seconds", controller=controller)[0] - drains)

    aws, stop = fleet.aws, threading.Event()
    pkg.manager.Manager(resync_period=30.0).run(
        fleet.cluster, config, stop, block=False,
        cloud_factory=lambda region: pkg.aws.AWSDriver(aws, aws, aws, accelerator_missing_retry=0.05),
    )
    try:
        fleet.create_objects()
        deadline = time.monotonic() + 60.0
        while True:
            readings = {}
            for controller in managed:
                drains = delta(controller)[2]  # read first: a tick may start between the reads
                ticks, keys, _ = delta(controller)
                readings[controller] = (ticks, keys, drains)
            # on a busy host a tick may still be draining when the next
            # starts: read once at most one tick of each controller is open
            if fleet.converged() and all(d >= 3 and d >= t - 1 for t, _, d in readings.values()):
                break
            assert time.monotonic() < deadline, readings
            time.sleep(0.05)
    finally:
        stop.set()
    for controller, (ticks, keys, drains) in readings.items():
        # every tick enqueues every managed object (a tick counted as it
        # starts may not have finished its enqueue loop yet)
        assert keys in (ticks * managed[controller], (ticks - 1) * managed[controller]), controller
        assert ticks - 1 <= drains <= ticks, controller


@pytest.mark.parametrize("family", DRIFT_FAMILIES)
def test_the_drift_families_stay_out_of_the_reference_catalog(family):
    # test_torch_observability holds every PORT_ONLY family out of register_all
    assert family in dict(_port("observability.instruments").PORT_ONLY)
    docs = (pathlib.Path(__file__).resolve().parent.parent / "docs" / "operations.md").read_text()
    assert family not in docs


# ---------------------------------------------------------------------------
# the binding's weight sync: written, or skipped where the pass already
# saw the spec's weight in AWS
# ---------------------------------------------------------------------------


def test_the_weight_sync_counter_is_port_only_and_counts_each_outcome():
    from .test_torch_binding_weight import World

    family = "agac_binding_weight_sync_total"
    instruments = _port("observability.instruments")
    metrics = _port("observability.metrics")
    assert family in dict(instruments.PORT_ONLY)
    assert instruments.register_all(metrics.MetricsRegistry()).get(family) is None
    docs = (pathlib.Path(__file__).resolve().parent.parent / "docs" / "operations.md").read_text()
    assert family not in docs
    world = World()
    try:
        world.bind("a", 100)
        assert world.measure("a")[1:] == (0, 1)  # new: the add set the weight
        world.edit_weight("a", 200)
        assert world.measure("a")[1:] == (1, 0)  # edited: written
    finally:
        world.close()
