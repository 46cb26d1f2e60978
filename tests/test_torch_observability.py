"""Differential check of the port's metrics plane: the same metric
operations on each package's ``MetricsRegistry`` give the same
Prometheus exposition text, and the full instrument catalog (every
family ``register_all`` builds) has the same names, types, labels and
help text in both.  Metric names are part of the port's public
surface: dashboards and alerts written for the reference must read the
port unchanged.  The port's own families (``instruments.PORT_ONLY``,
the wall-time histograms of its waits) stay outside ``register_all``,
each registered by its own accessor alone."""

from __future__ import annotations

import importlib

import pytest


def _metrics(package: str):
    return importlib.import_module(f"{package}.observability.metrics")


def _script(metrics) -> str:
    reg = metrics.MetricsRegistry(max_series=4)
    calls = reg.counter("agac_test_calls_total", "Calls by op", labels=("op", "outcome"))
    calls.labels(op="CreateAccelerator", outcome="success").inc()
    calls.labels(op="CreateAccelerator", outcome="success").inc(2)
    calls.labels(op="DeleteListener", outcome="Throttling\n\"x\"").inc()
    # past the cardinality cap: collapses onto the overflow series
    for i in range(6):
        calls.labels(op=f"Op{i}", outcome="success").inc()
    depth = reg.gauge("agac_test_depth", "Queue depth")
    depth.inc(5)
    depth.dec(2)
    live = reg.gauge("agac_test_live", "A callback gauge", labels=("queue",))
    live.labels(queue="service").set_function(lambda: 7.5)
    latency = reg.histogram(
        "agac_test_latency_seconds", "Latency", labels=("stage",), buckets=(0.01, 0.1, 1.0)
    )
    for value in (0.005, 0.05, 0.5, 5.0, 0.1):
        latency.labels(stage="mutate").observe(value)
    return reg.render()


def test_same_operations_give_the_same_exposition():
    ref, port = _script(_metrics("agac_tpu")), _script(_metrics("agac_tpu_torch"))
    assert "agac_test_latency_seconds_bucket" in ref
    assert port == ref
    assert _metrics("agac_tpu_torch").parse_text(port) == _metrics("agac_tpu").parse_text(ref)


def _port_only() -> dict:
    instruments = importlib.import_module("agac_tpu_torch.observability.instruments")
    return dict(instruments.PORT_ONLY)


@pytest.mark.parametrize("view", ["describe", "render"])
def test_instrument_catalog_is_identical(view):
    def catalog(package):
        metrics = _metrics(package)
        instruments = importlib.import_module(f"{package}.observability.instruments")
        return getattr(instruments.register_all(metrics.MetricsRegistry()), view)()

    ref, port = catalog("agac_tpu"), catalog("agac_tpu_torch")
    assert len(ref) > 0
    assert port == ref


@pytest.mark.parametrize("family", sorted(_port_only()))
def test_port_only_family_is_registered_by_its_accessor_alone(family):
    metrics = _metrics("agac_tpu_torch")
    instruments = importlib.import_module("agac_tpu_torch.observability.instruments")
    registry = metrics.MetricsRegistry()
    _port_only()[family](registry)
    assert [d["name"] for d in registry.describe()] == [family]
    # outside the generated catalog, so docs/operations.md's block stays the reference's
    assert instruments.register_all(metrics.MetricsRegistry()).get(family) is None
    assert importlib.import_module("agac_tpu.observability.instruments").register_all(
        _metrics("agac_tpu").MetricsRegistry()).get(family) is None
