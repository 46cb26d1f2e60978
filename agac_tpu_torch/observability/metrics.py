"""Thread-safe metrics registry with Prometheus text exposition.

The stack had four subsystems each hoarding private counter dicts
(read-plane ``stats()``, health-plane ``_counters``, GC totals, bench
op counts) with no uniform export.  This module is the one place
counters live: ``Counter`` / ``Gauge`` / ``Histogram`` primitives
behind a ``MetricsRegistry`` that renders the Prometheus text format
(version 0.0.4) for the ``/metrics`` endpoint on the manager's health
server.

Design constraints, in order:

- **Stdlib only.**  CI and the bare container never pip-install a
  prometheus client; the text format is simple enough to emit
  directly.
- **Construction goes through the registry.**  ``registry.counter(...)``
  is get-or-create (same name → same metric; a type/label mismatch is
  a programming error and raises).  Direct ``Counter(...)``
  construction outside this module is flagged by the
  ``unregistered-metric`` lint rule — an unregistered metric is
  invisible to ``/metrics``, which is exactly the private-dict drift
  this subsystem deletes.
- **Bounded label cardinality.**  A metric accepts at most
  ``max_series`` distinct label sets; past the cap every new label set
  collapses into one ``overflow`` series (and the drop is counted), so
  a key or error-code explosion can never OOM the registry or melt the
  scrape.  Label *names* are fixed at registration; label *values* are
  strings.
- **Callback samples.**  A gauge child can carry a callable evaluated
  at collection time (``set_function``) so live state — circuit state,
  AIMD rate, queue depth of an object that already owns the number —
  is exposed as a view instead of a copied-and-drifting dict.

There is one process-global registry (``registry()``), the default for
the hot-path instruments; components that tests instantiate many times
per process (HealthTracker, GarbageCollector, Manager) take an
explicit ``registry`` parameter instead and default to a private one.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Iterable, Optional

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

# Prometheus client_golang's default buckets: spans the 5 ms..10 s
# range a control-plane RPC or reconcile actually occupies.
DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# distinct label sets per metric before collapsing into the overflow
# series; generous for legitimate label spaces (ops x outcomes,
# queues, services) while bounding a runaway (keys, raw error text)
DEFAULT_MAX_SERIES = 256

_OVERFLOW = "overflow"


def _escape_label_value(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _format_value(value: float) -> str:
    if value != value:  # NaN
        return "NaN"
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def _render_labels(names: tuple[str, ...], values: tuple[str, ...],
                   extra: tuple[tuple[str, str], ...] = ()) -> str:
    pairs = list(zip(names, values)) + list(extra)
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in pairs)
    return "{" + body + "}"


class _Child:
    """One labeled series.  Counters/gauges hold a float behind a
    lock; a gauge may instead hold a callback evaluated at collection
    time.  Histogram children hold bucket counts + sum + count."""

    __slots__ = ("_metric", "_values", "_value", "_sum", "_count", "_fn", "_lock")

    def __init__(self, metric: "Metric"):
        self._metric = metric
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None
        if metric.type == HISTOGRAM:
            self._values = [0] * len(metric.buckets)
            self._sum = 0.0
            self._count = 0

    # -- counter/gauge -------------------------------------------------
    def inc(self, amount: float = 1.0) -> None:
        if self._metric.type == COUNTER and amount < 0:
            raise ValueError(f"{self._metric.name}: counters only go up")
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        if self._metric.type != GAUGE:
            raise ValueError(f"{self._metric.name}: only gauges can dec()")
        with self._lock:
            self._value -= amount

    def set(self, value: float) -> None:
        if self._metric.type != GAUGE:
            raise ValueError(f"{self._metric.name}: only gauges can set()")
        with self._lock:
            self._value = float(value)
            self._fn = None

    def set_function(self, fn: Callable[[], float]) -> None:
        """Expose live state as a collection-time view — the
        single-source-of-truth seam for circuit state, AIMD rate and
        queue depth (the owner keeps the number; the registry reads
        it, never copies it)."""
        if self._metric.type != GAUGE:
            raise ValueError(f"{self._metric.name}: only gauges take callbacks")
        with self._lock:
            self._fn = fn

    def value(self) -> float:
        with self._lock:
            fn = self._fn
        if fn is not None:
            try:
                return float(fn())
            except Exception:
                return float("nan")
        with self._lock:
            return self._value

    # -- histogram -----------------------------------------------------
    def observe(self, value: float) -> None:
        if self._metric.type != HISTOGRAM:
            raise ValueError(f"{self._metric.name}: only histograms observe()")
        buckets = self._metric.buckets
        with self._lock:
            for i, bound in enumerate(buckets):
                if value <= bound:
                    self._values[i] += 1
            self._sum += value
            self._count += 1

    def histogram_snapshot(self) -> tuple[list[int], float, int]:
        """(per-bucket non-cumulative-free cumulative counts, sum,
        count) — buckets are already cumulative by construction."""
        with self._lock:
            return list(self._values), self._sum, self._count


class Metric:
    """One metric family: name + type + help + fixed label names, and
    the labeled children.  Never construct directly — go through
    ``MetricsRegistry`` (enforced by the unregistered-metric lint
    rule)."""

    def __init__(
        self,
        name: str,
        help: str,
        type: str,
        label_names: tuple[str, ...] = (),
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
        max_series: int = DEFAULT_MAX_SERIES,
    ):
        self.name = name
        self.help = help
        self.type = type
        self.label_names = tuple(label_names)
        self.buckets = tuple(sorted(buckets)) if type == HISTOGRAM else ()
        self.max_series = max(1, max_series)
        self.dropped_series = 0  # label sets collapsed into overflow
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], _Child] = {}
        if not self.label_names:
            # an unlabeled metric IS its single child: metric.inc()
            self._children[()] = _Child(self)

    # unlabeled convenience: delegate to the () child
    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self.labels().dec(amount)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def set_function(self, fn: Callable[[], float]) -> None:
        self.labels().set_function(fn)

    def observe(self, value: float) -> None:
        self.labels().observe(value)

    def value(self) -> float:
        return self.labels().value()

    def labels(self, **labels: str) -> _Child:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, got "
                f"{tuple(sorted(labels))}"
            )
        key = tuple(str(labels[name]) for name in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is not None:
                return child
            if len(self._children) >= self.max_series:
                # cardinality cap: collapse into ONE overflow series so
                # a label-value explosion is visible but bounded
                self.dropped_series += 1
                overflow_key = tuple(_OVERFLOW for _ in self.label_names)
                child = self._children.get(overflow_key)
                if child is None:
                    child = self._children[overflow_key] = _Child(self)
                return child
            child = self._children[key] = _Child(self)
            return child

    def samples(self) -> Iterable[tuple[str, str, float]]:
        """(name+labels, "", value) sample lines for exposition."""
        with self._lock:
            children = sorted(self._children.items())
        for values, child in children:
            if self.type == HISTOGRAM:
                counts, total, count = child.histogram_snapshot()
                for bound, bucket_count in zip(self.buckets, counts):
                    yield (
                        self.name + "_bucket",
                        _render_labels(
                            self.label_names, values, (("le", _format_value(bound)),)
                        ),
                        bucket_count,
                    )
                yield (
                    self.name + "_bucket",
                    _render_labels(self.label_names, values, (("le", "+Inf"),)),
                    count,
                )
                yield (self.name + "_sum", _render_labels(self.label_names, values), total)
                yield (self.name + "_count", _render_labels(self.label_names, values), count)
            else:
                yield (self.name, _render_labels(self.label_names, values), child.value())


# The constructor aliases the lint rule knows: all construction flows
# through MetricsRegistry below, so these exist for isinstance checks
# and the rule's vocabulary, not for direct use.
Counter = Metric
Gauge = Metric
Histogram = Metric


class MetricsRegistry:
    """Get-or-create registry + text exposition.

    ``counter``/``gauge``/``histogram`` return the existing metric when
    the name is already registered (type/labels must match — a mismatch
    is a bug, not a merge).  ``render()`` produces the Prometheus text
    format the ``/metrics`` endpoint serves; ``describe()`` feeds the
    generated metric catalog in docs/operations.md."""

    def __init__(self, max_series: int = DEFAULT_MAX_SERIES):
        self._lock = threading.Lock()
        self._metrics: dict[str, Metric] = {}
        self._max_series = max_series

    def _get_or_create(
        self,
        name: str,
        help: str,
        type: str,
        labels: tuple[str, ...],
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
    ) -> Metric:
        labels = tuple(labels)
        with self._lock:
            metric = self._metrics.get(name)
            if metric is not None:
                if metric.type != type or metric.label_names != labels:
                    raise ValueError(
                        f"metric {name!r} already registered as {metric.type}"
                        f"{metric.label_names}, requested {type}{labels}"
                    )
                return metric
            metric = self._metrics[name] = Metric(
                name, help, type, labels, buckets=buckets, max_series=self._max_series
            )
            return metric

    def counter(self, name: str, help: str, labels: tuple[str, ...] = ()) -> Metric:
        return self._get_or_create(name, help, COUNTER, labels)

    def gauge(self, name: str, help: str, labels: tuple[str, ...] = ()) -> Metric:
        return self._get_or_create(name, help, GAUGE, labels)

    def histogram(
        self,
        name: str,
        help: str,
        labels: tuple[str, ...] = (),
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
    ) -> Metric:
        return self._get_or_create(name, help, HISTOGRAM, labels, buckets=buckets)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def describe(self) -> list[dict]:
        """[{name, type, labels, help}] sorted by name — the metric
        catalog's source (``observability.catalog``)."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        return [
            {
                "name": m.name,
                "type": m.type,
                "labels": list(m.label_names),
                "help": m.help,
            }
            for m in metrics
        ]

    def render(self) -> str:
        """The Prometheus text exposition format (0.0.4): HELP + TYPE
        headers per family, then one line per sample, deterministic
        order (sorted families, sorted label values)."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: list[str] = []
        for metric in metrics:
            lines.append(f"# HELP {metric.name} {_escape_help(metric.help)}")
            lines.append(f"# TYPE {metric.name} {metric.type}")
            for sample_name, label_str, value in metric.samples():
                lines.append(f"{sample_name}{label_str} {_format_value(value)}")
        return "\n".join(lines) + "\n"


CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# ---------------------------------------------------------------------------
# the process-global registry (the analog of controller-runtime's
# metrics.Registry): hot-path instruments default to it; tests that
# need isolation build their own MetricsRegistry
# ---------------------------------------------------------------------------

_registry = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _registry


def parse_text(text: str) -> dict[str, float]:
    """Parse a text-format exposition into {sample_with_labels: value}
    — the helper the bench's per-phase scrape and the e2e scrape tests
    share (strict enough to catch a malformed render, not a full
    OpenMetrics parser)."""
    samples: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        if not name:
            raise ValueError(f"unparseable sample line: {line!r}")
        samples[name] = float(value)
    return samples
