"""Fleet-merged metrics: one view over every shard replica's scrape.

A sharded fleet has no single endpoint that answers "what is
the fleet's convergence p99" — each replica's ``/metrics`` carries only
its own slice of the keyspace.  This module merges N expositions into
one fleet view:

- **counters and histograms are summed** sample-by-sample (histogram
  ``_bucket``/``_sum``/``_count`` series sum like any counter, which
  is exactly how journey latency histograms aggregate across shards);
- **gauges are labeled by shard** (``shard="<identity>"`` appended) —
  summing a depth or an age across replicas would manufacture numbers
  nobody measured;
- a source that fails to scrape is skipped and NAMED in the view's
  meta (``# fleet-source-failed``) — a partial fleet view must say it
  is partial, never silently shrink.

``FleetView`` is the serving form: sources are (identity → fetcher)
callables so the same class merges live registries in-process (the
sim harness's replicas), HTTP scrapes of peer replicas
(``--fleet-peers`` → ``/metrics/fleet`` on any replica), and captured
exposition texts (the bench's sharding phase, the process drill).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from .. import klog

# metric types whose samples sum across sources; everything else
# (gauges, unknown) is labeled per shard instead
_SUMMED_TYPES = frozenset({"counter", "histogram"})


@dataclass
class Family:
    name: str
    type: str = "untyped"
    help: str = ""
    # sample name (with labels) -> value, insertion-ordered
    samples: dict[str, float] = field(default_factory=dict)


def parse_exposition(text: str) -> dict[str, Family]:
    """Prometheus text format → {family name: Family}.  Strict enough
    to catch a malformed render; sample lines before any TYPE header
    land in an untyped family."""
    families: dict[str, Family] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_text = rest.partition(" ")
            families.setdefault(name, Family(name)).help = help_text
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, type_name = rest.partition(" ")
            families.setdefault(name, Family(name)).type = type_name
            continue
        if line.startswith("#"):
            continue
        sample, _, value = line.rpartition(" ")
        if not sample:
            raise ValueError(f"unparseable sample line: {line!r}")
        family_name = sample.split("{", 1)[0]
        # histogram samples (_bucket/_sum/_count) belong to the base
        # family whose TYPE header declared them
        for suffix in ("_bucket", "_sum", "_count"):
            base = family_name[: -len(suffix)] if family_name.endswith(suffix) else None
            if base and base in families and families[base].type == "histogram":
                family_name = base
                break
        family = families.setdefault(family_name, Family(family_name))
        family.samples[sample] = float(value)
    return families


def _label_sample(sample: str, extra_key: str, extra_value: str) -> str:
    """Append one label to a sample name (creating the braces when the
    sample is unlabeled)."""
    escaped = extra_value.replace("\\", "\\\\").replace('"', '\\"')
    if sample.endswith("}"):
        return f'{sample[:-1]},{extra_key}="{escaped}"}}'
    return f'{sample}{{{extra_key}="{escaped}"}}'


def merge_expositions(
    sources: dict[str, str], shard_label: str = "shard"
) -> tuple[dict[str, Family], list[str]]:
    """Merge {identity: exposition text}: counters/histograms summed,
    gauges labeled ``shard_label=identity``.  Returns (families,
    notes) where notes name type conflicts between sources."""
    merged: dict[str, Family] = {}
    notes: list[str] = []
    for identity in sorted(sources):
        for name, family in parse_exposition(sources[identity]).items():
            target = merged.get(name)
            if target is None:
                target = merged[name] = Family(name, family.type, family.help)
            elif target.type != family.type:
                notes.append(
                    f"type conflict on {name}: {target.type} vs "
                    f"{family.type} from {identity}"
                )
                continue
            if family.type in _SUMMED_TYPES:
                for sample, value in family.samples.items():
                    target.samples[sample] = target.samples.get(sample, 0.0) + value
            else:
                for sample, value in family.samples.items():
                    target.samples[
                        _label_sample(sample, shard_label, identity)
                    ] = value
    return merged, notes


def render_families(families: dict[str, Family], meta: Optional[list[str]] = None) -> str:
    """Families → exposition text (sorted, deterministic), with meta
    lines as leading comments."""
    lines = [f"# {note}" for note in (meta or [])]
    for name in sorted(families):
        family = families[name]
        lines.append(f"# HELP {family.name} {family.help}")
        lines.append(f"# TYPE {family.name} {family.type}")
        for sample in sorted(family.samples):
            value = family.samples[sample]
            if value != value:  # NaN
                rendered = "NaN"
            elif float(value).is_integer() and abs(value) < 1e15:
                rendered = str(int(value))
            else:
                rendered = repr(float(value))
            lines.append(f"{sample} {rendered}")
    return "\n".join(lines) + "\n"


class FleetView:
    """The serving form: named fetchers in, one merged exposition out.
    A fetcher raising is a partial view, named in the output meta —
    the contract every consumer (the ``/metrics/fleet`` endpoint, the
    bench, the drills) relies on during failover."""

    def __init__(self, sources: dict[str, Callable[[], str]]):
        self._sources = dict(sources)

    def add_source(self, identity: str, fetch: Callable[[], str]) -> None:
        self._sources[identity] = fetch

    def collect(self) -> tuple[dict[str, str], list[str]]:
        texts: dict[str, str] = {}
        failed: list[str] = []
        for identity, fetch in self._sources.items():
            try:
                texts[identity] = fetch()
            except Exception as err:
                failed.append(identity)
                klog.v(2).infof(
                    "fleet view: source %s failed to scrape: %s", identity, err
                )
        return texts, failed

    def render(self) -> str:
        texts, failed = self.collect()
        families, notes = merge_expositions(texts)
        meta = [f"fleet-sources: {','.join(sorted(texts)) or 'none'}"]
        for identity in failed:
            meta.append(f"fleet-source-failed: {identity}")
        meta += notes
        return render_families(families, meta=meta)


def http_fetcher(url: str, timeout: float = 5.0) -> Callable[[], str]:
    """A fetcher over a peer replica's /metrics (the --fleet-peers
    wiring)."""
    import urllib.request

    def fetch() -> str:
        with urllib.request.urlopen(url, timeout=timeout) as response:
            return response.read().decode()

    return fetch


def converge_percentiles(
    families: dict[str, Family], quantiles: tuple[float, ...] = (0.5, 0.99)
) -> dict[str, dict]:
    """Per-controller-group convergence percentiles off a (merged)
    exposition's journey histogram — the bench's ``convergence`` block
    and the fleet SLO view share this read."""
    from .slo import (
        BINDING_CONTROLLERS,
        GA_CONTROLLERS,
        RECORD_CONTROLLERS,
        estimate_quantile,
    )

    groups = {
        "ga": GA_CONTROLLERS,
        "record": RECORD_CONTROLLERS,
        "binding": BINDING_CONTROLLERS,
    }
    family = families.get("agac_journey_converge_seconds")
    out: dict[str, dict] = {}
    for group, controllers in groups.items():
        # gather cumulative buckets across the group's spec-trigger
        # series: {le: count}
        bucket_counts: dict[float, float] = {}
        total = 0.0
        if family is not None:
            for sample, value in family.samples.items():
                if 'trigger="spec"' not in sample:
                    continue
                if not any(f'controller="{c}"' in sample for c in controllers):
                    continue
                if "_bucket{" in sample:
                    le = sample.split('le="', 1)[1].split('"', 1)[0]
                    if le == "+Inf":
                        continue
                    bound = float(le)
                    bucket_counts[bound] = bucket_counts.get(bound, 0.0) + value
                elif "_count{" in sample:
                    total += value
        buckets = sorted(bucket_counts.items())
        entry = {"count": int(total)}
        for q in quantiles:
            entry[f"p{int(q * 100)}_s"] = round(
                estimate_quantile(buckets, total, q), 4
            )
        out[group] = entry
    return out
