"""Per-shard partial-report merging.

``Manager.drift_tick`` and ``GarbageCollector.sweep_once`` used to
keep ONE ``last_*_report`` dict — a latent single-owner assumption:
with the keyspace sharded, a second sweeper's report silently
overwrote the first and /healthz showed whichever shard reported
last.  Reports are now stored per shard-ownership token (the
``ShardFilter.token()`` label, ``"all"`` in single-shard mode) and
the legacy single-report view is an ADDITIVE merge over the stored
partials — counts sum, skip lists union, ``partial`` ORs — so no
caller sees a partial result masquerading as the whole cluster's.
"""

from __future__ import annotations

import copy

# keys that identify the reporting shard rather than describe the
# sweep — excluded from the merged legacy view so exact-shape
# consumers (tests, bench) keep working
_IDENTITY_KEYS = frozenset({"shards"})


def _merge_value(merged, value):
    if isinstance(value, bool):
        return bool(merged) or value
    if isinstance(value, (int, float)):
        return merged + value
    if isinstance(value, dict):
        out = dict(merged)
        for key, inner in value.items():
            out[key] = _merge_value(out[key], inner) if key in out else copy.deepcopy(inner)
        return out
    if isinstance(value, list):
        out = list(merged)
        out.extend(item for item in value if item not in out)
        return out
    return value  # strings and the like: last writer wins


def merge_shard_reports(reports: dict[str, dict]) -> dict:
    """Fold per-shard partial reports (keyed by ownership token) into
    one cluster-level view: numbers add, nested dicts merge, lists
    union, booleans OR.  Deterministic: tokens are folded in sorted
    order."""
    merged: dict = {}
    for token in sorted(reports):
        for key, value in reports[token].items():
            if key in _IDENTITY_KEYS:
                continue
            merged[key] = (
                _merge_value(merged[key], value)
                if key in merged
                else copy.deepcopy(value)
            )
    return merged
