"""Consistent-hash keyspace partitioner.

Maps a reconcile key (``namespace/name``) onto one of N shards via a
classic vnode hash ring: every shard owns ``vnodes`` points on a
64-bit circle, a key belongs to the shard owning the first point at or
after the key's own hash.  Properties the unit tier pins:

- **deterministic** — pure SHA-256 over literal strings, no process
  state, no randomness: every replica (and every replay of a sim
  seed) derives the identical map from the identical config;
- **bounded movement** — growing ``shard_count`` N→N+1 re-homes only
  ~1/(N+1) of the keyspace (each new vnode captures the arc segment
  immediately before it); a modulo partitioner would move ~N/(N+1);
- **versioned** — the ring publishes a content version derived from
  (shard_count, vnodes), so two replicas can cheaply assert they are
  partitioning under the same map before trusting each other's
  non-overlap (the exclusive-ownership oracle's precondition).

SHA-256 rather than ``hash()``: Python's string hash is salted per
process (PYTHONHASHSEED), which would give every replica a different
ring — the exact split-brain this module exists to prevent.
"""

from __future__ import annotations

import bisect
import hashlib

# vnodes per shard: at 64 the worst observed shard imbalance over
# uniform keys stays within ~±15% (test_sharding pins the bound at
# N=5k keys), while the ring stays small enough that building it is
# microseconds even at 64 shards
DEFAULT_VNODES = 64


def _point(token: str) -> int:
    """A stable 64-bit ring position for a token."""
    return int.from_bytes(hashlib.sha256(token.encode()).digest()[:8], "big")


class HashRing:
    """Immutable vnode ring over ``shard_count`` shards."""

    def __init__(self, shard_count: int, vnodes: int = DEFAULT_VNODES):
        if shard_count < 1:
            raise ValueError(f"shard_count must be >= 1, got {shard_count}")
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.shard_count = shard_count
        self.vnodes = vnodes
        points: list[tuple[int, int]] = []
        for shard in range(shard_count):
            for vnode in range(vnodes):
                # the token namespaces shard AND vnode so rings of
                # different sizes share every surviving shard's points
                # (that identity is what bounds movement on resize)
                points.append((_point(f"agac-shard-{shard}:vnode-{vnode}"), shard))
        points.sort()
        self._points = [p for p, _ in points]
        self._shards = [s for _, s in points]

    @property
    def version(self) -> str:
        """The map identity two replicas must agree on before their
        owned-shard sets can be assumed disjoint-by-key."""
        return f"{self.shard_count}x{self.vnodes}"

    def shard_for_key(self, key: str) -> int:
        """The owning shard of a ``namespace/name`` reconcile key."""
        if self.shard_count == 1:
            return 0
        return self.shard_at(_point(key))

    def shard_at(self, position: int) -> int:
        """The shard owning a raw 64-bit ring position (the arc-scan
        primitive ``transition_plan`` walks both rings with)."""
        index = bisect.bisect_right(self._points, position)
        if index == len(self._points):
            index = 0  # wrap: past the last vnode belongs to the first
        return self._shards[index]

    def shard_for(self, namespace: str, name: str) -> int:
        return self.shard_for_key(f"{namespace}/{name}")

    def partition(self, keys) -> dict[int, list[str]]:
        """Bucket ``keys`` by owning shard (diagnostics and tests)."""
        buckets: dict[int, list[str]] = {shard: [] for shard in range(self.shard_count)}
        for key in keys:
            buckets[self.shard_for_key(key)].append(key)
        return buckets


# ---------------------------------------------------------------------------
# ring transitions: the exact donor/gainer plan of a resize
# ---------------------------------------------------------------------------

_RING_SPACE = 1 << 64


class RingTransition:
    """The exact movement plan between two rings, computed over the
    union of both rings' vnode boundaries (no sampling): for every arc
    segment whose owner differs, the old owner is a *donor* of keys to
    the new-ring *gainer*.  Because surviving shards keep their vnode
    identities, growth re-homes only the arcs the new shards' vnodes
    capture (~1/N of the circle) and shrink re-homes only the removed
    shards' arcs — the bound the property tier pins."""

    __slots__ = ("old", "new", "moved_fraction", "gainers_of", "donors_of")

    def __init__(self, old: "HashRing", new: "HashRing"):
        self.old = old
        self.new = new
        # donor shard -> set of gainer shards it donates arcs to
        self.gainers_of: dict[int, frozenset[int]] = {}
        # gainer shard -> set of donor shards it receives arcs from
        self.donors_of: dict[int, frozenset[int]] = {}
        gainers_of: dict[int, set[int]] = {}
        donors_of: dict[int, set[int]] = {}
        boundaries = sorted(set(old._points) | set(new._points))
        moved = 0
        for index, start in enumerate(boundaries):
            end = (
                boundaries[index + 1]
                if index + 1 < len(boundaries)
                else boundaries[0] + _RING_SPACE
            )
            # the arc [start, end) belongs, in each ring, to the first
            # vnode strictly past ``start`` (shard_at semantics)
            owner_old = old.shard_at(start)
            owner_new = new.shard_at(start)
            if owner_old == owner_new:
                continue
            moved += end - start
            gainers_of.setdefault(owner_old, set()).add(owner_new)
            donors_of.setdefault(owner_new, set()).add(owner_old)
        self.moved_fraction = moved / _RING_SPACE
        self.gainers_of = {
            donor: frozenset(gainers) for donor, gainers in gainers_of.items()
        }
        self.donors_of = {
            gainer: frozenset(donors) for gainer, donors in donors_of.items()
        }

    @property
    def donors(self) -> frozenset[int]:
        return frozenset(self.gainers_of)

    @property
    def gainers(self) -> frozenset[int]:
        return frozenset(self.donors_of)

    def key_moves(self, key: str) -> bool:
        return self.old.shard_for_key(key) != self.new.shard_for_key(key)


def transition_plan(old: HashRing, new: HashRing) -> RingTransition:
    """The movement plan of an ``old`` → ``new`` ring transition."""
    if old.vnodes != new.vnodes:
        raise ValueError(
            f"rings must share vnode count ({old.vnodes} != {new.vnodes}): "
            "surviving-vnode identity is what bounds movement"
        )
    return RingTransition(old, new)
