"""Consistent-hash ring: digest-affine request placement with minimal
key movement (a copy of mesh_tpu/fleet/ring.py).

Each member (a replica name) is hashed onto the ring at ``vnodes``
virtual positions; a routing key walks clockwise from its own hash and
meets members in a pseudo-random but *stable* order.  Stability is the
whole point:

- the same key always lands on the same member while membership holds,
  so a replica keeps seeing the digests whose plan/page caches it
  already warmed;
- removing a member remaps ONLY the keys that key-walked onto it first
  (its arc is inherited by the clockwise successors) — every other
  key's primary is untouched;
- ``choices(key)`` returns the full preference order (primary first,
  then the spill sibling, ...), deduplicated, so admission spill has a
  deterministic second choice without rehashing.

Hashing is ``zlib.crc32`` over utf-8 strings — deterministic across
processes and Python versions (no ``PYTHONHASHSEED`` dependence), so
both packages place every key on the same member.  Stdlib-only, no
locking: the ring is owned by its router, which serializes membership
changes.
"""

import bisect
import zlib

__all__ = ["HashRing", "DEFAULT_VNODES"]

#: virtual nodes per member: enough to keep the largest/smallest arc
#: ratio low at single-digit member counts without bloating lookups
DEFAULT_VNODES = 64


def _hash(text):
    return zlib.crc32(text.encode("utf-8")) & 0xFFFFFFFF


class HashRing(object):
    """Members hashed to ``vnodes`` ring positions each; lookups walk
    clockwise from the key's own hash."""

    def __init__(self, members=(), vnodes=DEFAULT_VNODES):
        self.vnodes = max(1, int(vnodes))
        self._points = []         # sorted vnode hashes
        self._owner = {}          # vnode hash -> member name
        self._members = []        # insertion order (ties + introspection)
        for member in members:
            self.add(member)

    def __len__(self):
        return len(self._members)

    def __contains__(self, member):
        return member in self._members

    def members(self):
        """Member names in insertion order."""
        return list(self._members)

    def add(self, member):
        """Insert a member (idempotent)."""
        if member in self._members:
            return
        self._members.append(member)
        for i in range(self.vnodes):
            point = _hash("%s#%d" % (member, i))
            # a full 32-bit collision between two members' vnodes is
            # possible in principle; first owner keeps the point so
            # placement stays insertion-order deterministic
            if point not in self._owner:
                self._owner[point] = member
                bisect.insort(self._points, point)

    def remove(self, member):
        """Remove a member; only keys whose walk met it first move."""
        if member not in self._members:
            return
        self._members.remove(member)
        stale = [p for p, owner in self._owner.items() if owner == member]
        for point in stale:
            del self._owner[point]
            index = bisect.bisect_left(self._points, point)
            if index < len(self._points) and self._points[index] == point:
                del self._points[index]

    def lookup(self, key):
        """The primary member for ``key`` (None on an empty ring)."""
        choices = self.choices(key, n=1)
        return choices[0] if choices else None

    def choices(self, key, n=None):
        """Up to ``n`` distinct members in clockwise walk order from the
        key's hash — index 0 is the primary, index 1 the spill sibling.
        ``n=None`` returns every member."""
        if not self._points:
            return []
        want = len(self._members) if n is None else min(
            int(n), len(self._members))
        start = bisect.bisect(self._points, _hash(key))
        seen, order = set(), []
        for i in range(len(self._points)):
            point = self._points[(start + i) % len(self._points)]
            owner = self._owner[point]
            if owner in seen:
                continue
            seen.add(owner)
            order.append(owner)
            if len(order) >= want:
                break
        return order
