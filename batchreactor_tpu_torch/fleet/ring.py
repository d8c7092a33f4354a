"""Consistent-hash ring: affinity routing for the serving fleet.

The router's whole job is keeping each member's warm state warm: a
daemon that has served pack key ``(t1, rtol, atol, energy)`` for
mechanism ``m`` holds the warmed programs and (while the epoch is
resident) the streaming backlog for exactly that key, so the router
must send every request of that key to the same member — and when
membership changes, move as few keys as possible (a moved key pays one
cold epoch on its new host; a full reshuffle pays it everywhere at
once).

That is the textbook consistent-hash ring: each member owns ``vnodes``
points on a 2^64 ring (sha256 of ``"<member>#<k>"`` — *not* python's
``hash``, which is per-process salted and would reshuffle the fleet on
every router restart), a key routes to the first member point at or
clockwise-after its own hash, and adding/removing one member moves only
the arcs adjacent to that member's points (the bounded-churn property
tests in ``tests/test_torch_fleet.py`` pin this).  Virtual nodes smooth the
arc sizes so a 2-member fleet splits load ~evenly instead of wherever
two raw hashes happened to land.

Deterministic by construction: same member set => same ring => same
routes, across processes and restarts (a member's warm state outlives
the router, so a restarted router must route a key back to the member
that already holds it).  Port of ``batchreactor_tpu/fleet/ring.py``: the
same members and keys give the reference's owners and preference lists,
so a fleet mixing both packages routes alike
(``tests/test_torch_fleet.py``).

stdlib-only and stateless under reads; the router owns the mutation
lock (a ring is rebuilt, not edited, on membership change).
"""

import bisect
import hashlib

#: virtual nodes per member — 64 keeps the max/min arc ratio tight
#: (~1.3x at 2-8 members) at a few KiB of ring per member
DEFAULT_VNODES = 64


def _hash64(data):
    return int.from_bytes(
        hashlib.sha256(data.encode("utf-8")).digest()[:8], "big")


def canonical_key(parts):
    """One stable string for a route-key tuple: ``repr`` of each part
    joined with unit separators (floats keep full precision through
    ``repr``, ``None`` canonicalizes, and no two distinct tuples
    collide on a separator embedded in a mechanism id)."""
    return "\x1f".join(repr(p) for p in parts)


def request_key(obj):
    """The routing key of a raw (pre-validation) request object:
    ``(mech, t1, rtol, atol, energy)`` — the mechanism routing key plus
    the pack key's fields, i.e. the warm-state identity the request
    will occupy on whichever member serves it.  Absent fields
    canonicalize to ``None`` (the member applies its spec defaults, so
    two requests that omit ``rtol`` land on one member and share its
    default-rtol program).  Validation happens on the member — the
    router only peeks."""
    if not isinstance(obj, dict):
        return ("invalid",)
    return (obj.get("mech"), obj.get("t1"), obj.get("rtol"),
            obj.get("atol"), obj.get("energy"))


class HashRing:
    """Module doc.  ``members`` is any iterable of member names
    (strings); routes are deterministic functions of the member SET
    (insertion order never matters)."""

    def __init__(self, members=(), vnodes=DEFAULT_VNODES):
        self.vnodes = int(vnodes)
        self._members = tuple(sorted(set(str(m) for m in members)))
        self._points = []      # sorted (hash, member)
        for m in self._members:
            for k in range(self.vnodes):
                self._points.append((_hash64(f"{m}#{k}"), m))
        self._points.sort()
        self._hashes = [h for h, _m in self._points]

    # ---- membership (functional: build a new ring) -------------------------
    def members(self):
        return self._members

    def with_members(self, members):
        """A new ring over ``members`` (same vnodes) — the router
        rebuilds on membership change rather than editing in place, so
        a concurrent reader always sees one consistent ring."""
        return HashRing(members, vnodes=self.vnodes)

    # ---- routing -----------------------------------------------------------
    def route(self, key):
        """The member owning ``key`` (a tuple — see
        :func:`request_key` — or a pre-canonicalized string); ``None``
        on an empty ring."""
        prefs = self.preference(key, n=1)
        return prefs[0] if prefs else None

    def preference(self, key, n=None):
        """The failover order for ``key``: the first ``n`` DISTINCT
        members clockwise from the key's point (all members when ``n``
        is None).  Element 0 is the primary; the router walks the rest
        when a forward fails — so a dead primary's keys land on the
        same survivor every time (its arc *reassigns*, it does not
        scatter)."""
        if not self._points:
            return []
        if not isinstance(key, str):
            key = canonical_key(key)
        h = _hash64(key)
        start = bisect.bisect_right(self._hashes, h) % len(self._points)
        want = len(self._members) if n is None else min(
            int(n), len(self._members))
        out = []
        for i in range(len(self._points)):
            m = self._points[(start + i) % len(self._points)][1]
            if m not in out:
                out.append(m)
                if len(out) >= want:
                    break
        return out

    def arc_share(self, samples=4096):
        """Approximate fraction of key space owned per member (sampled
        — healthz/debug surface, not a routing primitive)."""
        if not self._members:
            return {}
        counts = dict.fromkeys(self._members, 0)
        for i in range(int(samples)):
            counts[self.route(f"sample:{i}")] += 1
        return {m: c / float(samples) for m, c in sorted(counts.items())}
