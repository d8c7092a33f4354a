"""Bucket ladders: the knob grammar that sets a padded shape.

Port of ``batchreactor_tpu/aot/buckets.py``: ``POW2`` and
``normalize_buckets`` (:32), ``resolve_bucket`` (:75), ``downshift_bucket``
(:123), ``upshift_bucket`` (:145) and ``bucket_ladder`` (:186).  The
mechanism-shape padding of ``batch_reactor_sweep`` uses the grammar for its
species and reaction axes (``species_buckets=``, ``reaction_buckets=``);
the sweeps' ``buckets=`` uses it for the lane axis, and the streaming
driver's down-shift and up-shift gears climb the ladder.  In the port a
rung is one set of captured CUDA graphs (``solver/graphs.py``), captured at
first use and kept for the process; there is no persistent program store.

The grammar:

* ``None``  — no padding (the default).
* ``"pow2"`` — the power-of-two ladder: a size pads to ``2**ceil(log2)``.
* a sequence of ints — an explicit ladder, e.g. ``(64, 96, 128)``; a size
  pads to the smallest entry >= it, and a size beyond the top entry is a
  loud error.
"""

POW2 = "pow2"


def normalize_buckets(buckets):
    """Validate a ``buckets=`` knob into its canonical form.

    Returns ``None`` (off), ``"pow2"``, or a strictly-increasing tuple of
    positive ints.  Anything else raises ``ValueError`` with the JAX
    package's message — the one validation point of every ladder knob.
    """
    if buckets is None or buckets is False:
        return None
    if isinstance(buckets, str):
        if buckets != POW2:
            raise ValueError(
                f"buckets must be None, 'pow2', or a sequence of "
                f"positive ints; got {buckets!r}")
        return POW2
    if isinstance(buckets, (bool, int, float)):
        raise ValueError(
            f"buckets must be None, 'pow2', or a sequence of positive "
            f"ints; got {buckets!r} (a single bucket is spelled "
            f"buckets=({buckets},))")
    try:
        ladder = tuple(buckets)
    except TypeError:
        raise ValueError(
            f"buckets must be None, 'pow2', or a sequence of positive "
            f"ints; got {buckets!r}") from None
    if not ladder:
        raise ValueError("buckets sequence must be non-empty (use "
                         "buckets=None to disable bucketing)")
    for b in ladder:
        if isinstance(b, bool) or not isinstance(b, int) or b < 1:
            raise ValueError(
                f"buckets entries must be positive ints; got {b!r} in "
                f"{buckets!r}")
    if list(ladder) != sorted(set(ladder)):
        raise ValueError(
            f"buckets must be strictly increasing with no duplicates; "
            f"got {buckets!r}")
    return ladder


def resolve_bucket(B, buckets, *, mesh_size=1):
    """The padded size for ``B`` (lanes, species or reactions).

    ``buckets`` is a normalized knob (:func:`normalize_buckets` output or
    raw — raw values are normalized here).  With ``buckets=None`` the
    answer is ``B`` itself (no padding).  ``mesh_size > 1`` additionally
    requires the chosen bucket to divide evenly over the device mesh —
    an indivisible bucket is a loud error, because silently re-padding
    it would run a program shape outside the canonical set.
    """
    B = int(B)
    if B < 1:
        raise ValueError(f"lane count must be >= 1, got {B}")
    buckets = normalize_buckets(buckets)
    if buckets is None:
        return B
    if buckets == POW2:
        bucket = 1 << max(0, (B - 1).bit_length())
        m = int(mesh_size)
        if m > 1:
            if m & (m - 1):
                # doubling can never reach divisibility by an odd prime
                # factor — fail loudly instead of looping forever
                raise ValueError(
                    f"buckets='pow2' cannot cover a {m}-device mesh "
                    f"(powers of two never divide evenly over a "
                    f"non-power-of-two mesh); use an explicit ladder of "
                    f"multiples of {m}")
            # a pow2 bucket below the mesh size cannot shard evenly; the
            # smallest valid pow2 multiple of a pow2 mesh is the mesh
            # itself
            while bucket % m:
                bucket *= 2
    else:
        bucket = next((b for b in buckets if b >= B), None)
        if bucket is None:
            raise ValueError(
                f"lane count {B} exceeds the top bucket of the explicit "
                f"ladder {buckets}; extend the ladder (warming the new "
                f"program shape) or use buckets='pow2'")
    if mesh_size > 1 and bucket % int(mesh_size):
        raise ValueError(
            f"bucket {bucket} (for B={B}) does not divide evenly over "
            f"the {int(mesh_size)}-device mesh; choose a ladder whose "
            f"entries are multiples of the mesh size")
    return bucket


def downshift_bucket(n_live, buckets, current, *, mesh_size=1):
    """The smaller ladder rung a draining sweep can down-shift onto, or
    ``None`` when no down-shift applies.

    The streaming driver (``parallel/sweep.py``, ``admission=``) calls this
    when its backlog is empty and ``n_live`` lanes remain resident in a
    ``current``-lane program: if the bucket for ``n_live`` is strictly below
    ``current``, the carry is compacted and sliced onto that smaller rung.
    ``n_live=0`` is treated as 1; ``buckets=None`` never down-shifts.
    """
    if buckets is None:
        return None
    target = resolve_bucket(max(int(n_live), 1), buckets,
                            mesh_size=mesh_size)
    return target if target < int(current) else None


def upshift_bucket(demand, buckets, current, *, cap=None, mesh_size=1):
    """The next-larger ladder rung a backlogged stream can up-shift onto,
    or ``None`` when no up-shift applies — the dual of
    :func:`downshift_bucket`.

    ``demand`` is the lane count the stream wants resident (live lanes plus
    backlog).  The answer is always the single next rung up, so every
    migration stays inside the ladder and the hysteresis window has a fixed
    step to damp against.  ``cap`` bounds the climb: rungs above
    ``resolve_bucket(cap)`` are never proposed.  ``buckets=None`` never
    up-shifts.
    """
    buckets = normalize_buckets(buckets)
    if buckets is None:
        return None
    current = int(current)
    if int(demand) <= current:
        return None
    if buckets == POW2:
        target = resolve_bucket(current + 1, buckets, mesh_size=mesh_size)
    else:
        target = next((b for b in buckets
                       if b > current and b % int(mesh_size) == 0), None)
        if target is None:
            return None
    if cap is not None:
        ceiling = resolve_bucket(max(int(cap), 1), buckets,
                                 mesh_size=mesh_size)
        if target > ceiling:
            return None
    return target if target > current else None


def bucket_ladder(lanes, buckets):
    """The deduplicated, sorted bucket set covering the given lane counts:
    the rungs a run over those lane counts captures graphs for."""
    return tuple(sorted({resolve_bucket(B, buckets) for B in lanes}))
