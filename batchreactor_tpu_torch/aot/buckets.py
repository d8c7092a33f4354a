"""Bucket ladders: the knob grammar that sets a padded shape.

Port of ``batchreactor_tpu/aot/buckets.py`` (``POW2`` and
``normalize_buckets`` at :32, ``resolve_bucket`` at :75), which the
mechanism-shape padding of ``batch_reactor_sweep`` uses for its species
and reaction axes (``species_buckets=``, ``reaction_buckets=``).  The
down-shift and up-shift gears and ``bucket_ladder`` belong to the lane
buckets of ROADMAP A13 and are not ported yet.

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
