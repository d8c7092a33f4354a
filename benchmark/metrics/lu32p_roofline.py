"""``lu32p_roofline``: the ``lu32p`` factor kernel's share of its roofline.

Its mean device time per launch (the trace's ``lu32p_*`` kernels over their
launches) against the least time the chip could take for one factor of the
sweep's (B, n) float64 Newton matrices: the larger of 2/3 n^3 B FLOPs at
the float32 peak and the bytes (the float64 matrix read once, the float32
factor and int32 pivots written once) at the HBM bandwidth
(``core/peaks.py``).  Nothing when no ``lu32p`` kernel ran."""

from benchmark.core.peaks import lu32p_cost, roofline

LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "cond_per_s"


def read(obs, log):
    hits = {k: v for k, v in obs["trace"]["kernels"].items()
            if "lu32p_" in k}
    seconds = sum(t for t, _ in hits.values())
    launches = sum(c for _, c in hits.values())
    if not launches or seconds <= 0:
        return None
    B, n = obs["lanes"], obs["width"]
    flops, nbytes = lu32p_cost(B, n)
    share, bound = roofline(flops, nbytes, seconds / launches)
    log(f"lu32p_roofline: {launches} launches ({sorted(hits)}), "
        f"{1e3 * seconds / launches:.5f} ms each at (B, n) = ({B}, {n}), "
        f"bound by {bound}: {share:.2f}%")
    return share
