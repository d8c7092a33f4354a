"""The yardstick's table of peaks and the operation and byte counts of the
kernels whose roofline share the benchmark reports.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W power
limit (a card set below it runs slower: every run prints the card's name
and limit beside its numbers).
"""

H100_SXM = {
    "f32_flop_per_s": 67e12,       # float32 outside the tensor cores
    "hbm_byte_per_s": 3.35e12,
}


def lu32p_cost(B, n):
    """(FLOPs, bytes) of ``lu32p`` factoring B float64 matrices (n, n): the
    2/3 n^3 of an LU per matrix; the float64 matrix read once, the float32
    factor and the int32 pivots written once.  Counted from the logical
    (B, n), never from the kernel's padded width, so the count is the same
    whatever implements the factor (the kernel table of ``PERF.md`` counts
    the written factor at the padded width)."""
    flops = 2.0 / 3.0 * n ** 3 * B
    nbytes = B * n * n * 8 + B * n * n * 4 + B * n * 4
    return flops, nbytes


def roofline(flops, nbytes, seconds, peaks=H100_SXM):
    """(share of the roofline in %, the bound: ``"bytes"`` or ``"flops"``):
    the least time the chip could take for float32 work over the measured
    time."""
    t_flop = flops / peaks["f32_flop_per_s"]
    t_byte = nbytes / peaks["hbm_byte_per_s"]
    least = max(t_flop, t_byte)
    return 100.0 * least / seconds, ("bytes" if t_byte >= t_flop
                                     else "flops")
