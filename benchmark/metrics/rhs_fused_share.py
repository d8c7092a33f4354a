"""``rhs_fused_share``: the share of the traced sweep's gas production-rate
evaluations that ran as the one ``gas_wdot`` kernel, 100 * ``rhs_fused`` /
(``rhs_fused`` + ``rhs_plain``) of ``solver/graphs.py`` ``COUNTS`` (set to 0
before the sweep; a captured window adds its counts on every replay).
Nothing where the counts have neither key (a program without the kernel)
or the sweep ran no device operation (a CPU run, where only the plain
rates exist)."""

LAYER = "RHS and Jacobian"
SOURCE = "program_counter"
MOVES = "cond_per_s"


def read(obs, log):
    counts = obs.get("counts") or {}
    if "rhs_fused" not in counts and "rhs_plain" not in counts:
        return None
    if not obs.get("trace", {}).get("device_ops"):
        return None
    fused, plain = counts.get("rhs_fused", 0), counts.get("rhs_plain", 0)
    if fused + plain == 0:
        return None
    share = 100.0 * fused / (fused + plain)
    log(f"rhs_fused_share: {fused} fused and {plain} plain gas RHS "
        f"evaluations: {share:.2f}%")
    return share
