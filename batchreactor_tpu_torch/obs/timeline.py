"""Per-lane solver timelines: the bounded attempt-record ring.

Port of ``batchreactor_tpu/obs/timeline.py`` (host side, unchanged).

``timeline=N`` on the solvers (``solver/bdf.py`` / ``solver/sdirk.py``;
requires ``stats=True``) generalizes the 64-slot ``step_audit`` accept
ring into a per-lane ring of full attempt records — for each of the last
``N`` step attempts: the attempted time ``t``, the attempted step size
``h``, and a signed int8 ``code`` packing outcome and cause::

    code > 0   accepted, at BDF order ``code`` (SDIRK records 4)
    code = -1  rejected by the error test (converged corrector)
    code = -2  rejected by a Newton convergence failure
    code = 0   empty slot (fewer than N attempts ever reached it)

The ring is slot-keyed by the GLOBAL attempt index mod N (the solvers
take a ``timeline_state`` carry so segmented relaunches keep writing
where the previous segment stopped), rides the ``stats`` dict under the
``TIMELINE_KEYS`` (``timeline_t`` / ``timeline_h`` / ``timeline_code``,
each ``(B, N)``: one ``(N,)`` row per lane), and therefore inherits
every existing per-lane path for free: segmented accumulation (replace,
not sum — ``obs/counters.py``), admission harvest un-shuffle, and the
report's ``per_lane`` JSONL export.  ``timeline=None`` (the default)
adds no key to the solver carry, so the captured step windows launch
the same kernels as without the knob.  The ring slot is a per-lane
tensor index (a ``scatter``), so a window that writes it still captures.

This module owns the HOST side: decoding a ring back into
chronologically ordered records and rendering the per-lane strip charts
``python -m batchreactor_tpu_torch.tools.obs_report --timeline`` prints — how a stiffness spike at
ignition becomes diagnosable per condition (h collapses, order drops,
conv-rejects cluster) without saving trajectories.
"""

import numpy as np

#: ring codes (sign carries outcome, magnitude the order / reject cause)
CODE_EMPTY = 0
CODE_ERR_REJECT = -1
CODE_CONV_REJECT = -2

#: stats-dict keys of the ring (per lane; excluded from counter totals,
#: replaced — never summed — across segments: obs/counters.py)
TIMELINE_KEYS = ("timeline_t", "timeline_h", "timeline_code")


def validate(timeline, stats):
    """THE validation rule for the ``timeline=`` knob, shared by the
    solvers and every sweep driver: ``None`` = off; otherwise an int
    >= 2 ring length, and the stats carry must be on (the ring rides
    it)."""
    if timeline is None:
        return None
    n = int(timeline)
    if isinstance(timeline, bool) or n < 2:
        raise ValueError(
            f"timeline must be None (off) or an int ring length >= 2, "
            f"got {timeline!r}")
    if not stats:
        raise ValueError(
            "timeline= rides the stats carry; pass stats=True "
            "(telemetry=True on the api entry points) or drop timeline=")
    return n


def has_timeline(stats):
    """True when a stats dict (or a report ``per_lane`` block) carries
    the ring keys."""
    return stats is not None and all(k in stats for k in TIMELINE_KEYS)


def decode(stats, lane=None):
    """Decode one lane's ring into chronological records.

    ``stats`` is a per-lane stats dict (arrays ``(N,)`` for one lane, or
    ``(B, N)`` batched with ``lane`` selecting the row) that also
    carries ``n_accepted``/``n_rejected`` — the global attempt total the
    slot arithmetic needs.  Returns a list of
    ``{"attempt", "t", "h", "code"}`` dicts, oldest first, at most N
    long (older attempts were overwritten)."""
    def pick(key):
        a = np.asarray(stats[key])
        return a[lane] if a.ndim > 1 else a

    t = pick("timeline_t")
    h = pick("timeline_h")
    code = pick("timeline_code")
    att_acc = np.asarray(stats["n_accepted"])
    att_rej = np.asarray(stats["n_rejected"])
    if att_acc.ndim > 0 and lane is not None:
        att_acc, att_rej = att_acc[lane], att_rej[lane]
    attempts = int(att_acc) + int(att_rej)
    N = t.shape[0]
    out = []
    for k in range(min(attempts, N)):
        a = attempts - min(attempts, N) + k     # global attempt index
        slot = a % N
        if int(code[slot]) == CODE_EMPTY:
            continue   # a padded/parked lane can under-fill its ring
        out.append({"attempt": a, "t": float(t[slot]),
                    "h": float(h[slot]), "code": int(code[slot])})
    return out


def _lane_strip(records, width=64):
    """One-character-per-attempt strip: digits = accepted order,
    ``e`` = error reject, ``c`` = convergence reject."""
    sym = []
    for r in records[-width:]:
        c = r["code"]
        sym.append(str(c) if c > 0 else ("e" if c == CODE_ERR_REJECT
                                         else "c"))
    return "".join(sym)


def render(report, lanes=None, max_lanes=4, width=64):
    """Human-readable per-lane timeline rendering from a report dict
    (``tools/obs_report.py --timeline``).

    ``lanes`` selects explicit lane indices; default picks the
    ``max_lanes`` lanes with the most rejected attempts (the stiff
    corners worth looking at).  Each lane prints a strip chart of its
    last ``width`` attempts plus the h-range and reject split."""
    per_lane = (report.get("solver_stats") or {}).get("per_lane") or {}
    if not has_timeline(per_lane):
        return ("no timeline in this report (run with timeline=N and "
                "telemetry=True)")
    n_rej = np.asarray(per_lane["n_rejected"])
    B = n_rej.shape[0]
    if lanes is None:
        order = np.argsort(-n_rej, kind="stable")
        lanes = [int(i) for i in order[:max_lanes]]
    lines = [f"solver timelines ({len(lanes)} of {B} lanes; digits = "
             f"accepted order, e = err-reject, c = conv-reject; "
             f"oldest -> newest)"]
    for b in lanes:
        if not 0 <= int(b) < B:
            raise ValueError(f"lane {b} outside [0, {B})")
        recs = decode(per_lane, lane=int(b))
        if not recs:
            lines.append(f"  lane {b}: (no attempts recorded)")
            continue
        hs = np.asarray([r["h"] for r in recs])
        acc = sum(r["code"] > 0 for r in recs)
        err = sum(r["code"] == CODE_ERR_REJECT for r in recs)
        conv = sum(r["code"] == CODE_CONV_REJECT for r in recs)
        lines.append(
            f"  lane {b}: attempts {recs[0]['attempt']}.."
            f"{recs[-1]['attempt']} acc={acc} err={err} conv={conv} "
            f"h [{hs.min():.2e}, {hs.max():.2e}] "
            f"t_last={recs[-1]['t']:.4e}")
        lines.append(f"    {_lane_strip(recs, width)}")
    return "\n".join(lines)
