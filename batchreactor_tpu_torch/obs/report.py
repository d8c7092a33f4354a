"""Assemble, render, and diff telemetry reports.

Port of ``batchreactor_tpu/obs/report.py``: the same ``br-obs-v1`` schema
and the same rendering, so a report from either package renders and
diffs with either package's tools.

A *report* is a plain JSON-able dict (schema ``br-obs-v1``) combining the
three telemetry sources — Recorder spans/events/counters, device-side
solver stats, and CompileWatch compile/retrace counts — into the one
artifact ``tools/obs_report.py`` renders and ``obs.export`` serializes.

Report layout::

    {"schema": "br-obs-v1",
     "meta":     {...free-form: label, backend, workload...},
     "spans":    [{name, path, depth, start, dur, attrs, seq}, ...],
     "events":   [{name, time, attrs}, ...],
     "counters": {name: number},
     "histograms": {name: [{"labels": {...}, "le": [...],
                            "counts": [...], "sum", "count"}, ...]}
                   | None,
     "solver_stats": {"totals": {...}, "per_lane": {key: [...]}} | None,
     "compile": {"available", "compiles", "traces", "retraces",
                 "compile_s", "by_label": {...}} | None}

``histograms`` (the ``obs/counters.py`` HIST_KEYS family —
docs/observability.md "Histograms") carries one series per label set:
``counts`` has one slot per ``le`` upper bound plus a trailing +Inf
overflow slot, and a MISSING family diffs as empty (count 0) — the
missing->0 convention lifted to distributions.
"""

import numpy as np
import torch

from . import counters as C

SCHEMA = "br-obs-v1"


def stats_totals(stats):
    """Alias of :func:`obs.counters.totals` re-exported at package level
    (the reduction most callers want)."""
    return C.totals(stats)


def _jsonable(v):
    """Coerce torch tensors, numpy scalars/arrays (and nested containers)
    to plain python so the report round-trips through json exactly; a
    tensor goes through the host (``.tolist()`` of its CPU copy)."""
    if torch.is_tensor(v):
        return _jsonable(v.detach().cpu().tolist())
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, np.ndarray):
        return _jsonable(v.tolist())
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if hasattr(v, "item") and not isinstance(v, (int, float, str, bool,
                                                 type(None))):
        # 0-d arrays of other array libraries
        try:
            return _jsonable(v.item())
        except (TypeError, ValueError):
            return repr(v)
    if isinstance(v, (int, float, str, bool, type(None))):
        return v
    return repr(v)


def build_report(recorder=None, solver_stats=None, watch=None, meta=None):
    """Assemble the report dict from whichever sources the caller has.

    ``solver_stats`` is a ``SolveResult.stats`` dict (scalar per-lane or
    lane-batched); per-lane arrays are included only when batched (a
    single-condition solve's totals ARE its per-lane view)."""
    spans, events, ctrs = ([], [], {})
    hists = None
    if recorder is not None:
        spans, events, ctrs = recorder.snapshot()
        snap = getattr(recorder, "hist_snapshot", None)
        if snap is not None:
            le = list(C.HIST_BUCKET_EDGES)
            hists = {name: [{"le": le, **ser} for ser in series]
                     for name, series in snap().items()} or None
    stats_block = per_lane = None
    if solver_stats is not None:
        # through the host once; the per-lane lists (the rings alone are
        # 3 x B x N numbers) skip the element-wise walk of _jsonable below:
        # tolist() already gives plain python numbers
        solver_stats = {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                            else np.asarray(v))
                        for k, v in solver_stats.items()}
        totals = C.totals(solver_stats)
        stats_block = {"totals": totals}
        lanes = C.per_lane(solver_stats)
        if lanes and any(v.ndim >= 1 and k != "order_hist"
                         for k, v in lanes.items()):
            first = next(iter(lanes.values()))
            if first.ndim >= 1:
                per_lane = {k: v.tolist() for k, v in lanes.items()}
    rep = _jsonable({
        "schema": SCHEMA,
        "meta": dict(meta or {}),
        "spans": spans,
        "events": events,
        "counters": ctrs,
        "histograms": hists,
        "solver_stats": stats_block,
        "compile": watch.summary() if watch is not None else None,
    })
    if per_lane is not None:
        rep["solver_stats"]["per_lane"] = per_lane
    return rep


# --------------------------------------------------------------------------
# rendering
# --------------------------------------------------------------------------
def _fmt_dur(d):
    return "   ...  " if d is None else f"{d:8.3f}s"


def hist_series_name(name, labels):
    """``serve_stage_seconds{stage="total"}`` — the one series-naming
    rule render, diff, and the gate share."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return name + "{" + inner + "}"


def _fmt_hs(v):
    """Histogram seconds, human-scaled (quantiles are None on empty)."""
    if v is None:
        return "-"
    return f"{1e3 * v:.1f}ms" if v < 1.0 else f"{v:.3f}s"


def render(report):
    """Human-readable multi-line rendering: span tree (indented by
    nesting depth, start order), counters, solver-stat totals with the
    order histogram, compile/retrace summary, and any events."""
    lines = []
    meta = report.get("meta") or {}
    head = " ".join(f"{k}={v}" for k, v in sorted(meta.items()))
    lines.append(f"obs report [{report.get('schema', '?')}]"
                 + (f"  {head}" if head else ""))

    spans = sorted(report.get("spans") or [], key=lambda s: s.get("seq", 0))
    if spans:
        lines.append("spans:")
        for s in spans:
            attrs = s.get("attrs") or {}
            extra = ("  " + " ".join(f"{k}={v}" for k, v in
                                     sorted(attrs.items()))) if attrs else ""
            lines.append(f"  {_fmt_dur(s.get('dur'))}  "
                         f"{'  ' * s.get('depth', 0)}{s['name']}{extra}")

    ctrs = report.get("counters") or {}
    if ctrs:
        lines.append("counters:")
        for k in sorted(ctrs):
            lines.append(f"  {k}: {ctrs[k]}")
        occ = C.occupancy(ctrs)
        if occ is not None:
            lines.append(f"  occupancy: {occ:.4f} "
                         f"(lane_attempts / lane_capacity)")

    hists = report.get("histograms") or {}
    if hists:
        lines.append("histograms:")
        for name in sorted(hists):
            for ser in hists[name]:
                lines.append(
                    f"  {hist_series_name(name, ser.get('labels'))}: "
                    f"n={ser['count']} mean={_fmt_hs(C.hist_mean(ser))} "
                    f"p50={_fmt_hs(C.hist_quantile(ser, 0.50))} "
                    f"p95={_fmt_hs(C.hist_quantile(ser, 0.95))} "
                    f"p99={_fmt_hs(C.hist_quantile(ser, 0.99))}")

    st = (report.get("solver_stats") or {}).get("totals")
    if st:
        lines.append("solver:")
        for k in ("n_accepted", "n_rejected", "newton_iters", "jac_builds",
                  "factorizations", "setup_reuses", "precond_age",
                  "err_rejects", "conv_rejects"):
            if k in st:
                lines.append(f"  {k}: {st[k]}")
        if "order_hist" in st:
            hist = st["order_hist"]
            lines.append("  order_hist: "
                         + " ".join(f"{q}:{n}" for q, n in
                                    enumerate(hist) if q >= 1))
        per_lane = (report.get("solver_stats") or {}).get("per_lane")
        if per_lane:
            b = len(next(iter(per_lane.values())))
            lines.append(f"  (per-lane stats for {b} lanes in the report)")

    comp = report.get("compile")
    if comp is not None:
        if not comp.get("available", True):
            # a JAX-package report whose runtime had no compile events
            lines.append("compile: unavailable (no jax.monitoring)")
        else:
            cache = ""
            if "cache_hits" in comp:
                cache = (f", cache {comp['cache_hits']} hits / "
                         f"{comp.get('cache_misses', 0)} misses")
            lines.append(f"compile: {comp['compiles']} compiles "
                         f"({comp['compile_s']:.2f}s), {comp['traces']} "
                         f"traces, {comp['retraces']} retraces{cache}")
            for label, v in sorted((comp.get("by_label") or {}).items()):
                progs = v.get("programs") or {}
                extra = (f" programs={len(progs)}" if len(progs) > 1
                         else "")
                lines.append(f"  {label}: compiles={v['compiles']} "
                             f"traces={v['traces']} "
                             f"retraces={v['retraces']}{extra}")

    events = report.get("events") or []
    if events:
        lines.append("events:")
        for e in events:
            attrs = e.get("attrs") or {}
            extra = " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
            lines.append(f"  {e['name']}" + (f"  {extra}" if extra else ""))
    return "\n".join(lines)


def diff(a, b):
    """Compare two reports (baseline ``a`` -> candidate ``b``): per-name
    span totals, recorder counters (e.g. the segmented drivers'
    ``blocking_syncs``), solver-stat totals, and compile counts, with
    absolute and relative deltas — the tool perf PRs cite for
    before/after numbers."""

    def span_totals(rep):
        agg = {}
        for s in rep.get("spans") or []:
            if s.get("dur") is not None:
                agg[s["name"]] = agg.get(s["name"], 0.0) + s["dur"]
        return agg

    lines = ["obs diff (a -> b)"]
    sa, sb = span_totals(a), span_totals(b)
    for name in sorted(set(sa) | set(sb)):
        va, vb = sa.get(name), sb.get(name)
        if va is None or vb is None:
            lines.append(f"  span {name}: "
                         f"{'-' if va is None else f'{va:.3f}s'} -> "
                         f"{'-' if vb is None else f'{vb:.3f}s'}")
        else:
            pct = 100.0 * (vb - va) / va if va else float("inf")
            lines.append(f"  span {name}: {va:.3f}s -> {vb:.3f}s "
                         f"({pct:+.1f}%)")

    def _fmt_ctr(v):
        # float counters are accumulated wall-clock (e.g. poll_wait_s):
        # format like span durations, not full-precision repr noise
        if isinstance(v, float):
            return f"{v:.3f}"
        return str(v)

    ka, kb = a.get("counters") or {}, b.get("counters") or {}
    missing_zero = C.missing_zero_keys()
    for k in sorted(set(ka) | set(kb)):
        va, vb = ka.get(k), kb.get(k)
        if k in missing_zero:
            # host counter families (fault/admission/live/serve — the
            # counters.FAMILIES registry's missing_zero declaration,
            # which registering a future family joins automatically)
            # are absent from reports whose run never exercised the
            # surface: missing is 0, not a difference (the
            # setup_reuses/cache_* convention)
            va, vb = va or 0, vb or 0
            if va == vb:
                continue
        if va != vb:
            lines.append(f"  counter {k}: {_fmt_ctr(va)} -> {_fmt_ctr(vb)}")
    # histogram families (HIST_KEYS — the serve_stage_seconds latency
    # decomposition): missing is EMPTY (count 0, quantiles None), the
    # missing->0 convention lifted to distributions, so a baseline that
    # never served diffs cleanly against a serving run.  Rendered as
    # count + p50/p99 shifts, not raw bucket vectors.
    def hist_series(rep):
        out = {}
        for name, series in (rep.get("histograms") or {}).items():
            for ser in series:
                out[hist_series_name(name, ser.get("labels"))] = ser
        return out

    ha, hb = hist_series(a), hist_series(b)
    empty = C.hist_new()
    for key in sorted(set(ha) | set(hb)):
        va, vb = ha.get(key, empty), hb.get(key, empty)
        if va["count"] == vb["count"] and va["counts"] == vb["counts"]:
            continue
        lines.append(
            f"  hist {key}: n {va['count']} -> {vb['count']}, "
            f"p50 {_fmt_hs(C.hist_quantile(va, 0.5))} -> "
            f"{_fmt_hs(C.hist_quantile(vb, 0.5))}, "
            f"p99 {_fmt_hs(C.hist_quantile(va, 0.99))} -> "
            f"{_fmt_hs(C.hist_quantile(vb, 0.99))}")

    # derived occupancy gauge (continuous batching): shown whenever either
    # side recorded capacity, so an admission A/B reads as one ratio
    # instead of two raw counter deltas
    oa, ob = C.occupancy(ka), C.occupancy(kb)
    if (oa is not None or ob is not None) and oa != ob:
        lines.append(f"  occupancy: "
                     f"{'-' if oa is None else f'{oa:.4f}'} -> "
                     f"{'-' if ob is None else f'{ob:.4f}'}")

    ta = (a.get("solver_stats") or {}).get("totals") or {}
    tb = (b.get("solver_stats") or {}).get("totals") or {}
    for k in sorted(set(ta) | set(tb)):
        va, vb = ta.get(k), tb.get(k)
        if k in ("setup_reuses", "precond_age"):
            # setup-economy keys are absent from pre-economy archived
            # reports: missing is 0, not a difference (the cache_* key
            # convention below)
            va, vb = va or 0, vb or 0
        if va != vb:
            lines.append(f"  solver {k}: {va} -> {vb}")
    ca, cb = a.get("compile") or {}, b.get("compile") or {}
    for k in ("compiles", "retraces", "cache_hits", "cache_misses"):
        # cache_* keys are absent from pre-AOT archived reports: a
        # missing counter is 0, not a difference
        va, vb = ca.get(k) or 0, cb.get(k) or 0
        if va != vb:
            lines.append(f"  compile {k}: {va} -> {vb}")
    # per-label compile counts: the AOT program store's zero-recompile
    # evidence is the ARMED sweep label going to zero ("compile
    # [sweep-segment] compiles: N -> 0"), distinct from sub-ms host
    # eager-op compiles that ride the totals
    bla, blb = (ca.get("by_label") or {}), (cb.get("by_label") or {})
    for label in sorted(set(bla) | set(blb)):
        va = (bla.get(label) or {}).get("compiles", 0)
        vb = (blb.get(label) or {}).get("compiles", 0)
        if va != vb:
            lines.append(f"  compile [{label}] compiles: {va} -> {vb}")
    # compile wall is the AOT program store's headline evidence
    # ("compiles: N -> 0" above, seconds saved here); float-compare with
    # a render threshold so ~us jitter doesn't read as a diff
    va, vb = ca.get("compile_s"), cb.get("compile_s")
    if (va is None) != (vb is None) or (
            va is not None and abs(va - vb) >= 5e-4):
        lines.append(f"  compile compile_s: {_fmt_ctr(va)} -> "
                     f"{_fmt_ctr(vb)}")
    if len(lines) == 1:
        lines.append("  (no differences in spans / counters / solver "
                     "stats / compiles)")
    return "\n".join(lines)
