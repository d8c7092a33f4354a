"""Solver-counter semantics and host-side reductions.

Port of ``batchreactor_tpu/obs/counters.py`` (same keys, families and
reductions, so a report of either package reads with the other's tools).
The counter *collection* lives inside the solvers (``solver/bdf.py`` and
``solver/sdirk.py``, ``stats=True``): int32 (B,) tensors in the stepper's
carry, updated with masked adds on values the step already computes — no
``.item()``, no host read, so a captured step window stays capturable —
and surfaced as the ``SolveResult.stats`` dict, one row per lane.  This
module owns the *meaning* of each key and the host-side reductions
(totals, per-lane views, segmented accumulation).  The families whose
producers are not ported yet (serving, AOT registry, fleet, SLO: ROADMAP
A15-A16) stay declared, so ``obs.diff`` treats their keys alike in both
packages.

Keys (CVODE's ``CVodeGetNumSteps``-family counters, per lane):

``n_accepted`` / ``n_rejected``
    accepted / rejected step attempts (aliases of the SolveResult fields,
    repeated here so an exported stats block is self-contained).
``newton_iters``
    total Newton iterations across all step attempts (BDF: corrector
    iterations; SDIRK: summed over the 5 stage solves of each attempt).
``jac_builds``
    Jacobian evaluations (``jac_window=K`` amortizes: one build serves up
    to K attempts, so ``jac_builds <= attempts`` with K > 1).
``factorizations``
    Newton iteration-matrix constructions M = I - cJ (+ solver setup);
    under ``freeze_precond`` one per window instead of one per attempt.
``err_rejects`` / ``conv_rejects``
    rejected attempts split by cause: error test failed with a converged
    corrector vs Newton convergence failure (incl. non-finite iterates).
    ``err_rejects + conv_rejects == n_rejected`` exactly.
``setup_reuses``  (BDF ``setup_economy=True`` only; 0 otherwise)
    jac-window opens that *reused* the carried iteration-matrix
    factorization instead of refactoring (the CVODE msbp/dgamrat test
    passed).  ``setup_reuses + factorizations == jac_builds`` exactly
    under economy, so ``factorizations < jac_builds`` wherever reuse
    fired.
``precond_age``  (gauge — see ``GAUGE_KEYS``)
    peak number of consecutive jac windows one factorization served
    (CVODE's msbp counter at its high-water mark).  A gauge, not a
    counter: segmented accumulation and totals reduce it by ``max``,
    never by sum.
``order_hist``  (BDF only)
    (MAXORD+1,) int32 histogram of *accepted* steps by the order they
    were taken at; slot 0 is structurally unused (orders run 1..5), and
    ``order_hist.sum() == n_accepted`` exactly.
``accept_ring`` / ``it_matrix``  (``step_audit=True`` only)
    the 64-slot attempt-outcome ring and last iteration matrix — folded
    into ``stats`` from the legacy top-level fields, which now alias
    these same arrays.

Counters are gated per lane on *liveness* (a lane parked by termination
or segmented re-entry stops counting even though the masked device
program keeps executing its lanes), so they report algorithmic work, not
SIMD occupancy: a fixed-trip window of the pipelined gear runs
``max_newton`` iterations under masks, while ``newton_iters`` counts an
iteration for a lane only while that lane's own Newton loop runs, so
both gears give equal counters (``solver/graphs.py`` ``COUNTS`` keeps
the executed count).
"""

import bisect

import numpy as np

#: counter keys common to both solvers (beyond the SolveResult aliases)
COMMON_KEYS = ("newton_iters", "jac_builds", "factorizations",
               "err_rejects", "conv_rejects")
#: additional BDF-only keys (setup_reuses stays 0 without setup_economy)
BDF_KEYS = ("order_hist", "setup_reuses", "precond_age")
#: gauge keys: high-water marks, reduced by max — summing a peak age
#: across segments would report an age no factorization ever reached
GAUGE_KEYS = ("precond_age",)
#: host-side fault/recovery counters (resilience/ — docs/robustness.md):
#: Recorder counters, not device stats.  Absent from a report means zero
#: faults, so ``obs.diff`` maps a missing key to 0 (the setup_reuses /
#: cache_* convention) — a fault-free baseline diffs cleanly against a
#: faulted run instead of reporting "None -> n".
FAULT_KEYS = ("fetch_timeouts", "chunk_retries", "chunks_corrupt",
              "chunks_reassigned", "lanes_quarantined", "lanes_recovered",
              "lanes_unrecovered")
#: continuous-batching counters (parallel/sweep.py ``admission=`` —
#: docs/performance.md "Continuous batching"): Recorder counters, not
#: device stats.  ``compactions``/``admitted_lanes``/``bucket_downshifts``
#: count the streaming driver's queue events and appear only when
#: admission ran (``bucket_upshifts`` — the autoscaling up-shift dual,
#: ``upshift=`` — counts warmed-ladder rung climbs the same way);
#: ``lane_attempts``/``lane_capacity`` are the occupancy
#: pair — useful LIVE-lane step attempts vs the device's attempt
#: capacity (padded B x segments x segment_steps) — recorded by the
#: pipelined driver whenever a recorder is armed, admission on OR off
#: (that is the A/B surface), additive across sweeps/chunks so
#: consumers derive occupancy = lane_attempts / lane_capacity
#: (report.render, the ``br_sweep_occupancy`` Prometheus gauge).  A
#: missing key means that surface didn't run (no recorder, blocking
#: gear, or admission off for the queue counters) — ``obs.diff`` maps
#: it to 0 (the FAULT_KEYS convention).
ADMISSION_KEYS = ("compactions", "admitted_lanes", "bucket_downshifts",
                  "bucket_upshifts", "lane_attempts", "lane_capacity")

#: graph/poll-layer counters of the port (``solver/graphs.py``): Recorder
#: counters that mirror ``graphs.COUNTS`` while a recorder is armed on the
#: sweep's thread — graph replays and Newton iterations EXECUTED (a
#: fixed-trip window counts every iteration it runs, masked or not; the
#: algorithmic count is the device ``newton_iters``).  The host syncs land
#: as the reference's ``blocking_syncs``.  Absent from a run without a
#: recorder — ``obs.diff`` maps a missing key to 0.  ``rhs_fused`` and
#: ``rhs_plain`` count the gas production-rate evaluations by route (the
#: ``gas_wdot`` kernel, aten ops; ``ops/gas_kinetics.py``), and
#: ``gas_wdot_launches`` that kernel's launches (``obs/tally.py``).
GRAPH_KEYS = ("graph_replays", "newton_iters_executed", "rhs_fused",
              "rhs_plain", "gas_wdot_launches")

#: step_audit payloads folded into stats (not counters; excluded from sums)
AUDIT_KEYS = ("accept_ring", "it_matrix")
#: per-lane timeline ring payloads (``timeline=N`` — obs/timeline.py):
#: slot-keyed sample buffers like the audit ring, so they REPLACE across
#: segments (the solver carries the ring forward and returns the updated
#: whole) and never enter counter totals
TIMELINE_KEYS = ("timeline_t", "timeline_h", "timeline_code")
#: live-telemetry-plane counters (obs/live.py — docs/observability.md
#: "Live metrics"/"Flight recorder"): Recorder counters incremented by
#: the metrics endpoint (scrapes), the registry (publishes), the fleet
#: snapshot writer, and the flight recorder (dumps).  Absent from a
#: report whose run served no endpoint — ``obs.diff`` maps a missing
#: key to 0 (the FAULT_KEYS/ADMISSION_KEYS convention).
LIVE_KEYS = ("metrics_scrapes", "live_publishes", "fleet_snapshots",
             "flight_dumps")
#: serving-plane counters (serving/ — docs/serving.md): Recorder
#: counters incremented by the daemon's scheduler (request admission /
#: rejection / resolution, epoch turnover, injected stalls), the
#: streaming driver's live feed (``fed_lanes`` — lanes appended to a
#: resident backlog mid-stream), the multi-epoch spray
#: (``epoch_spray`` — lanes a secondary resident epoch pulled from the
#: shared pack-key queue; structurally zero at ``resident_epochs=1``),
#: and the session warmup wall.
#: Request latency is NOT here: the old ``serve_latency_s`` additive
#: counter summed seconds across requests into a meaningless total —
#: it migrated to the ``serve_stage_seconds`` HISTOGRAM family
#: (``HIST_KEYS`` below, ``{stage="total"}``).  Absent from a report
#: whose run served nothing — ``obs.diff`` maps a missing key to 0
#: (the FAULT_KEYS convention).
SERVE_KEYS = ("serve_requests", "serve_lanes", "serve_answered",
              "serve_failed", "serve_rejects_overload",
              "serve_rejects_draining", "serve_stalls", "serve_epochs",
              "serve_warmup_s", "fed_lanes", "epoch_spray")
#: AOT program-store counters (aot/registry.py — docs/performance.md
#: "Mechanism-shape economy"): Recorder counters incremented by the
#: registry's LRU capacity policy (``enforce_capacity`` — entries
#: evicted from the warm-cache manifest now that mechanism uploads make
#: the program set user-extensible) and the serving session store's
#: mechanism admission/eviction.  Absent from a run that never touched
#: the registry — ``obs.diff`` maps a missing key to 0 (the FAULT_KEYS
#: convention).
AOT_KEYS = ("aot_evictions", "mech_admitted", "mech_evicted")
#: fleet-router counters (fleet/ — docs/serving.md "Fleet"): Recorder
#: counters incremented by the router's routing loop (requests routed,
#: transport/draining failovers, upstream error passthroughs, the
#: no-routable-member refusal), the upload replication fan-out, and
#: the membership refresh (ring joins/age-outs).  Host-side by
#: construction.  Absent from a run that
#: never routed — ``obs.diff`` maps a missing key to 0 (the FAULT_KEYS
#: convention).
FLEET_KEYS = ("route_requests", "route_failovers",
              "route_upstream_errors", "route_no_members",
              "fleet_uploads", "fleet_replications",
              "fleet_members_joined", "fleet_members_left")
#: request-latency HISTOGRAM families (obs/trace.py + serving/ —
#: docs/observability.md "Histograms"): Recorder histograms
#: (``Recorder.observe``) over the FIXED log-spaced bucket ladder
#: :data:`HIST_BUCKET_EDGES`, so merge is slot-wise sum by
#: construction.  ``serve_stage_seconds`` is labeled by destination
#: stage (``RequestTrace.segments`` + ``total`` — the migrated
#: ``serve_latency_s``) and renders as the Prometheus
#: ``br_serve_stage_seconds_bucket/_sum/_count`` exposition
#: (obs/export.py).  A missing histogram family diffs as EMPTY (count
#: 0), the missing->0 convention lifted to distributions.
HIST_KEYS = ("serve_stage_seconds",)
#: router-side latency HISTOGRAM family (fleet/router.py): wall time
#: from request receipt to the member's answer over the same fixed
#: ladder, labeled ``{path="direct"|"failover"}`` — the failover split
#: is the fleet bench's evidence that re-routing costs what it claims
#: (``serve_bench.py --router``).  Missing family diffs as EMPTY, the
#: HIST_KEYS convention.
ROUTE_HIST_KEYS = ("route_seconds",)
#: coalesce-window HISTOGRAM family (serving/scheduler.py — ROADMAP 2d
#: telemetry): the batching window each epoch's seed CLOSED at,
#: labeled ``{mode="fixed"|"adaptive"}``, so the adaptive lever's
#: chosen-window distribution sits next to the stage waterfalls it
#: shapes.  Missing family diffs as EMPTY, the HIST_KEYS convention.
COALESCE_HIST_KEYS = ("coalesce_window_s",)
#: SLO-monitor counters (obs/slo.py — docs/observability.md "SLO
#: monitor"): Recorder counters incremented on burn-rate alert STATE
#: TRANSITIONS (firing/resolved both count — the alert churn rate is
#: itself an operational signal).  The continuous per-objective values
#: render as ``br_slo_*`` gauges on the router ``/metrics``
#: (SloMonitor.prometheus), not as counters.  Absent from a run with
#: no monitor — ``obs.diff`` maps a missing key to 0 (the FAULT_KEYS
#: convention).
SLO_KEYS = ("slo_alerts",)


#: THE counter-family registry: every ``*_KEYS`` family above must appear
#: here with its semantics declared, so a consumer (``obs.diff``,
#: the Prometheus renderers, fleet merge) can treat any key correctly
#: without per-family special cases — and a FUTURE family cannot land
#: without declaring itself (the audit reflects over the module).
#:
#: ``kind``: ``device`` counters ride the solver stats carry; ``host``
#: counters are Recorder counters.  ``semantics``: ``additive`` keys
#: sum across lanes/segments/hosts; ``sample`` keys are slot-keyed
#: payload buffers that must never enter counter totals; ``histogram``
#: keys are fixed-bucket distributions (``HIST_BUCKET_EDGES``) merged
#: by slot-wise sum and rendered as Prometheus ``_bucket``/``_sum``/
#: ``_count`` families — they live in the report's ``histograms``
#: section, never in ``counters``; per-key ``gauges`` overrides mark
#: high-water marks reduced by max (the ``GAUGE_KEYS`` marker is
#: derived-equal by the audit).
#: ``missing_zero``: the key is absent from a report whose run never
#: exercised the surface, and ``obs.diff`` maps missing to 0 — REQUIRED
#: for every host family (a fault-free baseline must diff cleanly
#: against a faulted run instead of reporting "None -> n").
FAMILIES = {
    "solver-common": {"keys": COMMON_KEYS, "kind": "device",
                      "semantics": "additive", "missing_zero": False},
    "solver-bdf": {"keys": BDF_KEYS, "kind": "device",
                   "semantics": "additive", "gauges": GAUGE_KEYS,
                   "missing_zero": False},
    "audit": {"keys": AUDIT_KEYS, "kind": "device",
              "semantics": "sample", "missing_zero": False},
    "timeline": {"keys": TIMELINE_KEYS, "kind": "device",
                 "semantics": "sample", "missing_zero": False},
    "fault": {"keys": FAULT_KEYS, "kind": "host",
              "semantics": "additive", "missing_zero": True},
    "admission": {"keys": ADMISSION_KEYS, "kind": "host",
                  "semantics": "additive", "missing_zero": True},
    "live": {"keys": LIVE_KEYS, "kind": "host",
             "semantics": "additive", "missing_zero": True},
    "serve": {"keys": SERVE_KEYS, "kind": "host",
              "semantics": "additive", "missing_zero": True},
    "aot": {"keys": AOT_KEYS, "kind": "host",
            "semantics": "additive", "missing_zero": True},
    "serve-stage-hist": {"keys": HIST_KEYS, "kind": "host",
                         "semantics": "histogram",
                         "missing_zero": True},
    "fleet": {"keys": FLEET_KEYS, "kind": "host",
              "semantics": "additive", "missing_zero": True},
    "route-hist": {"keys": ROUTE_HIST_KEYS, "kind": "host",
                   "semantics": "histogram", "missing_zero": True},
    "coalesce-hist": {"keys": COALESCE_HIST_KEYS, "kind": "host",
                      "semantics": "histogram", "missing_zero": True},
    "slo": {"keys": SLO_KEYS, "kind": "host",
            "semantics": "additive", "missing_zero": True},
    "graph": {"keys": GRAPH_KEYS, "kind": "host",
              "semantics": "additive", "missing_zero": True},
}


def missing_zero_keys():
    """Every key the ``obs.diff`` missing->0 convention covers — the
    union over families declaring ``missing_zero`` (diff consumes THIS,
    so registering a family enrolls its keys automatically)."""
    return {k for meta in FAMILIES.values() if meta.get("missing_zero")
            for k in meta["keys"]}


# --------------------------------------------------------------------------
# histograms (the HIST_KEYS family machinery — docs/observability.md)
# --------------------------------------------------------------------------
#: THE fixed log-spaced bucket ladder every duration histogram shares:
#: upper bounds in seconds, 100 us doubling to ~52 s (20 slots), plus
#: an implicit +Inf overflow slot (``counts`` has one more entry than
#: edges).  Fixed and global so two histograms — two segments of one
#: run, two hosts, baseline vs candidate — merge by SLOT-WISE SUM with
#: no re-bucketing, the same reason Prometheus histograms fix ``le``.
HIST_BUCKET_EDGES = tuple(1e-4 * 2.0 ** i for i in range(20))


def hist_new():
    """An empty histogram dict: ``{"counts", "sum", "count"}`` over
    :data:`HIST_BUCKET_EDGES` (+1 overflow slot)."""
    return {"counts": [0] * (len(HIST_BUCKET_EDGES) + 1),
            "sum": 0.0, "count": 0}


def hist_observe(h, value):
    """Fold one observation into histogram dict ``h`` (in place)."""
    v = float(value)
    idx = bisect.bisect_left(HIST_BUCKET_EDGES, v)
    h["counts"][idx] += 1
    h["sum"] += v
    h["count"] += 1
    return h


def hist_merge(a, b):
    """Slot-wise sum of two histogram dicts (the fleet/segment merge);
    loud on a bucket-schema mismatch — merging differently-bucketed
    histograms would silently mis-shelve counts."""
    if len(a["counts"]) != len(b["counts"]):
        raise ValueError(
            f"histogram bucket schemas differ ({len(a['counts'])} vs "
            f"{len(b['counts'])} slots); merge needs one fixed ladder")
    return {"counts": [x + y for x, y in zip(a["counts"], b["counts"])],
            "sum": a["sum"] + b["sum"], "count": a["count"] + b["count"]}


def hist_quantile(h, q):
    """The ``q`` quantile (0..1) estimated from the bucket counts with
    linear interpolation inside the landing bucket (the
    ``histogram_quantile`` rule); ``None`` on an empty histogram.  An
    overflow-bucket landing returns the top edge — a LOWER bound, the
    honest answer a bounded ladder can give.  Uses the series' own
    ``le`` edges when present (an archived report is self-describing),
    else the process-wide :data:`HIST_BUCKET_EDGES`."""
    n = int(h.get("count", 0))
    if n <= 0:
        return None
    le = h.get("le") or HIST_BUCKET_EDGES
    rank = q * n
    cum = 0
    for i, c in enumerate(h["counts"]):
        if c == 0:
            continue
        if cum + c >= rank:
            if i >= len(le):
                return le[-1]
            lo = le[i - 1] if i > 0 else 0.0
            hi = le[i]
            frac = (rank - cum) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        cum += c
    return le[-1]


def hist_mean(h):
    """Mean of the exact observation sum (not bucket-estimated);
    ``None`` on empty."""
    n = int(h.get("count", 0))
    return (h["sum"] / n) if n else None


def occupancy(counters):
    """Derived occupancy gauge: ``lane_attempts / lane_capacity`` from a
    report's counter dict, or ``None`` when the pair is absent/zero (the
    sweep did not run a segmented driver that records capacity)."""
    cap = (counters or {}).get("lane_capacity")
    if not cap:
        return None
    return float((counters or {}).get("lane_attempts", 0)) / float(cap)


def masked_add(acc, seg, live):
    """``acc + seg`` where ``live`` (a (B,) bool mask), 0 elsewhere —
    broadcasting the mask over trailing axes (the order histogram is
    (B, MAXORD+1)).  The segmented sweep driver uses this so a lane only
    accumulates counters from segments it was still running in."""
    acc = np.asarray(acc)
    seg = np.asarray(seg)
    mask = np.asarray(live)
    mask = mask.reshape(mask.shape + (1,) * (seg.ndim - mask.ndim))
    return acc + np.where(mask, seg, 0)


def accumulate(total, seg_stats, live):
    """Fold one segment's stats dict into the running ``total`` (None on
    the first segment), masking by per-lane liveness.  Audit payloads
    (ring / iteration matrix) are *replaced*, not summed — the latest
    live segment wins, matching the ring's most-recent-attempts meaning."""
    if total is None:
        total = {}
        for k, v in seg_stats.items():
            if k in AUDIT_KEYS or k in TIMELINE_KEYS:
                total[k] = np.asarray(v)
            else:
                # gauges start from their first live observation too:
                # max(0, v) == v for the int32 high-water marks
                total[k] = masked_add(np.zeros_like(np.asarray(v)), v, live)
        return total
    out = dict(total)
    for k, v in seg_stats.items():
        if k in AUDIT_KEYS or k in TIMELINE_KEYS:
            mask = np.asarray(live)
            mask = mask.reshape(mask.shape + (1,) * (np.asarray(v).ndim
                                                     - mask.ndim))
            out[k] = np.where(mask, np.asarray(v), total[k])
        elif k in GAUGE_KEYS:
            # high-water mark across segments, not a sum (a reuse streak
            # broken by a segment boundary reports the larger piece)
            out[k] = np.maximum(total[k],
                                masked_add(np.zeros_like(total[k]), v, live))
        else:
            out[k] = masked_add(total[k], v, live)
    return out


def totals(stats):
    """Reduce a (possibly lane-batched) stats dict to python totals:
    scalar counters sum over every axis; ``order_hist`` sums over the
    batch axis only (stays a per-order list); gauges (``GAUGE_KEYS``)
    take the max; audit payloads are dropped (they are samples, not
    counters)."""
    if stats is None:
        return None
    out = {}
    for k, v in stats.items():
        if k in AUDIT_KEYS or k in TIMELINE_KEYS:
            # sample buffers, not counters: summing ring slots would
            # report a number with no meaning
            continue
        a = np.asarray(v)
        if k == "order_hist":
            hist = a.reshape(-1, a.shape[-1]).sum(axis=0)
            out[k] = [int(x) for x in hist]
        elif k in GAUGE_KEYS:
            out[k] = int(a.max())
        else:
            out[k] = int(a.sum())
    return out


def per_lane(stats):
    """Per-lane numpy view of a batched stats dict (audit payloads
    dropped); ``None`` passes through."""
    if stats is None:
        return None
    return {k: np.asarray(v) for k, v in stats.items()
            if k not in AUDIT_KEYS}
