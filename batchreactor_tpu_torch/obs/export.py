"""Machine-readable report exports: JSON-Lines and Prometheus text.

Port of ``batchreactor_tpu/obs/export.py``; the record kinds, metric
names and help texts are the reference's, so both packages export a
report to equal text.

Two formats, two consumers:

* **JSONL** (:func:`to_jsonl` / :func:`from_jsonl`) — one self-describing
  JSON object per line, ``kind``-tagged (``meta`` / ``span`` / ``event``
  / ``counter`` / ``solver_stats`` / ``compile``), streaming-friendly and
  exactly round-trippable back into the report dict.  This is the CI
  artifact format and what ``tools/obs_report.py --json`` emits.
* **Prometheus text exposition** (:func:`to_prometheus`) — the
  scrape-compatible gauge/counter rendering for wiring a long-running
  sweep service into standard dashboards.  Metric names are prefixed
  ``br_``; label values are escaped per the exposition format.
"""

import json

from .report import SCHEMA


# --------------------------------------------------------------------------
# JSONL
# --------------------------------------------------------------------------
def to_jsonl(report):
    """Serialize a report dict (``report.build_report``) to JSON-Lines."""
    lines = [json.dumps({"kind": "meta", "schema": report.get("schema",
                                                              SCHEMA),
                         "meta": report.get("meta") or {}},
                        sort_keys=True)]
    for s in report.get("spans") or []:
        lines.append(json.dumps({"kind": "span", **s}, sort_keys=True))
    for e in report.get("events") or []:
        lines.append(json.dumps({"kind": "event", **e}, sort_keys=True))
    for k, v in sorted((report.get("counters") or {}).items()):
        lines.append(json.dumps({"kind": "counter", "name": k, "value": v},
                                sort_keys=True))
    for name in sorted(report.get("histograms") or {}):
        for ser in report["histograms"][name]:
            lines.append(json.dumps({"kind": "histogram", "name": name,
                                     **ser}, sort_keys=True))
    if report.get("solver_stats") is not None:
        lines.append(json.dumps({"kind": "solver_stats",
                                 **report["solver_stats"]}, sort_keys=True))
    if report.get("compile") is not None:
        lines.append(json.dumps({"kind": "compile", **report["compile"]},
                                sort_keys=True))
    return "\n".join(lines) + "\n"


def from_jsonl(text):
    """Inverse of :func:`to_jsonl`: rebuild the report dict."""
    report = {"schema": SCHEMA, "meta": {}, "spans": [], "events": [],
              "counters": {}, "histograms": None, "solver_stats": None,
              "compile": None}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        rec = json.loads(line)
        kind = rec.pop("kind")
        if kind == "meta":
            report["schema"] = rec.get("schema", SCHEMA)
            report["meta"] = rec.get("meta", {})
        elif kind == "span":
            report["spans"].append(rec)
        elif kind == "event":
            report["events"].append(rec)
        elif kind == "counter":
            report["counters"][rec["name"]] = rec["value"]
        elif kind == "histogram":
            if report["histograms"] is None:
                report["histograms"] = {}
            report["histograms"].setdefault(rec.pop("name"),
                                            []).append(rec)
        elif kind == "solver_stats":
            report["solver_stats"] = rec
        elif kind == "compile":
            report["compile"] = rec
        else:
            raise ValueError(f"unknown JSONL record kind {kind!r}")
    return report


def write_jsonl(path, report):
    """Write the JSONL export to ``path`` (atomic enough for CI: one
    write call)."""
    with open(path, "w") as f:
        f.write(to_jsonl(report))


def read_jsonl(path):
    """Load a report previously written by :func:`write_jsonl`."""
    with open(path) as f:
        return from_jsonl(f.read())


# --------------------------------------------------------------------------
# Prometheus text exposition
# --------------------------------------------------------------------------
def _esc(value):
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _labels(labels):
    """``{k: v}`` -> ``{k="v",...}`` (sorted, escaped; "" when empty) —
    THE label serializer every exposition family shares."""
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _metric(lines, name, mtype, help_, samples):
    """Append one metric family; ``samples`` is [(labels_dict, value)]."""
    if not samples:
        return
    lines.append(f"# HELP {name} {help_}")
    lines.append(f"# TYPE {name} {mtype}")
    for labels, value in samples:
        lines.append(f"{name}{_labels(labels)} {value}")


def _histogram(lines, name, help_, series):
    """Append one Prometheus histogram family: ``series`` is the
    report's per-label list (``{"labels", "le", "counts", "sum",
    "count"}`` — ``counts`` has a trailing +Inf overflow slot, checked
    loudly like ``hist_merge``).  Bucket counts render CUMULATIVE with
    the closing ``le="+Inf"`` sample equal to ``_count``, per the
    exposition format."""
    if not series:
        return
    lines.append(f"# HELP {name} {help_}")
    lines.append(f"# TYPE {name} histogram")
    for ser in series:
        labels = ser.get("labels") or {}
        if len(ser["counts"]) != len(ser["le"]) + 1:
            raise ValueError(
                f"histogram {name}{_labels(labels)} has "
                f"{len(ser['counts'])} count slots for "
                f"{len(ser['le'])} le edges (want edges + 1 overflow "
                f"slot); a silently mis-shelved series would render "
                f"_bucket{{le=\"+Inf\"}} != _count")
        cum = 0
        for le, c in zip(ser["le"], ser["counts"]):
            cum += c
            lines.append(f"{name}_bucket"
                         f"{_labels({**labels, 'le': f'{le:.6g}'})} "
                         f"{cum}")
        cum += ser["counts"][len(ser["le"])]
        lines.append(f"{name}_bucket"
                     f"{_labels({**labels, 'le': '+Inf'})} {cum}")
        lines.append(f"{name}_sum{_labels(labels)} {ser['sum']:.6f}")
        lines.append(f"{name}_count{_labels(labels)} {ser['count']}")


def to_prometheus(report):
    """Render the report as a Prometheus text exposition (format 0.0.4)."""
    lines = []
    # spans aggregate by name (a scrape wants totals, not the tree)
    agg = {}
    for s in report.get("spans") or []:
        if s.get("dur") is not None:
            a = agg.setdefault(s["name"], [0.0, 0])
            a[0] += s["dur"]
            a[1] += 1
    _metric(lines, "br_span_seconds_total", "counter",
            "Total wall-clock seconds per span name.",
            [({"span": k}, v[0]) for k, v in sorted(agg.items())])
    _metric(lines, "br_span_calls_total", "counter",
            "Number of completed spans per span name.",
            [({"span": k}, v[1]) for k, v in sorted(agg.items())])
    _metric(lines, "br_counter_total", "counter",
            "Recorder counters.",
            [({"name": k}, v) for k, v in
             sorted((report.get("counters") or {}).items())])

    # histogram families (obs/counters.py HIST_KEYS): the standard
    # Prometheus histogram triple — cumulative _bucket{le=} counts, the
    # exact observation _sum, and _count — one series per label set
    # (``br_serve_stage_seconds_bucket{le="0.0128",stage="total"}`` —
    # labels render sorted, so ``le`` comes first)
    for name in sorted(report.get("histograms") or {}):
        _histogram(lines, f"br_{name}",
                   f"Fixed log-spaced latency histogram '{name}' "
                   f"(seconds; obs/counters.py bucket ladder).",
                   report["histograms"][name])

    # continuous batching (parallel/sweep.py admission=): occupancy is a
    # DERIVED ratio of the additive lane_attempts/lane_capacity pair —
    # a gauge, its own family (summing ratios across scrapes would be
    # meaningless; the raw pair stays in br_counter_total)
    from .counters import occupancy as _occupancy

    occ = _occupancy(report.get("counters"))
    if occ is not None:
        _metric(lines, "br_sweep_occupancy", "gauge",
                "Sweep step-attempt occupancy: useful per-lane attempts "
                "/ device attempt capacity (continuous-batching "
                "admission surface).",
                [({}, round(occ, 6))])

    # fault/recovery events (resilience/ — docs/robustness.md) aggregate
    # by kind: the alerting surface for wedges, retries, reassignments,
    # and quarantines (the per-event detail stays in the JSONL export)
    faults = {}
    for e in report.get("events") or []:
        if e.get("name") == "fault":
            kind = (e.get("attrs") or {}).get("kind", "unknown")
            faults[kind] = faults.get(kind, 0) + 1
    _metric(lines, "br_fault_events_total", "counter",
            "Fault/recovery events by kind (resilience layer: wedge "
            "watchdog, chunk retry, corrupt-chunk resume, dead-host "
            "reassignment, lane quarantine).",
            [({"kind": k}, v) for k, v in sorted(faults.items())])

    totals = (report.get("solver_stats") or {}).get("totals") or {}
    steps = []
    if "n_accepted" in totals:
        steps.append(({"outcome": "accepted"}, totals["n_accepted"]))
    if "n_rejected" in totals:
        steps.append(({"outcome": "rejected"}, totals["n_rejected"]))
    _metric(lines, "br_solver_steps_total", "counter",
            "Solver step attempts by outcome.", steps)
    _metric(lines, "br_solver_work_total", "counter",
            "Solver work counters (Newton iterations, Jacobian builds, "
            "iteration-matrix factorizations, setup-economy reuses, "
            "rejection causes).",
            [({"kind": k}, totals[k]) for k in
             ("newton_iters", "jac_builds", "factorizations",
              "setup_reuses", "err_rejects", "conv_rejects") if k in totals])
    if "precond_age" in totals:
        # a high-water mark, not a monotone count: gauge, its own family
        _metric(lines, "br_solver_precond_age", "gauge",
                "Peak consecutive jac windows served by one iteration-"
                "matrix factorization (setup economy msbp high-water).",
                [({}, totals["precond_age"])])
    if "order_hist" in totals:
        _metric(lines, "br_solver_order_steps_total", "counter",
                "Accepted BDF steps by method order.",
                [({"order": str(q)}, n)
                 for q, n in enumerate(totals["order_hist"]) if q >= 1])

    comp = report.get("compile") or {}
    if comp.get("available"):
        _metric(lines, "br_compiles_total", "counter",
                "XLA backend compiles per program label.",
                [({"label": k}, v["compiles"])
                 for k, v in sorted((comp.get("by_label") or {}).items())])
        _metric(lines, "br_retraces_total", "counter",
                "Unexpected recompiles (compiles past the first) per "
                "program label.",
                [({"label": k}, v["retraces"])
                 for k, v in sorted((comp.get("by_label") or {}).items())])
        _metric(lines, "br_compile_seconds_total", "counter",
                "XLA backend compile seconds per program label.",
                [({"label": k}, v["compile_s"])
                 for k, v in sorted((comp.get("by_label") or {}).items())])
        _metric(lines, "br_compile_cache_total", "counter",
                "Persistent compilation-cache lookups per program label "
                "by result (the AOT warm-cache evidence surface).",
                [({"label": k, "result": res}, v.get(key, 0))
                 for k, v in sorted((comp.get("by_label") or {}).items())
                 for res, key in (("hit", "cache_hits"),
                                  ("miss", "cache_misses"))])
    return "\n".join(lines) + ("\n" if lines else "")
