"""The perf-regression gate: band-check an obs report against a banked
baseline (the port's ``scripts/obs_gate.py``).

A fresh obs report JSONL (``tools/serve_bench.py --obs-out``,
``tools/serve.py --obs-out`` or any ``obs.write_jsonl`` artifact, from
either package) is checked against a banked baseline JSON of per-metric
tolerance bands; every band renders as a pass/fail row and any failure
exits nonzero.

  python -m batchreactor_tpu_torch.tools.obs_gate \\
      --baseline tests/fixtures/serve_gate_baseline.json \\
      --report serve_obs.jsonl

Baseline grammar (``br-obs-gate-v1``) — every section optional, every
leaf a band ``{"min": x, "max": y, "equals": z}`` (any subset)::

    {"schema": "br-obs-gate-v1",
     "description": "why these bands were chosen",
     "counters":   {"serve_failed": {"max": 0},
                    "serve_answered": {"equals": 30}},
     "histograms": {"serve_stage_seconds": {
                        "stage=total": {"count": {"min": 30},
                                        "p50_s": {"max": 2.0},
                                        "p99_s": {"max": 10.0}}}},
     "compile":    {"retraces": {"max": 0}},
     "spans":      {"solve": {"max": 60.0}}}

* **counters** check the report's counter dict, missing -> 0 (the
  ``obs.diff`` convention, so a never-exercised surface bands cleanly).
* **histograms** select one series per ``k=v[,k=v]`` label selector of
  a family (obs/counters.py HIST_KEYS) and band its ``count`` /
  ``sum_s`` / ``mean_s`` / ``p50_s`` / ``p90_s`` / ``p95_s`` /
  ``p99_s``; a MISSING series is empty — ``count`` bands see 0 and a
  quantile band fails loudly ("no observations"), which is exactly
  what a disappeared metric should do.
* **compile** bands the compile summary scalars (``compiles`` /
  ``retraces`` / ``cache_misses``...), missing -> 0.
* **spans** bands total wall seconds per span name.

Counters want exact-or-bounded bands; histogram quantiles want bands
loose enough to be non-flaky on shared CI runners (document the choice
in the baseline's ``description``).
"""

import argparse
import json
import os
import sys

from batchreactor_tpu_torch import obs
from batchreactor_tpu_torch.obs import counters as C

GATE_SCHEMA = "br-obs-gate-v1"

_HIST_METRICS = ("count", "sum_s", "mean_s", "p50_s", "p90_s",
                 "p95_s", "p99_s")


def _check_band(value, band):
    """(ok, detail) for one value against ``{"min","max","equals"}``."""
    bad = sorted(set(band) - {"min", "max", "equals"})
    if bad:
        raise ValueError(f"unknown band key(s) {bad}; known: "
                         f"['equals', 'max', 'min']")
    if value is None:
        return False, "no observations"
    parts, ok = [], True
    if "equals" in band:
        good = value == band["equals"]
        ok &= good
        parts.append(f"== {band['equals']}")
    if "min" in band:
        good = value >= band["min"]
        ok &= good
        parts.append(f">= {band['min']}")
    if "max" in band:
        good = value <= band["max"]
        ok &= good
        parts.append(f"<= {band['max']}")
    return ok, " and ".join(parts) or "(empty band)"


def _parse_selector(sel):
    """``"stage=total,mech=h2o2"`` -> label dict ("" = unlabeled)."""
    labels = {}
    for part in str(sel).split(","):
        part = part.strip()
        if not part:
            continue
        k, eq, v = part.partition("=")
        if not eq or not k:
            raise ValueError(f"histogram selector {sel!r} wants "
                             f"k=v[,k=v] (or '' for unlabeled)")
        labels[k.strip()] = v.strip()
    return labels


def _hist_metric(ser, metric):
    if metric == "count":
        return ser["count"]
    if metric == "sum_s":
        return ser["sum"]
    if metric == "mean_s":
        return C.hist_mean(ser)
    if metric.startswith("p") and metric.endswith("_s"):
        return C.hist_quantile(ser, float(metric[1:-2]) / 100.0)
    raise ValueError(f"unknown histogram metric {metric!r}; known: "
                     f"{list(_HIST_METRICS)}")


def _fmt(v):
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def run_gate(baseline, report):
    """Evaluate every band; returns ``(failures, lines)`` — the
    rendered pass/fail table and the failing rows."""
    if baseline.get("schema", GATE_SCHEMA) != GATE_SCHEMA:
        raise ValueError(f"unsupported gate schema "
                         f"{baseline.get('schema')!r} (this gate "
                         f"speaks {GATE_SCHEMA})")
    known = {"schema", "description", "counters", "histograms",
             "compile", "spans"}
    unknown = sorted(set(baseline) - known)
    if unknown:
        raise ValueError(f"unknown gate section(s) {unknown}; known: "
                         f"{sorted(known)}")
    lines, failures = [], []

    def row(ok, kind, name, value, detail):
        line = (f"  [{'ok' if ok else 'FAIL':>4s}] {kind} {name}: "
                f"{_fmt(value)} (want {detail})")
        lines.append(line)
        if not ok:
            failures.append(line)

    ctrs = report.get("counters") or {}
    for name, band in sorted((baseline.get("counters") or {}).items()):
        ok, detail = _check_band(ctrs.get(name) or 0, band)
        row(ok, "counter", name, ctrs.get(name) or 0, detail)

    hists = report.get("histograms") or {}
    for fam, selectors in sorted((baseline.get("histograms")
                                  or {}).items()):
        series = {tuple(sorted((ser.get("labels") or {}).items())): ser
                  for ser in hists.get(fam) or []}
        for sel, metrics in sorted(selectors.items()):
            labels = _parse_selector(sel)
            ser = series.get(tuple(sorted(labels.items())),
                             C.hist_new())
            name = fam + ("{" + sel + "}" if sel else "")
            for metric, band in sorted(metrics.items()):
                value = _hist_metric(ser, metric)
                ok, detail = _check_band(value, band)
                row(ok, "hist", f"{name} {metric}", value, detail)

    comp = report.get("compile") or {}
    for name, band in sorted((baseline.get("compile") or {}).items()):
        ok, detail = _check_band(comp.get(name) or 0, band)
        row(ok, "compile", name, comp.get(name) or 0, detail)

    span_totals = {}
    for s in report.get("spans") or []:
        if s.get("dur") is not None:
            span_totals[s["name"]] = (span_totals.get(s["name"], 0.0)
                                      + s["dur"])
    for name, band in sorted((baseline.get("spans") or {}).items()):
        ok, detail = _check_band(span_totals.get(name, 0.0), band)
        row(ok, "span", name, span_totals.get(name, 0.0), detail)

    return failures, lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True,
                    help="banked tolerance-band JSON (br-obs-gate-v1)")
    ap.add_argument("--report", required=True,
                    help="candidate obs report JSONL")
    args = ap.parse_args(argv)

    with open(args.baseline) as f:
        baseline = json.load(f)
    report = obs.read_jsonl(args.report)

    desc = baseline.get("description")
    print(f"obs gate [{GATE_SCHEMA}] baseline="
          f"{os.path.basename(args.baseline)}"
          + (f"\n  ({desc})" if desc else ""))
    failures, lines = run_gate(baseline, report)
    for line in lines:
        print(line)
    if failures:
        print(f"GATE FAILED: {len(failures)} band(s) out of tolerance",
              file=sys.stderr)
        for line in failures:
            print(line, file=sys.stderr)
        return 1
    print(f"gate passed ({len(lines)} bands)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
