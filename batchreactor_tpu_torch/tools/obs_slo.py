"""Evaluate SLO objectives over stitched fleet traces; gate in CI (the
port's ``scripts/obs_slo.py``).

Input is a fleet obs dir (the ``tools/serve_fleet.py --obs-dir``
layout: ``router.jsonl`` + one ``<member>.jsonl`` per member) or any
single obs report JSONL with ``request_trace`` events.  The traces are
stitched (``obs.stitch``) and the default objectives (``obs.slo``:
p95 end-to-end latency, error rate, failover rate) — or the baseline's
own — evaluate over them:

  # the summary table
  python -m batchreactor_tpu_torch.tools.obs_slo --fleet fleet/obs

  # CI gate: exit nonzero when any objective breaches its band
  python -m batchreactor_tpu_torch.tools.obs_slo --fleet fleet/obs \\
      --gate --baseline tests/fixtures/fleet_slo_baseline.json

Baseline grammar (schema ``br-slo-gate-v1``)::

    {"schema": "br-slo-gate-v1",
     "objectives": {
       "latency_p95":   {"kind": "latency", "budget": 0.05,
                         "threshold_s": 2.5,
                         "bad_fraction": {"max": 0.05}},
       "error_rate":    {"kind": "error", "budget": 0.01,
                         "bad_fraction": {"max": 0.0}},
       "failover_rate": {"kind": "failover", "budget": 0.05,
                         "bad_fraction": {"max": 0.5}}},
     "requests": {"min": 1}}

Each objective entry declares the contract (``kind`` / ``budget`` /
``threshold_s`` — the ``obs.slo.Objective`` fields) plus tolerance
bands (``{"min","max","equals"}`` — the ``obs_gate`` band grammar)
over the measured ``bad_fraction`` / ``bad`` / ``requests`` / ``burn``;
an omitted band means "just the budget check" (``bad_fraction <=
budget``).  ``requests`` at the top level bands the stitched-trace
count, so an empty run fails loudly instead of vacuously passing.
"""

import argparse
import json
import os
import sys

from batchreactor_tpu_torch.obs import read_jsonl
from batchreactor_tpu_torch.obs.slo import Objective, evaluate_traces
from batchreactor_tpu_torch.obs.stitch import load_fleet, stitch
from batchreactor_tpu_torch.tools.obs_gate import _check_band, _fmt

#: the banked-baseline schema this gate speaks — bump on any grammar
#: change
SLO_GATE_SCHEMA = "br-slo-gate-v1"

#: per-objective result fields a baseline may band
_BANDABLE = ("requests", "bad", "bad_fraction", "burn")


def load_objectives(baseline):
    """The baseline's objectives as ``obs.slo.Objective`` instances
    (``None`` -> the library defaults)."""
    if baseline is None or "objectives" not in baseline:
        return None
    objs = []
    for name, spec in sorted(baseline["objectives"].items()):
        objs.append(Objective(name, spec["kind"], spec["budget"],
                              threshold_s=spec.get("threshold_s")))
    return tuple(objs)


def run_slo_gate(baseline, results, n_traces):
    """Band every objective's measurements; ``(failures, lines)`` —
    the ``obs_gate.run_gate`` contract."""
    if baseline.get("schema", SLO_GATE_SCHEMA) != SLO_GATE_SCHEMA:
        raise ValueError(f"unsupported SLO gate schema "
                         f"{baseline.get('schema')!r} (this gate "
                         f"speaks {SLO_GATE_SCHEMA})")
    known = {"schema", "description", "objectives", "requests"}
    unknown = sorted(set(baseline) - known)
    if unknown:
        raise ValueError(f"unknown SLO gate section(s) {unknown}; "
                         f"known: {sorted(known)}")
    lines, failures = [], []

    def row(ok, name, value, detail):
        line = (f"  [{'ok' if ok else 'FAIL':>4s}] {name}: "
                f"{_fmt(value)} (want {detail})")
        lines.append(line)
        if not ok:
            failures.append(line)

    if "requests" in baseline:
        ok, detail = _check_band(n_traces, baseline["requests"])
        row(ok, "stitched traces", n_traces, detail)
    for name, spec in sorted((baseline.get("objectives") or {}).items()):
        res = results[name]
        row(res["ok"], f"{name} budget", res["bad_fraction"],
            f"<= {res['budget']} (budget)")
        for field in _BANDABLE:
            if field in spec:
                ok, detail = _check_band(res[field], spec[field])
                row(ok, f"{name} {field}", res[field], detail)
    return failures, lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("report", nargs="?",
                    help="single obs report JSONL (request_trace "
                         "events)")
    ap.add_argument("--fleet", metavar="DIR",
                    help="fleet obs dir (tools/serve_fleet.py --obs-dir "
                         "layout) to stitch and evaluate")
    ap.add_argument("--baseline",
                    help="banked br-slo-gate-v1 JSON (objectives + "
                         "tolerance bands)")
    ap.add_argument("--gate", action="store_true",
                    help="exit nonzero when any objective breaches "
                         "(CI mode; requires --baseline)")
    ap.add_argument("--json", action="store_true",
                    help="emit the evaluation as JSON instead of the "
                         "table")
    args = ap.parse_args(argv)
    if (args.report is None) == (args.fleet is None):
        ap.error("exactly one of REPORT or --fleet DIR is required")
    if args.gate and not args.baseline:
        ap.error("--gate requires --baseline")

    if args.fleet:
        reports = load_fleet(args.fleet)
    else:
        reports = [(os.path.splitext(os.path.basename(
            args.report))[0], read_jsonl(args.report))]
    traces = stitch(reports)
    baseline = None
    if args.baseline:
        with open(args.baseline) as f:
            baseline = json.load(f)
    results = evaluate_traces(traces, load_objectives(baseline))
    if args.json:
        print(json.dumps({"schema": SLO_GATE_SCHEMA,
                          "traces": len(traces),
                          "objectives": results}, sort_keys=True))
        if args.gate:
            failures, _ = run_slo_gate(baseline, results, len(traces))
            return 1 if failures else 0
        return 0
    print(f"SLO evaluation over {len(traces)} stitched trace(s) "
          f"({'fleet ' + args.fleet if args.fleet else args.report}):")
    for name, res in sorted(results.items()):
        thr = (f" threshold={res['threshold_s']}s"
               if "threshold_s" in res else "")
        print(f"  {name} [{res['kind']}]{thr}: "
              f"{res['bad']}/{res['requests']} bad "
              f"(fraction {res['bad_fraction']}, budget "
              f"{res['budget']}, burn {res['burn']}) "
              f"{'ok' if res['ok'] else 'BREACH'}")
    if baseline is not None:
        failures, lines = run_slo_gate(baseline, results, len(traces))
        print("gate:")
        print("\n".join(lines))
        if failures:
            print(f"SLO GATE FAILED ({len(failures)} breach(es))")
            return 1 if args.gate else 0
        print("slo gate ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
