"""Render per-request latency waterfalls from trace JSONL (the port's
``scripts/obs_trace.py``).

Input is an obs report JSONL (``tools/serve.py --obs-out`` /
``tools/serve_bench.py --obs-out``, or any ``obs.write_jsonl`` artifact
of either package):
every ``request_trace`` event — one per request the serving scheduler
resolved (obs/trace.py) — renders as a stage waterfall, so "where did
this request's latency go" is one command against the daemon's run
record:

  # every request, arrival order
  python -m batchreactor_tpu_torch.tools.obs_trace serve_obs.jsonl

  # the 10 slowest (the latency-triage view)
  python -m batchreactor_tpu_torch.tools.obs_trace serve_obs.jsonl \\
      --slowest 10

  # only requests past 250 ms, machine-readable
  python -m batchreactor_tpu_torch.tools.obs_trace serve_obs.jsonl \\
      --threshold-ms 250 --json

  # FLEET mode: stitch router + member streams into cross-host
  # waterfalls (docs/observability.md "Fleet tracing")
  python -m batchreactor_tpu_torch.tools.obs_trace --fleet fleet/obs \\
      --slowest 10

Stages (docs/observability.md "Request tracing"):
``submitted -> coalesced`` queue wait + coalesce window,
``-> admitted`` epoch hand-off, ``-> first_harvest`` resident solve,
``-> stalled`` (injected fault only), ``-> resolved`` harvest tail.

``--fleet DIR`` reads the ``tools/serve_fleet.py --obs-dir`` layout
(``router.jsonl`` + one ``<member>.jsonl`` per member), joins each
router hop ledger with its member's stage waterfall
(``obs.stitch`` — clock-skew corrected by the router's send/recv
bracket), and renders per-hop + per-stage attribution with failover
chains flagged; ``--json`` emits the stitched trace records.
"""

import argparse
import json
import sys

from batchreactor_tpu_torch import obs
from batchreactor_tpu_torch.obs import stitch as fleet_stitch
from batchreactor_tpu_torch.obs.trace import STAGE_ORDER

#: waterfall bar budget (columns for the longest segment on display)
_BAR = 36


def load_traces(report):
    """The ``request_trace`` event attribute dicts of a report, in
    event (= resolution) order."""
    out = []
    for e in report.get("events") or []:
        if e.get("name") == "request_trace":
            out.append(dict(e.get("attrs") or {}))
    return out


def select_traces(traces, slowest=None, threshold_ms=None):
    """THE filter both output modes share: drop requests under the
    threshold, then (``slowest``) keep the N largest totals, slowest
    first; otherwise resolution order is preserved."""
    if threshold_ms is not None:
        traces = [t for t in traces
                  if 1e3 * float(t.get("total_s", 0.0)) >= threshold_ms]
    if slowest is not None:
        traces = sorted(traces, key=lambda t: -float(t.get("total_s",
                                                           0.0)))
        traces = traces[:int(slowest)]
    return traces


def render_waterfalls(traces, slowest=None, threshold_ms=None):
    """The multi-line waterfall rendering (module doc) over trace
    attribute dicts (``RequestTrace.to_attrs`` shape)."""
    traces = select_traces(traces, slowest=slowest,
                           threshold_ms=threshold_ms)
    order = ("slowest first" if slowest is not None
             else "resolution order")
    if not traces:
        return "(no request_trace events match)"
    lines = [f"request waterfalls ({len(traces)} requests, {order})"]
    scale = max(max((d for t in traces
                     for d in (t.get("segments") or {}).values()),
                    default=0.0), 1e-9)
    for t in traces:
        total_ms = 1e3 * float(t.get("total_s", 0.0))
        head = (f"{t.get('request', '?')}  lanes={t.get('lanes', '?')}  "
                f"total {total_ms:.1f}ms")
        if t.get("failed"):
            head += "  [FAILED]"
        lines.append(head)
        segs = t.get("segments") or {}
        stages = t.get("stages") or {}
        prev = "submitted"
        for stage in STAGE_ORDER[1:]:
            if stage not in segs and stage not in stages:
                continue
            dur = float(segs.get(stage, 0.0))
            bar = "#" * max(1 if dur > 0 else 0,
                            round(_BAR * dur / scale))
            lines.append(f"  {prev + ' -> ' + stage:<28s} "
                         f"{1e3 * dur:9.2f}ms  {bar}")
            prev = stage
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("report", nargs="?",
                    help="obs report JSONL with request_trace events "
                         "(single-host mode)")
    ap.add_argument("--fleet", metavar="DIR",
                    help="fleet obs dir (tools/serve_fleet.py --obs-dir "
                         "layout): stitch router + member streams "
                         "into cross-host waterfalls")
    ap.add_argument("--slowest", type=int, metavar="N",
                    help="render only the N slowest requests, "
                         "slowest first")
    ap.add_argument("--threshold-ms", type=float,
                    help="drop requests faster than this")
    ap.add_argument("--json", action="store_true",
                    help="emit the matching trace records as JSONL "
                         "instead of the rendering")
    ap.add_argument("--out", help="also write the rendering here")
    args = ap.parse_args(argv)
    if (args.report is None) == (args.fleet is None):
        ap.error("exactly one of REPORT or --fleet DIR is required")

    if args.fleet:
        stitched = fleet_stitch.stitch(fleet_stitch.load_fleet(
            args.fleet))
        if args.json:
            for t in fleet_stitch.select_traces(
                    stitched, slowest=(args.slowest
                                       if args.slowest is not None
                                       else len(stitched)),
                    threshold_ms=args.threshold_ms):
                print(json.dumps(t, sort_keys=True))
            return 0
        text = fleet_stitch.render_fleet(
            stitched, slowest=(args.slowest
                               if args.slowest is not None
                               else len(stitched)),
            threshold_ms=args.threshold_ms)
    else:
        traces = load_traces(obs.read_jsonl(args.report))
        if args.json:
            for t in select_traces(traces, slowest=args.slowest,
                                   threshold_ms=args.threshold_ms):
                print(json.dumps(t, sort_keys=True))
            return 0
        text = render_waterfalls(traces, slowest=args.slowest,
                                 threshold_ms=args.threshold_ms)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
