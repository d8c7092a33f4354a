"""Render, export and diff telemetry reports (``br-obs-v1``).

The port's counterpart of ``scripts/obs_report.py``: every number it
prints comes off the structured ``obs`` report (host spans, per-lane
solver counters, the compile watch).  A report written by either package
reads here.

  # run a file-driven case with telemetry and render the report
  python -m batchreactor_tpu_torch.tools.obs_report \\
      --run tests/fixtures/batch_h2o2.xml --lib tests/fixtures --gaschem \\
      --out h2o2.jsonl --device cpu

  # render a stored report, or re-export it
  python -m batchreactor_tpu_torch.tools.obs_report h2o2.jsonl
  python -m batchreactor_tpu_torch.tools.obs_report h2o2.jsonl --json
  python -m batchreactor_tpu_torch.tools.obs_report h2o2.jsonl --prom

  # per-lane step timelines of a timeline=N sweep's report
  python -m batchreactor_tpu_torch.tools.obs_report sweep.jsonl --timeline

  # before/after comparison
  python -m batchreactor_tpu_torch.tools.obs_report --diff a.jsonl b.jsonl

``--device`` (for ``--run``) defaults to the GPU (``cuda``).
"""

import argparse
import os
import shutil
import sys
import tempfile

from batchreactor_tpu_torch import obs

_FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "fixtures")


def _build_parser():
    ap = argparse.ArgumentParser(
        prog="obs_report",
        description="render / export / diff obs telemetry reports")
    ap.add_argument("report", nargs="?", help="stored report (.jsonl)")
    ap.add_argument("--run", metavar="BATCH_XML",
                    help="run a file-driven case with telemetry=True and "
                         "report on it")
    ap.add_argument("--lib", default=_FIXTURES,
                    help="mechanism library dir for --run (default: the "
                         "vendored test fixtures)")
    ap.add_argument("--gaschem", action="store_true",
                    help="--run with gas chemistry")
    ap.add_argument("--surfchem", action="store_true",
                    help="--run with surface chemistry")
    ap.add_argument("--device", default=None,
                    help="device of --run (default cuda)")
    ap.add_argument("--out", help="also write the report as JSONL here")
    ap.add_argument("--json", action="store_true",
                    help="print the JSONL export instead of the rendering")
    ap.add_argument("--prom", action="store_true",
                    help="print the Prometheus text exposition instead")
    ap.add_argument("--diff", nargs=2, metavar=("A", "B"),
                    help="diff two stored reports (baseline -> candidate)")
    ap.add_argument("--timeline", action="store_true",
                    help="render the per-lane solver timelines instead "
                         "(a report from a timeline=N run)")
    ap.add_argument("--lanes",
                    help="comma-separated lane indices for --timeline "
                         "(default: the most-rejecting lanes)")
    return ap


def main(argv=None):
    ap = _build_parser()
    args = ap.parse_args(argv)
    if args.diff:
        a, b = (obs.read_jsonl(p) for p in args.diff)
        print(obs.diff(a, b))
        return 0
    if args.run:
        import batchreactor_tpu_torch as bt

        if not (args.gaschem or args.surfchem):
            args.gaschem = True
        # profile files land next to the input XML: run from a copy
        with tempfile.TemporaryDirectory() as tmp:
            xml = os.path.join(tmp, os.path.basename(args.run))
            shutil.copy(args.run, xml)
            ret, report = bt.batch_reactor(
                xml, args.lib, gaschem=args.gaschem, surfchem=args.surfchem,
                verbose=False, telemetry=True, device=args.device)
        print(f"status: {ret}", file=sys.stderr)
    elif args.report:
        report = obs.read_jsonl(args.report)
    else:
        ap.error("give a stored report, --run, or --diff")
    if args.out:
        obs.write_jsonl(args.out, report)
        print(f"wrote {args.out}", file=sys.stderr)
    if args.json:
        sys.stdout.write(obs.to_jsonl(report))
    elif args.prom:
        sys.stdout.write(obs.to_prometheus(report))
    elif args.timeline:
        lanes = ([int(x) for x in args.lanes.split(",")]
                 if args.lanes else None)
        print(obs.timeline.render(report, lanes=lanes))
    else:
        print(obs.render(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
