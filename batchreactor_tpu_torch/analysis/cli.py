"""brlint command line of the port: tiered static analysis of captured
steps and of the threaded host stack.

* **Tier A** — AST scan of the given paths (:mod:`.rules_ast`); runs
  whenever paths are passed.
* **Tier C** — ``--contracts`` runs the step-program contract engine
  (:mod:`.contracts`: every registered contract's programs recorded on the
  h2o2 fixture, the completeness check, and the fingerprint/counter
  registry audits) on ``--device cpu`` (an op log of each step, run
  eagerly) or ``--device cuda`` (each step captured as a CUDA graph, its
  kernel nodes read); ``--concurrency`` runs the host-concurrency lint
  (:mod:`.concurrency`) over the threaded host modules; ``--tier C`` is
  both (plus the tier-A scan of any paths given).

The JAX package's tier B (``--jaxpr``) and tier D (``--budgets``) walk
jaxprs and have no counterpart here.  There is no silent fallback: a
contract tier that cannot run (``--device cuda`` without a card or
``nvcc``) raises and exits non-zero; it never reports clean.

**Exit-code contract** (as the JAX CLI's, with ``--json`` exactly as
without): 0 = clean (or fully baselined), 1 = one or more findings
survived, 2 = usage error.  A crashed lint propagates its nonzero status
rather than printing an empty findings list.

Examples:
  python -m batchreactor_tpu_torch.tools.brlint batchreactor_tpu_torch/ chip_smoke.py
  python -m batchreactor_tpu_torch.tools.brlint --tier C --device cpu
  python batchreactor_tpu_torch/tools/brlint.py batchreactor_tpu_torch/  # no torch needed
"""

import argparse
import json
import sys

from .core import Baseline, all_rules, lint_paths
from . import rules_ast  # noqa: F401  (registers the tier-A rules)


def _build_parser():
    p = argparse.ArgumentParser(
        prog="brlint",
        description="captured-step / host-concurrency linter for the "
                    "PyTorch/CUDA port (batchreactor_tpu_torch)")
    p.add_argument("paths", nargs="*", help="files or directories to "
                                            "scan (tier A)")
    p.add_argument("--tier", choices=["A", "C", "a", "c"],
                   help="run a whole tier: A = AST scan of paths, "
                        "C = --contracts + --concurrency (plus the tier-A "
                        "scan of any paths given)")
    p.add_argument("--select", help="comma-separated rule names to run "
                                    "(default: all)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalogue (tier A + "
                        "concurrency) and exit")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable output")
    p.add_argument("--baseline", metavar="FILE",
                   help="tracked-debt file: only source findings "
                        "(tier A + concurrency) absent from it fail "
                        "the scan; stale entries are reported")
    p.add_argument("--write-baseline", metavar="FILE",
                   help="record current source findings as the new "
                        "baseline and exit 0")
    p.add_argument("--contracts", action="store_true",
                   help="tier C: step-program contract engine — every "
                        "registered contract, the completeness check, "
                        "and the fingerprint/counter registry audits")
    p.add_argument("--concurrency", action="store_true",
                   help="tier C: host-concurrency lint over the threaded "
                        "host modules (serving/, fleet/, obs/live.py, "
                        "resilience/, parallel/sweep.py, solver/graphs.py)")
    p.add_argument("--device", choices=["cpu", "cuda"], default="cpu",
                   help="where the contract engine records its programs: "
                        "cpu = each step run eagerly under an op recorder, "
                        "cuda = each step captured as a CUDA graph")
    p.add_argument("--fixtures", default=None,
                   help="fixture directory for --contracts (default: "
                        "tests/fixtures next to the package)")
    return p


def main(argv=None):
    args = _build_parser().parse_args(argv)

    from .concurrency import CONCURRENCY_RULES, lint_concurrency_paths

    if args.tier and args.tier.upper() == "C":
        args.contracts = True
        args.concurrency = True

    if args.list_rules:
        for name, rule in sorted(all_rules().items()):
            print(f"{name:28s} {rule.rule_doc}")
        for name, doc in sorted(CONCURRENCY_RULES.items()):
            print(f"{name:28s} [concurrency] {doc}")
        return 0

    if not args.paths and not args.contracts and not args.concurrency:
        print("brlint: nothing to do (pass paths and/or --contracts/"
              "--concurrency/--tier)", file=sys.stderr)
        return 2

    select = None
    if args.select:
        select = {s.strip() for s in args.select.split(",") if s.strip()}
        unknown = select - set(all_rules()) - set(CONCURRENCY_RULES)
        if unknown:
            print(f"brlint: unknown rules {sorted(unknown)}",
                  file=sys.stderr)
            return 2

    findings, n_suppressed, sources = [], 0, {}
    if args.paths:
        findings, n_suppressed, sources = lint_paths(args.paths, select)
    if args.concurrency:
        # explicit paths scope BOTH tiers; bare --concurrency scans the
        # default threaded-host module set
        cf, cns, csources = lint_concurrency_paths(
            paths=args.paths or None, select=select)
        findings += cf
        n_suppressed += cns
        sources.update(csources)

    if args.write_baseline:
        if args.contracts:
            print("brlint: --write-baseline cannot be combined with "
                  "--contracts (baselines track source findings only)",
                  file=sys.stderr)
            return 2
        Baseline.from_findings(findings, sources).save(args.write_baseline)
        print(f"brlint: wrote {len(findings)} finding(s) to "
              f"{args.write_baseline}")
        return 0

    stale = []
    baselined = []
    if args.baseline:
        bl = Baseline.load(args.baseline)
        findings, baselined, stale = bl.apply(findings, sources)

    contract_findings = []
    census = None
    if args.contracts:
        from .contracts import run_contracts

        census = []
        contract_findings = run_contracts(
            fixtures_dir=args.fixtures, device=args.device, census=census)
        findings = findings + contract_findings

    if args.as_json:
        doc = {"findings": [vars(f) for f in findings],
               "baselined": len(baselined),
               "suppressed": n_suppressed,
               "stale_baseline": stale}
        if census is not None:
            doc["contracts"] = census
        print(json.dumps(doc, indent=1))
    else:
        for f in findings:
            print(f.render())
        for fp in stale:
            print(f"brlint: stale baseline entry {fp} (finding no longer "
                  f"produced — remove it from the baseline)")
        tier_c = (f", {len(contract_findings)} from the contract engine "
                  f"({len(census)} contracts on {args.device})"
                  if census is not None else "")
        print(f"brlint: {len(findings)} finding(s){tier_c}, "
              f"{len(baselined)} baselined, {n_suppressed} suppressed")

    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
