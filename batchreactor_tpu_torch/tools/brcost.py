#!/usr/bin/env python
"""brcost of the port: static cost tables of the step programs, their
gate, the (B, S, R) memory ladder and the S-ladder
(``batchreactor_tpu_torch/analysis/costmodel.py``; the counterpart of
``scripts/brcost.py``).

  python -m batchreactor_tpu_torch.tools.brcost --table
  python -m batchreactor_tpu_torch.tools.brcost --table --json
  python -m batchreactor_tpu_torch.tools.brcost --table --device cuda
  python -m batchreactor_tpu_torch.tools.brcost \\
      --gate tests/fixtures/torch_cost_gate_baseline.json
  python -m batchreactor_tpu_torch.tools.brcost \\
      --write-baseline tests/fixtures/torch_cost_gate_baseline.json
  python -m batchreactor_tpu_torch.tools.brcost --ladder --B 256,1024,4096 \\
      --mechs h2o2:10:29,gri30:53:325
  python -m batchreactor_tpu_torch.tools.brcost --s-ladder
  python batchreactor_tpu_torch/tools/brcost.py --ladder --s-ladder  # no torch

* ``--table`` records every registered step-program contract on the
  vendored fixtures (``--device cpu``: an op log of each step run eagerly;
  ``cuda``: each step captured on the card, which raises without one) and
  renders per program FLOPs per attempt, transcendentals, bytes moved,
  peak residency and the ``lu32p`` kernel's shared memory per CTA.
* ``--gate`` band-checks a fresh table against a banked baseline JSON
  (``br-cost-gate-v1``: every leaf a ``{"min","max","equals"}`` band).  A
  banked program missing from the fresh table fails; a new unbanked one is
  reported and passes.
* ``--ladder`` / ``--s-ladder`` need no torch: the stdlib
  ``estimate_rung`` sweeps batch rungs x mechanism shapes and reports the
  predicted resident memory against the H100's 80 GiB (``--hbm-gb``), or
  sweeps S at fixed B to show the O(S^3) dense-LU wall.  The ``smem``
  column of the modes whose factor is the ``lu32p`` kernel (``lu32p``,
  ``inv32*``) reads the kernel's launch configuration, which imports
  torch.

Exit codes: 0 clean / fits, 1 gate failure, 2 usage error.
"""

import argparse
import json
import math
import os
import sys
import types

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# lightweight parent package, as in tools/brlint.py: run by path, the
# ladder modes load the analysis subpackage WITHOUT the package __init__
# (which imports torch); setdefault keeps an already imported package
_pkg = types.ModuleType("batchreactor_tpu_torch")
_pkg.__path__ = [os.path.join(REPO, "batchreactor_tpu_torch")]
sys.modules.setdefault("batchreactor_tpu_torch", _pkg)

from batchreactor_tpu_torch.analysis.costmodel import (  # noqa: E402
    HBM_BYTES, SMEM_BUDGET_BYTES, contract_cost_table, estimate_rung,
    fits_hbm, fits_smem)

GATE_SCHEMA = "br-cost-gate-v1"

#: table metrics a gate band may address
_METRICS = ("flops", "transcendentals", "bytes_moved", "peak_bytes",
            "smem_bytes", "n_while", "n_scan", "n_pallas")


def _check_band(value, band):
    """(ok, detail) against ``{"min","max","equals"}``."""
    bad = sorted(set(band) - {"min", "max", "equals"})
    if bad:
        raise ValueError(f"unknown band key(s) {bad}; known: "
                         f"['equals', 'max', 'min']")
    if value is None:
        return False, "no observations"
    parts, ok = [], True
    if "equals" in band:
        ok &= value == band["equals"]
        parts.append(f"== {band['equals']}")
    if "min" in band:
        ok &= value >= band["min"]
        parts.append(f">= {band['min']}")
    if "max" in band:
        ok &= value <= band["max"]
        parts.append(f"<= {band['max']}")
    return ok, " and ".join(parts) or "(empty band)"


def _fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(b) < 1024 or unit == "TiB":
            return f"{b:.0f} {unit}" if unit == "B" else f"{b:.3g} {unit}"
        b /= 1024.0


def _fmt_count(v):
    for unit in ("", "k", "M", "G", "T"):
        if abs(v) < 1000 or unit == "T":
            return f"{v:.0f}{unit}" if unit == "" else f"{v:.3g}{unit}"
        v /= 1000.0


def _as_dict(cost):
    return cost.as_dict() if hasattr(cost, "as_dict") else cost


def render_table(table):
    lines = [f"{'program':50s} {'flops/step':>10s} {'transc':>8s} "
             f"{'bytes':>9s} {'peak':>10s} {'smem':>9s} {'loops':>5s}"]
    for key in sorted(table):
        d = _as_dict(table[key])
        lines.append(
            f"{key:50s} {_fmt_count(d['flops']):>10s} "
            f"{_fmt_count(d['transcendentals']):>8s} "
            f"{_fmt_count(d['bytes_moved']):>9s} "
            f"{_fmt_bytes(d['peak_bytes']):>10s} "
            f"{_fmt_bytes(d['smem_bytes']):>9s} "
            f"{d['n_while'] + d['n_scan']:>5d}")
    return "\n".join(lines)


def run_gate(baseline, table):
    """Band-check a fresh cost table against the banked baseline; returns
    ``(failures, lines)``."""
    if baseline.get("schema", GATE_SCHEMA) != GATE_SCHEMA:
        raise ValueError(f"unsupported gate schema "
                         f"{baseline.get('schema')!r} (this gate speaks "
                         f"{GATE_SCHEMA})")
    known = {"schema", "description", "programs"}
    unknown = sorted(set(baseline) - known)
    if unknown:
        raise ValueError(f"unknown gate section(s) {unknown}; known: "
                         f"{sorted(known)}")
    lines, failures = [], []

    def row(ok, name, metric, value, detail):
        line = (f"  [{'ok' if ok else 'FAIL':>4s}] {name} {metric}: "
                f"{value if value is not None else '-'} (want {detail})")
        lines.append(line)
        if not ok:
            failures.append(line)

    fresh = {k: _as_dict(v) for k, v in table.items()}
    for name, bands in sorted((baseline.get("programs") or {}).items()):
        prog = fresh.get(name)
        if prog is None:
            row(False, name, "(program)", None,
                "program present in the fresh table — it disappeared "
                "from the contract registry")
            continue
        for metric, band in sorted(bands.items()):
            if metric not in _METRICS:
                raise ValueError(f"unknown cost metric {metric!r} for "
                                 f"{name!r}; known: {list(_METRICS)}")
            ok, detail = _check_band(prog.get(metric), band)
            row(ok, name, metric, prog.get(metric), detail)
    for name in sorted(set(fresh) - set(baseline.get("programs") or {})):
        lines.append(f"  [ new] {name}: unbanked program (add bands on "
                     f"the next baseline refresh)")
    return failures, lines


def make_baseline(table, description):
    """Bank the current table: 0.5x..1.5x flops bands, 0.8x..1.25x
    transcendental bands (the rate code's exponentials are counted
    exactly) and 1.5x residency ceilings, so a doubled metric fails; a
    program that runs the kernel keeps its launch and one block's shared
    memory."""
    programs = {}
    for key in sorted(table):
        d = _as_dict(table[key])
        programs[key] = {
            "flops": {"min": round(d["flops"] * 0.5, 1),
                      "max": round(d["flops"] * 1.5, 1)},
            "transcendentals": {"min": round(d["transcendentals"] * 0.8, 1),
                                "max": round(d["transcendentals"] * 1.25,
                                             1)},
            "peak_bytes": {"max": int(d["peak_bytes"] * 1.5)},
        }
        if d["n_pallas"]:
            programs[key]["n_pallas"] = {"min": d["n_pallas"]}
            programs[key]["smem_bytes"] = {"max": SMEM_BUDGET_BYTES}
    return {"schema": GATE_SCHEMA, "description": description,
            "programs": programs}


# --------------------------------------------------------------------------
# ladder modes (stdlib: no torch)
# --------------------------------------------------------------------------
def _parse_mechs(spec):
    """``"h2o2:10:29,gri30:53:325"`` -> [(label, S, R)] (R optional:
    ``label:S`` uses the 4*S heuristic)."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if len(bits) == 2:
            out.append((bits[0], int(bits[1]), None))
        elif len(bits) == 3:
            out.append((bits[0], int(bits[1]), int(bits[2])))
        else:
            raise ValueError(f"mech spec {part!r} wants label:S[:R]")
    return out


def ladder_report(Bs, mechs, *, method="bdf", energy=False,
                  linsolve="lu", jac_window=1, hbm_bytes=HBM_BYTES,
                  headroom=0.8):
    """Predicted resident memory for every (B, mech) rung, the fit verdict
    and the kernel's shared-memory fit."""
    rows = []
    for label, S, R in mechs:
        for B in Bs:
            est = estimate_rung(B, S, R, method=method, energy=energy,
                                linsolve=linsolve, jac_window=jac_window)
            est["mech"] = label
            est["fits"] = fits_hbm(est, hbm_bytes, headroom)
            est["smem_fits"] = fits_smem(est)
            rows.append(est)
    return rows


def render_ladder(rows, hbm_bytes, headroom):
    lines = [f"(B, S, R) ladder vs {_fmt_bytes(hbm_bytes)} device memory "
             f"at {headroom:.0%} headroom "
             f"(analysis/costmodel.py estimate_rung: the JAX formula; "
             f"ratios across rungs are the signal)",
             f"{'mech':10s} {'B':>7s} {'S':>5s} {'R':>5s} "
             f"{'flops/step':>11s} {'AI':>6s} {'pred mem':>10s} "
             f"{'smem':>9s}  fit"]
    for r in rows:
        note = " (R=4S assumed)" if r["r_assumed"] else ""
        if not r["smem_fits"]:
            note += " (no lu32p kernel past npad 240)"
        lines.append(
            f"{r['mech']:10s} {r['B']:>7d} {r['S']:>5d} {r['R']:>5d} "
            f"{_fmt_count(r['flops_per_step']):>11s} "
            f"{r['arithmetic_intensity']:>6.2f} "
            f"{_fmt_bytes(r['hbm_bytes']):>10s} "
            f"{_fmt_bytes(r['smem_bytes']):>9s}  "
            f"{'FITS' if r['fits'] else 'NO-FIT'}{note}")
    return "\n".join(lines)


def s_ladder(Ss, *, B=256, method="bdf", jac_window=1):
    """FLOPs/step across a species ladder at fixed B, plus the fitted
    log-log slope over the top half: the dense-Newton S^3 curve."""
    rows = [estimate_rung(B, S, None, method=method,
                          jac_window=jac_window) for S in Ss]
    top = [r for r in rows if r["S"] >= rows[len(rows) // 2]["S"]]
    slope = None
    if len(top) >= 2:
        x0 = math.log(top[0]["S"])
        y0 = math.log(top[0]["flops_per_lane_step"])
        x1 = math.log(top[-1]["S"])
        y1 = math.log(top[-1]["flops_per_lane_step"])
        slope = (y1 - y0) / (x1 - x0)
    return rows, slope


def render_s_ladder(rows, slope, B):
    lines = [f"S-ladder at B={B} (R = 4*S heuristic): the dense-Newton "
             f"wall — LU is 2/3 S^3, the Jacobian (S+1)^2",
             f"{'S':>6s} {'n':>6s} {'flops/lane/step':>16s} "
             f"{'lu share':>9s} {'pred mem':>10s}"]
    for r in rows:
        lu = (2.0 / 3.0) * r["n"] ** 3 / max(1, r.get("jac_window", 1))
        share = lu / r["flops_per_lane_step"]
        lines.append(f"{r['S']:>6d} {r['n']:>6d} "
                     f"{_fmt_count(r['flops_per_lane_step']):>16s} "
                     f"{share:>8.0%} {_fmt_bytes(r['hbm_bytes']):>10s}")
    if slope is not None:
        lines.append(f"log-log slope over the top half: {slope:.2f} "
                     f"(-> 3.0 as LU dominates; the S^3 curve)")
    return "\n".join(lines)


def _ints(s):
    return [int(x) for x in str(s).split(",") if x.strip()]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--table", action="store_true",
                    help="cost every contracted step program on the "
                         "vendored fixtures (needs torch)")
    ap.add_argument("--gate", metavar="BASELINE",
                    help="band-check the fresh table against a banked "
                         "br-cost-gate-v1 baseline (implies --table)")
    ap.add_argument("--write-baseline", metavar="FILE",
                    help="bank the current table as a gate baseline "
                         "(implies --table)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    ap.add_argument("--fixtures", default=None,
                    help="fixture dir (default: tests/fixtures)")
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cpu",
                    help="where --table records the programs: cpu = an op "
                         "log of each step run eagerly, cuda = each step "
                         "captured on the card (raises without one)")
    ap.add_argument("--ladder", action="store_true",
                    help="(B, S, R) memory rung report (stdlib, no torch)")
    ap.add_argument("--s-ladder", action="store_true", dest="s_ladder",
                    help="S^3 scaling sweep (stdlib, no torch)")
    ap.add_argument("--B", default="256,512,1024,2048,4096,8192",
                    help="comma-separated batch rungs for --ladder, or the "
                         "single fixed B for --s-ladder (first value)")
    ap.add_argument("--S", default="8,16,32,64,128,256,512,1024",
                    help="species ladder for --s-ladder")
    ap.add_argument("--mechs", default="h2o2:10:29,gri30:53:325",
                    help="label:S[:R] mechanism shapes for --ladder")
    ap.add_argument("--method", default="bdf", choices=["bdf", "sdirk"])
    ap.add_argument("--energy", action="store_true",
                    help="non-isothermal state (+1 temperature row)")
    ap.add_argument("--linsolve", default="lu",
                    help="lu | lu32p | inv32 | inv32nr | inv32f (factor "
                         "dtype and the smem column)")
    ap.add_argument("--jac-window", type=int, default=1)
    ap.add_argument("--hbm-gb", type=float, default=HBM_BYTES / 2 ** 30,
                    help="device memory for the fit verdict in GiB "
                         "(H100: 80)")
    ap.add_argument("--headroom", type=float, default=0.8,
                    help="usable fraction of device memory")
    args = ap.parse_args(argv)

    if args.gate or args.write_baseline:
        args.table = True
    if not (args.table or args.ladder or args.s_ladder):
        print("brcost: nothing to do (pass --table/--gate/--ladder/"
              "--s-ladder)", file=sys.stderr)
        return 2

    out = {}
    rc = 0
    hbm = int(args.hbm_gb * 2 ** 30)
    if args.ladder:
        rows = ladder_report(
            _ints(args.B), _parse_mechs(args.mechs), method=args.method,
            energy=args.energy, linsolve=args.linsolve,
            jac_window=args.jac_window, hbm_bytes=hbm,
            headroom=args.headroom)
        out["ladder"] = rows
        if not args.json:
            print(render_ladder(rows, hbm, args.headroom))
    if args.s_ladder:
        B = _ints(args.B)[0]
        rows, slope = s_ladder(_ints(args.S), B=B, method=args.method,
                               jac_window=args.jac_window)
        out["s_ladder"] = {"rows": rows, "loglog_slope": slope}
        if not args.json:
            print(render_s_ladder(rows, slope, B))
    if args.table:
        table = contract_cost_table(fixtures_dir=args.fixtures,
                                    device=args.device)
        out["table"] = {k: v.as_dict() for k, v in sorted(table.items())}
        if not args.json:
            print(render_table(table))
        if args.write_baseline:
            baseline = make_baseline(
                table, "banked by batchreactor_tpu_torch/tools/brcost.py "
                "--write-baseline: 0.5x..1.5x flops, 0.8x..1.25x "
                "transcendental bands and 1.5x peak-residency ceilings on "
                "the h2o2 fixture's step programs at B = 8 (one attempt "
                "with one Newton iteration per step)")
            with open(args.write_baseline, "w") as f:
                json.dump(baseline, f, indent=1, sort_keys=True)
                f.write("\n")
            print(f"brcost: banked {len(baseline['programs'])} "
                  f"program(s) to {args.write_baseline}")
        if args.gate:
            with open(args.gate) as f:
                baseline = json.load(f)
            desc = baseline.get("description")
            hdr = (f"cost gate [{GATE_SCHEMA}] baseline="
                   f"{os.path.basename(args.gate)}"
                   + (f"\n  ({desc})" if desc else ""))
            failures, lines = run_gate(baseline, table)
            out["gate"] = {"failures": len(failures), "lines": lines}
            if not args.json:
                print(hdr)
                for line in lines:
                    print(line)
            if failures:
                print(f"COST GATE FAILED: {len(failures)} band(s) out of "
                      f"tolerance", file=sys.stderr)
                for line in failures:
                    print(line, file=sys.stderr)
                rc = 1
            elif not args.json:
                print(f"cost gate passed ({len(lines)} rows)")
    if args.json:
        print(json.dumps(out, indent=1, sort_keys=True))
    return rc


if __name__ == "__main__":
    sys.exit(main())
