"""Matched single-core CPU baseline for the north-star 4096-lane map.

The port's counterpart of ``scripts/northstar_baseline.py``.  It samples
the 64 x 64 T x phi map of ``tools/northstar_sweep.py`` on a stratified
n x n sub-lattice (the centres of n x n equal blocks: unbiased for the
uniform grid), solves each sampled condition one at a time on one CPU
core, the way the reference runs a map (one serial CVODE-class BDF call
per condition), and extrapolates the mean s/lane x 4096 to the full map's
single-core wall.

Two baseline solvers, reported separately:

- ``native``: the port's copy of the independent C++ variable-order BDF
  (``native/br_native.cpp``), analytic Jacobian in C++, one thread: the
  strongest CVODE-class single-core baseline the repository has;
- ``scipy``: ``scipy.integrate.solve_ivp(method="BDF")`` over the port's
  float64 CPU RHS with its analytic Jacobian supplied (the single-core
  analogue of CVODE's user-Jacobian mode).

The per-lane (T, phi, s) rows feed ``northstar_sweep.lane_cost_model``.
With ``--map-record`` (a record ``tools/northstar_sweep.py`` wrote) the
record adds ``map_speedup_vs_<solver>`` = mean s/lane x 4096 / the map's
wall.

  python -m batchreactor_tpu_torch.tools.northstar_baseline     # 8x8 lanes
  python -m batchreactor_tpu_torch.tools.northstar_baseline --n 4 \\
      --solvers native --map-record build/northstar/northstar.json

The baseline is a CPU measurement by nature: ``--device`` takes ``cpu``
only, and no GPU is touched.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LIB = os.path.join(REPO, "tests", "fixtures")
OUT = os.path.join(REPO, "build", "northstar", "northstar_baseline.json")

# the north-star map (tools/northstar_sweep.py run_sweep defaults)
N_FULL = 64
T_LO, T_HI = 1500.0, 2000.0
PHI_LO, PHI_HI = 0.6, 1.6
T1, P = 8e-4, 1e5
RTOL, ATOL = 1e-6, 1e-10
SOLVERS = ("scipy", "native")


def sub_lattice(n):
    """The sampled temperatures and equivalence ratios: the centres of
    n x n equal blocks of the N_FULL x N_FULL grid."""
    full_T = np.linspace(T_LO, T_HI, N_FULL)
    full_phi = np.linspace(PHI_LO, PHI_HI, N_FULL)
    pick = N_FULL // (2 * n) + (N_FULL // n) * np.arange(n)
    return full_T[pick], full_phi[pick]


def _stats(walls, fails):
    return {"s_per_lane_mean": float(np.mean(walls)),
            "s_per_lane_min": float(np.min(walls)),
            "s_per_lane_max": float(np.max(walls)),
            "s_per_lane_std": float(np.std(walls)),
            "n_failed": fails}


def run_baseline(n=8, solvers=SOLVERS, map_record=None, log=print):
    """Solve the n x n sample with each of ``solvers``; return the record
    (per-solver s/lane statistics, per-lane rows, the extrapolated
    full-map walls and, with ``map_record``, the map's speed-up)."""
    from .. import compile_gaschemistry, create_thermo
    from ..ops.rhs import make_gas_jac, make_gas_rhs
    from .northstar_sweep import map_states

    unknown = set(solvers) - set(SOLVERS)
    if unknown:
        raise ValueError(f"unknown baseline solvers {sorted(unknown)}; "
                         f"choose from {SOLVERS}")
    gm = compile_gaschemistry(os.path.join(LIB, "grimech.dat"), device="cpu")
    th = create_thermo(list(gm.species), os.path.join(LIB, "therm.dat"),
                       device="cpu")
    Ts, phis = sub_lattice(n)
    lanes = [(T, phi) for T in Ts for phi in phis]
    log(f"[baseline] {len(lanes)} sample lanes from the {N_FULL}x{N_FULL} "
        f"map (T {Ts[0]:.0f}..{Ts[-1]:.0f}, phi {phis[0]:.2f}.."
        f"{phis[-1]:.2f}), t1={T1}, rtol={RTOL}/atol={ATOL}")

    def y0_of(T, phi):
        _, y0s = map_states(gm, th, 1, 1, T, T, phi, phi, P)
        return y0s[0].numpy()

    results = {}
    per_lane = [{"T": float(T), "phi": float(phi)} for T, phi in lanes]

    if "scipy" in solvers:
        from scipy.integrate import solve_ivp

        rhs, jacf = make_gas_rhs(gm, th), make_gas_jac(gm, th)
        walls, fails = [], 0
        for i, (T, phi) in enumerate(lanes):
            y0 = y0_of(T, phi)
            cfg = {"T": torch.tensor([float(T)], dtype=torch.float64)}

            def f(t, y, cfg=cfg):
                return rhs(t, torch.from_numpy(y)[None], cfg)[0].numpy()

            def J(t, y, cfg=cfg):
                return jacf(t, torch.from_numpy(y)[None], cfg)[0].numpy()

            t0 = time.perf_counter()
            sol = solve_ivp(f, (0.0, T1), y0, method="BDF", rtol=RTOL,
                            atol=ATOL, jac=J)
            walls.append(time.perf_counter() - t0)
            per_lane[i]["scipy_s"] = round(walls[-1], 4)
            fails += not sol.success
            if i % n == 0:
                log(f"[scipy] lane {i}/{len(lanes)} T={T:.0f} "
                    f"phi={phi:.2f}: {walls[-1]:.2f}s")
        results["scipy"] = _stats(walls, fails)

    if "native" in solvers:
        from .. import native

        native.load_library()  # the build outside the timer
        walls, fails = [], 0
        for i, (T, phi) in enumerate(lanes):
            y0 = y0_of(T, phi)
            t0 = time.perf_counter()
            r = native.solve_gas_bdf(gm, th, float(T), y0, 0.0, T1,
                                     rtol=RTOL, atol=ATOL, n_save=0)
            walls.append(time.perf_counter() - t0)
            per_lane[i]["native_s"] = round(walls[-1], 5)
            fails += r.status != "Success"
            if i % n == 0:
                log(f"[native] lane {i}/{len(lanes)} T={T:.0f} "
                    f"phi={phi:.2f}: {walls[-1]:.3f}s")
        results["native"] = _stats(walls, fails)

    B_full = N_FULL * N_FULL
    rec = {
        "workload": f"GRI30 {N_FULL}x{N_FULL} TxPhi ignition map "
                    f"(northstar_sweep.py definition), single-core CPU, "
                    f"one serial BDF call per condition",
        "sample": f"stratified {n}x{n} block-center sub-lattice "
                  f"({len(lanes)} lanes)",
        "t1": T1, "rtol": RTOL, "atol": ATOL,
        "solvers": results,
        # the per-lane (T, phi, s) rows feed the lane-cost model that
        # sorts the map into cost-homogeneous chunks
        "per_lane": per_lane,
    }
    for name, r in results.items():
        rec[f"extrapolated_full_map_wall_s_{name}"] = round(
            r["s_per_lane_mean"] * B_full, 1)
    if map_record is not None:
        with open(map_record) as fh:
            ns = json.load(fh)
        map_wall = ns.get("wall_s")
        if map_wall:
            rec["map_wall_s"] = map_wall
            rec["map_device"] = ns.get("device")
            for name, r in results.items():
                rec[f"map_speedup_vs_{name}"] = round(
                    r["s_per_lane_mean"] * B_full / map_wall, 1)
    return rec


def _build_parser():
    p = argparse.ArgumentParser(
        prog="northstar_baseline",
        description="single-core CPU baseline of the north-star map")
    p.add_argument("--n", type=int, default=8,
                   help="sample an n x n sub-lattice (default 8: 64 lanes)")
    p.add_argument("--solvers", default=",".join(SOLVERS),
                   help="comma-separated, of scipy and native")
    p.add_argument("--out", default=OUT, help="where the record is written")
    p.add_argument("--map-record", default=None,
                   help="a northstar_sweep record: adds the map's "
                        "speed-up over each solver")
    p.add_argument("--device", default="cpu",
                   help="cpu only: the baseline is one CPU core")
    return p


def main(argv=None):
    args = _build_parser().parse_args(argv)
    if torch.device(args.device).type != "cpu":
        print(f"northstar_baseline: the baseline runs on one CPU core; "
              f"--device {args.device} is not a CPU", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    rec = run_baseline(
        n=args.n, solvers=tuple(s.strip() for s in args.solvers.split(",")
                                if s.strip()),
        map_record=args.map_record,
        log=lambda m: print(m, file=sys.stderr, flush=True))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(rec, fh, indent=1)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
