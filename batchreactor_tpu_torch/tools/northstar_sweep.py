"""North-star workload: the 4096-condition GRI-Mech 3.0 ignition map.

The port's counterpart of ``scripts/northstar_sweep.py``.  The BASELINE.md
target: >= 50x wall-clock against a single-CPU CVODE-class BDF on a
4096-condition GRI ignition sweep, < 1% ignition-delay error.  The
reference runs such a map as 4096 serial CVODE calls, one condition per
call; here it is ONE checkpointed, cost-sorted, segmented ensemble sweep.

Grid: 64 T0 x 64 phi (equivalence ratio), CH4/O2/N2 with the oxidizer
stream carrying N2 at 0.5 mol per mol O2 (phi = 1 gives the reference
batch_ch4 mixture 0.25/0.5/0.25), 1 bar, t1 = 8e-4 s, rtol 1e-6 / atol
1e-10 (the reference's CVODE tolerances).  Ignition delay tau = the first
accepted time CH4 drops below half its initial value, interpolated, folded
in-loop by the observer (no trajectory buffer).  The rate exponentials run
in float32 (``exp32=True``, the bench protocol of the JAX package).

The record (JSON): conditions/s, tau parity against the native C++ BDF
(an independent implementation) on spot-check lanes, per-status lane
counts, the phase timers (parse / build / solve / spot_check) and the
``lu32p`` launches by kernel path.

  python -m batchreactor_tpu_torch.tools.northstar_sweep --ckpt DIR
  python -m batchreactor_tpu_torch.tools.northstar_sweep --device cpu \\
      --nt 2 --nphi 1 --chunk 2

``--device`` defaults to the GPU (``cuda``) and fails without one.  The
record goes to ``build/northstar/northstar.json`` unless ``--out`` says
otherwise, and the flight recorder dumps beside it.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LIB = os.path.join(REPO, "tests", "fixtures")
#: the single-core sample of the map (``tools/northstar_baseline.py``)
#: that orders the lanes by predicted cost
BASELINE = os.path.join(REPO, "NORTHSTAR_BASELINE.json")
OUT_DIR = os.path.join(REPO, "build", "northstar")


def lane_cost_model(T, phi, baseline, log=print):
    """Predicted per-lane cost from a baseline record's ``per_lane``
    sample (``tools/northstar_baseline.py``): bilinear interpolation of
    the per-lane s over the (T, phi) plane.  It cost-sorts lanes before
    chunking (``checkpointed_sweep(lane_cost=)``): a chunk's wall is its
    slowest lane, and the map's corner lanes cost ~3x its cheap ones, so
    cost-homogeneous chunks cut the straggler tax.  Only the order
    matters.  ``None`` (no sort) when the file is missing, a solver's
    times are missing on any row (``native_s`` is taken over ``scipy_s``,
    never mixed: they differ ~3.6x in scale), a time is NaN or the sample
    is not a full lattice."""
    if baseline is None or not os.path.exists(baseline):
        return None
    with open(baseline) as fh:
        rec = json.load(fh)
    per_lane = rec.get("per_lane")
    if not per_lane:
        return None
    pts = np.asarray([[r["T"], r["phi"]] for r in per_lane])
    key = ("native_s" if all("native_s" in r for r in per_lane)
           else "scipy_s" if all("scipy_s" in r for r in per_lane)
           else None)
    if key is None:
        return None
    w = np.asarray([r[key] for r in per_lane], dtype=np.float64)
    if np.isnan(w).any():
        return None
    Tg = np.unique(pts[:, 0])
    Pg = np.unique(pts[:, 1])
    if Tg.size * Pg.size != w.size:
        return None
    W = w.reshape(Tg.size, Pg.size)  # the sample is written T-major

    def interp1(grid, x):
        i = np.clip(np.searchsorted(grid, x) - 1, 0, grid.size - 2)
        f = np.clip((x - grid[i]) / (grid[i + 1] - grid[i]), 0.0, 1.0)
        return i, f

    iT, fT = interp1(Tg, _host(T))
    iP, fP = interp1(Pg, _host(phi))
    cost = ((1 - fT) * (1 - fP) * W[iT, iP]
            + (1 - fT) * fP * W[iT, iP + 1]
            + fT * (1 - fP) * W[iT + 1, iP]
            + fT * fP * W[iT + 1, iP + 1])
    log(f"[northstar] lane-cost model from {os.path.basename(baseline)}: "
        f"predicted s/lane {cost.min():.3f}..{cost.max():.3f} "
        f"(max/mean {cost.max() / cost.mean():.2f})")
    return cost


def map_states(gm, th, n_T=64, n_phi=64, T_lo=1500.0, T_hi=2000.0,
               phi_lo=0.6, phi_hi=1.6, p=1e5):
    """The map's lanes on the mechanism's device: the grid ``{"T", "phi"}``
    (T-major, B = n_T n_phi) and the initial states (B, S).  The oxidizer
    stream carries N2 at 0.5 mol per mol O2, so phi = 1 gives the
    reference batch_ch4 mixture CH4/O2/N2 = 0.25/0.5/0.25."""
    from ..parallel import (condition_grid, premixed_mole_fracs,
                            sweep_solution_vectors)

    dev = th.molwt.device
    grid = condition_grid(device=dev, T=np.linspace(T_lo, T_hi, n_T),
                          phi=np.linspace(phi_lo, phi_hi, n_phi))
    X = premixed_mole_fracs(list(gm.species), "CH4", grid["phi"],
                            stoich_o2=2.0, diluent="N2", o2_to_diluent=0.5,
                            device=dev)
    return grid, sweep_solution_vectors(X, th.molwt, grid["T"], p)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _spot_tau(native, gm, th, T, y0, t1, ch4, rtol, atol):
    """The native BDF's CH4 half-crossing delay of one lane, interpolated
    between the bracketing accepted steps as the observer does (NaN when
    CH4 never crosses)."""
    rn = native.solve_gas_bdf(gm, th, T, y0, 0.0, t1, rtol=rtol, atol=atol,
                              n_save=100_000)
    ts = np.concatenate([[0.0], rn.ts])
    ys = np.concatenate([y0[None, :], rn.ys])
    thr = 0.5 * y0[ch4]
    below = ys[:, ch4] < thr
    if not below.any():
        return float("nan")
    i = int(np.argmax(below))
    if i == 0:
        return float(ts[0])
    m_a, m_b = ys[i - 1, ch4], ys[i, ch4]
    w = (m_a - thr) / (m_a - m_b) if m_a != m_b else 1.0
    return float(ts[i - 1] + w * (ts[i] - ts[i - 1]))


def run_sweep(n_T=64, n_phi=64, T_lo=1500.0, T_hi=2000.0, phi_lo=0.6,
              phi_hi=1.6, t1=8e-4, p=1e5, ckpt_dir=None, chunk_size=512,
              segment_steps=256, mesh=None, rtol=1e-6, atol=1e-10,
              n_spot=8, method="bdf", jac_window=8, sort_lanes=True,
              pipeline=None, poll_every=None, admission=None, refill=None,
              record_occupancy=False, energy=None, device=None, exp32=True,
              baseline=BASELINE, flight_dir=None, return_result=False,
              log=print):
    """Run the T x phi GRI-3.0 ignition map; return the record dict (and
    with ``return_result`` the per-lane ``SolveResult`` beside it).

    ``ckpt_dir`` runs :func:`~..parallel.checkpointed_sweep` in chunks of
    ``chunk_size`` (cost-sorted by ``baseline`` when ``sort_lanes``; a
    second call on the same directory loads every chunk); without it the
    map is one ``ensemble_solve_segmented`` call.  ``energy`` (a mode of
    ``energy.resolve_energy``) switches to the adiabatic family: the state
    grows the trailing T row, tau comes from the max-dT/dt detector, and
    the native spot check is skipped (the C++ runtime is isothermal only).
    ``exp32`` runs the rate exponentials in float32.  The flight recorder
    is armed for the run, dumping into ``flight_dir`` (default
    ``build/northstar/``)."""
    from .. import compile_gaschemistry, create_thermo
    from ..obs import Recorder, recording
    from ..obs import counters as obs_counters
    from ..obs.live import arm_flight
    from ..ops.rhs import make_gas_jac, make_gas_rhs
    from ..parallel import checkpoint as ck
    from ..parallel import (checkpointed_sweep, ensemble_solve_segmented,
                            ignition_observer, sweep_report)
    from ..parallel.sweep import resolve_pipeline_defaults
    from ..solver import linalg_cuda as lc
    from ..solver.common import SUCCESS

    dev = resolve_device(device)
    # the phases: the program's own parse spans, then this tool's
    ph = Recorder()
    with recording(ph):
        gm = compile_gaschemistry(os.path.join(LIB, "grimech.dat"),
                                  device=dev)
        th = create_thermo(list(gm.species), os.path.join(LIB, "therm.dat"),
                           device=dev)
    sp = list(gm.species)

    with ph.span("build"):
        grid, y0s = map_states(gm, th, n_T, n_phi, T_lo, T_hi, phi_lo,
                               phi_hi, p)
        B = int(grid["T"].shape[0])
        cfgs = {"T": grid["T"]}
        if energy is not None:
            from ..energy import (ATOL_SCALE_KEY, energy_atol_scale,
                                  energy_ignition_observer, make_energy_jac,
                                  make_energy_rhs)

            rhs = make_energy_rhs(gm, th, energy, exp32=exp32)
            jac = make_energy_jac(gm, th, energy, exp32=exp32)
            obs, obs0 = energy_ignition_observer(len(sp))
            y0s = torch.cat([y0s, grid["T"][:, None]], dim=1)
            cfgs[ATOL_SCALE_KEY] = energy_atol_scale(
                B, int(y0s.shape[1]), atol, device=dev)
        else:
            rhs = make_gas_rhs(gm, th, exp32=exp32)
            jac = make_gas_jac(gm, th, exp32=exp32)
            obs, obs0 = ignition_observer(sp.index("CH4"), mode="half")

    solve_kw = dict(rtol=rtol, atol=atol, jac=jac, observer=obs,
                    observer_init=obs0, mesh=mesh, method=method,
                    segment_steps=segment_steps, jac_window=jac_window,
                    pipeline=pipeline, poll_every=poll_every)
    # continuous batching: a recorder rides along so the occupancy split
    # lands in the record whichever way admission is set
    obs_rec = (Recorder() if (admission is not None or record_occupancy)
               else None)
    # the flight recorder is armed for every map run: a supervised
    # teardown (SIGTERM first) dumps flight_<ts>.jsonl beside the record
    arm_flight(recorder=obs_rec,
               dir=flight_dir if flight_dir is not None else OUT_DIR,
               install_signal=True)
    lane_cost = None
    if sort_lanes and ckpt_dir:
        # cost-sorted chunking changes only a chunked sweep
        lane_cost = lane_cost_model(grid["T"], grid["phi"], baseline,
                                    log=log)
    launches0 = dict(lc.LAUNCHES_BY_PATH)
    solved0 = ck.COUNTS["chunks_solved"]
    t_start = time.perf_counter()
    with ph.span("solve"):
        if ckpt_dir:
            res = checkpointed_sweep(rhs, y0s, 0.0, t1, cfgs, ckpt_dir,
                                     chunk_size=chunk_size,
                                     lane_cost=lane_cost, chunk_log=log,
                                     admission=admission, refill=refill,
                                     recorder=obs_rec, energy=energy,
                                     **solve_kw)
        else:
            kw = {k: v for k, v in solve_kw.items() if k != "segment_steps"}
            res = ensemble_solve_segmented(rhs, y0s, 0.0, t1, cfgs,
                                           segment_steps=segment_steps,
                                           admission=admission,
                                           refill=refill,
                                           recorder=obs_rec, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t_start
    launches = {k: v - launches0[k] for k, v in lc.LAUNCHES_BY_PATH.items()}
    chunks = None
    if ckpt_dir:
        n_chunks = -(-B // chunk_size)
        solved = ck.COUNTS["chunks_solved"] - solved0
        chunks = {"n": n_chunks, "solved": solved,
                  "loaded": n_chunks - solved}
    occ = None
    adm_ctrs = {}
    if obs_rec is not None:
        adm_ctrs = obs_rec.snapshot()[2]
        occ = obs_counters.occupancy(adm_ctrs)

    if energy is not None:
        from ..energy import extract_delay

        tau = extract_delay(res.observed)
    else:
        tau = _host(res.observed["tau"])
    status = _host(res.status)
    if segment_steps and int(segment_steps) > 0:
        gear_run, stride_run = resolve_pipeline_defaults(pipeline,
                                                         poll_every)
    else:
        # a monolithic launch runs no segmented gear: null, not a
        # resolved default that never executed
        gear_run = stride_run = None
    report = sweep_report(res, cfgs)
    log(f"[northstar] B={B} wall={wall:.1f}s -> {B / wall:.2f} cond/s "
        f"({int((status == SUCCESS).sum())}/{B} ok, "
        f"{int(np.isnan(tau).sum())} no-ignition)")
    log("[northstar] phases:\n" + ph.pretty())

    # --- tau parity spot check against the independent native C++ BDF ---
    spot = []
    if energy is not None:
        # the native oracle is isothermal only: no spot check exists for
        # the adiabatic family (recorded as null, not silently green)
        n_spot = 0
    if n_spot:
        from .. import native

        ign = np.nonzero(~np.isnan(tau) & (status == SUCCESS))[0]
        idx = (ign[np.linspace(0, ign.size - 1, min(n_spot, ign.size))
                   .astype(int)] if ign.size else [])
        T_h, phi_h, y0_h = _host(grid["T"]), _host(grid["phi"]), _host(y0s)
        ch4 = sp.index("CH4")
        with ph.span("spot_check"):
            for b in idx:
                tau_n = _spot_tau(native, gm, th, float(T_h[b]), y0_h[b],
                                  t1, ch4, rtol, atol)
                rel = (abs(tau_n - tau[b]) / tau_n if tau_n
                       else float("nan"))
                spot.append({"lane": int(b), "T": float(T_h[b]),
                             "phi": float(phi_h[b]),
                             "tau_device": float(tau[b]),
                             "tau_native": tau_n, "rel_err": float(rel)})
                log(f"[spot] lane {b}: T={T_h[b]:.0f} phi={phi_h[b]:.2f} "
                    f"tau={tau[b]:.4e} native={tau_n:.4e} rel={rel:.2%}")
    # a NaN rel_err (the native BDF disagrees about ignition itself) fails
    # the parity claim loudly instead of vanishing in max()'s NaN order;
    # None and a failure count keep the JSON valid (no inf/nan literals)
    failed_spots = sum(s["rel_err"] != s["rel_err"] for s in spot)
    finite = [s["rel_err"] for s in spot if s["rel_err"] == s["rel_err"]]
    parity = None if failed_spots else (max(finite) if finite else None)

    rec = {
        "workload": f"GRI30 {n_T}x{n_phi} TxPhi ignition map, 1 bar, "
                    f"t1={t1}, rtol={rtol} atol={atol}"
                    + (f", energy={energy}" if energy else ""),
        "energy": energy,
        "method": method,
        "exp32": bool(exp32),
        "jac_window": jac_window,
        # the segmented gear actually run, resolved by the library rule
        "pipeline": gear_run,
        "poll_every": stride_run,
        "admission": (admission if not isinstance(admission, bool)
                      else "chunk"),
        "occupancy": None if occ is None else round(occ, 6),
        "admitted_lanes": int(adm_ctrs.get("admitted_lanes", 0)),
        "bucket_downshifts": int(adm_ctrs.get("bucket_downshifts", 0)),
        "lane_cost_sorted": lane_cost is not None,
        "B": B,
        "wall_s": round(wall, 2),
        "cond_per_s": round(B / wall, 3),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else dev.type),
        "counts": report["counts"],
        "n_no_ignition": int(np.isnan(tau).sum()),
        "tau_range_s": [float(np.nanmin(tau)), float(np.nanmax(tau))],
        "tau_parity_max_rel_err": parity,
        "tau_parity_failed_spots": failed_spots,
        "spot_checks": spot,
        "phases_s": {k: round(v, 2) for k, v in ph.summary().items()},
        "lu32p_launches": launches,
        "chunks": chunks,
    }
    return (rec, res) if return_result else rec


def _admission(text):
    """``--admission``: 0 = off (the occupancy recorder still armed), 1 =
    on with the chunk-sized resident program, N > 1 = N resident lanes."""
    n = int(text)
    return None if n == 0 else True if n == 1 else n


def _energy(text):
    """``--energy``: 0 = isothermal, 1 = ``adiabatic_v``, or a mode."""
    return (None if text in ("0", "") else "adiabatic_v" if text == "1"
            else text)


def _build_parser():
    p = argparse.ArgumentParser(
        prog="northstar_sweep",
        description="the T x phi GRI-3.0 ignition map (north-star "
                    "workload) through the port")
    p.add_argument("--nt", type=int, default=64, help="T0 points")
    p.add_argument("--nphi", type=int, default=64, help="phi points")
    p.add_argument("--ckpt", default="",
                   help="checkpoint directory (chunked, resumable sweep); "
                        "empty: one segmented sweep")
    p.add_argument("--method", choices=("bdf", "sdirk"), default="bdf")
    p.add_argument("--jw", type=int, default=None,
                   help="Jacobian window (default 8 for bdf, 1 for sdirk)")
    p.add_argument("--seg", type=int, default=256, help="segment steps")
    p.add_argument("--chunk", type=int, default=512, help="chunk size")
    p.add_argument("--sort", choices=("0", "1"), default="1",
                   help="cost-sort the lanes before chunking")
    p.add_argument("--pipeline", choices=("0", "1"), default=None,
                   help="pin the segmented gear (default: the library "
                        "rule)")
    p.add_argument("--poll", type=int, default=None,
                   help="status poll stride of the pipelined gear")
    p.add_argument("--admission", default=None,
                   help="continuous batching: 0 off, 1 chunk-sized "
                        "resident program, N resident lanes; given at "
                        "all, the occupancy is recorded")
    p.add_argument("--energy", type=_energy, default=None,
                   help="0 isothermal, 1 adiabatic_v, or an energy mode")
    p.add_argument("--exp32", action=argparse.BooleanOptionalAction,
                   default=True, help="float32 rate exponentials")
    p.add_argument("--baseline", default=BASELINE,
                   help="baseline record whose per-lane sample orders "
                        "the lanes (default: NORTHSTAR_BASELINE.json)")
    p.add_argument("--out", default=os.path.join(OUT_DIR, "northstar.json"),
                   help="where the record is written")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    return p


def main(argv=None):
    args = _build_parser().parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"northstar_sweep: {e}", file=sys.stderr)
        return 1
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    rec = run_sweep(
        n_T=args.nt, n_phi=args.nphi, ckpt_dir=args.ckpt or None,
        method=args.method,
        # jac_window 8 is validated for BDF only; SDIRK keeps 1
        jac_window=(args.jw if args.jw is not None
                    else 8 if args.method == "bdf" else 1),
        segment_steps=args.seg, chunk_size=args.chunk,
        sort_lanes=args.sort == "1",
        pipeline=None if args.pipeline is None else args.pipeline == "1",
        poll_every=args.poll,
        admission=(None if args.admission is None
                   else _admission(args.admission)),
        record_occupancy=args.admission is not None,
        energy=args.energy, device=device, exp32=args.exp32,
        baseline=args.baseline, flight_dir=out_dir,
        log=lambda m: print(m, file=sys.stderr, flush=True))
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
