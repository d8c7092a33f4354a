"""Public API of the port: the gas-phase forms of ``batch_reactor`` and the
ensemble ``batch_reactor_sweep``.

Port of ``batchreactor_tpu/api.py`` for gas-phase chemistry:

1. ``batch_reactor(input_file, lib_dir, gaschem=True)`` — XML-driven run
   that writes ``gas_profile.{dat,csv}`` next to the input file and returns
   the solver's status string.
2. ``batch_reactor(inlet_comp, T, p, time, chem=, thermo_obj=, md=)`` —
   programmatic dict-in/dict-out form; returns ``(times, {species: x})``.
3. ``batch_reactor_sweep(inlet_comp, T, p, time, chem=, thermo_obj=,
   md=)`` — one lane per condition, solved together.

Every entry point takes ``device=``: ``None`` runs on ``cuda`` and raises
without a GPU; pass ``device="cpu"`` for the CPU.  Options of the JAX API
that the port does not have yet raise ``NotImplementedError`` naming their
ROADMAP item.
"""

import dataclasses
import os
import sys

import numpy as np
import torch

from .device import resolve_device
from .io.config import input_data, parse_composition_text
from .io.writers import trim_trajectory, write_profiles
from .ops.rhs import make_gas_jac, make_gas_rhs
from .parallel.sweep import (ensemble_solve_segmented, ignition_observer,
                             sweep_report)
from .solver.common import (DT_UNDERFLOW, MAX_STEPS_REACHED, RUNNING,
                            SUCCESS, check_deferred)
from .solver.linalg import resolve_linsolve
from .utils.composition import density, mole_to_mass


@dataclasses.dataclass(frozen=True)
class Chemistry:
    """Chemistry-mode flags (the reference's ``ReactionCommons.Chemistry``);
    the port runs ``gaschem`` only."""

    surfchem: bool = False
    gaschem: bool = False
    userchem: bool = False
    udf: object = None


# retcode strings, as the JAX package reports them
_STATUS = {SUCCESS: "Success", MAX_STEPS_REACHED: "MaxIters",
           DT_UNDERFLOW: "DtLessThanMin", RUNNING: "Failure"}


def _status_str(code):
    return _STATUS.get(int(code)) or f"Failure({int(code)})"


def _gas_only(chem):
    if chem.surfchem or chem.userchem or chem.udf is not None:
        raise NotImplementedError(
            "only gas-phase chemistry is ported; surface, coupled and "
            "user-defined chemistry wait for ROADMAP A7")
    if not chem.gaschem:
        raise ValueError("the port needs chem.gaschem=True")


def get_solution_vector(mole_fracs, molwt, T, p, ini_covg=None):
    """y0 = rho * Y_k on ``molwt``'s device.  ``mole_fracs`` (S,) or
    (B, S); ``T``/``p`` scalars or (B,)."""
    if ini_covg is not None:
        raise NotImplementedError(
            "initial coverages belong to surface chemistry (ROADMAP A7)")
    dev = molwt.device
    x = torch.tensor(np.asarray(mole_fracs, dtype=np.float64), device=dev)
    T = torch.as_tensor(T, dtype=torch.float64, device=dev)
    p = torch.as_tensor(p, dtype=torch.float64, device=dev)
    rho = density(x, molwt, T, p)
    return rho[..., None] * mole_to_mass(x, molwt)


def resolve_jac_window(jac_window, method, device):
    """``jac_window=None`` -> 8 for BDF on the GPU (the bench protocol's
    quasi-constant iteration matrix), 1 on the CPU (the exact per-attempt
    Jacobian the parity tests pin)."""
    if jac_window is not None:
        return jac_window
    return 8 if (method == "bdf" and torch.device(device).type != "cpu") else 1


_SWEEP_DEFERRED = (
    ("smd", None, "A7"), ("asv_quirk", True, "A7"), ("mesh", None, "A5b"),
    ("energy", None, "A9"), ("atol_T", None, "A9"),
    ("telemetry", False, "A14"), ("pipeline", None, "A13"),
    ("poll_every", None, "A13"), ("buckets", None, "A13"),
    ("fetch_deadline", None, "A12"), ("quarantine", None, "A12"),
    ("admission", None, "A13"), ("refill", None, "A13"),
    ("timeline", None, "A14"), ("live_metrics", None, "A14"),
    ("species_buckets", None, "A10"), ("reaction_buckets", None, "A10"),
    ("mech_operands", False, "A10"), ("analytic_jac", True, "A13"),
)


def batch_reactor_sweep(inlet_comp, T, p, time, *, chem=None, thermo_obj=None,
                        md=None, gmd=None, Asv=1.0, rtol=1e-6, atol=1e-10,
                        max_steps=200_000, segment_steps=0, kc_compat=False,
                        ignition_marker=None, ignition_mode="half",
                        method="bdf", jac_window=None, linsolve="auto",
                        setup_economy=False, stale_tol=0.3, exp32=False,
                        device=None, **deferred):
    """Ensemble form: one lane per condition, all lanes solved together.

    ``T`` may be a scalar or a (B,) array; ``inlet_comp`` is one composition
    dict shared by all lanes or a dict of per-lane arrays.  Returns a dict
    with per-lane final mole fractions ``x`` {species: (B,)}, final times
    ``t``, ``status``, the ``report`` (:func:`sweep_report`) and, with
    ``ignition_marker`` (a species name), per-lane ignition delays ``tau``
    from the in-loop observer; ``linsolve`` and ``jac_window`` report the
    resolved solver configuration.  ``segment_steps > 0`` bounds each segment
    of the sweep driver; ``0`` runs one segment of ``max_steps``.

    ``jac_window=None`` resolves by device (:func:`resolve_jac_window`);
    ``linsolve="auto"`` resolves with the sweep's B and n (``"lu32p"`` on
    the GPU at B * n >= LU32P_MIN_BN, else ``"lu"``).  ``setup_economy``
    carries the Newton factorization across jac windows.  ``exp32``
    selects the float32 rate exponentials (off by default on every
    device).
    """
    check_deferred(deferred, _SWEEP_DEFERRED)
    if chem is None or thermo_obj is None:
        raise TypeError("batch_reactor_sweep needs chem= and thermo_obj=")
    _gas_only(chem)
    gm = gmd if gmd is not None else md
    if gm is None:
        raise TypeError("gas sweep needs md= or gmd=")
    device = resolve_device(device)
    gm, thermo_obj = gm.to(device), thermo_obj.to(device)
    species = thermo_obj.species

    T_np = np.atleast_1d(np.asarray(T, dtype=np.float64))
    B = max(T_np.shape[0],
            max((np.asarray(v).shape[0] for v in inlet_comp.values()
                 if np.ndim(v)), default=1))
    idx = {s.upper(): k for k, s in enumerate(species)}
    X = np.zeros((B, len(species)))
    for name, val in inlet_comp.items():
        key = name.upper()
        if key not in idx:
            raise KeyError(f"composition species {name!r} not in species list")
        X[:, idx[key]] = np.asarray(val)
    T_t = torch.as_tensor(np.broadcast_to(T_np, (B,)).copy(), device=device)
    y0s = get_solution_vector(X, thermo_obj.molwt, T_t, p)
    cfgs = {"T": T_t,
            "Asv": torch.full((B,), float(Asv), dtype=torch.float64,
                              device=device)}

    observer = obs0 = None
    if ignition_marker is not None:
        key = ignition_marker.upper()
        if key not in idx:
            raise KeyError(f"ignition_marker {ignition_marker!r} not in "
                           f"species list")
        observer, obs0 = ignition_observer(idx[key], mode=ignition_mode)
    rhs = make_gas_rhs(gm, thermo_obj, kc_compat=kc_compat, exp32=exp32)
    jac = make_gas_jac(gm, thermo_obj, kc_compat=kc_compat, exp32=exp32)
    jac_window = resolve_jac_window(jac_window, method, device)
    linsolve = resolve_linsolve(linsolve, method=method, device=device,
                                batch=B, n=len(species))
    if segment_steps > 0:
        seg = dict(segment_steps=segment_steps)
    else:
        seg = dict(segment_steps=int(max_steps), max_segments=1)
    res = ensemble_solve_segmented(
        rhs, y0s, 0.0, float(time), cfgs, rtol=rtol, atol=atol, jac=jac,
        observer=observer, observer_init=obs0, method=method,
        jac_window=jac_window, linsolve=linsolve,
        setup_economy=setup_economy, stale_tol=stale_tol, **seg)

    ng = len(species)
    molwt = thermo_obj.molwt.cpu().numpy()
    moles = res.y.cpu().numpy()[:, :ng] / molwt
    x_end = moles / moles.sum(axis=1, keepdims=True)
    out = {
        "x": {s: x_end[:, k] for k, s in enumerate(species)},
        "t": res.t.cpu().numpy(),
        "status": res.status.cpu().numpy(),
        "report": sweep_report(res, cfgs),
        # the resolved solver configuration the sweep actually ran
        "linsolve": linsolve,
        "jac_window": jac_window,
    }
    if ignition_marker is not None:
        out["tau"] = res.observed["tau"].cpu().numpy()
    return out


_RUN_DEFERRED = (
    ("sens", False, "A11"), ("sens_params", None, "A11"),
    ("sens_qoi", None, "A11"), ("sens_grid", 512, "A11"),
    ("surfchem", False, "A7"), ("asv_quirk", True, "A7"),
    ("backend", None, "A16"), ("telemetry", False, "A14"),
)


def _run_solve(gm, thermo, y0, T, t1, *, rtol, atol, n_save, max_steps,
               kc_compat, method, jac_window, segmented, exp32):
    """One condition through the sweep driver (B = 1); returns (status,
    t_end, y_end, ts, ys, truncated, n_acc, n_rej) with ts/ys including the
    initial row."""
    dev = y0.device
    jac_window = resolve_jac_window(jac_window, method, dev)
    seg_steps = (min(512, int(max_steps)) if segmented in (None, True)
                 else int(max_steps))
    res = ensemble_solve_segmented(
        make_gas_rhs(gm, thermo, kc_compat=kc_compat, exp32=exp32),
        y0[None, :], 0.0, float(t1),
        {"T": torch.full((1,), float(T), dtype=torch.float64, device=dev)},
        rtol=rtol, atol=atol, n_save=n_save, segment_steps=seg_steps,
        max_segments=max(1, -(-int(max_steps) // seg_steps)),
        max_attempts=int(max_steps),
        jac=make_gas_jac(gm, thermo, kc_compat=kc_compat, exp32=exp32),
        method=method, jac_window=jac_window)
    y_end = res.y[0].cpu().numpy()
    ts, ys, truncated = trim_trajectory(
        0.0, y0.cpu().numpy(), res.ts[0].numpy(), res.ys[0].numpy(),
        res.n_saved[0], res.n_accepted[0], res.t[0], y_end)
    return (_status_str(res.status[0]), float(res.t[0]), y_end, ts, ys,
            truncated, int(res.n_accepted[0]), int(res.n_rejected[0]))


def batch_reactor(*args, gaschem=False, Asv=1.0, chem=None, thermo_obj=None,
                  md=None, rtol=1e-6, atol=1e-10, n_save=16384,
                  max_steps=200_000, kc_compat=False, verbose=True,
                  segmented=None, method="bdf", jac_window=None, exp32=False,
                  device=None, **deferred):
    """Simulate an isothermal constant-volume batch reactor (gas phase).

    File-driven:   ``batch_reactor(input_file, lib_dir, gaschem=True)``
        -> ``"Success" | ...``; writes ``gas_profile.{dat,csv}`` next to
        the input file and, with ``verbose``, prints every accepted step
        time and a summary line, as the reference does.
    Programmatic:  ``batch_reactor(inlet_comp, T, p, time, chem=,
        thermo_obj=, md=)`` -> ``(times, {species: final x})``.

    ``segmented=None``/``True`` runs the solve in segments of at most 512
    attempts; ``False`` in one segment of ``max_steps``.  ``jac_window``
    follows :func:`resolve_jac_window`."""
    check_deferred(deferred, _RUN_DEFERRED)
    if method != "bdf":
        raise NotImplementedError(
            f"method={method!r} is not ported yet (ROADMAP A8)")
    solve_kw = dict(rtol=rtol, atol=atol, n_save=n_save, max_steps=max_steps,
                    kc_compat=kc_compat, method=method,
                    jac_window=jac_window, segmented=segmented, exp32=exp32)
    if args and isinstance(args[0], dict):
        if len(args) != 4:
            raise TypeError(
                "programmatic form: batch_reactor(inlet_comp, T, p, time, "
                "chem=..., thermo_obj=..., md=...)")
        if chem is None or thermo_obj is None or md is None:
            raise TypeError("programmatic form needs chem=, thermo_obj=, md=")
        _gas_only(chem)
        inlet_comp, T, p, time = args
        device = resolve_device(device)
        gm, thermo_obj = md.to(device), thermo_obj.to(device)
        species = thermo_obj.species
        comp_text = ",".join(f"{k}={v}" for k, v in inlet_comp.items())
        x0 = parse_composition_text(comp_text, species)
        y0 = get_solution_vector(x0, thermo_obj.molwt, float(T), float(p))
        status, t_end, y_end, ts, _, _, _, _ = _run_solve(
            gm, thermo_obj, y0, T, time, **solve_kw)
        if status != "Success":
            raise RuntimeError(
                f"batch_reactor integration failed with {status} at "
                f"t={t_end:.4e} of {float(time):.4e} s")
        moles = y_end / thermo_obj.molwt.cpu().numpy()
        x_end = moles / moles.sum()
        return ts, dict(zip(species, x_end.tolist()))

    if len(args) != 2:
        raise TypeError(
            f"unrecognized batch_reactor argument pattern: {args!r}")
    if chem is None:
        chem = Chemistry(gaschem=gaschem)
    _gas_only(chem)
    input_file, lib_dir = args
    id_ = input_data(input_file, lib_dir, chem, device=device)
    y0 = get_solution_vector(id_.mole_fracs, id_.thermo.molwt, id_.T, id_.p)
    status, t_end, _, ts, ys, truncated, n_acc, n_rej = _run_solve(
        id_.gmd, id_.thermo, y0, id_.T, id_.tf, **solve_kw)
    if verbose:
        # the reference prints every accepted time (@printf("%4e\n",t));
        # ts[0] is the initial row and a truncated run's last row is a
        # final-state bridge, neither an accepted step
        for tv in (ts[1:-1] if truncated else ts[1:]):
            print(f"{tv:4e}")
    if truncated:
        print(f"warning: trajectory buffer full "
              f"({n_acc} accepted steps > n_save={n_save}); "
              f"profile files skip the overflow but end at the true final "
              f"state", file=sys.stderr)
    out_dir = os.path.dirname(os.path.abspath(input_file))
    write_profiles(out_dir, id_.species, ts, ys, id_.T,
                   id_.thermo.molwt.cpu().numpy())
    if verbose:
        print(f"t = {t_end:.4e} s  "
              f"({n_acc} accepted / {n_rej} rejected steps)")
    return status
