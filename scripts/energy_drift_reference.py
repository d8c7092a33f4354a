"""Energy conservation of adiabatic GRI-3.0 sweeps in the JAX package, on
the CPU: the reference that sets the bounds of ``chip_smoke.py``'s energy
phases.

    JAX_PLATFORMS=cpu python scripts/energy_drift_reference.py

Lanes: CH4 in air at 1 bar, taken from ``chip_smoke.py``'s phase-11 grid
(phi 0.5, 0.75, 1.0, 1.5 x 256 temperatures in 1500-2000 K): for
``adiabatic_v`` every 51st temperature at each phi (24 lanes), for
``adiabatic_p`` the first 64 lanes (phi = 0.5, phase 12).  Each goes
through ``batch_reactor_sweep`` in the reference configuration (float64
``lu``, ``jac_window=1``) to t1 = 1e-2 s at rtol 1e-6, atol 1e-10.

The drift of a lane is |e(t1) - e(0)| / sum_k |Y_k e_k(0)|, with e the
mass-specific internal energy sum_k Y_k u_k / M_k (constant volume) or
enthalpy sum_k Y_k h_k / M_k (constant pressure), both of which the
reactor conserves; ``chip_smoke.py`` computes the same from the port's
final x and T.  Prints one JSON object per mode.
"""

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

import batchreactor_tpu as br  # noqa: E402
from batchreactor_tpu.ops.thermo import cp_h_s_over_R  # noqa: E402
from batchreactor_tpu.parallel import premixed_mole_fracs  # noqa: E402
from batchreactor_tpu.utils.constants import R  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(HERE), "tests", "fixtures")
PHI = (0.5, 0.75, 1.0, 1.5)
T_GRID = np.linspace(1500.0, 2000.0, 256)


def specific_energy(x, T, molwt, thermo, mode):
    """(e, sum_k |Y_k e_k|) per lane from mole fractions (B, S) and T."""
    _, h_RT, _ = jax.vmap(lambda t: cp_h_s_over_R(t, thermo))(
        jnp.asarray(T))
    h = np.asarray(h_RT) * R * T[:, None]                 # J/mol
    e = h - R * T[:, None] if mode == "adiabatic_v" else h
    Y = x * molwt / (x @ molwt)[:, None]
    terms = Y * e / molwt                                 # J/kg
    return terms.sum(axis=1), np.abs(terms).sum(axis=1)


def main():
    gm = br.compile_gaschemistry(os.path.join(FIXTURES, "grimech.dat"))
    th = br.create_thermo(list(gm.species),
                          os.path.join(FIXTURES, "therm.dat"))
    sp = list(gm.species)
    molwt = np.asarray(th.molwt)
    for mode in ("adiabatic_v", "adiabatic_p"):
        if mode == "adiabatic_v":
            lanes = [(p, t) for p in PHI for t in T_GRID[::51]]
        else:
            lanes = [(PHI[0], t) for t in T_GRID[:64]]
        phi = np.array([p for p, _ in lanes])
        T = np.array([t for _, t in lanes])
        x0 = np.asarray(premixed_mole_fracs(
            sp, "CH4", jnp.asarray(phi), diluent="N2", stoich_o2=2.0,
            o2_to_diluent=3.76))
        comp = {s: x0[:, k] for k, s in enumerate(sp) if x0[:, k].any()}
        out = br.batch_reactor_sweep(
            comp, T, 1e5, 1e-2, chem=br.Chemistry(gaschem=True),
            thermo_obj=th, md=gm, rtol=1e-6, atol=1e-10, energy=mode,
            linsolve="lu", jac_window=1)
        x1 = np.stack([out["x"][s] for s in sp], axis=1)
        e0, scale = specific_energy(x0, T, molwt, th, mode)
        e1, _ = specific_energy(x1, out["T"], molwt, th, mode)
        drift = np.abs(e1 - e0) / scale
        print(json.dumps({
            "mode": mode, "lanes": len(lanes),
            "success": int((out["status"] == 1).sum()),
            "drift_max": float(drift.max()),
            "drift_median": float(np.median(drift)),
            "tau_min": float(np.nanmin(out["ignition_delay"])),
            "tau_max": float(np.nanmax(out["ignition_delay"]))}),
            flush=True)


if __name__ == "__main__":
    main()
