"""Reaction sensitivities of the GRI-3.0 ignition sweep in the JAX package,
on the CPU: the reference that ``chip_smoke.py``'s adjoint phase (17)
holds the card to.

    JAX_PLATFORMS=cpu python scripts/sens_reference.py

Lanes: CH4/O2/N2 = 0.25/0.5/0.25 at 1 bar, t1 = 8e-4 s, from
``chip_smoke.py``'s main-path grid (1024 temperatures in 1500-2000 K).

- ``lane0``: the phase-17 lane 0 (1500 K).  ``solve_adjoint`` of the
  ignition delay (CH4 falling to half its first-knot value) with respect
  to ln A of all 325 reactions, rtol 1e-6, atol 1e-10, ``grid_size=512``,
  ``segments=8``, ``grid_refine=2``, the analytic Jacobian, ``auto``
  linsolve (the float64 ``lu`` on the CPU).  Prints tau and the normalized
  coefficients d ln tau / d ln A_i in reaction order (``coeffs``, 4
  significant digits: the card is held to 1e-2 of the largest |s|), and
  the top 10.
- ``cross_check``: the 4 lanes of phase 17's forward-against-adjoint check
  (every 16th of the 64 coolest temperatures) to t1 / 4 = 2e-4 s, before
  they ignite, rtol 1e-8, atol 1e-12: the adjoint gradient of the final
  H2O mass density over ln A of the 18 reactions matching ``*CH4*``
  (``grid_size=256``) against the H2O row of the forward tangents, as the
  largest difference over the largest |grad| per lane (the JAX package's
  own tier is 1e-3).

Prints one JSON object.  Takes ~3 minutes.
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
from batchreactor_tpu.ops.rhs import make_gas_jac, make_gas_rhs  # noqa: E402
from batchreactor_tpu.parallel import sweep_solution_vectors  # noqa: E402
from batchreactor_tpu.parallel.sweep import (  # noqa: E402
    ensemble_solve_forward)
from batchreactor_tpu.sensitivity import adjoint, params, rank  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(HERE), "tests", "fixtures")
T_GRID = np.linspace(1500.0, 2000.0, 1024)
COMP = {"CH4": 0.25, "O2": 0.5, "N2": 0.25}
T1 = 8e-4


def main():
    gm = br.compile_gaschemistry(os.path.join(FIXTURES, "grimech.dat"))
    th = br.create_thermo(list(gm.species),
                          os.path.join(FIXTURES, "therm.dat"))
    sp = list(gm.species)
    x0 = np.zeros(len(sp))
    for k, v in COMP.items():
        x0[sp.index(k)] = v

    def lanes(T):
        return sweep_solution_vectors(
            jnp.asarray(np.broadcast_to(x0, (len(T), len(sp)))), th.molwt,
            jnp.asarray(T), 1e5)

    def theta_fns(spec):
        theta = params.extract(gm, spec)
        rhs_theta = params.make_rhs_theta(gm, spec,
                                          lambda m: make_gas_rhs(m, th))

        def jac_theta(t, y, th_, cfg):
            return make_gas_jac(params.apply(gm, th_, spec), th)(t, y, cfg)

        return theta, rhs_theta, jac_theta

    # ---- lane 0 of phase 17 ------------------------------------------------
    spec = params.select(gm)
    theta, rhs_theta, jac_theta = theta_fns(spec)
    T0 = float(T_GRID[0])
    tau, grad, aux = adjoint.solve_adjoint(
        rhs_theta, adjoint.ignition_delay_qoi(sp.index("CH4"), frac=0.5),
        lanes([T0])[0], 0.0, T1, theta, {"T": jnp.asarray(T0)},
        jac_theta=jac_theta, rtol=1e-6, atol=1e-10, grid_size=512,
        segments=8, grid_refine=2)
    s = rank.normalized_sensitivities(float(tau),
                                      np.asarray(grad["log_A"]))
    lane0 = {"T": T0, "tau": float(tau), "status": int(aux["status"]),
             "n_accepted": int(aux["n_accepted"]),
             "truncated": bool(aux["truncated"]),
             "max_abs_coeff": float(np.abs(s).max()),
             "top10": rank.top_k(s, spec.equations, k=10),
             "coeffs": [float(f"{v:.4g}") for v in s]}

    # ---- the forward-against-adjoint cross-check lanes ---------------------
    spec18 = params.select(gm, reactions="*CH4*")
    theta18, rhs18, jac18 = theta_fns(spec18)
    Tc = T_GRID[:64:16]
    y0s = lanes(Tc)
    h2o = sp.index("H2O")
    fwd = ensemble_solve_forward(
        rhs18, y0s, 0.0, T1 / 4, theta18, {"T": jnp.asarray(Tc)}, rtol=1e-8,
        atol=1e-12, jac=lambda t, y, cfg: jac18(t, y, theta18, cfg))
    S = np.asarray(fwd.tangents)[:, :, h2o]
    cross = []
    for b, Tb in enumerate(Tc):
        q, g, a = adjoint.solve_adjoint(
            rhs18, adjoint.final_species_qoi(h2o), y0s[b], 0.0, T1 / 4,
            theta18, {"T": jnp.asarray(Tb)}, jac_theta=jac18, rtol=1e-8,
            atol=1e-12, grid_size=256, segments=8, grid_refine=2)
        g = np.asarray(g["log_A"])
        cross.append({"T": float(Tb), "n_accepted": int(a["n_accepted"]),
                      "truncated": bool(a["truncated"]),
                      "max_abs_grad": float(np.abs(g).max()),
                      "adjoint_vs_forward": float(
                          np.abs(g - S[b]).max() / np.abs(g).max())})
    print(json.dumps({"lane0": lane0, "cross_check": cross}))


if __name__ == "__main__":
    main()
