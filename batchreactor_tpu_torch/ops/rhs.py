"""Batch-reactor ODE right-hand side for gas-phase chemistry, lane-batched.

Port of the gas half of ``batchreactor_tpu/ops/rhs.py``.  The state is the
per-species mass density rho_k = rho * Y_k [kg/m^3], (B, S); the reactor is
isothermal at constant volume, with per-lane temperature ``cfg["T"]`` (B,):

  d(rho_k)/dt = wdot_k M_k,   conc_k = rho_k / M_k

(the reference's mole-fraction/pressure round trip reduces exactly to
conc_k = rho_k / M_k).  Surface and user-defined chemistry are not ported
yet (ROADMAP A7).
"""

from . import gas_kinetics


def make_gas_rhs(gm, thermo, kc_compat=False, exp32=False):
    """RHS for gas-only chemistry: ``rhs(t, y, cfg) -> dy`` with y (B, S)
    and cfg ``{"T": (B,)}``."""

    def rhs(t, y, cfg):
        conc = y / thermo.molwt  # mol/m^3
        wdot = gas_kinetics.production_rates(cfg["T"], conc, gm, thermo,
                                             kc_compat, exp32=exp32)
        return wdot * thermo.molwt

    return rhs


def make_gas_jac(gm, thermo, kc_compat=False, exp32=False):
    """Analytic Jacobian companion to :func:`make_gas_rhs`:
    ``jac(t, y, cfg) -> (B, S, S)`` with J_ab = d(rhs_a)/d(y_b)
    = M_a (dwdot_a/dconc_b) / M_b."""
    molwt = thermo.molwt
    scale = molwt[:, None] / molwt[None, :]

    def jac(t, y, cfg):
        conc = y / molwt
        _, dwdot = gas_kinetics.production_rates_and_jac(
            cfg["T"], conc, gm, thermo, kc_compat, exp32=exp32)
        return dwdot * scale

    return jac
