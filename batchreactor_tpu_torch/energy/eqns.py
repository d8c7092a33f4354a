"""Non-isothermal reactor equations: the energy ODE over ``[rho_k, T]``.

Port of ``batchreactor_tpu/energy/eqns.py`` on lane-batched states
``y = [rho*Y_1 .. rho*Y_S, T]``, (B, S+1): the trailing row is the
temperature, and dT/dt closes from the species production rates through
NASA-7 thermodynamics.

Modes (:func:`resolve_energy` is the one validation rule):

* ``None`` — isothermal: the gas RHS and Jacobian, unchanged;
* ``"adiabatic_v"`` — adiabatic constant volume:

    d(rho_k)/dt = wdot_k M_k
    dT/dt       = -sum_k u_k wdot_k / sum_k c_k Cv_k

  with molar internal energies ``u_k = h_k - R T`` and ``Cv_k = Cp_k - R``;
* ``"adiabatic_p"`` — adiabatic constant pressure, where the partial
  densities carry the thermal-expansion dilution of ``rho = p Wbar / RT``:

    d(rho_k)/dt = wdot_k M_k - rho_k (sum_j wdot_j / Ctot + (dT/dt)/T)
    dT/dt       = -sum_k h_k wdot_k / sum_k c_k Cp_k

The analytic Jacobian keeps the gas Jacobian's species block; the dense
dwdot/dT column and the NASA-7 T-derivatives (dCp/dT, dh/dT) are one
forward-mode derivative each (``torch.func.jvp`` in T, a tangent of ones
over the lanes; the rate kernel's clamps were built for tangents), and the
dT/dt row closes by the chain rule over the mixture sums.

The T row lives on a ~1000 K scale while the species rows sit at
~1e-1 kg/m^3, so it gets its own absolute tolerance ``atol_T``: the
per-lane ``ATOL_SCALE_KEY`` cfg operand (:func:`energy_atol_scale`) is
ones over the species rows and ``atol_T / atol`` on the T row.
"""

import torch

from ..device import resolve_device
from ..ops.gas_kinetics import production_rates, production_rates_and_jac
from ..ops.rhs import make_gas_jac, make_gas_rhs
from ..ops.thermo import cp_h_s_over_R
from ..solver.common import ATOL_SCALE_KEY, NLIVE_KEY
from ..utils.constants import R

#: accepted non-None mode literals, in documentation order
ENERGY_MODES = ("adiabatic_v", "adiabatic_p")

#: default absolute tolerance on the temperature row [K]
DEFAULT_ATOL_T = 1e-4


def resolve_energy(energy):
    """The validation rule for the ``energy=`` knob: ``None``/``False`` ->
    ``None`` (isothermal), the mode literals pass through, anything else
    raises naming the accepted values."""
    if energy is None or energy is False:
        return None
    if energy in ENERGY_MODES:
        return energy
    raise ValueError(
        f"unknown energy mode {energy!r}; accepted: None (isothermal), "
        f"'adiabatic_v' (adiabatic constant-volume), 'adiabatic_p' "
        f"(adiabatic constant-pressure)")


def _mix_thermo(T, thermo):
    """(Cp [J/mol/K], h [J/mol]), each (B, S), at temperatures T (B,)."""
    cp_R, h_RT, _ = cp_h_s_over_R(T, thermo)
    return cp_R * R, h_RT * (R * T)[:, None]


def _d_dT(fn, T):
    """(fn(T), d fn / dT) by one forward-mode derivative over the lanes'
    temperatures T (B,)."""
    from torch.func import jvp

    return jvp(fn, (T,), (torch.ones_like(T),))


def _dot(a, b):
    """Per-lane dot product over the last axis."""
    return torch.sum(a * b, dim=-1)


def _vecmat(v, M):
    """Per-lane row vector times matrix: sum_a v_a M_ab, (B, S)."""
    return torch.matmul(v[:, None, :], M)[:, 0]


def make_energy_rhs(gm, thermo, mode, kc_compat=False, exp32=False):
    """RHS over ``y = [rho_k, T]`` (B, S+1) for an adiabatic ``mode``
    (module doc); ``cfg`` is not read.  ``mode=None`` returns the
    isothermal gas RHS."""
    mode = resolve_energy(mode)
    if mode is None:
        return make_gas_rhs(gm, thermo, kc_compat=kc_compat, exp32=exp32)
    molwt = thermo.molwt

    def rhs(t, y, cfg):
        rho_y, T = y[:, :-1], y[:, -1]
        conc = rho_y / molwt
        wdot = production_rates(T, conc, gm, thermo, kc_compat, exp32=exp32)
        cp, h = _mix_thermo(T, thermo)
        if mode == "adiabatic_v":
            u = h - R * T[:, None]
            cv = cp - R
            Tdot = -_dot(u, wdot) / _dot(conc, cv)
            dy = wdot * molwt
        else:  # adiabatic_p
            Tdot = -_dot(h, wdot) / _dot(conc, cp)
            # the constant-p dilution keeps Ctot = p/(RT) along the path
            Ctot = torch.sum(conc, dim=-1)
            dil = torch.sum(wdot, dim=-1) / Ctot + Tdot / T
            dy = wdot * molwt - rho_y * dil[:, None]
        return torch.cat([dy, Tdot[:, None]], dim=1)

    return rhs


def make_energy_jac(gm, thermo, mode, kc_compat=False, exp32=False):
    """Analytic Jacobian companion to :func:`make_energy_rhs`:
    ``jac(t, y, cfg) -> (B, S+1, S+1)``.  ``mode=None`` returns the
    isothermal gas Jacobian."""
    mode = resolve_energy(mode)
    if mode is None:
        return make_gas_jac(gm, thermo, kc_compat=kc_compat, exp32=exp32)
    molwt = thermo.molwt
    inv_w = 1.0 / molwt
    scale = molwt[:, None] * inv_w[None, :]

    def jac(t, y, cfg):
        rho_y, T = y[:, :-1], y[:, -1]
        conc = rho_y / molwt
        wdot, dwdot = production_rates_and_jac(T, conc, gm, thermo,
                                               kc_compat, exp32=exp32)
        # the dense dwdot/dT column and the NASA-7 T-derivatives: one
        # forward-mode derivative each
        _, dwdot_dT = _d_dT(
            lambda Tv: production_rates(Tv, conc, gm, thermo, kc_compat,
                                        exp32=exp32), T)
        (cp, h), (dcp, dh) = _d_dT(lambda Tv: _mix_thermo(Tv, thermo), T)
        if mode == "adiabatic_v":
            u = h - R * T[:, None]
            du = dh - R          # == Cv_k, through the same derivative
            cv = cp - R
            ccv = _dot(conc, cv)
            Tdot = -_dot(u, wdot) / ccv
            J_ss = dwdot * scale
            J_sT = dwdot_dT * molwt
            # dTdot/dc_b = -(u . dwdot[:, b])/ccv - Tdot Cv_b/ccv
            dTdot_dc = (-_vecmat(u, dwdot) / ccv[:, None]
                        - Tdot[:, None] * cv / ccv[:, None])
            J_Ts = dTdot_dc * inv_w
            J_TT = ((-_dot(du, wdot) - _dot(u, dwdot_dT)) / ccv
                    - Tdot * _dot(conc, dcp) / ccv)
        else:  # adiabatic_p
            ccp = _dot(conc, cp)
            Tdot = -_dot(h, wdot) / ccp
            dTdot_dc = (-_vecmat(h, dwdot) / ccp[:, None]
                        - Tdot[:, None] * cp / ccp[:, None])
            dTdot_dT = ((-_dot(dh, wdot) - _dot(h, dwdot_dT)) / ccp
                        - Tdot * _dot(conc, dcp) / ccp)
            Ctot = torch.sum(conc, dim=-1)
            W = torch.sum(wdot, dim=-1)
            dil = W / Ctot + Tdot / T
            colsum = torch.sum(dwdot, dim=1)          # dW/dc_b
            ddil_dc = (colsum / Ctot[:, None]
                       - (W / (Ctot * Ctot))[:, None]
                       + dTdot_dc / T[:, None])
            ddil_dT = (torch.sum(dwdot_dT, dim=-1) / Ctot + dTdot_dT / T
                       - Tdot / (T * T))
            eye = torch.eye(molwt.shape[0], dtype=y.dtype, device=y.device)
            J_ss = (dwdot * scale - dil[:, None, None] * eye
                    - rho_y[:, :, None] * (ddil_dc * inv_w)[:, None, :])
            J_sT = dwdot_dT * molwt - rho_y * ddil_dT[:, None]
            J_Ts = dTdot_dc * inv_w
            J_TT = dTdot_dT
        top = torch.cat([J_ss, J_sT[:, :, None]], dim=2)
        bot = torch.cat([J_Ts, J_TT[:, None]], dim=1)[:, None, :]
        return torch.cat([top, bot], dim=1)

    return jac


def extend_states(y0s, T):
    """``(B, S) -> (B, S+1)``: append the lanes' initial temperatures
    (a scalar or (B,)) as the trailing state row, on ``y0s``'s device."""
    T = torch.as_tensor(T, dtype=y0s.dtype, device=y0s.device)
    T = T.expand(y0s.shape[0])
    return torch.cat([y0s, T[:, None]], dim=1)


def energy_atol_scale(n_lanes, n, atol, atol_T=None, device=None):
    """The (B, n) :data:`ATOL_SCALE_KEY` operand of an energy-extended
    state: ones over the species rows and ``atol_T / atol`` on the
    trailing T row, so the solvers weigh the temperature error at
    ``atol_T`` Kelvin.  ``atol_T=None`` -> :data:`DEFAULT_ATOL_T`."""
    atol_T = DEFAULT_ATOL_T if atol_T is None else float(atol_T)
    if atol_T <= 0:
        raise ValueError(f"atol_T must be positive Kelvin, got {atol_T}")
    row = torch.ones(int(n), dtype=torch.float64,
                     device=resolve_device(device))
    row[-1] = atol_T / float(atol)
    return row.expand(int(n_lanes), int(n)).clone()


def energy_cfg(cfgs, energy, n_lanes, n, atol, atol_T=None, device=None):
    """A copy of the per-lane ``cfgs`` extended for an energy-mode sweep
    with the T-row :data:`ATOL_SCALE_KEY` operand, and the live count
    (``NLIVE_KEY``, set by mechanism padding) bumped by one for the live T
    row; ``energy=None`` returns ``cfgs`` itself."""
    if resolve_energy(energy) is None:
        return cfgs
    out = dict(cfgs)
    if NLIVE_KEY in out:
        out[NLIVE_KEY] = out[NLIVE_KEY] + 1.0
    out[ATOL_SCALE_KEY] = energy_atol_scale(n_lanes, n, atol, atol_T,
                                            device=device)
    return out
