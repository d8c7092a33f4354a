"""Surface molar production rates and their closed-form Jacobian blocks.

Port of ``batchreactor_tpu/ops/surface_kinetics.py``.  The JAX forms take a
scalar T and (S,) vectors under ``vmap``; these take ``T`` (B,), gas
concentrations (B, Sg) and coverages (B, Ss) and return (B, R) rate
constants, (B, Sg)/(B, Ss) production rates and (B, ·, ·) Jacobian blocks,
all float64.  Rate-law conventions: the module docstring of
``models/surface.py``.

Internally cgs (mol/cm^3 gas, mol/cm^2 surface), because the mechanism's A
values are cgs; the single x1e4 conversion to SI mol/m^2/s happens at the
end.
"""

import torch

from ..utils.constants import R
# the forward rates and the analytic Jacobian share ONE stoichiometric-
# product implementation (clamps included), so the Jacobian cannot drift
# from the derivative of the RHS
from .gas_kinetics import _stoich_prod, _stoich_prod_and_grad

_EXP_MAX = 690.0
# cgs gas constant for the sticking flux sqrt(R T / 2 pi M): erg/(mol K)
_R_CGS = R * 1e7
_PI = 3.141592653589793


def rate_constants(T, theta, sm, with_grad=False):
    """Effective rate constants (B, R), cgs units.

    ``with_grad=True`` also returns dk/dtheta (B, R, Ss): the one
    implementation both the forward rates and the analytic Jacobian use."""
    T = T[:, None]
    # coverage-dependent activation energy Ea_eff = Ea + eps @ theta, on
    # Arrhenius AND sticking rows
    Ea_eff = sm.Ea + theta @ sm.cov_eps.T
    log_arg = sm.beta * torch.log(T) - Ea_eff / (R * T)
    k_arr = torch.exp(torch.clamp(sm.log_A + log_arg, -_EXP_MAX, _EXP_MAX))
    # sticking: (s0/(1-s0/2) if MWC) sqrt(RT/2piM) [cm/s]; theta enters
    # the rate directly
    s_raw = sm.stick_s0 * torch.exp(torch.clamp(log_arg, -_EXP_MAX,
                                                _EXP_MAX))
    denom = 1.0 - s_raw / 2.0
    s_eff = torch.where(sm.mwc > 0, s_raw / denom, s_raw)
    flux = torch.sqrt(T) * torch.sqrt(_R_CGS / (2.0 * _PI * sm.stick_molwt))
    k = torch.where(sm.stick > 0, s_eff * flux, k_arr)
    if not with_grad:
        return k
    # d/dEa_eff: Arrhenius -k/(RT); stick s_raw' = -s_raw/(RT) through the
    # Motz-Wise chain d(s/(1-s/2))/ds = 1/denom^2
    dmwc_ds = torch.where(sm.mwc > 0, 1.0 / (denom * denom), 1.0)
    dk_dEa = torch.where(sm.stick > 0,
                         flux * dmwc_ds * (-s_raw / (R * T)),
                         -k_arr / (R * T))
    return k, dk_dEa[..., None] * sm.cov_eps


def reaction_rates_c(T, c_gas, theta, sm):
    """Rate of progress per reaction (B, R), mol/cm^2/s, from cgs gas
    concentrations c_gas [mol/cm^3]."""
    c_surf = theta * sm.site_density / sm.site_coordination  # mol/cm^2
    k = rate_constants(T, theta, sm)
    gas_part = _stoich_prod(c_gas, sm.expo_gas, sm.int_expo)
    # stick rows use raw coverages; Arrhenius rows surface concentrations
    surf_conc_part = _stoich_prod(c_surf, sm.expo_surf, sm.int_expo)
    surf_theta_part = _stoich_prod(theta, sm.expo_surf, sm.int_expo)
    surf_part = torch.where(sm.stick > 0, surf_theta_part, surf_conc_part)
    return k * gas_part * surf_part


def _c_gas_cgs(T, p, mole_fracs):
    """x p/(RT) in mol/cm^3, (B, Sg)."""
    return mole_fracs * (p / (R * T))[..., None] * 1e-6


def reaction_rates(T, p, mole_fracs, theta, sm):
    """Rate of progress per reaction (B, R), mol/cm^2/s."""
    return reaction_rates_c(T, _c_gas_cgs(T, p, mole_fracs), theta, sm)


def production_rates_c(T, c_gas, theta, sm):
    """(sdot_gas (B, Sg), sdot_surf (B, Ss)) in SI mol/m^2/s from cgs gas
    concentrations.  The reactor RHS enters here: in its state the
    mole-fraction/pressure round trip reduces to c_gas_k = rho_k/(M_k 1e6)."""
    q = reaction_rates_c(T, c_gas, theta, sm)        # mol/cm^2/s
    sdot_gas = q @ (sm.nu_r_gas - sm.nu_f_gas) * 1e4
    sdot_surf = q @ (sm.nu_r_surf - sm.nu_f_surf) * 1e4
    return sdot_gas, sdot_surf


def production_rates(T, p, mole_fracs, theta, sm):
    """(sdot_gas (B, Sg), sdot_surf (B, Ss)) in SI mol/m^2/s."""
    return production_rates_c(T, _c_gas_cgs(T, p, mole_fracs), theta, sm)


def production_rates_and_jac(T, p, mole_fracs, theta, sm):
    """Production rates plus their closed-form Jacobian blocks.

    Returns ``(sdot_gas, sdot_surf, (dgas_dcg, dgas_dth, dsurf_dcg,
    dsurf_dth))``: the derivatives of the SI production rates with respect
    to the cgs gas concentrations c_gas = x p/(RT) 1e-6 [mol/cm^3] and the
    raw coverages theta, each (B, rows, cols).  The reactor-state chain
    rule lives in ``ops/rhs.make_surface_jac``.  Per reaction row j:

      q_j = k_j(theta) * G_j(c_gas) * S_j(theta)
      dk_j/dtheta_k = (dk_j/dEa_eff) cov_eps_jk
      dS_j/dtheta_k: stick rows use raw coverages; Arrhenius rows go
        through c_surf = theta Gamma/sigma.
    """
    return production_rates_and_jac_c(T, _c_gas_cgs(T, p, mole_fracs), theta,
                                      sm)


def production_rates_and_jac_c(T, c_gas, theta, sm):
    """:func:`production_rates_and_jac` from cgs gas concentrations — the
    reactor's entry (see :func:`production_rates_c`)."""
    gamma_sig = sm.site_density / sm.site_coordination        # (Ss,)
    c_surf = theta * gamma_sig                                # mol/cm^2

    k, dk_dth = rate_constants(T, theta, sm, with_grad=True)

    G, dG = _stoich_prod_and_grad(c_gas, sm.expo_gas, sm.int_expo)
    Sc, dSc = _stoich_prod_and_grad(c_surf, sm.expo_surf, sm.int_expo)
    St, dSt = _stoich_prod_and_grad(theta, sm.expo_surf, sm.int_expo)
    S_sel = torch.where(sm.stick > 0, St, Sc)
    dS_dth = torch.where(sm.stick[:, None] > 0, dSt, dSc * gamma_sig)

    q = k * G * S_sel                                         # (B, R)
    dq_dcg = (k * S_sel)[..., None] * dG                      # (B, R, Sg)
    dq_dth = ((G * S_sel)[..., None] * dk_dth
              + (k * G)[..., None] * dS_dth)                  # (B, R, Ss)

    dnu_g = sm.nu_r_gas - sm.nu_f_gas                         # (R, Sg)
    dnu_s = sm.nu_r_surf - sm.nu_f_surf                       # (R, Ss)
    return (q @ dnu_g * 1e4, q @ dnu_s * 1e4,
            (torch.matmul(dnu_g.T, dq_dcg) * 1e4,
             torch.matmul(dnu_g.T, dq_dth) * 1e4,
             torch.matmul(dnu_s.T, dq_dcg) * 1e4,
             torch.matmul(dnu_s.T, dq_dth) * 1e4))
