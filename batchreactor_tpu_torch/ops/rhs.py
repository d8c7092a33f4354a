"""Batch-reactor ODE right-hand sides and Jacobians, lane-batched.

Port of ``batchreactor_tpu/ops/rhs.py``.  The state is the per-species mass
density rho_k = rho * Y_k [kg/m^3] of the ng gas species, optionally
followed by the ns surface coverages theta_k, (B, ng [+ ns]); the reactor is
isothermal at constant volume, with per-lane temperature ``cfg["T"]`` and
surface-to-volume ratio ``cfg["Asv"]``, both (B,):

  d(rho_k)/dt   = sdot_k M_k Asv + wdot_k M_k      (gas species)
  d(theta_k)/dt = sdot_k sigma_k / Gamma           (surface coverages)

(the reference's mole-fraction/pressure round trip reduces exactly to
conc_k = rho_k / M_k).  ``asv_quirk`` reproduces the reference scaling the
whole surface source, coverages included, by Asv.

The JAX package's ``fence_blocks`` option (an XLA optimization barrier
around the Jacobian blocks) has no PyTorch counterpart and is not ported.
"""

import torch

from ..utils.composition import mass_to_mole, pressure
from . import gas_kinetics, surface_kinetics


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


def make_surface_rhs(sm, thermo, gm=None, asv_quirk=True, kc_compat=False,
                     exp32=False):
    """RHS for surface (and, with ``gm``, coupled gas) chemistry:
    ``rhs(t, y, cfg) -> dy`` with y = [rho_k, theta_k] (B, ng + ns) and
    cfg ``{"T": (B,), "Asv": (B,)}``.  ``exp32`` applies to the gas term."""
    ng = len(thermo.species) if gm is None else gm.n_species
    molwt = thermo.molwt
    # Gamma is stored in mol/cm^2 like the reference's site density; x1e4
    # -> mol/m^2
    cov_scale = sm.site_coordination / (sm.site_density * 1e4)

    def rhs(t, y, cfg):
        T, Asv = cfg["T"], cfg["Asv"][:, None]
        rho_k = y[:, :ng]
        theta = y[:, ng:]
        c_gas_cgs = rho_k / (molwt * 1e6)  # mol/cm^3
        sdot_gas, sdot_surf = surface_kinetics.production_rates_c(
            T, c_gas_cgs, theta, sm)
        sdot_gas = sdot_gas * Asv
        if asv_quirk:
            sdot_surf = sdot_surf * Asv  # the reference scales coverages too
        dy_gas = sdot_gas * molwt
        if gm is not None:
            conc = rho_k / molwt  # mol/m^3
            wdot = gas_kinetics.production_rates(T, conc, gm, thermo,
                                                 kc_compat, exp32=exp32)
            dy_gas = dy_gas + wdot * molwt
        return torch.cat([dy_gas, sdot_surf * cov_scale], dim=1)

    return rhs


def make_surface_jac(sm, thermo, gm=None, asv_quirk=True, kc_compat=False,
                     exp32=False, return_blocks=False):
    """Analytic Jacobian companion to :func:`make_surface_rhs`:
    ``jac(t, y, cfg) -> (B, n, n)`` over y = [rho_k, theta_k].  The cgs
    gas concentrations are rho_k/M_k * 1e-6, so the chain rule is a
    diagonal scale.  Blocks (ng gas rows, ns coverage rows):

      J_gg = Asv M_a dsdot_gas_a/dc_gas_b * 1e-6/M_b  [+ gas-phase block]
      J_gt = Asv M_a dsdot_gas_a/dtheta_b
      J_tg = quirk sigma_a/(Gamma 1e4) dsdot_surf_a/dc_gas_b * 1e-6/M_b
      J_tt = quirk sigma_a/(Gamma 1e4) dsdot_surf_a/dtheta_b

    with quirk = Asv under ``asv_quirk``, else 1.  ``return_blocks=True``
    returns ``(J_gg, J_gt, J_tg, J_tt)`` instead of the assembled matrix."""
    ng = len(thermo.species) if gm is None else gm.n_species
    molwt = thermo.molwt
    dcg = 1e-6 / molwt                      # d c_gas_cgs_b / d rho_b
    cov_scale = sm.site_coordination / (sm.site_density * 1e4)

    def jac(t, y, cfg):
        T, Asv = cfg["T"], cfg["Asv"][:, None, None]
        rho_k = y[:, :ng]
        theta = y[:, ng:]
        c_gas_cgs = rho_k / (molwt * 1e6)  # mol/cm^3 (same identity as rhs)
        _, _, (dg_dcg, dg_dth, ds_dcg, ds_dth) = (
            surface_kinetics.production_rates_and_jac_c(
                T, c_gas_cgs, theta, sm))
        coef = cov_scale[:, None] * Asv if asv_quirk else cov_scale[:, None]
        J_gg = Asv * molwt[:, None] * dg_dcg * dcg
        J_gt = Asv * molwt[:, None] * dg_dth
        J_tg = coef * ds_dcg * dcg
        J_tt = coef * ds_dth
        if gm is not None:
            conc = rho_k / molwt
            _, dwdot = gas_kinetics.production_rates_and_jac(
                T, conc, gm, thermo, kc_compat, exp32=exp32)
            J_gg = J_gg + dwdot * (molwt[:, None] / molwt[None, :])
        if return_blocks:
            return J_gg, J_gt, J_tg, J_tt
        return torch.cat([torch.cat([J_gg, J_gt], dim=2),
                          torch.cat([J_tg, J_tt], dim=2)], dim=1)

    return jac


def make_udf_rhs(udf, molwt, species=None):
    """RHS for a user-defined source function.

    ``udf(t, state) -> source (S,) [mol/m^3/s]`` is called per lane, mapped
    over the lanes with ``torch.func.vmap``, so it must be written with
    torch operations that ``vmap`` can batch (no in-place writes into its
    inputs, no ``.item()``).  ``state`` carries ``T``, ``p``,
    ``mole_frac``, ``molwt`` and ``species`` (the tuple of species names,
    so a UDF can map indices to names).  The solver's ``jac=None``
    fallback differentiates through it."""
    from torch.func import vmap

    species = tuple(species) if species is not None else None

    def one(t, y, T):
        rho = torch.sum(y)
        mole_fracs = mass_to_mole(y / rho, molwt)
        state = {"T": T, "p": pressure(rho, mole_fracs, molwt, T),
                 "mole_frac": mole_fracs, "molwt": molwt, "species": species}
        return udf(t, state)

    def rhs(t, y, cfg):
        B = y.shape[0]
        t = torch.as_tensor(t, dtype=y.dtype, device=y.device).expand(B)
        T = torch.as_tensor(cfg["T"], dtype=y.dtype,
                            device=y.device).expand(B)
        return vmap(one)(t, y, T) * molwt

    return rhs
