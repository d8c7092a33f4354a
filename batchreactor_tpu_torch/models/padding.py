"""Mechanism-shape padding: a mechanism on a larger (species, reactions)
shape whose dead tail is inert.

Port of ``batchreactor_tpu/models/padding.py`` (``mech_shape_class`` :60,
``pad_gas_mechanism`` :91, ``pad_thermo`` :174, ``pad_states`` :225,
``nlive_cfg`` :238).  On the card the padded species count is the Newton
matrices' n, so padding sets the ``lu32p`` kernel's path: GRI-3.0's 53
species take the warp path (npad 56), padded to 96 the CTA path.

:func:`pad_gas_mechanism` pads a :class:`~.gas.GasMechanism` onto
``(S_pad, R_pad)`` such that the dead tail is inert:

* **dead species** carry zero stoichiometry columns (``nu_f``/``nu_r``),
  zero third-body efficiency columns, zero initial mass (the caller pads
  states with :func:`pad_states`), and the inert NASA-7 row
  (:func:`pad_thermo`: ``cp = R``, ``h = RT``, so the energy equations'
  ``Cv``/``u`` vanish on the dead tail too).  Their production rates, their
  Jacobian rows and columns and their error-norm contributions are exactly
  ``0.0``, and the Newton matrix ``M = I - cJ`` is the identity on the
  dead block (the LU of a block-diagonal ``[M_live, I]`` reproduces the
  live factorization);
* **dead reactions** carry ``log_A = _LOG_ZERO`` (the ln-domain zero the
  parser uses for absent LOW slots), zero stoichiometry rows, zero
  efficiency rows and every feature mask off: their net rate meets
  all-zero ``dnu`` rows, an exact ``+0.0`` per product term.

The one quantity padding can perturb is the solvers' scaled RMS norm,
whose mean divides by the state length.  The sweep therefore sets the
reserved ``cfg["_nlive"]`` operand (:data:`~..solver.common.NLIVE_KEY`)
to the live count, and the padded run takes the unpadded run's steps.

``canonical=True`` replaces the species and equation names with
shape-derived placeholders, so two mechanisms padded to one shape give
bundles with the same names (the JAX package's operand mode shares one
executable between them; the port compiles no program per mechanism).
Shape compatibility is :func:`mech_shape_class`.
"""

import numpy as np
import torch

from ..solver.common import NLIVE_KEY
from .gas import _LOG_ZERO, GasMechanism
from .thermo import ThermoTable


def mech_shape_class(gm, thermo=None):
    """The shape signature of a (possibly padded) mechanism: every
    attribute that sets a tensor shape or a rate-code branch.  Equal
    signatures mean the padded bundles are interchangeable."""
    sig = {
        "S": int(gm.n_species),
        "R": int(gm.n_reactions),
        "P": int(gm.plog_lnp.shape[1]),
        "NT": int(gm.cheb_coef.shape[1]),
        "NP": int(gm.cheb_coef.shape[2]),
        "int_stoich": bool(gm.int_stoich),
        "any_plog": bool(gm.any_plog),
        "any_cheb": bool(gm.any_cheb),
    }
    if thermo is not None:
        sig["S_thermo"] = int(thermo.n_species)
    return sig


def _canonical_names(prefix, n):
    return tuple(f"_{prefix}{k}" for k in range(n))


def _pad_species_names(species, s_pad, canonical):
    if canonical:
        return _canonical_names("S", s_pad)
    return tuple(species) + tuple(
        f"_PAD_S{k}" for k in range(s_pad - len(species)))


def _cat(a, fill, n_pad, dim=0):
    """``a`` with ``n_pad`` slices of constant ``fill`` appended on
    ``dim``; ``fill`` broadcasts against one slice."""
    shape = list(a.shape)
    shape[dim] = n_pad
    pad = torch.as_tensor(fill, dtype=a.dtype, device=a.device)
    return torch.cat([a, pad.expand(shape)], dim=dim)


def pad_gas_mechanism(gm, s_pad, r_pad, *, canonical=False):
    """Pad ``gm`` to ``s_pad`` species x ``r_pad`` reactions (module doc
    inertness contract), on ``gm``'s device.  ``s_pad``/``r_pad`` below the
    live counts raise; identity padding changes no tensor value."""
    S, R = gm.n_species, gm.n_reactions
    s_pad, r_pad = int(s_pad), int(r_pad)
    if s_pad < S or r_pad < R:
        raise ValueError(
            f"mechanism padding cannot shrink: live (S={S}, R={R}) vs "
            f"requested (S={s_pad}, R={r_pad})")
    ds, dr = s_pad - S, r_pad - R

    def row_col(a):
        """(R, S) -> (r_pad, s_pad), zero columns then zero rows."""
        return _cat(_cat(a, 0.0, ds, dim=1), 0.0, dr)

    def rows(a, fill):
        """(R, ...) -> (r_pad, ...) with constant ``fill`` rows."""
        return _cat(a, fill, dr)

    # dead efficiency columns must be zero: a live +M row's d(cM)/dc_dead
    # is eff[row, dead], and a nonzero entry would put mass in the
    # Jacobian's dead columns and break the identity block
    troe_inert = [0.6, 100.0, 1000.0, np.inf]
    sri_inert = [1.0, 0.0, np.inf, 1.0, 0.0]
    cheb_invT_inert = [1 / 300.0, 1 / 2500.0]
    cheb_logP_inert = [0.0, 1.0]
    return GasMechanism(
        nu_f=row_col(gm.nu_f),
        nu_r=row_col(gm.nu_r),
        log_A=rows(gm.log_A, _LOG_ZERO),
        beta=rows(gm.beta, 0.0),
        Ea=rows(gm.Ea, 0.0),
        eff=row_col(gm.eff),
        has_tb=rows(gm.has_tb, 0.0),
        has_falloff=rows(gm.has_falloff, 0.0),
        log_A0=rows(gm.log_A0, _LOG_ZERO),
        beta0=rows(gm.beta0, 0.0),
        Ea0=rows(gm.Ea0, 0.0),
        has_troe=rows(gm.has_troe, 0.0),
        troe=rows(gm.troe, troe_inert),
        has_sri=rows(gm.has_sri, 0.0),
        sri=rows(gm.sri, sri_inert),
        rev_mask=rows(gm.rev_mask, 0.0),
        sign_A=rows(gm.sign_A, 1.0),
        has_rev=rows(gm.has_rev, 0.0),
        log_A_rev=rows(gm.log_A_rev, _LOG_ZERO),
        beta_rev=rows(gm.beta_rev, 0.0),
        Ea_rev=rows(gm.Ea_rev, 0.0),
        sign_A_rev=rows(gm.sign_A_rev, 1.0),
        has_plog=rows(gm.has_plog, 0.0),
        plog_lnp=rows(gm.plog_lnp, np.inf),
        plog_logA=rows(gm.plog_logA, _LOG_ZERO),
        plog_beta=rows(gm.plog_beta, 0.0),
        plog_Ea=rows(gm.plog_Ea, 0.0),
        has_cheb=rows(gm.has_cheb, 0.0),
        cheb_coef=rows(gm.cheb_coef, 0.0),
        cheb_invT=rows(gm.cheb_invT, cheb_invT_inert),
        cheb_logP=rows(gm.cheb_logP, cheb_logP_inert),
        cheb_si_ln=rows(gm.cheb_si_ln, 0.0),
        species=_pad_species_names(gm.species, s_pad, canonical),
        equations=(_canonical_names("R", r_pad) if canonical
                   else tuple(gm.equations) + tuple(
                       f"_PAD_R{k}" for k in range(dr))),
        int_stoich=gm.int_stoich,
        any_plog=gm.any_plog,
        any_cheb=gm.any_cheb,
    )


def pad_thermo(thermo, s_pad, *, canonical=False):
    """Pad a :class:`~.thermo.ThermoTable` to ``s_pad`` species.  Dead
    species get the inert NASA-7 row ``a1 = 1, a2..a7 = 0`` in both ranges
    (``cp = R``, ``h = R T``, ``s = R ln T``), molwt 1.0 (so ``conc =
    rho_k / molwt`` is ``0/1``, never ``0/0``) and the 300/1000/5000 K
    range bounds.  ``a1 = 1`` rather than zeros: the energy equations sum
    ``c_k Cv_k`` and ``u_k wdot_k`` with ``Cv = Cp - R`` and ``u = h -
    RT``, which the inert row makes exactly 0 on the dead tail, so the
    adiabatic Jacobian's dead columns stay zero too."""
    S = thermo.n_species
    s_pad = int(s_pad)
    if s_pad < S:
        raise ValueError(
            f"thermo padding cannot shrink: live S={S} vs requested "
            f"{s_pad}")
    ds = s_pad - S
    coeffs_inert = np.zeros((2, 7))
    coeffs_inert[:, 0] = 1.0
    return ThermoTable(
        coeffs=_cat(thermo.coeffs, coeffs_inert, ds),
        T_low=_cat(thermo.T_low, 300.0, ds),
        T_mid=_cat(thermo.T_mid, 1000.0, ds),
        T_high=_cat(thermo.T_high, 5000.0, ds),
        molwt=_cat(thermo.molwt, 1.0, ds),
        species=_pad_species_names(thermo.species, s_pad, canonical),
        composition=(((),) * s_pad if canonical
                     else tuple(thermo.composition) + ((),) * ds),
    )


def pad_states(y, s_pad):
    """Pad state rows ``(..., S)`` to ``(..., s_pad)`` with zero mass, the
    dead species' initial condition."""
    S = y.shape[-1]
    if s_pad < S:
        raise ValueError(f"state padding cannot shrink: {S} -> {s_pad}")
    if s_pad == S:
        return y
    return torch.nn.functional.pad(y, (0, int(s_pad) - S))


def nlive_cfg(cfgs, n_live, n_lanes):
    """A copy of the per-lane ``cfgs`` with the reserved
    :data:`~..solver.common.NLIVE_KEY` operand set to the live component
    count, on the device of ``cfgs``' tensors."""
    dev = next((v.device for v in cfgs.values() if torch.is_tensor(v)),
               None)
    out = dict(cfgs)
    out[NLIVE_KEY] = torch.full((int(n_lanes),), float(n_live),
                                dtype=torch.float64, device=dev)
    return out


__all__ = ["NLIVE_KEY", "mech_shape_class", "nlive_cfg", "pad_gas_mechanism",
           "pad_states", "pad_thermo"]
