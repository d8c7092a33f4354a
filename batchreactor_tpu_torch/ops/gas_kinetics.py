"""Gas-phase molar production rates and their closed-form Jacobian.

Port of ``batchreactor_tpu/ops/gas_kinetics.py``.  The JAX forms take a
scalar T and an (S,) concentration vector under ``vmap``; these take
``T`` (B,) and ``conc`` (B, S) [mol/m^3] and return (B, R) rate constants,
(B, S) production rates and (B, S, S) Jacobians, all float64.  The clamps
keep forward and tangent values finite exactly as in the JAX package
(``torch.func.jacfwd`` goes through this code in the tests).

Rate law (CHEMKIN-II semantics):
  kf_i = A_i T^beta_i exp(-Ea_i / RT)
  third body: rate *= cM_i = sum_k eff_ik c_k
  falloff:   kf = k_inf * Pr/(1+Pr) * F,  Pr = k0 cM / k_inf,
             F = 1 (Lindemann), TROE, or SRI blending
  reverse:   kr = kf / Kc, Kc = exp(-sum_k dnu_ik g_k/RT) * (p_atm/RT)^dnu_i
  wdot_k = sum_i dnu_ik (ratef_i - rater_i),  dnu = nu_r - nu_f

``exp32`` is the JAX package's f32 rate-exponential formulation, here an
explicit option that is off by default on every device: the JAX package
turns it on for accelerators only because the TPU emulates float64, and the
H100 has native float64.  PLOG and Chebyshev rate tables recover the
reactor pressure from the state (p = Ctot R T), as in the JAX package.
"""

import math

import torch

from ..utils.constants import P_ATM, R
from .thermo import gibbs_over_RT

_LOG10 = 2.302585092994046

# clamps: keep exponentials/logs finite under forward-mode AD without
# changing physics (690 ~ ln(f64 max); physical rate constants in SI units
# never approach e^690, so the clip only engages on discarded branches)
_EXP_MAX = 690.0
_TINY = 1e-300


def _exp(x, exp32=False):
    """exp for rate expressions; ``exp32`` evaluates exp(x/8) in float32
    and squares three times in float64, which keeps the f32 argument
    inside +-86.25 over the whole +-690 clip window."""
    if exp32:
        e = torch.exp((x * 0.125).to(torch.float32)).to(torch.float64)
        e2 = e * e
        e4 = e2 * e2
        return e4 * e4
    return torch.exp(x)


# per stoichiometry tensor: (nu, idx (R, K), powers (R, K)) of the K
# species a row involves at most (_stoich_gather)
_STOICH_INDEX = {}


def _stoich_gather(nu):
    """The species each row of an integer stoichiometry ``nu`` (R, S)
    involves, in species order: (idx (R, K), powers (R, K)) with K the most
    any row involves, rows with fewer padded with power 0.  Computed once
    per tensor (one host sync) and kept beside it."""
    hit = _STOICH_INDEX.get(id(nu))
    if hit is not None and hit[0] is nu:
        return hit[1], hit[2]
    nz = nu != 0
    K = max(int(nz.sum(dim=1).max()), 1) if nu.numel() else 1
    idx = torch.argsort((~nz).to(torch.int8), dim=1, stable=True)[:, :K]
    pw = torch.gather(nu, 1, idx)
    if len(_STOICH_INDEX) >= 64:
        _STOICH_INDEX.pop(next(iter(_STOICH_INDEX)))
    _STOICH_INDEX[id(nu)] = (nu, idx, pw)
    return idx, pw


def _stoich_prod(conc, nu, int_stoich):
    """prod_k c_k^nu_ik for each reaction row, (B, R); fast path for
    integer nu <= 3 (integer powers of transient negative Newton iterates,
    no NaNs) over the K <= S species each row involves, gathered (B, R, K)
    rather than masked over all S (the factors that are 1 drop out
    exactly)."""
    if int_stoich:
        idx, pw = _stoich_gather(nu)
        c = conc[:, idx]                                   # (B, R, K)
        p = torch.where(pw >= 1, c, 1.0)
        p = torch.where(pw >= 2, p * c, p)
        p = torch.where(pw >= 3, p * c, p)
        return torch.prod(p, dim=2)
    safe_c = torch.where(conc > _TINY, conc, _TINY)[:, None, :]
    return torch.exp(torch.sum(nu * torch.log(safe_c), dim=2))


def _arrhenius(T, log_A, beta, Ea, exp32=False):
    """k = exp(ln A + beta ln T - Ea/RT) for T (B, 1) -> (B, R)."""
    logk = log_A + beta * torch.log(T) - Ea / (R * T)
    return _exp(torch.clamp(logk, -_EXP_MAX, _EXP_MAX), exp32)


def _troe_F(T, Pr, troe, has_troe, with_grad=False, exp32=False):
    """TROE falloff blending factor; 1 where not TROE, finite always.
    ``with_grad=True`` also returns dF/dPr (0 where not TROE)."""
    a, T3, T1, T2 = troe[:, 0], troe[:, 1], troe[:, 2], troe[:, 3]
    Fcent = ((1.0 - a) * _exp(-T / T3, exp32) + a * _exp(-T / T1, exp32)
             + _exp(-T2 / T, exp32))
    log_fc = torch.log(torch.clamp(Fcent, min=_TINY)) / _LOG10
    c = -0.4 - 0.67 * log_fc
    n = 0.75 - 1.27 * log_fc
    Pr_safe = torch.clamp(Pr, min=_TINY)
    log_pr = torch.log(Pr_safe) / _LOG10
    denom = n - 0.14 * (log_pr + c)
    f1 = (log_pr + c) / denom
    one_f1 = 1.0 + f1 * f1
    F_troe = _exp(_LOG10 * log_fc / one_f1, exp32)
    F = torch.where(has_troe > 0, F_troe, 1.0)
    if not with_grad:
        return F
    # dF/dPr = F ln10 (dlogF/dlp) (dlp/dPr);  dlp/dPr = 1/(ln10 Pr)
    df1_dlp = n / (denom * denom)
    dlogF_dlp = -log_fc * 2.0 * f1 * df1_dlp / (one_f1 * one_f1)
    dF_dPr = torch.where(has_troe > 0, F_troe * dlogF_dlp / Pr_safe, 0.0)
    return F, dF_dPr


def _sri_F(T, Pr, sri, has_sri, with_grad=False, exp32=False):
    """SRI falloff blending factor F = d T^e [a exp(-b/T) + exp(-T/c)]^X,
    X = 1/(1 + log10(Pr)^2); 1 where not SRI, finite always."""
    a, b, c = sri[:, 0], sri[:, 1], sri[:, 2]
    d, e = sri[:, 3], sri[:, 4]
    Pr_safe = torch.clamp(Pr, min=_TINY)
    lp = torch.log(Pr_safe) / _LOG10
    X = 1.0 / (1.0 + lp * lp)
    base = torch.clamp(a * _exp(-b / T, exp32) + _exp(-T / c, exp32),
                       min=_TINY)
    ln_base = torch.log(base)
    F_sri = d * _exp(e * torch.log(T), exp32) * _exp(X * ln_base, exp32)
    F = torch.where(has_sri > 0, F_sri, 1.0)
    if not with_grad:
        return F
    # dF/dPr = F ln(base) dX/dlp dlp/dPr;  dX/dlp = -2 lp X^2
    dF_dPr = torch.where(
        has_sri > 0,
        F_sri * ln_base * (-2.0 * lp * X * X) / (_LOG10 * Pr_safe), 0.0)
    return F, dF_dPr


def _blend_F(T, Pr, gm, with_grad=False, exp32=False):
    """Falloff blending F (TROE, SRI, or Lindemann F=1) with optional
    dF/dPr; TROE and SRI are mutually exclusive per reaction."""
    if not with_grad:
        return (_troe_F(T, Pr, gm.troe, gm.has_troe, exp32=exp32)
                * _sri_F(T, Pr, gm.sri, gm.has_sri, exp32=exp32))
    Ft, dFt = _troe_F(T, Pr, gm.troe, gm.has_troe, True, exp32)
    Fs, dFs = _sri_F(T, Pr, gm.sri, gm.has_sri, True, exp32)
    return Ft * Fs, dFt * Fs + Ft * dFs


def _ctot(conc):
    """Total concentration (B, 1), negatives clamped out as the falloff
    collider does for transient Newton iterates."""
    return torch.clamp(torch.sum(torch.clamp(conc, min=0.0), dim=1,
                                 keepdim=True), min=_TINY)


def _take(x, idx):
    """x (B, R, P) at per-(lane, reaction) index idx (B, R)."""
    return torch.gather(x, 2, idx[..., None])[..., 0]


def _plog_interp(T, conc, gm):
    """PLOG rate interpolation for T (B, 1): (ln k (B, R), dlnk/dlnp slope
    (B, R), Ctot (B, 1)).  ln k is piecewise linear in ln p between the
    per-pressure Arrhenius fits, clamped to the table ends; rows are +inf /
    ln 0 padded and the interval search never lands on a pad."""
    Ctot = _ctot(conc)
    lnp = torch.log(Ctot * R * T)                             # (B, 1)
    Tp = T[..., None]
    lnk_pts = (gm.plog_logA + gm.plog_beta * torch.log(Tp)
               - gm.plog_Ea / (R * Tp))                       # (B, R, P)
    grid = gm.plog_lnp.expand(conc.shape[0], -1, -1)          # (B, R, P)
    P = grid.shape[2]
    idx = torch.clamp(torch.sum(grid <= lnp[..., None], dim=2) - 1, 0,
                      max(P - 2, 0))
    idx_hi = idx + 1 if P > 1 else idx
    lo, hi = _take(grid, idx), _take(grid, idx_hi)
    klo, khi = _take(lnk_pts, idx), _take(lnk_pts, idx_hi)
    span = hi - lo
    ok = torch.isfinite(span) & (span > 0)
    safe_span = torch.where(span > 0, span, 1.0)
    w_raw = torch.where(ok, (lnp - lo) / safe_span, 0.0)
    w = torch.clamp(w_raw, 0.0, 1.0)
    lnk = klo + w * (khi - klo)
    # the slope is live only strictly inside the table (clamped regions
    # are pressure-independent — matches jacfwd through the clipped forward)
    inside = (w_raw > 0.0) & (w_raw < 1.0)
    slope = torch.where(inside & ok, (khi - klo) / safe_span, 0.0)
    return lnk, slope, Ctot


def _cheb_basis(x, n):
    out = [torch.ones_like(x), x]
    for _ in range(2, n):
        out.append(2.0 * x * out[-1] - out[-2])
    return torch.stack(out[:n], dim=-1)


def _cheb_eval(T, conc, gm):
    """Chebyshev rate tables for T (B, 1): (ln k (B, R), d ln k / d log10 p
    (B, R), Ctot (B, 1)).  log10 k = sum_ij a_ij T_i(Ttil) T_j(Ptil) over
    the scaled inverse temperature and log10 pressure, both clamped to
    [-1, 1]; the pressure derivative vanishes outside the window."""
    Ctot = _ctot(conc)
    log10p = torch.log(Ctot * R * T) / _LOG10                # (B, 1)
    iT_lo, iT_hi = gm.cheb_invT[:, 0], gm.cheb_invT[:, 1]
    p_lo, p_hi = gm.cheb_logP[:, 0], gm.cheb_logP[:, 1]
    Ttil = torch.clamp((2.0 / T - iT_lo - iT_hi) / (iT_hi - iT_lo), -1.0, 1.0)
    Ptil_raw = (2.0 * log10p - p_lo - p_hi) / (p_hi - p_lo)
    inside_p = (Ptil_raw > -1.0) & (Ptil_raw < 1.0)
    Ptil = torch.clamp(Ptil_raw, -1.0, 1.0)
    NT, NP = gm.cheb_coef.shape[1], gm.cheb_coef.shape[2]
    Tb = _cheb_basis(Ttil, max(NT, 2))[..., :NT]             # (B, R, NT)
    Pb = _cheb_basis(Ptil, max(NP, 2))[..., :NP]             # (B, R, NP)
    log10k = torch.einsum("rij,bri,brj->br", gm.cheb_coef, Tb, Pb)
    lnk = log10k * _LOG10 + gm.cheb_si_ln
    # dT_j/dx = j U_{j-1}(x) via the derivative recurrence
    dPb = [torch.zeros_like(Ptil), torch.ones_like(Ptil)]
    U_prev, U_cur = torch.ones_like(Ptil), 2.0 * Ptil        # U0, U1
    for j in range(2, NP):
        dPb.append(j * U_cur)                                # U_cur == U_{j-1}
        U_prev, U_cur = U_cur, 2.0 * Ptil * U_cur - U_prev
    dPb = torch.stack(dPb[:max(NP, 1)], dim=-1)[..., :NP]
    dlog10k_dPtil = torch.einsum("rij,bri,brj->br", gm.cheb_coef, Tb, dPb)
    dlnk_dlog10p = torch.where(
        inside_p, dlog10k_dPtil * _LOG10 * 2.0 / (p_hi - p_lo), 0.0)
    return lnk, dlnk_dlog10p, Ctot


def _tables_exp(lnk, exp32):
    return _exp(torch.clamp(lnk, -_EXP_MAX, _EXP_MAX), exp32)


def forward_rate_constants(T, conc, gm, with_grad=False,
                           falloff_compat=False, exp32=False):
    """Effective forward rate constants (B, R) with third-body/falloff.

    Returns (kf, tb_factor); with ``with_grad=True`` additionally
    (dkf/dcM, dtb/dcM, dkf/dCtot) for the analytic Jacobian (cM = eff @
    conc; dkf/dCtot is None for mechanisms without PLOG/CHEB tables).
    ``falloff_compat=True`` is the reference stack's falloff convention
    (the blended falloff rate times cM in mol/cm^3).
    """
    T = T[:, None]
    k_inf = _arrhenius(T, gm.log_A, gm.beta, gm.Ea, exp32)
    cM = conc @ gm.eff.T  # (B, R)
    k0 = _arrhenius(T, gm.log_A0, gm.beta0, gm.Ea0, exp32)
    ratio = k0 / torch.clamp(k_inf, min=_TINY)
    cM_pos = torch.clamp(cM, min=0.0)
    Pr = ratio * cM_pos
    L = Pr / (1.0 + Pr)
    tb_factor = torch.where(gm.has_tb > 0, cM, 1.0)
    fc = cM_pos * 1e-6 if falloff_compat else 1.0
    if not with_grad:
        F = _blend_F(T, Pr, gm, exp32=exp32)
        kf = gm.sign_A * torch.where(gm.has_falloff > 0, k_inf * L * F * fc,
                                     k_inf)
        if gm.any_plog:
            lnk, _, _ = _plog_interp(T, conc, gm)
            kf = torch.where(gm.has_plog > 0, _tables_exp(lnk, exp32), kf)
        if gm.any_cheb:
            lnk_c, _, _ = _cheb_eval(T, conc, gm)
            kf = torch.where(gm.has_cheb > 0, _tables_exp(lnk_c, exp32), kf)
        return kf, tb_factor
    F, dF_dPr = _blend_F(T, Pr, gm, with_grad=True, exp32=exp32)
    kf = gm.sign_A * torch.where(gm.has_falloff > 0, k_inf * L * F * fc,
                                 k_inf)
    dkf_dPr = k_inf * (F / ((1.0 + Pr) * (1.0 + Pr)) + L * dF_dPr)
    # the forward path clamps Pr (and fc) at cM=0, so the true derivative
    # is 0 for transiently negative Newton iterates
    live = (gm.has_falloff > 0) & (cM > 0.0)
    if falloff_compat:
        dkf_dcM = torch.where(
            live, (dkf_dPr * ratio * cM_pos + k_inf * L * F) * 1e-6, 0.0)
    else:
        dkf_dcM = torch.where(live, dkf_dPr * ratio, 0.0)
    dtb_dcM = (gm.has_tb > 0).to(kf.dtype)
    if not (gm.any_plog or gm.any_cheb):
        return kf, tb_factor, dkf_dcM, dtb_dcM, None
    # p = Ctot R T, so dkf/dc_k = kf (dlnk/dlnp) / Ctot on positive-c
    # entries (the caller applies the (conc > 0) indicator)
    dkf_dCtot = torch.zeros_like(kf)
    if gm.any_plog:
        lnk, slope, Ctot = _plog_interp(T, conc, gm)
        k_plog = _tables_exp(lnk, exp32)
        kf = torch.where(gm.has_plog > 0, k_plog, kf)
        dkf_dCtot = torch.where(gm.has_plog > 0, k_plog * slope / Ctot,
                                dkf_dCtot)
    if gm.any_cheb:
        lnk_c, dlnk_dlog10p, Ctot = _cheb_eval(T, conc, gm)
        k_cheb = _tables_exp(lnk_c, exp32)
        kf = torch.where(gm.has_cheb > 0, k_cheb, kf)
        dkf_dCtot = torch.where(gm.has_cheb > 0,
                                k_cheb * dlnk_dlog10p / (_LOG10 * Ctot),
                                dkf_dCtot)
    return kf, tb_factor, dkf_dcM, dtb_dcM, dkf_dCtot


def equilibrium_constants(T, gm, thermo, kc_compat=False):
    """ln of concentration-based equilibrium constants, ln Kc (B, R).

    ``kc_compat=True`` is the reference stack's convention (cgs standard
    concentration with p0 = 1 bar); the default is SI with p0 = 1 atm."""
    g = gibbs_over_RT(T, thermo)  # (B, S)
    dnu = gm.nu_r - gm.nu_f
    dG = g @ dnu.T  # (B, R) Delta G / RT
    dn = torch.sum(dnu, dim=1)
    if kc_compat:
        log_c0 = torch.log(1e5 / (R * T)) + math.log(1e6)
    else:
        log_c0 = torch.log(P_ATM / (R * T))
    return -dG + dn * log_c0[:, None]


def reverse_rate_constants(T, kf, gm, thermo, kc_compat=False, log_Kc=None,
                           exp32=False):
    """Reverse rate constants kr (B, R): kf/Kc for equilibrium-derived
    rows, explicit Arrhenius for ``REV``-parameterized rows."""
    if log_Kc is None:
        log_Kc = equilibrium_constants(T, gm, thermo, kc_compat)
    kr_eq = gm.rev_mask * kf * _exp(
        torch.clamp(-log_Kc, -_EXP_MAX, _EXP_MAX), exp32)
    kr_rev = gm.sign_A_rev * _arrhenius(T[:, None], gm.log_A_rev,
                                        gm.beta_rev, gm.Ea_rev, exp32)
    return torch.where(gm.has_rev > 0, kr_rev, kr_eq)


def reaction_rates(T, conc, gm, thermo, kc_compat=False, falloff_compat=None,
                   exp32=False):
    """Net rate of progress q (B, R) [mol/m^3/s].  ``falloff_compat=None``
    follows ``kc_compat`` (the two reference quirks travel together)."""
    if falloff_compat is None:
        falloff_compat = kc_compat
    kf, tb = forward_rate_constants(T, conc, gm,
                                    falloff_compat=falloff_compat,
                                    exp32=exp32)
    kr = reverse_rate_constants(T, kf, gm, thermo, kc_compat, exp32=exp32)
    rf = kf * _stoich_prod(conc, gm.nu_f, gm.int_stoich)
    rr = kr * _stoich_prod(conc, gm.nu_r, gm.int_stoich)
    return (rf - rr) * tb


def production_rates(T, conc, gm, thermo, kc_compat=False,
                     falloff_compat=None, exp32=False):
    """Species molar production rates wdot (B, S) [mol/m^3/s]."""
    q = reaction_rates(T, conc, gm, thermo, kc_compat, falloff_compat, exp32)
    return q @ (gm.nu_r - gm.nu_f)


def _stoich_prod_and_grad(conc, nu, int_stoich):
    """(P (B, R), dP (B, R, S)): P_j = prod_k c_k^nu_jk, dP_jk = dP_j/dc_k.

    The integer path is exact at c == 0: the exclusive product
    E_jk = prod_{m != k} f_jm is recovered without dividing by zero."""
    c = conc[:, None, :]
    if int_stoich:
        f = torch.where(nu >= 1, c, 1.0)
        f = torch.where(nu >= 2, f * c, f)
        f = torch.where(nu >= 3, f * c, f)
        d = (nu >= 1).to(conc.dtype).expand_as(f)
        d = torch.where(nu >= 2, 2.0 * c, d)
        d = torch.where(nu >= 3, 3.0 * c * c, d)
    else:
        safe_c = torch.where(conc > _TINY, conc, _TINY)[:, None, :]
        f = torch.exp(nu * torch.log(safe_c))
        # zero derivative where the forward path clamps (matches jacfwd)
        d = torch.where(c > _TINY, nu * f / safe_c, 0.0)
    iszero = f == 0.0
    f_safe = torch.where(iszero, 1.0, f)
    total_nz = torch.prod(f_safe, dim=2, keepdim=True)       # (B, R, 1)
    nzeros = torch.sum(iszero, dim=2, keepdim=True)          # (B, R, 1)
    total = torch.where(nzeros == 0, total_nz, 0.0)
    E = torch.where(
        iszero,
        torch.where(nzeros == 1, total_nz, 0.0),
        torch.where(nzeros == 0, total_nz / f_safe, 0.0),
    )
    return total[..., 0], d * E


def production_rates_and_jac(T, conc, gm, thermo, kc_compat=False,
                             falloff_compat=None, exp32=False):
    """(wdot (B, S), dwdot/dconc (B, S, S)) — analytic, closed form.

      q_j = tb_j * kf_j * (Pf_j - rev_j e^{-lnKc_j} Prp_j)
      dq/dc_k picks up the stoichiometric-product derivatives, the
      third-body factor (dtb/dc_k = eff_jk) and the falloff dependence
      kf(Pr), Pr = (k0/kinf) cM, including the TROE/SRI term dF/dPr.
    """
    if falloff_compat is None:
        falloff_compat = kc_compat
    kf, tb, dkf_dcM, dtb_dcM, dkf_dCtot = forward_rate_constants(
        T, conc, gm, with_grad=True, falloff_compat=falloff_compat,
        exp32=exp32)
    log_Kc = equilibrium_constants(T, gm, thermo, kc_compat)
    kr = reverse_rate_constants(T, kf, gm, thermo, kc_compat, log_Kc=log_Kc,
                                exp32=exp32)
    # equilibrium-derived rows: kr = (rev_mask e^{-lnKc}) kf scales with kf;
    # explicit-REV rows have no cM dependence
    rKc = gm.rev_mask * _exp(torch.clamp(-log_Kc, -_EXP_MAX, _EXP_MAX), exp32)
    dkr_dcM = torch.where(gm.has_rev > 0, 0.0, rKc * dkf_dcM)

    Pf, dPf = _stoich_prod_and_grad(conc, gm.nu_f, gm.int_stoich)
    Prp, dPrp = _stoich_prod_and_grad(conc, gm.nu_r, gm.int_stoich)

    net = kf * Pf - kr * Prp                                  # (B, R)
    q = tb * net
    dq = tb[..., None] * (kf[..., None] * dPf - kr[..., None] * dPrp) + (
        dtb_dcM * net + tb * (dkf_dcM * Pf - dkr_dcM * Prp))[..., None] * gm.eff
    if dkf_dCtot is not None:
        # pressure chain: dCtot/dc_k = 1 on positive entries; kr = rKc kf
        ind = (conc > 0.0).to(kf.dtype)
        dq = dq + (tb * dkf_dCtot * (Pf - rKc * Prp))[..., None] \
            * ind[:, None, :]

    dnu = gm.nu_r - gm.nu_f
    return q @ dnu, torch.matmul(dnu.T, dq)
