// br_native — native (C++) runtime for batchreactor_tpu.
//
// The reference's native compute lives in two wrapped C libraries: SUNDIALS
// CVODE (variable-order BDF, BatchReactor.jl src/BatchReactor.jl:138,210) and
// libxml2 (BatchReactor.jl Project.toml:10,14).  This file is the framework's
// own native runtime: a CHEMKIN-semantics gas-kinetics right-hand side and a
// CVODE-class variable-order (1..5) BDF integrator with modified Newton and
// dense partially-pivoted LU, compiled to a shared library and driven from
// Python via ctypes (batchreactor_tpu/native/).
//
// Roles:
//   * backend="cpu" execution path for single conditions (host latency;
//     no XLA compile cost),
//   * the self-measured single-CPU baseline for bench.py (BASELINE.md:
//     the reference publishes no numbers, so the baseline is a CVODE-class
//     BDF on the identical RHS at identical tolerances — this integrator),
//   * a solver-vs-solver oracle for the JAX SDIRK4 path in tests.
//
// Numerical semantics mirror batchreactor_tpu/ops/{thermo,gas_kinetics}.py
// exactly (same clamps, same ln-domain Arrhenius parameters, same kc_compat
// convention) so C++ and JAX RHS evaluations agree to rounding error.
//
// BDF formulation: variable-step, variable-order BDF in backward-difference
// form with quasi-constant step sizes (Shampine & Reichelt, "The MATLAB ODE
// Suite", SIAM J. Sci. Comput. 18(1), 1997 — the ode15s/CVODE family).
// kappa = 0 (pure BDF, as CVODE).  Jacobian by difference quotients, reused
// lazily across steps (CVODE's quasi-constant iteration-matrix economy).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kR = 8.314472;        // J/mol/K (utils/constants.py)
constexpr double kPAtm = 101325.0;     // Pa
constexpr double kExpMax = 690.0;      // ln(f64 max) guard (ops/gas_kinetics.py)
constexpr double kTiny = 1e-300;
constexpr double kLog10 = 2.302585092994046;

inline double clamp(double x, double lo, double hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

}  // namespace

extern "C" {

// Gas-phase mechanism tensor bundle — pointer view of the Python-side
// GasMechanism + ThermoTable arrays (models/gas.py, models/thermo.py).
// All matrices row-major.  Lifetimes owned by the caller.
struct BrGasMech {
  int64_t S;                 // species
  int64_t R;                 // reactions
  const double* nu_f;        // (R,S)
  const double* nu_r;        // (R,S)
  const double* log_A;       // (R,)  ln-domain SI pre-exponentials
  const double* beta;        // (R,)
  const double* Ea;          // (R,)  J/mol
  const double* eff;         // (R,S) third-body efficiencies
  const double* has_tb;      // (R,)
  const double* has_falloff; // (R,)
  const double* log_A0;      // (R,)
  const double* beta0;       // (R,)
  const double* Ea0;         // (R,)
  const double* has_troe;    // (R,)
  const double* troe;        // (R,4) a, T3, T1, T2
  const double* has_sri;     // (R,)
  const double* sri;         // (R,5) a, b, c, d, e
  const double* rev_mask;    // (R,)
  const double* sign_A;      // (R,) +-1; negative-A DUPLICATE rows
  const double* has_rev;     // (R,) 1.0 where explicit REV parameters
  const double* log_A_rev;   // (R,) ln|A_rev|, SI
  const double* beta_rev;    // (R,)
  const double* Ea_rev;      // (R,) J/mol
  const double* sign_A_rev;  // (R,) +-1
  int64_t plog_P;            // PLOG table width (padded); 0 disables
  const double* has_plog;    // (R,)
  const double* plog_lnp;    // (R,P) ln(p/Pa), +inf padded
  const double* plog_logA;   // (R,P) ln A (SI)
  const double* plog_beta;   // (R,P)
  const double* plog_Ea;     // (R,P) J/mol
  int64_t cheb_NT;           // Chebyshev table rows (0 disables)
  int64_t cheb_NP;           // Chebyshev table cols
  const double* has_cheb;    // (R,)
  const double* cheb_coef;   // (R,NT,NP)
  const double* cheb_invT;   // (R,2) 1/Tmin, 1/Tmax
  const double* cheb_logP;   // (R,2) log10(Pmin/Pa), log10(Pmax/Pa)
  const double* cheb_si_ln;  // (R,) ln cgs->SI factor
  const double* coeffs;      // (S,2,7) NASA-7 low/high ranges
  const double* T_mid;       // (S,)
  const double* molwt;       // (S,) kg/mol
  int32_t kc_compat;         // PARITY.md equilibrium-constant quirk
  int32_t int_stoich;        // integer stoichiometry fast path
};

// y = per-species mass density rho_k (kg/m^3); dy = d(rho_k)/dt.
// Mirrors ops/rhs.make_gas_rhs: conc = y/molwt; dy = wdot*molwt.
void br_gas_rhs(const BrGasMech* m, double T, const double* y, double* dy) {
  const int64_t S = m->S, R = m->R;
  std::vector<double> conc(S), g(S), wdot(S, 0.0);
  for (int64_t k = 0; k < S; ++k) conc[k] = y[k] / m->molwt[k];

  // NASA-7 Gibbs g_k/(RT) = h/(RT) - s/R (ops/thermo.py)
  const double T2 = T * T, T3 = T2 * T, T4 = T3 * T, logT = std::log(T);
  for (int64_t k = 0; k < S; ++k) {
    const double* a = m->coeffs + (k * 2 + (T > m->T_mid[k] ? 1 : 0)) * 7;
    const double h = a[0] + a[1] / 2 * T + a[2] / 3 * T2 + a[3] / 4 * T3 +
                     a[4] / 5 * T4 + a[5] / T;
    const double s = a[0] * logT + a[1] * T + a[2] / 2 * T2 + a[3] / 3 * T3 +
                     a[4] / 4 * T4 + a[6];
    g[k] = h - s;
  }

  const double rt = kR * T;
  const double log_c0_phys = std::log(kPAtm / rt);
  const double log_c0_ref = std::log(1e5 / rt);

  // loop-invariant PLOG/CHEB pressure (p = Ctot R T): hundreds of
  // pressure-dependent rows must not each rescan the species
  double lnp = 0.0;
  if (m->plog_P > 0 || m->cheb_NT > 0) {
    double Ctot = 0.0;
    for (int64_t k = 0; k < S; ++k) Ctot += conc[k] > 0 ? conc[k] : 0.0;
    if (Ctot < kTiny) Ctot = kTiny;
    lnp = std::log(Ctot * kR * T);
  }

  for (int64_t i = 0; i < R; ++i) {
    const double* nuf = m->nu_f + i * S;
    const double* nur = m->nu_r + i * S;
    const double* effi = m->eff + i * S;

    double kf = std::exp(
        clamp(m->log_A[i] + m->beta[i] * logT - m->Ea[i] / rt, -kExpMax, kExpMax));
    double cM = 0.0;
    for (int64_t k = 0; k < S; ++k) cM += effi[k] * conc[k];

    const bool falloff = m->has_falloff[i] > 0;
    if (falloff) {
      const double k0 = std::exp(clamp(
          m->log_A0[i] + m->beta0[i] * logT - m->Ea0[i] / rt, -kExpMax, kExpMax));
      const double Pr = k0 * (cM > 0 ? cM : 0.0) / (kf > kTiny ? kf : kTiny);
      double F = 1.0;
      if (m->has_troe[i] > 0) {
        const double* t = m->troe + i * 4;
        const double a = t[0];
        double Fcent = (1.0 - a) * std::exp(-T / t[1]) + a * std::exp(-T / t[2]);
        if (std::isfinite(t[3])) Fcent += std::exp(-t[3] / T);
        const double log_fc =
            std::log(Fcent > kTiny ? Fcent : kTiny) / kLog10;
        const double c = -0.4 - 0.67 * log_fc;
        const double n = 0.75 - 1.27 * log_fc;
        const double log_pr = std::log(Pr > kTiny ? Pr : kTiny) / kLog10;
        const double f1 = (log_pr + c) / (n - 0.14 * (log_pr + c));
        F = std::exp(kLog10 * log_fc / (1.0 + f1 * f1));
      }
      if (m->has_sri[i] > 0) {
        // SRI blending: F = d T^e [a exp(-b/T) + exp(-T/c)]^X,
        // X = 1/(1 + log10(Pr)^2)  (mirrors ops/gas_kinetics._sri_F)
        const double* s = m->sri + i * 5;
        const double lp = std::log(Pr > kTiny ? Pr : kTiny) / kLog10;
        const double X = 1.0 / (1.0 + lp * lp);
        double base = s[0] * std::exp(-s[1] / T);
        if (std::isfinite(s[2])) base += std::exp(-T / s[2]);
        else base += 1.0;
        if (base < kTiny) base = kTiny;
        F = s[3] * std::pow(T, s[4]) * std::exp(X * std::log(base));
      }
      kf = kf * (Pr / (1.0 + Pr)) * F;
      // reference-parity falloff (PARITY.md, resolved round 2): the blended
      // rate is additionally multiplied by the collider concentration in
      // mol/cm^3 — the reference treats (+M) like a plain +M third body in
      // its cgs rate space
      if (m->kc_compat) kf *= (cM > 0.0 ? cM : 0.0) * 1e-6;
    }
    const double tb = m->has_tb[i] > 0 ? cM : 1.0;

    // equilibrium: ln Kc = -dG/RT + dn ln c0 (ops/gas_kinetics.py, PARITY.md)
    double dG = 0.0, dn = 0.0;
    for (int64_t k = 0; k < S; ++k) {
      const double d = nur[k] - nuf[k];
      dG += d * g[k];
      dn += d;
    }
    kf *= m->sign_A[i];  // negative-A DUPLICATE rows (ln-domain stores |A|)

    if (m->plog_P > 0 && m->has_plog[i] > 0) {
      // PLOG: piecewise-linear ln k in ln p between per-pressure Arrhenius
      // fits, clamped at the table ends (mirrors ops/gas_kinetics._plog_interp)
      const int64_t P = m->plog_P;
      const double* pg = m->plog_lnp + i * P;
      int64_t idx = -1;
      for (int64_t j = 0; j < P; ++j) idx += pg[j] <= lnp ? 1 : 0;
      if (idx < 0) idx = 0;
      if (idx > P - 2 && P > 1) idx = P - 2;
      const int64_t j1 = P > 1 ? idx + 1 : idx;
      const double lo = pg[idx], hi = pg[j1];
      auto lnk_at = [&](int64_t j) {
        return m->plog_logA[i * P + j] + m->plog_beta[i * P + j] * logT -
               m->plog_Ea[i * P + j] / rt;
      };
      const double klo = lnk_at(idx), khi = lnk_at(j1);
      const double span = hi - lo;
      double w = (std::isfinite(span) && span > 0) ? (lnp - lo) / span : 0.0;
      w = w < 0 ? 0.0 : (w > 1 ? 1.0 : w);
      kf = std::exp(clamp(klo + w * (khi - klo), -kExpMax, kExpMax));
    }

    if (m->cheb_NT > 0 && m->has_cheb[i] > 0) {
      // Chebyshev tables (mirrors ops/gas_kinetics._cheb_eval): log10 k =
      // sum a_ij T_i(Ttil) T_j(Ptil), window-clamped
      const double iT_lo = m->cheb_invT[i * 2], iT_hi = m->cheb_invT[i * 2 + 1];
      const double p_lo = m->cheb_logP[i * 2], p_hi = m->cheb_logP[i * 2 + 1];
      double Ttil = (2.0 / T - iT_lo - iT_hi) / (iT_hi - iT_lo);
      double Ptil = (2.0 * lnp / kLog10 - p_lo - p_hi) / (p_hi - p_lo);
      Ttil = Ttil < -1 ? -1.0 : (Ttil > 1 ? 1.0 : Ttil);
      Ptil = Ptil < -1 ? -1.0 : (Ptil > 1 ? 1.0 : Ptil);
      const int64_t NT = m->cheb_NT, NP = m->cheb_NP;
      double Tb[16], Pb[16];  // parse caps table degrees well below this
      Tb[0] = 1.0; if (NT > 1) Tb[1] = Ttil;
      for (int64_t a = 2; a < NT; ++a) Tb[a] = 2.0 * Ttil * Tb[a-1] - Tb[a-2];
      Pb[0] = 1.0; if (NP > 1) Pb[1] = Ptil;
      for (int64_t a = 2; a < NP; ++a) Pb[a] = 2.0 * Ptil * Pb[a-1] - Pb[a-2];
      double log10k = 0.0;
      const double* c = m->cheb_coef + i * NT * NP;
      for (int64_t a = 0; a < NT; ++a)
        for (int64_t b = 0; b < NP; ++b) log10k += c[a * NP + b] * Tb[a] * Pb[b];
      kf = std::exp(clamp(log10k * kLog10 + m->cheb_si_ln[i],
                          -kExpMax, kExpMax));
    }

    const double log_c0 =
        m->kc_compat ? log_c0_ref + std::log(1e6) : log_c0_phys;
    const double log_Kc = -dG + dn * log_c0;
    // reverse: explicit REV Arrhenius where given, else kf/Kc
    const double kr =
        m->has_rev[i] > 0
            ? m->sign_A_rev[i] *
                  std::exp(clamp(m->log_A_rev[i] + m->beta_rev[i] * logT -
                                     m->Ea_rev[i] / rt,
                                 -kExpMax, kExpMax))
            : m->rev_mask[i] * kf * std::exp(clamp(-log_Kc, -kExpMax, kExpMax));

    // stoichiometric concentration products (ops/gas_kinetics._stoich_prod:
    // integer powers keep transient negative concentrations NaN-free)
    double pf = 1.0, pr = 1.0;
    if (m->int_stoich) {
      for (int64_t k = 0; k < S; ++k) {
        int nf = (int)(nuf[k] + 0.5), nr = (int)(nur[k] + 0.5);
        for (int j = 0; j < nf; ++j) pf *= conc[k];
        for (int j = 0; j < nr; ++j) pr *= conc[k];
      }
    } else {
      double sf = 0.0, sr = 0.0;
      for (int64_t k = 0; k < S; ++k) {
        const double lc = std::log(conc[k] > kTiny ? conc[k] : kTiny);
        sf += nuf[k] * lc;
        sr += nur[k] * lc;
      }
      pf = std::exp(sf);
      pr = std::exp(sr);
    }
    const double q = (kf * pf - kr * pr) * tb;
    for (int64_t k = 0; k < S; ++k) wdot[k] += (nur[k] - nuf[k]) * q;
  }
  for (int64_t k = 0; k < S; ++k) dy[k] = wdot[k] * m->molwt[k];
}

// ---------------------------------------------------------------------------
// Generic CVODE-class BDF integrator.
// ---------------------------------------------------------------------------

typedef void (*BrRhsFn)(const void* ctx, double t, const double* y, double* dy);

struct BrStats {
  double t;           // time reached
  int32_t status;     // 0 success, 2 max steps, 3 dt underflow
  int32_t pad;
  int64_t n_steps;    // accepted
  int64_t n_rejected; // rejected attempts (error test + Newton failures)
  int64_t n_rhs;
  int64_t n_jac;
  int64_t n_lu;
};

enum { BR_SUCCESS = 0, BR_MAX_STEPS = 2, BR_DT_UNDERFLOW = 3 };

namespace {

constexpr int kMaxOrder = 5;
constexpr int kNewtonMax = 4;

struct Dense {
  // column-major n x n with LAPACK-style pivots
  int n;
  std::vector<double> a;
  std::vector<int> piv;
  // returns false on exact singularity
  bool factor() {
    for (int k = 0; k < n; ++k) {
      int p = k;
      double best = std::fabs(a[k * n + k]);
      for (int i = k + 1; i < n; ++i) {
        const double v = std::fabs(a[k * n + i]);
        if (v > best) { best = v; p = i; }
      }
      piv[k] = p;
      if (best == 0.0) return false;
      if (p != k)
        for (int j = 0; j < n; ++j) std::swap(a[j * n + k], a[j * n + p]);
      const double d = a[k * n + k];
      for (int i = k + 1; i < n; ++i) a[k * n + i] /= d;
      for (int j = k + 1; j < n; ++j) {
        const double ajk = a[j * n + k];
        if (ajk == 0.0) continue;
        for (int i = k + 1; i < n; ++i) a[j * n + i] -= a[k * n + i] * ajk;
      }
    }
    return true;
  }
  void solve(double* b) const {
    for (int k = 0; k < n; ++k) std::swap(b[k], b[piv[k]]);
    for (int k = 0; k < n; ++k)
      for (int i = k + 1; i < n; ++i) b[i] -= a[k * n + i] * b[k];
    for (int k = n - 1; k >= 0; --k) {
      b[k] /= a[k * n + k];
      for (int i = 0; i < k; ++i) b[i] -= a[k * n + i] * b[k];
    }
  }
};

// RMS of e scaled by atol + rtol*|y| (same norm as solver/sdirk.py)
double scaled_norm(const std::vector<double>& e, const std::vector<double>& y,
                   double rtol, double atol) {
  double s = 0.0;
  for (size_t i = 0; i < e.size(); ++i) {
    const double sc = atol + rtol * std::fabs(y[i]);
    const double v = e[i] / sc;
    s += v * v;
  }
  return std::sqrt(s / e.size());
}

// Rescale backward differences for a step-size change by `factor` at the
// current order (Shampine & Reichelt eq. for the R matrix): D <- (R U)^T D.
void change_D(std::vector<std::vector<double>>& D, int order, double factor) {
  const int m = order + 1;
  std::vector<double> R(m * m, 0.0), U(m * m, 0.0);
  auto fill = [m, order](std::vector<double>& M, double fac) {
    std::vector<double> W(m * m, 0.0);
    for (int j = 0; j < m; ++j) W[0 * m + j] = 1.0;  // row 0 all ones
    for (int i = 1; i <= order; ++i)
      for (int j = 1; j <= order; ++j)
        W[i * m + j] = (i - 1 - fac * j) / i;
    // cumulative product down the rows
    for (int i = 1; i < m; ++i)
      for (int j = 0; j < m; ++j) W[i * m + j] *= W[(i - 1) * m + j];
    M = W;
  };
  fill(R, factor);
  fill(U, 1.0);
  std::vector<double> RU(m * m, 0.0);
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < m; ++j) {
      double s = 0.0;
      for (int k = 0; k < m; ++k) s += R[i * m + k] * U[k * m + j];
      RU[i * m + j] = s;
    }
  const int n = (int)D[0].size();
  std::vector<std::vector<double>> nD(m, std::vector<double>(n, 0.0));
  for (int i = 0; i < m; ++i)       // nD[i] = sum_j RU[j,i] * D[j]
    for (int j = 0; j < m; ++j) {
      const double w = RU[j * m + i];
      if (w == 0.0) continue;
      for (int k = 0; k < n; ++k) nD[i][k] += w * D[j][k];
    }
  for (int i = 0; i < m; ++i) D[i] = nD[i];
}

}  // namespace

// Integrate dy/dt = f(t, y) from t0 to t1 with variable-order BDF.
// ts_out/ys_out: optional accepted-step trajectory buffer of n_save rows
// (pass n_save = 0 to skip).  Returns status (also in stats).
int32_t br_bdf(BrRhsFn f, const void* ctx, int64_t n_, const double* y0,
               double t0, double t1, double rtol, double atol,
               int64_t max_steps, double first_step, double* y_out,
               double* ts_out, double* ys_out, int64_t n_save,
               int64_t* n_saved, BrStats* stats) {
  const int n = (int)n_;
  const double span = t1 - t0;
  std::vector<double> y(y0, y0 + n), fy(n), scale(n);
  BrStats st = {t0, BR_MAX_STEPS, 0, 0, 0, 0, 0, 0};
  int64_t saved = 0;

  auto rhs = [&](double t, const std::vector<double>& yy,
                 std::vector<double>& out) {
    f(ctx, t, yy.data(), out.data());
    ++st.n_rhs;
  };

  rhs(t0, y, fy);
  double h;
  if (first_step > 0) {
    h = first_step;
  } else {
    // same first-step heuristic as solver/sdirk.py:103-112
    const double d0 = scaled_norm(y, y, rtol, atol);
    const double d1 = scaled_norm(fy, y, rtol, atol);
    h = clamp(0.01 * d0 / (d1 > 1e-30 ? d1 : 1e-30), span * 1e-24, span);
  }

  // backward differences D[0..kMaxOrder+2]
  std::vector<std::vector<double>> D(kMaxOrder + 3,
                                     std::vector<double>(n, 0.0));
  D[0] = y;
  for (int k = 0; k < n; ++k) D[1][k] = h * fy[k];
  int order = 1;
  int n_equal_steps = 0;

  // BDF coefficients: gamma_j = sum_{i<=j} 1/i; alpha=gamma (kappa=0);
  // error const at order j is 1/(j+1).
  double gamma[kMaxOrder + 2];
  gamma[0] = 0.0;
  for (int j = 1; j <= kMaxOrder + 1; ++j) gamma[j] = gamma[j - 1] + 1.0 / j;
  auto err_const = [](int j) { return 1.0 / (j + 1); };

  // lazy Jacobian + iteration matrix
  std::vector<double> J(n * n, 0.0);
  Dense lu;
  lu.n = n;
  lu.a.resize(n * n);
  lu.piv.resize(n);
  bool jac_current = false, lu_current = false;
  double c_lu = 0.0;  // the c the current LU was built with

  auto num_jac = [&](double t, const std::vector<double>& yy,
                     const std::vector<double>& f0) {
    std::vector<double> yp = yy, fp(n);
    const double sq = std::sqrt(2.220446049250313e-16);
    for (int j = 0; j < n; ++j) {
      const double dy =
          sq * std::fmax(std::fabs(yy[j]), std::fmax(atol, 1e-14));
      yp[j] = yy[j] + dy;
      rhs(t, yp, fp);
      for (int i = 0; i < n; ++i) J[j * n + i] = (fp[i] - f0[i]) / dy;
      yp[j] = yy[j];
    }
    ++st.n_jac;
    jac_current = true;
    lu_current = false;
  };

  const double newton_tol =
      std::fmax(10 * 2.22e-16 / rtol, std::fmin(0.03, std::sqrt(rtol)));
  double t = t0;
  const double h_min = span * 1e-22;

  std::vector<double> y_pred(n), psi(n), d(n), res(n), ynew(n), tmp(n);

  while (st.n_steps < max_steps) {
    if (t >= t1 - span * 1e-14) {
      st.status = BR_SUCCESS;
      break;
    }
    if (h > t1 - t) {
      const double factor = (t1 - t) / h;
      change_D(D, order, factor);
      h = t1 - t;
      n_equal_steps = 0;
    }

    const double t_new = t + h;
    // predictor and psi from differences
    for (int i = 0; i < n; ++i) {
      double yp = 0.0, ps = 0.0;
      for (int j = 0; j <= order; ++j) yp += D[j][i];
      for (int j = 1; j <= order; ++j) ps += gamma[j] * D[j][i];
      y_pred[i] = yp;
      psi[i] = ps / gamma[order];  // alpha = gamma (kappa=0)
    }
    const double c = h / gamma[order];
    for (int i = 0; i < n; ++i) scale[i] = atol + rtol * std::fabs(y_pred[i]);

    // modified Newton on d: F(d) = c f(t_new, y_pred+d) - psi - d = 0
    bool converged = false;
    bool step_fail = false;
    for (int attempt = 0; attempt < 2 && !converged; ++attempt) {
      if (!lu_current || c != c_lu) {
        for (int j = 0; j < n; ++j)
          for (int i = 0; i < n; ++i)
            lu.a[j * n + i] = (i == j ? 1.0 : 0.0) - c * J[j * n + i];
        if (!lu.factor()) { step_fail = true; break; }
        ++st.n_lu;
        lu_current = true;
        c_lu = c;
      }
      std::fill(d.begin(), d.end(), 0.0);
      ynew = y_pred;
      double dw_old = -1.0;
      converged = false;
      for (int it = 0; it < kNewtonMax; ++it) {
        rhs(t_new, ynew, tmp);
        bool finite = true;
        for (int i = 0; i < n; ++i) {
          res[i] = c * tmp[i] - psi[i] - d[i];
          if (!std::isfinite(res[i])) finite = false;
        }
        if (!finite) break;
        lu.solve(res.data());
        double dw = 0.0;
        for (int i = 0; i < n; ++i) {
          const double v = res[i] / scale[i];
          dw += v * v;
        }
        dw = std::sqrt(dw / n);
        double rate = dw_old > 0 ? dw / dw_old : 0.0;
        if (dw_old > 0 && (rate >= 1.0 ||
                           std::pow(rate, kNewtonMax - it) / (1 - rate) * dw >
                               newton_tol))
          break;  // diverging or too slow
        for (int i = 0; i < n; ++i) {
          d[i] += res[i];
          ynew[i] = y_pred[i] + d[i];
        }
        if (dw == 0.0 ||
            (dw_old > 0 ? rate / (1 - rate) * dw < newton_tol
                        : dw < 0.1 * newton_tol)) {
          converged = true;
          break;
        }
        dw_old = dw;
      }
      if (!converged && !jac_current) {
        rhs(t_new, y_pred, tmp);
        num_jac(t_new, y_pred, tmp);
      } else if (!converged) {
        break;
      }
    }

    if (!converged || step_fail) {
      // halve the step; the Jacobian (freshly rebuilt by the retry above)
      // is kept — only the iteration matrix needs rebuilding at the new c
      ++st.n_rejected;
      const double factor = 0.5;
      change_D(D, order, factor);
      h *= factor;
      n_equal_steps = 0;
      lu_current = false;
      if (h < h_min) { st.status = BR_DT_UNDERFLOW; break; }
      continue;
    }

    // local error estimate: err = err_const(order) * d
    double err_norm = 0.0;
    for (int i = 0; i < n; ++i) {
      const double v = err_const(order) * d[i] / scale[i];
      err_norm += v * v;
    }
    err_norm = std::sqrt(err_norm / n);

    if (err_norm > 1.0) {
      ++st.n_rejected;
      const double factor = std::fmax(
          0.1, 0.9 * std::pow(err_norm, -1.0 / (order + 1)));
      change_D(D, order, factor);
      h *= factor;
      n_equal_steps = 0;
      if (h < h_min) { st.status = BR_DT_UNDERFLOW; break; }
      continue;
    }

    // accept
    ++st.n_steps;
    ++n_equal_steps;
    t = t_new;
    // update differences: D[order+2] = d - D[order+1]; D[order+1] = d;
    // D[j] += D[j+1] downward
    for (int i = 0; i < n; ++i) {
      D[order + 2][i] = d[i] - D[order + 1][i];
      D[order + 1][i] = d[i];
    }
    for (int j = order; j >= 0; --j)
      for (int i = 0; i < n; ++i) D[j][i] += D[j + 1][i];
    y = D[0];
    jac_current = false;  // J ages; rebuilt on next Newton failure

    if (n_save > 0 && saved < n_save) {
      ts_out[saved] = t;
      std::memcpy(ys_out + saved * n, y.data(), n * sizeof(double));
      ++saved;
    }

    if (n_equal_steps < order + 1) continue;  // let the history settle

    // order/step selection (Shampine & Reichelt): compare error estimates
    // at order-1, order, order+1 via scaled differences
    for (int i = 0; i < n; ++i) scale[i] = atol + rtol * std::fabs(y[i]);
    double e_m = 1e300, e_p = 1e300;
    if (order > 1) {
      double s = 0.0;
      for (int i = 0; i < n; ++i) {
        const double v = err_const(order - 1) * D[order][i] / scale[i];
        s += v * v;
      }
      e_m = std::sqrt(s / n);
    }
    if (order < kMaxOrder) {
      double s = 0.0;
      for (int i = 0; i < n; ++i) {
        const double v = err_const(order + 1) * D[order + 2][i] / scale[i];
        s += v * v;
      }
      e_p = std::sqrt(s / n);
    }
    const double f_m =
        order > 1 ? std::pow(std::fmax(e_m, 1e-16), -1.0 / order) : 0.0;
    const double f_0 = std::pow(std::fmax(err_norm, 1e-16), -1.0 / (order + 1));
    const double f_p = order < kMaxOrder
                           ? std::pow(std::fmax(e_p, 1e-16), -1.0 / (order + 2))
                           : 0.0;
    int delta = 0;
    double best = f_0;
    if (f_m > best) { best = f_m; delta = -1; }
    if (f_p > best) { best = f_p; delta = 1; }
    order += delta;
    double factor = std::fmin(10.0, 0.9 * best);
    if (factor < 0.2) factor = 0.2;
    change_D(D, order, factor);
    h *= factor;
    n_equal_steps = 0;
    lu_current = false;
  }

  st.t = t;
  std::memcpy(y_out, y.data(), n * sizeof(double));
  if (n_saved) *n_saved = saved;
  if (stats) *stats = st;
  return st.status;
}

// ---------------------------------------------------------------------------
// Surface (catalytic) chemistry — native mirror of ops/surface_kinetics.py
// and ops/rhs.make_surface_rhs (reference semantics:
// SurfaceReactions.calculate_molar_production_rates!,
// BatchReactor.jl src/BatchReactor.jl:344, conventions pinned in PARITY.md).
// ---------------------------------------------------------------------------

struct BrSurfMech {
  int64_t R;                  // reactions
  int64_t Sg;                 // gas species coupled to
  int64_t Ss;                 // surface species
  const double* nu_f_gas;     // (R,Sg)
  const double* nu_r_gas;     // (R,Sg)
  const double* nu_f_surf;    // (R,Ss)
  const double* nu_r_surf;    // (R,Ss)
  const double* expo_gas;     // (R,Sg) rate-law exponents
  const double* expo_surf;    // (R,Ss)
  const double* log_A;        // (R,) ln A, cgs
  const double* beta;         // (R,)
  const double* Ea;           // (R,) J/mol
  const double* cov_eps;      // (R,Ss) coverage-dependent Ea slopes, J/mol
  const double* stick;        // (R,) 1.0 for sticking rows
  const double* stick_s0;     // (R,)
  const double* stick_molwt;  // (R,) g/mol
  const double* mwc;          // (R,) Motz-Wise flag
  double site_density;        // Gamma, mol/cm^2
  const double* site_coordination;  // (Ss,) sigma
  const double* molwt_gas;    // (Sg,) kg/mol (gas state layout order)
  int32_t int_expo;           // all exponents in {0,1,2,3}
};

namespace {

constexpr double kRCgs = kR * 1e7;  // erg/(mol K)
constexpr double kPi = 3.141592653589793;

// prod_k base_k^expo_ik for one reaction row (ops/surface_kinetics._pow_prod)
inline double pow_prod_row(const double* base, const double* expo, int64_t n,
                           bool int_expo) {
  double p = 1.0;
  if (int_expo) {
    for (int64_t k = 0; k < n; ++k) {
      const int e = (int)(expo[k] + 0.5);
      for (int j = 0; j < e; ++j) p *= base[k];
    }
    return p;
  }
  double s = 0.0;
  for (int64_t k = 0; k < n; ++k)
    s += expo[k] * std::log(base[k] > kTiny ? base[k] : kTiny);
  return std::exp(s);
}

}  // namespace

// Surface molar production rates (SI, mol/m^2/s) from T [K], p [Pa], gas
// mole fractions x (Sg,), coverages theta (Ss,).  Mirrors
// ops/surface_kinetics.production_rates.
void br_surface_rates(const BrSurfMech* m, double T, double p,
                      const double* x, const double* theta,
                      double* sdot_gas, double* sdot_surf) {
  const int64_t R = m->R, Sg = m->Sg, Ss = m->Ss;
  std::vector<double> c_gas(Sg), c_surf(Ss);
  for (int64_t k = 0; k < Sg; ++k) c_gas[k] = x[k] * p / (kR * T) * 1e-6;
  for (int64_t k = 0; k < Ss; ++k)
    c_surf[k] = theta[k] * m->site_density / m->site_coordination[k];
  for (int64_t k = 0; k < Sg; ++k) sdot_gas[k] = 0.0;
  for (int64_t k = 0; k < Ss; ++k) sdot_surf[k] = 0.0;

  const double logT = std::log(T), rt = kR * T;
  for (int64_t i = 0; i < R; ++i) {
    double Ea_eff = m->Ea[i];
    const double* eps = m->cov_eps + i * Ss;
    for (int64_t k = 0; k < Ss; ++k) Ea_eff += eps[k] * theta[k];

    double k_rate;
    const bool is_stick = m->stick[i] > 0;
    if (is_stick) {
      // s_eff sqrt(RT/2 pi M) [cm/s]; coverages enter the rate directly
      // (no Gamma^m) — golden-trajectory convention (PARITY.md)
      double s_eff = m->stick_s0[i] *
          std::exp(clamp(m->beta[i] * logT - Ea_eff / rt, -kExpMax, kExpMax));
      if (m->mwc[i] > 0) s_eff = s_eff / (1.0 - s_eff / 2.0);
      k_rate = s_eff * std::sqrt(kRCgs * T / (2.0 * kPi * m->stick_molwt[i]));
    } else {
      k_rate = std::exp(clamp(m->log_A[i] + m->beta[i] * logT - Ea_eff / rt,
                              -kExpMax, kExpMax));
    }

    const double gas_part =
        pow_prod_row(c_gas.data(), m->expo_gas + i * Sg, Sg, m->int_expo);
    const double surf_part = pow_prod_row(
        is_stick ? theta : c_surf.data(), m->expo_surf + i * Ss, Ss,
        m->int_expo);
    const double q = k_rate * gas_part * surf_part;  // mol/cm^2/s

    const double* nfg = m->nu_f_gas + i * Sg;
    const double* nrg = m->nu_r_gas + i * Sg;
    const double* nfs = m->nu_f_surf + i * Ss;
    const double* nrs = m->nu_r_surf + i * Ss;
    for (int64_t k = 0; k < Sg; ++k) sdot_gas[k] += (nrg[k] - nfg[k]) * q;
    for (int64_t k = 0; k < Ss; ++k) sdot_surf[k] += (nrs[k] - nfs[k]) * q;
  }
  for (int64_t k = 0; k < Sg; ++k) sdot_gas[k] *= 1e4;   // -> mol/m^2/s
  for (int64_t k = 0; k < Ss; ++k) sdot_surf[k] *= 1e4;
}

// Full surface(+gas) reactor RHS over y = [rho_k (Sg), theta_k (Ss)].
// Mirrors ops/rhs.make_surface_rhs including the reference's Asv quirk
// (BatchReactor.jl src/BatchReactor.jl:345: the WHOLE surface source —
// coverage part included — scales by Asv when asv_quirk).
void br_surf_rhs(const BrSurfMech* m, const BrGasMech* gm, double T,
                 double Asv, int32_t asv_quirk, const double* y, double* dy) {
  const int64_t Sg = m->Sg, Ss = m->Ss;
  std::vector<double> x(Sg), sdot_gas(Sg), sdot_surf(Ss);
  double rho = 0.0;
  for (int64_t k = 0; k < Sg; ++k) rho += y[k];
  // mass fracs -> mole fracs; p = rho R T sum(Y_k/M_k)
  double inv_wbar = 0.0;
  for (int64_t k = 0; k < Sg; ++k) {
    x[k] = (y[k] / rho) / m->molwt_gas[k];
    inv_wbar += x[k];
  }
  const double p = rho * kR * T * inv_wbar;
  for (int64_t k = 0; k < Sg; ++k) x[k] /= inv_wbar;

  br_surface_rates(m, T, p, x.data(), y + Sg, sdot_gas.data(),
                   sdot_surf.data());

  for (int64_t k = 0; k < Sg; ++k)
    dy[k] = sdot_gas[k] * Asv * m->molwt_gas[k];
  if (gm) {
    std::vector<double> yg(Sg), dyg(Sg);
    // conc = x p/(RT) = rho_k/M_k: reuse the gas RHS on the mass densities
    for (int64_t k = 0; k < Sg; ++k) yg[k] = y[k];
    br_gas_rhs(gm, T, yg.data(), dyg.data());
    for (int64_t k = 0; k < Sg; ++k) dy[k] += dyg[k];
  }
  const double covg_scale = asv_quirk ? Asv : 1.0;
  for (int64_t k = 0; k < Ss; ++k)
    dy[Sg + k] = sdot_surf[k] * covg_scale * m->site_coordination[k] /
                 (m->site_density * 1e4);
}

// Convenience: BDF over the built-in gas RHS at fixed temperature T
// (isothermal reactor, BatchReactor.jl src/BatchReactor.jl:14-17).
struct GasCtx {
  const BrGasMech* m;
  double T;
};

static void gas_rhs_tramp(const void* ctx, double t, const double* y,
                          double* dy) {
  (void)t;
  const GasCtx* g = (const GasCtx*)ctx;
  br_gas_rhs(g->m, g->T, y, dy);
}

int32_t br_solve_gas_bdf(const BrGasMech* m, double T, const double* y0,
                         double t0, double t1, double rtol, double atol,
                         int64_t max_steps, double first_step, double* y_out,
                         double* ts_out, double* ys_out, int64_t n_save,
                         int64_t* n_saved, BrStats* stats) {
  GasCtx ctx = {m, T};
  return br_bdf(gas_rhs_tramp, &ctx, m->S, y0, t0, t1, rtol, atol, max_steps,
                first_step, y_out, ts_out, ys_out, n_save, n_saved, stats);
}

// Convenience: BDF over the surface(+gas) RHS (gm may be null: surf-only).
struct SurfCtx {
  const BrSurfMech* m;
  const BrGasMech* gm;
  double T;
  double Asv;
  int32_t asv_quirk;
};

static void surf_rhs_tramp(const void* ctx, double t, const double* y,
                           double* dy) {
  (void)t;
  const SurfCtx* s = (const SurfCtx*)ctx;
  br_surf_rhs(s->m, s->gm, s->T, s->Asv, s->asv_quirk, y, dy);
}

int32_t br_solve_surf_bdf(const BrSurfMech* m, const BrGasMech* gm, double T,
                          double Asv, int32_t asv_quirk, const double* y0,
                          double t0, double t1, double rtol, double atol,
                          int64_t max_steps, double first_step, double* y_out,
                          double* ts_out, double* ys_out, int64_t n_save,
                          int64_t* n_saved, BrStats* stats) {
  SurfCtx ctx = {m, gm, T, Asv, asv_quirk};
  return br_bdf(surf_rhs_tramp, &ctx, m->Sg + m->Ss, y0, t0, t1, rtol, atol,
                max_steps, first_step, y_out, ts_out, ys_out, n_save, n_saved,
                stats);
}

}  // extern "C"
