// Gas-phase molar production rates wdot (B, S) in one launch, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package evaluates
// batchreactor_tpu/ops/gas_kinetics.py::production_rates as XLA ops and
// leaves their fusion to XLA.  The port's plain version of the same function
// (ops/gas_kinetics.py::production_rates) runs as some 200 aten kernels a
// call, each of which reads and writes (B, R) float64 intermediates in
// device memory.  This kernel computes that function from T (B,) and the
// concentrations c (B, S) and writes only wdot, in float64 throughout:
//   - Arrhenius rate constants, third-body efficiencies, Lindemann, TROE and
//     SRI falloff (the falloff_compat convention too), negative-A rows
//     (sign_A), explicit REV reverse rates, and equilibrium reverse rates
//     from the NASA-7 Gibbs energies (p0 and the kc_compat shift come from
//     the wrapper);
//   - integer stoichiometry up to 3, as products of c, c*c and c*c*c;
//   - the _EXP_MAX clip of every rate exponent and the _TINY floors;
//   - the exp32 formulation where asked: exp(x/8) in float32, then three
//     float64 squarings.
// Every value that feeds an exponential is computed with the plain
// version's order of operations and with explicitly rounded operations
// (__dadd_rn, __dmul_rn, ...), which nvcc does not contract into FMAs, so
// an exponent differs from the plain version's only where the plain version
// sums through a matrix product (Delta G, the third-body sum).
//
// What bounds it: float64 transcendentals, not bytes.  A GRI-3.0 lane needs
// 325 Arrhenius and ~310 equilibrium exponentials, 29 falloff blends (each
// a low-pressure exponential, three TROE exponentials, two logs and one
// more exponential) and 53 NASA-7 Gibbs energies; its bytes are the
// state read and wdot written, 848 bytes a lane.
//
// Design, for that bound:
//   - One CTA of `block` threads takes a tile of `lanes` lanes.  It stages
//     the tile's concentrations and each lane's T, ln T, R T and ln c0 in
//     shared memory, then computes g_k/RT once per lane and species (the
//     NASA-7 polynomials) into shared memory.
//   - Thread t takes lane t % lanes and walks reaction slots t / lanes,
//     t / lanes + block / lanes, ...: the lanes of one reaction sit in
//     neighbouring threads, so a warp loads each reaction's parameters once
//     and runs one branch.  The slots follow a host-made order that groups
//     reactions by kind (elementary, third-body, Lindemann, TROE, SRI), so
//     a warp rarely diverges into a falloff blend.  Irreversible rows and
//     REV rows skip the equilibrium exponential; only falloff rows compute
//     the low-pressure one.
//   - q_j of each lane goes to shared memory, never to device memory.
//     After a barrier each (lane, species) pair sums dnu_jk q_j over the
//     species' own reactions (a CSR list made on the host, in reaction
//     order): a fixed order and no atomics, so two launches agree bit for
//     bit.
//   - The mechanism's parameters (ln A, beta, Ea, the falloff and REV
//     parameters, efficiencies, NASA-7 coefficients) are read from the
//     mechanism's own tensors at each launch; only the structure (species
//     lists per reaction, the species' reaction lists, the order) is packed
//     on the host, once per stoichiometry.  So a captured graph keeps
//     reading whatever parameters the mechanism's buffers hold.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr double kExpMax = 690.0;    // ops/gas_kinetics.py _EXP_MAX
constexpr double kTiny = 1e-300;     // _TINY
constexpr double kLog10 = 2.302585092994046;  // _LOG10

// operand slots; the wrapper's OPERANDS (ops/gas_rates_cuda.py) lists the
// same names in the same order
enum Operand {
  LOG_A, BETA, EA, HAS_TB, HAS_FALLOFF, LOG_A0, BETA0, EA0, HAS_TROE, TROE,
  HAS_SRI, SRI, REV_MASK, SIGN_A, HAS_REV, LOG_A_REV, BETA_REV, EA_REV,
  SIGN_A_REV, EFF, COEFFS, T_MID,
  // the packed structure: int32 lists, float64 values
  ORDER, F_IDX, F_PW, R_IDX, R_PW, D_IDX, D_VAL, DN, CSR_PTR, CSR_RXN,
  CSR_VAL, N_OPERANDS
};

struct Operands {
  const void* p[N_OPERANDS];
};

struct Shape {
  int batch, species, reactions;
  int kf, kr, kd;            // widths of the forward, reverse, dnu lists
  int lanes;                 // lanes of one CTA's tile
  long long t_stride, c_stride;
  double r_gas, p0, c0_shift;
  int falloff_compat, exp32;
};

template <class T>
__device__ __forceinline__ const T* op(const Operands& o, int i) {
  return static_cast<const T*>(o.p[i]);
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ double floor_at(double x, double lo) {
  return x < lo ? lo : x;
}

// torch.clamp(x, -_EXP_MAX, _EXP_MAX)
__device__ __forceinline__ double clip_exp(double x) {
  return x < -kExpMax ? -kExpMax : (x > kExpMax ? kExpMax : x);
}

// ops/gas_kinetics.py::_exp
__device__ __forceinline__ double rexp(double x, bool exp32) {
  if (exp32) {
    const double e = static_cast<double>(
        expf(__double2float_rn(__dmul_rn(x, 0.125))));
    const double e2 = __dmul_rn(e, e);
    const double e4 = __dmul_rn(e2, e2);
    return __dmul_rn(e4, e4);
  }
  return exp(x);
}

// clamp(ln A + beta ln T - Ea / (R T)), the plain version's order
__device__ __forceinline__ double arrhenius(double log_a, double beta,
                                            double ea, double lnT,
                                            double rt, bool exp32) {
  return rexp(clip_exp(__dsub_rn(__dadd_rn(log_a, __dmul_rn(beta, lnT)),
                                 __ddiv_rn(ea, rt))),
              exp32);
}

// g_k / (R T) = h/RT - s/R from the NASA-7 range that T selects
__device__ __forceinline__ double gibbs(const double* a, double T,
                                        double lnT) {
  const double T2 = __dmul_rn(T, T);
  const double T3 = __dmul_rn(T2, T);
  const double T4 = __dmul_rn(T3, T);
  double h = __dadd_rn(a[0], __dmul_rn(__ddiv_rn(a[1], 2.0), T));
  h = __dadd_rn(h, __dmul_rn(__ddiv_rn(a[2], 3.0), T2));
  h = __dadd_rn(h, __dmul_rn(__ddiv_rn(a[3], 4.0), T3));
  h = __dadd_rn(h, __dmul_rn(__ddiv_rn(a[4], 5.0), T4));
  h = __dadd_rn(h, __ddiv_rn(a[5], T));
  double s = __dadd_rn(__dmul_rn(a[0], lnT), __dmul_rn(a[1], T));
  s = __dadd_rn(s, __dmul_rn(__ddiv_rn(a[2], 2.0), T2));
  s = __dadd_rn(s, __dmul_rn(__ddiv_rn(a[3], 3.0), T3));
  s = __dadd_rn(s, __dmul_rn(__ddiv_rn(a[4], 4.0), T4));
  s = __dadd_rn(s, a[6]);
  return __dsub_rn(h, s);
}

// ops/gas_kinetics.py::_troe_F on a TROE row
__device__ __forceinline__ double troe_f(const double* tr, double T,
                                         double Pr, bool exp32) {
  const double a = tr[0], T3 = tr[1], T1 = tr[2], T2 = tr[3];
  const double fcent = __dadd_rn(
      __dadd_rn(__dmul_rn(__dsub_rn(1.0, a), rexp(__ddiv_rn(-T, T3), exp32)),
                __dmul_rn(a, rexp(__ddiv_rn(-T, T1), exp32))),
      rexp(__ddiv_rn(-T2, T), exp32));
  const double log_fc = __ddiv_rn(log(floor_at(fcent, kTiny)), kLog10);
  const double c = __dsub_rn(-0.4, __dmul_rn(0.67, log_fc));
  const double n = __dsub_rn(0.75, __dmul_rn(1.27, log_fc));
  const double log_pr = __ddiv_rn(log(floor_at(Pr, kTiny)), kLog10);
  const double lpc = __dadd_rn(log_pr, c);
  const double denom = __dsub_rn(n, __dmul_rn(0.14, lpc));
  const double f1 = __ddiv_rn(lpc, denom);
  const double one_f1 = __dadd_rn(1.0, __dmul_rn(f1, f1));
  return rexp(__ddiv_rn(__dmul_rn(kLog10, log_fc), one_f1), exp32);
}

// ops/gas_kinetics.py::_sri_F on an SRI row
__device__ __forceinline__ double sri_f(const double* sr, double T,
                                        double lnT, double Pr, bool exp32) {
  const double a = sr[0], b = sr[1], c = sr[2], d = sr[3], e = sr[4];
  const double lp = __ddiv_rn(log(floor_at(Pr, kTiny)), kLog10);
  const double X = __ddiv_rn(1.0, __dadd_rn(1.0, __dmul_rn(lp, lp)));
  const double base = floor_at(
      __dadd_rn(__dmul_rn(a, rexp(__ddiv_rn(-b, T), exp32)),
                rexp(__ddiv_rn(-T, c), exp32)),
      kTiny);
  return __dmul_rn(__dmul_rn(d, rexp(__dmul_rn(e, lnT), exp32)),
                   rexp(__dmul_rn(X, log(base)), exp32));
}

// prod_k c_k^nu_jk over one row's species list (powers 0..3)
__device__ __forceinline__ double stoich_prod(const int32_t* idx,
                                              const int32_t* pw, int k,
                                              const double* c) {
  double p = 1.0;
  for (int m = 0; m < k; ++m) {
    const int w = pw[m];
    if (w >= 1) {
      const double x = c[idx[m]];
      double f = x;
      if (w >= 2) f = f * x;
      if (w >= 3) f = f * x;
      p = p * f;
    }
  }
  return p;
}

// net rate of progress q_j of one lane
__device__ double rate_of_progress(const Operands& o, const Shape& sh,
                                   int j, const double* c, const double* g,
                                   double T, double lnT, double rt,
                                   double log_c0) {
  const bool x32 = sh.exp32 != 0;
  const int S = sh.species;
  const double k_inf = arrhenius(op<double>(o, LOG_A)[j],
                                 op<double>(o, BETA)[j], op<double>(o, EA)[j],
                                 lnT, rt, x32);
  const bool tb = op<double>(o, HAS_TB)[j] > 0.0;
  const bool fo = op<double>(o, HAS_FALLOFF)[j] > 0.0;
  double cM = 0.0;
  if (tb || fo) {
    const double* e = op<double>(o, EFF) + static_cast<long long>(j) * S;
    for (int k = 0; k < S; ++k) cM = fma(c[k], e[k], cM);
  }
  double kf = k_inf;
  if (fo) {
    const double k0 = arrhenius(op<double>(o, LOG_A0)[j],
                                op<double>(o, BETA0)[j],
                                op<double>(o, EA0)[j], lnT, rt, x32);
    const double ratio = __ddiv_rn(k0, floor_at(k_inf, kTiny));
    const double cM_pos = floor_at(cM, 0.0);
    const double Pr = __dmul_rn(ratio, cM_pos);
    const double L = __ddiv_rn(Pr, __dadd_rn(1.0, Pr));
    double Ft = 1.0, Fs = 1.0;
    if (op<double>(o, HAS_TROE)[j] > 0.0)
      Ft = troe_f(op<double>(o, TROE) + 4 * j, T, Pr, x32);
    if (op<double>(o, HAS_SRI)[j] > 0.0)
      Fs = sri_f(op<double>(o, SRI) + 5 * j, T, lnT, Pr, x32);
    const double fc = sh.falloff_compat ? cM_pos * 1e-6 : 1.0;
    kf = k_inf * L * (Ft * Fs) * fc;
  }
  kf = op<double>(o, SIGN_A)[j] * kf;
  double kr;
  if (op<double>(o, HAS_REV)[j] > 0.0) {
    kr = op<double>(o, SIGN_A_REV)[j] *
         arrhenius(op<double>(o, LOG_A_REV)[j], op<double>(o, BETA_REV)[j],
                   op<double>(o, EA_REV)[j], lnT, rt, x32);
  } else {
    const double rev = op<double>(o, REV_MASK)[j];
    kr = rev * kf;
    if (rev != 0.0) {
      // the exponential is positive and finite, so an irreversible row's
      // (0 kf) e^x is 0 kf without it
      const int32_t* di = op<int32_t>(o, D_IDX) + j * sh.kd;
      const double* dv = op<double>(o, D_VAL) + j * sh.kd;
      double dG = 0.0;
      for (int m = 0; m < sh.kd; ++m)
        dG = __dadd_rn(dG, __dmul_rn(g[di[m]], dv[m]));
      const double log_kc = __dadd_rn(-dG,
                                      __dmul_rn(op<double>(o, DN)[j], log_c0));
      kr = kr * rexp(clip_exp(-log_kc), x32);
    }
  }
  const double pf = stoich_prod(op<int32_t>(o, F_IDX) + j * sh.kf,
                                op<int32_t>(o, F_PW) + j * sh.kf, sh.kf, c);
  const double pr = stoich_prod(op<int32_t>(o, R_IDX) + j * sh.kr,
                                op<int32_t>(o, R_PW) + j * sh.kr, sh.kr, c);
  return (kf * pf - kr * pr) * (tb ? cM : 1.0);
}

__global__ void __launch_bounds__(256) gas_wdot_kernel(
    const double* __restrict__ Tin, const double* __restrict__ conc,
    double* __restrict__ wdot, Operands o, Shape sh) {
  extern __shared__ __align__(16) double gas_smem[];
  const int L = sh.lanes, S = sh.species, R = sh.reactions;
  double* c_s = gas_smem;                 // (L, S) concentrations
  double* g_s = c_s + L * S;              // (L, S) g_k / RT
  double* q_s = g_s + L * S;              // (R, L) rates of progress
  double* lane_s = q_s + static_cast<long long>(R) * L;  // T, lnT, RT, ln c0
  const int b0 = blockIdx.x * L;
  const int live = min(L, sh.batch - b0);
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int l = tid; l < L; l += nt) {
    // a lane past the batch computes on T = 1000 K and c = 0, unwritten
    const double T = l < live ? Tin[(b0 + l) * sh.t_stride] : 1000.0;
    const double rt = __dmul_rn(T, sh.r_gas);
    lane_s[l] = T;
    lane_s[L + l] = log(T);
    lane_s[2 * L + l] = rt;
    lane_s[3 * L + l] = __dadd_rn(log(__ddiv_rn(sh.p0, rt)), sh.c0_shift);
  }
  for (int i = tid; i < L * S; i += nt) {
    const int l = i / S, k = i - l * S;
    c_s[i] = l < live ? conc[(b0 + l) * sh.c_stride + k] : 0.0;
  }
  __syncthreads();

  const double* coeffs = op<double>(o, COEFFS);
  const double* t_mid = op<double>(o, T_MID);
  for (int i = tid; i < L * S; i += nt) {
    const int l = i / S, k = i - l * S;
    const double T = lane_s[l];
    const int hi = T > t_mid[k] ? 1 : 0;
    g_s[i] = gibbs(coeffs + 14 * k + 7 * hi, T, lane_s[L + l]);
  }
  __syncthreads();

  const int32_t* order = op<int32_t>(o, ORDER);
  const int l = tid % L;
  for (int s = tid / L; s < R; s += nt / L) {
    const int j = order[s];
    q_s[j * L + l] = rate_of_progress(o, sh, j, c_s + l * S, g_s + l * S,
                                      lane_s[l], lane_s[L + l],
                                      lane_s[2 * L + l], lane_s[3 * L + l]);
  }
  __syncthreads();

  const int32_t* ptr = op<int32_t>(o, CSR_PTR);
  const int32_t* rxn = op<int32_t>(o, CSR_RXN);
  const double* val = op<double>(o, CSR_VAL);
  for (int i = tid; i < L * S; i += nt) {
    const int lane = i % L, k = i / L;
    if (lane >= live) continue;
    double acc = 0.0;
    for (int e = ptr[k]; e < ptr[k + 1]; ++e)
      acc = fma(q_s[rxn[e] * L + lane], val[e], acc);
    wdot[static_cast<long long>(b0 + lane) * S + k] = acc;
  }
}

long long smem_bytes(int lanes, int species, int reactions) {
  return 8LL * lanes * (2LL * species + reactions + 4);
}

}  // namespace

// wdot (B, S) from T (B,) with lane stride t_stride (0 broadcasts one T)
// and conc (B, S) with row stride c_stride; operands: N_OPERANDS device
// pointers in the Operand order.  Returns a cudaError_t (0 on success).
extern "C" int gas_wdot(const double* T, long long t_stride,
                        const double* conc, long long c_stride, double* wdot,
                        int batch, int species, int reactions, int kf, int kr,
                        int kd, const void* const* operands, int n_operands,
                        double r_gas, double p0, double c0_shift,
                        int falloff_compat, int exp32, int lanes, int grid,
                        int block, int smem, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n_operands != N_OPERANDS || batch <= 0 || species <= 0 ||
      reactions <= 0 || kf <= 0 || kr <= 0 || kd <= 0 || lanes <= 0 ||
      block <= 0 || block > 256 || block % lanes != 0 ||
      smem != smem_bytes(lanes, species, reactions) ||
      static_cast<long long>(grid) * lanes < batch ||
      static_cast<long long>(grid - 1) * lanes >= batch) {
    return bad;
  }
  Operands o;
  for (int i = 0; i < N_OPERANDS; ++i) o.p[i] = operands[i];
  Shape sh{batch, species, reactions, kf, kr, kd, lanes, t_stride, c_stride,
           r_gas, p0, c0_shift, falloff_compat, exp32};
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gas_wdot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  gas_wdot_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      T, conc, wdot, o, sh);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gas_wdot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
