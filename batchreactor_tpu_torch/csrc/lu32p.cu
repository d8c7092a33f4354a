// Batched float32 LU with partial pivoting for Hopper (sm_90a).
//
// Replaces batchreactor_tpu/solver/linalg_pallas.py::_lu_kernel, the JAX
// package's Pallas kernel behind linsolve="lu32p".  It computes what that
// kernel computes, not its TPU blocking: for each lane matrix M (n x n,
// float64 in device memory) the LAPACK-style factorization
// P A = L U of A = [[M, 0], [0, I]] padded with an identity block to npad
// (a multiple of 8), in float32, with
//   - the pivot of column k chosen as the row with the largest |a_ik| among
//     the rows at positions >= k, the first in the current row order on a
//     tie (jnp.argmax / torch.argmax order; a NaN wins like it does there),
//   - full-row exchanges recorded as 0-based ipiv,
//   - a pivot p with |p| > 0 false (zero or NaN) replaced by 1.0 for the
//     division (the singular guard of solver/linalg.py::lu_factor: the
//     factor stays finite, the solve goes non-finite),
//   - unit-lower L stored below the diagonal, U on and above it.
// Partial pivoting with full-row exchanges gives the same (LU, ipiv) as the
// blocked, delayed-laswp form of the TPU kernel, up to rounding.  Every
// element update is one fmaf(-l_ik, u_kj, a_ij) with l_ik = a_ik / pivot
// (IEEE division, no TF32).
//
// Three kernels, chosen by npad alone (the wrapper's launch_config):
//
// npad <= 64: lu32p_warp_kernel<NPAD>, one warp per lane matrix, the factor
// in registers, no block barrier: the warps of a CTA only share its shared
// memory, and a warp synchronises with __syncwarp alone.
//   - Rows never move.  Lane r holds rows r and r + 32 in registers, each
//     with its current position; a step exchanges two positions.  NPAD and
//     the column within a group of four are template parameters, so every
//     register index is a compile-time constant, while the loop over groups
//     of four columns stays rolled: a fully unrolled factorization runs out
//     of the instruction cache at NPAD 56 and 64.  The
//     registers hold a window of the row: index j is column k0 + j, and
//     after each four columns the window shifts left by four and the four
//     retired (final) columns go to the row's line in a shared-memory tile.
//   - Pivot search: each row at a position >= k turns |a_rk| into a 32-bit
//     key that orders as the value (NaN canonicalised above +inf); one
//     __reduce_max_sync finds the largest key and one __reduce_min_sync the
//     smallest position holding it, the first maximum in the current order.
//     The search for column k + 1 starts as soon as column k + 1 is updated,
//     so the reductions overlap the rest of the rank-1 update, and the owner
//     of the next pivot row publishes each 16-byte group of it to a per-warp
//     buffer (double-buffered by column) as soon as that group is updated.
//   - A row is final when it becomes the pivot row: the warp stores it as
//     row k of LU straight away (retired columns from the tile, the rest
//     from the published buffer), so no store phase follows the loop.
//   - Once 32 rows remain (column npad - 32) the rows already pivoted are
//     dropped and the remaining rows move to one per lane through shared
//     memory; the window narrows with the live columns: full width, then
//     narrower, then 32 and 16 columns, so fewer FMAs are spent on columns
//     past the matrix and on rows already eliminated.
//   - The n*n float64 slab is read with coalesced 16-byte loads into the tile
//     (cast to float32; a misaligned first and last element of an odd n load
//     alone), and each lane copies its rows into registers, writing the
//     identity pad on the way.
//
// npad 72..240: one CTA per lane matrix with the npad x npad tile in
// dynamic shared memory, factored as the Pallas kernel factors it: a
// right-looking blocked getrf with 8-wide panels, two kernels by npad.
//   - npad 72..128, lu32p_cta_kernel<R> (128 threads): warp 0 factors each
//     panel with the panel's rows in its registers (lane l holds rows
//     ps + l + 32 s, R = 3 or 4, each with its position) and no block
//     barrier; the pivot search is the warp kernel's (pivot_key,
//     __reduce_max_sync, __reduce_min_sync), so ties and NaN order as there.
//     Look-ahead: warp 0 first updates its next panel's 8 columns itself,
//     while the other three warps update the columns right of it, so a
//     panel costs two block barriers (18 at npad 72, where the first port of
//     this path ran five per column).  At npad 72..96 the kernel is held to
//     64 registers, so 8 CTAs fit an SM and B = 1024 runs in one wave.
//   - npad 136..240, lu32p_cta_wide_kernel (256 threads): one CTA fills an
//     SM's shared memory (two at npad 136..152), so nothing hides one warp's
//     serial panel; each thread holds one panel row instead, and a column
//     step is one block barrier: each warp's first largest key and its row
//     go to a per-warp slot, every thread picks the winner after the
//     barrier, then takes its multiplier and rank-1 update.  Ten block
//     barriers per panel; the update runs on every warp after the panel.
//   - Both: the panel's 8 exchanges on the other columns (the delayed
//     laswp) are applied as net row moves, which 16 lanes derive from the 8
//     pivots: one thread per column loads every moved entry, then stores
//     them, and right of the panel solves the unit-lower 8 x 8 system for
//     the U12 strip in registers between the two.  The rank-8 trailing
//     update A22 -= L21 U12 gives each thread 4 x 4 tiles, the tile row's
//     multipliers in registers (16 shared-memory accesses per 128 FMAs).
//   - Rows ps .. ps + 7 are final once their panel's U12 is solved (later
//     exchanges involve only rows below): they are stored to LU with 16-byte
//     stores while the next panel runs.  The float64 slab is read with
//     coalesced 16-byte loads, cast on the way, beside the identity pad.
//   - R and the thread count are template parameters, npad is not: no loop
//     index needs a runtime division.
//   - Every update is an IEEE float32 fmaf on the CUDA cores.  No TF32: its
//     ten mantissa bits would break |PA - LU| <= 64 n eps32 |L||U|.  Whether
//     a 3xTF32 mma.sync trailing update keeps that bound, and pays, is a
//     later question.
//   The order of operations is tools/lu32p_coverages.py::blocked_lu32's,
//   which reproduces both kernels' factors bit for bit.
//
// What bounds them on an H100: per lane the function must read n*n*8 bytes
// of float64 and write npad*npad*4 of LU (plus the pivots), against
// 2/3 npad^3 flops.  At (B, n) = (1024, 53) that is 36 MB, 11 us at
// 3.35 TB/s, against 0.12 GFLOP, 1.8 us at 67 TFLOP/s (fp32): bytes.  The
// CTA path is bytes-bound too: 0.0171, 0.0530 and 0.2116 ms of bytes against
// 0.0038, 0.0177 and 0.1409 ms of flops at (1024, 66), (1024, 120) and
// (1024, 240).
//   - The warp kernel moves each of those bytes once, but it is
//     latency-bound: each warp runs npad dependent column steps (two warp
//     reductions, a shared-memory round trip for the pivot row, IEEE
//     divisions, then the FMAs), and B = 1024 gives 7.75 warps per SM, two
//     per scheduler, to hide that.  The load phase (all warps read at once)
//     does not overlap the factorization.
//   - The CTA kernels also move each byte once and overlap their stores
//     with the factorization, but the panels' column steps are a serial
//     chain.  tools/lu32p_trace.py (clock64() marks in CTA 0) shows, at
//     npad 72, ~24% of the cycles loading (a wave of CTAs reads before any
//     factors) and ~57% in warp 0's panel passes, whose column steps
//     compete for issue with the SM's other 31 warps; at npad 240, ~52% in
//     the wide kernel's column steps and exchanges (PERF.md).
//
// Built by batchreactor_tpu_torch/solver/linalg_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
//        -cudart shared
// and called through ctypes: the wrapper allocates LU and piv, computes the
// launch configuration, launches on PyTorch's current stream, and raises on
// a non-zero return code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// npad <= 64: one warp per lane matrix
// ---------------------------------------------------------------------------

constexpr int kWarpNpadMax = 64;
constexpr int kMaxWarpsPerCta = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLoadDepth = 8;  // 16-byte loads in flight per lane

// Orders as |v|, with every NaN equal and above +inf; 0 is left for rows
// that are not candidates.
__device__ __forceinline__ unsigned pivot_key(float v) {
  unsigned bits = __float_as_uint(fabsf(v));
  bits = bits > 0x7f800000u ? 0x7f800001u : bits;
  return bits + 1u;
}

// a / b rounded to nearest (IEEE division) for b neither zero nor NaN.  A
// zero a, common in the sparse Newton matrices, takes the exact signed zero
// instead: the division's range check would send it to the slow path.
__device__ __forceinline__ float div_rn(float a, float b) {
  if (a == 0.0f) {
    return __int_as_float((__float_as_int(a) ^ __float_as_int(b)) &
                          static_cast<int>(0x80000000u));
  }
  return a / b;
}

// The rows one lane holds: R rows of a window of the matrix's columns (index
// j holds column k0 + j at the step of column k0), each with its current
// position (-1: no row) and the tile row that keeps its retired columns.
template <int R, int NPAD>
struct Rows {
  float a[R][NPAD];
  int pos[R];
  int rid[R];
};

// Pivot search of window column C (global column k), first half: every
// candidate row's key (0 for rows already eliminated) and the warp's
// largest key.
template <int C, int R, int NPAD>
__device__ __forceinline__ unsigned pivot_max(const Rows<R, NPAD>& x, int k,
                                              unsigned (&key)[R]) {
  unsigned best = 0u;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    key[s] = x.pos[s] >= k ? pivot_key(x.a[s][C]) : 0u;
    best = key[s] > best ? key[s] : best;
  }
  return __reduce_max_sync(kFull, best);
}

// Second half: the smallest position holding the largest key, which is the
// first maximum in the current row order, packed as position * 256 + tile
// row.
template <int R, int NPAD>
__device__ __forceinline__ int pivot_pos(const Rows<R, NPAD>& x,
                                         const unsigned (&key)[R],
                                         unsigned best) {
  unsigned first = 0xffffffffu;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const unsigned packed = static_cast<unsigned>(x.pos[s] * 256 + x.rid[s]);
    if (key[s] == best && packed < first) first = packed;
  }
  return static_cast<int>(__reduce_min_sync(kFull, first));
}

// Column k = k0 + I of the factorization, at window index I; only the first
// W window indices are computed (the columns beyond the matrix are zeros).
// pr packs the pivot position p of column k and its tile row (pivot_pos);
// the previous step has published that row's columns k0.. in the pivot-row
// buffer of this step, and its columns before k0 are in its tile row.  The
// row is final: the warp stores it as row p of LU.  The step returns the
// packed pivot of column k + 1 and publishes that row in the other buffer:
// the search starts as soon as column k + 1 is updated, so its two warp
// reductions overlap the rest of the rank-1 update, and the new pivot row's
// owner stores each 16-byte group of it as soon as it is updated.
template <int I, int W, int R, int NPAD>
__device__ __forceinline__ int column_step(Rows<R, NPAD>& x, int& pv0,
                                           int& pv1, float* pbuf,
                                           const float* tile, float* LUb,
                                           int lane, int k0, int pr) {
  constexpr int LD = NPAD + 4;
  constexpr bool kNext = I + 1 < W;  // column k + 1 is in the window
  constexpr int QN = (I + 1) & ~3;   // its 16-byte group ...
  constexpr int QM = QN + 4 * ((W - QN) / 8);  // ... and halfway past it
  constexpr int S = I == 3 ? 4 : 0;  // window shift before column k + 1
  const int k = k0 + I;
  const int p = pr >> 8;
  const float* prow = pbuf + (I & 1) * NPAD;  // double-buffered by column
  float* pnext = pbuf + ((I + 1) & 1) * NPAD;

  if (lane == (k & 31)) {
    if (k < 32) pv0 = p; else pv1 = p;
  }
#pragma unroll
  for (int s = 0; s < R; ++s) {
    x.pos[s] = x.pos[s] == p ? k : (x.pos[s] == k ? p : x.pos[s]);
  }
  __syncwarp();  // the pivot row is visible to every lane

  const float pivot = prow[I];
  {
    // the pivot row is final: row k of LU, columns lane and lane + 32
    const float* lrow = tile + (pr & 255) * LD;
    float* urow = LUb + k * NPAD;
#pragma unroll
    for (int c = lane; c < NPAD; c += 32) {
      urow[c] = c < k0 ? lrow[c] : prow[c - k0];
    }
  }

  // multipliers and the rank-1 update of the rows below
  const float safe = fabsf(pivot) > 0.0f ? pivot : 1.0f;
  bool below[R];
  float l[R];
#pragma unroll
  for (int s = 0; s < R; ++s) {
    below[s] = x.pos[s] > k;
    l[s] = div_rn(x.a[s][I], safe);
    if (below[s]) x.a[s][I] = l[s];
  }
  unsigned key[R];
  unsigned best = 0u;
  int next = 0;
  bool own[R];
#pragma unroll
  for (int q = I & ~3; q < W; q += 4) {
    const float4 t = *reinterpret_cast<const float4*>(prow + q);
    const float u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (q + c > I) {
#pragma unroll
        for (int s = 0; s < R; ++s) {
          if (below[s]) x.a[s][q + c] = fmaf(-l[s], u[c], x.a[s][q + c]);
        }
      }
    }
    if constexpr (kNext) {
      if (q == QN) best = pivot_max<I + 1, R, NPAD>(x, k + 1, key);
      if (q >= QM) {
        if (q == QM) {
          next = pivot_pos<R, NPAD>(x, key, best);
#pragma unroll
          for (int s = 0; s < R; ++s) own[s] = x.pos[s] == next >> 8;
        }
        // publish the groups of the next pivot row updated so far
#pragma unroll
        for (int g = (q == QM ? QN : q); g <= q; g += 4) {
          if (g >= S) {
#pragma unroll
            for (int s = 0; s < R; ++s) {
              if (own[s]) {
                *reinterpret_cast<float4*>(pnext + g - S) =
                    make_float4(x.a[s][g], x.a[s][g + 1], x.a[s][g + 2],
                                x.a[s][g + 3]);
              }
            }
          }
        }
      }
    }
  }
  return next;
}

// Columns 4t .. 4t + 3 for t in [t0, t1), window width W; after each four,
// the retired columns go to the tile rows and the window shifts by four.
template <int W, int R, int NPAD>
__device__ __forceinline__ int run_quads(Rows<R, NPAD>& x, int& pv0, int& pv1,
                                         float* pbuf, float* tile, float* LUb,
                                         int lane, int t0, int t1, int pr) {
  constexpr int LD = NPAD + 4;
#pragma unroll 1
  for (int t = t0; t < t1; ++t) {
    const int k0 = 4 * t;
    pr = column_step<0, W, R, NPAD>(x, pv0, pv1, pbuf, tile, LUb, lane, k0, pr);
    pr = column_step<1, W, R, NPAD>(x, pv0, pv1, pbuf, tile, LUb, lane, k0, pr);
    pr = column_step<2, W, R, NPAD>(x, pv0, pv1, pbuf, tile, LUb, lane, k0, pr);
    pr = column_step<3, W, R, NPAD>(x, pv0, pv1, pbuf, tile, LUb, lane, k0, pr);
#pragma unroll
    for (int s = 0; s < R; ++s) {
      if (x.pos[s] >= 0) {
        *reinterpret_cast<float4*>(tile + x.rid[s] * LD + k0) =
            make_float4(x.a[s][0], x.a[s][1], x.a[s][2], x.a[s][3]);
      }
#pragma unroll
      for (int j = 0; j < W; ++j) x.a[s][j] = j + 4 < W ? x.a[s][j + 4] : 0.0f;
    }
  }
  return pr;
}

// From the column where 32 or fewer rows remain: one row per lane, the
// window narrowed to 32 columns and then to 16.
template <int NPAD>
__device__ __forceinline__ void one_row_phases(Rows<1, NPAD>& y, int& pv0,
                                               int& pv1, float* pbuf,
                                               float* tile, float* LUb,
                                               int lane, int pr) {
  constexpr int WB = NPAD < 32 ? NPAD : 32;
  constexpr int WC = WB > 16 ? 16 : WB;
  pr = run_quads<WB, 1, NPAD>(y, pv0, pv1, pbuf, tile, LUb, lane,
                              (NPAD - WB) / 4, (NPAD - WC) / 4, pr);
  run_quads<WC, 1, NPAD>(y, pv0, pv1, pbuf, tile, LUb, lane, (NPAD - WC) / 4,
                         NPAD / 4, pr);
}

template <int NPAD>
__global__ void __launch_bounds__(kMaxWarpsPerCta * 32)
lu32p_warp_kernel(const double* __restrict__ M, float* __restrict__ LU,
                  int32_t* __restrict__ piv, int batch, int n) {
  constexpr int R = (NPAD + 31) / 32;  // rows per lane
  constexpr int LD = NPAD + 4;         // tile row stride in floats
  extern __shared__ __align__(16) float smem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= batch) return;  // whole warps only: no barrier below is shared
  float* tile = smem + warp * (NPAD * LD + 2 * NPAD);
  float* pbuf = tile + NPAD * LD;  // two pivot-row buffers

  // 1. coalesced 16-byte loads of the n*n float64 slab into the tile, as
  // float32; the slab of an odd n is 16-byte aligned only every other
  // matrix, so a misaligned first and a lone last element load alone
  const double* Mb = M + static_cast<size_t>(b) * n * n;
  const int nn = n * n;
  const float inv_n = 1.0f / static_cast<float>(n);
  auto put = [&](int e, double v) {
    // e / n without an integer division: exact for e < 4096, n <= 64
    const int i = static_cast<int>((static_cast<float>(e) + 0.5f) * inv_n);
    tile[i * LD + (e - i * n)] = static_cast<float>(v);
  };
  const int head = static_cast<int>((reinterpret_cast<uintptr_t>(Mb) >> 3) & 1);
  const int body = (nn - head) / 2;  // 16-byte pairs
  const double2* Mp = reinterpret_cast<const double2*>(Mb + head);
  if (lane == 0 && head) put(0, __ldg(Mb));
  if (lane == 1 && head + 2 * body < nn) put(nn - 1, __ldg(Mb + nn - 1));
  for (int c0 = 0; c0 < body; c0 += 32 * kLoadDepth) {
    double2 v[kLoadDepth];
#pragma unroll
    for (int u = 0; u < kLoadDepth; ++u) {
      const int c = c0 + 32 * u + lane;
      v[u] = c < body ? __ldg(Mp + c) : make_double2(0.0, 0.0);
    }
#pragma unroll
    for (int u = 0; u < kLoadDepth; ++u) {
      const int c = c0 + 32 * u + lane;
      if (c < body) {
        put(head + 2 * c, v[u].x);
        put(head + 2 * c + 1, v[u].y);
      }
    }
  }
  __syncwarp();

  // 2. each lane's rows into registers, identity pad written on the way
  Rows<R, NPAD> x;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int r = lane + 32 * s;
    x.pos[s] = r < NPAD ? r : -1;
    x.rid[s] = r;
    const bool live = r < n;
#pragma unroll
    for (int q = 0; q < NPAD; q += 4) {
      float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (live) t = *reinterpret_cast<const float4*>(tile + r * LD + q);
      const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = q + c;
        x.a[s][j] = (live && j < n) ? tv[c] : (r == j ? 1.0f : 0.0f);
      }
    }
  }

  // 3. the first pivot, published for the first step
  int pv0 = 0, pv1 = 0;  // lane l keeps ipiv[l] and ipiv[l + 32]
  float* LUb = LU + static_cast<size_t>(b) * NPAD * NPAD;
  int pr;
  {
    unsigned key[R];
    const unsigned best = pivot_max<0, R, NPAD>(x, 0, key);
    pr = pivot_pos<R, NPAD>(x, key, best);
#pragma unroll
    for (int s = 0; s < R; ++s) {
      if (x.pos[s] == pr >> 8) {
#pragma unroll
        for (int q = 0; q < NPAD; q += 4) {
          *reinterpret_cast<float4*>(pbuf + q) = make_float4(
              x.a[s][q], x.a[s][q + 1], x.a[s][q + 2], x.a[s][q + 3]);
        }
      }
    }
  }

  // 4. the factorization: with two rows per lane while more than 32 rows
  // remain, then with the remaining 32 rows moved to one per lane (a row
  // already pivoted is final and stored, so it is dropped)
  if constexpr (R == 2) {
    constexpr int KC = NPAD - 32;  // the column where 32 rows remain
    constexpr int TH = KC / 8;  // the first half at the full width
    pr = run_quads<NPAD, 2, NPAD>(x, pv0, pv1, pbuf, tile, LUb, lane, 0, TH,
                                  pr);
    pr = run_quads<NPAD - 4 * TH, 2, NPAD>(x, pv0, pv1, pbuf, tile, LUb, lane,
                                           TH, KC / 4, pr);
    // row j of the stage (tile columns KC .. KC + 35, not yet retired)
    // takes the row at position KC + j
    float* stage = tile + KC;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (x.pos[s] >= KC) {
        float* dst = stage + (x.pos[s] - KC) * LD;
#pragma unroll
        for (int q = 0; q < 32; q += 4) {
          *reinterpret_cast<float4*>(dst + q) = make_float4(
              x.a[s][q], x.a[s][q + 1], x.a[s][q + 2], x.a[s][q + 3]);
        }
        reinterpret_cast<int*>(dst)[32] = x.rid[s];
      }
    }
    __syncwarp();
    Rows<1, NPAD> y;
    const float* src = stage + lane * LD;
#pragma unroll
    for (int q = 0; q < 32; q += 4) {
      const float4 t = *reinterpret_cast<const float4*>(src + q);
      y.a[0][q] = t.x;
      y.a[0][q + 1] = t.y;
      y.a[0][q + 2] = t.z;
      y.a[0][q + 3] = t.w;
    }
    y.rid[0] = reinterpret_cast<const int*>(src)[32];
    y.pos[0] = KC + lane;
    one_row_phases<NPAD>(y, pv0, pv1, pbuf, tile, LUb, lane, pr);
  } else {
    one_row_phases<NPAD>(x, pv0, pv1, pbuf, tile, LUb, lane, pr);
  }
  if (lane < NPAD) piv[static_cast<size_t>(b) * NPAD + lane] = pv0;
  if (lane + 32 < NPAD) piv[static_cast<size_t>(b) * NPAD + lane + 32] = pv1;
}

// dynamic shared memory of one warp of the warp kernel, in floats: the
// tile and two pivot-row buffers
constexpr int warp_smem_floats(int npad) {
  return npad * (npad + 4) + 2 * npad;
}

template <int NPAD>
int launch_warp(const double* M, float* LU, int32_t* piv, int batch, int n,
                int grid, int block, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lu32p_warp_kernel<NPAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  lu32p_warp_kernel<NPAD><<<grid, block, smem, stream>>>(M, LU, piv, batch,
                                                         n);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// npad 72..240: one CTA per lane matrix, blocked right-looking LU
// ---------------------------------------------------------------------------

constexpr int kPanel = 8;           // panel width: the Pallas kernel's _BLOCK
constexpr int kCtaNpadMax = 240;    // the tile of npad 248 exceeds 227 KB
constexpr int kMoves = 4 * kPanel;  // a panel's net row moves (ints)
constexpr int kSlot = 12;  // a warp's candidate: key, row, 2 pad, 8 values

constexpr int kPanelWarpNpadMax = 128;  // the panel in one warp up to here

// threads per CTA and dynamic shared bytes for an npad: up to npad 128,
// 128 threads with the tile, the moves and two pivot-row buffers; above,
// 256 threads (one panel row each) with the tile, the moves, two sets of
// per-warp candidate slots and two copies of the row a step exchanges
constexpr int cta_threads(int npad) {
  return npad <= kPanelWarpNpadMax ? 128 : 256;
}
constexpr int cta_smem_bytes(int npad) {
  return (npad * npad + kMoves +
          (npad <= kPanelWarpNpadMax
               ? 2 * kPanel
               : 2 * kSlot * (cta_threads(npad) / 32) + 2 * kPanel)) *
         static_cast<int>(sizeof(float));
}

// The 8 panel columns of a row, and their store.
__device__ __forceinline__ void load8(const float* p, float (&v)[kPanel]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kPanel]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// The panel's net row moves, for the exchanges on the other columns, from
// its 8 pivots on threads 0..15: moves[j] is the row whose entries row
// ps + j takes (j < 8), and row moves[16 + i] (-1: none) takes those of
// row moves[8 + i], for each pivot row below the panel once.
__device__ __forceinline__ void publish_moves(const int (&piv8)[kPanel],
                                              int ps, int* moves, int tid) {
  if (tid >= 2 * kPanel) return;
  int d = ps + tid;  // threads 0..7: the panel's rows
  if (tid >= kPanel) {
    const int i = tid - kPanel;
    d = piv8[0];
#pragma unroll
    for (int j = 1; j < kPanel; ++j) d = j == i ? piv8[j] : d;
#pragma unroll
    for (int j = 0; j < kPanel - 1; ++j) d = j < i && piv8[j] == d ? -1 : d;
    d = d >= ps + kPanel ? d : -1;
  }
  int src = d;
#pragma unroll
  for (int j = kPanel - 1; j >= 0; --j) {
    const int k = ps + j;
    src = src == k ? piv8[j] : (src == piv8[j] ? k : src);
  }
  moves[tid] = src;
  if (tid >= kPanel) moves[tid + kPanel] = d;
}

// A22 -= L21 U12 on rows pe.. and the columns right of the next panel
// (pe + 8 ..), by NU threads (t counts them).  A thread owns 4 x 4 tiles:
// a quarter-warp shares a row tile, whose 4 x 8 multipliers it keeps in registers while
// it walks column groups, each read as one 16-byte word by one lane (a
// quarter-warp reads 128 contiguous bytes of a row), so a tile costs 16
// shared-memory accesses for 128 FMAs.
template <int NU>
__device__ __forceinline__ void trailing_update(float* A, int npad, int ps,
                                                int t) {
  constexpr int kTX = 8;
  constexpr int kTY = NU / kTX;
  const int pe = ps + kPanel;
  const int c0 = pe + kPanel;
  const int nrow = (npad - pe) >> 2;
  const int ncol = (npad - c0) >> 2;
  const int tx = t & (kTX - 1);
  for (int rt = t / kTX; rt < nrow; rt += kTY) {
    const int r0 = pe + 4 * rt;
    float l[4][kPanel];
#pragma unroll
    for (int i = 0; i < 4; ++i) load8(A + (r0 + i) * npad + ps, l[i]);
    for (int cg = tx; cg < ncol; cg += kTX) {
      const int cc = c0 + 4 * cg;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            A + (r0 + i) * npad + cc);
        acc[i][0] = v.x; acc[i][1] = v.y; acc[i][2] = v.z; acc[i][3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < kPanel; ++j) {
        const float4 w = *reinterpret_cast<const float4*>(
            A + (ps + j) * npad + cc);
        const float u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[i][c] = fmaf(-l[i][j], u[c], acc[i][c]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<float4*>(A + (r0 + i) * npad + cc) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
  }
}

// The n*n float64 slab into the tile as float32, with coalesced 16-byte
// loads (a misaligned first and a lone last element of an odd n load
// alone), and the identity pad: rows >= n in full, columns >= n of the
// rows < n.
template <int NT>
__device__ __forceinline__ void load_tile(const double* Mb, float* A, int n,
                                          int npad, int tid) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nn = n * n;
  const float inv_n = 1.0f / static_cast<float>(n);
  auto put = [&](int e, double v) {
    // e / n without an integer division: the product's error, under
    // n 2^-23, stays below the 0.5 / n between (e + 0.5) / n and the
    // nearest integer for n < 2048
    const int i = static_cast<int>((static_cast<float>(e) + 0.5f) * inv_n);
    A[i * npad + (e - i * n)] = static_cast<float>(v);
  };
  const int head =
      static_cast<int>((reinterpret_cast<uintptr_t>(Mb) >> 3) & 1);
  const int body = (nn - head) / 2;  // 16-byte pairs
  const double2* Mp = reinterpret_cast<const double2*>(Mb + head);
  if (tid == 0 && head) put(0, __ldg(Mb));
  if (tid == 1 && head + 2 * body < nn) put(nn - 1, __ldg(Mb + nn - 1));
  for (int c0 = 0; c0 < body; c0 += NT * kLoadDepth) {
    double2 v[kLoadDepth];
#pragma unroll
    for (int u = 0; u < kLoadDepth; ++u) {
      const int c = c0 + NT * u + tid;
      v[u] = c < body ? __ldg(Mp + c) : make_double2(0.0, 0.0);
    }
#pragma unroll
    for (int u = 0; u < kLoadDepth; ++u) {
      const int c = c0 + NT * u + tid;
      if (c < body) {
        put(head + 2 * c, v[u].x);
        put(head + 2 * c + 1, v[u].y);
      }
    }
  }
  for (int i = warp; i < npad; i += NT / 32) {
    for (int j = (i < n ? n : 0) + lane; j < npad; j += 32) {
      A[i * npad + j] = i == j ? 1.0f : 0.0f;
    }
  }
}

// The panel's exchanges on every other column (the delayed laswp), one
// column per thread: the moved entries are all loaded, then stored; on the
// columns right of the panel the unit-lower solve for the U12 strip runs
// between, in registers: t_i = fmaf(-l_ij, t_j, t_i), j then i.
template <int NT>
__device__ __forceinline__ void exchange_columns(float* A, int npad, int ps,
                                                 const int* moves, int tid) {
  const int pe = ps + kPanel;
  float l11[kPanel][kPanel];
#pragma unroll
  for (int i = 1; i < kPanel; ++i) {
#pragma unroll
    for (int j = 0; j < i; ++j) l11[i][j] = A[(ps + i) * npad + ps + j];
  }
  for (int c = tid; c < npad; c += NT) {
    if (c >= ps && c < pe) continue;
    float t[kPanel];
    float w[kPanel];
#pragma unroll
    for (int j = 0; j < kPanel; ++j) t[j] = A[moves[j] * npad + c];
#pragma unroll
    for (int i = 0; i < kPanel; ++i) {
      const int src = moves[kPanel + i];
      if (moves[2 * kPanel + i] >= 0) w[i] = A[src * npad + c];
    }
#pragma unroll
    for (int i = 0; i < kPanel; ++i) {
      const int dst = moves[2 * kPanel + i];
      if (dst >= 0) A[dst * npad + c] = w[i];
    }
    if (c >= pe) {
#pragma unroll
      for (int j = 0; j < kPanel; ++j) {
#pragma unroll
        for (int i = j + 1; i < kPanel; ++i) {
          t[i] = fmaf(-l11[i][j], t[j], t[i]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPanel; ++j) A[(ps + j) * npad + c] = t[j];
  }
}

// Rows ps .. ps + 7 are final once their panel's exchanges and U12 are
// done (later exchanges involve rows below): 16-byte stores to LU, left in
// flight while the update runs.
template <int NT>
__device__ __forceinline__ void store_rows(const float* A, float* LUb,
                                           int npad, int ps, int tid) {
  const int lane = tid & 31;
  for (int r = tid >> 5; r < kPanel; r += NT / 32) {
    const float4* src = reinterpret_cast<const float4*>(A + (ps + r) * npad);
    float4* dst = reinterpret_cast<float4*>(LUb + (ps + r) * npad);
    for (int q = lane; q < (npad >> 2); q += 32) dst[q] = src[q];
  }
}

// npad 72..128: the panel in one warp's registers, the update on the others.

// The panel as the panel warp holds it: lane l keeps rows ps + l + 32 s of
// the panel's 8 columns, each with its current position (-1: no row).
template <int R>
struct Panel {
  float a[R][kPanel];
  int pos[R];
};

// Rows ps.. of the panel's columns into the panel warp's registers.
template <int R>
__device__ __forceinline__ void load_panel(Panel<R>& x, const float* A,
                                           int npad, int ps, int lane) {
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int r = ps + lane + 32 * s;
    x.pos[s] = r < npad ? r : -1;
    if (r < npad) {
      load8(A + r * npad + ps, x.a[s]);
    } else {
#pragma unroll
      for (int c = 0; c < kPanel; ++c) x.a[s][c] = 0.0f;
    }
  }
}

// The panel's eight column steps inside one warp, no block barrier: the
// pivot search as in the warp kernel (a 32-bit key per candidate row, the
// largest key, then the smallest position holding it), the exchange of two
// positions, the pivot row published through shared memory (double-
// buffered by step), the multipliers and the rank-1 update of the panel's
// columns right of the step.  piv8[j] receives the pivot of column ps + j
// in every lane, and lane 0 stores it to piv.
template <int R>
__device__ __forceinline__ void factor_panel_warp(Panel<R>& x,
                                                  int (&piv8)[kPanel],
                                                  int ps, float* pbuf,
                                                  int32_t* pivb, int lane) {
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    const int k = ps + j;
    unsigned key[R];
    unsigned best = 0u;
#pragma unroll
    for (int s = 0; s < R; ++s) {
      key[s] = x.pos[s] >= k ? pivot_key(x.a[s][j]) : 0u;
      best = key[s] > best ? key[s] : best;
    }
    best = __reduce_max_sync(kFull, best);
    unsigned first = 0xffffffffu;
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const unsigned pos = static_cast<unsigned>(x.pos[s]);
      if (key[s] == best && pos < first) first = pos;
    }
    const int p = static_cast<int>(__reduce_min_sync(kFull, first));
    piv8[j] = p;
    if (lane == 0) pivb[k] = p;
    float* prow = pbuf + (j & 1) * kPanel;
    __syncwarp();  // every lane has read the buffer two steps back
#pragma unroll
    for (int s = 0; s < R; ++s) {
      if (x.pos[s] == p) store8(prow, x.a[s]);
      x.pos[s] = x.pos[s] == p ? k : (x.pos[s] == k ? p : x.pos[s]);
    }
    __syncwarp();  // the pivot row is visible to every lane
    float u[kPanel];
    load8(prow, u);
    const float safe = fabsf(u[j]) > 0.0f ? u[j] : 1.0f;
#pragma unroll
    for (int s = 0; s < R; ++s) {
      if (x.pos[s] > k) {
        const float l = div_rn(x.a[s][j], safe);
        x.a[s][j] = l;
#pragma unroll
        for (int c = j + 1; c < kPanel; ++c) {
          x.a[s][c] = fmaf(-l, u[c], x.a[s][c]);
        }
      }
    }
  }
}

// The factored panel back to the tile, each row at its final position.
template <int R>
__device__ __forceinline__ void store_panel(const Panel<R>& x, float* A,
                                            int npad, int ps) {
#pragma unroll
  for (int s = 0; s < R; ++s) {
    if (x.pos[s] >= 0) store8(A + x.pos[s] * npad + ps, x.a[s]);
  }
}

// The panel warp's look-ahead: rows pe.. of the next panel's columns
// pe .. pe + 7 take the rank-8 update of the panel at ps = pe - 8 in the
// tile, in the trailing update's order (a = fmaf(-l_j, u_jc, a), j = 0..7),
// a rolled loop over the rows.
__device__ __forceinline__ void update_next_panel(float* A, int npad, int pe,
                                                  int lane) {
  const int ps = pe - kPanel;
  for (int r = pe + lane; r < npad; r += 32) {
    float l[kPanel];
    float a[kPanel];
    load8(A + r * npad + ps, l);
    load8(A + r * npad + pe, a);
#pragma unroll
    for (int j = 0; j < kPanel; ++j) {
      float u[kPanel];
      load8(A + (ps + j) * npad + pe, u);
#pragma unroll
      for (int c = 0; c < kPanel; ++c) a[c] = fmaf(-l[j], u[c], a[c]);
    }
    store8(A + r * npad + pe, a);
  }
}

// npad 72..128: warp 0 factors each panel in registers while the other
// warps run the trailing update; it updates its next panel's columns itself
// first (the look-ahead), so a panel costs two block barriers.  At npad
// 72..96 the kernel is held to 64 registers: 8 CTAs fit an SM and
// B = 1024 runs in one wave.
template <int R>
__global__ void __launch_bounds__(128, R == 3 ? 8 : 4)
lu32p_cta_kernel(const double* __restrict__ M, float* __restrict__ LU,
                 int32_t* __restrict__ piv, int n, int npad) {
  constexpr int NT = 128;
  extern __shared__ __align__(16) float smem[];
  float* A = smem;  // npad x npad, row stride npad (16-byte aligned rows)
  float* pbuf = A + npad * npad;
  int* moves = reinterpret_cast<int*>(pbuf + 2 * kPanel);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t b = blockIdx.x;
  float* LUb = LU + b * static_cast<size_t>(npad) * npad;
  int32_t* pivb = piv + b * npad;

  load_tile<NT>(M + b * static_cast<size_t>(n) * n, A, n, npad, tid);
  __syncthreads();
  Panel<R> x;
  int piv8[kPanel];
  if (tid < 32) {
    load_panel<R>(x, A, npad, 0, lane);
    factor_panel_warp<R>(x, piv8, 0, pbuf, pivb, lane);
    store_panel<R>(x, A, npad, 0);
    publish_moves(piv8, 0, moves, lane);
  }
  __syncthreads();
  for (int ps = 0; ps < npad; ps += kPanel) {
    const int pe = ps + kPanel;
    exchange_columns<NT>(A, npad, ps, moves, tid);
    __syncthreads();
    store_rows<NT>(A, LUb, npad, ps, tid);
    if (pe < npad) {
      if (tid < 32) {
        update_next_panel(A, npad, pe, lane);
        __syncwarp();
        load_panel<R>(x, A, npad, pe, lane);
        factor_panel_warp<R>(x, piv8, pe, pbuf, pivb, lane);
        store_panel<R>(x, A, npad, pe);
        publish_moves(piv8, pe, moves, lane);
      } else {
        trailing_update<NT - 32>(A, npad, ps, tid - 32);
      }
    }
    __syncthreads();
  }
}

// The panel's eight column steps, thread r holding row r's 8 panel columns
// in registers, one block barrier per step.  Each warp finds its first
// largest key (__reduce_max_sync, then __reduce_min_sync over the rows
// holding it) and that row publishes key, row and values in the warp's
// slot, while the row at k publishes its values; after the barrier every
// thread picks the largest key over the warps, first row on a tie, so ties
// and NaN order as in the warp kernel.  Row k takes the pivot row's values
// and the pivot row row k's (the full-row exchange, on the panel's
// columns), then the rows below take their multiplier and the rank-1
// update of the columns right of the step.  Slots and exchanged row are
// double-buffered by step, so one barrier per step suffices.  piv8[j]
// receives the pivot of column ps + j in every thread.
template <int NT>
__device__ __forceinline__ void factor_panel_cta(float (&a)[kPanel],
                                             int (&piv8)[kPanel], int npad,
                                             int ps, float* slots,
                                             float* xrow, int tid) {
  constexpr int kWarps = NT / 32;
  const int r = tid;
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    const int k = ps + j;
    const bool live = r >= k && r < npad;
    const unsigned key = live ? pivot_key(a[j]) : 0u;
    const unsigned best = __reduce_max_sync(kFull, key);
    const unsigned first = __reduce_min_sync(
        kFull, key == best ? static_cast<unsigned>(r) : 0xffffffffu);
    float* set = slots + (j & 1) * kWarps * kSlot;
    float* xr = xrow + (j & 1) * kPanel;
    if (static_cast<unsigned>(r) == first) {
      float* slot = set + (r >> 5) * kSlot;
      reinterpret_cast<unsigned*>(slot)[0] = best;
      reinterpret_cast<int*>(slot)[1] = r;
      store8(slot + 4, a);
    }
    if (r == k) store8(xr, a);
    __syncthreads();
    unsigned bk = 0u;
    int p = 0x7fffffff;
    int bw = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const unsigned kw = reinterpret_cast<const unsigned*>(set + w * kSlot)[0];
      const int rw = reinterpret_cast<const int*>(set + w * kSlot)[1];
      if (kw > bk || (kw == bk && rw < p)) {
        bk = kw;
        p = rw;
        bw = w;
      }
    }
    piv8[j] = p;
    float u[kPanel];
    load8(set + bw * kSlot + 4, u);
    if (r == k) {
#pragma unroll
      for (int c = 0; c < kPanel; ++c) a[c] = u[c];
    } else if (r == p) {
      load8(xr, a);
    }
    const float safe = fabsf(u[j]) > 0.0f ? u[j] : 1.0f;
    if (r > k && r < npad) {
      const float l = div_rn(a[j], safe);
      a[j] = l;
#pragma unroll
      for (int c = j + 1; c < kPanel; ++c) a[c] = fmaf(-l, u[c], a[c]);
    }
  }
}

// npad 136..240: one panel row per thread; each panel's column steps run
// on the whole CTA, one block barrier each, then the update on every warp.
// Here one CTA (two at npad 136..152) fills an SM's shared memory, so the
// panel's latency cannot hide behind other CTAs and is spread instead.
template <int NT>
__global__ void __launch_bounds__(NT)
lu32p_cta_wide_kernel(const double* __restrict__ M,
                      float* __restrict__ LU, int32_t* __restrict__ piv,
                      int n, int npad) {
  constexpr int kWarps = NT / 32;
  extern __shared__ __align__(16) float smem[];
  float* A = smem;  // npad x npad, row stride npad (16-byte aligned rows)
  float* slots = A + npad * npad;
  float* xrow = slots + 2 * kWarps * kSlot;
  int* moves = reinterpret_cast<int*>(xrow + 2 * kPanel);

  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;

  load_tile<NT>(M + b * static_cast<size_t>(n) * n, A, n, npad, tid);
  __syncthreads();

  // per panel: the 8 column steps (8 barriers), the exchanges on the
  // other columns with the U12 strip, the rank-8 update
  float* LUb = LU + b * static_cast<size_t>(npad) * npad;
  int32_t* pivb = piv + b * npad;
  float a[kPanel] = {};  // thread r holds row r's panel columns
  if (tid < npad) load8(A + tid * npad, a);
  for (int ps = 0; ps < npad; ps += kPanel) {
    const int pe = ps + kPanel;
    int piv8[kPanel];
    factor_panel_cta<NT>(a, piv8, npad, ps, slots, xrow, tid);
    if (tid >= ps && tid < npad) store8(A + tid * npad + ps, a);
    publish_moves(piv8, ps, moves, tid);
    if (tid == 0) {
#pragma unroll
      for (int j = 0; j < kPanel; ++j) pivb[ps + j] = piv8[j];
    }
    __syncthreads();

    exchange_columns<NT>(A, npad, ps, moves, tid);
    __syncthreads();

    store_rows<NT>(A, LUb, npad, ps, tid);
    if (pe < npad) {
      trailing_update<NT>(A, npad, ps, tid);
      // the next panel's row of this thread, updated in registers
      if (tid >= pe && tid < npad) {
        float l[kPanel];
        load8(A + tid * npad + ps, l);
        load8(A + tid * npad + pe, a);
#pragma unroll
        for (int j = 0; j < kPanel; ++j) {
          float u[kPanel];
          load8(A + (ps + j) * npad + pe, u);
#pragma unroll
          for (int c = 0; c < kPanel; ++c) a[c] = fmaf(-l[j], u[c], a[c]);
        }
      }
    }
  }
}

template <int R>
int launch_cta(const double* M, float* LU, int32_t* piv, int batch, int n,
               int npad, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lu32p_cta_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  lu32p_cta_kernel<R><<<batch, 128, smem, stream>>>(M, LU, piv, n, npad);
  return static_cast<int>(cudaGetLastError());
}

int launch_cta_wide(const double* M, float* LU, int32_t* piv, int batch,
                    int n, int npad, int smem, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      lu32p_cta_wide_kernel<256>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  lu32p_cta_wide_kernel<256><<<batch, 256, smem, stream>>>(M, LU, piv, n,
                                                           npad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch configuration comes from the wrapper (launch_config in
// linalg_cuda.py) and is checked here against the kernel that npad selects;
// a mismatch returns cudaErrorInvalidValue and launches nothing.
extern "C" int lu32p_factor(const double* M, float* LU, int32_t* piv,
                            int batch, int n, int npad, int grid, int block,
                            int smem, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || n <= 0 || n > npad || npad % 8 != 0) return bad;
  if (npad <= kWarpNpadMax) {
    const int warps = block / 32;
    if (block % 32 != 0 || warps < 1 || warps > kMaxWarpsPerCta ||
        smem != warps * warp_smem_floats(npad) * static_cast<int>(sizeof(float)) ||
        static_cast<long long>(grid) * warps < batch ||
        static_cast<long long>(grid - 1) * warps >= batch) {
      return bad;
    }
    switch (npad) {
      case 8: return launch_warp<8>(M, LU, piv, batch, n, grid, block, smem, st);
      case 16: return launch_warp<16>(M, LU, piv, batch, n, grid, block, smem, st);
      case 24: return launch_warp<24>(M, LU, piv, batch, n, grid, block, smem, st);
      case 32: return launch_warp<32>(M, LU, piv, batch, n, grid, block, smem, st);
      case 40: return launch_warp<40>(M, LU, piv, batch, n, grid, block, smem, st);
      case 48: return launch_warp<48>(M, LU, piv, batch, n, grid, block, smem, st);
      case 56: return launch_warp<56>(M, LU, piv, batch, n, grid, block, smem, st);
      case 64: return launch_warp<64>(M, LU, piv, batch, n, grid, block, smem, st);
      default: return bad;
    }
  }
  if (npad > kCtaNpadMax || grid != batch || block != cta_threads(npad) ||
      smem != cta_smem_bytes(npad)) {
    return bad;
  }
  if (npad > kPanelWarpNpadMax) {
    return launch_cta_wide(M, LU, piv, batch, n, npad, smem, st);
  }
  return npad <= 96 ? launch_cta<3>(M, LU, piv, batch, n, npad, smem, st)
                    : launch_cta<4>(M, LU, piv, batch, n, npad, smem, st);
}

extern "C" const char* lu32p_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
