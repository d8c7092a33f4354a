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
// Two kernels, chosen by npad alone (the wrapper's launch_config):
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
// npad 72..240: lu32p_cta_kernel, one CTA of 128 threads per lane matrix
// with the npad x (npad + 1) tile in dynamic shared memory; per column a
// block argmax, a row swap, the multipliers and the rank-1 update, each
// behind a block barrier.  No main-path mechanism has n > 64; this is the
// general path, kept as the first port wrote it.
//
// What bounds it on an H100: at the main path's shape (B = 1024, n = 53,
// npad = 56) the function must read 1024*53*53*8 B = 23.0 MB of float64 and
// write 1024*56*56*4 B = 12.8 MB of LU plus 0.2 MB of pivots, against about
// 2/3 npad^3 B = 0.12 GFLOP: at 3.35 TB/s and 67 TFLOP/s (fp32) a bandwidth
// bound of about 11 us.  The warp kernel moves each of those bytes once, but
// it is latency-bound: each warp runs npad dependent column steps (two warp
// reductions, a shared-memory round trip for the pivot row, IEEE divisions,
// then the FMAs), and B = 1024 gives 7.75 warps per SM, two per scheduler,
// to hide that.  The load phase (all warps read at once) does not overlap
// the factorization.
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
// npad 72..240: one CTA per lane matrix
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// argmax order: NaN beats every number, then the larger value, then the
// lower row index (the first maximum, as jnp.argmax and torch.argmax).
__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  const bool n1 = isnan(v1);
  const bool n2 = isnan(v2);
  if (n1 != n2) return n1;
  if (!n1 && v1 != v2) return v1 > v2;
  return i1 < i2;
}

__global__ void __launch_bounds__(kThreads)
lu32p_cta_kernel(const double* __restrict__ M, float* __restrict__ LU,
                 int32_t* __restrict__ piv, int n, int npad) {
  extern __shared__ float A[];  // npad rows of stride ld
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int s_p;

  const int ld = npad + 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t b = blockIdx.x;
  const double* Mb = M + b * static_cast<size_t>(n) * n;

  // load: float32 cast and identity pad in one pass
  for (int e = tid; e < npad * npad; e += kThreads) {
    const int i = e / npad;
    const int j = e - i * npad;
    float v;
    if (i < n && j < n) {
      v = static_cast<float>(Mb[static_cast<size_t>(i) * n + j]);
    } else {
      v = (i == j) ? 1.0f : 0.0f;
    }
    A[i * ld + j] = v;
  }
  __syncthreads();

  for (int k = 0; k < npad; ++k) {
    // 1. block argmax of |a_ik| over i >= k
    float bv = -1.0f;  // below every |a|: a thread with no rows never wins
    int bi = npad;
    for (int i = k + tid; i < npad; i += kThreads) {
      const float v = fabsf(A[i * ld + k]);
      if (better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      float v = red_v[0];
      int i0 = red_i[0];
      for (int w = 1; w < kWarps; ++w) {
        if (better(red_v[w], red_i[w], v, i0)) {
          v = red_v[w];
          i0 = red_i[w];
        }
      }
      s_p = i0;
      piv[b * npad + k] = i0;
    }
    __syncthreads();

    // 2. full-row swap (p is block-uniform, so the barrier is too)
    const int p = s_p;
    if (p != k) {
      for (int j = tid; j < npad; j += kThreads) {
        const float t = A[k * ld + j];
        A[k * ld + j] = A[p * ld + j];
        A[p * ld + j] = t;
      }
      __syncthreads();
    }

    // 3. pivot guard and multipliers
    const float pivot = A[k * ld + k];
    const float safe = (fabsf(pivot) > 0.0f) ? pivot : 1.0f;
    for (int i = k + 1 + tid; i < npad; i += kThreads) {
      A[i * ld + k] = A[i * ld + k] / safe;
    }
    __syncthreads();

    // 4. rank-1 update of the trailing submatrix
    const int w = npad - k - 1;
    for (int e = tid; e < w * w; e += kThreads) {
      const int r = e / w;
      const int i = k + 1 + r;
      const int j = k + 1 + (e - r * w);
      A[i * ld + j] = fmaf(-A[i * ld + k], A[k * ld + j], A[i * ld + j]);
    }
    __syncthreads();
  }

  float* LUb = LU + b * static_cast<size_t>(npad) * npad;
  for (int e = tid; e < npad * npad; e += kThreads) {
    const int i = e / npad;
    const int j = e - i * npad;
    LUb[e] = A[i * ld + j];
  }
}

int launch_cta(const double* M, float* LU, int32_t* piv, int batch, int n,
               int npad, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lu32p_cta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  lu32p_cta_kernel<<<batch, kThreads, smem, stream>>>(M, LU, piv, n, npad);
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
  if (grid != batch || block != kThreads ||
      smem != npad * (npad + 1) * static_cast<int>(sizeof(float))) {
    return bad;
  }
  return launch_cta(M, LU, piv, batch, n, npad, smem, st);
}

extern "C" const char* lu32p_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
