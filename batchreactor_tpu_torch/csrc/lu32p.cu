// Batched float32 LU with partial pivoting for Hopper (sm_90a).
//
// Replaces batchreactor_tpu/solver/linalg_pallas.py::_lu_kernel, the JAX
// package's Pallas kernel behind linsolve="lu32p".  It computes what that
// kernel computes, not its TPU blocking: for each lane matrix M (n x n,
// float64 in device memory) the LAPACK-style factorization
// P A = L U of A = [[M, 0], [0, I]] padded with an identity block to npad
// (a multiple of 8), in float32, with
//   - the pivot of column k chosen as the first row i >= k with the largest
//     |a_ik| (jnp.argmax / torch.argmax order; a NaN wins like it does there),
//   - full-row swaps recorded as 0-based ipiv,
//   - a zero pivot replaced by 1.0 (the exactly-singular guard of
//     solver/linalg.py::lu_factor: the factor stays finite, the solve goes
//     non-finite),
//   - unit-lower L stored below the diagonal, U on and above it.
// Partial pivoting with full-row swaps gives the same (LU, ipiv) as the
// blocked, delayed-laswp form of the TPU kernel, up to rounding.
//
// Design: one CTA of 128 threads per lane matrix, so the grid is B blocks.
// The npad x npad tile sits in dynamic shared memory with a row stride of
// npad + 1 (column reads are bank-conflict free); the cast to float32 and
// the identity pad happen while loading.  Per column: a block argmax (warp
// shuffles, then one value per warp in shared memory), the row swap and
// pivot guard, the multipliers, and a rank-1 update of the trailing
// submatrix by all threads in plain fp32 FMA (no TF32).
//
// What bounds it on an H100: at the main path's shape (B = 1024, n = 53,
// npad = 56) the function must read 1024*53*53*8 B = 23.0 MB of float64 and
// write 1024*56*56*4 B = 12.8 MB of LU plus 0.2 MB of pivots, against about
// 2/3 npad^3 B = 0.12 GFLOP.  At 3.35 TB/s and 67 TFLOP/s (fp32) that is a
// bandwidth bound of about 11 us.  This design reads each input byte once
// and writes each output byte once (the tile never leaves shared memory),
// but its npad sequential column steps, each with three block-wide barriers,
// make it latency-bound well above that bound.  Several matrices per CTA,
// register tiling of the trailing update and cp.async loads are the later
// work that moves it toward the bound.
//
// Built by batchreactor_tpu_torch/solver/linalg_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes: the wrapper allocates LU and piv, launches on
// PyTorch's current stream, and raises on a non-zero return code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
lu32p_kernel(const double* __restrict__ M, float* __restrict__ LU,
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

}  // namespace

extern "C" int lu32p_factor(const double* M, float* LU, int32_t* piv,
                            int batch, int n, int npad, void* stream) {
  const size_t smem = static_cast<size_t>(npad) * (npad + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lu32p_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  lu32p_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      M, LU, piv, n, npad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lu32p_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
