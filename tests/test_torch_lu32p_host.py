"""The CUDA source of the ``lu32p`` kernels run on the host: the port's
``csrc/lu32p.cu`` compiled with g++ against a mock of the CUDA runtime
that runs one ``std::thread`` per CUDA thread (a ``std::barrier`` per warp
for ``__syncwarp`` and the warp reductions, one per block for
``__syncthreads``; shared memory filled with NaN), called through ctypes on
numpy buffers.  It checks the kernels' logic on the CPU, not their speed
or the device compiler: ``chip_smoke.py`` does that on the card.

The CTA kernel (npad 72..240) must reproduce ``blocked_lu32``, its order of
operations, bit for bit, and the plain version's pivots; the warp kernel
(npad <= 64) the plain version's pivots, within 64 n eps32.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from batchreactor_tpu_torch.solver import linalg_cuda as lc
from batchreactor_tpu_torch.tools.lu32p_coverages import blocked_lu32
from test_torch_cuda import _nan_matrix, _tie_matrix
from test_torch_linalg import _separated

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)

MOCK_CUDA_RUNTIME = r"""
#pragma once
#include <array>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __align__(x) alignas(x)
struct dim3v { int x, y, z; };
inline thread_local dim3v threadIdx, blockIdx, blockDim;
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) double2 { double x, y; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline double2 make_double2(double a, double b) { return {a, b}; }
template <class T> T __ldg(const T* p) { return *p; }
inline unsigned __float_as_uint(float f) {
  unsigned u; std::memcpy(&u, &f, 4); return u;
}
inline int __float_as_int(float f) { int u; std::memcpy(&u, &f, 4); return u; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int e) { return e ? "invalid" : "ok"; }
struct MockBlock {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> wbar;
  std::vector<std::array<unsigned, 32>> slots;
  std::vector<float> smem;
};
inline thread_local MockBlock* g_block;
inline void __syncthreads() { g_block->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  g_block->wbar[threadIdx.x / 32]->arrive_and_wait();
}
inline unsigned mock_reduce(unsigned v, bool mx, bool bits = false) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_block->slots[w][l] = v;
  __syncwarp();
  unsigned r = g_block->slots[w][0];
  for (int i = 1; i < 32; ++i) {
    const unsigned o = g_block->slots[w][i];
    r = bits ? (r | o) : mx ? (o > r ? o : r) : (o < r ? o : r);
  }
  __syncwarp();
  return r;
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  return mock_reduce(v, true);
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  return mock_reduce(v, false);
}
inline unsigned __ballot_sync(unsigned, bool v) {
  return mock_reduce(v ? 1u << (threadIdx.x % 32) : 0u, true, true);
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline float* mock_smem() { return g_block->smem.data(); }
template <class K, class... Args>
void mock_launch(K kernel, int grid, int block, int smem, cudaStream_t,
                 Args... args) {
  for (int b = 0; b < grid; ++b) {
    MockBlock blk;
    blk.bar = std::make_unique<std::barrier<>>(block);
    for (int w = 0; w < (block + 31) / 32; ++w)
      blk.wbar.push_back(std::make_unique<std::barrier<>>(32));
    blk.slots.resize((block + 31) / 32);
    blk.smem.assign(smem / 4 + 4, std::numeric_limits<float>::quiet_NaN());
    std::vector<std::thread> th;
    for (int t = 0; t < block; ++t)
      th.emplace_back([&, t] {
        threadIdx = {t, 0, 0}; blockIdx = {b, 0, 0}; blockDim = {block, 1, 1};
        g_block = &blk;
        kernel(args...);
      });
    for (auto& x : th) x.join();
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    out = tmp_path_factory.mktemp("lu32p_host")
    (out / "cuda_runtime.h").write_text(MOCK_CUDA_RUNTIME)
    with open(lc._SRC) as f:
        src = f.read()
    sites = src.count("<<<")
    src = src.replace("extern __shared__ __align__(16) float smem[];",
                      "float* smem = mock_smem();")
    src, launches = re.subn(
        r"([A-Za-z_0-9]+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);",
        lambda m: f"mock_launch({m.group(1)}, {m.group(2)}, {m.group(3)});",
        src, flags=re.S)
    assert launches == sites and "<<<" not in src
    (out / "lu32p_host.cpp").write_text(src)
    so = str(out / "liblu32p_host.so")
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                           "-pthread", "-I", str(out), "-o", so,
                           str(out / "lu32p_host.cpp")],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(so)
    lib.lu32p_factor.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                                 + [ctypes.c_void_p])
    lib.lu32p_factor.restype = ctypes.c_int
    return lib


def _factor(lib, A):
    """The C entry point on host buffers, with the wrapper's launch
    configuration; LU and piv start as garbage."""
    A = np.ascontiguousarray(A, dtype=np.float64)
    B, n = A.shape[0], A.shape[-1]
    npad = lc.padded_n(n)
    cfg = lc.launch_config(B, npad)
    LU = np.full((B, npad, npad), np.nan, dtype=np.float32)
    piv = np.full((B, npad), -7, dtype=np.int32)
    err = lib.lu32p_factor(A.ctypes.data, LU.ctypes.data, piv.ctypes.data,
                           B, n, npad, cfg["grid"], cfg["block"], cfg["smem"],
                           None)
    assert err == 0
    return torch.tensor(LU), torch.tensor(piv)


@pytest.mark.parametrize("kind", ["separated", "random"])
@pytest.mark.parametrize("n", [65, 66, 120, 129, 176, 240])
def test_cta_kernel_source_is_blocked_lu32_bit_for_bit(host_lib, n, kind):
    """B = 2 with an odd n puts the float64 slab off 16-byte alignment on
    the second lane, which the load handles element by element."""
    rng = np.random.default_rng(1000 + n)
    A = (_separated(2, n, rng) if kind == "separated"
         else rng.standard_normal((2, n, n)))
    assert lc.launch_config(2, lc.padded_n(n))["path"] == "cta"
    LU, piv = _factor(host_lib, A)
    LU_e, piv_e = blocked_lu32(torch.tensor(A))
    assert torch.equal(piv, piv_e)
    assert torch.equal(LU, LU_e)
    _, piv_p = lc.lu32p_factor_plain(torch.tensor(A))
    assert torch.equal(piv, piv_p)


@pytest.mark.parametrize("n", [9, 53, 64])
def test_warp_kernel_source_matches_plain(host_lib, n):
    rng = np.random.default_rng(2000 + n)
    A = _separated(5, n, rng)
    LU, piv = _factor(host_lib, A)
    LU_p, piv_p = lc.lu32p_factor_plain(torch.tensor(A))
    assert torch.equal(piv, piv_p)
    scale = LU_p.abs().amax(dim=(1, 2), keepdim=True)
    assert float(((LU - LU_p).abs() / scale).max()) <= 64 * n * EPS32


def _embedded(A9, n):
    A = 0.5 * np.eye(n)
    A[:9, :9] = A9
    return A


@pytest.mark.parametrize("n", [9, 70, 240])
@pytest.mark.parametrize("case", [_tie_matrix, _nan_matrix],
                         ids=["exact_tie", "nan_pivot"])
def test_kernel_source_pivot_order(host_lib, case, n):
    """The exact-tie and NaN cases of test_torch_cuda.py, on both kernels:
    at n = 9 alone (the warp kernel), at n = 70 and 240 as the leading
    block of 0.5 I (the CTA kernel)."""
    A9, want = case()
    A = _embedded(A9, n)[None]
    LU, piv = _factor(host_lib, A)
    LU_p, piv_p = lc.lu32p_factor_plain(torch.tensor(A))
    assert piv[0, :9].tolist() == want
    assert torch.equal(piv, piv_p)
    assert torch.equal(torch.isnan(LU), torch.isnan(LU_p))
    fin = torch.isfinite(LU_p)
    assert float((LU[fin] - LU_p[fin]).abs().max()) <= 1e-6


@pytest.mark.parametrize("n,m", [(3, 5), (70, 69)])
def test_kernel_source_singular_guard_and_pad(host_lib, n, m):
    """A structurally singular column factors finite and solves
    non-finite (n), and the identity pad of an m short of a multiple of 8
    pivots on its own diagonal."""
    S = np.eye(n)
    S[:3, :3] = [[1.0, 2.0, 0.0], [3.0, 4.0, 0.0], [5.0, 6.0, 0.0]]
    LU, piv = _factor(host_lib, S[None])
    x = lc.lu32p_solve((LU, piv), torch.ones((1, n), dtype=torch.float64))
    assert bool(torch.all(torch.isfinite(LU)))
    assert not bool(torch.all(torch.isfinite(x)))
    rng = np.random.default_rng(m)
    _, piv = _factor(host_lib, _separated(2, m, rng))
    npad = lc.padded_n(m)
    assert npad > m
    np.testing.assert_array_equal(piv[:, m:].numpy(), np.broadcast_to(
        np.arange(m, npad), (2, npad - m)))
    assert bool(torch.all(piv[:, :m] < m))


def test_trace_tool_marks_both_cta_kernels():
    """``tools/lu32p_trace.py`` patches clock64() marks into a copy of the
    source at its phase boundaries: each anchor must still be there, once
    in each CTA kernel."""
    from batchreactor_tpu_torch.tools.lu32p_trace import traced_source

    src = traced_source()
    for i in ("0", "1", "8 + 2 * (ps >> 3)", "9 + 2 * (ps >> 3)"):
        assert src.count(f"MARK({i});") == 2, i
