"""Where the CTA kernels of ``lu32p`` spend their cycles: a copy of
``csrc/lu32p.cu`` with clock64() marks at the phase boundaries of CTA 0,
built with nvcc beside the kernel library and run once per shape.

    python -m batchreactor_tpu_torch.tools.lu32p_trace [--n 66 120 240]

Needs an NVIDIA GPU and nvcc.  For each n (B = 1024 row-permuted
diagonally dominant matrices, made from ``--seed``) it prints one JSON
line: the launch's CUDA-event ms, CTA 0's cycles to load its tile, to
factor the first panel and to the last panel's exchanges, and per panel
the cycles from the panel's start to the end of its exchanges
(``to_xchg``: in the wide kernel the column steps too) and from there to
the next panel's start (``after_xchg``: in the panel-warp kernel the
panel warp's next panel beside the trailing update).  The marks sit
after block barriers, so each span is the slowest warp's.
"""

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from batchreactor_tpu_torch import kernels
from batchreactor_tpu_torch.solver import linalg_cuda as lc

MARKS = (
    ('#include <stdint.h>\n',
     '#include <stdint.h>\n__device__ unsigned long long g_trace[1024];\n'
     '#define MARK(i) do { if (blockIdx.x == 0) g_trace[i] = clock64(); }'
     ' while (0)\n'),
    ('''  load_tile<NT>(M + b * static_cast<size_t>(n) * n, A, n, npad, tid);
  __syncthreads();''',
     '''  if (tid == 0) MARK(0);
  load_tile<NT>(M + b * static_cast<size_t>(n) * n, A, n, npad, tid);
  __syncthreads();
  if (tid == 0) MARK(1);'''),
    ('''  for (int ps = 0; ps < npad; ps += kPanel) {
    const int pe = ps + kPanel;''',
     '''  for (int ps = 0; ps < npad; ps += kPanel) {
    const int pe = ps + kPanel;
    if (tid == 0) MARK(8 + 2 * (ps >> 3));'''),
    ('''    exchange_columns<NT>(A, npad, ps, moves, tid);
    __syncthreads();''',
     '''    exchange_columns<NT>(A, npad, ps, moves, tid);
    __syncthreads();
    if (tid == 0) MARK(9 + 2 * (ps >> 3));'''),
)


def traced_source():
    with open(lc._SRC) as f:
        src = f.read()
    for old, new in MARKS:
        if old not in src:
            raise RuntimeError(f"lu32p.cu changed: no anchor {old[:50]!r}")
        src = src.replace(old, new)
    return src + ('\nextern "C" int lu32p_trace_read(void* dst) {\n'
                  '  return static_cast<int>(cudaMemcpyFromSymbol(\n'
                  '      dst, g_trace, sizeof(g_trace)));\n}\n')


def build():
    out = os.path.join(kernels.BUILD_DIR, "trace")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, "lu32p_trace.cu"), os.path.join(
        out, "liblu32p_trace.so")
    with open(cu, "w") as f:
        f.write(traced_source())
    proc = subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS, "-o", so, cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    lib.lu32p_factor.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                                 + [ctypes.c_void_p])
    lib.lu32p_trace_read.argtypes = [ctypes.c_void_p]
    return lib


def trace(lib, n, rng, B=1024):
    A = rng.standard_normal((B, n, n)) * 0.1 + np.eye(n) * rng.uniform(
        10.0, 20.0, (B, 1, n))
    A = np.take_along_axis(A, rng.permuted(
        np.broadcast_to(np.arange(n), (B, n)), axis=1)[..., None], axis=1)
    M = torch.tensor(A, device="cuda")
    npad = lc.padded_n(n)
    cfg = lc.launch_config(B, npad)
    LU = torch.empty((B, npad, npad), dtype=torch.float32, device="cuda")
    piv = torch.empty((B, npad), dtype=torch.int32, device="cuda")
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(3):  # the last launch is the one read
        e0.record()
        err = lib.lu32p_factor(M.data_ptr(), LU.data_ptr(), piv.data_ptr(),
                               B, n, npad, cfg["grid"], cfg["block"],
                               cfg["smem"],
                               torch.cuda.current_stream().cuda_stream)
        e1.record()
        if err != 0:
            raise RuntimeError(f"launch failed: {err}")
    torch.cuda.synchronize()
    t = np.zeros(1024, dtype=np.uint64)
    if lib.lu32p_trace_read(t.ctypes.data) != 0:
        raise RuntimeError("cudaMemcpyFromSymbol failed")
    t = t.astype(np.int64)
    P = npad // 8
    panels = [{"panel": k, "to_xchg": int(t[9 + 2 * k] - t[8 + 2 * k]),
               "after_xchg": (int(t[8 + 2 * (k + 1)] - t[9 + 2 * k])
                              if k + 1 < P else None)} for k in range(P)]
    return {"n": n, "npad": npad, "B": B, "block": cfg["block"],
            "event_ms": e0.elapsed_time(e1),
            "load_cycles": int(t[1] - t[0]),
            "first_panel_cycles": int(t[8] - t[1]),
            "cycles_to_last_xchg": int(t[9 + 2 * (P - 1)] - t[0]),
            "sum_to_xchg": sum(p["to_xchg"] for p in panels),
            "sum_after_xchg": sum(p["after_xchg"] or 0 for p in panels),
            "panels": panels}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[66, 120, 240])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lu32p_trace: needs an NVIDIA GPU")
    lib = build()
    rng = np.random.default_rng(args.seed)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for n in args.n:
        if lc.launch_config(1, lc.padded_n(n))["path"] != "cta":
            raise SystemExit(f"n={n} is not on the CTA path")
        print(json.dumps({"gpu": gpu, **trace(lib, n, rng)}), flush=True)


if __name__ == "__main__":
    main()
