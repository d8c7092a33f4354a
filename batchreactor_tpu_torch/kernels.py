"""The port's hand-written CUDA kernels as one shared library.

Every ``.cu`` source under ``csrc/`` (``lu32p.cu``, the float32 LU factor
of ``solver/linalg_cuda.py``; ``gas_rates.cu``, the gas production rates
of ``ops/gas_rates_cuda.py``) builds at first use with ``nvcc`` into
``build/kernels/`` beside the package, as one library named by a hash of
those sources and the flags, so a library on disk was built from exactly
them.  :func:`load_library` builds (once) and loads it, with the ctypes
signature of each C entry point set.  Both wrappers load it from here,
so the physics layer and the solver layer share it without importing
each other.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

from .obs.recorder import current as current_recorder
from .obs.recorder import span_or_null

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
#: the CUDA sources
CSRC = os.path.join(_PKG_DIR, "csrc")
#: where the library is built
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
# -cudart shared: the library uses the process's libcudart (PyTorch's), so
# torch.profiler sees its launches
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-cudart", "shared",
              "-Xptxas", "-v"]

_ll, _vp, _i, _d = (ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_double)
#: (argtypes, restype) of each C entry point of the library
SIGNATURES = {
    # (M, LU, piv, batch, n, npad, grid, block, smem, stream)
    "lu32p_factor": ([_vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _vp], _i),
    "lu32p_error_string": ([_i], ctypes.c_char_p),
    # (T, t_stride, conc, c_stride, wdot, B, S, R, kf, kr, kd, operands,
    #  n_operands, r_gas, p0, c0_shift, falloff_compat, exp32, lanes, grid,
    #  block, smem, stream)
    "gas_wdot": ([_vp, _ll, _vp, _ll, _vp, _i, _i, _i, _i, _i, _i, _vp, _i,
                  _d, _d, _d, _i, _i, _i, _i, _i, _i, _vp], _i),
    "gas_wdot_error_string": ([_i], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib = None
#: what the last build printed (``-Xptxas -v``: registers, shared memory)
#: and how long it took, for ``chip_smoke.py``
BUILD_INFO = {}


def nvcc():
    """The ``nvcc`` of ``CUDA_HOME`` (default ``/usr/local/cuda``) or of
    ``PATH``."""
    # the build runs at the library's first load, outside any step
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"  # brlint: disable=env-read-in-trace
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be "
                           "built (set CUDA_HOME or put nvcc on PATH)")
    return found


def sources():
    """Every file under ``csrc/`` that the build reads."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path():
    """Build target named by a content hash of the CUDA sources."""
    h = hashlib.sha256()
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libbrtorch-{h.hexdigest()[:12]}.so")


def load_library():
    """Build (once, at first use) and load the kernel library; an entered
    ``obs.CompileWatch`` counts the build, or the load from the build
    cache, and the current recorder gets a ``lib_load`` span (``built``:
    whether nvcc ran)."""
    if _lib is not None:
        return _lib
    with span_or_null(current_recorder(), "lib_load",
                      built=not os.path.exists(library_path())):
        return _load_library()


def _load_library():
    from .obs import retrace

    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            # build to a temp name and rename: the hash-named target is
            # trusted by existence alone
            tmp = f"{so}.build{os.getpid()}"
            t0 = time.perf_counter()
            units = [p for p in sources() if p.endswith(".cu")]
            proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, *units],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {units}:\n{proc.stderr}")
            os.replace(tmp, so)
            BUILD_INFO.update(seconds=time.perf_counter() - t0,
                              log=proc.stderr)
            retrace.dispatch("compile", step="nvcc",
                             seconds=BUILD_INFO["seconds"])
        else:
            retrace.dispatch("cache_hit")
        lib = ctypes.CDLL(so)
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _lib = lib
        return lib
