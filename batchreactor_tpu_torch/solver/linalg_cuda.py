"""Batched float32 LU with partial pivoting (``linsolve="lu32p"``): the
Hopper kernel and its plain PyTorch version.

Port of ``batchreactor_tpu/solver/linalg_pallas.py``.  The JAX package's
one Pallas kernel, ``_lu_kernel``, becomes ``csrc/lu32p.cu`` (CUDA C++ for
sm_90a; the source says what bounds it), two kernels chosen by npad
(:func:`launch_config`): for npad <= 64 one warp per lane matrix with the
factor in registers; for npad 72..240 one CTA per lane matrix with the tile
in shared memory, factored as the Pallas kernel factors it, a blocked
right-looking LU with 8-wide panels (each panel inside one warp, the
delayed row exchanges and the U12 strip one column per thread, a
register-tiled rank-8 trailing update with look-ahead, two block barriers
per panel).  Past npad 240 (:data:`CTA_NPAD_MAX`) there is no kernel, and
``resolve_linsolve("auto")`` keeps such states on the float64 ``lu``.  The
contract is the JAX one, batched: ``lu32p_factor(A)`` with A (B, n, n)
returns ``(LU, piv)`` at the PADDED size (:func:`padded_n`) — LU (B, npad,
npad) float32 with unit-lower L in place, piv (B, npad) int32 LAPACK-style
0-based ``ipiv``.

* :func:`lu32p_factor` takes the plain version only for a tensor on the
  CPU; for a CUDA tensor it launches one of the two kernels or raises.
  Both run as the operator ``brtorch::lu32p_factor`` (a
  ``torch.library.custom_op``: the plain version is its CPU kernel, the
  launch its CUDA kernel), so the kernel has a name in an op log, in
  ``torch.profiler`` and in a captured graph.
* :func:`lu32p_factor_plain` follows the Pallas algorithm step by step
  (8-wide panels, masked argmax, delayed swaps, unit-lower TRSM for the U12
  strip, trailing float32 matmul).  The CPU tests hold it against the JAX
  kernel in interpret mode; ``chip_smoke.py`` holds the CUDA kernel
  against it on the card.
* :func:`lu32p_solve` is plain substitution, as in the JAX package (where
  XLA fuses it); it is not a kernel.

The kernels build at first use with ``nvcc`` into ``build/kernels/`` beside
the package, as one library named by a hash of every source under
``csrc/``, so a library on disk was built from exactly these sources.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

#: panel width of the plain version and of the CTA kernel; also the
#: padding granule (GRI n=53 pads to 56)
_BLOCK = 8

#: shared memory one block may use on sm_90 (227 KB)
_SMEM_LIMIT = 232_448

#: the largest npad the warp kernel takes (two rows per lane)
WARP_NPAD_MAX = 64
#: warps (lane matrices) per CTA of the warp kernel
WARPS_PER_CTA = 4
#: the largest npad the CTA kernel takes: its npad x npad tile at npad 248
#: exceeds the shared memory of one block.  ``resolve_linsolve("auto")``
#: keeps larger states on the float64 ``lu``.
CTA_NPAD_MAX = 240
#: up to this npad one warp of the CTA kernel factors each panel in its
#: registers; above, every thread holds one panel row
PANEL_WARP_NPAD_MAX = 128

#: launches of the CUDA kernels since the count was last set to 0
LAUNCHES = 0
#: the same launches by kernel: ``warp`` (npad <= 64) and ``cta``
LAUNCHES_BY_PATH = {"warp": 0, "cta": 0}
# launches recorded into the CUDA graph this thread is capturing, by path
# (per thread: the mesh's host threads capture at the same time); the
# graph adds them to the counts above on every replay
# (``solver/graphs.py``), so a count is a launch the card ran
_captured = threading.local()

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_SRC = os.path.join(_CSRC, "lu32p.cu")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
# -cudart shared: the library uses the process's libcudart (PyTorch's), so
# torch.profiler sees its launches
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-cudart", "shared",
               "-Xptxas", "-v"]

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None
#: what the last build printed (``-Xptxas -v``: registers, shared memory)
#: and how long it took, for ``chip_smoke.py``
BUILD_INFO = {}


def captured_by_path():
    """This thread's capture tally, ``{"warp": n, "cta": n}``: the
    launches recorded into the graph being captured (``graphs.Program``
    sets it to 0 before a capture and reads it after)."""
    tally = getattr(_captured, "value", None)
    if tally is None:
        tally = _captured.value = {"warp": 0, "cta": 0}
    return tally


def padded_n(n):
    """Padded size: next multiple of ``_BLOCK``.  The pad block is
    identity: pad columns pivot on their own diagonal 1 and never cross the
    boundary, so the pad adds no fill-in."""
    return max(_BLOCK, -(-n // _BLOCK) * _BLOCK)


def cta_threads(npad):
    """Threads per CTA of the CTA kernel: 128 up to npad
    :data:`PANEL_WARP_NPAD_MAX` (one warp factors each panel, three update),
    256 above (one panel row per thread)."""
    return 128 if npad <= PANEL_WARP_NPAD_MAX else 256


def launch_config(batch, npad):
    """The kernel that npad selects and its launch: ``path`` (``"warp"`` or
    ``"cta"``), ``grid``, ``block`` (threads) and ``smem`` (dynamic shared
    bytes).  The warp kernel gives each warp (one lane matrix) an npad x
    (npad + 4) float tile and two pivot-row buffers; the CTA kernel gives
    each lane matrix an npad x npad tile, a panel's 32-int list of row
    moves and a few buffers of the panel's steps, which caps npad at
    :data:`CTA_NPAD_MAX`.  The C
    entry point checks the configuration against the kernel that npad
    selects there."""
    if npad <= WARP_NPAD_MAX:
        return {"path": "warp", "grid": -(-batch // WARPS_PER_CTA),
                "block": 32 * WARPS_PER_CTA,
                "smem": WARPS_PER_CTA * (npad * (npad + 4) + 2 * npad) * 4}
    # the tile, the moves, and two pivot-row buffers (npad <= 128) or two
    # sets of 12-float candidate slots per warp and two exchanged rows
    extra = 2 * _BLOCK if npad <= PANEL_WARP_NPAD_MAX else (
        2 * 12 * cta_threads(npad) // 32 + 2 * _BLOCK)
    smem = (npad * npad + 4 * _BLOCK + extra) * 4
    if npad > CTA_NPAD_MAX:
        raise ValueError(
            f"npad={npad}: the lu32p kernel takes npad <= {CTA_NPAD_MAX}; its "
            f"{smem}-byte tile would exceed the {_SMEM_LIMIT}-byte shared "
            f"memory of one block (linsolve='lu' takes any n)")
    return {"path": "cta", "grid": batch, "block": cta_threads(npad),
            "smem": smem}


def _nvcc():
    # the build runs at the library's first load, outside any step
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"  # brlint: disable=env-read-in-trace
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the lu32p kernel cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def _sources():
    """Every file under ``csrc/`` that the build reads."""
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh")))


def library_path():
    """Build target named by a content hash of the CUDA sources."""
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"liblu32p-{h.hexdigest()[:12]}.so")


def load_library():
    """Build (once, at first use) and load the kernel library; an entered
    ``obs.CompileWatch`` counts the build, or the load from the build
    cache."""
    from ..obs import retrace

    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            # build to a temp name and rename: the hash-named target is
            # trusted by existence alone
            tmp = f"{so}.build{os.getpid()}"
            t0 = time.perf_counter()
            proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", tmp, _SRC],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {_SRC}:\n{proc.stderr}")
            os.replace(tmp, so)
            BUILD_INFO.update(seconds=time.perf_counter() - t0,
                              log=proc.stderr)
            retrace.dispatch("compile", step="nvcc",
                             seconds=BUILD_INFO["seconds"])
        else:
            retrace.dispatch("cache_hit")
        lib = ctypes.CDLL(so)
        # (M, LU, piv, batch, n, npad, grid, block, smem, stream)
        lib.lu32p_factor.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.lu32p_factor.restype = ctypes.c_int
        lib.lu32p_error_string.argtypes = [ctypes.c_int]
        lib.lu32p_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _pad_identity(A, npad):
    """(B, n, n) -> (B, npad, npad) float32 with an identity pad block."""
    B, n = A.shape[0], A.shape[-1]
    Ap = torch.eye(npad, dtype=torch.float32, device=A.device).repeat(B, 1, 1)
    Ap[:, :n, :n] = A.to(torch.float32)
    return Ap


def lu32p_factor_plain(A):
    """Plain PyTorch version of the kernel, step for step the Pallas
    algorithm: per 8-column panel a masked-argmax pivot search with row
    swaps inside the panel, the singular-pivot guard, the panel's swaps
    applied to the off-panel columns (delayed ``laswp``), the unit-lower
    TRSM for the U12 strip, and the trailing update A22 -= L21 @ U12 in
    float32."""
    B, n = A.shape[0], A.shape[-1]
    npad = padded_n(n)
    dev = A.device
    LU = _pad_identity(A, npad)
    piv = torch.zeros((B, npad), dtype=torch.int32, device=dev)
    lanes = torch.arange(B, device=dev)
    ridx = torch.arange(npad, device=dev)
    cidx = torch.arange(npad, device=dev)
    bcol = torch.arange(_BLOCK, device=dev)
    r_small = torch.arange(_BLOCK, device=dev)
    neg_inf = torch.tensor(-float("inf"), dtype=torch.float32, device=dev)
    for ps in range(0, npad, _BLOCK):
        pe = ps + _BLOCK
        P = LU[:, :, ps:pe].clone()                      # (B, npad, 8)
        for j in range(_BLOCK):
            k = ps + j
            cand = torch.where(ridx >= k, torch.abs(P[:, :, j]), neg_inf)
            p = torch.argmax(cand, dim=1)                # (B,)
            row_k = P[:, k, :].clone()
            row_p = P[lanes, p, :].clone()
            P[:, k, :] = row_p
            P[lanes, p, :] = row_k       # p == k: row_k equals row_p
            col = P[:, :, j]
            pivot = P[:, k, j]
            safe = torch.where(torch.abs(pivot) > 0, pivot, 1.0)
            factor = torch.where(ridx > k, col / safe[:, None], 0.0)
            row_masked = torch.where(bcol > j, P[:, k, :], 0.0)
            P = P - factor[:, :, None] * row_masked[:, None, :]
            P[:, :, j] = torch.where(ridx > k, factor, P[:, :, j])
            piv[:, k] = p.to(torch.int32)
        LU[:, :, ps:pe] = P
        off_panel = (cidx < ps) | (cidx >= pe)
        for j in range(_BLOCK):
            k = ps + j
            p = piv[:, k].long()
            rk = LU[:, k, :].clone()
            rp = LU[lanes, p, :].clone()
            LU[:, k, :] = torch.where(off_panel, rp, rk)
            LU[lanes, p, :] = torch.where(off_panel, rk, rp)
        if pe < npad:
            L11 = P[:, ps:pe, :]                         # (B, 8, 8)
            T = LU[:, ps:pe, pe:].clone()                # (B, 8, W)
            for j in range(_BLOCK):
                lcol = torch.where(r_small > j, L11[:, :, j], 0.0)
                T = T - lcol[:, :, None] * T[:, j:j + 1, :]
            LU[:, ps:pe, pe:] = T
            L21 = P[:, pe:, :]                           # (B, npad-pe, 8)
            LU[:, pe:, pe:] = LU[:, pe:, pe:] - torch.matmul(L21, T)
    return LU, piv


def lu32p_factor(A):
    """Blocked, partially pivoted float32 LU of a lane batch A (B, n, n).

    A CPU tensor goes through :func:`lu32p_factor_plain`; a CUDA tensor
    (float64, the Newton matrix's dtype) launches the Hopper kernel or
    raises.  Both go through the operator ``brtorch::lu32p_factor``
    (:data:`OP`), so an op log, ``torch.profiler`` and a captured graph
    name the kernel on either device (the contract ``bdf-step-lu32p``)."""
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"lu32p_factor needs (B, n, n), got {tuple(A.shape)}")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lu32p_factor runs on cpu or cuda, not {A.device}")
    if A.device.type == "cuda" and A.dtype != torch.float64:
        raise TypeError(f"the lu32p kernel takes float64, not {A.dtype}")
    return OP(A)


@torch.library.custom_op("brtorch::lu32p_factor", mutates_args=(),
                         device_types="cpu")
def OP(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The operator behind :func:`lu32p_factor` (which validates its
    input): the plain version on the CPU, the kernel on CUDA."""
    return lu32p_factor_plain(A)


@OP.register_kernel("cuda")
def _lu32p_launch(A):
    """Launch the kernel that npad selects on A's current stream; inside a
    capture, count the launch for the graph's tally instead."""
    B, n = A.shape[0], A.shape[-1]
    npad = padded_n(n)
    cfg = launch_config(B, npad)
    LU = torch.empty((B, npad, npad), dtype=torch.float32, device=A.device)
    piv = torch.empty((B, npad), dtype=torch.int32, device=A.device)
    if B == 0:
        return LU, piv
    A = A.contiguous()
    lib = load_library()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        if torch.cuda.is_current_stream_capturing():
            captured_by_path()[cfg["path"]] += 1
        else:
            add_launches({cfg["path"]: 1})
        err = lib.lu32p_factor(A.data_ptr(), LU.data_ptr(), piv.data_ptr(),
                               B, n, npad, cfg["grid"], cfg["block"],
                               cfg["smem"], stream)
    if err != 0:
        raise RuntimeError("lu32p kernel launch failed: "
                           + lib.lu32p_error_string(err).decode())
    return LU, piv


def add_launches(by_path):
    """Count kernel launches, ``{path: launches}``: one where the wrapper
    launches, a captured graph's tally where the graph is replayed (the
    mesh's host threads replay at the same time, hence the lock)."""
    global LAUNCHES
    with _count_lock:
        for path, k in by_path.items():
            LAUNCHES += k
            LAUNCHES_BY_PATH[path] += k


def lu32p_solve(lu_piv, b):
    """Solve with :func:`lu32p_factor` output: b (B, n) -> x (B, n), or P
    right-hand sides b (B, P, n) -> x (B, P, n), float32.  b is padded
    with zeros to (B, npad, P) columns (pad rows solve to exact 0 against
    the identity block) and the substitution runs once on the padded
    float32 factor with the pivots made 1-based."""
    LU, piv = lu_piv
    npad = LU.shape[-1]
    n = b.shape[-1]
    cols = b[..., None] if b.ndim == 2 else b.transpose(-1, -2)
    bp = torch.zeros((cols.shape[0], npad, cols.shape[-1]),
                     dtype=torch.float32, device=b.device)
    bp[:, :n] = cols.to(torch.float32)
    x = torch.linalg.lu_solve(LU, piv + 1, bp)[:, :n]
    return x[..., 0] if b.ndim == 2 else x.transpose(-1, -2)


def permute_rows(A, piv):
    """P A for LAPACK-style 0-based ``piv`` (the row exchanges in order)."""
    A = A.clone()
    lanes = torch.arange(A.shape[0], device=A.device)
    for k in range(piv.shape[1]):
        p = piv[:, k].long()
        rk = A[:, k, :].clone()
        A[:, k, :] = A[lanes, p, :]
        A[lanes, p, :] = rk
    return A


def lu32p_backward_error(A, LU, piv):
    """Componentwise backward error of an :func:`lu32p_factor` output for A
    (B, n, n): per lane, the largest (|PA - LU|_ij - n FLT_MIN)+ /
    (|L||U|)_ij over the padded float32 matrix the factor was taken of
    (in float64), and the largest |L|.

    Any float32 LU with partial pivoting meets |PA - LU| <= gamma_n |L||U|
    entry by entry (gamma_n ~ n eps32, and n FLT_MIN covers entries that
    underflow) with |L| <= 1.  Entry by entry, the bound holds the small
    rows of a matrix to their own scale (the gas rows of a coupled Newton
    matrix, beside coverage rows ten decades larger), where a bound scaled
    by the largest entry of the lane or of the row would not."""
    npad = LU.shape[-1]
    Ap = _pad_identity(A, npad).double()
    LUd = LU.double()
    L = torch.tril(LUd, -1) + torch.eye(npad, dtype=torch.float64,
                                        device=A.device)
    U = torch.triu(LUd)
    E = (permute_rows(Ap, piv) - L @ U).abs()
    E = (E - npad * torch.finfo(torch.float32).tiny).clamp_min(0.0)
    LLU = L.abs() @ U.abs()
    ratio = torch.where(E > 0, E / LLU, torch.zeros_like(E))
    return ratio.amax(dim=(1, 2)), torch.tril(LUd, -1).abs().amax(dim=(1, 2))
