"""On-card smoke run of the PyTorch/CUDA port (``batchreactor_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py            # add --profile for the time breakdown

It builds every kernel of the port's main path from the checkout's sources
(``csrc/lu32p.cu`` with ``nvcc`` into ``build/kernels/``), holds each kernel
against its plain PyTorch version on the card, drives the main path — the
GRI-3.0 isothermal ignition sweep, B = 1024 lanes — through the port's own
entry point, cross-checks it against the float64 ``lu`` mode, and runs the
file-driven entry point.  ``--profile`` adds a phase that runs the main
path once more under ``torch.profiler`` and prints where its time goes
(per layer and per kernel).  Each phase prints one JSON line; any failure
raises and the script exits non-zero.  The line before the last lists every
kernel with its launches on the main path, its error against the plain
version and its times; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Without a GPU, or without the package beside it, it exits non-zero and
prints no result.  It imports neither jax nor the JAX package.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "tests", "fixtures")

# the main path: bench.py's GRI-3.0 workload
B_MAIN = 1024
T_LO, T_HI, T1 = 1500.0, 2000.0, 8e-4
RTOL, ATOL = 1e-6, 1e-10
COMP = {"CH4": 0.25, "O2": 0.5, "N2": 0.25}
B_CROSS = 64

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bytes/s and
# float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
EPS32 = float(np.finfo(np.float32).eps)


def emit(obj):
    print(json.dumps(obj), flush=True)


def gpu_name_and_limit():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time(fn, reps, warmup=2):
    """Mean milliseconds per call, by CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def permute_rows(A, piv):
    """P A for LAPACK-style 0-based ipiv (sequential row exchanges)."""
    import torch

    A = A.clone()
    lanes = torch.arange(A.shape[0], device=A.device)
    for k in range(piv.shape[1]):
        p = piv[:, k].long()
        rk = A[:, k, :].clone()
        A[:, k, :] = A[lanes, p, :]
        A[lanes, p, :] = rk
    return A


def backward_error(A, LU, piv):
    """Per-lane max|PA - LU| / max|A| of the padded float64 system."""
    import torch

    from batchreactor_tpu_torch.solver.linalg_cuda import _pad_identity

    npad = LU.shape[-1]
    Ap = _pad_identity(A, npad).double()
    Ap[:, :A.shape[1], :A.shape[1]] = A.double()
    LUd = LU.double()
    eye = torch.eye(npad, dtype=torch.float64, device=A.device)
    L = torch.tril(LUd, -1) + eye
    U = torch.triu(LUd)
    err = (permute_rows(Ap, piv) - L @ U).abs().amax(dim=(1, 2))
    return err / Ap.abs().amax(dim=(1, 2))


def separated(B, n, gen, device):
    """Row-permuted strongly diagonally dominant matrices: every pivot is
    unique by a wide margin, so kernel and plain version must agree on it."""
    import torch

    diag = 10.0 + 10.0 * torch.rand((B, n), generator=gen, dtype=torch.float64)
    A = 0.1 * torch.randn((B, n, n), generator=gen, dtype=torch.float64)
    A = A + torch.diag_embed(diag)
    perm = torch.argsort(torch.rand((B, n), generator=gen), dim=1)
    return A[torch.arange(B)[:, None], perm].to(device)


def check_kernel(device, batches=(1, 1024, 4096), sizes=(9, 13, 53, 120)):
    """Phase 2: the lu32p kernel against its plain version on the card."""
    import torch

    from batchreactor_tpu_torch.solver import linalg_cuda as lc

    gen = torch.Generator().manual_seed(0)
    cases = []
    for B in batches:
        for n in sizes:
            tol = 64 * n * EPS32
            # well-separated pivots: pivots equal, LU equal to roundoff
            A = separated(B, n, gen, device)
            LU_k, piv_k = lc.lu32p_factor(A)
            LU_p, piv_p = lc.lu32p_factor_plain(A)
            torch.cuda.synchronize()
            piv_ok = bool(torch.equal(piv_k, piv_p))
            scale = LU_p.abs().amax(dim=(1, 2), keepdim=True)
            lu_err = float(((LU_k - LU_p).abs() / scale).max())
            # general random matrices: backward error and solve error
            G = torch.randn((B, n, n), generator=gen,
                            dtype=torch.float64).to(device)
            b = torch.randn((B, n), generator=gen,
                            dtype=torch.float64).to(device)
            fac = lc.lu32p_factor(G)
            bwd = float(backward_error(G, *fac).max())
            x = lc.lu32p_solve(fac, b).double()
            x_ref = torch.linalg.solve(G, b)
            rel = ((x - x_ref).abs().amax(dim=1)
                   / x_ref.abs().amax(dim=1))
            cond = torch.linalg.cond(G)
            solve_ok = bool(torch.all(rel <= 4 * n * cond * EPS32))
            ok = piv_ok and lu_err <= tol and bwd <= tol and solve_ok
            cases.append({"B": B, "n": n, "piv_equal": piv_ok,
                          "lu_rel_err": lu_err, "backward_err": bwd,
                          "tol": tol, "solve_ok": solve_ok})
            if not ok:
                emit({"phase": "kernel", "failed": cases[-1]})
                raise AssertionError(f"lu32p kernel disagrees: {cases[-1]}")
    # contract cases
    Z = torch.tensor([[[0.0, 1.0, 0.0], [2.0, 0.0, 1.0], [0.0, 3.0, 1.0]]],
                     dtype=torch.float64, device=device)
    bz = torch.tensor([[1.0, 2.0, 3.0]], dtype=torch.float64, device=device)
    xz = lc.lu32p_solve(lc.lu32p_factor(Z), bz).double()
    pivot_ok = bool(torch.allclose(xz, torch.linalg.solve(Z, bz), rtol=1e-5,
                                   atol=1e-5))
    S = torch.tensor([[[1.0, 2.0, 0.0], [3.0, 4.0, 0.0], [5.0, 6.0, 0.0]]],
                     dtype=torch.float64, device=device)
    fac_s = lc.lu32p_factor(S)
    xs = lc.lu32p_solve(fac_s, torch.ones((1, 3), dtype=torch.float64,
                                          device=device))
    singular_ok = bool(torch.all(torch.isfinite(fac_s[0]))
                       and not torch.all(torch.isfinite(xs)))
    P = separated(16, 53, gen, device)
    _, piv_pad = lc.lu32p_factor(P)
    pad_ok = bool(torch.all(piv_pad[:, :53] < 53)
                  and torch.equal(piv_pad[:, 53:].cpu(),
                                  torch.arange(53, 56, dtype=torch.int32)
                                  .expand(16, 3)))
    if not (pivot_ok and singular_ok and pad_ok):
        raise AssertionError(f"lu32p contract cases: pivoting={pivot_ok} "
                             f"singular={singular_ok} pad={pad_ok}")
    emit({"phase": "kernel", "cases": cases, "pivoting_required": pivot_ok,
          "singular_guard": singular_ok, "pad_never_pivots": pad_ok})


def main_path_matrices(gm, th, device, B=B_MAIN):
    """Newton iteration matrices M = I - c J at the main path's initial
    states (B = 1024, GRI-3.0), c = 1e-7 s: the kernel's inputs there."""
    import torch

    from batchreactor_tpu_torch.api import get_solution_vector
    from batchreactor_tpu_torch.ops.rhs import make_gas_jac

    sp = list(gm.species)
    x0 = np.zeros(len(sp))
    for k, v in COMP.items():
        x0[sp.index(k)] = v
    T = torch.linspace(T_LO, T_HI, B, dtype=torch.float64, device=device)
    y0 = get_solution_vector(np.broadcast_to(x0, (B, len(sp))),
                             th.molwt, T, 1e5)
    J = make_gas_jac(gm, th)(0.0, y0, {"T": T})
    eye = torch.eye(len(sp), dtype=torch.float64, device=device)
    return eye - 1e-7 * J


def time_kernel(M):
    """Times at the main-path shape, and the kernel's error against its
    plain version on the main path's own iteration matrices."""
    import torch

    from batchreactor_tpu_torch.solver import linalg_cuda as lc

    B, n = M.shape[0], M.shape[-1]
    npad = lc.padded_n(n)
    LU_k, piv_k = lc.lu32p_factor(M)
    LU_p, piv_p = lc.lu32p_factor_plain(M)
    torch.cuda.synchronize()
    same = (piv_k == piv_p).all(dim=1)
    max_abs_err = float((LU_k - LU_p)[same].abs().max())
    scale = float(LU_p[same].abs().max())
    bwd = float(backward_error(M, LU_k, piv_k).max())
    if not (bool(same.all()) and max_abs_err <= 64 * n * EPS32 * scale
            and bwd <= 64 * n * EPS32):
        raise AssertionError(
            f"lu32p on main-path matrices: {int((~same).sum())} lanes with "
            f"other pivots, max_abs_err {max_abs_err}, backward {bwd}")
    Mp = lc._pad_identity(M, npad)
    ms = cuda_time(lambda: lc.lu32p_factor(M), reps=50)
    plain_ms = cuda_time(lambda: lc.lu32p_factor_plain(M), reps=3, warmup=1)
    library_ms = cuda_time(lambda: torch.linalg.lu_factor_ex(Mp), reps=20)
    bytes_moved = B * n * n * 8 + B * npad * npad * 4 + B * npad * 4
    flops = B * 2.0 / 3.0 * npad ** 3
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, flops / PEAK_F32
    return {"max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "flops": flops}


def sweep(bt, gm, th, T, device, **kw):
    return bt.batch_reactor_sweep(
        COMP, T, 1e5, T1, chem=bt.Chemistry(gaschem=True), thermo_obj=th,
        md=gm, rtol=RTOL, atol=ATOL, method="bdf", jac_window=8,
        setup_economy=True, ignition_marker="CH4", segment_steps=256,
        device=device, **kw)


def profile_main_path(bt, gm, th, T, device, warm_wall):
    """Where the main path's time goes: the sweep under torch.profiler,
    with the port's layers labelled by ``record_function`` ranges (RHS,
    Jacobian, lu32p factor, Newton solve, whole segment), the device's busy
    share, and the kernels that take the most device time.

    A layer's ``host_ms`` is the host time inside its ranges and its
    ``device_ms`` the kernel time launched from them.  The idle share is
    given against the profiled wall and against ``warm_wall``, the same
    sweep's wall without the profiler (its tracing slows the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from batchreactor_tpu_torch import api
    from batchreactor_tpu_torch.solver import bdf

    def labelled(name, fn):
        def wrap(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return wrap

    def labelled_builder(name, build):
        return lambda *a, **k: labelled(name, build(*a, **k))

    patches = [(api, "make_gas_rhs", labelled_builder("layer:rhs",
                                                      api.make_gas_rhs)),
               (api, "make_gas_jac", labelled_builder("layer:jacobian",
                                                      api.make_gas_jac)),
               (bdf, "factor_m", labelled("layer:factor", bdf.factor_m)),
               (bdf, "apply_factor", labelled("layer:solve",
                                              bdf.apply_factor)),
               (bdf, "solve", labelled("layer:segment", bdf.solve))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sweep(bt, gm, th, T, device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    events = prof.key_averages()
    layers = {}
    kernels = []
    for ev in events:
        if ev.key.startswith("layer:"):
            # each range also appears as a device-side annotation whose
            # time is a span, not kernel time: keep the host-side entry
            if "CPU" in str(ev.device_type):
                layers[ev.key[6:]] = {
                    "calls": ev.count,
                    "host_ms": ev.cpu_time_total / 1e3,
                    "device_ms": ev.device_time_total / 1e3}
        elif ev.self_device_time_total > 0 and not \
                ev.key.startswith("aten::"):
            kernels.append((ev.self_device_time_total / 1e3,
                            ev.count, ev.key[:90]))
    kernels.sort(reverse=True)
    busy_s = sum(k[0] for k in kernels) / 1e3
    if busy_s <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return {"wall_s": wall, "warm_wall_s": warm_wall,
            "device_busy_ms": busy_s * 1e3,
            "idle_share": 1.0 - busy_s / wall,
            "idle_share_unprofiled": 1.0 - busy_s / warm_wall,
            "kernel_launches": sum(k[1] for k in kernels), "layers": layers,
            "top_kernels": [{"ms": m, "calls": c, "name": n}
                            for m, c, n in kernels[:12]]}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import batchreactor_tpu_torch as bt
    from batchreactor_tpu_torch.solver import linalg_cuda as lc

    device = torch.device("cuda")
    smi = gpu_name_and_limit()
    print(smi, flush=True)

    # ---- phase 1: environment and kernel build --------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lc.load_library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in lc.BUILD_INFO.get("log", "").splitlines()
             if "registers" in ln or "smem" in ln]
    emit({"phase": "env", "gpu": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "build_s": build_s, "ptxas": ptxas,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    # ---- phase 2: the kernel against its plain version ------------------
    t0 = time.perf_counter()
    check_kernel(device)
    gm = bt.compile_gaschemistry(os.path.join(FIXTURES, "grimech.dat"))
    th = bt.create_thermo(list(gm.species),
                          os.path.join(FIXTURES, "therm.dat"))
    kt = time_kernel(main_path_matrices(gm, th, device))
    emit({"phase": "kernel_timing", "shape": [B_MAIN, gm.n_species],
          "gpu": smi, **kt, "seconds": time.perf_counter() - t0})

    # ---- phase 3: the main path -----------------------------------------
    T = np.linspace(T_LO, T_HI, B_MAIN)
    t0 = time.perf_counter()
    sweep(bt, gm, th, T, device)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    lc.LAUNCHES = 0
    t0 = time.perf_counter()
    out = sweep(bt, gm, th, T, device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lc.LAUNCHES
    tau = out["tau"]
    rep = out["report"]
    if out["linsolve"] != "lu32p":
        raise AssertionError(f"linsolve resolved to {out['linsolve']!r}")
    if launches <= 0:
        raise AssertionError("the main path launched no lu32p kernel")
    if rep["counts"] != {"success": B_MAIN}:
        raise AssertionError(f"lanes not all successful: {rep['counts']}")
    if not np.all(np.isfinite(tau)):
        raise AssertionError(f"{int((~np.isfinite(tau)).sum())} lanes "
                             f"without a finite tau")
    emit({"phase": "main_path", "gpu": smi, "B": B_MAIN,
          "mechanism": "GRI-3.0 (53 species, 325 reactions)",
          "linsolve": out["linsolve"], "jac_window": out["jac_window"],
          "cold_s": cold_s, "wall_s": wall, "cond_per_s": B_MAIN / wall,
          "mean_accepted": rep["n_accepted"]["mean"],
          "max_accepted": rep["n_accepted"]["max"],
          "tau_min": float(tau.min()), "tau_max": float(tau.max()),
          "lu32p_launches": launches,
          "kernel_share": launches * kt["ms"] / 1e3 / wall})

    if "--profile" in sys.argv[1:]:
        emit({"phase": "profile", "gpu": smi,
              **profile_main_path(bt, gm, th, T, device, wall)})

    # ---- phase 4: cross-check against the float64 lu mode ---------------
    t0 = time.perf_counter()
    ref = sweep(bt, gm, th, T[:B_CROSS], device, linsolve="lu")
    rel = np.abs(tau[:B_CROSS] / ref["tau"] - 1.0)
    if ref["linsolve"] != "lu" or not np.all(rel <= 1e-3):
        raise AssertionError(f"tau lu32p vs lu: max rel {rel.max()}")
    emit({"phase": "cross_check", "lanes": B_CROSS, "tau_max_rel": float(
        rel.max()), "tau_mean_rel": float(rel.mean()),
        "seconds": time.perf_counter() - t0})

    # ---- phase 5: the file-driven entry point ---------------------------
    with tempfile.TemporaryDirectory() as tmp:
        xml = os.path.join(tmp, "batch.xml")
        with open(xml, "w") as f:
            f.write("<batch><gas_mech>h2o2.dat</gas_mech>"
                    "<molefractions>H2=0.25,O2=0.25,N2=0.5</molefractions>"
                    "<T>1173.0</T><p>1e5</p><time>10.0</time></batch>")
        t0 = time.perf_counter()
        status = bt.batch_reactor(xml, FIXTURES, gaschem=True, verbose=False)
        with open(os.path.join(tmp, "gas_profile.csv")) as f:
            lines = f.read().splitlines()
    row = dict(zip(lines[0].split(","), map(float, lines[-1].split(","))))
    if status != "Success" or abs(row["H2O"] - 2 / 7) > 1e-4 or abs(
            row["O2"] - 1 / 7) > 1e-4:
        raise AssertionError(f"file-driven h2o2: {status} {row}")
    emit({"phase": "file_driven", "status": status, "t_end": row["t"],
          "x_H2O": row["H2O"], "x_O2": row["O2"], "rows": len(lines) - 1,
          "seconds": time.perf_counter() - t0})

    print(smi, flush=True)
    emit({"kernels": [{
        "name": "lu32p", "route": "cuda",
        "source": "batchreactor_tpu_torch/csrc/lu32p.cu",
        "replaces": "batchreactor_tpu/solver/linalg_pallas.py:69",
        "launches": launches, "pass": True,
        "max_abs_err": kt["max_abs_err"], "ms": kt["ms"],
        "plain_ms": kt["plain_ms"], "bound_ms": kt["bound_ms"],
        "bound_by": kt["bound_by"], "library_ms": kt["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
