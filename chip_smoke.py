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
kernel (both paths of ``lu32p``) with its launches on the main path, its
error against the plain version and its times; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

Kernel times are CUDA-event times of launches queued behind a sleep kernel
(so the host's enqueue never starves the card), rotating over enough input
and output buffers that one round exceeds the 50 MB L2 (the cold time, the
one of record) or reusing one input (the hot time: the main path writes the
Newton matrix just before it factors it).

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
L2_BYTES = 50e6
EPS32 = float(np.finfo(np.float32).eps)
# the highest SM clock of the card (H100 SXM: 1980 MHz), to size the sleep
# kernel that queued launches wait behind
MAX_CLOCK_HZ = 1.98e9


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


def queued_time(fns, rounds, must_queue=True):
    """Mean milliseconds per call of ``fns`` called in turn, ``rounds``
    times, by CUDA events, and whether the card ran them back to back.  The
    calls are enqueued while a sleep kernel holds the stream, so the card
    runs them back to back however long the host takes to launch them,
    unless a call waits for the card (then the time includes the host's
    gaps: an error when ``must_queue``).  Each call's outputs stay alive for
    one round, so a round's outputs occupy distinct buffers."""
    import torch

    outs = [f() for f in fns]                     # warm-up, and host time
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [f() for f in fns]
    enqueue_s = (time.perf_counter() - t0) * rounds
    torch.cuda.synchronize()
    sleep_s = 3.0 * enqueue_s + 1e-3
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(sleep_s * MAX_CLOCK_HZ))
    t0 = time.perf_counter()
    start.record()
    for _ in range(rounds):
        for i, f in enumerate(fns):
            outs[i] = f()
    stop.record()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    queued = host_s < sleep_s
    if must_queue and not queued:
        raise RuntimeError(f"the host took {host_s:.4f} s to enqueue, longer "
                           f"than the {sleep_s:.4f} s sleep: the card waited")
    del outs
    return start.elapsed_time(stop) / (rounds * len(fns)), queued


def cold_hot_ms(fn, inputs, out_bytes, rounds=10, must_queue=True):
    """Cold and hot milliseconds of ``fn``, the number of input copies, and
    whether both timings ran queued: cold rotates over enough copies of
    ``inputs`` that one round moves more than three L2s (inputs read,
    ``out_bytes`` written per call); hot repeats the first copy."""
    moved = sum(t.numel() * t.element_size() for t in inputs) + out_bytes
    sets = max(2, -(-int(3 * L2_BYTES) // moved))
    copies = [tuple(t.clone() for t in inputs) for _ in range(sets)]
    cold, q1 = queued_time([lambda c=c: fn(*c) for c in copies], rounds,
                           must_queue)
    hot, q2 = queued_time([lambda: fn(*copies[0])], rounds * sets,
                          must_queue)
    return cold, hot, sets, q1 and q2


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


def tie_matrix():
    """n = 9: step 0 exchanges rows 0 and 5 with zero multipliers, and step
    1 finds |1| in row 3 and in original row 0 (now at position 5): the
    first in the current order, position 3, must win."""
    A = 0.5 * np.eye(9)
    A[:, 0] = 0.0
    A[:, 1] = 0.0
    A[5, 0], A[0, 1], A[3, 1] = 10.0, 1.0, -1.0
    A[0, 0] = A[1, 1] = A[5, 5] = 0.0
    return A, [5, 3, 2, 5, 4, 5, 6, 7, 8]


def nan_matrix():
    """n = 9: a NaN in column 0 wins the pivot, and the guard divides by
    1.0, not by the NaN, so later columns stay finite."""
    A = 2.0 * np.eye(9)
    A[4, 0], A[7, 0] = np.nan, 5.0
    return A, [4, 1, 2, 3, 7, 5, 6, 7, 8]


def check_kernel(device, batches=(1, 1024, 4096),
                 sizes=(1, 9, 13, 53, 64, 65, 120, 240)):
    """Phase 2: both paths of the lu32p kernel against its plain version on
    the card, and the contract cases."""
    import torch

    from batchreactor_tpu_torch.solver import linalg_cuda as lc

    gen = torch.Generator().manual_seed(0)
    cases = []
    for B in batches:
        for n in sizes:
            tol = 64 * n * EPS32
            path = lc.launch_config(B, lc.padded_n(n))["path"]
            # well-separated pivots: pivots equal, LU equal to roundoff
            A = separated(B, n, gen, device)
            LU_k, piv_k = lc.lu32p_factor(A)
            LU_p, piv_p = lc.lu32p_factor_plain(A)
            torch.cuda.synchronize()
            piv_ok = bool(torch.equal(piv_k, piv_p))
            scale = LU_p.abs().amax(dim=(1, 2), keepdim=True)
            lu_err = float(((LU_k - LU_p).abs() / scale).max())
            del A, LU_k, LU_p
            # general random matrices: backward error on every lane, solve
            # error against cond(A) eps on the first 1024 (cond takes an SVD
            # per lane)
            G = torch.randn((B, n, n), generator=gen,
                            dtype=torch.float64).to(device)
            b = torch.randn((B, n), generator=gen,
                            dtype=torch.float64).to(device)
            fac = lc.lu32p_factor(G)
            bwd = float(backward_error(G, *fac).max())
            m = min(B, 1024)
            x = lc.lu32p_solve((fac[0][:m], fac[1][:m]), b[:m]).double()
            x_ref = torch.linalg.solve(G[:m], b[:m])
            rel = ((x - x_ref).abs().amax(dim=1)
                   / x_ref.abs().amax(dim=1))
            cond = torch.linalg.cond(G[:m])
            solve_ok = bool(torch.all(rel <= 4 * n * cond * EPS32))
            del G, fac
            ok = piv_ok and lu_err <= tol and bwd <= tol and solve_ok
            cases.append({"B": B, "n": n, "path": path, "piv_equal": piv_ok,
                          "lu_rel_err": lu_err, "backward_err": bwd,
                          "tol": tol, "solve_ok": solve_ok,
                          "solve_lanes": m})
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
    order = {}
    for name, (A, want) in (("exact_tie", tie_matrix()),
                            ("nan_pivot", nan_matrix())):
        At = torch.tensor(A[None], device=device)
        LU_k, piv_k = lc.lu32p_factor(At)
        LU_p, piv_p = lc.lu32p_factor_plain(At)
        same_nan = bool(torch.equal(torch.isnan(LU_k), torch.isnan(LU_p)))
        fin = torch.isfinite(LU_p)
        lu_err = float((LU_k[fin] - LU_p[fin]).abs().max())
        order[name] = {"piv": piv_k[0, :9].tolist(),
                       "piv_equal_plain": bool(torch.equal(piv_k, piv_p)),
                       "piv_as_expected": piv_k[0, :9].tolist() == want,
                       "nan_pattern_equal": same_nan, "lu_max_abs_err": lu_err}
    order_ok = all(c["piv_equal_plain"] and c["piv_as_expected"]
                   and c["nan_pattern_equal"] and c["lu_max_abs_err"] <= 1e-6
                   for c in order.values())
    if not (pivot_ok and singular_ok and pad_ok and order_ok):
        raise AssertionError(f"lu32p contract cases: pivoting={pivot_ok} "
                             f"singular={singular_ok} pad={pad_ok} "
                             f"order={order}")
    emit({"phase": "kernel", "cases": cases, "pivoting_required": pivot_ok,
          "singular_guard": singular_ok, "pad_never_pivots": pad_ok,
          "pivot_order": order})


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
    """One shape: the kernel's error against its plain version on M, its
    cold and hot times, the plain version's, the library call's
    (``torch.linalg.lu_factor_ex`` on the padded float32 matrices) and the
    bound for these inputs."""
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
            f"lu32p at {B}x{n}: {int((~same).sum())} lanes with other "
            f"pivots, max_abs_err {max_abs_err}, backward {bwd}")
    del LU_k, LU_p
    out_bytes = B * npad * npad * 4 + B * npad * 4
    ms, hot_ms, sets, _ = cold_hot_ms(lc.lu32p_factor, (M,), out_bytes)
    plain_ms = cuda_time(lambda: lc.lu32p_factor_plain(M), reps=3, warmup=1)
    # the library call may wait for the card inside a call: then its time
    # includes the host's gaps, and library_queued says so
    library_ms, _, _, library_queued = cold_hot_ms(
        lambda A: torch.linalg.lu_factor_ex(A), (lc._pad_identity(M, npad),),
        out_bytes, rounds=4, must_queue=False)
    bytes_moved = B * n * n * 8 + out_bytes
    flops = B * 2.0 / 3.0 * npad ** 3
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, flops / PEAK_F32
    bound_ms = max(t_bytes, t_ops) * 1e3
    return {"shape": [B, n], "npad": npad,
            "path": lc.launch_config(B, npad)["path"],
            "max_abs_err": max_abs_err, "backward_err": bwd, "ms": ms,
            "hot_ms": hot_ms, "l2_rotation_sets": sets, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_queued": library_queued,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "share_of_bound": bound_ms / ms, "bytes": bytes_moved,
            "flops": flops}


def sweep(bt, gm, th, T, device, **kw):
    return bt.batch_reactor_sweep(
        COMP, T, 1e5, T1, chem=bt.Chemistry(gaschem=True), thermo_obj=th,
        md=gm, rtol=RTOL, atol=ATOL, method="bdf", jac_window=8,
        setup_economy=True, ignition_marker="CH4", segment_steps=256,
        device=device, **kw)


def profile_main_path(bt, gm, th, T, device, warm_wall, factor_event_ms):
    """Where the main path's time goes: the sweep under torch.profiler,
    with the port's layers labelled by ``record_function`` ranges (RHS,
    Jacobian, lu32p factor, Newton solve, whole segment), the device's busy
    share, and the kernels that take the most device time.

    A layer's ``host_ms`` is the host time inside its ranges and its
    ``device_ms`` the kernel time launched from them.  The profiler links a
    kernel launched through ctypes to no PyTorch op, so the ``lu32p``
    kernels (launched only by the factor layer) are added to that layer by
    name, and their profiled time is set beside ``factor_event_ms``, the
    same launches timed with CUDA events (launches x hot time).  The idle
    share is given against the profiled wall and against ``warm_wall``, the
    same sweep's wall without the profiler (its tracing slows the host)."""
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
    lu_ms = sum(m for m, _, name in kernels if "lu32p_" in name)
    lu_calls = sum(c for _, c, name in kernels if "lu32p_" in name)
    if "factor" in layers:
        layers["factor"]["device_ms"] += lu_ms
    busy_s = sum(k[0] for k in kernels) / 1e3
    if busy_s <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return {"wall_s": wall, "warm_wall_s": warm_wall,
            "device_busy_ms": busy_s * 1e3,
            "idle_share": 1.0 - busy_s / wall,
            "idle_share_unprofiled": 1.0 - busy_s / warm_wall,
            "kernel_launches": sum(k[1] for k in kernels), "layers": layers,
            "lu32p_profiled_ms": lu_ms, "lu32p_profiled_calls": lu_calls,
            "lu32p_event_ms": factor_event_ms,
            "lu32p_profiled_over_event": lu_ms / factor_event_ms,
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
             if any(w in ln for w in ("entry function", "registers",
                                      "spill"))]
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
    gen = torch.Generator().manual_seed(1)
    timing = {}
    for name, M in (("main", main_path_matrices(gm, th, device)),
                    ("main_b4096", main_path_matrices(gm, th, device, 4096)),
                    ("cta_n120", separated(B_MAIN, 120, gen, device))):
        timing[name] = time_kernel(M)
        del M
        emit({"phase": "kernel_timing", "case": name, "gpu": smi,
              **timing[name]})
    emit({"phase": "kernel_checked", "seconds": time.perf_counter() - t0})

    # ---- phase 3: the main path -----------------------------------------
    T = np.linspace(T_LO, T_HI, B_MAIN)
    t0 = time.perf_counter()
    sweep(bt, gm, th, T, device)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    lc.LAUNCHES = 0
    lc.LAUNCHES_BY_PATH.update(warp=0, cta=0)
    t0 = time.perf_counter()
    out = sweep(bt, gm, th, T, device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lc.LAUNCHES
    by_path = dict(lc.LAUNCHES_BY_PATH)
    tau = out["tau"]
    rep = out["report"]
    if out["linsolve"] != "lu32p":
        raise AssertionError(f"linsolve resolved to {out['linsolve']!r}")
    if launches <= 0 or by_path["warp"] != launches or by_path["cta"] != 0:
        raise AssertionError(f"the main path's lu32p launches by path: "
                             f"{by_path} of {launches}")
    if rep["counts"] != {"success": B_MAIN}:
        raise AssertionError(f"lanes not all successful: {rep['counts']}")
    if not np.all(np.isfinite(tau)):
        raise AssertionError(f"{int((~np.isfinite(tau)).sum())} lanes "
                             f"without a finite tau")
    hot_ms = timing["main"]["hot_ms"]
    emit({"phase": "main_path", "gpu": smi, "B": B_MAIN,
          "mechanism": "GRI-3.0 (53 species, 325 reactions)",
          "linsolve": out["linsolve"], "jac_window": out["jac_window"],
          "cold_s": cold_s, "wall_s": wall, "cond_per_s": B_MAIN / wall,
          "mean_accepted": rep["n_accepted"]["mean"],
          "max_accepted": rep["n_accepted"]["max"],
          "tau_min": float(tau.min()), "tau_max": float(tau.max()),
          "lu32p_launches": launches, "lu32p_launches_by_path": by_path,
          "kernel_share": launches * hot_ms / 1e3 / wall})

    if "--profile" in sys.argv[1:]:
        emit({"phase": "profile", "gpu": smi,
              **profile_main_path(bt, gm, th, T, device, wall,
                                  launches * hot_ms)})

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
    kernels = []
    for path, case in (("warp", "main"), ("cta", "cta_n120")):
        kt = timing[case]
        kernels.append({
            "name": f"lu32p_{path}", "route": "cuda",
            "source": "batchreactor_tpu_torch/csrc/lu32p.cu",
            "replaces": "batchreactor_tpu/solver/linalg_pallas.py:69",
            "launches": by_path[path], "on_main_path": path == "warp",
            "pass": True, "shape": kt["shape"],
            "max_abs_err": kt["max_abs_err"], "ms": kt["ms"],
            "hot_ms": kt["hot_ms"], "plain_ms": kt["plain_ms"],
            "bound_ms": kt["bound_ms"], "bound_by": kt["bound_by"],
            "share_of_bound": kt["share_of_bound"],
            "library_ms": kt["library_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
