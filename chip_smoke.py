"""On-card smoke run of the PyTorch/CUDA port (``batchreactor_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py            # add --profile for the time breakdown
    python3 chip_smoke.py --profile-only   # only the breakdown, both gears

It builds every kernel of the port's paths from the checkout's sources
(``csrc/lu32p.cu`` with ``nvcc`` into ``build/kernels/``), holds each kernel
against its plain PyTorch version on the card (phase 2: random matrices,
n = 1..240 across both paths, the contract cases on both, and each path's
own Newton matrices, the coupled path's, the energy path's and the padded
gas path's at three step sizes, with the coupled ones' condition numbers;
the CTA path timed at n = 66, 96, 120, 176 and 240), and drives the port's
paths through its own entry points:

- the gas main path, the GRI-3.0 isothermal ignition sweep at B = 1024
  lanes (the kernel's warp path), its float64 ``lu`` cross-check, and the
  file-driven h2o2 run (phases 3-5);
- the coupled GRI-3.0 + CH4/Ni sweep at B = 1024 lanes, T x Asv, over the
  reference's 10 s horizon (float64 ``lu``), then the same sweep with
  ``linsolve="lu32p"`` over its first millisecond (the kernel's CTA path:
  n = 66, npad 72) against ``lu`` (phases 6-7);
- the surface-only CH4/Ni sweep at B = 2048, the user-defined-chemistry
  sweep at B = 4096 (the warp path) and the file-driven surface run
  (phases 8-10);
- the energy path, a GRI-3.0 phi x T ignition-delay sweep of CH4 in air
  at B = 1024 lanes, adiabatic at constant volume (53 species + T, the
  kernel's warp path, npad 56), with its energy conservation against a
  bound from the JAX package on the CPU (phase 11); its first 64 lanes
  with the float64 ``lu`` and at constant pressure (phase 12);
- SDIRK4 on the main path's conditions at B = 256 (``inv32``) against
  phase 3's BDF delays, and one ``temperature_sweep`` (phase 13);
- below the ``lu32p`` gate (B = 256): BDF through the monolithic
  ``ensemble_solve`` with every Newton mode (``lu``, ``inv32``,
  ``inv32nr``, ``inv32f``, ``lu32p``) and with ``lu32p`` under
  ``freeze_precond``, an A/B with no assertion on speed (phase 14);
- the gas main path with GRI-3.0 padded to 96 species and 512 reactions
  (``species_buckets``/``reaction_buckets``: the kernel's CTA path, npad
  96) against phase 3's delays (phase 15);
- forward sensitivities, ``ensemble_solve_forward`` on 640 lanes of
  phase 3's temperature range over ln A of the 18 ``*CH4*`` reactions
  (every tangent solve through the warp kernel's factor) against a
  plain twin and a float64 ``lu`` run, with the peak device memory
  (phase 16);
- the adjoint ranking of all 325 reactions by d ln tau / d ln A on 8
  lanes (``inv32``), lane 0 against the JAX package on the CPU
  (``scripts/sens_reference.py``), and on 4 lanes at rtol 1e-8 the
  adjoint gradient against the forward tangents (phase 17);
- the two gears of the segmented driver on the main path (phase 18): the
  blocking gear and the pipelined gear (CUDA graphs of fixed-trip step
  windows, the default of every segmented phase above) at poll_every 1
  and 4, cold and warm, every lane equal to the bit, with host syncs,
  graph replays and Newton iterations; then the gears against each other
  on 64 lanes each of the coupled, energy and SDIRK4 paths;
- continuous batching (phase 19): 4096 main-path temperatures streamed
  through 1024 resident slots on the ladder (256, 512, 1024) against the
  admission-off sweep, then 1024 of them from 256 slots climbing the
  ladder;
- checkpointing and resilience (phase 20): ``checkpointed_sweep`` over
  phase 3's lanes in chunks of 256 (fresh, cold and warm, against phase
  3), a child process killed before saving chunk 2 and the resume here, a
  torn chunk, a hung wait under ``fetch_deadline`` with one retry, three
  NaN lanes under ``quarantine=True`` (each recovery equal to the fresh
  run bit for bit, the quarantine within 1e-3), and
  ``batch_reactor_sweep`` on a one-device mesh against ``mesh=None``;
- the multi-process tiers (phase 21): two child processes on the one card
  in a gloo group, ``ensemble_solve_multihost`` over phase 3's lanes
  against phase 3, then ``elastic_checkpointed_sweep`` with one process
  killed before its second chunk: the survivor takes it over and every
  chunk equals phase 20's bit for bit.

Every path is driven with the launch counts set to 0 just before it and
read just after; a CUDA graph adds its captured launches on every replay.
The child processes of phases 20-21 (``chip_smoke.py --child ARGS``) do
the same in their own process and report their counts.
``--profile`` adds a phase that runs the gas main path once more in each
gear under ``torch.profiler`` and prints where its time goes (per layer
and per kernel); ``--profile-only`` runs only that.  Each phase prints one JSON line; any failure
raises and the script exits non-zero.  The line before the last lists every
kernel (both paths of ``lu32p``) with its launches by path, its error
against the plain version and its times on its own path's matrices; the
last line is ``{"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": 1}}``.

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

# the coupled path: the reference's batch_gas_and_surf (GRI-3.0 with
# CH4/Ni, 10 s) widened to 256 temperatures x 4 catalyst loadings
N_T_COUPLED = 256
ASV_DECADES = (1.0, 10.0, 100.0, 1000.0)
T_LO_C, T_HI_C, T1_C = 1073.0, 1273.0, 10.0
# the horizon of the coupled sweep with linsolve="lu32p" (the CTA kernel)
T1_C_LU32P = 1e-3
# the surface path: the reference's batch_surf (CH4/Ni over 7 gas species,
# no gas mechanism, Asv = 10, 10 s) widened to 2048 temperatures
GAS7 = ["CH4", "H2O", "H2", "CO", "CO2", "O2", "N2"]
COMP7 = {"CH4": 0.25, "H2O": 0.25, "N2": 0.5}
B_SURF, T_LO_S, T_HI_S, T1_S = 2048, 1023.0, 1223.0, 10.0
# the user-defined path: first-order H2 decay on h2o2, 4096 temperatures
B_UDF, T_LO_U, T_HI_U, T1_U = 4096, 1000.0, 2000.0, 5.0
# the energy path: CH4 in air, phi x 256 temperatures in 1500-2000 K, 1 bar,
# adiabatic; the coolest, leanest lane ignites at 0.90 ms (the JAX package
# on the CPU), well before T1_E / 2
PHI_E = (0.5, 0.75, 1.0, 1.5)
N_T_E, T1_E = 256, 1e-2
# bounds on the energy drift |e(t1) - e(0)| / sum_k |Y_k e_k(0)| (phases 11
# and 12): ten times the largest drift of the JAX package's reference
# configuration on lanes of the same grid on the CPU, 5.918e-7 over 24
# lanes at constant volume and 4.348e-6 over the 64 lanes of phase 12 at
# constant pressure (python scripts/energy_drift_reference.py)
DRIFT_REF_V, DRIFT_REF_P = 5.918e-7, 4.348e-6
DRIFT_BOUND_V, DRIFT_BOUND_P = 10 * DRIFT_REF_V, 10 * DRIFT_REF_P
# the SDIRK path and the Newton-mode A/B: every 4th main-path temperature
SDIRK_STRIDE = 4
# the padded gas path (phase 15): GRI-3.0 padded to 96 species (the CTA
# path of lu32p, npad 96) and the pow2 rung of its 325 reactions
S_PAD, R_PAD = 96, 512
# the gear comparison (phase 18): the 64-lane checks take every 16th lane
# of the coupled, energy and main-path grids, over a shorter horizon
GEAR_STRIDE = 16
T1_E_GEARS, T1_SDIRK_GEARS = 1e-3, T1 / 4
# continuous batching (phase 19): 4096 main-path temperatures streamed
# through 1024 resident slots on a three-rung ladder; then the first 1024
# of them from 256 slots, free to climb to 1024.  Every main-path lane
# takes 247-305 attempts (the CPU run of the driver's configuration), so
# in segments of 256 every lane of a resident generation parks in the
# same segment and the drain tail never holds live lanes beside parked
# ones: a down-shift cannot fire.  In segments of 16, with the lanes in
# the order of a 4 x 1024 map (each generation spans the T range, as the
# rows of a phi x T map do), the tail is ragged.
B_STREAM, STREAM_RESIDENT, STREAM_REFILL = 4096, 1024, 0.25
STREAM_BUCKETS = (256, 512, 1024)
STREAM_SEGMENT = 16
# the streams poll the status every segment, so slots refill and the drain
# tail shifts down as soon as lanes park
STREAM_POLL = 1
CLIMB_LANES, CLIMB_RESIDENT, CLIMB_CEILING = 1024, 256, 1024
# the forward sensitivities (phase 16): 640 temperatures across the main
# path's range, cut from 1024 to keep the script under 1000 s;
# B * n stays above the lu32p gate (640 x 53 >= 32768)
B_SENS = 640
# the checkpointed main path (phases 20-21): chunks of 256 lanes; the hung
# wait of phase 20 (d) is held HANG_S s against a DEADLINE_S s deadline
CKPT_CHUNK = 256
DEADLINE_S, HANG_S = 5.0, 30.0
# the adjoint ranking (phase 17): every 128th main-path temperature (8
# lanes; the Python loop of stage solves, not the lanes, sets its wall);
# the forward-against-adjoint check runs every 16th of the 64 coolest
# temperatures to T1 / 4, before they ignite
SENS_LANES = 8
# lane 0 of phase 17 (1500 K) in the JAX package's reference configuration
# on the CPU (python scripts/sens_reference.py): d ln tau / d ln A_i of the
# CH4 half-crossing delay (tau 5.692e-4 s) for the 325 GRI-3.0 reactions in
# reaction order, to 4 significant digits; the card is held to 1e-2 of the
# largest, 0.4203 (HO2+CH3<=>OH+CH3O)
SENS_REF_LANE0_COEFFS = (
    2.343e-10, 1.073e-07, -0.00357, 0.007418, 0.0002244, 3.772e-09, 6.339e-06,
    1.189e-06, 3.155e-07, 0.02032, -0.02092, 1.816e-05, 0.0001127, 9.173e-05,
    -0.01318, 1.248e-06, 0.0001156, -0.001054, -0.0001769, 2.794e-09,
    -0.0001039, -3.931e-07, -5.019e-05, 1.961e-05, -0.0001345, 0.0003901,
    -0.007697, 9.95e-06, -1.419e-05, -5.332e-05, -9.897e-05, -0.1306,
    0.0003028, 0.0002414, 0.0006435, 0.0001695, 0.0, -0.3838, 5.631e-07,
    2.356e-08, 4.774e-07, 3.632e-10, 1.479e-05, 0.001615, 0.04344, 0.02794,
    -0.0008324, 0.0007805, 2.723e-08, 2.002e-08, 1.019e-06, 0.00108, 0.216,
    -9.943e-06, 0.001158, -2.988e-06, 0.001565, 0.03036, -1.471e-08, 1.079e-05,
    -0.003456, -8.401e-05, 6.158e-08, 2.403e-06, 0.00092, 0.001146, 0.0006344,
    -0.0001633, 0.000688, 2.117e-09, 0.0003641, 1.135e-06, 8.7e-05, -0.000531,
    -0.005151, 3.237e-05, 0.0001225, -1.226e-05, 1.281e-05, 0.0002567,
    0.0006589, -4.083e-08, 1.749e-05, -0.02553, -0.004394, -0.0002297, 0.03529,
    0.0003869, 0.01969, 6.564e-12, 3.569e-09, 9.737e-06, 1.674e-06, 4.416e-06,
    0.001032, -0.001946, -0.003365, 0.05949, -0.004299, 0.001066, -0.07431,
    3.522e-06, 0.0003264, -0.001351, -0.001619, -2.908e-09, -8.978e-07,
    -8.004e-07, -4.407e-06, 1.265e-07, 1.909e-05, -0.01696, -0.02448,
    -4.335e-05, 0.00294, 0.09813, 0.0001213, -0.0484, -0.4203, 0.00534,
    -0.04677, -7.145e-11, 3.009e-14, 6.672e-11, -8.572e-06, 3.104e-05,
    8.196e-07, 5.74e-11, -2.002e-08, 6.903e-06, -1.335e-08, 2.743e-09,
    1.79e-06, 1.265e-10, 0.0003504, -3.573e-05, 1.166e-07, 0.0003437,
    -0.001436, -4.64e-05, 4.002e-08, -0.003927, 0.0, -0.01514, 0.02014,
    0.0001222, 3.948e-05, -0.001559, 3.743e-05, 0.0005326, -0.0001974,
    -5.288e-06, 3.713e-05, -7.122e-05, -0.3852, -0.129, -0.04666, 0.2277,
    -0.08777, 0.01367, -0.09282, -0.001069, 0.02538, -0.003219, -0.006327,
    -0.003531, 0.00514, -0.01849, 1.11e-05, -0.08658, 3.847e-07, -5.765e-07,
    0.006394, 3.105e-06, -0.01589, -2.389e-05, 4.464e-08, 9.816e-11,
    -2.582e-12, 3.729e-12, -5.275e-09, 7.699e-11, 2.252e-09, 4.909e-07,
    3.157e-09, 4.381e-10, -2.34e-12, 1.256e-11, 1.283e-10, 1.182e-11,
    1.608e-11, 5.787e-12, 8.434e-12, -3.458e-10, 1.952e-10, -6.919e-20,
    2.436e-11, -5.44e-14, 3.31e-11, 1.027e-14, 5.629e-13, -1.398e-11,
    -1.545e-13, 1.738e-09, 7.191e-10, 4.926e-08, 2.187e-10, 5.253e-10,
    1.805e-09, 9.756e-10, 2.293e-09, -4.22e-12, 4.336e-12, 1.109e-10,
    1.923e-11, -6.061e-11, 3.631e-15, 3.327e-15, -2.132e-12, -3.033e-13,
    -2.562e-13, 2.45e-13, 3.861e-13, 2.919e-14, 7.269e-22, 1.766e-13,
    1.057e-14, -2.262e-13, -6.453e-20, 4.673e-16, -1.207e-12, 2.783e-13,
    -3.13e-13, -1.388e-13, -4.109e-14, 2.349e-15, -2.205e-16, -3.495e-14,
    -4.756e-15, 5.454e-10, -2.489e-11, 1.092e-13, 2.558e-16, -4.052e-18,
    1.087e-19, 2.659e-15, 5.272e-16, -5.992e-16, 1.256e-12, 2.989e-13,
    3.259e-13, 1.64e-13, 6.132e-14, 4.175e-14, 2.528e-12, -1.252e-12,
    7.888e-13, 1.034e-13, -9.348e-11, 8.806e-13, 2.468e-12, 2.295e-15,
    2.278e-19, 9.253e-16, -1.26e-13, -1.254e-12, -2.408e-13, 1.468e-15,
    9.243e-13, 2.731e-15, 6.807e-15, 6.237e-15, -4.807e-15, 2.437e-12,
    -4.301e-11, 3.735e-11, -4.1e-12, -3.573e-13, -3.1e-15, -1.696e-11,
    4.589e-22, 5.512e-21, 1.837e-13, 0.01702, -0.002349, 0.001545, 0.03073,
    0.00187, -1.63e-08, -0.002392, 0.001018, 8.192e-09, 9.106e-05, -0.009196,
    0.001054, -3.643e-06, 6.499e-08, -1.125e-05, -4.292e-06, 3.009e-05,
    2.911e-05, -8.892e-06, 1.011e-05, 7.982e-05, -2.612e-05, 3.12e-05,
    -0.0004069, 1.785e-05, 3.111e-05, 4.403e-05, -8.016e-06, 0.00266,
    -1.201e-05, 0.000165, 4.575e-05, -1.199e-05, 3.13e-06, 1.708e-06,
    2.566e-06, 8.423e-09, -5.677e-07, -1.668e-06, -4.777e-07, -5.771e-06,
    5.16e-06,)

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


def embedded(A9, n):
    """A contract case (n = 9) as the leading block of 0.5 I (n x n), for
    the CTA path."""
    A = 0.5 * np.eye(n)
    A[:9, :9] = A9
    return A


def check_kernel(device, batches=(1, 1024, 4096),
                 sizes=(1, 9, 13, 53, 64, 65, 66, 120, 176, 240)):
    """Phase 2: both paths of the lu32p kernel against its plain version on
    the card, and the contract cases on both paths (at n = 70 for the CTA
    path)."""
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
            # general random matrices: componentwise backward error and
            # |L| <= 1 on every lane, solve error against cond(A) eps on the
            # first 1024 (cond takes an SVD per lane)
            G = torch.randn((B, n, n), generator=gen,
                            dtype=torch.float64).to(device)
            b = torch.randn((B, n), generator=gen,
                            dtype=torch.float64).to(device)
            fac = lc.lu32p_factor(G)
            bwd, l_max = (float(v.max()) for v in
                          lc.lu32p_backward_error(G, *fac))
            m = min(B, 1024)
            x = lc.lu32p_solve((fac[0][:m], fac[1][:m]), b[:m]).double()
            x_ref = torch.linalg.solve(G[:m], b[:m])
            rel = ((x - x_ref).abs().amax(dim=1)
                   / x_ref.abs().amax(dim=1))
            cond = torch.linalg.cond(G[:m])
            solve_ok = bool(torch.all(rel <= 4 * n * cond * EPS32))
            del G, fac
            ok = (piv_ok and lu_err <= tol and bwd <= tol and l_max <= 1.0
                  and solve_ok)
            cases.append({"B": B, "n": n, "path": path, "piv_equal": piv_ok,
                          "lu_rel_err": lu_err, "backward_err": bwd,
                          "max_abs_L": l_max, "tol": tol,
                          "solve_ok": solve_ok,
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
    singular_ok = True
    for n in (3, 70):
        S = np.eye(n)
        S[:3, :3] = [[1.0, 2.0, 0.0], [3.0, 4.0, 0.0], [5.0, 6.0, 0.0]]
        fac_s = lc.lu32p_factor(torch.tensor(S[None], device=device))
        xs = lc.lu32p_solve(fac_s, torch.ones((1, n), dtype=torch.float64,
                                              device=device))
        singular_ok = singular_ok and bool(
            torch.all(torch.isfinite(fac_s[0]))
            and not torch.all(torch.isfinite(xs)))
    pad_ok = True
    for m in (53, 65):
        npad = lc.padded_n(m)
        _, piv_pad = lc.lu32p_factor(separated(16, m, gen, device))
        pad_ok = pad_ok and bool(
            torch.all(piv_pad[:, :m] < m)
            and torch.equal(piv_pad[:, m:].cpu(),
                            torch.arange(m, npad, dtype=torch.int32)
                            .expand(16, npad - m)))
    order = {}
    for name, (A, want) in (("exact_tie", tie_matrix()),
                            ("nan_pivot", nan_matrix())):
        for n in (9, 70):
            At = torch.tensor((A if n == 9 else embedded(A, n))[None],
                              device=device)
            LU_k, piv_k = lc.lu32p_factor(At)
            LU_p, piv_p = lc.lu32p_factor_plain(At)
            same_nan = bool(torch.equal(torch.isnan(LU_k),
                                        torch.isnan(LU_p)))
            fin = torch.isfinite(LU_p)
            lu_err = float((LU_k[fin] - LU_p[fin]).abs().max())
            key = name if n == 9 else f"{name}_n{n}"
            order[key] = {"path": lc.launch_config(1, lc.padded_n(n))["path"],
                          "piv": piv_k[0, :9].tolist(),
                          "piv_equal_plain": bool(torch.equal(piv_k, piv_p)),
                          "piv_as_expected": piv_k[0, :9].tolist() == want,
                          "nan_pattern_equal": same_nan,
                          "lu_max_abs_err": lu_err}
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


def time_kernel(M, same_pivots=True):
    """One shape: the kernel against its plain version on M, its cold and
    hot times, the plain version's, the library call's
    (``torch.linalg.lu_factor_ex`` on the padded float32 matrices) and the
    bound for these inputs.

    Every lane must meet the componentwise backward bound |PA - LU| <= 64 n
    eps32 |L||U| with |L| <= 1 (``lu32p_backward_error``), which holds
    rows of any scale to their own.  With ``same_pivots`` every lane must
    also take the plain version's pivots, and the factors may differ by at
    most 64 n eps32 times the row's largest (|L||U|): the bound two float32
    factorizations in different orders of operations meet at the paths'
    own step sizes.  At the coupled path's larger steps (cond(M) to 1e18)
    they need not (``python -m batchreactor_tpu_torch.tools.lu32p_coverages``
    measures two correct ones apart), so there the pivots and the
    difference are reported.  On the CTA path the kernel is also held
    against ``blocked_lu32``, its order of operations in torch ops on the
    card: the lanes whose factor is bit-identical are reported."""
    import torch

    from batchreactor_tpu_torch.solver import linalg_cuda as lc

    B, n = M.shape[0], M.shape[-1]
    npad = lc.padded_n(n)
    tol = 64 * n * EPS32
    LU_k, piv_k = lc.lu32p_factor(M)
    LU_p, piv_p = lc.lu32p_factor_plain(M)
    torch.cuda.synchronize()
    same = (piv_k == piv_p).all(dim=1)
    diff = (LU_k - LU_p)[same].abs().double()
    max_abs_err = float(diff.max()) if bool(same.any()) else None
    L = torch.tril(LU_p[same].double(), -1) + torch.eye(
        npad, dtype=torch.float64, device=M.device)
    llu_row = (L.abs() @ torch.triu(LU_p[same].double()).abs()).amax(
        dim=2, keepdim=True)
    fwd = float((diff / llu_row).max()) if bool(same.any()) else None
    del L, llu_row, diff
    bwd, l_max = (float(v.max()) for v in
                  lc.lu32p_backward_error(M, LU_k, piv_k))
    ok = bwd <= tol and l_max <= 1.0
    if same_pivots:
        ok = ok and bool(same.all()) and fwd <= tol
    if not ok:
        raise AssertionError(
            f"lu32p at {B}x{n}: {int((~same).sum())} lanes with other "
            f"pivots, difference {fwd} of the row's |L||U|, componentwise "
            f"backward {bwd}, max|L| {l_max} (tolerance {tol})")
    path = lc.launch_config(B, npad)["path"]
    witness = {}
    if path == "cta":
        # the kernel's order of operations, emulated with torch ops on the
        # card: lanes whose factor and pivots are bit-identical
        from batchreactor_tpu_torch.tools.lu32p_coverages import blocked_lu32

        LU_e, piv_e = blocked_lu32(M)
        alike = (LU_k == LU_e).flatten(1).all(dim=1) & (piv_k == piv_e).all(
            dim=1)
        witness = {"lanes_bitwise_blocked_lu32": int(alike.sum()),
                   "entries_off_blocked_lu32": int((LU_k != LU_e).sum())}
        del LU_e
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
    return {"shape": [B, n], "npad": npad, "path": path, "tol": tol,
            "lanes_same_pivots": int(same.sum()), "max_abs_err": max_abs_err,
            "diff_over_row_LLU": fwd, "backward_err": bwd,
            "max_abs_L": l_max, "ms": ms,
            "hot_ms": hot_ms, "l2_rotation_sets": sets, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_queued": library_queued,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "share_of_bound": bound_ms / ms, "bytes": bytes_moved,
            "flops": flops, **witness}


def sweep(bt, gm, th, T, device, t1=T1, **kw):
    """The main path's sweep of the temperatures T; ``kw`` overrides its
    solver configuration."""
    cfg = dict(method="bdf", jac_window=8, setup_economy=True)
    cfg.update(kw)
    return bt.batch_reactor_sweep(
        COMP, T, 1e5, t1, chem=bt.Chemistry(gaschem=True), thermo_obj=th,
        md=gm, rtol=RTOL, atol=ATOL, ignition_marker="CH4",
        segment_steps=256, device=device, **cfg)


def counted(fn):
    """Run ``fn`` with the kernel's launch counts set to 0 just before it;
    return its result, the launches and the launches by path."""
    from batchreactor_tpu_torch.solver import linalg_cuda as lc

    lc.LAUNCHES = 0
    lc.LAUNCHES_BY_PATH.update(warp=0, cta=0)
    out = fn()
    return out, lc.LAUNCHES, dict(lc.LAUNCHES_BY_PATH)


def coupled_conditions():
    """(T, Asv) of the coupled path: N_T_COUPLED temperatures x the Asv
    decades, temperature-major."""
    T = np.repeat(np.linspace(T_LO_C, T_HI_C, N_T_COUPLED),
                  len(ASV_DECADES))
    Asv = np.tile(ASV_DECADES, N_T_COUPLED)
    return T, Asv


def coupled_jacobians(gm, th, sm, device):
    """The coupled Jacobians J (B = 1024, n = 53 + 13) at the coupled
    path's initial states across the T x Asv grid."""
    import torch

    from batchreactor_tpu_torch.api import get_solution_vector
    from batchreactor_tpu_torch.ops.rhs import make_surface_jac

    sp = list(gm.species)
    x0 = np.zeros(len(sp))
    for k, v in COMP.items():
        x0[sp.index(k)] = v
    T, Asv = coupled_conditions()
    T = torch.tensor(T, device=device)
    Asv = torch.tensor(Asv, device=device)
    y0 = get_solution_vector(np.broadcast_to(x0, (T.shape[0], len(sp))),
                             th.molwt, T, 1e5, ini_covg=sm.ini_covg)
    return make_surface_jac(sm, th, gm=gm)(0.0, y0, {"T": T, "Asv": Asv})


def coupled_conditioning(J, ng):
    """How the coupled Newton matrices condition as the step grows: the
    largest |J| entry of each block (gas/coverage rows x columns) and
    cond(M = I - c J) over the lanes for c = h/gamma from 1e-9 to 1e-3 s."""
    import torch

    blocks = {"gg": J[:, :ng, :ng], "gt": J[:, :ng, ng:],
              "tg": J[:, ng:, :ng], "tt": J[:, ng:, ng:]}
    eye = torch.eye(J.shape[-1], dtype=torch.float64, device=J.device)
    cond = {}
    for c in (1e-9, 1e-7, 1e-5, 1e-3):
        k = torch.linalg.cond(eye - c * J)
        cond[f"{c:g}"] = {"max": float(k.max()), "median": float(
            k.median())}
    return {"J_abs_max": {b: float(v.abs().max()) for b, v in
                          blocks.items()}, "cond_M": cond}


def coupled_sweep(bt, gm, th, sm, T, Asv, t1, device, segment_steps=256,
                  **kw):
    return bt.batch_reactor_sweep(
        COMP, T, 1e5, t1, chem=bt.Chemistry(gaschem=True, surfchem=True),
        thermo_obj=th, gmd=gm, smd=sm, Asv=Asv, rtol=RTOL, atol=ATOL,
        asv_quirk=True, segment_steps=segment_steps, device=device, **kw)


def h2_decay_udf(species, device):
    """First-order H2 decay at k(T) = T/1e5 1/s, per lane (the source is
    mapped over the lanes with torch.func.vmap): mol/m^3/s."""
    import torch

    onehot = torch.zeros(len(species), dtype=torch.float64, device=device)
    onehot[list(species).index("H2")] = 1.0

    def udf(t, state):
        c = state["mole_frac"] * state["p"] / (8.314472 * state["T"])
        return -(state["T"] / 1e5) * c * onehot

    return udf


def check_sweep(name, out, B, by_path, want_path, want_ls=None):
    """The assertions every sweep phase shares: all lanes successful,
    finite states and, with surface chemistry, coverages that sum to 1
    within 1e-6; the kernel launched on ``want_path`` only (``None``: no
    launch, and the float64 ``lu`` mode unless ``want_ls`` names
    another).  Returns the coverage sums' largest distance from 1."""
    rep = out["report"]
    if want_ls is None:
        want_ls = "lu" if want_path is None else "lu32p"
    if out["linsolve"] != want_ls:
        raise AssertionError(f"{name}: linsolve resolved to "
                             f"{out['linsolve']!r}, not {want_ls!r}")
    check_launches(name, by_path, want_path)
    if rep["counts"] != {"success": B}:
        raise AssertionError(f"{name}: lanes not all successful: "
                             f"{rep['counts']}")
    x = np.stack(list(out["x"].values()), axis=1)
    if not np.all(np.isfinite(x)):
        raise AssertionError(f"{name}: non-finite mole fractions")
    if "covg" in out:
        dev = np.abs(out["covg"].sum(axis=1) - 1.0)
        if not (np.all(np.isfinite(out["covg"])) and dev.max() <= 1e-6):
            raise AssertionError(f"{name}: coverage sums off 1 by "
                                 f"{dev.max()}")
        return float(dev.max())
    return None


def coupled_states(out, species):
    """Final gas mole fractions then coverages, (B, 66)."""
    return np.concatenate([np.stack([out["x"][k] for k in species], axis=1),
                           out["covg"]], axis=1)


def surface_sweep(bt, th7, sm7, T, device, **kw):
    return bt.batch_reactor_sweep(
        COMP7, T, 1e5, T1_S, chem=bt.Chemistry(surfchem=True),
        thermo_obj=th7, smd=sm7, Asv=10.0, rtol=RTOL, atol=ATOL,
        segment_steps=256, device=device, **kw)


def energy_conditions(gm, device):
    """Phase 11's lanes: (phi, T) per lane on the phi x T grid, phi-major,
    and the premixed CH4/air mole fractions (B, 53) as numpy arrays."""
    from batchreactor_tpu_torch.parallel import (condition_grid,
                                                 premixed_mole_fracs)

    g = condition_grid(phi=PHI_E, T=np.linspace(T_LO, T_HI, N_T_E),
                       device=device)
    x = premixed_mole_fracs(list(gm.species), "CH4", g["phi"],
                            diluent="N2", stoich_o2=2.0, o2_to_diluent=3.76,
                            device=device)
    return (g["phi"].cpu().numpy(), g["T"].cpu().numpy(),
            x.cpu().numpy())


def energy_jacobians(gm, th, device):
    """The constant-volume energy Jacobians (B = 1024, n = 53 + 1) at phase
    11's initial states."""
    import torch

    from batchreactor_tpu_torch.energy import eqns
    from batchreactor_tpu_torch.parallel import sweep_solution_vectors

    _, T, x = energy_conditions(gm, device)
    T = torch.tensor(T, device=device)
    y0 = eqns.extend_states(sweep_solution_vectors(x, th.molwt, T, 1e5), T)
    return eqns.make_energy_jac(gm, th, "adiabatic_v")(0.0, y0, {})


def energy_sweep(bt, gm, th, x, T, device, energy="adiabatic_v", t1=T1_E,
                 **kw):
    """An adiabatic GRI-3.0 sweep of the lanes (x, T) with the main path's
    solver configuration."""
    comp = {s: x[:, k] for k, s in enumerate(gm.species) if x[:, k].any()}
    return bt.batch_reactor_sweep(
        comp, T, 1e5, t1, chem=bt.Chemistry(gaschem=True), thermo_obj=th,
        md=gm, rtol=RTOL, atol=ATOL, energy=energy, jac_window=8,
        setup_economy=True, segment_steps=256, device=device, **kw)


def energy_drift(th, x0, T0, out, mode):
    """Per-lane |e(t1) - e(0)| / sum_k |Y_k e_k(0)| of the specific internal
    energy (``adiabatic_v``) or enthalpy (``adiabatic_p``), which the
    reactor conserves, from the initial and final x and T."""
    import torch

    from batchreactor_tpu_torch.ops.thermo import cp_h_s_over_R
    from batchreactor_tpu_torch.utils.constants import R

    molwt = th.molwt.cpu().numpy()

    def specific(x, T):
        _, h_RT, _ = cp_h_s_over_R(torch.tensor(T, device=th.molwt.device),
                                   th)
        h = h_RT.cpu().numpy() * R * T[:, None]
        e = h - R * T[:, None] if mode == "adiabatic_v" else h
        Y = x * molwt / (x @ molwt)[:, None]
        terms = Y * e / molwt
        return terms.sum(axis=1), np.abs(terms).sum(axis=1)

    e0, scale = specific(x0, T0)
    x1 = np.stack([out["x"][s] for s in th.species], axis=1)
    e1, _ = specific(x1, out["T"])
    return np.abs(e1 - e0) / scale


def timed(fn):
    """``counted(fn)`` with the wall of the call, the card synchronised."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, launches, by_path = counted(fn)
    torch.cuda.synchronize()
    return out, launches, by_path, time.perf_counter() - t0


def steps(rep):
    return {"mean_accepted": rep["n_accepted"]["mean"],
            "max_accepted": rep["n_accepted"]["max"],
            "mean_rejected": rep["n_rejected"]["mean"],
            "max_rejected": rep["n_rejected"]["max"]}


def phase_energy(bt, gm, th, device, smi, timing, by_phase):
    """Phases 11 and 12: the adiabatic GRI-3.0 phi x T sweep (the kernel's
    warp path), then its first B_CROSS lanes with the float64 ``lu`` and
    at constant pressure."""
    import torch

    # ---- phase 11: the energy path --------------------------------------
    phi_e, T_e, x_e = energy_conditions(gm, device)
    B_E = T_e.shape[0]
    t0 = time.perf_counter()
    energy_sweep(bt, gm, th, x_e, T_e, device)
    torch.cuda.synchronize()
    cold_e = time.perf_counter() - t0
    out_e, launches_e, by_phase["energy"], wall_e = timed(
        lambda: energy_sweep(bt, gm, th, x_e, T_e, device))
    check_sweep("energy", out_e, B_E, by_phase["energy"], "warp")
    tau_e = out_e["ignition_delay"]
    if not np.all(np.isfinite(tau_e)):
        raise AssertionError(f"energy: {int((~np.isfinite(tau_e)).sum())} "
                             f"lanes without an ignition delay")
    rise = out_e["T"] - T_e
    if not np.all(rise > 500.0):
        raise AssertionError(f"energy: final T only {rise.min()} K above "
                             f"the initial T")
    tau_grid = tau_e.reshape(len(PHI_E), -1)
    if not np.all(np.diff(tau_grid, axis=1) < 0):
        raise AssertionError("energy: tau not strictly decreasing in T at "
                             "every phi")
    x_sum = np.abs(sum(out_e["x"].values()) - 1.0).max()
    if x_sum > 1e-12:
        raise AssertionError(f"energy: sum x off 1 by {x_sum}")
    drift_e = energy_drift(th, x_e, T_e, out_e, "adiabatic_v")
    if not drift_e.max() <= DRIFT_BOUND_V:
        raise AssertionError(f"energy: internal energy drift "
                             f"{drift_e.max()} > {DRIFT_BOUND_V}")
    emit({"phase": "energy", "gpu": smi, "B": B_E,
          "mechanism": "GRI-3.0 (53 species) + T, n = 54",
          "energy": "adiabatic_v", "phi": list(PHI_E), "T": [T_LO, T_HI],
          "t1": T1_E, "linsolve": out_e["linsolve"],
          "jac_window": out_e["jac_window"], "cold_s": cold_e,
          "wall_s": wall_e, "cond_per_s": B_E / wall_e,
          **steps(out_e["report"]),
          "tau_min": float(tau_e.min()), "tau_max": float(tau_e.max()),
          "T_rise_min": float(rise.min()), "sum_x_max_dev": float(x_sum),
          "u_drift_max": float(drift_e.max()),
          "u_drift_median": float(np.median(drift_e)),
          "u_drift_bound": DRIFT_BOUND_V, "u_drift_jax_cpu": DRIFT_REF_V,
          "lu32p_launches": launches_e,
          "lu32p_launches_by_path": by_phase["energy"],
          "kernel_share": launches_e * timing["energy_n54"]["hot_ms"]
          / 1e3 / wall_e})

    # ---- phase 12: the energy path's cross-checks ------------------------
    t0 = time.perf_counter()
    m = min(B_CROSS, B_E)
    ref_e, _, by_lu, wall_lu = timed(
        lambda: energy_sweep(bt, gm, th, x_e[:m], T_e[:m], device,
                             linsolve="lu"))
    check_sweep("energy lu", ref_e, m, by_lu, None)
    tau_rel = np.abs(tau_e[:m] / ref_e["ignition_delay"] - 1.0)
    T_rel = np.abs(out_e["T"][:m] / ref_e["T"] - 1.0)
    if not (tau_rel.max() <= 1e-3 and T_rel.max() <= 1e-5):
        raise AssertionError(f"energy lu32p vs lu: tau max rel "
                             f"{tau_rel.max()}, T max rel {T_rel.max()}")
    out_p, _, by_p, wall_p = timed(
        lambda: energy_sweep(bt, gm, th, x_e[:m], T_e[:m], device,
                             energy="adiabatic_p"))
    check_sweep("energy adiabatic_p", out_p, m, by_p, None)
    drift_p = energy_drift(th, x_e[:m], T_e[:m], out_p, "adiabatic_p")
    if not (np.all(np.isfinite(out_p["ignition_delay"]))
            and drift_p.max() <= DRIFT_BOUND_P):
        raise AssertionError(f"energy adiabatic_p: enthalpy drift "
                             f"{drift_p.max()} > {DRIFT_BOUND_P}, or lanes "
                             f"without a delay")
    emit({"phase": "energy_cross_check", "gpu": smi, "lanes": m,
          "tau_max_rel_vs_lu": float(tau_rel.max()),
          "T_max_rel_vs_lu": float(T_rel.max()), "lu_wall_s": wall_lu,
          "lu_steps": steps(ref_e["report"]),
          "adiabatic_p_linsolve": out_p["linsolve"],
          "adiabatic_p_wall_s": wall_p,
          "adiabatic_p_steps": steps(out_p["report"]),
          "adiabatic_p_tau_range": [float(out_p["ignition_delay"].min()),
                                    float(out_p["ignition_delay"].max())],
          "h_drift_max": float(drift_p.max()),
          "h_drift_bound": DRIFT_BOUND_P, "h_drift_jax_cpu": DRIFT_REF_P,
          "seconds": time.perf_counter() - t0})


def main_path_lanes(gm, th, Ts, device):
    """The main path's composition at the temperatures Ts: (y0s, cfg, rhs,
    jac, observer, observer_init) for the ensemble layer's entry points."""
    import torch

    from batchreactor_tpu_torch.ops.rhs import make_gas_jac, make_gas_rhs
    from batchreactor_tpu_torch.parallel import (ignition_observer,
                                                 sweep_solution_vectors)

    sp = list(gm.species)
    x0 = np.zeros(len(sp))
    for k, v in COMP.items():
        x0[sp.index(k)] = v
    Tt = torch.tensor(Ts, device=device)
    y0s = sweep_solution_vectors(np.broadcast_to(x0, (len(Ts), len(sp))),
                                 th.molwt, Tt, 1e5)
    obs, obs0 = ignition_observer(sp.index("CH4"), mode="half")
    return (y0s, {"T": Tt}, make_gas_rhs(gm, th), make_gas_jac(gm, th), obs,
            obs0)


def phase_sdirk(bt, gm, th, Ts, tau_bdf, rep_bdf, device, smi, by_phase):
    """Phase 13: SDIRK4 (``auto`` -> ``inv32``) on the main path's
    conditions at the temperatures Ts against phase 3's BDF delays there,
    and one ``temperature_sweep``."""
    from batchreactor_tpu_torch.parallel import temperature_sweep

    B_S = Ts.shape[0]
    out_sd, _, by_sd, wall_sd = timed(
        lambda: sweep(bt, gm, th, Ts, device, method="sdirk",
                      jac_window=None, setup_economy=False))
    # inv32 inverts through the lu32p factor: the warp path at n = 53
    check_sweep("sdirk", out_sd, B_S, by_sd, "warp", want_ls="inv32")
    by_phase["sdirk"] = by_sd
    rel_sd = np.abs(out_sd["tau"] / tau_bdf - 1.0)
    if out_sd["jac_window"] != 1 or not rel_sd.max() <= 1e-3:
        raise AssertionError(f"sdirk: tau max rel {rel_sd.max()} against "
                             f"phase 3's BDF, jac_window "
                             f"{out_sd['jac_window']}")
    # one initial state (T_LO, 1 bar) over the 16 hottest temperatures to
    # T1 / 4, through the monolithic ensemble_solve: hotter lanes ignite
    # sooner, all of them within 1e-4 s
    y0s, _, rhs, jac, obs, obs0 = main_path_lanes(gm, th, Ts[:1], device)
    T_ts = Ts[-16:]
    res_ts, _, by_ts, wall_ts = timed(
        lambda: temperature_sweep(rhs, y0s[0], T_ts, T1 / 4, method="sdirk",
                                  rtol=RTOL, atol=ATOL, jac=jac,
                                  observer=obs, observer_init=obs0))
    tau_ts = res_ts.observed["tau"].cpu().numpy()
    if not (bool((res_ts.status == 1).all()) and np.all(np.isfinite(tau_ts))
            and np.all(np.diff(tau_ts) < 0) and by_ts["warp"] > 0
            and by_ts["cta"] == 0):
        raise AssertionError(f"temperature_sweep sdirk: status "
                             f"{res_ts.status.tolist()}, tau {tau_ts}")
    by_phase["temperature_sweep"] = by_ts
    emit({"phase": "sdirk", "gpu": smi, "B": B_S, "t1": T1,
          "linsolve": out_sd["linsolve"], "jac_window": out_sd["jac_window"],
          "wall_s": wall_sd, "cond_per_s": B_S / wall_sd,
          **steps(out_sd["report"]),
          "bdf_mean_accepted_phase3": rep_bdf["n_accepted"]["mean"],
          "tau_max_rel_vs_bdf": float(rel_sd.max()),
          "tau_mean_rel_vs_bdf": float(rel_sd.mean()),
          "lu32p_launches_by_path": by_sd,
          "temperature_sweep": {"B": int(T_ts.shape[0]), "t1": T1 / 4,
                                "T": [float(T_ts[0]), float(T_ts[-1])],
                                "wall_s": wall_ts,
                                "mean_accepted": float(
                                    res_ts.n_accepted.double().mean()),
                                "tau_range": [float(tau_ts.min()),
                                              float(tau_ts.max())]}})


def phase_linsolve_ab(gm, th, Ts, device, smi, by_phase):
    """Phase 14: below the ``lu32p`` gate, BDF through one monolithic
    ``ensemble_solve`` of the same lanes with every Newton mode at the main
    path's economy settings, and ``lu32p`` under ``freeze_precond``: warm
    walls, steps, lanes successful and tau against ``lu`` (<= 1e-3).  No
    assertion on speed."""
    import torch

    from batchreactor_tpu_torch.parallel import ensemble_solve
    from batchreactor_tpu_torch.solver import linalg as la

    B_S = Ts.shape[0]
    y0s, cfg, rhs, jac, obs, obs0 = main_path_lanes(gm, th, Ts, device)
    n = y0s.shape[1]
    eye = torch.eye(n, dtype=torch.float64, device=device).expand(4, n, n)
    one = torch.ones((4, n), dtype=torch.float64, device=device)
    for mode in la.MODES:      # first use of each mode's library calls
        la.apply_factor(la.factor_m(eye, mode), one, mode, torch.float64)
    torch.cuda.synchronize()
    economy = dict(jac_window=8, setup_economy=True)
    runs = [(m, dict(linsolve=m, **economy)) for m in
            ("lu", "inv32", "inv32nr", "inv32f", "lu32p")]
    runs.append(("lu32p_freeze_precond",
                 dict(linsolve="lu32p", jac_window=8, freeze_precond=True,
                      setup_economy=False)))
    ab, taus = {}, {}
    for name, kw in runs:
        res, _, by_ab, wall_ab = timed(
            lambda kw=kw: ensemble_solve(
                rhs, y0s, 0.0, T1, cfg, rtol=RTOL, atol=ATOL, jac=jac,
                observer=obs, observer_init=obs0, **kw))
        taus[name] = res.observed["tau"].cpu().numpy()
        ab[name] = {"wall_s": wall_ab,
                    "success": int((res.status == 1).sum()),
                    "mean_accepted": float(res.n_accepted.double().mean()),
                    "max_accepted": int(res.n_accepted.max()),
                    "mean_rejected": float(res.n_rejected.double().mean()),
                    "lu32p_launches_by_path": by_ab,
                    "tau_max_rel_vs_lu": float(
                        np.abs(taus[name] / taus["lu"] - 1.0).max())}
        by_phase["linsolve_ab_" + name] = by_ab
    bad = {k: v for k, v in ab.items() if v["success"] != B_S
           or not v["tau_max_rel_vs_lu"] <= 1e-3}
    if bad:
        raise AssertionError(f"linsolve A/B: {bad}")
    emit({"phase": "linsolve_ab", "gpu": smi, "B": B_S, "n": n,
          "B_times_n": B_S * n, "gate": la.LU32P_MIN_BN, "t1": T1,
          "auto": la.resolve_linsolve("auto", device=device, batch=B_S,
                                      n=n), "runs": ab})


def padded_matrices(gm, th, device, c):
    """Phase 15's Newton matrices M = I - c J at the main path's initial
    states (B = 1024) on GRI-3.0 padded to (S_PAD, R_PAD): the live block
    is the main path's, the dead block the identity."""
    import torch

    from batchreactor_tpu_torch.api import get_solution_vector
    from batchreactor_tpu_torch.models.padding import (pad_gas_mechanism,
                                                       pad_states, pad_thermo)
    from batchreactor_tpu_torch.ops.rhs import make_gas_jac

    gmp, thp = pad_gas_mechanism(gm, S_PAD, R_PAD), pad_thermo(th, S_PAD)
    sp = list(gm.species)
    x0 = np.zeros(len(sp))
    for k, v in COMP.items():
        x0[sp.index(k)] = v
    T = torch.linspace(T_LO, T_HI, B_MAIN, dtype=torch.float64, device=device)
    y0 = pad_states(get_solution_vector(
        np.broadcast_to(x0, (B_MAIN, len(sp))), th.molwt, T, 1e5), S_PAD)
    J = make_gas_jac(gmp, thp)(0.0, y0, {"T": T})
    return torch.eye(S_PAD, dtype=torch.float64, device=device) - c * J


def phase_padded(bt, gm, th, T, tau_main, rep_main, device, smi, by_phase):
    """Phase 15: the gas main path with GRI-3.0 padded to S_PAD species and
    the pow2 reaction rung (53 -> 96, 325 -> 512): ``auto`` -> ``lu32p``
    on the CTA path (npad 96).  Every lane successful, CTA launches only,
    the 53 live species in ``x``, tau within 1e-3 of phase 3's; the steps
    are reported against phase 3's (the two kernel paths round the live
    block differently, so they need not be equal on the card)."""
    pad = dict(species_buckets=(S_PAD,), reaction_buckets="pow2")
    _, _, _, cold = timed(lambda: sweep(bt, gm, th, T, device, **pad))
    out, launches, by_phase["padded_gas"], wall = timed(
        lambda: sweep(bt, gm, th, T, device, **pad))
    check_sweep("padded_gas", out, B_MAIN, by_phase["padded_gas"], "cta")
    if list(out["x"]) != list(gm.species):
        raise AssertionError(f"padded_gas: x holds {len(out['x'])} species, "
                             f"not the {gm.n_species} live ones")
    rel = np.abs(out["tau"] / tau_main - 1.0)
    if not rel.max() <= 1e-3:
        raise AssertionError(f"padded_gas: tau max rel {rel.max()} against "
                             f"phase 3's")
    rep = out["report"]
    emit({"phase": "padded_gas", "gpu": smi, "B": B_MAIN,
          "shape": {"S": [gm.n_species, S_PAD], "R": [gm.n_reactions,
                                                      R_PAD]},
          "linsolve": out["linsolve"], "cold_s": cold, "wall_s": wall,
          "cond_per_s": B_MAIN / wall, **steps(rep),
          "accepted_minus_phase3": {
              k: rep["n_accepted"][k] - rep_main["n_accepted"][k]
              for k in ("mean", "max")},
          "rejected_minus_phase3": {
              k: rep["n_rejected"][k] - rep_main["n_rejected"][k]
              for k in ("mean", "max")},
          "tau_max_rel_vs_phase3": float(rel.max()),
          "tau_mean_rel_vs_phase3": float(rel.mean()),
          "lu32p_launches": launches,
          "lu32p_launches_by_path": by_phase["padded_gas"]})


def ch4_theta(gm, th, reactions):
    """(spec, theta, rhs_theta, jac_theta) over ln A of the selected
    reactions of the (unpadded) mechanism."""
    from batchreactor_tpu_torch.ops.rhs import make_gas_jac, make_gas_rhs
    from batchreactor_tpu_torch.sensitivity import params

    spec = params.select(gm, reactions=reactions)
    theta = params.extract(gm, spec)
    rhs_theta = params.make_rhs_theta(gm, spec,
                                      lambda m: make_gas_rhs(m, th))

    def jac_theta(t, y, th_, cfg):
        return make_gas_jac(params.apply(gm, th_, spec), th)(t, y, cfg)

    return spec, theta, rhs_theta, jac_theta


def max_rel_to_lane(a, ref):
    """Largest |a - ref| over each lane's largest |ref|, over all lanes."""
    a, ref = (np.asarray(v.cpu()) if hasattr(v, "cpu") else np.asarray(v)
              for v in (a, ref))
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(axis=1)
    diff = np.abs(a - ref).reshape(ref.shape[0], -1).max(axis=1)
    return float((diff / scale).max())


def phase_sens_forward(gm, th, device, smi, by_phase):
    """Phase 16: ``ensemble_solve_forward`` on B_SENS of phase 3's
    temperatures (its range at a smaller depth) with
    theta = ln A of the 18 reactions matching ``*CH4*`` (P = 18),
    ``jac_window=1``, ``auto`` -> ``lu32p`` (warp path, npad 56): every
    lane successful, the steps and final states of a plain
    ``ensemble_solve`` with the same settings, and on the first B_CROSS
    lanes the tangents of a float64 ``lu`` run within 1e-3 of each lane's
    largest |S|.  Reports the wall, the launches and the peak device
    memory."""
    import torch

    from batchreactor_tpu_torch.parallel import (ensemble_solve,
                                                 ensemble_solve_forward)
    from batchreactor_tpu_torch.solver.linalg import resolve_linsolve

    T = np.linspace(T_LO, T_HI, B_SENS)
    y0s, cfg, _, _, _, _ = main_path_lanes(gm, th, T, device)
    spec, theta, rt, jt = ch4_theta(gm, th, "*CH4*")

    def jac(t, y, c):
        return jt(t, y, theta, c)

    def fwd(n_lanes=B_SENS, **kw):
        return ensemble_solve_forward(
            rt, y0s[:n_lanes], 0.0, T1, theta,
            {k: v[:n_lanes] for k, v in cfg.items()}, rtol=RTOL, atol=ATOL,
            jac=jac, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    res, launches, by_phase["sens_forward"], wall = timed(fwd)
    peak = torch.cuda.max_memory_allocated()
    check_launches("sens_forward", by_phase["sens_forward"], "warp")
    plain, _, by_plain, wall_plain = timed(lambda: ensemble_solve(
        lambda t, y, c: rt(t, y, theta, c), y0s, 0.0, T1, cfg, rtol=RTOL,
        atol=ATOL, jac=jac))
    ok = bool((res.status == 1).all()) and bool((plain.status == 1).all())
    same_steps = (torch.equal(res.n_accepted, plain.n_accepted)
                  and torch.equal(res.n_rejected, plain.n_rejected))
    y_rel = float(((res.y - plain.y).abs()
                   / plain.y.abs().clamp_min(1e-300)).max())
    S = res.tangents
    finite = bool(torch.isfinite(S).all())
    ref, _, _, wall_ref = timed(lambda: fwd(B_CROSS, linsolve="lu"))
    s_rel = max_rel_to_lane(S[:B_CROSS], ref.tangents)
    if not (ok and same_steps and finite and y_rel <= 1e-12
            and s_rel <= 1e-3):
        raise AssertionError(
            f"sens_forward: success {ok}, steps equal to the plain twin "
            f"{same_steps}, finite {finite}, final y rel {y_rel}, tangents "
            f"vs lu {s_rel}")
    emit({"phase": "sens_forward", "gpu": smi, "B": B_SENS, "P": S.shape[1],
          "reactions": "*CH4*", "t1": T1,
          "linsolve": resolve_linsolve("auto", device=device, batch=B_SENS,
                                       n=y0s.shape[1]),
          "jac_window": 1, "wall_s": wall, "cond_per_s": B_SENS / wall,
          "plain_twin_wall_s": wall_plain,
          "mean_accepted": float(res.n_accepted.double().mean()),
          "max_accepted": int(res.n_accepted.max()),
          "mean_rejected": float(res.n_rejected.double().mean()),
          "steps_equal_plain_twin": same_steps,
          "final_y_max_rel_vs_plain_twin": y_rel,
          "tangents_max_rel_vs_lu": s_rel, "lu_lanes": B_CROSS,
          "lu_wall_s": wall_ref,
          "max_memory_allocated_bytes": int(peak),
          "memory_before_bytes": int(base_mem),
          "tangents_bytes": S.numel() * S.element_size(),
          "lu32p_launches": launches,
          "lu32p_launches_by_path": by_phase["sens_forward"],
          "plain_twin_lu32p_launches_by_path": by_plain})


def check_launches(name, by_path, want_path):
    """The kernel launched on ``want_path`` only (``None``: no launch)."""
    launched = {k for k, v in by_path.items() if v}
    if launched != ({want_path} if want_path else set()):
        raise AssertionError(f"{name}: lu32p launches by path {by_path}")


def phase_adjoint(gm, th, T, device, smi):
    """Phase 17: the adjoint ranking of all GRI-3.0 reactions by their
    effect on the ignition delay, over SENS_LANES lanes (every 128th
    temperature of phase 3): ``solve_adjoint`` of the CH4 half-crossing
    delay with respect to ln A of the 325 reactions, one theta row per
    lane, ``grid_size=512``, ``segments=8``, ``grid_refine=2``, ``auto`` ->
    ``inv32``.  Lane 0's coefficients d ln tau / d ln A against the JAX
    package's on the CPU (``scripts/sens_reference.py``) within 1e-2 of the
    largest; then on 4 lanes (every 16th of the coolest 64) to T1 / 4 at
    rtol 1e-8 / atol 1e-12 the adjoint gradient of the final H2O over the
    18 ``*CH4*`` reactions against the forward tangents' H2O row, within
    1e-3 of the largest |grad| (the JAX package's own tier, also on a
    horizon before ignition).  Counts the RHS and Jacobian calls."""
    import torch

    from batchreactor_tpu_torch.parallel import ensemble_solve_forward
    from batchreactor_tpu_torch.sensitivity import adjoint, rank

    sp = list(gm.species)
    Ts = T[::B_MAIN // SENS_LANES]
    y0s, cfg, _, _, _, _ = main_path_lanes(gm, th, Ts, device)
    spec, theta, rt0, jt0 = ch4_theta(gm, th, None)
    calls = {"rhs": 0, "jacobian": 0}

    def rt(*a):
        calls["rhs"] += 1
        return rt0(*a)

    def jt(*a):
        calls["jacobian"] += 1
        return jt0(*a)

    rows = {k: v.expand(len(Ts), -1) for k, v in theta.items()}
    t0 = time.perf_counter()
    tau, grad, aux = adjoint.solve_adjoint(
        rt, adjoint.ignition_delay_qoi(sp.index("CH4"), frac=0.5), y0s, 0.0,
        T1, rows, cfg, jac_theta=jt, rtol=RTOL, atol=ATOL, grid_size=512,
        segments=8, grid_refine=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = rank.normalized_sensitivities(tau, grad["log_A"])       # (L, 325)
    ref = np.asarray(SENS_REF_LANE0_COEFFS)
    lane0_err = float(np.abs(s[0] - ref).max() / np.abs(ref).max())
    tau_np = tau.cpu().numpy()
    ok = (bool((aux["status"] == 1).all())
          and not bool(aux["truncated"].any())
          and np.all(np.isfinite(tau_np)) and np.all(np.isfinite(s)))
    if not (ok and lane0_err <= 1e-2):
        raise AssertionError(
            f"adjoint: status {aux['status'].tolist()}, truncated "
            f"{aux['truncated'].tolist()}, tau {tau_np}, lane 0 against the "
            f"JAX package {lane0_err}")
    top = rank.top_k(np.abs(s).mean(axis=0), spec.equations, k=10)

    # the forward-against-adjoint tier of the JAX package's own tests
    Tc = T[:64:16]
    t1c = T1 / 4
    y0c, cfgc, _, _, _, _ = main_path_lanes(gm, th, Tc, device)
    spec18, theta18, rt18, jt18 = ch4_theta(gm, th, "*CH4*")
    h2o = sp.index("H2O")
    t0 = time.perf_counter()
    fwd = ensemble_solve_forward(
        rt18, y0c, 0.0, t1c, theta18, cfgc, rtol=1e-8, atol=1e-12,
        jac=lambda t, y, c: jt18(t, y, theta18, c))
    rows18 = {k: v.expand(len(Tc), -1) for k, v in theta18.items()}
    q, g, aux_c = adjoint.solve_adjoint(
        rt18, adjoint.final_species_qoi(h2o), y0c, 0.0, t1c, rows18, cfgc,
        jac_theta=jt18, rtol=1e-8, atol=1e-12, grid_size=256, segments=8,
        grid_refine=2)
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    cross = max_rel_to_lane(g["log_A"], fwd.tangents[:, :, h2o])
    if not (bool((fwd.status == 1).all()) and bool((aux_c["status"] == 1)
                                                   .all())
            and not bool(aux_c["truncated"].any()) and cross <= 1e-3):
        raise AssertionError(f"adjoint vs forward: {cross}, status "
                             f"{fwd.status.tolist()} "
                             f"{aux_c['status'].tolist()}")
    emit({"phase": "adjoint", "gpu": smi, "lanes": len(Ts), "P": s.shape[1],
          "T": [float(Ts[0]), float(Ts[-1])], "qoi": "tau(CH4, frac 0.5)",
          "linsolve": adjoint._resolve_linsolve("auto", device),
          "grid_size": 512, "grid_refine": 2, "segments": 8, "wall_s": wall,
          "calls": calls,
          "pin_mean_accepted": float(aux["n_accepted"].double().mean()),
          "pin_max_accepted": int(aux["n_accepted"].max()),
          "tau_range": [float(tau_np.min()), float(tau_np.max())],
          "lane0_max_err_vs_jax": lane0_err,
          "lane0_max_abs_coeff": float(np.abs(ref).max()),
          "top10_mean_abs_dlntau_dlnA": [
              {"rank": r, "rxn": i, "equation": eq, "coeff": c}
              for r, i, eq, c in top],
          "cross_check": {"lanes": len(Tc), "T": [float(v) for v in Tc],
                          "t1": t1c, "rtol": 1e-8, "P": 18,
                          "wall_s": wall_c,
                          "pin_max_accepted": int(aux_c["n_accepted"].max()),
                          "adjoint_vs_forward_max_rel": cross}})


def lane_fields(res):
    """A SolveResult's per-lane values as host arrays (state, t, status,
    steps, step size, the ignition delay)."""
    out = {f: getattr(res, f).detach().cpu().numpy()
           for f in ("t", "y", "status", "n_accepted", "n_rejected", "h")}
    out["tau"] = res.observed["tau"].detach().cpu().numpy()
    return out


def lanes_equal(a, b):
    """Per lane: every field of ``lane_fields`` equal to the bit."""
    eq = np.ones(a["t"].shape[0], dtype=bool)
    for k in a:
        x, y = a[k], b[k]
        same = (x == y) | (np.isnan(x) & np.isnan(y)) if x.dtype.kind == \
            "f" else x == y
        eq &= same.reshape(x.shape[0], -1).all(axis=1)
    return eq


def gear_run(fn):
    """``timed(fn)`` with the graph layer's counts set to 0 before it."""
    from batchreactor_tpu_torch.solver import graphs

    graphs.reset_counts()
    res, launches, by_path, wall = timed(fn)
    return {"res": res, "wall_s": wall, "lu32p_launches_by_path": by_path,
            "graphs_captured": dict(graphs.CAPTURES),
            **{k: v for k, v in graphs.COUNTS.items()}}


def phase_gears(bt, gm, th, sm, T, device, smi, by_phase):
    """Phase 18: the main path's sweep in both gears, blocking (cold, then
    warm) and pipelined at poll_every 1 and 4 (each cold, its graphs
    dropped first, then warm), every lane equal to the bit; then blocking
    against pipelined on 64 lanes each of the coupled (f64 ``lu``), energy
    (the jvp T column) and SDIRK4 (``inv32``) paths."""
    from batchreactor_tpu_torch.parallel import ensemble_solve_segmented
    from batchreactor_tpu_torch.solver import graphs

    y0s, cfg, rhs, jac, obs, obs0 = main_path_lanes(gm, th, T, device)
    kw = dict(segment_steps=256, rtol=RTOL, atol=ATOL, jac=jac,
              observer=obs, observer_init=obs0, method="bdf", jac_window=8,
              setup_economy=True)

    def main(**gear):
        return gear_run(lambda: ensemble_solve_segmented(
            rhs, y0s, 0.0, T1, cfg, **kw, **gear))

    runs = {"blocking_cold": main(pipeline=False),
            "blocking_warm": main(pipeline=False)}
    for pe in (1, 4):
        graphs.clear_programs()
        runs[f"pipelined_poll{pe}_cold"] = main(pipeline=True, poll_every=pe)
        runs[f"pipelined_poll{pe}_warm"] = main(pipeline=True, poll_every=pe)
    ref = lane_fields(runs["blocking_warm"]["res"])
    needed = runs["blocking_warm"]["newton_iters"]
    blk_warp = runs["blocking_warm"]["lu32p_launches_by_path"]["warp"]
    report = {}
    for name, r in runs.items():
        got = lane_fields(r.pop("res"))
        equal = int(lanes_equal(ref, got).sum())
        lp = r["lu32p_launches_by_path"]
        if equal != B_MAIN:
            raise AssertionError(f"gears: {name} equals the blocking gear on "
                                 f"{equal} of {B_MAIN} lanes")
        if not (lp["warp"] > 0 and lp["cta"] == 0):
            raise AssertionError(f"gears: {name} lu32p launches {lp}")
        if name.startswith("pipelined"):
            if lp["warp"] < blk_warp:
                raise AssertionError(f"gears: {name} launched the kernel "
                                     f"{lp['warp']} times, the blocking "
                                     f"gear {blk_warp}")
            if name.endswith("warm") and sum(
                    r["graphs_captured"].values()):
                raise AssertionError(f"gears: the warm sweep {name} "
                                     f"captured {r['graphs_captured']}")
        report[name] = {**r, "cond_per_s": B_MAIN / r["wall_s"],
                        "lanes_equal": equal,
                        "newton_iters_over_blocking": r["newton_iters"]
                        / needed}
    by_phase["gears"] = runs["pipelined_poll4_warm"][
        "lu32p_launches_by_path"]

    # the 64-lane checks, blocking against pipelined through the API
    def both(name, fn, keys):
        b = gear_run(lambda: fn(pipeline=False))
        p = gear_run(lambda: fn())
        ob, op = b.pop("res"), p.pop("res")
        if ob["report"]["counts"] != op["report"]["counts"] or any(
                not np.array_equal(ob[k], op[k], equal_nan=True)
                for k in keys) or any(
                not np.array_equal(ob["x"][k], op["x"][k])
                for k in ob["x"]) or ob["report"]["n_accepted"] != op[
                "report"]["n_accepted"] or ob["report"]["n_rejected"] != op[
                "report"]["n_rejected"]:
            raise AssertionError(f"gears: {name} differs between the gears")
        if set(ob["report"]["counts"]) != {"success"}:
            raise AssertionError(f"gears: {name} {ob['report']['counts']}")
        return {"lanes": len(ob["t"]), "linsolve": op["linsolve"],
                "equal_fields": ["x", "report"] + list(keys),
                "mean_accepted": op["report"]["n_accepted"]["mean"],
                "blocking": b, "pipelined": p}

    Tc, Asv = coupled_conditions()
    s = slice(None, None, GEAR_STRIDE)
    checks = {"coupled": both(
        "coupled", lambda **g: coupled_sweep(bt, gm, th, sm, Tc[s], Asv[s],
                                             T1_C_LU32P, device, **g),
        ("t", "status", "covg"))}
    _, T_e, x_e = energy_conditions(gm, device)
    checks["energy"] = both(
        "energy", lambda **g: energy_sweep(bt, gm, th, x_e[s], T_e[s],
                                           device, t1=T1_E_GEARS, **g),
        ("t", "status", "T", "ignition_delay"))
    checks["sdirk"] = both(
        "sdirk", lambda **g: sweep(bt, gm, th, T[s], device,
                                   t1=T1_SDIRK_GEARS, method="sdirk",
                                   jac_window=None, setup_economy=False, **g),
        ("t", "status", "tau"))
    emit({"phase": "gears", "gpu": smi, "B": B_MAIN, "segment_steps": 256,
          "bit_exact_fields": list(ref), "main_path": report,
          "newton_iters_blocking": needed, "checks_64": checks})


def phase_stream(gm, th, device, smi, by_phase):
    """Phase 19: B_STREAM main-path temperatures (in 4 x 1024 map order)
    streamed through STREAM_RESIDENT slots on the STREAM_BUCKETS ladder,
    against the admission-off sweep of the same lanes in one program; then
    the first CLIMB_LANES of them from CLIMB_RESIDENT slots, free to climb
    to CLIMB_CEILING."""
    from batchreactor_tpu_torch.parallel import ensemble_solve_segmented
    from batchreactor_tpu_torch.parallel import sweep as sw

    T4 = np.linspace(T_LO, T_HI, B_STREAM).reshape(-1, 4).T.reshape(-1)
    y0s, cfg, rhs, jac, obs, obs0 = main_path_lanes(gm, th, T4, device)
    kw = dict(segment_steps=STREAM_SEGMENT, rtol=RTOL, atol=ATOL, jac=jac,
              observer=obs, observer_init=obs0, method="bdf", jac_window=8,
              setup_economy=True)

    def run(y, c, **opts):
        sw.reset_stream_counts()
        r = gear_run(lambda: ensemble_solve_segmented(rhs, y, 0.0, T1, c,
                                                      **kw, **opts))
        r["stream"] = dict(sw.STREAM_COUNTS)
        return r

    ref = run(y0s, cfg)
    by_phase["stream_reference"] = ref["lu32p_launches_by_path"]
    st = run(y0s, cfg, admission=STREAM_RESIDENT, refill=STREAM_REFILL,
             buckets=STREAM_BUCKETS, poll_every=STREAM_POLL)
    by_phase["stream"] = st["lu32p_launches_by_path"]
    a, b = lane_fields(ref.pop("res")), lane_fields(st.pop("res"))
    c = st["stream"]
    rel = np.abs(b["tau"] / a["tau"] - 1.0)
    steps_differ = int(((a["n_accepted"] != b["n_accepted"])
                        | (a["n_rejected"] != b["n_rejected"])).sum())
    if not (np.array_equal(a["status"], b["status"])
            and np.all(a["status"] == 1) and rel.max() <= 1e-3):
        raise AssertionError(f"stream: status or tau (max rel {rel.max()}) "
                             f"off the admission-off sweep")
    if not (c["compactions"] >= 1 and c["bucket_downshifts"] >= 1
            and c["harvested_lanes"] == B_STREAM
            and c["admitted_lanes"] == B_STREAM - STREAM_RESIDENT):
        raise AssertionError(f"stream: counters {c}")
    if not st["lu32p_launches_by_path"]["warp"] > 0:
        raise AssertionError(f"stream: {st['lu32p_launches_by_path']}")
    idx = np.arange(CLIMB_LANES)
    climb = run(y0s[idx], {k: v[idx] for k, v in cfg.items()},
                admission=CLIMB_RESIDENT, refill=STREAM_REFILL,
                buckets=STREAM_BUCKETS, upshift=CLIMB_CEILING,
                poll_every=STREAM_POLL)
    cl = lane_fields(climb.pop("res"))
    if not (climb["stream"]["bucket_upshifts"] >= 1
            and np.all(cl["status"] == 1)
            and np.array_equal(cl["status"], a["status"][idx])):
        raise AssertionError(f"stream climb: {climb['stream']}, status "
                             f"{np.unique(cl['status'])}")
    rel_c = np.abs(cl["tau"] / a["tau"][idx] - 1.0)
    for r, n in ((ref, B_STREAM), (st, B_STREAM), (climb, len(idx))):
        r["cond_per_s"] = n / r["wall_s"]
        r["occupancy"] = (r["stream"]["lane_attempts"]
                          / r["stream"]["lane_capacity"]
                          if r["stream"]["lane_capacity"] else None)
    emit({"phase": "stream", "gpu": smi, "lanes": B_STREAM,
          "resident": STREAM_RESIDENT, "buckets": list(STREAM_BUCKETS),
          "refill": STREAM_REFILL, "poll_every": STREAM_POLL,
          "segment_steps": STREAM_SEGMENT, "order": "4 x 1024 map",
          "reference": ref, "stream": st,
          "lanes_bit_equal": int(lanes_equal(a, b).sum()),
          "lanes_steps_differ": steps_differ,
          "tau_max_rel": float(rel.max()),
          "tau_mean_rel": float(rel.mean()),
          "climb": {"lanes": len(idx), "resident": CLIMB_RESIDENT,
                    "upshift": CLIMB_CEILING, **climb,
                    "lanes_bit_equal": int(lanes_equal(
                        {k: v[idx] for k, v in a.items()}, cl).sum()),
                    "tau_max_rel": float(rel_c.max())}})


def ckpt_setup(gm, th, T, device):
    """Phases 20-21's checkpointed sweep of the main path's conditions at
    the temperatures T: (rhs, y0s, cfg, solver keywords), the segmented
    pipelined gear with ``linsolve="auto"`` (resolved with the whole
    sweep: ``lu32p``, warp path)."""
    y0s, cfg, rhs, jac, obs, obs0 = main_path_lanes(gm, th, T, device)
    kw = dict(segment_steps=256, rtol=RTOL, atol=ATOL, jac=jac, observer=obs,
              observer_init=obs0, method="bdf", jac_window=8,
              setup_economy=True, linsolve="auto")
    return rhs, y0s, cfg, kw


def ckpt_fields(res):
    """A checkpointed result's per-lane values as host arrays."""
    out = {f: getattr(res, f).numpy()
           for f in ("t", "y", "status", "n_accepted", "n_rejected", "h")}
    out["tau"] = res.observed["tau"].numpy()
    return out


def copy_ckpt(src, dst, chunks):
    """A checkpoint directory with only the manifest and ``chunks``."""
    import shutil

    os.makedirs(dst)
    shutil.copy(os.path.join(src, "manifest.json"), dst)
    for i in chunks:
        name = f"chunk_{i:05d}.npz"
        shutil.copy(os.path.join(src, name), os.path.join(dst, name))


def run_children(argss, timeout):
    """Run ``chip_smoke.py --child ARGS`` once per entry of ``argss``, all
    at once, each under ``resilience.run_guarded`` (SIGTERM past
    ``timeout``, SIGKILL after a grace); returns their GuardedResults."""
    from concurrent.futures import ThreadPoolExecutor

    from batchreactor_tpu_torch.resilience import run_guarded

    cmds = [[sys.executable, os.path.join(HERE, "chip_smoke.py"), "--child",
             json.dumps(a)] for a in argss]
    with ThreadPoolExecutor(len(cmds)) as ex:
        return list(ex.map(lambda c: run_guarded(
            c, timeout, grace_s=20.0, merge_stderr=True), cmds))


def child_result(guarded, name, rc=0):
    """The child's last ``RESULT`` line, or raise with its output tail
    unless it exited ``rc`` (137: killed by the fault injector)."""
    lines = [ln for ln in guarded.stdout.splitlines()
             if ln.startswith("RESULT ")]
    if guarded.timed_out or guarded.rc != rc or not lines:
        raise AssertionError(
            f"{name}: child rc {guarded.rc} (want {rc}), timed out "
            f"{guarded.timed_out}:\n{guarded.stdout[-3000:]}")
    return json.loads(lines[-1][7:])


def child_main(args):
    """A child process of phases 20-21 (``--child ARGS``): ``kind`` "ckpt"
    runs phase 20's checkpointed sweep with a fault armed; "multihost"
    joins a gloo group on cuda:0 and runs ``ensemble_solve_multihost``,
    then ``elastic_checkpointed_sweep`` with its own fault armed."""
    import torch

    sys.path.insert(0, HERE)
    import batchreactor_tpu_torch as bt
    from batchreactor_tpu_torch.parallel import checkpointed_sweep
    from batchreactor_tpu_torch.parallel import multihost as mh
    from batchreactor_tpu_torch.resilience import inject
    from batchreactor_tpu_torch.solver import linalg_cuda as lc

    device = torch.device("cuda:0")
    gm = bt.compile_gaschemistry(os.path.join(FIXTURES, "grimech.dat"),
                                 device=device)
    th = bt.create_thermo(list(gm.species),
                          os.path.join(FIXTURES, "therm.dat"), device=device)
    T = np.linspace(T_LO, T_HI, B_MAIN)
    rhs, y0s, cfg, kw = ckpt_setup(gm, th, T, device)
    if args["kind"] == "ckpt":
        inject.arm(args["inject"])
        checkpointed_sweep(rhs, y0s, 0.0, T1, cfg, args["dir"],
                           chunk_size=CKPT_CHUNK, **kw)
        print("RESULT " + json.dumps({"died": False}), flush=True)
        return 0
    rank, world = args["rank"], args["world"]
    mh.initialize(f"localhost:{args['port']}", num_processes=world,
                  process_id=rank, timeout_s=300)
    res, _, by_a, wall_a = timed(lambda: mh.ensemble_solve_multihost(
        rhs, y0s, 0.0, T1, cfg, device=device, **kw))
    if rank == 0:
        np.savez(os.path.join(args["dir"], "multihost.npz"),
                 status=res.status.numpy(), tau=res.observed["tau"].numpy())
    part = {"rank": rank, "multihost_wall_s": wall_a,
            "multihost_lu32p_launches_by_path": by_a}
    print("RESULT " + json.dumps(part), flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()
    if args.get("inject"):
        inject.arm(args["inject"])
    mh.reset_counts()
    _, _, by_b, wall_b = timed(lambda: mh.elastic_checkpointed_sweep(
        rhs, y0s, 0.0, T1, cfg, os.path.join(args["dir"], "elastic"),
        process_id=rank, num_processes=world, chunk_size=CKPT_CHUNK,
        heartbeat_s=0.5, **kw))
    print("RESULT " + json.dumps({
        **part, "elastic_wall_s": wall_b,
        "elastic_lu32p_launches_by_path": by_b,
        "elastic_counts": dict(mh.COUNTS)}), flush=True)
    return 0


def phase_resilience(bt, gm, th, T, out3, wall3, device, smi, by_phase):
    """Phase 20: ``checkpointed_sweep`` over phase 3's lanes in chunks of
    CKPT_CHUNK: (a) fresh, cold then warm, against phase 3; (b) a child
    killed before saving chunk 2, then the resume here; (c) a torn chunk
    1; (d) a hung wait under ``fetch_deadline`` with one retry; (e) three
    NaN lanes under ``quarantine=True``; (f) ``batch_reactor_sweep`` on a
    one-device mesh against ``mesh=None``.  Returns phase 20 (a)'s
    checkpoint directory's chunks (loaded) for phase 21."""
    from batchreactor_tpu_torch.parallel import checkpoint as ck
    from batchreactor_tpu_torch.parallel import checkpointed_sweep
    from batchreactor_tpu_torch.resilience import inject

    rhs, y0s, cfg, kw = ckpt_setup(gm, th, T, device)
    tmp = tempfile.mkdtemp(prefix="br_resilience_")
    d = {k: os.path.join(tmp, k) for k in "abcdef"}
    walls, by_step = {}, {}

    def run(name, path, **extra):
        ck.reset_counts()
        res, _, by_step[name], walls[name] = timed(
            lambda: checkpointed_sweep(rhs, y0s, 0.0, T1, cfg, path,
                                       chunk_size=CKPT_CHUNK, **kw, **extra))
        return ckpt_fields(res), dict(ck.COUNTS), res

    def same(name, got, ref):
        eq = lanes_equal(ref, got)
        if not eq.all():
            raise AssertionError(f"resilience: {name} equals (a) on "
                                 f"{int(eq.sum())} of {len(eq)} lanes")

    # (a) fresh, cold (its chunk shape captures), then warm
    a, _, _ = run("a_cold", d["a"])
    a2, _, _ = run("a_warm", os.path.join(tmp, "a2"))
    same("the warm run", a2, a)
    by_phase["resilience"] = by_step["a_warm"]
    check_launches("resilience", by_step["a_warm"], "warp")
    rel = np.abs(a["tau"] / out3["tau"] - 1.0)
    if not (np.array_equal(a["status"], out3["status"])
            and rel.max() <= 1e-3):
        raise AssertionError(f"resilience: (a) status or tau (max rel "
                             f"{rel.max()}) off phase 3")
    tau_bit = int((a["tau"] == out3["tau"]).sum())
    # (b) a child killed before saving chunk 2; the resume solves 2 and 3
    t0 = time.perf_counter()
    kid, = run_children([{"kind": "ckpt", "dir": d["b"],
                          "inject": "kill:chunk=2"}], timeout=300)
    walls["b_child"] = time.perf_counter() - t0
    if kid.timed_out or kid.rc != 137:
        raise AssertionError(f"resilience: the killed child exited "
                             f"{kid.rc}:\n{kid.stdout[-3000:]}")
    on_disk = sorted(n for n in os.listdir(d["b"]) if n.endswith(".npz"))
    b, cb, _ = run("b_resume", d["b"])
    if on_disk != ["chunk_00000.npz", "chunk_00001.npz"] or cb[
            "chunks_solved"] != 2:
        raise AssertionError(f"resilience: (b) {on_disk}, {cb}")
    same("(b)", b, a)
    # (c) chunk 1 torn after its save, then the resume
    copy_ckpt(d["a"], d["c"], (0, 2, 3))
    inject.arm("corrupt_chunk:chunk=1")
    run("c_tear", d["c"])
    c, cc, _ = run("c_resume", d["c"])
    if not (cc == {"chunks_solved": 1, "chunks_corrupt": 1}
            and os.path.exists(os.path.join(d["c"],
                                            "chunk_00001.npz.corrupt"))):
        raise AssertionError(f"resilience: (c) {cc}")
    same("(c)", c, a)
    # (d) the wait of chunk 3 held past fetch_deadline: a WedgeError, one
    # retry after reset_backend()
    copy_ckpt(d["a"], d["d"], (0, 1, 2))
    inject.arm(f"hang_fetch:delay={HANG_S}")
    dd, _, _ = run("d_wedge", d["d"], fetch_deadline=DEADLINE_S,
                   retry={"max_retries": 1, "backoff_s": 0.0})
    with open(os.path.join(d["d"], "manifest.json")) as f:
        ledger = json.load(f)["attempts"]
    # chunk 3's rows of this run (the copied manifest holds (a)'s)
    rows = ledger.get("3", [])[-2:]
    if [(r["attempt"], r["outcome"]) for r in rows] != [
            (0, "error"), (1, "ok")] or rows[0].get("kind") != "WedgeError":
        raise AssertionError(f"resilience: (d) ledger {ledger}")
    same("(d)", dd, a)
    # (e) three NaN lanes, re-solved by the quarantine
    # one lane in each of chunks 0, 1 and 3 (85, 341 and 853)
    lanes = tuple(c * CKPT_CHUNK + CKPT_CHUNK // 3 for c in (0, 1, 3))
    copy_ckpt(d["a"], d["e"], (2,))
    inject.arm(";".join(f"nan_lane:lane={i}" for i in lanes))
    e, _, res_e = run("e_quarantine", d["e"], quarantine=True)
    prov = res_e.provenance.numpy()
    rel_e = np.abs(e["tau"] / a["tau"] - 1.0)
    if not (np.all(prov[list(lanes)] != 0) and np.all(e["status"] == 1)
            and rel_e.max() <= 1e-3 and int((prov != 0).sum()) == 3):
        raise AssertionError(f"resilience: (e) provenance "
                             f"{prov[list(lanes)]}, tau rel {rel_e.max()}")
    # (f) a one-device mesh against mesh=None
    mesh = bt.Mesh([device])
    f0, _, by_step["f_none"], walls["f_none"] = timed(
        lambda: sweep(bt, gm, th, T, device))
    f1, _, by_step["f_mesh"], walls["f_mesh"] = timed(
        lambda: sweep(bt, gm, th, T, device, mesh=mesh))
    if not (all(np.array_equal(f0["x"][k], f1["x"][k]) for k in f0["x"])
            and np.array_equal(f0["tau"], f1["tau"], equal_nan=True)
            and f0["report"] == f1["report"]):
        raise AssertionError("resilience: (f) mesh run differs")
    emit({"phase": "resilience", "gpu": smi, "B": B_MAIN,
          "chunk_size": CKPT_CHUNK, "walls_s": walls,
          "cond_per_s_checkpointed_warm": B_MAIN / walls["a_warm"],
          "cond_per_s_phase3": B_MAIN / wall3,
          "a_tau_max_rel_vs_phase3": float(rel.max()),
          "a_tau_lanes_bit_equal_phase3": tau_bit,
          "b_child_rc": kid.rc, "b_chunks_on_disk": on_disk,
          "d_deadline_s": DEADLINE_S, "d_ledger": rows,
          "e_lanes": list(lanes),
          "e_provenance": prov[list(lanes)].tolist(),
          "e_lanes_bit_equal": int(lanes_equal(a, e).sum()),
          "e_tau_max_rel": float(rel_e.max()),
          "f_mesh": repr(mesh), "lanes_bit_equal_to_a": B_MAIN,
          "lu32p_launches_by_path": by_step["a_warm"],
          "lu32p_launches_by_step": by_step})
    return d["a"]


def phase_multihost(dir_a, out3, smi, by_phase):
    """Phase 21: two child processes on cuda:0 in one gloo group,
    ``ensemble_solve_multihost`` over phase 3's lanes against phase 3,
    then ``elastic_checkpointed_sweep`` with rank 1 killed before it saves
    its second chunk: the survivor takes it over and every chunk equals
    phase 20 (a)'s bit for bit."""
    import socket

    from batchreactor_tpu_torch.parallel import checkpoint as ck

    tmp = tempfile.mkdtemp(prefix="br_multihost_")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    kids = run_children(
        [{"kind": "multihost", "rank": r, "world": 2, "port": port,
          "dir": tmp, "inject": "kill:chunk=3" if r == 1 else None}
         for r in range(2)], timeout=400)
    wall = time.perf_counter() - t0
    r1 = child_result(kids[1], "multihost rank 1", rc=137)
    r0 = child_result(kids[0], "multihost rank 0")
    with np.load(os.path.join(tmp, "multihost.npz")) as z:
        status, tau = z["status"], z["tau"]
    rel = np.abs(tau / out3["tau"] - 1.0)
    if not (np.array_equal(status, out3["status"]) and rel.max() <= 1e-3):
        raise AssertionError(f"multihost: status or tau (max rel "
                             f"{rel.max()}) off phase 3")
    el = os.path.join(tmp, "elastic")
    n_chunks = B_MAIN // CKPT_CHUNK
    names = sorted(n for n in os.listdir(el) if n.endswith(".npz"))
    if names != [f"chunk_{i:05d}.npz" for i in range(n_chunks)]:
        raise AssertionError(f"multihost: elastic chunks {names}")
    for i in range(n_chunks):
        got, _ = ck.load_result(os.path.join(el, names[i]))
        want, _ = ck.load_result(os.path.join(dir_a, names[i]))
        eq = lanes_equal(ckpt_fields(want), ckpt_fields(got))
        if not eq.all():
            raise AssertionError(f"multihost: elastic chunk {i} equals "
                                 f"phase 20 (a) on {int(eq.sum())} lanes")
    if r0["elastic_counts"]["chunks_reassigned"] < 1:
        raise AssertionError(f"multihost: {r0['elastic_counts']}")
    # the launches of both ranks: rank 1's elastic run died before its
    # report, so its count is the collective solve's alone
    by = {p: r0["multihost_lu32p_launches_by_path"][p]
          + r0["elastic_lu32p_launches_by_path"][p]
          + r1["multihost_lu32p_launches_by_path"][p]
          for p in ("warp", "cta")}
    check_launches("multihost", by, "warp")
    by_phase["multihost"] = by
    emit({"phase": "multihost", "gpu": smi, "B": B_MAIN, "processes": 2,
          "backend": "gloo", "device": "cuda:0 in both", "wall_s": wall,
          "rank0": r0, "rank1": r1, "rank1_rc": kids[1].rc,
          "tau_max_rel_vs_phase3": float(rel.max()),
          "tau_lanes_bit_equal_phase3": int((tau == out3["tau"]).sum()),
          "elastic_chunks_bit_equal_phase20a": n_chunks,
          "lu32p_launches_by_path": by})


def profile_main_path(bt, gm, th, T, device, warm_wall, factor_event_ms,
                      pipeline):
    """Where the main path's time goes in one gear: the sweep under
    torch.profiler, the device's busy share, the host syncs of the sweep
    and the kernels that take the most device time.

    In the blocking gear the port's layers are labelled by
    ``record_function`` ranges (RHS, Jacobian, lu32p factor, Newton solve,
    whole segment): a layer's ``host_ms`` is the host time inside its
    ranges and its ``device_ms`` the kernel time launched from them.  The
    profiler links a kernel launched through ctypes to no PyTorch op, so
    the ``lu32p`` kernels (launched only by the factor layer) are added to
    that layer by name, and their profiled time is set beside
    ``factor_event_ms``, the same launches timed with CUDA events
    (launches x hot time).  The pipelined gear replays the graphs phase 3
    captured, which no Python layer runs through, so it has no layers.
    The idle share is given against the profiled wall and against
    ``warm_wall``, the same sweep's wall without the profiler (its tracing
    slows the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from batchreactor_tpu_torch import api
    from batchreactor_tpu_torch.solver import bdf, graphs

    def labelled(name, fn):
        def wrap(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return wrap

    def labelled_builder(name, build):
        return lambda *a, **k: labelled(name, build(*a, **k))

    patches = [] if pipeline else [
        (api, "make_gas_rhs", labelled_builder("layer:rhs",
                                               api.make_gas_rhs)),
        (api, "make_gas_jac", labelled_builder("layer:jacobian",
                                               api.make_gas_jac)),
        (bdf, "factor_m", labelled("layer:factor", bdf.factor_m)),
        (bdf, "apply_factor", labelled("layer:solve", bdf.apply_factor)),
        (bdf, "solve", labelled("layer:segment", bdf.solve))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        if patches:
            # the labelled builders make new callables: drop cached ones
            api._SWEEP_FNS.clear()
        torch.cuda.synchronize()
        graphs.reset_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sweep(bt, gm, th, T, device, pipeline=pipeline)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = dict(graphs.COUNTS)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        if patches:
            api._SWEEP_FNS.clear()
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
        raise RuntimeError(f"torch.profiler recorded no device time "
                           f"(pipeline={pipeline})")
    return {"gear": "pipelined" if pipeline else "blocking", "wall_s": wall,
            "warm_wall_s": warm_wall, "device_busy_ms": busy_s * 1e3,
            "idle_share": 1.0 - busy_s / wall,
            "idle_share_unprofiled": 1.0 - busy_s / warm_wall,
            "host_syncs": counts["host_syncs"],
            "graph_replays": counts["replays"],
            "newton_iters": counts["newton_iters"],
            "kernel_launches": sum(k[1] for k in kernels), "layers": layers,
            "lu32p_profiled_ms": lu_ms, "lu32p_profiled_calls": lu_calls,
            "lu32p_event_ms": factor_event_ms,
            "lu32p_profiled_over_event": lu_ms / factor_event_ms,
            "top_kernels": [{"ms": m, "calls": c, "name": n}
                            for m, c, n in kernels[:12]]}


def profile_gears(bt, gm, th, device, smi):
    """``--profile-only``: the main path's sweep (cold, then warm) in each
    gear, then each under torch.profiler (``profile_main_path``), with the
    kernel's hot time on the main path's matrices for the factor layer.
    Prints no contract line."""
    import torch

    T = np.linspace(T_LO, T_HI, B_MAIN)
    hot_ms = time_kernel(main_path_matrices(gm, th, device))["hot_ms"]
    warm = {}
    for pipe in (True, False):
        for _ in range(2):      # cold, then warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, launches, _ = counted(
                lambda: sweep(bt, gm, th, T, device, pipeline=pipe))
            torch.cuda.synchronize()
            warm[pipe] = (time.perf_counter() - t0, launches)
    for pipe in (True, False):
        emit({"phase": "profile", "gpu": smi,
              **profile_main_path(bt, gm, th, T, device, warm[pipe][0],
                                  warm[pipe][1] * hot_ms, pipe)})
    print(smi, flush=True)
    return 0


def main():
    import torch

    if "--child" in sys.argv[1:]:
        return child_main(json.loads(sys.argv[sys.argv.index("--child")
                                              + 1]))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import batchreactor_tpu_torch as bt
    from batchreactor_tpu_torch.solver import graphs
    from batchreactor_tpu_torch.solver import linalg_cuda as lc

    t_start = time.perf_counter()
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
    profile_only = "--profile-only" in sys.argv[1:]
    t0 = time.perf_counter()
    gm = bt.compile_gaschemistry(os.path.join(FIXTURES, "grimech.dat"))
    th = bt.create_thermo(list(gm.species),
                          os.path.join(FIXTURES, "therm.dat"))
    if profile_only:
        return profile_gears(bt, gm, th, device, smi)
    check_kernel(device)
    sm = bt.compile_mech(os.path.join(FIXTURES, "ch4ni.xml"), th,
                         list(gm.species))
    gen = torch.Generator().manual_seed(1)
    J_c = coupled_jacobians(gm, th, sm, device)
    eye_c = torch.eye(J_c.shape[-1], dtype=torch.float64, device=device)
    timing = {}
    # coupled_n66: the coupled path's Newton matrices M = I - c J at its
    # initial states, c = 1e-7 s as on the other paths, then at the larger
    # steps where cond(M) reaches 1e14 and 1e18
    for name, build, same_pivots in (
            ("main", lambda: main_path_matrices(gm, th, device), True),
            ("main_b4096", lambda: main_path_matrices(gm, th, device, 4096),
             True),
            ("cta_n120", lambda: separated(B_MAIN, 120, gen, device), True),
            ("cta_n176", lambda: separated(B_MAIN, 176, gen, device), True),
            ("cta_n240", lambda: separated(B_MAIN, 240, gen, device), True),
            ("coupled_n66", lambda: eye_c - 1e-7 * J_c, True),
            ("coupled_n66_c1e-5", lambda: eye_c - 1e-5 * J_c, False),
            ("coupled_n66_c1e-3", lambda: eye_c - 1e-3 * J_c, False),
            ("padded_n96", lambda: padded_matrices(gm, th, device, 1e-7),
             True),
            ("padded_n96_c1e-5", lambda: padded_matrices(gm, th, device,
                                                         1e-5), True),
            ("padded_n96_c1e-3", lambda: padded_matrices(gm, th, device,
                                                         1e-3), True)):
        timing[name] = time_kernel(build(), same_pivots)
        emit({"phase": "kernel_timing", "case": name, "gpu": smi,
              **timing[name]})
    emit({"phase": "coupled_conditioning", "gpu": smi,
          **coupled_conditioning(J_c, gm.n_species)})
    del J_c, eye_c
    # energy_n54: the energy path's Newton matrices M = I - c J at its
    # initial adiabatic states, whose T row and column are 1e3-1e4 times
    # the species entries
    J_e = energy_jacobians(gm, th, device)
    eye_e = torch.eye(J_e.shape[-1], dtype=torch.float64, device=device)
    for name, c in (("energy_n54", 1e-7), ("energy_n54_c1e-5", 1e-5),
                    ("energy_n54_c1e-3", 1e-3)):
        timing[name] = time_kernel(eye_e - c * J_e, True)
        emit({"phase": "kernel_timing", "case": name, "gpu": smi,
              **timing[name]})
    del J_e, eye_e
    emit({"phase": "kernel_checked", "seconds": time.perf_counter() - t0})

    # ---- phase 3: the main path -----------------------------------------
    T = np.linspace(T_LO, T_HI, B_MAIN)
    t0 = time.perf_counter()
    sweep(bt, gm, th, T, device)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    lc.LAUNCHES = 0
    lc.LAUNCHES_BY_PATH.update(warp=0, cta=0)
    graphs.reset_counts()
    t0 = time.perf_counter()
    out = sweep(bt, gm, th, T, device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lc.LAUNCHES
    by_path = dict(lc.LAUNCHES_BY_PATH)
    counts3 = dict(graphs.COUNTS)
    tau = out["tau"]
    rep = rep_main = out["report"]
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
          "kernel_share": launches * hot_ms / 1e3 / wall,
          "gear": "pipelined", "graph_replays": counts3["replays"],
          "host_syncs": counts3["host_syncs"],
          "graphs_captured_warm": graphs.captures()})

    if "--profile" in sys.argv[1:]:
        # both gears: the blocking one's warm wall first, unprofiled
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, blk_launches, _ = counted(
            lambda: sweep(bt, gm, th, T, device, pipeline=False))
        torch.cuda.synchronize()
        blk_wall = time.perf_counter() - t0
        # the pipelined gear first: it replays the graphs phase 3 captured
        for pipe, warm, n_launch in ((True, wall, launches),
                                     (False, blk_wall, blk_launches)):
            emit({"phase": "profile", "gpu": smi,
                  **profile_main_path(bt, gm, th, T, device, warm,
                                      n_launch * hot_ms, pipe)})

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

    # ---- phase 6: the coupled path -------------------------------------
    # linsolve="auto" resolves to the float64 lu for a state with coverages
    # (solver.linalg.resolve_linsolve says why)
    by_phase = {"gas_main": by_path}
    Tc, Asv = coupled_conditions()
    B_C = Tc.shape[0]
    t0 = time.perf_counter()
    coupled_sweep(bt, gm, th, sm, Tc, Asv, T1_C, device)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_c, _, by_phase["coupled"] = counted(
        lambda: coupled_sweep(bt, gm, th, sm, Tc, Asv, T1_C, device))
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    dev_c = check_sweep("coupled", out_c, B_C, by_phase["coupled"], None)
    rep = out_c["report"]
    emit({"phase": "coupled", "gpu": smi, "B": B_C,
          "mechanism": "GRI-3.0 (53 species) + CH4/Ni (13 surface species, "
                       "42 reactions), n = 66",
          "T": [T_LO_C, T_HI_C], "Asv": list(ASV_DECADES), "t1": T1_C,
          "linsolve": out_c["linsolve"], "jac_window": out_c["jac_window"],
          "cold_s": cold_s, "wall_s": wall_c, "cond_per_s": B_C / wall_c,
          "mean_accepted": rep["n_accepted"]["mean"],
          "max_accepted": rep["n_accepted"]["max"],
          "min_accepted": rep["n_accepted"]["min"],
          "covg_sum_max_dev": dev_c,
          "lu32p_launches_by_path": by_phase["coupled"]})

    # ---- phase 7: the CTA kernel on the coupled path ---------------------
    # the same sweep with linsolve="lu32p" over its first T1_C_LU32P s,
    # against the float64 lu over the same horizon
    t0 = time.perf_counter()
    out_k, _, by_phase["coupled_lu32p"] = counted(
        lambda: coupled_sweep(bt, gm, th, sm, Tc, Asv, T1_C_LU32P, device,
                              linsolve="lu32p"))
    torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    dev_k = check_sweep("coupled_lu32p", out_k, B_C,
                        by_phase["coupled_lu32p"], "cta")
    ref = coupled_sweep(bt, gm, th, sm, Tc, Asv, T1_C_LU32P, device)
    check_sweep("coupled_lu32p reference", ref, B_C, {}, None)
    got, want = coupled_states(out_k, th.species), coupled_states(
        ref, th.species)
    diff = np.abs(got - want)
    if not np.all(diff <= 1e-5 + 1e-3 * np.abs(want)):
        raise AssertionError(f"coupled lu32p vs lu: max abs {diff.max()}")
    big = np.abs(want) > 1e-6
    launches_k = by_phase["coupled_lu32p"]["cta"]
    emit({"phase": "coupled_lu32p", "gpu": smi, "B": B_C,
          "t1": T1_C_LU32P, "linsolve": out_k["linsolve"],
          "wall_s": wall_k,
          "mean_accepted": out_k["report"]["n_accepted"]["mean"],
          "max_accepted": out_k["report"]["n_accepted"]["max"],
          "lu_max_accepted": ref["report"]["n_accepted"]["max"],
          "covg_sum_max_dev": dev_k,
          "max_abs_diff_vs_lu": float(diff.max()),
          "max_rel_diff_vs_lu": float((diff[big] / np.abs(want[big])).max()),
          "bound": "1e-5 + 1e-3 |lu|",
          "lu32p_launches": launches_k,
          "lu32p_launches_by_path": by_phase["coupled_lu32p"],
          "kernel_share": launches_k * timing["coupled_n66"]["hot_ms"]
          / 1e3 / wall_k, "seconds": time.perf_counter() - t0})

    # ---- phase 8: the surface path ---------------------------------------
    th7 = bt.create_thermo(GAS7, os.path.join(FIXTURES, "therm.dat"))
    sm7 = bt.compile_mech(os.path.join(FIXTURES, "ch4ni.xml"), th7, GAS7)
    Ts = np.linspace(T_LO_S, T_HI_S, B_SURF)
    t0 = time.perf_counter()
    out_s, _, by_phase["surface"] = counted(
        lambda: surface_sweep(bt, th7, sm7, Ts, device))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    dev_s = check_sweep("surface", out_s, B_SURF, by_phase["surface"], None)
    lane = int(np.argmin(np.abs(Ts - 1073.15)))
    x_h2, x_co = out_s["x"]["H2"][lane], out_s["x"]["CO"][lane]
    if not (x_h2 > 0.01 and x_co > 0.001):
        raise AssertionError(f"surface: no syngas at {Ts[lane]} K: "
                             f"x_H2 {x_h2}, x_CO {x_co}")
    emit({"phase": "surface", "gpu": smi, "B": B_SURF,
          "mechanism": "CH4/Ni over 7 gas species, n = 20", "Asv": 10.0,
          "t1": T1_S, "linsolve": out_s["linsolve"], "wall_s": wall_s,
          "cond_per_s": B_SURF / wall_s,
          "mean_accepted": out_s["report"]["n_accepted"]["mean"],
          "max_accepted": out_s["report"]["n_accepted"]["max"],
          "covg_sum_max_dev": dev_s, "T_syngas": float(Ts[lane]),
          "x_H2": float(x_h2), "x_CO": float(x_co),
          "lu32p_launches_by_path": by_phase["surface"]})

    # ---- phase 9: the user-defined-chemistry path ------------------------
    gm_h = bt.compile_gaschemistry(os.path.join(FIXTURES, "h2o2.dat"))
    th_h = bt.create_thermo(list(gm_h.species),
                            os.path.join(FIXTURES, "therm.dat"))
    Tu = np.linspace(T_LO_U, T_HI_U, B_UDF)
    t0 = time.perf_counter()
    out_u, launches_u, by_phase["udf"] = counted(
        lambda: bt.batch_reactor_sweep(
            {"H2": 0.25, "O2": 0.25, "N2": 0.5}, Tu, 1e5, T1_U,
            chem=bt.Chemistry(userchem=True,
                              udf=h2_decay_udf(th_h.species, device)),
            thermo_obj=th_h, rtol=RTOL, atol=ATOL, segment_steps=256,
            device=device))
    torch.cuda.synchronize()
    wall_u = time.perf_counter() - t0
    check_sweep("udf", out_u, B_UDF, by_phase["udf"], "warp")
    f = 0.25 * np.exp(-Tu / 1e5 * T1_U)
    rel_u = np.abs(out_u["x"]["H2"] / (f / (0.75 + f)) - 1.0)
    if not np.all(rel_u <= 1e-3):
        raise AssertionError(f"udf: x_H2 off the closed form by {rel_u.max()}")
    emit({"phase": "udf", "gpu": smi, "B": B_UDF,
          "source": "first-order H2 decay, k = T/1e5 1/s, on h2o2 (n = 9)",
          "t1": T1_U, "linsolve": out_u["linsolve"], "wall_s": wall_u,
          "mean_accepted": out_u["report"]["n_accepted"]["mean"],
          "x_H2_max_rel_err": float(rel_u.max()),
          "lu32p_launches": launches_u,
          "lu32p_launches_by_path": by_phase["udf"]})

    # ---- phase 10: the file-driven surface entry point -------------------
    with tempfile.TemporaryDirectory() as tmp:
        xml = os.path.join(tmp, "batch.xml")
        with open(xml, "w") as f:
            f.write("<batch><surface_mech>ch4ni.xml</surface_mech>"
                    f"<gasphase>{' '.join(GAS7)}</gasphase>"
                    "<molefractions>CH4=0.25,H2O=0.25,N2=0.5</molefractions>"
                    "<T>1073.15</T><p>1e5</p><Asv>10</Asv>"
                    f"<time>{T1_S}</time></batch>")
        t0 = time.perf_counter()
        status = bt.batch_reactor(xml, FIXTURES, surfchem=True,
                                  verbose=False)
        covg_csv = os.path.join(tmp, "surface_covg.csv")
        with open(covg_csv) as f:
            lines = f.read().splitlines()
    theta = np.array([float(v) for v in lines[-1].split(",")[2:]])
    if status != "Success" or abs(theta.sum() - 1.0) > 1e-6:
        raise AssertionError(f"file-driven surface: {status}, coverage sum "
                             f"{theta.sum()}")
    emit({"phase": "file_driven_surface", "status": status,
          "t_end": float(lines[-1].split(",")[0]), "rows": len(lines) - 1,
          "covg_sum": float(theta.sum()),
          "seconds": time.perf_counter() - t0})

    # ---- phases 11-14: the energy path, SDIRK4, the Newton-mode A/B ------
    phase_energy(bt, gm, th, device, smi, timing, by_phase)
    Ts = T[::SDIRK_STRIDE]
    phase_sdirk(bt, gm, th, Ts, tau[::SDIRK_STRIDE], rep_main, device, smi,
                by_phase)
    phase_linsolve_ab(gm, th, Ts, device, smi, by_phase)

    # ---- phases 15-21: padding, sensitivities, the gears, the stream, ---
    # ---- checkpointing and resilience, the multi-process tiers -----------
    walls = {}
    ckpt_dir = []
    out3 = {"status": out["status"], "tau": tau}
    for name, run in (
            ("padded_gas", lambda: phase_padded(bt, gm, th, T, tau, rep_main,
                                                device, smi, by_phase)),
            ("sens_forward", lambda: phase_sens_forward(gm, th, device,
                                                        smi, by_phase)),
            ("adjoint", lambda: phase_adjoint(gm, th, T, device, smi)),
            ("gears", lambda: phase_gears(bt, gm, th, sm, T, device, smi,
                                          by_phase)),
            ("stream", lambda: phase_stream(gm, th, device, smi,
                                            by_phase)),
            ("resilience", lambda: ckpt_dir.append(phase_resilience(
                bt, gm, th, T, out3, wall, device, smi, by_phase))),
            ("multihost", lambda: phase_multihost(ckpt_dir[0], out3, smi,
                                                  by_phase))):
        t0 = time.perf_counter()
        run()
        walls[name] = time.perf_counter() - t0
    emit({"phase": "walls", "new_phases_s": walls,
          "total_s": time.perf_counter() - t_start})

    print(smi, flush=True)
    kernels = []
    for path, case in (("warp", "main"), ("cta", "coupled_n66")):
        kt = timing[case]
        kernels.append({
            "name": f"lu32p_{path}", "route": "cuda",
            "source": "batchreactor_tpu_torch/csrc/lu32p.cu",
            "replaces": "batchreactor_tpu/solver/linalg_pallas.py:69",
            "launches": sum(c[path] for c in by_phase.values()),
            "launches_by_phase": {p: c[path] for p, c in by_phase.items()},
            "on_paths": [p for p, c in by_phase.items() if c[path]],
            "timing_case": case,
            "pass": True, "shape": kt["shape"],
            "max_abs_err": kt["max_abs_err"], "ms": kt["ms"],
            "hot_ms": kt["hot_ms"], "plain_ms": kt["plain_ms"],
            "bound_ms": kt["bound_ms"], "bound_by": kt["bound_by"],
            "share_of_bound": kt["share_of_bound"],
            "library_ms": kt["library_ms"],
            "by_case": {c: {k: timing[c][k] for k in (
                "shape", "ms", "hot_ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by", "share_of_bound", "max_abs_err")}
                for c in timing if timing[c]["path"] == path}})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
