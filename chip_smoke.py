"""On-card smoke run of the PyTorch/CUDA port (``batchreactor_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py            # add --profile for the time breakdown
    python3 chip_smoke.py --profile-only   # only the breakdown, both gears
    python3 chip_smoke.py --serving-only   # phase 3, then phases 23-24
    python3 chip_smoke.py --native-only    # phases 3 and 5, then phase 25
    python3 chip_smoke.py --analysis-only  # phase 26 alone
    python3 chip_smoke.py --northstar-only # phase 27 alone

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
  phase 3's temperature range to T1 / 2 over ln A of the 18 ``*CH4*``
  reactions
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
  chunk equals phase 20's bit for bit;
- observability (phase 22): phase 3's sweep with ``telemetry=True`` and a
  64-attempt timeline, cold and warm, equal to phase 3 to the bit, its
  per-lane counters checked against the result and each other, phase 3's
  host syncs and launches; the blocking gear's counters and rings equal
  to the bit; the compile watch (captures cold, none warm); a thread
  scraping ``/metrics`` and ``/healthz`` while a ``live_metrics`` sweep
  runs; the report's JSONL, Prometheus and rendering; a
  ``utils.profiling.device_trace`` that names the kernel as often as it
  was counted; and ``checkpointed_sweep`` with a recorder (4 chunk solves,
  then 4 loads);
- serving (phase 23): a ``serving.SolverSession`` on GRI-3.0 (1024 slots
  on the ladder (256, 512, 1024), ``lu32p``, the main path's BDF
  settings, the CH4 marker, counters on, ``adiabatic_v`` enabled) warmed,
  then (b) phase 3's 1024 temperatures as 8 concurrent HTTP requests of
  128 lanes on a ``127.0.0.1`` port: every lane ``success``, tau within
  1e-3 and x within 1e-5 + 1e-3|x| of phase 3, no graph captured, warp
  launches, latency percentiles and the lanes bit-equal to phase 3; (c) a
  64-lane ``adiabatic_v`` request on phase 11's first lanes beside a
  thread scraping ``/metrics``; (d) ``overloaded`` past the queue bound,
  then ``draining`` during a drain that answers its stalled request; (e)
  two resident epochs on the one card against (b); (f) ``python -m
  batchreactor_tpu_torch.tools.serve`` as a child process, SIGTERM while
  two requests stall: exit 0, every accepted request answered, a
  ``draining`` answer and a flight dump;
- the fleet (phase 24): two member daemons of 256 slots as child
  processes on the one card behind an in-process ``fleet.FleetRouter``;
  8 requests of 64 lanes over 4 horizons (two waves), one member
  SIGKILLed while it holds work: every request answered once, the killed
  member's requests failed over, each answer against the same lanes
  solved by phase 23's session, both hosts in the router's ``/metrics``,
  the traces stitched (a failover one trace of two hops), exit codes 0
  and -9;
- the native CPU runtime (phase 25): ``native/br_native.cpp`` built with
  g++, ``native.solve_gas_bdf`` on 8 main-path lanes against phase 3's
  delays and ``batch_reactor(backend="cpu")`` against phase 5; phase 3's
  lanes through ``checkpointed_sweep(..., quarantine={"oracle": True})``
  equal to phase 20 (a) to the bit; then one chunk whose two lanes fail
  every device pass (``lu32p``), answered by the quarantine's oracle rung
  (``native_oracle`` over the sweep's RHS on the card) within 1e-3 of
  phase 3; and ``tools/fault_smoke.py`` on the card in a child process;
- static analysis (phase 26, ``chip_smoke.py --analysis-only`` in a
  child process started beside phase 17 and joined in its slot):
  ``tools/brlint.py``'s tier A and concurrency lint over the checkout
  (clean), the contract tier on ``cuda`` (every registered step program
  captured on the h2o2 fixture at B = 8, every obligation held on the
  captured graphs, ``bdf-step-lu32p``'s graph containing the ``lu32p``
  kernel), and the ``lu32p`` window's replay against the same steps run
  eagerly with the plain version;
- the north-star map (phase 27): ``tools/northstar_baseline.py`` on an
  8 x 8 sample of the map (the native BDF, one lane at a time) in a child
  process that cannot see the card, started beside phase 17; then
  ``tools/northstar_sweep.py``'s ``run_sweep`` at full width, 64 T x 64
  phi = 4096 GRI-3.0 lanes over phi 0.6-1.6 with float32 rate
  exponentials, in chunks of 512 sorted by the baseline's lane costs
  (every lane ``success``, tau within 1e-3 of the native BDF on 8 spot
  lanes, warp launches), its resume (every chunk loaded, nothing
  launched, every lane equal to the bit), and the map's diagonal with
  float64 exponentials (status equal, tau within 1e-3).

Every path is driven with the launch counts set to 0 just before it and
read just after; a CUDA graph adds its captured launches on every replay.
The child processes of phases 20-21 (``chip_smoke.py --child ARGS``) and
26 (``--analysis-only``) do the same in their own process and report
their counts; phase 27's baseline child runs on the host only.
``--profile`` adds a phase that runs the gas main path once more in each
gear under ``torch.profiler`` and prints where its time goes (per layer
and per kernel); ``--profile-only`` runs only that,
``--telemetry-only`` only phase 3's sweep and phase 22,
``--serving-only`` only phase 3's sweep and phases 23-24,
``--native-only`` only phase 3's sweep, phase 5 and phase 25,
``--analysis-only`` only phase 26, and ``--northstar-only`` only phase
27, its baseline alone on the host first (these six print no contract
line).  Each phase prints one JSON line; any failure
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
# (the SDIRK4 check only to T1 / 8: its blocking gear sets the phase's
# wall, and the whole script has a 1000 s target)
T1_E_GEARS, T1_SDIRK_GEARS = 1e-3, T1 / 8
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
# ... over T1 / 2 (cut from T1 to keep the script under 1000 s)
T1_SENS = T1 / 2
# the checkpointed main path (phases 20-21): chunks of 256 lanes; the hung
# wait of phase 20 (d) is held HANG_S s against a DEADLINE_S s deadline
CKPT_CHUNK = 256
DEADLINE_S, HANG_S = 5.0, 30.0
# the native runtime (phase 25): native.solve_gas_bdf on every
# NATIVE_STRIDE-th main-path temperature (8 lanes, lane 0 first); the
# oracle rung on chunk ORACLE_CHUNK of phase 20's chunking, whose local
# lanes ORACLE_LANES fail every device pass
NATIVE_STRIDE = 128
ORACLE_CHUNK, ORACLE_LANES = 1, (40, 200)
# the north-star map (phase 27): tools/northstar_sweep.py at its defaults,
# NS_N T x NS_N phi = 4096 lanes in cost-sorted chunks of NS_CHUNK, the lane
# costs from its single-core baseline on an NS_BASELINE_N x NS_BASELINE_N
# sample (64 lanes, the native BDF) in a child process
NS_N, NS_CHUNK, NS_BASELINE_N = 64, 512, 8
BESIDE_17 = ("phase 17 (adjoint) and the next phases, with phase 25 (d)'s "
             "fault smoke and phase 26 in child processes")
# the adjoint ranking (phase 17): every 128th main-path temperature (8
# lanes; the Python loop of stage solves, not the lanes, sets its wall);
# the forward-against-adjoint check runs every 16th of the 64 coolest
# temperatures to T1_SENS_CROSS, before they ignite (T1 / 16: cut from
# T1 / 4 and T1 / 8 to keep the script under 1000 s)
SENS_LANES = 8
T1_SENS_CROSS = T1 / 16
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


def check_kernel(device, batches=(1, 1024),
                 sizes=(1, 9, 13, 53, 64, 65, 66, 120, 176, 240),
                 extra=((4096, 9), (4096, 53))):
    """Phase 2: both paths of the lu32p kernel against its plain version on
    the card, and the contract cases on both paths (at n = 70 for the CTA
    path).  ``extra`` holds B = 4096 at the sizes the driven paths factor
    there (n = 9: phase 9's UDF path on h2o2; n = 53: phase 19's 4096-lane
    GRI-3.0 reference sweep, also the ``main_b4096`` timing case); the
    other sizes at B = 4096 were cut to keep the script under 1000 s."""
    import torch

    from batchreactor_tpu_torch.solver import linalg_cuda as lc

    gen = torch.Generator().manual_seed(0)
    cases = []
    for B, n in [(B, n) for B in batches for n in sizes] + list(extra):
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


def file_driven_h2o2(bt, **kw):
    """``batch_reactor`` on the h2o2 XML (10 s to equilibrium) in a
    temporary directory: (status, the profile's rows as dicts)."""
    with tempfile.TemporaryDirectory() as tmp:
        xml = os.path.join(tmp, "batch.xml")
        with open(xml, "w") as f:
            f.write("<batch><gas_mech>h2o2.dat</gas_mech>"
                    "<molefractions>H2=0.25,O2=0.25,N2=0.5</molefractions>"
                    "<T>1173.0</T><p>1e5</p><time>10.0</time></batch>")
        status = bt.batch_reactor(xml, FIXTURES, gaschem=True, verbose=False,
                                  **kw)
        with open(os.path.join(tmp, "gas_profile.csv")) as f:
            lines = f.read().splitlines()
    head = lines[0].split(",")
    return status, [dict(zip(head, map(float, ln.split(","))))
                    for ln in lines[1:]]


def phase_file_driven(bt):
    """Phase 5: the file-driven entry point on h2o2; returns its last
    profile row."""
    t0 = time.perf_counter()
    status, rows = file_driven_h2o2(bt)
    row = rows[-1]
    if status != "Success" or abs(row["H2O"] - 2 / 7) > 1e-4 or abs(
            row["O2"] - 1 / 7) > 1e-4:
        raise AssertionError(f"file-driven h2o2: {status} {row}")
    emit({"phase": "file_driven", "status": status, "t_end": row["t"],
          "x_H2O": row["H2O"], "x_O2": row["O2"], "rows": len(rows),
          "seconds": time.perf_counter() - t0})
    return row


def sweep(bt, gm, th, T, device, t1=T1, **kw):
    """The main path's sweep of the temperatures T; ``kw`` overrides its
    solver configuration."""
    cfg = dict(method="bdf", jac_window=8, setup_economy=True,
               segment_steps=256)
    cfg.update(kw)
    return bt.batch_reactor_sweep(
        COMP, T, 1e5, t1, chem=bt.Chemistry(gaschem=True), thermo_obj=th,
        md=gm, rtol=RTOL, atol=ATOL, ignition_marker="CH4", device=device,
        **cfg)


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
    return x_e, T_e, tau_e


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
    temperatures (its range at a smaller depth) to T1_SENS with
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
            rt, y0s[:n_lanes], 0.0, T1_SENS, theta,
            {k: v[:n_lanes] for k, v in cfg.items()}, rtol=RTOL, atol=ATOL,
            jac=jac, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    res, launches, by_phase["sens_forward"], wall = timed(fwd)
    peak = torch.cuda.max_memory_allocated()
    check_launches("sens_forward", by_phase["sens_forward"], "warp")
    plain, _, by_plain, wall_plain = timed(lambda: ensemble_solve(
        lambda t, y, c: rt(t, y, theta, c), y0s, 0.0, T1_SENS, cfg, rtol=RTOL,
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
          "reactions": "*CH4*", "t1": T1_SENS,
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
    largest; then on 4 lanes (every 16th of the coolest 64) to
    T1_SENS_CROSS at
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
    t1c = T1_SENS_CROSS
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
    """Phase 18: the main path's sweep in both gears, blocking and
    pipelined at poll_every 1 and 4 (each cold, its graphs dropped first,
    then warm), every lane equal to the bit; then (:func:`gear_checks`)
    blocking against pipelined on 64 lanes each of the coupled (f64
    ``lu``), energy (the jvp T column) and SDIRK4 (``inv32``) paths."""
    from batchreactor_tpu_torch.parallel import ensemble_solve_segmented
    from batchreactor_tpu_torch.solver import graphs

    y0s, cfg, rhs, jac, obs, obs0 = main_path_lanes(gm, th, T, device)
    kw = dict(segment_steps=256, rtol=RTOL, atol=ATOL, jac=jac,
              observer=obs, observer_init=obs0, method="bdf", jac_window=8,
              setup_economy=True)

    def main(**gear):
        return gear_run(lambda: ensemble_solve_segmented(
            rhs, y0s, 0.0, T1, cfg, **kw, **gear))

    # the blocking gear captures nothing, so its first run is its warm
    # run (phase 3 built every kernel and program it needs)
    runs = {"blocking_warm": main(pipeline=False)}
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

    checks = gear_checks(bt, gm, th, sm, T, device)
    emit({"phase": "gears", "gpu": smi, "B": B_MAIN, "segment_steps": 256,
          "bit_exact_fields": list(ref), "main_path": report,
          "newton_iters_blocking": needed, "checks_64": checks})


def gear_checks(bt, gm, th, sm, T, device):
    """Phase 18's 64-lane checks, blocking against pipelined through the
    API, on the coupled, energy and SDIRK4 paths (every GEAR_STRIDE-th
    lane): statuses, step counts and every field equal to the bit."""
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
    return checks


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


# the telemetry cell (phase 22): the main path's sweep with the solver
# counters and a ring of each lane's last TIMELINE attempts
TIMELINE = 64
# the scraper thread of phase 22 (d): its period and its URL timeout (s);
# the live sweep runs segments of LIVE_SEGMENT attempts polled after each,
# so its in-flight state is published about five times (a main-path lane
# takes 247-305 attempts)
SCRAPE_EVERY_S, SCRAPE_TIMEOUT_S = 0.02, 5.0
LIVE_SEGMENT = 64
# the traced sweep of phase 22 (f): (d)'s program over the first 1/1000
# of the horizon (the whole horizon runs ~850 000 kernels and its first
# 1/16 ~630 000, whose Chrome trace took 39 s to write and read back)
TRACE_T1 = T1 / 1000


def captured_driver():
    """A wrapper of the API's segmented driver that keeps every
    SolveResult it returns (the API reports no per-lane step counts) and
    a function that restores the driver: ``(results, restore)``."""
    from batchreactor_tpu_torch import api

    orig = api.ensemble_solve_segmented
    results = []

    def keep(*a, **k):
        res = orig(*a, **k)
        results.append(res)
        return res

    api.ensemble_solve_segmented = keep

    def restore():
        api.ensemble_solve_segmented = orig

    return results, restore


def lane_counters(rep):
    """The per-lane block of a telemetry report as numpy arrays."""
    return {k: np.asarray(v) for k, v in
            rep["solver_stats"]["per_lane"].items()}


def scrape(port, stop, out):
    """Scrape ``/metrics`` every SCRAPE_EVERY_S until ``stop`` is set, and
    ``/healthz`` once two scrapes are in; ``out`` gets the texts."""
    import urllib.request

    base = f"http://127.0.0.1:{port}"
    while not stop.is_set():
        try:
            with urllib.request.urlopen(base + "/metrics",
                                        timeout=SCRAPE_TIMEOUT_S) as r:
                out["metrics"].append(r.read().decode())
            if len(out["metrics"]) >= 2 and out["healthz"] is None:
                with urllib.request.urlopen(base + "/healthz",
                                            timeout=SCRAPE_TIMEOUT_S) as r:
                    out["healthz"] = json.loads(r.read().decode())
        except OSError as e:   # not bound yet, or closed at the end
            out["errors"].append(type(e).__name__)
        time.sleep(SCRAPE_EVERY_S)


def sweep_lines(text):
    """``{series: value}`` of the in-flight sweep families of a scrape:
    ``br_sweep_*`` and the sweep counters (not the endpoint's own)."""
    keep = {}
    for ln in text.splitlines():
        if ln.startswith("#") or not ln.strip():
            continue
        name, value = ln.rsplit(" ", 1)
        if name.startswith("br_sweep_") or any(
                f'name="{k}"' in name for k in ("lane_attempts",
                                                "lane_capacity")):
            keep[name] = value
    return keep


def phase_telemetry(bt, gm, th, T, out3, counts3, wall3, launches3, device,
                    smi, by_phase):
    """Phase 22: observability on the main path.  (a) ``telemetry=True,
    timeline=TIMELINE`` cold, then warm: status, x and tau equal phase 3's
    to the bit, the per-lane counters consistent with the result and with
    each other, the rings as full as the attempts, the warm host syncs and
    launches phase 3's; (b) the blocking gear: every counter and ring
    equal to (a)'s; (c) the compile watch: captures cold, none warm, no
    retrace; (d) ``live_metrics``: a thread scrapes ``/metrics`` while the
    sweep runs (two scrapes that differ, the reference's names) and then
    ``/healthz``, on a warm program of LIVE_SEGMENT-attempt segments;
    (e) the report's JSONL round trip, Prometheus lines and rendering;
    (f) ``utils.profiling.device_trace`` around (d)'s program, warm, over
    TRACE_T1 names the kernel as often as it was counted; (g)
    ``checkpointed_sweep`` with a recorder: 4 ``chunk_solve`` spans fresh,
    4 ``chunk_load`` spans and no solve on the second call."""
    import re
    import socket
    import threading

    import torch

    from batchreactor_tpu_torch import obs
    from batchreactor_tpu_torch.parallel import checkpoint as ck
    from batchreactor_tpu_torch.solver import graphs
    from batchreactor_tpu_torch.solver import linalg_cuda as lc
    from batchreactor_tpu_torch.utils.profiling import device_trace

    tel = dict(telemetry=True, timeline=TIMELINE)
    walls = {}

    def run(name, **kw):
        results, restore = captured_driver()
        try:
            graphs.reset_counts()
            r = gear_run(lambda: sweep(bt, gm, th, T, device, **kw))
        finally:
            restore()
        r["solve"] = results[-1]
        walls[name] = r["wall_s"]
        return r

    # ---- (a) the sweep, cold then warm -----------------------------------
    cold = run("a_cold", **tel)
    warm = run("a_warm", **tel)
    out, res = warm["res"], warm["solve"]
    for k in ("status", "tau"):
        if not np.array_equal(out[k], out3[k], equal_nan=True):
            raise AssertionError(f"telemetry: {k} differs from phase 3")
    if any(not np.array_equal(out["x"][sp], out3["x"][sp])
           for sp in out["x"]):
        raise AssertionError("telemetry: x differs from phase 3")
    rep = out["telemetry"]
    pl = lane_counters(rep)
    n_acc, n_rej = res.n_accepted.numpy(), res.n_rejected.numpy()
    attempts = n_acc + n_rej
    filled = (pl["timeline_code"] != 0).sum(axis=1)
    checks = {
        "n_accepted": np.array_equal(pl["n_accepted"], n_acc),
        "n_rejected": np.array_equal(pl["n_rejected"], n_rej),
        "err_plus_conv": np.array_equal(
            pl["err_rejects"] + pl["conv_rejects"], pl["n_rejected"]),
        "order_hist_sum": np.array_equal(pl["order_hist"].sum(axis=1),
                                         pl["n_accepted"]),
        "reuses_plus_factorizations": np.array_equal(
            pl["setup_reuses"] + pl["factorizations"], pl["jac_builds"]),
        "timeline_filled": np.array_equal(
            filled, np.minimum(TIMELINE, attempts))}
    if not all(checks.values()):
        raise AssertionError(f"telemetry: per-lane checks {checks}")
    if warm["host_syncs"] != counts3["host_syncs"]:
        raise AssertionError(f"telemetry: {warm['host_syncs']} host syncs "
                             f"warm, phase 3 {counts3['host_syncs']}")
    lp = warm["lu32p_launches_by_path"]
    if lp["warp"] != launches3 or lp["cta"]:
        raise AssertionError(f"telemetry: lu32p launches {lp}, phase 3 "
                             f"{launches3} on the warp path")
    if rep["counters"].get("blocking_syncs") != warm["host_syncs"]:
        raise AssertionError(f"telemetry: the report's blocking_syncs "
                             f"{rep['counters'].get('blocking_syncs')}, the "
                             f"run's host syncs {warm['host_syncs']}")

    # ---- (b) the blocking gear -------------------------------------------
    blk = run("b_blocking", pipeline=False, **tel)
    pl_b = lane_counters(blk["res"]["telemetry"])
    differ = [k for k in pl if not np.array_equal(pl[k], pl_b[k])]
    if differ:
        raise AssertionError(f"telemetry: the gears' counters differ in "
                             f"{differ}")
    if not np.array_equal(blk["res"]["tau"], out["tau"], equal_nan=True):
        raise AssertionError("telemetry: the gears' tau differ")

    # ---- (c) the compile watch -------------------------------------------
    cw, ww = (cold["res"]["telemetry"]["compile"],
              out["telemetry"]["compile"])
    if not (cw["compiles"] >= 1 and cw["by_label"].get(
            "sweep-segment", {}).get("compiles", 0) >= 1
            and cw["retraces"] == 0 and ww["compiles"] == 0
            and ww["retraces"] == 0):
        raise AssertionError(f"telemetry: compile watch cold {cw}, warm {ww}")

    # ---- (d) live metrics ------------------------------------------------
    live_kw = dict(segment_steps=LIVE_SEGMENT, poll_every=1)
    run("d_cold", **live_kw)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    scraped = {"metrics": [], "healthz": None, "errors": []}
    stop = threading.Event()
    scraper = threading.Thread(target=scrape, args=(port, stop, scraped),
                               daemon=True, name="chip-smoke-scraper")
    scraper.start()
    try:
        live = run("d_live", live_metrics=port, **live_kw)
    finally:
        stop.set()
        scraper.join()
    series = [sweep_lines(t) for t in scraped["metrics"]]
    inflight = [x for x in series if x]
    distinct = {tuple(sorted(x.items())) for x in inflight}
    if not (len(inflight) >= 2 and len(distinct) >= 2
            and any("br_sweep_occupancy" in x for x in inflight)
            and scraped["healthz"] and scraped["healthz"]["ok"]):
        raise AssertionError(
            f"telemetry: live scrapes {len(scraped['metrics'])}, in flight "
            f"{len(inflight)}, distinct {len(distinct)}, healthz "
            f"{scraped['healthz']}")
    # another segment length restarts the jac windows elsewhere: the
    # lanes agree at the rtol scale, not to the bit
    rel_d = np.abs(live["res"]["tau"] / out["tau"] - 1.0)
    if not (np.array_equal(live["res"]["status"], out["status"])
            and rel_d.max() <= 1e-3):
        raise AssertionError(f"telemetry: the live sweep's status or tau "
                             f"(max rel {rel_d.max()}) off (a)")

    # ---- (e) the report --------------------------------------------------
    if obs.from_jsonl(obs.to_jsonl(rep)) != rep:
        raise AssertionError("telemetry: the JSONL round trip changed the "
                             "report")
    prom = obs.to_prometheus(rep)
    sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? '
                        r'(-?[0-9.eE+-]+|[+-]?Inf|NaN)$')
    bad = [ln for ln in prom.splitlines()
           if ln and not ln.startswith("# ") and not sample.match(ln)]
    text = obs.render(rep)
    if bad or "n_accepted" not in text or "solve" not in text:
        raise AssertionError(f"telemetry: Prometheus lines {bad[:3]}, "
                             f"render {text[:200]!r}")

    # ---- (f) the device trace --------------------------------------------
    trace_dir = tempfile.mkdtemp(prefix="br_trace_")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lc.LAUNCHES = 0
    lc.LAUNCHES_BY_PATH.update(warp=0, cta=0)
    with device_trace(trace_dir) as trace_path:
        sweep(bt, gm, th, T, device, t1=TRACE_T1, **live_kw)
    traced = lc.LAUNCHES
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    walls["f_trace"] = time.perf_counter() - t0
    kernels = [e for e in events if e.get("cat") == "kernel"]
    named = sum("lu32p_" in e.get("name", "") for e in kernels)
    if traced <= 0 or named != traced:
        raise AssertionError(f"telemetry: the trace names lu32p {named} "
                             f"times, the wrapper counted {traced}")

    # ---- (g) the checkpointed sweep with a recorder ----------------------
    rhs, y0s, cfg, kw = ckpt_setup(gm, th, T, device)
    ckdir = tempfile.mkdtemp(prefix="br_ckpt_obs_")
    recs = []
    for _ in range(2):
        rec = obs.Recorder()
        t0 = time.perf_counter()
        ck.checkpointed_sweep(rhs, y0s, 0.0, T1, cfg, ckdir,
                              chunk_size=CKPT_CHUNK, recorder=rec, **kw)
        torch.cuda.synchronize()
        walls[f"g_{len(recs)}"] = time.perf_counter() - t0
        recs.append({k: v["count"] for k, v in rec.by_name().items()})
    n_chunks = B_MAIN // CKPT_CHUNK
    if not (recs[0].get("chunk_solve") == n_chunks
            and recs[0].get("chunk_save") == n_chunks
            and recs[1].get("chunk_load") == n_chunks
            and "chunk_solve" not in recs[1]):
        raise AssertionError(f"telemetry: checkpointed spans {recs}")

    by_phase["telemetry"] = lp
    st = rep["solver_stats"]["totals"]
    emit({"phase": "telemetry", "gpu": smi, "B": B_MAIN,
          "timeline": TIMELINE, "walls_s": walls,
          "warm_wall_s": warm["wall_s"], "phase3_warm_wall_s": wall3,
          "counters_cost_share": warm["wall_s"] / wall3 - 1.0,
          "host_syncs_warm": warm["host_syncs"],
          "phase3_host_syncs": counts3["host_syncs"],
          "per_lane_checks": checks, "solver_totals": st,
          "recorder_counters": rep["counters"],
          "newton_iters_executed": {"pipelined": warm["newton_iters"],
                                    "blocking": blk["newton_iters"]},
          "newton_iters_counted": st["newton_iters"],
          "compile_cold": {k: cw[k] for k in ("compiles", "traces",
                                              "retraces", "compile_s")},
          "compile_warm": {k: ww[k] for k in ("compiles", "traces",
                                              "retraces")},
          "live": {"segment_steps": LIVE_SEGMENT,
                   "tau_max_rel_vs_a": float(rel_d.max()),
                   "scrapes": len(scraped["metrics"]),
                   "in_flight": len(inflight), "distinct": len(distinct),
                   "healthz_ok": scraped["healthz"]["ok"]},
          "prometheus_lines": len(prom.splitlines()),
          "trace": {"kernels": len(kernels), "lu32p": named,
                    "lu32p_counted": traced},
          "checkpointed_spans": recs,
          "lu32p_launches_by_path": lp,
          "lu32p_launches_by_path_blocking": blk[
              "lu32p_launches_by_path"]})


def telemetry_main(bt, gm, th, device, smi):
    """``--telemetry-only``: phase 3's sweep (cold, then warm, its counts
    set to 0 before the warm run) and phase 22 against it.  Prints no
    contract line."""
    import torch

    from batchreactor_tpu_torch.solver import graphs

    T = np.linspace(T_LO, T_HI, B_MAIN)
    sweep(bt, gm, th, T, device)
    graphs.reset_counts()
    r = gear_run(lambda: sweep(bt, gm, th, T, device))
    out = r["res"]
    emit({"phase": "main_path", "gpu": smi, "wall_s": r["wall_s"],
          "host_syncs": r["host_syncs"],
          "lu32p_launches_by_path": r["lu32p_launches_by_path"]})
    t0 = time.perf_counter()
    phase_telemetry(bt, gm, th, T, {k: out[k] for k in ("status", "tau",
                                                          "x")},
                    {"host_syncs": r["host_syncs"]}, r["wall_s"],
                    r["lu32p_launches_by_path"]["warp"], device, smi, {})
    torch.cuda.synchronize()
    emit({"phase": "walls", "telemetry_s": time.perf_counter() - t0})
    print(smi, flush=True)
    return 0


# ---------------------------------------------------------------------------
# phases 23-24: serving and the fleet
# ---------------------------------------------------------------------------
# phase 23: phase 3's 1024 temperatures as 8 concurrent requests of 128
# lanes to a resident program of 1024 slots on the ladder (256, 512,
# 1024); the coalesce window lets all 8 join one seed (it closes as soon
# as 1024 lanes are queued), so the epoch runs phase 3's width
SERVE_REQUESTS, SERVE_LANES = 8, 128
SERVE_BUCKETS = (256, 512, 1024)
SERVE_COALESCE_S = 1.0
# (d): the refusal scheduler's queue bound, the stall of the drained
# request; (f): the daemon's stalls, during which SIGTERM lands
REFUSE_QUEUE, STALL_S, DAEMON_STALL_S = 128, 1.0, 2.0
# phase 24: two member daemons of 256 slots; 8 requests of 64 lanes over 4
# horizons (t1 is an operand, not a program key); the member names put
# two of the four route keys on each member of the consistent-hash ring
FLEET_RESIDENT, FLEET_LANES = 256, 64
FLEET_T1 = (2e-4, 4e-4, 6e-4, 8e-4)
FLEET_MEMBERS = ("s1", "s2")
SERVE_TIMEOUT_S = 600.0


class ServeCase:
    """What phases 23-24 serve: the mechanism files, the composition, the
    marker, the conditions and the widths (the module constants on the
    card; a CPU rehearsal passes small ones)."""

    def __init__(self, mech, therm, comp, marker, T, t1, lanes=SERVE_LANES,
                 requests=SERVE_REQUESTS, buckets=SERVE_BUCKETS,
                 fleet_resident=FLEET_RESIDENT, fleet_lanes=FLEET_LANES,
                 fleet_t1=FLEET_T1, energy=None, linsolve="lu32p",
                 jac_window=8, segment_steps=256, want_path="warp"):
        self.mech, self.therm, self.comp, self.marker = mech, therm, comp, \
            marker
        self.T, self.t1, self.lanes, self.requests = T, t1, lanes, requests
        self.buckets, self.fleet_resident = buckets, fleet_resident
        self.fleet_lanes, self.fleet_t1 = fleet_lanes, fleet_t1
        self.energy = energy            # (x (k, S), T (k,), t1, tau_ref)
        self.linsolve, self.jac_window = linsolve, jac_window
        self.segment_steps, self.want_path = segment_steps, want_path


def serve_spec(case, resident, buckets, energy=True, **serve):
    """The session spec of phases 23-24: the main path's BDF settings,
    ``linsolve`` explicit (``auto`` resolves with an epoch's first rung,
    and a small first rung takes ``lu``), the CH4 marker, counters on."""
    solver = {"method": "bdf", "rtol": RTOL, "atol": ATOL,
              "jac_window": case.jac_window, "setup_economy": True,
              "segment_steps": case.segment_steps,
              "linsolve": case.linsolve, "ignition_marker": case.marker,
              "stats": True}
    if energy:
        solver["energy_modes"] = ["adiabatic_v"]
    return {"mechanism": {"mech": case.mech, "therm": case.therm},
            "solver": solver,
            "serve": {"resident": int(resident), "buckets": list(buckets),
                      "refill": 1, "poll_every": 1, "idle_timeout_s": 0.25,
                      "request_timeout_s": SERVE_TIMEOUT_S, **serve}}


def fire(client, reqs):
    """Post the requests at once, one thread each; returns per request
    ``(code, response, latency_s)`` in order and the wall from the first
    post to the last answer."""
    import threading

    from batchreactor_tpu_torch.serving.client import ServeError

    out = [None] * len(reqs)

    def one(i):
        t0 = time.perf_counter()
        try:
            resp, code = client.solve(reqs[i]), "ok"
        except ServeError as e:
            resp, code = e.response, e.code
        except OSError as e:
            resp, code = {"error": str(e)}, "transport"
        out[i] = (code, resp, time.perf_counter() - t0)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(reqs))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return out, time.perf_counter() - t0


def latency(results, wall):
    """``serving.client.summarize`` of ``fire``'s results: counts, cond/s
    over ``wall`` and the p50/p95/p99 latency of the answered requests."""
    from batchreactor_tpu_torch.serving.client import summarize

    return summarize([{"ok": c == "ok", "latency_s": s, "response": r}
                      for c, r, s in results], wall)


def served_lanes(results, species):
    """tau and x (B, S) of the answers, in request order."""
    tau = np.concatenate([np.asarray(r["tau"], dtype=float)
                          for _, r, _ in results])
    x = np.concatenate([np.stack([r["x"][s] for s in species], axis=1)
                        for _, r, _ in results])
    status = sum((r["solver_status"] for _, r, _ in results), [])
    return tau, x, status


def check_served(name, results, n_lanes):
    bad = [(i, c) for i, (c, r, _) in enumerate(results)
           if c != "ok" or r.get("provenance") != ["success"]
           * len(r.get("t", []))]
    lanes = sum(len(r["t"]) for c, r, _ in results if c == "ok")
    if bad or lanes != n_lanes:
        raise AssertionError(f"{name}: answers not all ok with every lane "
                             f"success: {bad[:4]}, {lanes} lanes")


def wait_for(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def phase_serving(bt, gm, th, case, out3, wall3, device, smi, by_phase):
    """Phase 23: the serving main path in this process.  (a) the session's
    warmup; (b) phase 3's lanes as concurrent HTTP requests: every lane
    success, tau and x against phase 3, no capture, warp launches; (c) one
    energy request beside a live ``/metrics`` scrape; (d) the refusals and
    the drain; (e) two resident epochs on one card; (f) the daemon drained
    by SIGTERM.  Returns the session (phase 24 holds the fleet's answers
    to it)."""
    import threading

    import torch

    from batchreactor_tpu_torch.resilience import inject
    from batchreactor_tpu_torch.serving.client import SolveClient
    from batchreactor_tpu_torch.serving.scheduler import Scheduler
    from batchreactor_tpu_torch.serving.server import ServingServer
    from batchreactor_tpu_torch.serving.session import (SolverSession,
                                                        load_spec)
    from batchreactor_tpu_torch.solver import graphs
    from batchreactor_tpu_torch.solver import linalg_cuda as lc

    t_phase = time.perf_counter()
    B = case.lanes * case.requests
    cap = max(case.buckets)
    spec = load_spec(serve_spec(case, cap, case.buckets,
                                energy=case.energy is not None,
                                coalesce_s=SERVE_COALESCE_S,
                                max_queue_lanes=4 * cap))
    session = SolverSession(gm, th, spec, device=device)

    # ---- (a) warmup -------------------------------------------------------
    graphs.reset_counts()
    session.warmup()
    warm = dict(session.warmup_summary)
    emit({"phase": "serving_warmup", "gpu": smi, **warm,
          "graphs_captured": graphs.captures(),
          "programs_warmed": len(session.warmed),
          "rungs": sorted({w["rung"] for w in session.warmed})})

    # ---- (b) phase 3's lanes as concurrent requests -------------------------
    session.__enter__()
    reqs = [{"id": f"b{i}", "t1": case.t1, "X": case.comp, "trace": True,
             "T": [float(v) for v in case.T[i * case.lanes:
                                            (i + 1) * case.lanes]]}
            for i in range(case.requests)]
    graphs.reset_counts()
    lc.LAUNCHES = 0
    lc.LAUNCHES_BY_PATH.update(warp=0, cta=0)
    with ServingServer(session, Scheduler(session)) as srv:
        client = SolveClient(srv.url, timeout=SERVE_TIMEOUT_S)
        results, wall_b = fire(client, reqs)
        health = client.healthz()["serving"]
    by_b = dict(lc.LAUNCHES_BY_PATH)
    by_phase["serving"] = by_b
    captured = graphs.captures()
    check_served("serving", results, B)
    if captured or any(session.program_compiles().values()):
        raise AssertionError(f"serving: {captured} graphs captured, "
                             f"{session.program_compiles()} after warmup")
    check_launches("serving", by_b, case.want_path)
    tau_b, x_b, _ = served_lanes(results, th.species)
    tau3 = np.asarray(out3["tau"])[:B]
    x3 = np.stack([np.asarray(out3["x"][s])[:B] for s in th.species],
                  axis=1)
    tau_rel = np.abs(tau_b / tau3 - 1.0)
    dx = np.abs(x_b - x3)
    if not (tau_rel.max() <= 1e-3 and np.all(dx <= 1e-5 + 1e-3
                                              * np.abs(x3))):
        raise AssertionError(f"serving vs phase 3: tau max rel "
                             f"{tau_rel.max()}, x max abs {dx.max()}")
    bit_equal = int(((tau_b == tau3) & (x_b == x3).all(axis=1)).sum())
    lat = latency(results, wall_b)
    stages = {}
    for _, r, _ in results:
        for k, v in r["trace"]["segments"].items():
            stages.setdefault(k, []).append(v)
    emit({"phase": "serving", "gpu": smi, "lanes": B,
          "requests": case.requests, "lanes_per_request": case.lanes,
          "resident": cap, "buckets": list(case.buckets),
          "linsolve": case.linsolve, "wall_s": wall_b,
          "cond_per_s": B / wall_b, "phase3_wall_s": wall3,
          "phase3_cond_per_s": B / wall3 if wall3 else None,
          **{k: lat[k] for k in ("p50_ms", "p95_ms", "p99_ms")},
          "tau_max_rel_vs_phase3": float(tau_rel.max()),
          "x_max_abs_diff_vs_phase3": float(dx.max()),
          "lanes_bit_equal_phase3": bit_equal,
          "graphs_captured": captured,
          "program_compiles": session.program_compiles(),
          "lu32p_launches_by_path": by_b,
          "server_stage_max_s": {k: max(v) for k, v in stages.items()},
          "healthz_program_compiles": health["program_compiles"]})

    # ---- (c) an energy request beside a live scrape -------------------------
    if case.energy is not None:
        x_e, T_e, t1_e, tau_ref = case.energy
        comp_e = {s: [float(v) for v in x_e[:, k]]
                  for k, s in enumerate(th.species) if x_e[:, k].any()}
        req_e = {"id": "energy", "T": [float(v) for v in T_e], "X": comp_e,
                 "t1": t1_e, "energy": "adiabatic_v"}
        seen = {"inflight": 0, "scrapes": 0}
        lc.LAUNCHES_BY_PATH.update(warp=0, cta=0)
        with ServingServer(session, Scheduler(session)) as srv:
            client = SolveClient(srv.url, timeout=SERVE_TIMEOUT_S)
            stop = threading.Event()

            def scraper():
                while not stop.is_set():
                    try:
                        text = client.metrics()
                    except OSError:
                        continue
                    seen["scrapes"] += 1
                    for ln in text.splitlines():
                        if ln.startswith("br_sweep_serve_inflight_lanes ") \
                                and float(ln.split()[-1]) > 0:
                            seen["inflight"] += 1
                    stop.wait(0.02)

            scr = threading.Thread(target=scraper, daemon=True)
            scr.start()
            (res_e,), wall_e = fire(client, [req_e])
            stop.set()
            scr.join()
        by_phase["serving_energy"] = dict(lc.LAUNCHES_BY_PATH)
        check_served("serving energy", [res_e], T_e.shape[0])
        delay = np.asarray([np.nan if v is None else v
                            for v in res_e[1]["ignition_delay"]])
        rel_e = np.abs(delay / tau_ref - 1.0)
        if not rel_e.max() <= 1e-3 or not seen["inflight"]:
            raise AssertionError(f"serving energy: delay max rel "
                                 f"{rel_e.max()} against the energy path; "
                                 f"in-flight scrapes {seen}")
        emit({"phase": "serving_energy", "gpu": smi,
              "lanes": T_e.shape[0], "t1": t1_e, "wall_s": wall_e,
              "delay_max_rel_vs_energy_path": float(rel_e.max()),
              "scrapes": seen["scrapes"],
              "scrapes_with_inflight": seen["inflight"],
              "lu32p_launches_by_path": by_phase["serving_energy"]})

    # ---- (d) the refusals and the drain ---------------------------------------
    small = [float(v) for v in case.T[:case.lanes // 2]]
    t1_d = case.t1 / 8
    sched = Scheduler(session, max_queue_lanes=REFUSE_QUEUE)
    srv = ServingServer(session, sched).start()
    client = SolveClient(srv.url, timeout=SERVE_TIMEOUT_S)
    over, _ = fire(client, [{"id": "big", "T": [float(case.T[0])]
                             * (REFUSE_QUEUE + 1), "X": case.comp,
                             "t1": t1_d}])
    stalls0 = session.recorder.snapshot()[2].get("serve_stalls", 0)
    inject.arm(f"slow_request:delay={STALL_S},request=d0")
    accepted = {}
    th_acc = threading.Thread(target=lambda: accepted.update(r=fire(
        client, [{"id": f"d{i}", "T": small, "X": case.comp, "t1": t1_d,
                  "trace": True} for i in range(2)])))
    th_acc.start()
    wait_for(lambda: sum(sched.depth()) >= 2 * len(small), 60,
             "both requests accepted")
    closer = threading.Thread(target=srv.close)
    closer.start()
    wait_for(lambda: sched._draining, 10, "the drain flag")
    late, _ = fire(client, [{"id": "late", "T": small, "X": case.comp,
                             "t1": t1_d}])
    th_acc.join()
    closer.join()
    inject.disarm()
    acc_results, _ = accepted["r"]
    stalls = session.recorder.snapshot()[2].get("serve_stalls", 0) - stalls0
    stalled = acc_results[0][1]["trace"]["segments"].get("resolved", 0.0)
    if not (over[0][0] == "overloaded" and late[0][0] == "draining"
            and [c for c, _, _ in acc_results] == ["ok", "ok"]
            and stalls == 1 and stalled >= STALL_S):
        raise AssertionError(f"serving refusals: over {over[0][0]}, late "
                             f"{late[0][0]}, accepted "
                             f"{[c for c, _, _ in acc_results]}, stalls "
                             f"{stalls}, stalled {stalled}")
    emit({"phase": "serving_refusals", "gpu": smi,
          "over_queue": over[0][0], "late_while_draining": late[0][0],
          "accepted_answered": len(acc_results), "stalls": stalls,
          "stalled_segment_s": stalled})
    session.__exit__(None, None, None)

    # ---- (e) two resident epochs on one card ----------------------------------
    spec2 = load_spec(serve_spec(case, cap, case.buckets, energy=False,
                                 resident_epochs=2, coalesce_s=0.5,
                                 max_queue_lanes=4 * cap))
    s2 = SolverSession(gm, th, spec2, device=device)
    s2.warmup()
    half = case.requests // 2
    graphs.reset_counts()
    with s2, ServingServer(s2, Scheduler(s2)) as srv:
        client = SolveClient(srv.url, timeout=SERVE_TIMEOUT_S)
        waves = {}
        th1 = threading.Thread(target=lambda: waves.update(
            a=fire(client, reqs[:half])))
        th1.start()
        time.sleep(0.7)
        waves["b"] = fire(client, reqs[half:])
        th1.join()
        counters = s2.recorder.snapshot()[2]
        gauges = s2.registry.gauges() if hasattr(s2.registry, "gauges") \
            else {}
    res2 = waves["a"][0] + waves["b"][0]
    check_served("two epochs", res2, B)
    tau2, _, status2 = served_lanes(res2, th.species)
    rel2 = np.abs(tau2 / tau_b - 1.0)
    if (not rel2.max() <= 1e-3 or counters.get("serve_epochs", 0) < 2
            or graphs.captures()):
        raise AssertionError(f"two epochs: tau max rel {rel2.max()} "
                             f"against (b), epochs "
                             f"{counters.get('serve_epochs')}, captured "
                             f"{graphs.captures()}")
    emit({"phase": "serving_two_epochs", "gpu": smi,
          "resident_epochs": s2.resident_epochs,
          "warmup": s2.warmup_summary,
          "epochs_run": counters.get("serve_epochs"),
          "epoch_spray_lanes": counters.get("epoch_spray", 0),
          "tau_max_rel_vs_b": float(rel2.max()),
          "lanes_bit_equal_b": int((tau2 == tau_b).sum()),
          "wall_s": max(waves["a"][1], waves["b"][1] + 0.7),
          "graphs_captured": graphs.captures(),
          "gauges": {k: v for k, v in gauges.items()
                     if k.startswith("lanes_running")}})
    s2.release()
    del s2

    # ---- (f) the daemon, drained by SIGTERM ----------------------------------
    phase_daemon(case, device, smi)
    emit({"phase": "serving_walls", "seconds": time.perf_counter()
          - t_phase})
    return session


def daemon_cmd(spec_path, flight_dir, device, *extra):
    return [sys.executable, "-m", "batchreactor_tpu_torch.tools.serve",
            "--spec", spec_path, "--flight-dir", flight_dir, "--device",
            str(device), *extra]


def daemon_env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def start_daemon(cmd, log_path, **env):
    """The daemon as a child process, its standard error in ``log_path``
    (a pipe nobody reads could fill and stall it)."""
    with open(log_path, "w") as log:
        return subprocess.Popen(cmd, cwd=HERE, env=daemon_env(**env),
                                stdout=subprocess.PIPE, stderr=log,
                                text=True)


def tail(path, n=3000):
    try:
        with open(path) as f:
            return f.read()[-n:]
    except OSError:
        return ""


def read_startup(proc, log_path, timeout):
    """The daemon's startup line (its ``serving`` block)."""
    import threading

    got = {}
    t = threading.Thread(target=lambda: got.update(
        line=proc.stdout.readline()), daemon=True)
    t.start()
    t.join(timeout)
    if not got.get("line"):
        proc.kill()
        raise AssertionError(f"the daemon printed no startup line:\n"
                             f"{tail(log_path)}")
    return json.loads(got["line"])["serving"]


def phase_daemon(case, device, smi):
    """Phase 23 (f): ``python -m batchreactor_tpu_torch.tools.serve`` as a
    child process, SIGTERM while two requests are stalled: exit 0, every
    accepted request answered, a ``draining`` answer, a flight dump."""
    import signal
    import threading

    from batchreactor_tpu_torch.serving.client import SolveClient

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        spec_path = os.path.join(tmp, "serve.json")
        with open(spec_path, "w") as f:
            json.dump(serve_spec(case, case.fleet_resident,
                                 (case.fleet_resident,), energy=False,
                                 coalesce_s=0.0), f)
        log = os.path.join(tmp, "daemon.log")
        proc = start_daemon(
            daemon_cmd(spec_path, tmp, device, "--no-warmup"), log,
            BR_FAULT_INJECT=f"slow_request:delay={DAEMON_STALL_S},count=2")
        try:
            info = read_startup(proc, log, 180)
            client = SolveClient(info["url"], timeout=SERVE_TIMEOUT_S)
            reqs = [{"id": f"f{i}", "X": case.comp, "t1": case.t1 / 4,
                     "T": [float(v) for v in case.T[i::3][:case.fleet_lanes]]}
                    for i in range(3)]
            box = {}
            th = threading.Thread(target=lambda: box.update(
                r=fire(client, reqs)))
            th.start()

            def stalled():
                h = client.healthz()["serving"]
                return h["inflight_lanes"] >= 2 * case.fleet_lanes or (
                    "r" in box)
            wait_for(stalled, 120, "the daemon's stalled requests")
            proc.send_signal(signal.SIGTERM)
            probes = []
            pth = []
            for i in range(20):
                p = threading.Thread(target=lambda i=i: probes.append(fire(
                    client, [{"id": f"late{i}", "X": case.comp,
                              "t1": case.t1 / 4,
                              "T": [float(case.T[0])]}])[0][0][0]))
                p.start()
                pth.append(p)
                time.sleep(0.1)
            th.join()
            for p in pth:
                p.join()
            rc = proc.wait(timeout=120)
            err = tail(log)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        results, _ = box["r"]
        flights = [f for f in os.listdir(tmp) if f.startswith("flight_")]
    codes = [c for c, _, _ in results]
    if rc != 0 or codes != ["ok"] * 3 or "draining" not in probes \
            or not flights:
        raise AssertionError(f"daemon drain: rc {rc}, answers {codes}, "
                             f"probes {probes}, flights {flights}:\n"
                             f"{err[-3000:]}")
    emit({"phase": "serving_daemon", "gpu": smi, "exit_code": rc,
          "answered": codes, "probes": sorted(set(probes)),
          "probes_draining": probes.count("draining"),
          "flight_dumps": len(flights),
          "seconds": time.perf_counter() - t0})


def phase_fleet(case, session, device, smi):
    """Phase 24: two member daemons (child processes on the one card)
    behind an in-process ``FleetRouter``; one member SIGKILLed mid-trace;
    every request answered once and held against phase 23's session; the
    router's ``/metrics`` and the stitched traces."""
    import signal
    import threading

    from batchreactor_tpu_torch.fleet import FleetRouter, read_members
    from batchreactor_tpu_torch.fleet.ring import HashRing, request_key
    from batchreactor_tpu_torch.obs import build_report, read_jsonl
    from batchreactor_tpu_torch.obs.stitch import stitch
    from batchreactor_tpu_torch.serving import schema
    from batchreactor_tpu_torch.serving.client import (SolveClient,
                                                       with_trace_ctx)

    t_phase = time.perf_counter()
    ring = HashRing(FLEET_MEMBERS)
    owners = {t1: ring.route(request_key({"t1": t1}))
              for t1 in case.fleet_t1}
    victim = owners[case.fleet_t1[0]]
    (survivor,) = [m for m in FLEET_MEMBERS if m != victim]
    n_req = 2 * len(case.fleet_t1)
    Tf = case.T[::max(1, case.T.shape[0] // (n_req * case.fleet_lanes))]
    reqs = [with_trace_ctx({
        "id": f"q{i}", "X": case.comp,
        "t1": case.fleet_t1[i % len(case.fleet_t1)], "trace": True,
        "T": [float(v) for v in Tf[i * case.fleet_lanes:
                                   (i + 1) * case.fleet_lanes]]})
        for i in range(n_req)]
    with tempfile.TemporaryDirectory() as tmp:
        fleet_dir = os.path.join(tmp, "fleet")
        obs_dir = os.path.join(tmp, "obs")
        os.makedirs(obs_dir)
        spec_path = os.path.join(tmp, "serve.json")
        with open(spec_path, "w") as f:
            json.dump(serve_spec(case, case.fleet_resident,
                                 (case.fleet_resident,), energy=False,
                                 coalesce_s=0.0), f)
        logs = {name: os.path.join(tmp, f"{name}.log")
                for name in FLEET_MEMBERS}
        procs = {name: start_daemon(
            daemon_cmd(spec_path, tmp, device, "--fleet-dir", fleet_dir,
                       "--member-name", name, "--obs-out",
                       os.path.join(obs_dir, f"{name}.jsonl")), logs[name])
            for name in FLEET_MEMBERS}
        router = None
        try:
            infos = {n: read_startup(p, logs[n], 240)
                     for n, p in procs.items()}
            wait_for(lambda: sum(m.routable for m in read_members(
                fleet_dir)) == 2, 60, "two routable members")
            router = FleetRouter(fleet_dir, dead_after_s=60.0,
                                 refresh_s=0.0,
                                 request_timeout=SERVE_TIMEOUT_S).start()
            client = SolveClient(router.url, timeout=SERVE_TIMEOUT_S)
            vclient = SolveClient(infos[victim]["url"], timeout=10.0)
            # wave 1: one request per horizon, so both members answer;
            # wave 2: the same horizons again, the victim killed once it
            # holds accepted work
            wave1, wall1 = fire(client, reqs[:len(case.fleet_t1)])
            box = {}
            th = threading.Thread(target=lambda: box.update(
                r=fire(client, reqs[len(case.fleet_t1):])))
            th.start()
            wait_for(lambda: vclient.healthz()["serving"]["inflight_lanes"]
                     > 0, 120, "the victim's accepted work")
            procs[victim].send_signal(signal.SIGKILL)
            th.join()
            wave2, wall2 = box["r"]
            results, wall = wave1 + wave2, wall1 + wall2
            time.sleep(0.6)          # a heartbeat: the survivor's snapshot
            metrics = router.metrics_text()
            router_report = build_report(recorder=router.recorder)
            procs[survivor].send_signal(signal.SIGTERM)
            rcs = {n: p.wait(timeout=120) for n, p in procs.items()}
            survivor_report = read_jsonl(os.path.join(obs_dir,
                                                      f"{survivor}.jsonl"))
            survivor_log = tail(logs[survivor])
        finally:
            if router is not None:
                router.close()
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
    codes = [c for c, _, _ in results]
    hosts = {r["router"]["host"] for c, r, _ in wave1 if c == "ok"}
    failovers = [r["id"] for c, r, _ in results
                 if c == "ok" and r["router"]["failover"]]
    check_served("fleet", results, n_req * case.fleet_lanes)
    # every answer against the same lanes solved by phase 23's session
    worst = 0.0
    for _c, r, _s in results:
        req = schema.validate_request(
            {k: v for k, v in reqs[int(r["id"][1:])].items()
             if k != "trace_ctx"})
        y0, cfg = session.request_lanes(req)
        ref = session._run(y0, cfg, t1=req.t1, rtol=RTOL, atol=ATOL,
                           energy=None, live_source="sweep",
                           admission=case.fleet_resident)
        tau_ref = ref.observed["tau"].cpu().numpy()
        if not (ref.status.cpu().numpy() == 1).all():
            raise AssertionError("fleet: a reference lane failed")
        tau_got = np.asarray(r["tau"], dtype=float)
        # a lane whose marker never crossed before t1 has no delay: it
        # must have none in both
        both_nan = np.isnan(tau_got) & np.isnan(tau_ref)
        rel = np.abs(tau_got[~both_nan] / tau_ref[~both_nan] - 1.0)
        if rel.size:
            worst = max(worst, float(rel.max()) if not np.isnan(
                rel).any() else float("inf"))
    traces = stitch([(survivor, survivor_report),
                     ("router", router_report)])
    by_req = {t["request"]: t for t in traces if t.get("router")}
    fo_traces = [by_req[i] for i in failovers if i in by_req]
    two_hops = all(len(t["hops"]) == 2 and t["hops"][0]["outcome"]
                   == "transport" and "member_trace" in t["hops"][1]
                   for t in fo_traces)
    pids = {infos[n]["pid"] for n in FLEET_MEMBERS}
    hosts_in_metrics = all(f'host="p{pid}"' in metrics for pid in pids)
    if not (codes == ["ok"] * n_req and hosts == set(FLEET_MEMBERS)
            and failovers and worst <= 1e-3
            and set(by_req) == {r["id"] for r in reqs}
            and fo_traces and two_hops and hosts_in_metrics
            and rcs[survivor] == 0 and rcs[victim] in (-9, 137)):
        raise AssertionError(f"fleet: answers {codes}, hosts {hosts}, "
                             f"failovers {failovers}, tau max rel {worst}, "
                             f"traces {sorted(by_req)}, two hops "
                             f"{two_hops}, both hosts in /metrics "
                             f"{hosts_in_metrics}, exit codes {rcs}:\n"
                             f"{survivor_log}")
    emit({"phase": "fleet", "gpu": smi, "members": list(FLEET_MEMBERS),
          "route_owners": {str(k): v for k, v in owners.items()},
          "killed": victim, "requests": n_req,
          "lanes_per_request": case.fleet_lanes, "wall_s": wall,
          "wave1_answered_by": sorted(hosts),
          "wave2_answered_by": sorted({r["router"]["host"]
                                       for _, r, _ in wave2}),
          "failovers": failovers,
          "tau_max_rel_vs_direct": worst,
          "stitched_traces": len(by_req),
          "failover_traces_two_hops": two_hops,
          "exit_codes": rcs,
          **{k: latency(results, wall)[k]
             for k in ("p50_ms", "p95_ms", "p99_ms")},
          "seconds": time.perf_counter() - t_phase})


def main_serve_case(gm, T, x_e=None, T_e=None, tau_e=None):
    """Phases 23-24 on the main path: GRI-3.0, phase 3's temperatures and
    horizon, and phase 11's first B_CROSS lanes for the energy request."""
    energy = None
    if x_e is not None:
        energy = (x_e[:B_CROSS], T_e[:B_CROSS], T1_E, tau_e[:B_CROSS])
    return ServeCase(os.path.join(FIXTURES, "grimech.dat"),
                     os.path.join(FIXTURES, "therm.dat"), COMP, "CH4", T,
                     T1, energy=energy)


def serving_main(bt, gm, th, device, smi):
    """``--serving-only``: phase 3's sweep (cold, then warm), the energy
    reference of phase 11's first B_CROSS lanes, then phases 23-24.
    Prints no contract line."""
    import torch

    T = np.linspace(T_LO, T_HI, B_MAIN)
    sweep(bt, gm, th, T, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sweep(bt, gm, th, T, device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    emit({"phase": "main_path", "gpu": smi, "wall_s": wall})
    _, T_e, x_e = energy_conditions(gm, device)
    ref_e = energy_sweep(bt, gm, th, x_e[:B_CROSS], T_e[:B_CROSS], device,
                         linsolve="lu32p")
    case = main_serve_case(gm, T, x_e, T_e, ref_e["ignition_delay"])
    by_phase = {}
    t0 = time.perf_counter()
    session = phase_serving(bt, gm, th, case, out, wall, device, smi,
                            by_phase)
    t1 = time.perf_counter()
    phase_fleet(case, session, device, smi)
    emit({"phase": "walls", "serving_s": t1 - t0,
          "fleet_s": time.perf_counter() - t1,
          "launches_by_phase": by_phase})
    print(smi, flush=True)
    return 0


def native_tau(res, y0, marker):
    """The main path's ignition delay (``ignition_observer``, CH4 below
    half its initial value, interpolated) over a native trajectory: the
    initial row, then every accepted step of ``res`` (``n_save`` rows)."""
    import torch

    from batchreactor_tpu_torch.parallel import ignition_observer

    obs, init = ignition_observer(marker, mode="half")
    acc = {k: torch.full((1,), v, dtype=torch.float64)
           for k, v in init.items()}
    ts = np.concatenate([[0.0], res.ts])
    ys = np.concatenate([np.asarray(y0)[None, :], res.ys])
    for t, y in zip(ts, ys):
        acc = obs(torch.tensor([t]), torch.from_numpy(y[None, :]), acc)
    return float(acc["tau"][0])


def poison(res, lanes):
    """``res`` with ``lanes`` failed as a NaN blowup (y NaN, status
    DT_UNDERFLOW), as ``resilience.inject.poison_lanes`` does."""
    import dataclasses

    import torch

    from batchreactor_tpu_torch.solver.common import DT_UNDERFLOW

    idx = torch.as_tensor(lanes, dtype=torch.long, device=res.y.device)
    y, status = res.y.clone(), res.status.clone()
    y[idx] = float("nan")
    status[idx] = DT_UNDERFLOW
    return dataclasses.replace(res, y=y, status=status)


def start_fault_smoke(before=None):
    """Start ``tools/fault_smoke.py`` on the card in a child process, its
    output in a temporary directory; ``before`` names the phase it runs
    beside (None: phase 25 waits for it at once)."""
    tmp = tempfile.mkdtemp(prefix="br_fault_smoke_")
    with open(os.path.join(tmp, "child.log"), "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "batchreactor_tpu_torch.tools.fault_smoke",
             "--out", os.path.join(tmp, "fault_events.jsonl"),
             "--scrape-out", os.path.join(tmp, "fault_scrape.prom"),
             "--flight-dir", tmp], cwd=tmp, stdout=log,
            stderr=subprocess.STDOUT, env={**os.environ, "PYTHONPATH": HERE})
    return {"proc": proc, "dir": tmp, "t0": time.perf_counter(),
            "t0_wall": time.time(), "before": before}


def stop_fault_smoke(kid, grace_s=20.0):
    """SIGTERM the fault smoke child if it still runs, SIGKILL past the
    grace; True when it had to be stopped."""
    proc = kid["proc"]
    if proc.poll() is not None:
        return False
    proc.terminate()
    try:
        proc.wait(grace_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    return True


def drop_kid(kid):
    """Stop a child started by :func:`start_fault_smoke` or
    :func:`start_analysis` and remove its temporary directory."""
    import shutil

    stop_fault_smoke(kid)
    shutil.rmtree(kid["dir"], ignore_errors=True)


def join_kid(kid, timeout):
    """Wait for a child process ``timeout`` s from its start, stopping it
    past that; True when it had to be stopped."""
    left = timeout - (time.perf_counter() - kid["t0"])
    try:
        kid["proc"].wait(max(left, 1.0))
        return False
    except subprocess.TimeoutExpired:
        return stop_fault_smoke(kid)


def finish_fault_smoke(kid, timeout=300.0):
    """Wait for the fault smoke child (``timeout`` s from its start): its
    exit code, the fault kinds of its ``fault_events.jsonl``, its wall
    (from its start to its events file, which it writes last) and the
    tail of its log."""
    timed_out = join_kid(kid, timeout)
    wall = time.perf_counter() - kid["t0"]
    kinds = set()
    out = os.path.join(kid["dir"], "fault_events.jsonl")
    try:
        if os.path.exists(out):
            wall = os.path.getmtime(out) - kid["t0_wall"]
            with open(out) as f:
                kinds = {json.loads(ln).get("attrs", {}).get("kind")
                         for ln in f if '"fault"' in ln}
        with open(os.path.join(kid["dir"], "child.log")) as f:
            tail = f.read()[-3000:]
    finally:
        drop_kid(kid)
    return {"rc": kid["proc"].returncode, "timed_out": timed_out,
            "wall_s": wall, "kinds": sorted(k for k in kinds if k),
            "tail": tail}


def phase_native(bt, gm, th, T, out3, file_row, dir_a, device, smi,
                 by_phase, fault_kid=None):
    """Phase 25: the native runtime (``native/br_native.cpp``, g++) beside
    the CUDA main path.  (a) The build from the checkout.  (b)
    ``native.solve_gas_bdf`` on every NATIVE_STRIDE-th main-path lane,
    status and tau against phase 3's (1e-3, phase 20 (a)'s bound), the
    host wall per lane; ``batch_reactor(backend="cpu")`` on phase 5's
    h2o2 input against phase 5.  (c1) ``checkpointed_sweep`` over phase
    3's lanes in chunks of CKPT_CHUNK with ``quarantine={"oracle": True}``
    and no fault: every lane equal to phase 20 (a)'s to the bit
    (``dir_a``; without it the reference sweep runs here).  (c2) Chunk
    ORACLE_CHUNK through ``resilience.quarantine.resolve`` with a
    ``solve_subset`` that runs the device solve (``lu32p``) and fails
    ORACLE_LANES on every pass, and ``native_oracle`` over the sweep's
    RHS on the card as the oracle: the two lanes' provenance ``oracle``,
    their native tau within 1e-3 of phase 3's, the other lanes equal to
    the chunk's device result to the bit, the oracle's seconds per lane
    (and one lane again over a float64 CPU copy of the mechanism).  (d)
    ``tools/fault_smoke.py`` in a child process on the card: exit 0 and
    the four fault classes in its ``fault_events.jsonl`` (``fault_kid``:
    the child ``start_fault_smoke`` started before an earlier phase)."""
    import torch

    from batchreactor_tpu_torch import native
    from batchreactor_tpu_torch.native import bindings
    from batchreactor_tpu_torch.ops.rhs import make_gas_rhs
    from batchreactor_tpu_torch.parallel import checkpoint as ck
    from batchreactor_tpu_torch.parallel import checkpointed_sweep
    from batchreactor_tpu_torch.resilience import (QuarantinePolicy,
                                                   fallback_kwargs)
    from batchreactor_tpu_torch.resilience import quarantine as qr

    walls = {}
    # (a) the build
    t0 = time.perf_counter()
    native.load_library()
    walls["a_build"] = time.perf_counter() - t0
    build_s = bindings.BUILD_INFO.get("seconds")

    # (b) the native BDF on the main path's lanes, and backend="cpu"
    marker = list(gm.species).index("CH4")
    idx = np.arange(0, B_MAIN, NATIVE_STRIDE)
    y0s_b, _, _, _, _, _ = main_path_lanes(gm, th, T[idx], device)
    y0_np = y0s_b.cpu().numpy()
    lane_s, tau_n, stat_n, steps_n = [], [], [], []
    for k, i in enumerate(idx):
        t0 = time.perf_counter()
        r = native.solve_gas_bdf(gm, th, float(T[i]), y0_np[k], 0.0, T1,
                                 rtol=RTOL, atol=ATOL, n_save=8192)
        lane_s.append(time.perf_counter() - t0)
        stat_n.append(r.status)
        steps_n.append(r.n_accepted)
        tau_n.append(native_tau(r, y0_np[k], marker))
    tau_n = np.asarray(tau_n)
    rel_b = np.abs(tau_n / out3["tau"][idx] - 1.0)
    if not (all(s == "Success" for s in stat_n)
            and np.all(out3["status"][idx] == 1) and rel_b.max() <= 1e-3):
        raise AssertionError(f"native: (b) status {stat_n}, tau max rel "
                             f"{rel_b.max()} against phase 3")
    t0 = time.perf_counter()
    status_cpu, rows_cpu = file_driven_h2o2(bt, backend="cpu")
    walls["b_backend_cpu"] = time.perf_counter() - t0
    last = rows_cpu[-1]
    keys = [k for k in file_row if k not in ("t", "T", "p", "rho")]
    dx = max(abs(last[k] - file_row[k]) - 1e-3 * abs(file_row[k])
             for k in keys)
    if status_cpu != "Success" or last["t"] != file_row["t"] or dx > 1e-5:
        raise AssertionError(f"native: (b) backend='cpu' {status_cpu} "
                             f"{last} against phase 5 {file_row}")

    # (c1) the oracle rung armed beside the CUDA sweep, no fault
    rhs, y0s, cfg, kw = ckpt_setup(gm, th, T, device)
    tmp = tempfile.mkdtemp(prefix="br_native_")
    if dir_a is None:
        dir_a = os.path.join(tmp, "a")
        checkpointed_sweep(rhs, y0s, 0.0, T1, cfg, dir_a,
                           chunk_size=CKPT_CHUNK, **kw)
    ref = ckpt_fields(checkpointed_sweep(rhs, y0s, 0.0, T1, cfg, dir_a,
                                         chunk_size=CKPT_CHUNK, **kw))
    ck.reset_counts()
    res_c1, _, by_phase["native_c1"], walls["c1"] = timed(
        lambda: checkpointed_sweep(rhs, y0s, 0.0, T1, cfg,
                                   os.path.join(tmp, "c1"),
                                   chunk_size=CKPT_CHUNK,
                                   quarantine={"oracle": True}, **kw))
    check_launches("native (c1)", by_phase["native_c1"], "warp")
    c1 = ckpt_fields(res_c1)
    eq_c1 = lanes_equal(ref, c1)
    prov_c1 = res_c1.provenance.numpy()
    if not (eq_c1.all() and ck.COUNTS["chunks_solved"] == B_MAIN
            // CKPT_CHUNK and not prov_c1.any()):
        raise AssertionError(f"native: (c1) {int(eq_c1.sum())} lanes equal "
                             f"to phase 20 (a), {ck.COUNTS}, provenance "
                             f"{np.unique(prov_c1)}")

    # (c2) two lanes of one chunk fail every device pass; the oracle
    # answers them
    lo = ORACLE_CHUNK * CKPT_CHUNK
    sel = slice(lo, lo + CKPT_CHUNK)
    y0c, cfgc = y0s[sel], {k: v[sel] for k, v in cfg.items()}
    run_kw = ck._resolve_run_kw(kw, y0s, B_MAIN)
    qpol = QuarantinePolicy(oracle=True)
    bad_T = set(float(v) for v in T[lo + np.asarray(ORACLE_LANES)])

    def device_solve(y, c, solve_kw):
        r = ck._solve_chunk(rhs, y, 0.0, T1, c, solve_kw)
        hit = [j for j, v in enumerate(c["T"].tolist()) if v in bad_T]
        return poison(r, hit)

    passes = []

    def solve_subset(y, c, pass_name):
        passes.append((pass_name, int(y.shape[0])))
        return device_solve(y, c, run_kw if pass_name == "retry"
                            else fallback_kwargs(qpol, run_kw))

    base = qr.native_oracle(rhs, 0.0, T1, rtol=RTOL, atol=ATOL,
                            n_save=8192)
    answers = []

    def oracle(y0_lane, cfg_lane):
        t0 = time.perf_counter()
        out = base(y0_lane, cfg_lane)
        answers.append((time.perf_counter() - t0, float(cfg_lane["T"]),
                        out, y0_lane.cpu().numpy()))
        return out

    torch.cuda.synchronize()
    t_c2 = time.perf_counter()
    # the chunk's device solve, then the ladder over its failed lanes
    clean, _, by_prim = counted(
        lambda: ck._solve_chunk(rhs, y0c, 0.0, T1, cfgc, run_kw))
    (res_c2, prov), _, by_res = counted(lambda: qr.resolve(
        poison(clean, list(ORACLE_LANES)), y0c, cfgc, solve_subset,
        policy=qpol, oracle=oracle))
    by_phase["native_c2"] = {p: by_prim[p] + by_res[p] for p in by_prim}
    torch.cuda.synchronize()
    walls["c2"] = time.perf_counter() - t_c2
    check_launches("native (c2)", by_phase["native_c2"], "warp")
    others = np.setdiff1d(np.arange(CKPT_CHUNK), ORACLE_LANES)
    eq_c2 = lanes_equal(lane_fields(clean), lane_fields(res_c2))
    tau_o = np.asarray([native_tau(out, y0, marker)
                        for _, _, out, y0 in answers])
    rel_c2 = np.abs(tau_o / out3["tau"][lo + np.asarray(ORACLE_LANES)]
                    - 1.0)
    if not (np.all(prov[list(ORACLE_LANES)] == qr.ORACLE)
            and not prov[others].any() and eq_c2[others].all()
            and len(answers) == len(ORACLE_LANES)
            and rel_c2.max() <= 1e-3
            and passes == [("retry", CKPT_CHUNK),
                           ("fallback", len(ORACLE_LANES))]):
        raise AssertionError(
            f"native: (c2) provenance {prov[list(ORACLE_LANES)]}, others "
            f"equal {int(eq_c2[others].sum())} of {len(others)}, oracle "
            f"answers {len(answers)}, tau max rel {rel_c2}, passes "
            f"{passes}")
    # the same oracle over a float64 CPU copy of the mechanism (what the
    # entry points that hold the mechanism build)
    cpu_oracle = qr.native_oracle(make_gas_rhs(gm.to("cpu"), th.to("cpu")),
                                  0.0, T1, rtol=RTOL, atol=ATOL,
                                  device="cpu", n_save=8192)
    j = ORACLE_LANES[0]
    t0 = time.perf_counter()
    out_cpu = cpu_oracle(y0c[j], {k: v[j] for k, v in cfgc.items()})
    oracle_cpu_s = time.perf_counter() - t0
    rel_cpu = abs(native_tau(out_cpu, y0c[j].cpu().numpy(), marker)
                  / out3["tau"][lo + j] - 1.0)
    if out_cpu.status != "Success" or not rel_cpu <= 1e-3:
        raise AssertionError(f"native: (c2) CPU-copy oracle {out_cpu.status}"
                             f", tau rel {rel_cpu}")

    # (d) the fault smoke on the card, in a child process (started here,
    # or earlier by the caller so that it runs beside a host-bound phase)
    kid = fault_kid or start_fault_smoke()
    d = finish_fault_smoke(kid)
    walls["d_fault_smoke"] = d["wall_s"]
    want = {"hung_fetch", "corrupt_chunk", "lane_quarantine",
            "dead_host_reassign"}
    if d["timed_out"] or d["rc"] != 0 or not want <= set(d["kinds"]):
        raise AssertionError(f"native: (d) fault_smoke rc {d['rc']}, kinds "
                             f"{d['kinds']}:\n{d['tail']}")
    emit({"phase": "native", "gpu": smi,
          "host": "the card's machine, host CPU (one thread)",
          "a_build_s": build_s, "a_load_s": walls["a_build"],
          "b_lanes": idx.tolist(), "b_status": stat_n,
          "b_wall_s_per_lane": lane_s,
          "b_wall_s_per_lane_mean": float(np.mean(lane_s)),
          "b_accepted": steps_n, "b_tau_max_rel_vs_phase3":
              float(rel_b.max()),
          "b_backend_cpu_h2o2": {"status": status_cpu, "t_end": last["t"],
                                 "x_H2O": last["H2O"], "x_O2": last["O2"],
                                 "rows": len(rows_cpu),
                                 "max_excess_over_bound": dx},
          "c1_lanes_bit_equal_phase20a": int(eq_c1.sum()),
          "c1_wall_s": walls["c1"],
          "c1_lu32p_launches_by_path": by_phase["native_c1"],
          "c2_chunk": ORACLE_CHUNK, "c2_lanes": [lo + j for j in
                                                 ORACLE_LANES],
          "c2_passes": passes,
          "c2_provenance": [qr.PROVENANCE_NAMES[int(prov[j])]
                            for j in ORACLE_LANES],
          "c2_oracle_s_per_lane": [a[0] for a in answers],
          "c2_oracle_rhs_calls": [a[2].n_rhs for a in answers],
          "c2_oracle_accepted": [a[2].n_accepted for a in answers],
          "c2_oracle_tau_rel_vs_phase3": rel_c2.tolist(),
          "c2_oracle_s_cpu_copy_rhs": oracle_cpu_s,
          "c2_oracle_cpu_copy_accepted": out_cpu.n_accepted,
          "c2_others_bit_equal": int(eq_c2[others].sum()),
          "c2_wall_s": walls["c2"],
          "c2_lu32p_launches_by_path": by_phase["native_c2"],
          "d_rc": d["rc"], "d_fault_kinds": d["kinds"],
          "d_started_before_phase": kid["before"],
          "walls_s": walls})


def native_main(bt, gm, th, device, smi):
    """``--native-only``: phase 3's sweep (cold, then warm), phase 5, then
    phase 25 (its reference checkpointed sweep runs there).  Prints no
    contract line."""
    import torch

    T = np.linspace(T_LO, T_HI, B_MAIN)
    sweep(bt, gm, th, T, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sweep(bt, gm, th, T, device)
    torch.cuda.synchronize()
    emit({"phase": "main_path", "gpu": smi,
          "wall_s": time.perf_counter() - t0})
    file_row = phase_file_driven(bt)
    by_phase = {}
    t0 = time.perf_counter()
    phase_native(bt, gm, th, T, {"status": out["status"], "tau": out["tau"]},
                 file_row, None, device, smi, by_phase)
    emit({"phase": "walls", "native_s": time.perf_counter() - t0,
          "launches_by_phase": by_phase})
    print(smi, flush=True)
    return 0


def state_deviation(got, want):
    """Largest deviation between two nests of tensors of one structure:
    floats as max |a - b| over max |b| per leaf, every other dtype as the
    count of unequal entries."""
    from batchreactor_tpu_torch.solver import graphs

    worst, unequal = 0.0, 0
    for a, b in zip(graphs.tree_leaves(got), graphs.tree_leaves(want)):
        if a.dtype.is_floating_point:
            scale = float(b.abs().max()) if b.numel() else 0.0
            dev = float((a - b).abs().max()) if b.numel() else 0.0
            worst = max(worst, dev / scale if scale > 0 else dev)
        else:
            unequal += int((a != b).sum())
    return worst, unequal


def phase_analysis(device, smi, by_phase):
    """Phase 26: static analysis on the card.  (a) The static tiers over
    the checkout (``tools/brlint.py`` by path: tier A and the concurrency
    lint over the package and this script, in a child process beside (b)
    and (c)) must be clean.  (b) The contract tier on ``cuda``: every
    registered contract's programs captured on the h2o2 fixture at B = 8,
    every obligation evaluated on the captured graphs, none may fail, and
    ``bdf-step-lu32p``'s graphs must contain the ``lu32p`` kernel (their
    DOT dumps' kernel nodes and the capture tally).  (c) The
    ``bdf-step-lu32p`` segment program's ``begin`` and ``window`` captured
    and replayed once, against the same steps run eagerly with
    ``lu32p_factor_plain``: every float of the solver's carry within the
    warp path's phase-2 bound 64 n eps32 of its lane-batch maximum, every
    integer equal."""
    walls = {}
    t_static = time.perf_counter()
    kid = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "batchreactor_tpu_torch",
                                      "tools", "brlint.py"),
         os.path.join(HERE, "batchreactor_tpu_torch"),
         os.path.join(HERE, "chip_smoke.py"), "--concurrency", "--json"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=HERE)
    try:
        summary = analysis_on_card(smi, by_phase, walls)
    finally:
        try:
            out, err = kid.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            kid.kill()
            out, err = kid.communicate()
    walls["static_s"] = time.perf_counter() - t_static
    if kid.returncode != 0:
        raise AssertionError(f"analysis: the static tiers exit "
                             f"{kid.returncode}:\n{out[-3000:]}\n"
                             f"{err[-3000:]}")
    doc = json.loads(out)
    emit({"phase": "analysis", "gpu": smi,
          "static": {"findings": len(doc["findings"]),
                     "suppressed": doc["suppressed"]}, **summary,
          "lu32p_launches_by_path": by_phase["analysis"], "walls": walls})


def analysis_on_card(smi, by_phase, walls):
    """Phase 26 (b) and (c) (:func:`phase_analysis`); returns their
    summary."""
    import torch

    from batchreactor_tpu_torch.analysis import contracts as C
    from batchreactor_tpu_torch.solver import graphs, linalg
    from batchreactor_tpu_torch.solver import linalg_cuda as lc

    # ---- (b) the contract tier on the card ------------------------------
    census = []
    graphs.reset_counts()
    t0 = time.perf_counter()
    findings, _, by_phase["analysis"] = counted(
        lambda: C.run_contracts(device="cuda", census=census))
    walls["contracts_s"] = time.perf_counter() - t0
    for entry in census:
        emit({"phase": "analysis_contract", "gpu": smi, **{
            k: entry[k] for k in ("name", "obligations", "findings",
                                  "seconds")},
            "programs": [{k: p[k] for k in ("tag", "captured", "nodes",
                                            "kernels", "ops",
                                            "lu32p_launches", "seconds")}
                         for p in entry["programs"]]})
    if findings:
        raise AssertionError("analysis: the contract tier on cuda found:\n"
                             + "\n".join(f.render() for f in findings))
    lu = [p for e in census if e["name"] == "bdf-step-lu32p"
          for p in e["programs"]]
    if not lu or not all(p["captured"] and p["lu32p_launches"].get(
            "warp", 0) > 0 for p in lu):
        raise AssertionError(f"analysis: bdf-step-lu32p's captures {lu}")
    if by_phase["analysis"]["warp"] <= 0:
        raise AssertionError(f"analysis: lu32p launches "
                             f"{by_phase['analysis']}")

    # ---- (c) the lu32p window: replayed graph against the eager plain twin
    t0 = time.perf_counter()
    h = C.Harness(device="cuda")
    prog = h.segment_program(linsolve="lu32p")
    twin = h.segment_program(linsolve="lu32p")
    for name in ("begin", "window"):
        prog.run(name)
    kernel, plain = linalg.lu32p_factor, lc.lu32p_factor_plain
    linalg.lu32p_factor = plain
    try:
        for name in ("begin", "window"):
            twin.state.update(twin.steps[name](twin.state))
    finally:
        linalg.lu32p_factor = kernel
    torch.cuda.synchronize()
    n = h.y0.shape[1]
    bound = 64 * n * EPS32
    worst, unequal = state_deviation(prog.state["w"], twin.state["w"])
    walls["replay_s"] = time.perf_counter() - t0
    if not (worst <= bound and unequal == 0):
        raise AssertionError(f"analysis: the replayed lu32p window differs "
                             f"from its eager plain twin: {worst} of the "
                             f"lane-batch max (bound {bound}), {unequal} "
                             f"unequal integers")
    nodes = {}
    for entry in census:
        for p in entry["programs"]:
            for k, v in p["nodes"].items():
                nodes[k] = nodes.get(k, 0) + v
    return {"contracts": len(census),
            "obligations": sum(e["obligations"] for e in census),
            "programs": sum(len(e["programs"]) for e in census),
            "captured_programs": sum(p["captured"] for e in census
                                     for p in e["programs"]),
            "graph_nodes": nodes,
            "replay_vs_plain": {"max_rel": worst, "bound": bound,
                                "unequal_integers": unequal, "n": n,
                                "B": h.B}}


def start_analysis():
    """Start phase 26 (``chip_smoke.py --analysis-only``) in a child
    process, its output in a temporary directory: it runs beside the
    host-bound adjoint loop of phase 17, and :func:`finish_analysis`
    joins it in phase 26's slot and removes the directory."""
    tmp = tempfile.mkdtemp(prefix="br_analysis_")
    with open(os.path.join(tmp, "child.log"), "w") as log:
        proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"),
             "--analysis-only"], cwd=HERE, stdout=log,
            stderr=subprocess.STDOUT)
    return {"proc": proc, "dir": tmp, "t0": time.perf_counter()}


def finish_analysis(kid, smi, by_phase, timeout=900.0):
    """Phase 26's slot: wait for the child :func:`start_analysis` started
    (``timeout`` s from its start; SIGTERM past it), which must exit 0;
    re-emit its phase lines and take its ``lu32p`` launches (counted in
    the child, from 0, around its contract tier)."""
    timed_out = join_kid(kid, timeout)
    wall = time.perf_counter() - kid["t0"]
    try:
        with open(os.path.join(kid["dir"], "child.log")) as f:
            text = f.read()
    finally:
        drop_kid(kid)
    rows = []
    for ln in text.splitlines():
        if ln.startswith("{"):
            try:
                rows.append(json.loads(ln))
            except ValueError:
                pass
    walls = [r for r in rows if r.get("phase") == "walls"]
    if timed_out or kid["proc"].returncode != 0 or not walls:
        raise AssertionError(f"analysis: the child exited "
                             f"{kid['proc'].returncode} (timed out "
                             f"{timed_out}):\n{text[-4000:]}")
    for r in rows:
        if r.get("phase") in ("analysis_contract", "analysis"):
            emit({**r, "child_wall_s": wall} if r["phase"] == "analysis"
                 else r)
    by_phase["analysis"] = walls[-1]["launches_by_phase"]["analysis"]


def analysis_main(device, smi):
    """``--analysis-only``: phase 26 alone (after phase 1's build).
    Prints no contract line."""
    by_phase = {}
    t0 = time.perf_counter()
    phase_analysis(device, smi, by_phase)
    emit({"phase": "walls", "analysis_s": time.perf_counter() - t0,
          "launches_by_phase": by_phase})
    print(smi, flush=True)
    return 0


def start_baseline(before=None):
    """Start phase 27 (a), the map's single-core baseline
    (``tools/northstar_baseline.py``, NS_BASELINE_N x NS_BASELINE_N lanes,
    the native BDF), in a child process that cannot see the card
    (``CUDA_VISIBLE_DEVICES=""``), its record in a temporary directory;
    ``before`` names what runs beside it (None: phase 27 waits for it at
    once, alone on the host)."""
    tmp = tempfile.mkdtemp(prefix="br_baseline_")
    with open(os.path.join(tmp, "child.log"), "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "batchreactor_tpu_torch.tools.northstar_baseline",
             "--n", str(NS_BASELINE_N), "--solvers", "native",
             "--out", os.path.join(tmp, "baseline.json")],
            cwd=tmp, stdout=log, stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": HERE,
                 "CUDA_VISIBLE_DEVICES": ""})
    return {"proc": proc, "dir": tmp, "t0": time.perf_counter(),
            "t0_wall": time.time(), "before": before}


def finish_baseline(kid, timeout=600.0):
    """Wait for the baseline child (``timeout`` s from its start), which
    must exit 0 with NS_BASELINE_N**2 lanes, none failed; returns its
    record, the record's path and the child's wall (from its start to its
    record, which it writes last).  The directory stays for the map's
    lane-cost model (:func:`drop_kid` removes it)."""
    timed_out = join_kid(kid, timeout)
    path = os.path.join(kid["dir"], "baseline.json")
    rec = wall = None
    if os.path.exists(path):
        wall = os.path.getmtime(path) - kid["t0_wall"]
        with open(path) as f:
            rec = json.load(f)
    if timed_out or kid["proc"].returncode != 0 or rec is None:
        with open(os.path.join(kid["dir"], "child.log")) as f:
            tail = f.read()[-3000:]
        raise AssertionError(f"northstar: the baseline child exited "
                             f"{kid['proc'].returncode} (timed out "
                             f"{timed_out}):\n{tail}")
    nat = rec["solvers"]["native"]
    if len(rec["per_lane"]) != NS_BASELINE_N ** 2 or nat["n_failed"]:
        raise AssertionError(f"northstar: the baseline solved "
                             f"{len(rec['per_lane'])} lanes, "
                             f"{nat['n_failed']} failed")
    return rec, path, wall


def phase_northstar(gm, th, device, smi, by_phase, kid):
    """Phase 27: the north-star map (``tools/northstar_sweep.py``).  (a)
    Join the baseline child :func:`start_baseline` started: exit 0, 64
    lanes, none failed; its native s per lane.  (b) ``run_sweep`` at its
    defaults (64 T x 64 phi = 4096 lanes, chunks of NS_CHUNK cost-sorted
    by (a)'s record, f32 rate exponentials, 8 native spot lanes), cold:
    every lane ``success``, spot parity <= 1e-3 with no failed spot,
    sorted, every chunk solved, warp launches only.  (c) The same call on
    the same directory: no chunk solved, every chunk loaded, no launch,
    every lane equal to (b)'s to the bit.  (d) The diagonal lanes of the
    map (T_i, phi_i), i < 64 (every 64th lane would hold phi at its lean
    edge), with float64 exponentials through ``ensemble_solve_segmented``
    (``lu32p``, so only the exponentials differ): status equal to (b)'s,
    tau within 1e-3.  The flight recorder ``run_sweep`` arms is disarmed
    after the phase."""
    import re
    import shutil

    import torch

    from batchreactor_tpu_torch.obs import live
    from batchreactor_tpu_torch.ops.rhs import make_gas_jac, make_gas_rhs
    from batchreactor_tpu_torch.parallel import (ensemble_solve_segmented,
                                                 ignition_observer)
    from batchreactor_tpu_torch.solver import graphs
    from batchreactor_tpu_torch.tools import northstar_sweep as ns

    chunk_s = []

    def log(msg):
        # the checkpointed sweep logs each chunk's solve wall
        m = re.match(r"\[ckpt\] chunk \d+ \(\d+ lanes\): solve ([\d.]+)s",
                     msg)
        if m:
            chunk_s.append(float(m.group(1)))
        print(msg, file=sys.stderr, flush=True)

    tmp = tempfile.mkdtemp(prefix="br_northstar_")
    try:
        # (a) the baseline child
        base, base_path, base_wall = finish_baseline(kid)
        nat = base["solvers"]["native"]
        emit({"phase": "northstar_baseline", "lanes": len(base["per_lane"]),
              "solver": "native", "n_failed": nat["n_failed"],
              "s_per_lane_mean": nat["s_per_lane_mean"],
              "s_per_lane_min": nat["s_per_lane_min"],
              "s_per_lane_max": nat["s_per_lane_max"],
              "extrapolated_full_map_wall_s":
                  base["extrapolated_full_map_wall_s_native"],
              "host_cores": len(os.sched_getaffinity(0)),
              "beside": kid["before"] or "nothing (alone on the host)",
              "child_wall_s": base_wall})

        def run():
            return ns.run_sweep(
                n_T=NS_N, n_phi=NS_N, ckpt_dir=os.path.join(tmp, "ck"),
                chunk_size=NS_CHUNK, segment_steps=256, jac_window=8,
                exp32=True, baseline=base_path, n_spot=8, device=device,
                flight_dir=tmp, return_result=True, log=log)

        # (b) the map, cold
        graphs.reset_counts()
        (rec, res), _, by_phase["northstar"], wall = timed(run)
        B = NS_N * NS_N
        check_launches("northstar", by_phase["northstar"], "warp")
        if rec["counts"] != {"success": B}:
            raise AssertionError(f"northstar: lanes {rec['counts']}")
        if (rec["tau_parity_failed_spots"]
                or rec["tau_parity_max_rel_err"] is None
                or rec["tau_parity_max_rel_err"] > 1e-3
                or len(rec["spot_checks"]) != min(
                    8, B - rec["n_no_ignition"])):
            raise AssertionError(f"northstar: spot parity "
                                 f"{rec['spot_checks']}")
        n_chunks = -(-B // NS_CHUNK)
        if not rec["lane_cost_sorted"] or rec["chunks"] != {
                "n": n_chunks, "solved": n_chunks, "loaded": 0}:
            raise AssertionError(f"northstar: sorted "
                                 f"{rec['lane_cost_sorted']}, chunks "
                                 f"{rec['chunks']}")
        if rec["lu32p_launches"] != by_phase["northstar"]:
            raise AssertionError(f"northstar: the record's launches "
                                 f"{rec['lu32p_launches']} against "
                                 f"{by_phase['northstar']}")
        map_b = lane_fields(res)
        emit({"phase": "northstar", "gpu": smi, "B": B,
              "workload": rec["workload"], "exp32": rec["exp32"],
              "chunk_size": NS_CHUNK, "chunks": rec["chunks"],
              "lane_cost_sorted": rec["lane_cost_sorted"],
              "wall_s": rec["wall_s"], "cond_per_s": rec["cond_per_s"],
              "call_s": wall, "chunk_solve_s": chunk_s,
              "counts": rec["counts"],
              "n_no_ignition": rec["n_no_ignition"],
              "tau_range_s": rec["tau_range_s"],
              "tau_parity_max_rel_err": rec["tau_parity_max_rel_err"],
              "tau_parity_failed_spots": rec["tau_parity_failed_spots"],
              "phases_s": rec["phases_s"],
              "map_speedup_vs_native": nat["s_per_lane_mean"] * B
              / rec["wall_s"],
              "mean_accepted": float(map_b["n_accepted"].mean()),
              "max_accepted": int(map_b["n_accepted"].max()),
              "lu32p_launches_by_path": by_phase["northstar"],
              "graphs_captured": graphs.captures(),
              "graph_replays": graphs.COUNTS["replays"],
              "host_syncs": graphs.COUNTS["host_syncs"]})

        # (c) the resume: every chunk loaded, nothing launched
        (rec_c, res_c), _, by_phase["northstar_resume"], wall_c = timed(run)
        check_launches("northstar resume", by_phase["northstar_resume"],
                       None)
        eq = lanes_equal(map_b, lane_fields(res_c))
        if rec_c["chunks"] != {"n": n_chunks, "solved": 0,
                               "loaded": n_chunks} or not eq.all():
            raise AssertionError(f"northstar: the resume's chunks "
                                 f"{rec_c['chunks']}, {int(eq.sum())} of "
                                 f"{B} lanes equal to (b)")
        emit({"phase": "northstar_resume", "call_s": wall_c,
              "wall_s": rec_c["wall_s"], "chunks": rec_c["chunks"],
              "lanes_equal": int(eq.sum()),
              "lu32p_launches_by_path": by_phase["northstar_resume"]})

        # (d) float64 exponentials on the map's diagonal
        grid, y0s = ns.map_states(gm, th, NS_N, NS_N)
        idx = np.arange(NS_N) * (NS_N + 1)
        lanes = torch.as_tensor(idx, device=y0s.device)
        obs, obs0 = ignition_observer(list(gm.species).index("CH4"),
                                      mode="half")
        res_d, _, by_phase["northstar_f64"], wall_d = timed(
            lambda: ensemble_solve_segmented(
                make_gas_rhs(gm, th, exp32=False), y0s[lanes], 0.0, T1,
                {"T": grid["T"][lanes]}, segment_steps=256, rtol=RTOL,
                atol=ATOL, jac=make_gas_jac(gm, th, exp32=False),
                observer=obs, observer_init=obs0, method="bdf",
                jac_window=8, linsolve="lu32p"))
        check_launches("northstar f64", by_phase["northstar_f64"], "warp")
        d = lane_fields(res_d)
        tau_b = map_b["tau"][idx]
        rel = np.abs(tau_b / d["tau"] - 1.0)
        # a lane that ignites in neither run has no tau in either
        both_nan = np.isnan(tau_b) & np.isnan(d["tau"])
        same_status = np.array_equal(d["status"], map_b["status"][idx])
        if not (same_status and np.all(both_nan | (rel <= 1e-3))):
            raise AssertionError(f"northstar: exp32 against float64 "
                                 f"exponentials, status equal "
                                 f"{same_status}, tau max rel "
                                 f"{np.nanmax(rel)}, no tau "
                                 f"{int(np.isnan(tau_b).sum())} and "
                                 f"{int(np.isnan(d['tau']).sum())}")
        emit({"phase": "northstar_exp32_check", "lanes": int(idx.size),
              "lane_stride": NS_N + 1, "linsolve": "lu32p",
              "no_ignition": int(both_nan.sum()),
              "tau_max_rel": float(np.nanmax(rel)),
              "tau_mean_rel": float(np.nanmean(rel)), "wall_s": wall_d,
              "lu32p_launches_by_path": by_phase["northstar_f64"]})
    finally:
        live.disarm_flight()
        drop_kid(kid)
        shutil.rmtree(tmp, ignore_errors=True)


def northstar_main(gm, th, device, smi):
    """``--northstar-only``: phase 27 alone (after phase 1's build), its
    baseline child first and alone on the host.  Prints no contract
    line."""
    by_phase = {}
    t0 = time.perf_counter()
    phase_northstar(gm, th, device, smi, by_phase, start_baseline())
    emit({"phase": "walls", "northstar_s": time.perf_counter() - t0,
          "launches_by_phase": by_phase})
    print(smi, flush=True)
    return 0


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
    telemetry_only = "--telemetry-only" in sys.argv[1:]
    serving_only = "--serving-only" in sys.argv[1:]
    native_only = "--native-only" in sys.argv[1:]
    northstar_only = "--northstar-only" in sys.argv[1:]
    if "--analysis-only" in sys.argv[1:]:
        return analysis_main(device, smi)
    t0 = time.perf_counter()
    gm = bt.compile_gaschemistry(os.path.join(FIXTURES, "grimech.dat"))
    th = bt.create_thermo(list(gm.species),
                          os.path.join(FIXTURES, "therm.dat"))
    if profile_only:
        return profile_gears(bt, gm, th, device, smi)
    if telemetry_only:
        return telemetry_main(bt, gm, th, device, smi)
    if serving_only:
        return serving_main(bt, gm, th, device, smi)
    if native_only:
        return native_main(bt, gm, th, device, smi)
    if northstar_only:
        return northstar_main(gm, th, device, smi)
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
    file_row = phase_file_driven(bt)

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
    energy_lanes = phase_energy(bt, gm, th, device, smi, timing, by_phase)
    Ts = T[::SDIRK_STRIDE]
    phase_sdirk(bt, gm, th, Ts, tau[::SDIRK_STRIDE], rep_main, device, smi,
                by_phase)
    phase_linsolve_ab(gm, th, Ts, device, smi, by_phase)

    # ---- phases 15-21: padding, sensitivities, the gears, the stream, ---
    # ---- checkpointing and resilience, the multi-process tiers -----------
    walls = {}
    ckpt_dir = []
    served = []
    kids = []
    out3 = {"status": out["status"], "tau": tau, "x": out["x"]}
    case = main_serve_case(gm, T, *energy_lanes)
    for name, run in (
            ("padded_gas", lambda: phase_padded(bt, gm, th, T, tau, rep_main,
                                                device, smi, by_phase)),
            ("sens_forward", lambda: phase_sens_forward(gm, th, device,
                                                        smi, by_phase)),
            # phase 25 (d)'s fault smoke, phase 26 and phase 27 (a)'s
            # baseline (on the host only) run in child processes beside the
            # host-bound adjoint loop
            ("adjoint", lambda: (kids.append(start_fault_smoke("adjoint")),
                                 kids.append(start_analysis()),
                                 kids.append(start_baseline(BESIDE_17)),
                                 phase_adjoint(gm, th, T, device, smi))),
            ("gears", lambda: phase_gears(bt, gm, th, sm, T, device, smi,
                                          by_phase)),
            ("stream", lambda: phase_stream(gm, th, device, smi,
                                            by_phase)),
            ("resilience", lambda: ckpt_dir.append(phase_resilience(
                bt, gm, th, T, out3, wall, device, smi, by_phase))),
            ("multihost", lambda: phase_multihost(ckpt_dir[0], out3, smi,
                                                  by_phase)),
            ("telemetry", lambda: phase_telemetry(
                bt, gm, th, T, out3, counts3, wall, launches, device, smi,
                by_phase)),
            ("serving", lambda: served.append(phase_serving(
                bt, gm, th, case, out3, wall, device, smi, by_phase))),
            ("fleet", lambda: phase_fleet(case, served[0], device, smi)),
            ("native", lambda: phase_native(bt, gm, th, T, out3, file_row,
                                            ckpt_dir[0], device, smi,
                                            by_phase, fault_kid=kids[0])),
            ("analysis", lambda: finish_analysis(kids[1], smi, by_phase)),
            ("northstar", lambda: phase_northstar(gm, th, device, smi,
                                                  by_phase, kids[2]))):
        t0 = time.perf_counter()
        try:
            run()
        except BaseException:
            for kid in kids:
                drop_kid(kid)
            raise
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
