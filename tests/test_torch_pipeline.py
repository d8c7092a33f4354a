"""Port parity: the pipelined segment gear (``parallel/sweep.py``) and the
fixed-trip step windows it replays (``solver/bdf.py``/``sdirk.py``
``make_stepper``, ``solver/graphs.py``), on the CPU.

* The fixed-trip window (every attempt and every Newton iteration run
  under the lanes' masks, no host decision) equals the blocking loop bit
  for bit, on Robertson lanes that fail Newton at different attempts.
* The pipelined gear equals the blocking gear bit for bit over method x
  ``n_save`` x ``poll_every`` with a DT_UNDERFLOW lane, and with the
  ``max_attempts`` budget parking lanes mid-sweep; these mirror
  ``tests/test_parallel.py::test_pipelined_bit_exact_matrix`` and
  ``::test_pipelined_budget_parking_bit_exact``.
* The pipelined gear matches the JAX package's pipelined gear at the sweep
  tier (h2o2: status equal, x within 10 rtol).

On the CPU the steps run eagerly; on the card the same steps replay CUDA
graphs (``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 18).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import batchreactor_tpu as br
import batchreactor_tpu_torch as bt
from batchreactor_tpu.parallel import ensemble_solve_segmented as seg_j
from batchreactor_tpu_torch.parallel import sweep as sp
from batchreactor_tpu_torch.solver import bdf, graphs, sdirk
from batchreactor_tpu_torch.solver.common import (DT_UNDERFLOW,
                                                  MAX_STEPS_REACHED, RUNNING,
                                                  SUCCESS)

torch.set_num_threads(1)

# Robertson, one stiff rate per lane: lanes reject and fail their Newton
# iteration at different attempts (tests/test_torch_bdf.py)
K3 = np.array([3e7, 1e7, 3e6, 1e8])
Y0 = np.array([[1.0, 0.0, 0.0]] * len(K3))


def _robertson(t, y, cfg):
    d1 = -0.04 * y[:, 0] + 1e4 * y[:, 1] * y[:, 2]
    d3 = cfg["k"] * y[:, 1] * y[:, 1]
    return torch.stack([d1, -d1 - d3, d3], dim=1)


def _result_fields(r):
    out = {f: getattr(r, f) for f in ("t", "y", "status", "n_accepted",
                                      "n_rejected", "ts", "ys", "n_saved",
                                      "h")}
    out.update({f"obs_{k}": v for k, v in (r.observed or {}).items()})
    if r.err_prev is not None:
        out["err_prev"] = r.err_prev
    if r.solver_state is not None:
        out.update({f"ss{i}": v for i, v in
                    enumerate(graphs.tree_leaves(r.solver_state))})
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def _bit_exact(a, b, ctx=""):
    fa, fb = _result_fields(a), _result_fields(b)
    assert fa.keys() == fb.keys(), ctx
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=f"{ctx} {k}")


@pytest.mark.parametrize("method,opts", [
    ("bdf", dict(jac_window=1)),
    ("bdf", dict(jac_window=4)),
    ("bdf", dict(jac_window=4, setup_economy=True)),
    ("bdf", dict(jac_window=4, freeze_precond=True)),
    ("bdf", dict(jac_window=4, setup_economy=True, n_save=6)),
    ("sdirk", dict(jac_window=1)),
    ("sdirk", dict(jac_window=3, n_save=6)),
], ids=lambda x: x if isinstance(x, str) else
    ",".join(f"{k}={v}" for k, v in x.items()))
def test_fixed_trip_window_equals_break_loop(method, opts):
    """A window that runs all its attempts and all max_newton iterations
    under the lanes' masks leaves every lane's values as the loops that
    stop early do, bit for bit, and executes at least their iterations."""
    solver = {"bdf": bdf, "sdirk": sdirk}[method]
    y0 = torch.tensor(Y0)
    cfg = {"k": torch.tensor(K3)}
    kw = dict(rtol=1e-4, atol=1e-10, linsolve="lu")
    graphs.reset_counts()
    ref = solver.solve(_robertson, y0, 0.0, 1e3, cfg, **kw, **opts)
    needed = graphs.COUNTS["newton_iters"]
    B, n = y0.shape
    st = solver.make_stepper(_robertson, cfg, B, n, y0.dtype, y0.device,
                             **kw, **opts)
    carry = st.init(y0, 0.0, 1e3)
    windows = 0
    graphs.reset_counts()
    while bool((carry["status"] == RUNNING).any()):
        carry = st.window(carry, fixed=True)
        windows += 1
    got = st.result(carry)
    _bit_exact(ref, got, f"{method} {opts}")
    assert graphs.COUNTS["host_syncs"] == 0
    assert graphs.COUNTS["newton_iters"] >= needed
    per_attempt = 6 if method == "bdf" else 5 * 8
    assert graphs.COUNTS["newton_iters"] == (
        windows * opts["jac_window"] * per_attempt)
    # a replay after every lane stopped changes nothing
    again = st.result(st.window(carry, fixed=True))
    _bit_exact(got, again, "no-op window")


def _decay_rhs(t, y, cfg):
    return -cfg["k"][:, None] * y


def _decay_setup(B=4, poison_lane=None, k_hi=2.5):
    y0 = torch.tensor([[1.0, 0.5]] * B, dtype=torch.float64)
    if poison_lane is not None:
        y0[poison_lane, 0] = float("nan")
    return y0, {"k": torch.logspace(1.0, k_hi, B, dtype=torch.float64)}


def _decay_observer():
    init = {"ymax": -float("inf"), "t_last": float("nan")}

    def obs(t, y, acc):
        return {"ymax": torch.maximum(y[:, 0], acc["ymax"]), "t_last": t}

    return obs, init


@pytest.mark.parametrize("method", ["bdf", "sdirk"])
@pytest.mark.parametrize("n_save", [0, 4])
def test_pipelined_bit_exact_matrix(method, n_save):
    obs, obs0 = _decay_observer()
    y0, cfg = _decay_setup(B=4, poison_lane=1)
    kw = dict(segment_steps=16, max_segments=20, observer=obs,
              observer_init=obs0, n_save=n_save, method=method,
              dt_min_factor=1e-12)
    blocking = sp.ensemble_solve_segmented(_decay_rhs, y0, 0.0, 1.0, cfg,
                                           pipeline=False, **kw)
    status = blocking.status.numpy()
    assert status[1] == DT_UNDERFLOW and np.all(np.delete(status, 1)
                                                == SUCCESS)
    assert int(blocking.n_accepted.max()) > 32  # spans >2 segments
    for poll_every in (1, 4, 50):
        piped = sp.ensemble_solve_segmented(_decay_rhs, y0, 0.0, 1.0, cfg,
                                            pipeline=True,
                                            poll_every=poll_every, **kw)
        _bit_exact(blocking, piped, f"{method}/n_save={n_save}/"
                                    f"poll={poll_every}")
    # the caller's arrays are untouched
    assert np.isnan(y0[1, 0].item())


def test_pipelined_budget_parking_bit_exact():
    y0, cfg = _decay_setup(B=4)
    kw = dict(segment_steps=16, max_segments=64, max_attempts=120)
    blocking = sp.ensemble_solve_segmented(_decay_rhs, y0, 0.0, 1.0, cfg,
                                           pipeline=False, **kw)
    status = blocking.status.numpy()
    assert np.any(status == MAX_STEPS_REACHED) and np.any(status == SUCCESS)
    for poll_every in (1, 3):
        piped = sp.ensemble_solve_segmented(_decay_rhs, y0, 0.0, 1.0, cfg,
                                            pipeline=True,
                                            poll_every=poll_every, **kw)
        _bit_exact(blocking, piped, f"budget/poll={poll_every}")
    # max_segments exhausted with lanes running: both gears park them
    kw = dict(segment_steps=16, max_segments=3)
    blocking = sp.ensemble_solve_segmented(_decay_rhs, y0, 0.0, 1.0, cfg,
                                           pipeline=False, **kw)
    assert np.all(blocking.status.numpy() == MAX_STEPS_REACHED)
    _bit_exact(blocking, sp.ensemble_solve_segmented(
        _decay_rhs, y0, 0.0, 1.0, cfg, pipeline=True, **kw), "max_segments")


def test_pipelined_host_syncs_and_progress():
    """The pipelined gear reads one flag per window and one per segment;
    the blocking gear pays a sync per Newton iteration.  progress sees
    every segment in order, with every drained row."""
    y0, cfg = _decay_setup(B=4)
    kw = dict(segment_steps=16, max_segments=64, n_save=40)
    seen_b, seen_p = [], []
    graphs.reset_counts()
    blocking = sp.ensemble_solve_segmented(_decay_rhs, y0, 0.0, 1.0, cfg,
                                           pipeline=False,
                                           progress=seen_b.append, **kw)
    syncs_b = graphs.COUNTS["host_syncs"]
    graphs.reset_counts()
    piped = sp.ensemble_solve_segmented(_decay_rhs, y0, 0.0, 1.0, cfg,
                                        pipeline=True, poll_every=4,
                                        progress=seen_p.append, **kw)
    _bit_exact(blocking, piped, "progress")
    segments = len(seen_b)
    assert segments >= 3
    assert [p["segment"] for p in seen_p] == list(range(segments))
    assert seen_p[-1]["lanes_done"] == 4
    assert sum(len(p.get("drained_ts", ())) for p in seen_p) == sum(
        len(p.get("drained_ts", ())) for p in seen_b) == 160
    windows = graphs.COUNTS["replays"] or (graphs.COUNTS["host_syncs"]
                                           - 2 * segments)
    assert graphs.COUNTS["host_syncs"] <= windows + 2 * segments
    assert syncs_b > 3 * graphs.COUNTS["host_syncs"]


def test_program_runs_eagerly_on_the_cpu():
    """On the CPU a Program's steps run as plain calls: no capture, no
    replay, the state rebound."""
    calls = []

    def bump(s):
        calls.append(1)
        return {"x": s["x"] + 1}

    prog = graphs.Program("cpu", {"bump": bump})
    prog.set(x=torch.zeros(3))
    graphs.reset_counts()
    for _ in range(3):
        prog.run("bump")
    assert torch.equal(prog.state["x"], torch.full((3,), 3.0))
    assert len(calls) == 3 and graphs.captures() == 0
    assert graphs.COUNTS["replays"] == 0


@pytest.fixture(scope="module")
def h2o2(fixtures_dir):
    path = os.path.join(fixtures_dir, "h2o2.dat")
    therm = os.path.join(fixtures_dir, "therm.dat")
    gm_j = br.compile_gaschemistry(path)
    gm_t = bt.compile_gaschemistry(path, device="cpu")
    return (gm_j, br.create_thermo(list(gm_j.species), therm),
            gm_t, bt.create_thermo(list(gm_t.species), therm, device="cpu"))


def _h2o2_lanes(h2o2, T):
    from batchreactor_tpu.ops.rhs import make_gas_jac as jac_j
    from batchreactor_tpu.ops.rhs import make_gas_rhs as rhs_j
    from batchreactor_tpu.utils.composition import density, mole_to_mass
    from batchreactor_tpu_torch.ops.rhs import make_gas_jac, make_gas_rhs

    gm_j, th_j, gm_t, th_t = h2o2
    sp_names = list(gm_t.species)
    x = np.zeros(len(sp_names))
    for k, v in {"H2": 0.3, "O2": 0.15, "N2": 0.55}.items():
        x[sp_names.index(k)] = v
    y0 = np.stack([np.asarray(mole_to_mass(jnp.asarray(x), th_j.molwt)
                              * density(jnp.asarray(x), th_j.molwt, T_, 1e5))
                   for T_ in T])
    return (y0, np.asarray(T), (rhs_j(gm_j, th_j), jac_j(gm_j, th_j)),
            (make_gas_rhs(gm_t, th_t), make_gas_jac(gm_t, th_t)))


def test_pipelined_matches_jax_pipelined(h2o2):
    """The port's pipelined gear against the JAX package's on h2o2 lanes
    crossing segments: status equal, final state within 10 rtol (steps
    reported).  SDIRK's pipelined gear equals its blocking gear bit for bit
    (test_pipelined_bit_exact_matrix), which tests/test_torch_sdirk.py
    holds against the JAX package."""
    y0, T, (rj, jj), (rt, jt) = _h2o2_lanes(h2o2, [1100.0, 1250.0, 1400.0])
    kw = dict(segment_steps=16, rtol=1e-6, atol=1e-10, linsolve="lu",
              method="bdf", jac_window=1)
    ref = seg_j(rj, jnp.asarray(y0), 0.0, 1e-4, {"T": jnp.asarray(T)},
                jac=jj, pipeline=True, poll_every=2, **kw)
    got = sp.ensemble_solve_segmented(
        rt, torch.tensor(y0), 0.0, 1e-4, {"T": torch.tensor(T)}, jac=jt,
        pipeline=True, poll_every=2, **kw)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    yr = np.asarray(ref.y)
    np.testing.assert_allclose(got.y.numpy(), yr, rtol=1e-5,
                               atol=1e-5 * np.abs(yr).max())
    print("accepted port/jax:", got.n_accepted.tolist(),
          np.asarray(ref.n_accepted).tolist())
    assert jax.default_backend() == "cpu"


@pytest.mark.parametrize("n", [1, 9, 53, 66, 241])
def test_inv32_equals_the_library_inverse(n):
    """The ``inv32*`` modes' inverse (the lu32p factor and a triangular
    solve of the identity, capturable where ``torch.linalg.inv_ex`` is
    not) equals ``inv_ex`` in float32 to cond(M) eps32, and a singular M
    still gives a non-finite inverse."""
    from batchreactor_tpu_torch.solver.linalg import inv32

    rng = np.random.default_rng(n)
    M = torch.tensor(rng.standard_normal((6, n, n)) + 3 * np.eye(n))
    got = inv32(M)
    want = torch.linalg.inv_ex(M.to(torch.float32))[0]
    assert got.dtype == torch.float32 and got.shape == want.shape
    cond = torch.linalg.cond(M.to(torch.float32))
    err = (got - want).abs().amax((1, 2)) / want.abs().amax((1, 2))
    eps32 = float(np.finfo(np.float32).eps)
    assert bool((err <= 4 * n * cond * eps32).all()), (err, cond)
    S = torch.eye(3, dtype=torch.float64).expand(2, 3, 3).clone()
    S[1, 1, 1] = 0.0
    inv = inv32(S)
    assert torch.equal(inv[0], torch.eye(3)) and not bool(
        torch.isfinite(inv[1]).all())
