"""Port parity: the lane-batched SDIRK4 (batchreactor_tpu_torch
solver/sdirk.py) against the JAX solver under ``vmap``.

Robertson with per-lane rates, an observer fold and an ``n_save`` buffer,
at jac_window 1 and 4, and with a step budget that leaves some lanes at
MAX_STEPS_REACHED: the same formulas on both sides, so every lane's status
and accepted and rejected counts are equal and the final state, the fold
and the saved rows agree to roundoff.  A batched h2o2 sweep through
``batch_reactor_sweep(method="sdirk")`` agrees with the JAX package's at
the rtol scale, and a segmented SDIRK sweep, which resumes each lane's step
size and PI controller memory (``err0``) across segments, equals the
monolithic solve bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import batchreactor_tpu as br
import batchreactor_tpu_torch as bt
from batchreactor_tpu.solver import sdirk as sdirk_j
from batchreactor_tpu_torch.parallel import (ensemble_solve,
                                             ensemble_solve_segmented)
from batchreactor_tpu_torch.solver import common, sdirk

torch.set_num_threads(1)

K3 = np.array([3e7, 1e7, 3e6, 1e8])
Y0 = np.array([[1.0, 0.0, 0.0]] * len(K3))
T1 = 1e5
RTOL = 1e-6


def _robertson_t(t, y, cfg):
    d1 = -0.04 * y[:, 0] + 1e4 * y[:, 1] * y[:, 2]
    d3 = cfg["k"] * y[:, 1] * y[:, 1]
    return torch.stack([d1, -d1 - d3, d3], dim=1)


def _robertson_j(t, y, cfg):
    d1 = -0.04 * y[0] + 1e4 * y[1] * y[2]
    d3 = cfg["k"] * y[1] * y[1]
    return jnp.stack([d1, -d1 - d3, d3])


def _peak_t(t, y, acc):
    return {"m": torch.maximum(acc["m"], y[:, 1])}


def _peak_j(t, y, acc):
    return {"m": jnp.maximum(acc["m"], y[1])}


def test_status_codes_line_up_with_jax():
    assert (common.RUNNING, common.SUCCESS, common.MAX_STEPS_REACHED,
            common.DT_UNDERFLOW) == (sdirk_j.RUNNING, sdirk_j.SUCCESS,
                                     sdirk_j.MAX_STEPS_REACHED,
                                     sdirk_j.DT_UNDERFLOW)
    assert common.ATOL_SCALE_KEY == sdirk_j.ATOL_SCALE_KEY
    np.testing.assert_array_equal(np.asarray(sdirk._B_ERR), sdirk_j._B_ERR)


@pytest.mark.parametrize("jac_window,max_steps", [(1, 100_000), (4, 100_000),
                                                  (1, 300)])
def test_robertson_lanes_match_jax(jac_window, max_steps):
    kw = dict(rtol=1e-4, atol=1e-10, jac_window=jac_window, linsolve="lu",
              n_save=16, max_steps=max_steps)
    ref = jax.vmap(lambda y, k: sdirk_j.solve(
        _robertson_j, y, 0.0, T1, {"k": k}, observer=_peak_j,
        observer_init={"m": jnp.asarray(0.0)}, **kw))(
        jnp.asarray(Y0), jnp.asarray(K3))
    got = sdirk.solve(_robertson_t, torch.tensor(Y0), 0.0, T1,
                      {"k": torch.tensor(K3)}, observer=_peak_t,
                      observer_init={"m": torch.zeros(len(K3),
                                                      dtype=torch.float64)},
                      **kw)
    for name in ("status", "n_accepted", "n_rejected", "n_saved"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    if max_steps < 1000:
        assert set(got.status.tolist()) == {common.SUCCESS,
                                            common.MAX_STEPS_REACHED}
    # lanes that reached t1: the final state to roundoff; lanes cut by the
    # step budget stop at times that differ as the saved rows' do (below)
    done = got.status.numpy() == common.SUCCESS
    y_ref = np.asarray(ref.y)
    np.testing.assert_allclose(got.y.numpy()[done], y_ref[done], rtol=1e-9,
                               atol=1e-9 * np.abs(y_ref).max())
    np.testing.assert_allclose(got.t.numpy()[done], np.asarray(ref.t)[done],
                               rtol=1e-9)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-2)
    # the fold: to roundoff, within the solve's atol on the stiff
    # transient of y2 (its peak moves by ~1e-12 of 1e-10 atol)
    np.testing.assert_allclose(got.observed["m"].numpy(),
                               np.asarray(ref.observed["m"]), rtol=1e-9,
                               atol=kw["atol"])
    # the saved rows: the same rows filled; their times agree to 1e-2 only,
    # because Robertson's embedded error estimate is a difference of stage
    # derivatives ~13 decades apart, so its roundoff (~1e-3 relative) moves
    # each PI step size a little (h2o2 keeps them to roundoff: below)
    ts_ref = np.asarray(ref.ts)
    np.testing.assert_array_equal(np.isfinite(got.ts.numpy()),
                                  np.isfinite(ts_ref))
    np.testing.assert_allclose(got.ts.numpy(), ts_ref, rtol=1e-2)
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(ref.ys), rtol=1e-2,
                               atol=kw["atol"])
    print(f"jac_window={jac_window} max_steps={max_steps}: accepted",
          got.n_accepted.tolist(), "rejected", got.n_rejected.tolist())


def test_atol_scale_weights_the_sdirk_norms_as_jax():
    """A (B, n) atol weight in cfg changes the step sequence on both sides
    alike."""
    w = np.array([[1.0, 1e3, 1.0]] * len(K3))
    kw = dict(rtol=1e-4, atol=1e-10, linsolve="lu")
    ref = jax.vmap(lambda y, k, w1: sdirk_j.solve(
        _robertson_j, y, 0.0, T1, {"k": k, sdirk_j.ATOL_SCALE_KEY: w1},
        **kw))(jnp.asarray(Y0), jnp.asarray(K3), jnp.asarray(w))
    got = sdirk.solve(_robertson_t, torch.tensor(Y0), 0.0, T1,
                      {"k": torch.tensor(K3),
                       common.ATOL_SCALE_KEY: torch.tensor(w)}, **kw)
    plain = sdirk.solve(_robertson_t, torch.tensor(Y0), 0.0, T1,
                        {"k": torch.tensor(K3)}, **kw)
    np.testing.assert_array_equal(got.n_accepted.numpy(),
                                  np.asarray(ref.n_accepted))
    assert not torch.equal(got.n_accepted, plain.n_accepted)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(ref.y), rtol=1e-9,
                               atol=1e-15)


def test_jacfwd_fallback_matches_analytic_jacobian():
    kw = dict(rtol=1e-4, atol=1e-10, linsolve="lu")
    cfg = {"k": torch.tensor(K3)}

    def jac(t, y, cfg):
        J = torch.zeros((y.shape[0], 3, 3), dtype=y.dtype)
        k = cfg["k"]
        J[:, 0] = torch.stack([torch.full_like(k, -0.04), 1e4 * y[:, 2],
                               1e4 * y[:, 1]], dim=1)
        J[:, 2, 1] = 2 * k * y[:, 1]
        J[:, 1] = -J[:, 0] - J[:, 2]
        return J

    a = sdirk.solve(_robertson_t, torch.tensor(Y0), 0.0, 1e2, cfg, jac=jac,
                    **kw)
    b = sdirk.solve(_robertson_t, torch.tensor(Y0), 0.0, 1e2, cfg, **kw)
    np.testing.assert_array_equal(a.n_accepted.numpy(), b.n_accepted.numpy())
    np.testing.assert_allclose(a.y.numpy(), b.y.numpy(), rtol=1e-10,
                               atol=1e-16)


def test_segmented_resume_through_err0_is_bit_exact():
    """Segments of 37 attempts carry each lane's step size and PI memory:
    the segmented sweep repeats the monolithic step sequence exactly."""
    kw = dict(rtol=1e-4, atol=1e-10, linsolve="lu", method="sdirk",
              observer=_peak_t, observer_init={"m": 0.0})
    cfg = {"k": torch.tensor(K3)}
    mono = ensemble_solve(_robertson_t, torch.tensor(Y0), 0.0, T1, cfg, **kw)
    seg = ensemble_solve_segmented(_robertson_t, torch.tensor(Y0), 0.0, T1,
                                   cfg, segment_steps=37, **kw)
    for name in ("y", "t", "status", "n_accepted", "n_rejected", "err_prev"):
        assert torch.equal(getattr(seg, name), getattr(mono, name)), name
    assert torch.equal(seg.observed["m"], mono.observed["m"])
    assert seg.solver_state is None


def test_zero_span_lane_succeeds_untouched():
    """A lane already at t1 (parked by ensemble_solve_segmented) succeeds at
    once with its state unchanged; its siblings are unaffected."""
    t0 = torch.tensor([0.0, T1, 0.0, 0.0], dtype=torch.float64)
    y = torch.tensor(Y0)
    kw = dict(rtol=1e-4, atol=1e-10, linsolve="lu")
    res = sdirk.solve(_robertson_t, y, t0, T1, {"k": torch.tensor(K3)},
                      **kw)
    ref = sdirk.solve(_robertson_t, y, 0.0, T1, {"k": torch.tensor(K3)},
                      **kw)
    assert res.status.tolist() == [common.SUCCESS] * 4
    assert int(res.n_accepted[1]) == 0 and torch.equal(res.y[1], y[1])
    keep = [0, 2, 3]
    assert torch.equal(res.y[keep], ref.y[keep])


def test_sdirk_options_not_ported_raise():
    # the counters landed (ROADMAP A14): stats runs, a ring without the
    # counter block is refused, and an unknown option is a TypeError
    res = sdirk.solve(_robertson_t, torch.tensor(Y0), 0.0, 1e-3,
                      {"k": torch.tensor(K3)}, stats=True, linsolve="lu")
    assert torch.equal(res.stats["n_accepted"], res.n_accepted.int())
    with pytest.raises(ValueError, match="stats"):
        sdirk.solve(_robertson_t, torch.tensor(Y0), 0.0, 1.0,
                    {"k": torch.tensor(K3)}, timeline=4)
    with pytest.raises(TypeError):
        sdirk.solve(_robertson_t, torch.tensor(Y0), 0.0, 1.0,
                    {"k": torch.tensor(K3)}, step_audit=True)
    with pytest.raises(ValueError, match="jac_window"):
        sdirk.solve(_robertson_t, torch.tensor(Y0), 0.0, 1.0,
                    {"k": torch.tensor(K3)}, jac_window=0)


H2O2_T = [1200.0, 1300.0, 1400.0, 1500.0]
H2O2_COMP = {"H2": 0.3, "O2": 0.15, "N2": 0.55}


@pytest.fixture(scope="module")
def h2o2_sdirk(fixtures_dir):
    path = os.path.join(fixtures_dir, "h2o2.dat")
    therm = os.path.join(fixtures_dir, "therm.dat")
    gm_j = br.compile_gaschemistry(path)
    th_j = br.create_thermo(list(gm_j.species), therm)
    gm_t = bt.compile_gaschemistry(path, device="cpu")
    th_t = bt.create_thermo(list(gm_t.species), therm, device="cpu")
    ref = br.batch_reactor_sweep(H2O2_COMP, H2O2_T, 1e5, 5e-4,
                                 chem=br.Chemistry(gaschem=True),
                                 thermo_obj=th_j, md=gm_j, method="sdirk",
                                 ignition_marker="H2")
    kw = dict(chem=bt.Chemistry(gaschem=True), thermo_obj=th_t, md=gm_t,
              method="sdirk", ignition_marker="H2", device="cpu")
    got = bt.batch_reactor_sweep(H2O2_COMP, H2O2_T, 1e5, 5e-4, **kw)
    seg = bt.batch_reactor_sweep(H2O2_COMP, H2O2_T, 1e5, 5e-4,
                                 segment_steps=64, **kw)
    return ref, got, seg


def test_h2o2_sdirk_sweep_matches_jax(h2o2_sdirk):
    ref, got, _ = h2o2_sdirk
    assert got["linsolve"] == "lu" and got["jac_window"] == 1
    np.testing.assert_array_equal(got["status"], ref["status"])
    assert got["report"]["counts"] == {"success": len(H2O2_T)}
    np.testing.assert_allclose(got["tau"], ref["tau"], rtol=10 * RTOL)
    for s, xj in ref["x"].items():
        big = xj > 1e-6
        np.testing.assert_allclose(got["x"][s][big], xj[big],
                                   rtol=10 * RTOL, err_msg=s)
    np.testing.assert_array_equal(got["t"], ref["t"])
    print("accepted (port, jax):", got["report"]["n_accepted"],
          ref["report"]["n_accepted"])


def test_h2o2_sdirk_segmented_sweep_is_bit_exact(h2o2_sdirk):
    _, got, seg = h2o2_sdirk
    np.testing.assert_array_equal(seg["tau"], got["tau"])
    np.testing.assert_array_equal(seg["t"], got["t"])
    for s in got["x"]:
        np.testing.assert_array_equal(seg["x"][s], got["x"][s])
    assert seg["report"]["n_accepted"] == got["report"]["n_accepted"]


def test_h2o2_sdirk_saved_rows_and_fold_match_jax(fixtures_dir):
    """``ensemble_solve(method="sdirk")`` with ``n_save`` and an observer
    on both sides: the saved rows and the fold agree to roundoff."""
    from batchreactor_tpu.ops.rhs import make_gas_jac as jac_j
    from batchreactor_tpu.ops.rhs import make_gas_rhs as rhs_j
    from batchreactor_tpu.parallel import ensemble_solve as solve_j
    from batchreactor_tpu.parallel import ignition_observer as obs_j
    from batchreactor_tpu.parallel import sweep_solution_vectors as y0_j
    from batchreactor_tpu_torch.ops.rhs import make_gas_jac, make_gas_rhs
    from batchreactor_tpu_torch.parallel import (ignition_observer,
                                                 sweep_solution_vectors)

    path = os.path.join(fixtures_dir, "h2o2.dat")
    therm = os.path.join(fixtures_dir, "therm.dat")
    gm_j = br.compile_gaschemistry(path)
    gm_t = bt.compile_gaschemistry(path, device="cpu")
    th_j = br.create_thermo(list(gm_j.species), therm)
    th_t = bt.create_thermo(list(gm_t.species), therm, device="cpu")
    sp = list(gm_t.species)
    x = np.zeros((2, len(sp)))
    for k, v in H2O2_COMP.items():
        x[:, sp.index(k)] = v
    T = np.array([1300.0, 1500.0])
    kw = dict(rtol=RTOL, atol=1e-10, n_save=24, method="sdirk",
              linsolve="lu")
    mk = sp.index("H2")
    ob_j, ob0_j = obs_j(mk, mode="half")
    ref = solve_j(rhs_j(gm_j, th_j), y0_j(jnp.asarray(x), th_j.molwt,
                                         jnp.asarray(T), 1e5),
                  0.0, 1e-4, {"T": jnp.asarray(T)}, jac=jac_j(gm_j, th_j),
                  observer=ob_j, observer_init=ob0_j, **kw)
    ob_t, ob0_t = ignition_observer(mk, mode="half")
    got = ensemble_solve(make_gas_rhs(gm_t, th_t),
                         sweep_solution_vectors(x, th_t.molwt,
                                                torch.tensor(T), 1e5),
                         0.0, 1e-4, {"T": torch.tensor(T)},
                         jac=make_gas_jac(gm_t, th_t), observer=ob_t,
                         observer_init=ob0_t, **kw)
    for name in ("status", "n_accepted", "n_rejected", "n_saved"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    np.testing.assert_allclose(got.ts.numpy(), np.asarray(ref.ts),
                               rtol=1e-12)
    ys = np.asarray(ref.ys)
    np.testing.assert_allclose(got.ys.numpy(), ys, rtol=1e-10,
                               atol=1e-12 * np.abs(ys).max())
    for k in ob0_t:
        np.testing.assert_allclose(got.observed[k].numpy(),
                                   np.asarray(ref.observed[k]), rtol=1e-10,
                                   err_msg=k)


def test_programmatic_sdirk_form_matches_jax(fixtures_dir):
    path = os.path.join(fixtures_dir, "h2o2.dat")
    therm = os.path.join(fixtures_dir, "therm.dat")
    gm_j = br.compile_gaschemistry(path)
    gm_t = bt.compile_gaschemistry(path, device="cpu")
    th_j = br.create_thermo(list(gm_j.species), therm)
    th_t = bt.create_thermo(list(gm_t.species), therm, device="cpu")
    comp = {"H2": 0.3, "O2": 0.15, "N2": 0.55}
    ts_j, x_j = br.batch_reactor(comp, 1300.0, 1e5, 2e-4,
                                 chem=br.Chemistry(gaschem=True),
                                 thermo_obj=th_j, md=gm_j, method="sdirk")
    ts_t, x_t = bt.batch_reactor(comp, 1300.0, 1e5, 2e-4,
                                 chem=bt.Chemistry(gaschem=True),
                                 thermo_obj=th_t, md=gm_t, method="sdirk",
                                 device="cpu")
    for s, v in x_j.items():
        if v > 1e-6:
            assert x_t[s] == pytest.approx(v, rel=10 * RTOL), s
    print("accepted times (port, jax):", len(ts_t), len(ts_j))
