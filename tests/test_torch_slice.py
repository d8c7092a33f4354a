"""Port parity: the gas slice end to end (batchreactor_tpu_torch api ->
sweep driver -> BDF -> Newton linear algebra -> kinetics) against the JAX
package, on the CPU at h2o2 scale.

Reference configuration: the JAX CPU path (float64, ``linsolve="lu"``,
``jac_window=1``).  Solve observables agree at the rtol scale; step counts
are reported, not asserted.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import batchreactor_tpu as br
import batchreactor_tpu_torch as bt

torch.set_num_threads(1)

RTOL = 1e-6
T_GRID = [1200.0, 1300.0, 1400.0, 1500.0]   # all ignite inside 5e-4 s
COMP = {"H2": 0.3, "O2": 0.15, "N2": 0.55}
T1 = 5e-4


@pytest.fixture(scope="module")
def mechs(fixtures_dir):
    path = os.path.join(fixtures_dir, "h2o2.dat")
    therm = os.path.join(fixtures_dir, "therm.dat")
    gm_j = br.compile_gaschemistry(path)
    gm_t = bt.compile_gaschemistry(path, device="cpu")
    return (gm_j, br.create_thermo(list(gm_j.species), therm),
            gm_t, bt.create_thermo(list(gm_t.species), therm, device="cpu"))


@pytest.fixture(scope="module")
def jax_sweep(mechs):
    gm_j, th_j, _, _ = mechs
    return br.batch_reactor_sweep(
        COMP, T_GRID, 1e5, T1, chem=br.Chemistry(gaschem=True),
        thermo_obj=th_j, md=gm_j, ignition_marker="H2", jac_window=1,
        linsolve="lu")


def _port_sweep(mechs, **kw):
    _, _, gm_t, th_t = mechs
    return bt.batch_reactor_sweep(
        COMP, T_GRID, 1e5, T1, chem=bt.Chemistry(gaschem=True),
        thermo_obj=th_t, md=gm_t, ignition_marker="H2", device="cpu", **kw)


@pytest.fixture(scope="module")
def port_sweep(mechs):
    return _port_sweep(mechs, jac_window=1, linsolve="lu")


def test_sweep_status_and_tau_match_jax(jax_sweep, port_sweep):
    np.testing.assert_array_equal(port_sweep["status"], jax_sweep["status"])
    assert port_sweep["report"]["counts"] == {"success": len(T_GRID)}
    assert np.all(np.isfinite(port_sweep["tau"]))
    np.testing.assert_allclose(port_sweep["tau"], jax_sweep["tau"],
                               rtol=1e-4)
    print("accepted (port, jax):", port_sweep["report"]["n_accepted"],
          jax_sweep["report"]["n_accepted"])


def test_sweep_final_state_matches_jax(jax_sweep, port_sweep):
    for s, xj in jax_sweep["x"].items():
        big = xj > 1e-6
        np.testing.assert_allclose(port_sweep["x"][s][big], xj[big],
                                   rtol=10 * RTOL, err_msg=s)
    np.testing.assert_array_equal(port_sweep["t"], jax_sweep["t"])


def test_economy_lu32p_sweep_tau_close_to_reference(mechs, jax_sweep):
    """The GPU main path's solver configuration (jac_window=8, setup
    economy, float32 ``lu32p`` preconditioner — its plain version here)
    against the exact reference: the f32 preconditioner and the economy
    move tau by quasi-Newton roundoff only."""
    out = _port_sweep(mechs, jac_window=8, setup_economy=True,
                      linsolve="lu32p")
    assert out["report"]["counts"] == {"success": len(T_GRID)}
    np.testing.assert_allclose(out["tau"], jax_sweep["tau"], rtol=1e-3)
    print("accepted jw=8 economy lu32p:", out["report"]["n_accepted"])


@pytest.mark.parametrize("linsolve", ["lu", "lu32p"])
def test_jac_window_economy_matches_jax_same_config(mechs, linsolve):
    """The main path's solver configuration on both sides: the per-lane
    masks of the Newton, jac-window and step loops reproduce the JAX
    package's batched while_loops, so tau stays at roundoff (float64
    ``lu``) or float32 preconditioner roundoff (``lu32p``: the plain
    version against the Pallas kernel in interpret mode)."""
    gm_j, th_j, _, _ = mechs
    kw = dict(jac_window=8, setup_economy=True, linsolve=linsolve)
    ref = br.batch_reactor_sweep(
        COMP, T_GRID, 1e5, T1, chem=br.Chemistry(gaschem=True),
        thermo_obj=th_j, md=gm_j, ignition_marker="H2", **kw)
    out = _port_sweep(mechs, **kw)
    assert out["report"]["counts"] == {"success": len(T_GRID)}
    np.testing.assert_allclose(out["tau"], ref["tau"], rtol=1e-7)
    for s, xj in ref["x"].items():
        big = xj > 1e-6
        np.testing.assert_allclose(out["x"][s][big], xj[big], rtol=10 * RTOL,
                                   err_msg=s)
    print(f"accepted jw=8 economy {linsolve} (port, jax):",
          out["report"]["n_accepted"], ref["report"]["n_accepted"])


def test_segmented_is_bit_exact_with_one_segment(mechs, port_sweep):
    """At jac_window=1 the segment loop (park, resume the BDF history) is
    bit-exact with a single segment, as in the JAX package."""
    seg = _port_sweep(mechs, jac_window=1, linsolve="lu", segment_steps=16)
    np.testing.assert_array_equal(seg["tau"], port_sweep["tau"])
    for s in seg["x"]:
        np.testing.assert_array_equal(seg["x"][s], port_sweep["x"][s])


def test_programmatic_form_matches_jax(mechs):
    gm_j, th_j, gm_t, th_t = mechs
    ts_j, x_j = br.batch_reactor(COMP, 1300.0, 1e5, T1,
                                 chem=br.Chemistry(gaschem=True),
                                 thermo_obj=th_j, md=gm_j, jac_window=1)
    ts_t, x_t = bt.batch_reactor(COMP, 1300.0, 1e5, T1,
                                 chem=bt.Chemistry(gaschem=True),
                                 thermo_obj=th_t, md=gm_t, device="cpu")
    assert ts_t[-1] == pytest.approx(T1, rel=1e-14)
    for s, v in x_j.items():
        if v > 1e-6:
            assert x_t[s] == pytest.approx(v, rel=10 * RTOL), s


def _last_row(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[0].split(","), np.array([float(v) for v in
                                          lines[-1].split(",")])


def test_file_driven_matches_jax(tmp_path, fixtures_dir):
    for sub in ("jax", "port"):
        (tmp_path / sub).mkdir()
        shutil.copy(os.path.join(fixtures_dir, "batch_h2o2.xml"),
                    tmp_path / sub / "batch.xml")
    assert br.batch_reactor(str(tmp_path / "jax" / "batch.xml"), fixtures_dir,
                            gaschem=True, verbose=False) == "Success"
    assert bt.batch_reactor(str(tmp_path / "port" / "batch.xml"),
                            fixtures_dir, gaschem=True, verbose=False,
                            device="cpu") == "Success"
    head_j, row_j = _last_row(tmp_path / "jax" / "gas_profile.csv")
    head_t, row_t = _last_row(tmp_path / "port" / "gas_profile.csv")
    assert head_t == head_j
    assert (tmp_path / "port" / "gas_profile.dat").is_file()
    big = np.abs(row_j) > 1e-6
    np.testing.assert_allclose(row_t[big], row_j[big], rtol=10 * RTOL)


def test_file_driven_equilibrium_oracle(tmp_path, fixtures_dir):
    """Stoichiometric H2 burnout: x_H2O = 2/7, x_O2 = 1/7, x_N2 = 4/7."""
    xml = tmp_path / "batch.xml"
    xml.write_text(
        "<batch><gas_mech>h2o2.dat</gas_mech>"
        "<molefractions>H2=0.25,O2=0.25,N2=0.5</molefractions>"
        "<T>1173.0</T><p>1e5</p><time>10.0</time></batch>")
    assert bt.batch_reactor(str(xml), fixtures_dir, gaschem=True,
                            verbose=False, device="cpu") == "Success"
    head, row = _last_row(tmp_path / "gas_profile.csv")
    x = dict(zip(head, row))
    assert x["t"] == pytest.approx(10.0)
    assert x["H2O"] == pytest.approx(2 / 7, abs=1e-4)
    assert x["O2"] == pytest.approx(1 / 7, abs=1e-4)
    assert x["N2"] == pytest.approx(4 / 7, abs=1e-4)


def _h2o2_lanes(mechs, T):
    _, _, gm_t, th_t = mechs
    from batchreactor_tpu_torch.ops.rhs import make_gas_jac, make_gas_rhs

    sp = list(gm_t.species)
    x = np.zeros(len(sp))
    for k, v in COMP.items():
        x[sp.index(k)] = v
    T = torch.tensor(T, dtype=torch.float64)
    y0 = bt.get_solution_vector(np.broadcast_to(x, (len(T), len(sp))),
                                th_t.molwt, T, 1e5)
    return (make_gas_rhs(gm_t, th_t), make_gas_jac(gm_t, th_t), y0,
            {"T": T})


def test_bdf_jacfwd_fallback_matches_analytic_jacobian(mechs):
    """``jac=None`` differentiates the RHS with torch.func.jacfwd (the JAX
    solver's jax.jacfwd fallback); the closed form agrees to roundoff, so
    the trajectories agree to the rtol scale."""
    from batchreactor_tpu_torch.solver import bdf

    rhs, jac, y0, cfg = _h2o2_lanes(mechs, [1300.0, 1500.0])
    a = bdf.solve(rhs, y0, 0.0, 5e-5, cfg, jac=jac)
    f = bdf.solve(rhs, y0, 0.0, 5e-5, cfg)
    assert torch.equal(a.status, f.status)
    np.testing.assert_allclose(f.y.numpy(), a.y.numpy(), rtol=10 * RTOL,
                               atol=1e-12 * float(a.y.abs().max()))


def test_segment_driver_drain_budget_and_progress(mechs):
    """The n_save drain keeps the first rows in order across segments, the
    attempt budget parks a lane with MAX_STEPS_REACHED, and progress sees
    every segment."""
    from batchreactor_tpu_torch.parallel.sweep import \
        ensemble_solve_segmented
    from batchreactor_tpu_torch.solver.common import (MAX_STEPS_REACHED,
                                                      SUCCESS)

    rhs, jac, y0, cfg = _h2o2_lanes(mechs, [1300.0, 1500.0])
    mono = ensemble_solve_segmented(rhs, y0, 0.0, T1, cfg, jac=jac,
                                    segment_steps=100_000, max_segments=1,
                                    n_save=40)
    seen = []
    seg = ensemble_solve_segmented(rhs, y0, 0.0, T1, cfg, jac=jac,
                                   segment_steps=16, n_save=40,
                                   progress=seen.append)
    np.testing.assert_array_equal(seg.ts.numpy(), mono.ts.numpy())
    np.testing.assert_array_equal(seg.ys.numpy(), mono.ys.numpy())
    assert seg.n_saved.tolist() == [40, 40]
    assert [p["segment"] for p in seen] == list(range(len(seen)))
    assert seen[-1]["lanes_done"] == 2
    assert sum(len(p.get("drained_ts", ())) for p in seen) == 80
    cap = ensemble_solve_segmented(rhs, y0, 0.0, T1, cfg, jac=jac,
                                   segment_steps=16, max_attempts=48)
    assert cap.status.tolist() == [MAX_STEPS_REACHED] * 2
    assert int((cap.n_accepted + cap.n_rejected).max()) == 48
    assert mono.status.tolist() == [SUCCESS] * 2


@pytest.mark.parametrize("mode", ["half", "peak"])
def test_ignition_observer_matches_jax(mode):
    """The lane-batched observer fold equals the JAX fold lane by lane on
    the same accepted-step sequence."""
    import jax
    import jax.numpy as jnp

    from batchreactor_tpu.parallel import ignition_observer as obs_j
    from batchreactor_tpu_torch.parallel.sweep import ignition_observer

    rng = np.random.default_rng(3)
    ts = np.cumsum(rng.uniform(1e-6, 1e-5, (30, 3)), axis=0)
    ys = np.exp(-ts[..., None] * rng.uniform(1e4, 1e5, (1, 3, 1))) * \
        rng.uniform(0.5, 1.0, (30, 3, 2))
    fj, init_j = obs_j(1, mode=mode)
    ft, init_t = ignition_observer(1, mode=mode)
    acc_t = {k: torch.full((3,), v, dtype=torch.float64)
             for k, v in init_t.items()}
    step_j = jax.vmap(fj, in_axes=(0, 0, 0))
    acc_j = {k: jnp.full((3,), v) for k, v in init_j.items()}
    for t, y in zip(ts, ys):
        acc_t = ft(torch.tensor(t), torch.tensor(y), acc_t)
        acc_j = step_j(jnp.asarray(t), jnp.asarray(y), acc_j)
    np.testing.assert_allclose(acc_t["tau"].numpy(), np.asarray(acc_j["tau"]),
                               rtol=1e-15)
