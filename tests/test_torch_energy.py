"""Port parity: adiabatic chemistry (batchreactor_tpu_torch energy/) against
the JAX package's ``energy/``, on the CPU.

The energy RHS and its analytic Jacobian agree with the JAX package's to
roundoff (1e-12 of each row's largest entry) in both modes, on h2o2 and
GRI-3.0; the port's
analytic Jacobian also agrees with ``torch.func.jacfwd`` of its own RHS.
The adiabatic h2o2 sweep of ``tests/test_energy.py``'s ``adiabatic_mono``
fixture agrees with the JAX package's at the rtol scale (final T, ignition
delay, mole fractions at 10 rtol; step counts reported), and the port's
segmented sweep equals its monolithic ``ensemble_solve`` bit for bit at
``jac_window=1``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import batchreactor_tpu as br
import batchreactor_tpu_torch as bt
from batchreactor_tpu.energy import eqns as eqns_j
from batchreactor_tpu.energy import ignition as ign_j
from batchreactor_tpu.solver.sdirk import _scaled_norm
from batchreactor_tpu_torch.energy import eqns, ignition
from batchreactor_tpu_torch.parallel import (ensemble_solve,
                                             sweep_solution_vectors)
from batchreactor_tpu_torch.solver.common import (ATOL_SCALE_KEY,
                                                  jacfwd_lanes, scaled_norm)

torch.set_num_threads(1)

RTOL = 1e-6
X_MIX = {"H2": 0.3, "O2": 0.2, "N2": 0.5}
T_MONO = np.linspace(1050.0, 1250.0, 5)
T1_MONO = 2e-4


def _mechs(fixtures_dir, name):
    path = os.path.join(fixtures_dir, name)
    therm = os.path.join(fixtures_dir, "therm.dat")
    gm_j = br.compile_gaschemistry(path)
    gm_t = bt.compile_gaschemistry(path, device="cpu")
    return (gm_j, br.create_thermo(list(gm_j.species), therm),
            gm_t, bt.create_thermo(list(gm_t.species), therm, device="cpu"))


@pytest.fixture(scope="module")
def h2o2(fixtures_dir):
    return _mechs(fixtures_dir, "h2o2.dat")


@pytest.fixture(scope="module")
def gri(fixtures_dir):
    return _mechs(fixtures_dir, "grimech.dat")


def _states(n_species, seed):
    """Three lanes of random positive partial densities at 1000, 1500 and
    2100 K, with the T row appended."""
    rng = np.random.default_rng(seed)
    y = np.abs(rng.standard_normal((3, n_species))) * 0.02 + 1e-6
    return np.concatenate([y, np.array([[1000.0], [1500.0], [2100.0]])], 1)


def _rel(got, want):
    """Largest |got - want| over the largest |want| of its row (a row of
    zeros, an inert species', must match exactly)."""
    scale = np.abs(want).max(axis=-1, keepdims=True)
    return float(np.max(np.abs(got - want) / np.maximum(scale, 1e-300)))


@pytest.mark.parametrize("mech", ["h2o2", "gri"])
@pytest.mark.parametrize("mode", eqns.ENERGY_MODES)
def test_energy_rhs_and_jacobian_match_jax(mech, mode, request):
    gm_j, th_j, gm_t, th_t = request.getfixturevalue(mech)
    ye = _states(len(gm_t.species), seed=7)
    rhs_j = eqns_j.make_energy_rhs(gm_j, th_j, mode)
    jac_j = eqns_j.make_energy_jac(gm_j, th_j, mode)
    f_j = np.asarray(jax.vmap(lambda y: rhs_j(0.0, y, {}))(jnp.asarray(ye)))
    J_j = np.asarray(jax.vmap(lambda y: jac_j(0.0, y, {}))(jnp.asarray(ye)))
    t = torch.zeros(3, dtype=torch.float64)
    f_t = eqns.make_energy_rhs(gm_t, th_t, mode)(t, torch.tensor(ye), {})
    J_t = eqns.make_energy_jac(gm_t, th_t, mode)(t, torch.tensor(ye), {})
    assert _rel(f_t.numpy(), f_j) < 1e-12
    assert _rel(J_t.numpy(), J_j) < 1e-12


@pytest.mark.parametrize("mech", ["h2o2", "gri"])
@pytest.mark.parametrize("mode", eqns.ENERGY_MODES)
def test_energy_jacobian_matches_jacfwd_of_port_rhs(mech, mode, request):
    _, _, gm_t, th_t = request.getfixturevalue(mech)
    y = torch.tensor(_states(len(gm_t.species), seed=8))
    t = torch.zeros(3, dtype=torch.float64)
    J = eqns.make_energy_jac(gm_t, th_t, mode)(t, y, {})
    J_fwd = jacfwd_lanes(eqns.make_energy_rhs(gm_t, th_t, mode))(t, y, {})
    assert _rel(J.numpy(), J_fwd.numpy()) < 1e-12


def test_mode_none_is_the_isothermal_gas_path(h2o2):
    _, _, gm_t, th_t = h2o2
    y = torch.tensor(_states(len(gm_t.species), seed=9))[:, :-1]
    cfg = {"T": torch.tensor([1000.0, 1500.0, 2100.0], dtype=torch.float64)}
    t = torch.zeros(3, dtype=torch.float64)
    iso_rhs = bt.api.make_gas_rhs(gm_t, th_t)(t, y, cfg)
    iso_jac = bt.api.make_gas_jac(gm_t, th_t)(t, y, cfg)
    assert torch.equal(eqns.make_energy_rhs(gm_t, th_t, None)(t, y, cfg),
                       iso_rhs)
    assert torch.equal(eqns.make_energy_jac(gm_t, th_t, None)(t, y, cfg),
                       iso_jac)


def test_resolve_energy_grammar():
    assert eqns.ENERGY_MODES == eqns_j.ENERGY_MODES
    assert eqns.DEFAULT_ATOL_T == eqns_j.DEFAULT_ATOL_T
    assert ignition.DEFAULT_DT_THRESHOLD == ign_j.DEFAULT_DT_THRESHOLD
    assert ignition.DEFAULT_DT_MIN == ign_j.DEFAULT_DT_MIN
    for ok in (None, False) + eqns.ENERGY_MODES:
        assert eqns.resolve_energy(ok) == eqns_j.resolve_energy(ok)
    for bad in ("isothermal", "adiabatic", True):
        with pytest.raises(ValueError) as port_err:
            eqns.resolve_energy(bad)
        with pytest.raises(ValueError) as jax_err:
            eqns_j.resolve_energy(bad)
        assert str(port_err.value) == str(jax_err.value)
        assert "'adiabatic_v'" in str(port_err.value)
        assert "'adiabatic_p'" in str(port_err.value)


def test_atol_T_and_energy_mode_errors(h2o2):
    _, _, gm_t, th_t = h2o2
    kw = dict(chem=bt.Chemistry(gaschem=True), thermo_obj=th_t, md=gm_t,
              device="cpu")
    with pytest.raises(ValueError, match="atol_T"):
        bt.batch_reactor_sweep(X_MIX, 1100.0, 1e5, 1e-5, atol_T=1e-3, **kw)
    with pytest.raises(ValueError, match="adiabatic_v"):
        bt.batch_reactor_sweep(X_MIX, 1100.0, 1e5, 1e-5, energy="bogus",
                               **kw)
    with pytest.raises(ValueError, match="gas chemistry only"):
        bt.batch_reactor_sweep(
            {"H2": 1.0}, 1100.0, 1e5, 1e-5, thermo_obj=th_t,
            chem=bt.Chemistry(userchem=True, udf=lambda t, s: 0.0),
            energy="adiabatic_v", device="cpu")
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError, match="atol_T must be positive"):
            eqns.energy_atol_scale(2, 4, 1e-10, atol_T=bad, device="cpu")
        with pytest.raises(ValueError, match="atol_T must be positive"):
            eqns_j.energy_atol_scale(2, 4, 1e-10, atol_T=bad)


def test_atol_scale_operand_matches_jax():
    got = eqns.energy_atol_scale(3, 5, 1e-10, atol_T=2e-4, device="cpu")
    want = np.asarray(eqns_j.energy_atol_scale(3, 5, 1e-10, atol_T=2e-4))
    np.testing.assert_array_equal(got.numpy(), want)
    cfg = {"T": torch.ones(3, dtype=torch.float64)}
    assert eqns.energy_cfg(cfg, None, 3, 5, 1e-10) is cfg
    ext = eqns.energy_cfg(cfg, "adiabatic_p", 3, 5, 1e-10, device="cpu")
    assert sorted(ext) == ["T", ATOL_SCALE_KEY] and ext is not cfg
    assert torch.equal(ext[ATOL_SCALE_KEY][:, -1],
                       torch.full((3,), 1e6, dtype=torch.float64))


def test_atol_scale_norm_weighting():
    """The weight enters the scaled norm as atol * w, as in the JAX
    package; without it the norm is the plain-atol formula bit for bit."""
    rng = np.random.default_rng(3)
    e = rng.standard_normal((4, 6)) * 1e-8
    y = rng.standard_normal((4, 6))
    w = np.ones((4, 6))
    w[:, -1] = 1e6
    got = scaled_norm(torch.tensor(e), torch.tensor(y), RTOL, 1e-10,
                      torch.tensor(w)).numpy()
    want = np.asarray(jax.vmap(
        lambda e1, y1, w1: _scaled_norm(e1, y1, RTOL, 1e-10, None, w1))(
        jnp.asarray(e), jnp.asarray(y), jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=1e-14)
    plain = scaled_norm(torch.tensor(e), torch.tensor(y), RTOL, 1e-10)
    by_hand = torch.sqrt(torch.mean(torch.square(
        torch.tensor(e) / (1e-10 + RTOL * torch.abs(torch.tensor(y)))),
        dim=-1))
    assert torch.equal(plain, by_hand)


def test_isothermal_sweep_unchanged_by_energy_none(h2o2):
    _, _, gm_t, th_t = h2o2
    kw = dict(chem=bt.Chemistry(gaschem=True), thermo_obj=th_t, md=gm_t,
              ignition_marker="H2", device="cpu")
    T = [1100.0, 1300.0]
    plain = bt.batch_reactor_sweep(X_MIX, T, 1e5, 2e-5, **kw)
    knob = bt.batch_reactor_sweep(X_MIX, T, 1e5, 2e-5, energy=None, **kw)
    assert "T" not in knob and "ignition_delay" not in knob
    assert sorted(knob) == sorted(plain)
    for key in ("t", "status", "tau"):
        np.testing.assert_array_equal(knob[key], plain[key])
    for s in plain["x"]:
        np.testing.assert_array_equal(knob["x"][s], plain["x"][s])


@pytest.fixture(scope="module")
def adiabatic_mono(h2o2):
    """The JAX package's adiabatic_mono sweep and the port's, both on the
    CPU reference configuration."""
    gm_j, th_j, gm_t, th_t = h2o2
    ref = br.batch_reactor_sweep(X_MIX, T_MONO, 1e5, T1_MONO,
                                 chem=br.Chemistry(gaschem=True),
                                 thermo_obj=th_j, md=gm_j,
                                 energy="adiabatic_v")
    got = bt.batch_reactor_sweep(X_MIX, T_MONO, 1e5, T1_MONO,
                                 chem=bt.Chemistry(gaschem=True),
                                 thermo_obj=th_t, md=gm_t,
                                 energy="adiabatic_v", device="cpu")
    return ref, got


def test_adiabatic_sweep_matches_jax(adiabatic_mono):
    ref, got = adiabatic_mono
    np.testing.assert_array_equal(got["status"], ref["status"])
    assert got["report"]["counts"] == {"success": len(T_MONO)}
    assert got["linsolve"] == "lu" and got["jac_window"] == 1
    np.testing.assert_allclose(got["T"], ref["T"], rtol=10 * RTOL)
    assert np.all(got["T"] > T_MONO + 1500.0)
    assert np.all(np.isfinite(got["ignition_delay"]))
    np.testing.assert_allclose(got["ignition_delay"], ref["ignition_delay"],
                               rtol=10 * RTOL)
    assert np.all(np.diff(got["ignition_delay"]) < 0)
    for s, xj in ref["x"].items():
        big = xj > 1e-6
        np.testing.assert_allclose(got["x"][s][big], xj[big],
                                   rtol=10 * RTOL, err_msg=s)
    np.testing.assert_allclose(sum(got["x"].values()), 1.0, rtol=1e-12)
    print("accepted (port, jax):", got["report"]["n_accepted"],
          ref["report"]["n_accepted"])


def test_adiabatic_segmented_matches_monolithic_bit_exact(h2o2,
                                                          adiabatic_mono):
    """The sweep's segment loop (64 attempts per segment) against one
    monolithic ``ensemble_solve`` of the same lanes at jac_window=1."""
    _, got = adiabatic_mono
    _, _, gm_t, th_t = h2o2
    seg = bt.batch_reactor_sweep(X_MIX, T_MONO, 1e5, T1_MONO,
                                 chem=bt.Chemistry(gaschem=True),
                                 thermo_obj=th_t, md=gm_t,
                                 energy="adiabatic_v", segment_steps=64,
                                 device="cpu")
    sp = list(gm_t.species)
    x = np.zeros(len(sp))
    for k, v in X_MIX.items():
        x[sp.index(k)] = v
    T = torch.tensor(T_MONO)
    y0 = eqns.extend_states(sweep_solution_vectors(
        np.broadcast_to(x, (len(T_MONO), len(sp))), th_t.molwt, T, 1e5), T)
    cfg = eqns.energy_cfg({"T": T}, "adiabatic_v", len(T_MONO),
                          y0.shape[1], 1e-10, device="cpu")
    obs, obs0 = ignition.energy_ignition_observer(len(sp))
    mono = ensemble_solve(
        eqns.make_energy_rhs(gm_t, th_t, "adiabatic_v"), y0, 0.0, T1_MONO,
        cfg, jac=eqns.make_energy_jac(gm_t, th_t, "adiabatic_v"),
        observer=obs, observer_init=obs0, linsolve="lu")
    for out in (seg, got):
        np.testing.assert_array_equal(out["T"], mono.y[:, -1].numpy())
        np.testing.assert_array_equal(out["t"], mono.t.numpy())
        np.testing.assert_array_equal(out["ignition_delay"],
                                      ignition.extract_delay(mono.observed))
        np.testing.assert_array_equal(out["report"]["n_accepted"]["max"],
                                      int(mono.n_accepted.max()))


def test_adiabatic_p_sweep_matches_jax(h2o2):
    gm_j, th_j, gm_t, th_t = h2o2
    T = [1100.0, 1200.0]
    ref = br.batch_reactor_sweep(X_MIX, T, 1e5, T1_MONO,
                                 chem=br.Chemistry(gaschem=True),
                                 thermo_obj=th_j, md=gm_j,
                                 energy="adiabatic_p", atol_T=1e-3)
    got = bt.batch_reactor_sweep(X_MIX, T, 1e5, T1_MONO,
                                 chem=bt.Chemistry(gaschem=True),
                                 thermo_obj=th_t, md=gm_t,
                                 energy="adiabatic_p", atol_T=1e-3,
                                 device="cpu")
    np.testing.assert_array_equal(got["status"], ref["status"])
    np.testing.assert_allclose(got["T"], ref["T"], rtol=10 * RTOL)
    np.testing.assert_allclose(got["ignition_delay"], ref["ignition_delay"],
                               rtol=10 * RTOL)
    print("accepted (port, jax):", got["report"]["n_accepted"],
          ref["report"]["n_accepted"])


def _trajectory(seed, B=4, K=40):
    """Synthetic accepted-step trajectories of a trailing T row: a
    sigmoid runaway per lane with uneven step times."""
    rng = np.random.default_rng(seed)
    ts = np.cumsum(rng.uniform(0.5, 1.5, (B, K)), axis=1) * 1e-5
    tau = rng.uniform(1e-4, 3e-4, B)
    T0 = rng.uniform(1000.0, 1400.0, B)
    T = T0[:, None] + 1500.0 / (1.0 + np.exp(-(ts - tau[:, None]) / 1e-5))
    T[-1] = T0[-1] + 0.1 * np.arange(K)          # a lane that never ignites
    ys = np.concatenate([rng.uniform(0, 1, (B, K, 2)), T[..., None]], -1)
    return ts, ys


def test_energy_observer_fold_matches_jax():
    ts, ys = _trajectory(5)
    obs_t, init_t = ignition.energy_ignition_observer(2)
    obs_j, init_j = ign_j.energy_ignition_observer(2)
    B = ts.shape[0]
    acc_t = {k: torch.full((B,), v, dtype=torch.float64)
             for k, v in init_t.items()}
    acc_j = {k: jnp.full((B,), v) for k, v in init_j.items()}
    step_j = jax.vmap(obs_j)
    for k in range(ts.shape[1]):
        acc_t = obs_t(torch.tensor(ts[:, k]), torch.tensor(ys[:, k]), acc_t)
        acc_j = step_j(jnp.asarray(ts[:, k]), jnp.asarray(ys[:, k]), acc_j)
    assert set(acc_t) == set(acc_j)
    for k in acc_t:
        np.testing.assert_allclose(acc_t[k].numpy(), np.asarray(acc_j[k]),
                                   rtol=1e-14, err_msg=k)
    got, want = ignition.extract_delay(acc_t), ign_j.extract_delay(acc_j)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[-1]) and np.all(np.isfinite(got[:-1]))
    np.testing.assert_allclose(got[:-1], want[:-1], rtol=1e-14)


def test_crossing_rules_match_jax():
    ts, ys = _trajectory(6)
    m = ys[..., -1]
    thr = m[:, 0] + 400.0
    got = ignition.grid_crossing(torch.tensor(ts), torch.tensor(m),
                                 torch.tensor(thr), rising=True).numpy()
    want = np.asarray(jax.vmap(
        lambda t, v, h: ign_j.grid_crossing(t, v, h, rising=True))(
        jnp.asarray(ts), jnp.asarray(m), jnp.asarray(thr)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-14)
    falling = ignition.grid_crossing(torch.tensor(ts[0]),
                                     torch.tensor(-m[0]), -thr[0]).item()
    assert falling == pytest.approx(float(ign_j.grid_crossing(
        jnp.asarray(ts[0]), jnp.asarray(-m[0]), -thr[0])), rel=1e-14)
    a = np.array([0.0, 1.0, 2.0])
    got = ignition.interp_crossing(torch.tensor(a), torch.tensor(a + 1),
                                   torch.tensor([1.0, 5.0, 3.0]),
                                   torch.tensor([3.0, 5.0, 1.0]), 2.0)
    want = ign_j.interp_crossing(jnp.asarray(a), jnp.asarray(a + 1),
                                 jnp.asarray([1.0, 5.0, 3.0]),
                                 jnp.asarray([3.0, 5.0, 1.0]), 2.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_merge_observers_composes_and_rejects_collisions():
    obs, init = ignition.energy_ignition_observer(2)
    with pytest.raises(ValueError, match="collide"):
        ignition.merge_observers(obs, init, obs, init)
    sp_obs, sp_init = bt.parallel.ignition_observer(0, mode="peak")
    merged, merged_init = ignition.merge_observers(obs, init, sp_obs,
                                                   sp_init)
    assert set(merged_init) == set(init) | set(sp_init)
    acc = {k: torch.full((2,), v, dtype=torch.float64)
           for k, v in merged_init.items()}
    y = torch.tensor([[1.0, 0.0, 1100.0], [2.0, 0.0, 1200.0]])
    out = merged(torch.tensor([1e-6, 2e-6]), y, acc)
    assert torch.equal(out["m_max"], y[:, 0])
    assert torch.equal(out["ign_T0"], y[:, 2])


def test_energy_helpers_need_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eqns.energy_atol_scale(2, 4, 1e-10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eqns.energy_cfg({}, "adiabatic_v", 2, 4, 1e-10)
    assert eqns.energy_atol_scale(2, 4, 1e-10,
                                  device="cpu").device.type == "cpu"


def test_auto_linsolve_sees_the_temperature_row(monkeypatch, h2o2):
    """``linsolve="auto"`` resolves on the energy state, n = S + 1: on the
    GPU the adiabatic GRI-3.0 sweep (n = 54) at B = 1024 takes ``lu32p``
    (B n = 55 296 >= LU32P_MIN_BN), and SDIRK takes ``inv32``."""
    from batchreactor_tpu_torch import api
    from batchreactor_tpu_torch.solver.linalg import (LU32P_MIN_BN,
                                                      resolve_linsolve)

    _, _, gm_t, th_t = h2o2
    seen = []

    def spy(linsolve, **kw):
        seen.append((kw["method"], kw["n"], kw["n_surface"]))
        return "lu"

    monkeypatch.setattr(api, "resolve_linsolve", spy)
    for method in ("bdf", "sdirk"):
        bt.batch_reactor_sweep(X_MIX, [1100.0, 1200.0], 1e5, 1e-8,
                               chem=bt.Chemistry(gaschem=True),
                               thermo_obj=th_t, md=gm_t, method=method,
                               energy="adiabatic_v", device="cpu")
    S = len(gm_t.species)
    assert seen == [("bdf", S + 1, 0), ("sdirk", S + 1, 0)]
    assert 1024 * 54 >= LU32P_MIN_BN > 1024 * 10
    assert resolve_linsolve("auto", device="cuda", batch=1024,
                            n=54) == "lu32p"
    assert resolve_linsolve("auto", method="sdirk", device="cuda",
                            batch=1024, n=54) == "inv32"
    assert resolve_linsolve("auto", device="cpu", batch=1024, n=54) == "lu"
