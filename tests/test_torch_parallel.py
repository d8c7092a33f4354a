"""Port parity: the ensemble layer (batchreactor_tpu_torch parallel/) against
the JAX package's ``parallel/``, on the CPU.

The grid helpers (``condition_grid``, ``premixed_mole_fracs``,
``sweep_solution_vectors``) agree with the JAX package's to roundoff;
``ignition_delay`` picks the same saved row; ``temperature_sweep`` and
the monolithic ``ensemble_solve`` (BDF, with ``freeze_precond``) agree at
the rtol scale, and ``ensemble_solve`` equals
``ensemble_solve_segmented`` bit for bit at ``jac_window=1``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import batchreactor_tpu as br
import batchreactor_tpu_torch as bt
from batchreactor_tpu import parallel as par_j
from batchreactor_tpu.ops.rhs import make_gas_jac as jac_j
from batchreactor_tpu.ops.rhs import make_gas_rhs as rhs_j
from batchreactor_tpu_torch import parallel as par
from batchreactor_tpu_torch.ops.rhs import make_gas_jac, make_gas_rhs

torch.set_num_threads(1)

RTOL = 1e-6
H2O2_X = {"H2": 0.3, "O2": 0.15, "N2": 0.55}


@pytest.fixture(scope="module")
def h2o2(fixtures_dir):
    path = os.path.join(fixtures_dir, "h2o2.dat")
    therm = os.path.join(fixtures_dir, "therm.dat")
    gm_j = br.compile_gaschemistry(path)
    gm_t = bt.compile_gaschemistry(path, device="cpu")
    return (gm_j, br.create_thermo(list(gm_j.species), therm),
            gm_t, bt.create_thermo(list(gm_t.species), therm, device="cpu"))


def test_condition_grid_matches_jax():
    axes = dict(phi=[0.5, 0.75, 1.0, 1.5], T=np.linspace(1500, 2000, 5),
                Asv=[10.0])
    got = par.condition_grid(device="cpu", **axes)
    want = par_j.condition_grid(**axes)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["phi"].shape == (20,) and got["T"][1] > got["T"][0]


@pytest.mark.parametrize("case", [
    dict(fuel="CH4", stoich_o2=2.0, diluent="N2", o2_to_diluent=3.76),
    dict(fuel="CH4", stoich_o2=2.0),
    dict(fuel="H2", stoich_o2=0.5, diluent="AR", o2_to_diluent=1.0),
])
def test_premixed_mole_fracs_matches_jax(case, fixtures_dir):
    sp = list(bt.compile_gaschemistry(os.path.join(fixtures_dir,
                                                   "grimech.dat"),
                                      device="cpu").species)
    phi = np.array([0.5, 0.75, 1.0, 1.5])
    got = par.premixed_mole_fracs(sp, phi=phi, device="cpu", **case)
    want = np.asarray(par_j.premixed_mole_fracs(sp, phi=jnp.asarray(phi),
                                                **case))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15, atol=0)
    np.testing.assert_allclose(got.sum(dim=1).numpy(), 1.0, rtol=1e-15)


def test_premixed_mole_fracs_errors_as_jax():
    sp = ["CH4", "O2", "N2"]
    for kw, err in ((dict(fuel="CH4"), ValueError),
                    (dict(fuel="CH4", stoich_o2=2.0, o2_to_diluent=3.76),
                     ValueError),
                    (dict(fuel="C3H8", stoich_o2=5.0), KeyError)):
        with pytest.raises(err) as port_err:
            par.premixed_mole_fracs(sp, phi=[1.0], device="cpu", **kw)
        with pytest.raises(err) as jax_err:
            par_j.premixed_mole_fracs(sp, phi=jnp.asarray([1.0]), **kw)
        assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("covg", [None, [0.6, 0.3, 0.1]])
def test_sweep_solution_vectors_matches_jax(h2o2, covg):
    _, th_j, _, th_t = h2o2
    rng = np.random.default_rng(2)
    x = rng.uniform(0.0, 1.0, (5, len(th_t.species)))
    x /= x.sum(axis=1, keepdims=True)
    T = rng.uniform(1000.0, 2000.0, 5)
    got = par.sweep_solution_vectors(x, th_t.molwt, torch.tensor(T), 1e5,
                                     ini_covg=covg)
    want = par_j.sweep_solution_vectors(jnp.asarray(x), th_j.molwt,
                                        jnp.asarray(T), 1e5,
                                        ini_covg=None if covg is None
                                        else jnp.asarray(covg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14)


@pytest.mark.parametrize("mode", ["peak", "half"])
def test_ignition_delay_matches_jax(mode):
    """Saved trajectories with +inf padding, a lane whose marker never
    halves and a lane with a tie at the peak."""
    rng = np.random.default_rng(4)
    B, K, S = 5, 12, 3
    ts = np.cumsum(rng.uniform(0.5, 1.5, (B, K)), axis=1) * 1e-5
    ys = rng.uniform(0.2, 1.0, (B, K, S))
    ys[:, 0, 1] = 1.0
    ys[1, :, 1] = 0.9                       # never below half, flat peak
    ts[2, 8:] = np.inf                      # padded rows
    ys[2, 8:] = 0.0
    got = par.ignition_delay(torch.tensor(ts), torch.tensor(ys), 1,
                             mode=mode)
    want = par_j.ignition_delay(jnp.asarray(ts), jnp.asarray(ys), 1,
                                mode=mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="ignition-delay mode"):
        par.ignition_delay(torch.tensor(ts), torch.tensor(ys), 1,
                           mode="max")


def test_temperature_sweep_matches_jax(h2o2):
    gm_j, th_j, gm_t, th_t = h2o2
    sp = list(gm_t.species)
    x = np.zeros(len(sp))
    for k, v in H2O2_X.items():
        x[sp.index(k)] = v
    T = np.array([1200.0, 1400.0])
    y0_t = bt.get_solution_vector(x, th_t.molwt, 1300.0, 1e5)
    y0_j = par_j.sweep_solution_vectors(jnp.asarray(x), th_j.molwt,
                                        1300.0, 1e5)[0]
    kw = dict(rtol=RTOL, atol=1e-10, linsolve="lu")
    ref = par_j.temperature_sweep(rhs_j(gm_j, th_j), y0_j, jnp.asarray(T),
                                  1e-4, jac=jac_j(gm_j, th_j), **kw)
    got = par.temperature_sweep(make_gas_rhs(gm_t, th_t), y0_t, T, 1e-4,
                                jac=make_gas_jac(gm_t, th_t), **kw)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    y = np.asarray(ref.y)
    np.testing.assert_allclose(got.y.numpy(), y, rtol=10 * RTOL,
                               atol=10 * RTOL * np.abs(y).max())
    print("accepted (port, jax):", got.n_accepted.tolist(),
          np.asarray(ref.n_accepted).tolist())


def _lanes(h2o2, T):
    _, _, gm_t, th_t = h2o2
    sp = list(gm_t.species)
    x = np.zeros((len(T), len(sp)))
    for k, v in H2O2_X.items():
        x[:, sp.index(k)] = v
    Tt = torch.tensor(T)
    y0 = par.sweep_solution_vectors(x, th_t.molwt, Tt, 1e5)
    return y0, {"T": Tt}, make_gas_rhs(gm_t, th_t), make_gas_jac(gm_t, th_t)


def test_ensemble_solve_equals_segmented_bit_exact(h2o2):
    y0, cfg, rhs, jac = _lanes(h2o2, [1200.0, 1350.0, 1500.0])
    obs, obs0 = par.ignition_observer(0, mode="half")
    kw = dict(rtol=RTOL, atol=1e-10, jac=jac, linsolve="lu",
              observer=obs, observer_init=obs0)
    mono = par.ensemble_solve(rhs, y0, 0.0, 2e-4, cfg, **kw)
    seg = par.ensemble_solve_segmented(rhs, y0, 0.0, 2e-4, cfg,
                                       segment_steps=50, **kw)
    for name in ("y", "t", "status", "n_accepted", "n_rejected"):
        assert torch.equal(getattr(seg, name), getattr(mono, name)), name
    assert torch.equal(seg.observed["tau"], mono.observed["tau"])
    assert mono.err_prev is None and seg.err_prev is None


def test_ensemble_solve_freeze_precond_matches_jax(h2o2):
    """BDF's in-window frozen preconditioner (jac_window=8) on h2o2: the
    same lanes through the JAX package's monolithic ensemble_solve."""
    gm_j, th_j, _, _ = h2o2
    T = [1200.0, 1350.0, 1500.0]
    y0, cfg, rhs, jac = _lanes(h2o2, T)
    kw = dict(rtol=RTOL, atol=1e-10, linsolve="lu", jac_window=8,
              freeze_precond=True)
    ref = par_j.ensemble_solve(rhs_j(gm_j, th_j), jnp.asarray(y0.numpy()),
                               0.0, 2e-4, {"T": jnp.asarray(T)},
                               jac=jac_j(gm_j, th_j), **kw)
    got = par.ensemble_solve(rhs, y0, 0.0, 2e-4, cfg, jac=jac, **kw)
    plain = par.ensemble_solve(rhs, y0, 0.0, 2e-4, cfg, jac=jac,
                               **{**kw, "freeze_precond": False})
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    y = np.asarray(ref.y)
    np.testing.assert_allclose(got.y.numpy(), y, rtol=10 * RTOL,
                               atol=10 * RTOL * np.abs(y).max())
    print("accepted (port, jax, port without freeze):",
          got.n_accepted.tolist(), np.asarray(ref.n_accepted).tolist(),
          plain.n_accepted.tolist())


def test_ensemble_solve_knob_errors(h2o2):
    y0, cfg, rhs, jac = _lanes(h2o2, [1200.0])
    with pytest.raises(ValueError, match="newton_tol is an sdirk-only"):
        par.ensemble_solve(rhs, y0, 0.0, 1e-6, cfg, newton_tol=0.1)
    with pytest.raises(ValueError, match="freeze_precond is a bdf-only"):
        par.ensemble_solve(rhs, y0, 0.0, 1e-6, cfg, method="sdirk",
                           freeze_precond=True)
    with pytest.raises(ValueError, match="setup_economy is a bdf-only"):
        par.ensemble_solve_segmented(rhs, y0, 0.0, 1e-6, cfg,
                                     method="sdirk", setup_economy=True)
    with pytest.raises(ValueError, match="unknown method"):
        par.ensemble_solve(rhs, y0, 0.0, 1e-6, cfg, method="rk45")
    for solve in (par.ensemble_solve, par.ensemble_solve_segmented):
        # mesh= is ported (ROADMAP A12): it takes a parallel.Mesh
        with pytest.raises(TypeError, match="parallel.Mesh"):
            solve(rhs, y0, 0.0, 1e-6, cfg, mesh=object())


def test_grid_helpers_need_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        par.condition_grid(T=[1000.0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        par.premixed_mole_fracs(["CH4", "O2"], "CH4", [1.0], stoich_o2=2.0)
