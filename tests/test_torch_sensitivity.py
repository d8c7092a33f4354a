"""Port parity: parameter sensitivities (batchreactor_tpu_torch
sensitivity/, the BDF ``tangent=`` hook, ``parallel.ensemble_solve_forward``,
the energy gradient passes and the ``sens=`` forms of ``batch_reactor``)
against the JAX package on the same inputs.

Tolerances: theta selections, splices and names equal; the analytic decay
oracle to 1e-7 (tangent, adjoint QoI) and 1e-6 (adjoint gradient);
forward tangents against the JAX package's within 10 rtol of each lane's
largest |S| with equal step counts; adjoint QoIs and gradients within
10 rtol (gradients scaled by the largest); forward against central finite
differences at rtol 1e-8 within 1.5e-3 (the JAX package's own tier).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import batchreactor_tpu as br
import batchreactor_tpu_torch as bt
from batchreactor_tpu.energy import eqns as eqns_j
from batchreactor_tpu.energy import ignition as ignition_j
from batchreactor_tpu.ops.rhs import make_gas_jac as make_gas_jac_j
from batchreactor_tpu.ops.rhs import make_gas_rhs as make_gas_rhs_j
from batchreactor_tpu.parallel import sweep as sweep_j
from batchreactor_tpu.sensitivity import adjoint as adjoint_j
from batchreactor_tpu.sensitivity import params as params_j
from batchreactor_tpu.sensitivity import rank as rank_j
from batchreactor_tpu_torch.energy import eqns, ignition
from batchreactor_tpu_torch.ops.rhs import make_gas_jac, make_gas_rhs
from batchreactor_tpu_torch.parallel import ensemble_solve_forward
from batchreactor_tpu_torch.parallel.grid import sweep_solution_vectors
from batchreactor_tpu_torch.sensitivity import adjoint, forward, params, rank
from batchreactor_tpu_torch.solver import bdf
from batchreactor_tpu_torch.solver.common import SUCCESS

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures")
XML = os.path.join(FIX, "batch_h2o2.xml")
COMP = {"H2": 0.3, "O2": 0.2, "N2": 0.5}


@pytest.fixture(scope="module")
def h2o2():
    gm_j = br.compile_gaschemistry(os.path.join(FIX, "h2o2.dat"))
    th_j = br.create_thermo(list(gm_j.species),
                            os.path.join(FIX, "therm.dat"))
    gm = bt.compile_gaschemistry(os.path.join(FIX, "h2o2.dat"),
                                 device="cpu")
    th = bt.create_thermo(list(gm.species), os.path.join(FIX, "therm.dat"),
                          device="cpu")
    return gm_j, th_j, gm, th


def _lanes(gm, th, T):
    idx = {s: k for k, s in enumerate(gm.species)}
    X = np.zeros((len(T), gm.n_species))
    for k, v in COMP.items():
        X[:, idx[k]] = v
    Tt = torch.tensor(np.asarray(T, dtype=np.float64))
    return sweep_solution_vectors(X, th.molwt, Tt, 1e5), {"T": Tt}


def _thetas(h2o2, reactions=None):
    """(spec, theta, rhs_theta, jac_theta) on both sides."""
    gm_j, th_j, gm, th = h2o2
    out = []
    for P, g, t, mr, mj in ((params_j, gm_j, th_j, make_gas_rhs_j,
                             make_gas_jac_j),
                            (params, gm, th, make_gas_rhs, make_gas_jac)):
        spec = P.select(g, reactions=reactions)
        theta = P.extract(g, spec)
        rhs_theta = P.make_rhs_theta(g, spec, lambda m, t=t, mr=mr: mr(m, t))

        def jac_theta(tt, y, th_, cfg, P=P, g=g, spec=spec, t=t, mj=mj):
            return mj(P.apply(g, th_, spec), t)(tt, y, cfg)

        out.append((spec, theta, rhs_theta, jac_theta))
    return out


# ---------------------------------------------------------------------------
# params: the theta layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mech,kw", [
    ("h2o2.dat", {}), ("h2o2.dat", {"fields": ("log_A", "Ea"),
                                    "reactions": (2, 5)}),
    ("h2o2.dat", {"reactions": "*H2O2*", "fields": ("beta",)}),
    ("grimech.dat", {"reactions": "*CH4*"})])
def test_select_extract_apply_names_equal_jax(mech, kw):
    gm_j = br.compile_gaschemistry(os.path.join(FIX, mech))
    gm = bt.compile_gaschemistry(os.path.join(FIX, mech), device="cpu")
    spec_j, spec = params_j.select(gm_j, **kw), params.select(gm, **kw)
    assert (spec.kind, spec.fields, spec.rxn_idx, spec.equations) == (
        spec_j.kind, spec_j.fields, spec_j.rxn_idx, spec_j.equations)
    assert params.names(spec) == params_j.names(spec_j)
    theta_j, theta = params_j.extract(gm_j, spec_j), params.extract(gm, spec)
    for f in spec.fields:
        np.testing.assert_array_equal(theta[f].numpy(),
                                      np.asarray(theta_j[f]))
    bump = {f: v + 0.1 * (k + 1) for k, (f, v) in enumerate(theta.items())}
    bump_j = {f: jnp.asarray(v.numpy()) for f, v in bump.items()}
    a, b = params_j.apply(gm_j, bump_j, spec_j), params.apply(gm, bump, spec)
    for f in ("log_A", "beta", "Ea"):
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(a, f)))
    flat_j, _ = params_j.flatten(theta_j)
    flat, unflatten = params.flatten(theta)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(flat_j))
    # per-lane rows: lane l of an (L, K) theta is the (K,) splice
    rows = {f: torch.stack([v, v + 0.5]) for f, v in theta.items()}
    c = params.apply(gm, rows, spec)
    f0 = spec.fields[0]
    assert getattr(c, f0).shape == (2, gm.n_reactions)
    np.testing.assert_array_equal(
        getattr(c, f0)[1].numpy(),
        getattr(params.apply(gm, {f: v + 0.5 for f, v in theta.items()},
                             spec), f0).numpy())
    assert torch.equal(unflatten(flat)[spec.fields[0]],
                       theta[spec.fields[0]])


def test_select_errors_equal_jax(h2o2):
    gm_j, _, gm, _ = h2o2
    for kw, exc in (({"reactions": "*XENON*"}, ValueError),
                    ({"fields": ("nu_f",)}, ValueError),
                    ({"fields": ()}, ValueError),
                    ({"reactions": (0, 10_000)}, IndexError)):
        with pytest.raises(exc) as ej:
            params_j.select(gm_j, **kw)
        with pytest.raises(exc) as et:
            params.select(gm, **kw)
        assert str(et.value) == str(ej.value)


def test_apply_is_out_of_place_and_differentiable(h2o2):
    _, _, gm, th = h2o2
    before = gm.log_A.clone()
    spec = params.select(gm, reactions=(1, 2))
    theta = {"log_A": params.extract(gm, spec)["log_A"].clone()
             .requires_grad_(True)}
    y0, cfg = _lanes(gm, th, [1200.0])
    dy = params.make_rhs_theta(gm, spec, lambda m: make_gas_rhs(m, th))(
        0.0, y0, theta, cfg)
    dy.sum().backward()
    assert theta["log_A"].grad is not None
    assert torch.equal(gm.log_A, before)


@pytest.mark.parametrize("kind", ["gas_gri", "surface_ch4ni"])
def test_per_lane_theta_rows_equal_single_lane_splices(kind):
    """(L, K) theta rows give (L, R) parameter tensors that the rate code
    broadcasts lane by lane: rates and Jacobians of each lane equal those
    of that lane's own (K,) splice (GRI-3.0's falloff and reverse rows,
    CH4/Ni's sticking rows)."""
    from batchreactor_tpu_torch.ops.rhs import (make_surface_jac,
                                                make_surface_rhs)

    gm = bt.compile_gaschemistry(os.path.join(FIX, "grimech.dat"),
                                 device="cpu")
    th = bt.create_thermo(list(gm.species), os.path.join(FIX, "therm.dat"),
                          device="cpu")
    rng = np.random.default_rng(5)
    if kind == "gas_gri":
        mech = gm
        fields = ("log_A", "beta", "Ea")

        def build(m):
            return make_gas_rhs(m, th), make_gas_jac(m, th)
    else:
        mech = bt.compile_mech(os.path.join(FIX, "ch4ni.xml"), th,
                               list(gm.species), device="cpu")
        fields = ("log_A", "Ea", "stick_s0")

        def build(m):
            return (make_surface_rhs(m, th, gm=gm),
                    make_surface_jac(m, th, gm=gm))
    spec = params.select(mech, fields=fields)
    theta = params.extract(mech, spec)
    L = 3
    rows = {f: v * torch.tensor(1.0 + 0.05 * rng.standard_normal(
        (L, v.shape[0]))) for f, v in theta.items()}
    y, cfg = _lanes(gm, th, [1200.0, 1400.0, 1600.0])
    if kind != "gas_gri":
        y = torch.cat([y, mech.ini_covg.expand(L, -1)], dim=1)
    cfg["Asv"] = torch.ones(L, dtype=torch.float64)
    rhs, jac = build(params.apply(mech, rows, spec))
    dy, J = rhs(0.0, y, cfg), jac(0.0, y, cfg)
    for b in range(L):
        one = {k: v[b:b + 1] for k, v in cfg.items()}
        rhs_b, jac_b = build(params.apply(
            mech, {f: v[b] for f, v in rows.items()}, spec))
        np.testing.assert_allclose(dy[b].numpy(),
                                   rhs_b(0.0, y[b:b + 1], one)[0].numpy(),
                                   rtol=1e-13, atol=1e-300)
        np.testing.assert_allclose(J[b].numpy(),
                                   jac_b(0.0, y[b:b + 1], one)[0].numpy(),
                                   rtol=1e-12, atol=1e-300)


# ---------------------------------------------------------------------------
# the analytic decay oracle dy/dt = -k y
# ---------------------------------------------------------------------------
def _decay(t, y, theta, cfg):
    return -theta["k"][..., :1] * y


def test_forward_tangents_analytic_decay():
    theta = {"k": torch.tensor([1.3], dtype=torch.float64)}
    y0 = torch.ones((1, 1), dtype=torch.float64)
    r = forward.solve_forward(_decay, y0, 0.0, 1.0, theta, {}, rtol=1e-10,
                              atol=1e-14)
    assert int(r.status[0]) == SUCCESS
    np.testing.assert_allclose(float(r.tangents[0, 0, 0]), -np.exp(-1.3),
                               rtol=1e-7)
    r4 = forward.solve_forward(_decay, y0, 0.0, 1.0, theta, {}, rtol=1e-10,
                               atol=1e-14, jac_window=4)
    np.testing.assert_allclose(r4.tangents.numpy(), r.tangents.numpy(),
                               rtol=1e-6)


def test_adjoint_analytic_decay_and_nan_when_never_crossed():
    theta = {"k": torch.tensor([1.3], dtype=torch.float64)}
    y0 = torch.ones((1, 1), dtype=torch.float64)
    qoi, grad, aux = adjoint.solve_adjoint(
        _decay, adjoint.final_species_qoi(0), y0, 0.0, 1.0, theta, {},
        rtol=1e-9, atol=1e-13, grid_size=64, segments=4)
    assert int(aux["status"][0]) == SUCCESS
    np.testing.assert_allclose(float(qoi[0]), np.exp(-1.3), rtol=1e-7)
    np.testing.assert_allclose(float(grad["k"][0]), -np.exp(-1.3),
                               rtol=1e-6)
    # y never drops below half by t = 1e-3: NaN tau and a zero gradient
    qoi2, grad2, _ = adjoint.solve_adjoint(
        _decay, adjoint.ignition_delay_qoi(0), y0, 0.0, 1e-3, theta, {},
        rtol=1e-6, atol=1e-10, grid_size=32, segments=4)
    assert np.isnan(float(qoi2[0]))
    np.testing.assert_array_equal(grad2["k"].numpy(), np.zeros(1))


# ---------------------------------------------------------------------------
# forward tangents against the JAX package
# ---------------------------------------------------------------------------
def test_forward_sweep_8_lanes_matches_jax(h2o2):
    gm_j, th_j, gm, th = h2o2
    (spec_j, theta_j, rt_j, jt_j), (spec, theta, rt, jt) = _thetas(h2o2)
    T = np.linspace(1050.0, 1400.0, 8)
    y0, cfg = _lanes(gm, th, T)
    rtol = 1e-6
    ref = sweep_j.ensemble_solve_forward(
        rt_j, jnp.asarray(y0.numpy()), 0.0, 5e-5, theta_j,
        {"T": jnp.asarray(T)}, rtol=rtol, atol=1e-10,
        jac=lambda t, y, cfg: jt_j(t, y, theta_j, cfg), linsolve="lu")
    got = ensemble_solve_forward(
        rt, y0, 0.0, 5e-5, theta, cfg, rtol=rtol, atol=1e-10,
        jac=lambda t, y, c: jt(t, y, theta, c))
    np.testing.assert_array_equal(got.n_accepted.numpy(),
                                  np.asarray(ref.n_accepted))
    np.testing.assert_array_equal(got.n_rejected.numpy(),
                                  np.asarray(ref.n_rejected))
    S, S_j = got.tangents.numpy(), np.asarray(ref.tangents)
    assert S.shape == (8, spec.n_params, gm.n_species)
    scale = np.abs(S_j).max(axis=(1, 2), keepdims=True)
    assert np.abs(S - S_j).max() / 1.0 <= (10 * rtol * scale).min()
    np.testing.assert_allclose(got.y.numpy(), np.asarray(ref.y),
                               rtol=1e-12, atol=1e-20)
    # the tangents leave the state's grid as the plain solve takes it
    plain = bdf.solve(lambda t, y, c: rt(t, y, theta, c), y0, 0.0, 5e-5,
                      cfg, rtol=rtol, atol=1e-10,
                      jac=lambda t, y, c: jt(t, y, theta, c), linsolve="lu")
    assert torch.equal(plain.n_accepted, got.n_accepted)
    assert torch.equal(plain.y, got.y)


def test_forward_matches_central_fd(h2o2):
    gm_j, th_j, gm, th = h2o2
    _, (spec, theta, rt, jt) = _thetas(h2o2, reactions=(1, 2, 4))
    y0, cfg = _lanes(gm, th, [1100.0])
    t1 = 3e-5

    def final_at(th_flat):
        th_ = {"log_A": th_flat}
        return bdf.solve(lambda t, y, c: rt(t, y, th_, c), y0, 0.0, t1, cfg,
                         rtol=1e-10, atol=1e-14,
                         jac=lambda t, y, c: jt(t, y, th_, c)).y[0]

    base, eps = theta["log_A"], 1e-4
    fd = np.stack([
        (final_at(base + eps * torch.eye(3, dtype=torch.float64)[i])
         - final_at(base - eps * torch.eye(3, dtype=torch.float64)[i]))
        .numpy() / (2 * eps) for i in range(3)])
    r = forward.solve_forward(rt, y0, 0.0, t1, theta, cfg, rtol=1e-8,
                              atol=1e-12,
                              jac=lambda t, y, c: jt(t, y, theta, c))
    assert int(r.status[0]) == SUCCESS
    scale = np.max(np.abs(fd), axis=1, keepdims=True)
    np.testing.assert_allclose(r.tangents[0].numpy() / scale, fd / scale,
                               atol=1.5e-3)


# ---------------------------------------------------------------------------
# the energy gradient passes
# ---------------------------------------------------------------------------
def test_delay_sensitivity_forward_and_temperature_qoi_match_jax(h2o2):
    gm_j, th_j, gm, th = h2o2
    spec = params.select(gm, reactions=(0, 1, 2))
    spec_j = params_j.select(gm_j, reactions=(0, 1, 2))
    theta, theta_j = params.extract(gm, spec), params_j.extract(gm_j, spec_j)
    rt = params.make_rhs_theta(
        gm, spec, lambda m: eqns.make_energy_rhs(m, th, "adiabatic_v"))
    rt_j = params_j.make_rhs_theta(
        gm_j, spec_j,
        lambda m: eqns_j.make_energy_rhs(m, th_j, "adiabatic_v"))

    def jt(t, y, th_, cfg):
        return eqns.make_energy_jac(params.apply(gm, th_, spec), th,
                                    "adiabatic_v")(t, y, cfg)

    def jt_j(t, y, th_, cfg):
        return eqns_j.make_energy_jac(params_j.apply(gm_j, th_, spec_j),
                                      th_j, "adiabatic_v")(t, y, cfg)

    # a hot lane and a loose tolerance keep the solve short on the CPU
    T0, t_max, rtol, atol = 1600.0, 3e-5, 1e-4, 1e-8
    y0, _ = _lanes(gm, th, [T0])
    ye = eqns.extend_states(y0, torch.tensor([T0]))
    n = ye.shape[1]
    cfg = eqns.energy_cfg({"T": torch.tensor([T0])}, "adiabatic_v", 1, n,
                          atol, device="cpu")
    cfg_j = eqns_j.energy_cfg({"T": jnp.asarray(T0)}, "adiabatic_v", 1, n,
                              atol)
    cfg_j = {k: (v[0] if np.ndim(v) == 2 else v) for k, v in cfg_j.items()}
    tau, grad, aux = ignition.delay_sensitivity_forward(
        rt, ye, theta, cfg, n - 1, t_max=t_max, jac=jt, rtol=rtol,
        atol=atol)
    tau_j, grad_j, aux_j = ignition_j.delay_sensitivity_forward(
        rt_j, jnp.asarray(ye[0].numpy()), theta_j, cfg_j, n - 1,
        t_max=t_max, jac=jt_j, rtol=rtol, atol=atol)
    assert int(aux["n_accepted"][0]) == aux_j["n_accepted"]
    assert bool(aux["ignited"][0])
    np.testing.assert_allclose(float(tau[0]), tau_j, rtol=1e-8)
    gj = np.asarray(grad_j["log_A"])
    assert np.abs(grad["log_A"][0].numpy() - gj).max() <= 1e-6 * np.abs(
        gj).max()
    # the temperature-threshold adjoint QoI on a fixed series
    tk = torch.linspace(0.0, 1.0, 11, dtype=torch.float64)[None]
    ys = torch.zeros((1, 11, n), dtype=torch.float64)
    ys[0, :, -1] = T0 + 1000.0 * tk[0] ** 2
    q = ignition.temperature_ignition_qoi(n - 1)(tk, ys, ys[:, -1])
    q_j = ignition_j.temperature_ignition_qoi(n - 1)(
        jnp.asarray(tk[0].numpy()), jnp.asarray(ys[0].numpy()), None)
    np.testing.assert_allclose(float(q[0]), float(q_j), rtol=1e-14)


# ---------------------------------------------------------------------------
# rank and the API's sens= forms
# ---------------------------------------------------------------------------
def test_top_k_and_format_ranking_identical():
    rng = np.random.default_rng(3)
    coeffs = rng.standard_normal(12)
    eqs = tuple(f"R{i}+X=Y" for i in range(12))
    for k in (0, 3, 12, 20):
        assert rank.top_k(coeffs, eqs, k) == rank_j.top_k(coeffs, eqs, k)
    r = rank.top_k(torch.tensor(coeffs), eqs, 5)
    assert r == rank_j.top_k(coeffs, eqs, 5)
    assert rank.format_ranking(r, "tau") == rank_j.format_ranking(r, "tau")
    assert rank.format_ranking([]) == rank_j.format_ranking([])
    np.testing.assert_array_equal(
        rank.normalized_sensitivities(torch.tensor([2.0, 4.0]),
                                      torch.tensor(coeffs[:8].reshape(2, 4))),
        rank_j.normalized_sensitivities(np.array([2.0, 4.0]),
                                        coeffs[:8].reshape(2, 4)))
    with pytest.raises(ValueError, match="aggregate"):
        rank.top_k(coeffs.reshape(3, 4), eqs)


@pytest.mark.parametrize("kw", [
    {"sens": "forward", "sens_qoi": "H2O"},
    {"sens": "forward", "sens_params": {"reactions": (1, 2)},
     "rtol": 1e-8, "atol": 1e-12}], ids=["forward", "forward_selection"])
def test_batch_reactor_sens_matches_jax(kw):
    a = br.batch_reactor(XML, FIX, gaschem=True, verbose=False, **kw)
    b = bt.batch_reactor(XML, FIX, gaschem=True, verbose=False,
                         device="cpu", **kw)
    assert isinstance(b, bt.SensitivitySolution)
    assert (b.status, b.species, b.names, b.n_accepted, b.truncated) == (
        a.status, a.species, a.names, a.n_accepted, a.truncated)
    rtol = kw.get("rtol", 1e-6)
    np.testing.assert_allclose(b.y, np.asarray(a.y), rtol=10 * rtol,
                               atol=1e-20)
    if a.tangents is not None:
        Sa = np.asarray(a.tangents)
        assert np.abs(b.tangents - Sa).max() <= 10 * rtol * np.abs(Sa).max()
    if a.qoi is not None:
        np.testing.assert_allclose(b.qoi, a.qoi, rtol=10 * rtol)
        ga = np.asarray(a.qoi_grad["log_A"])
        assert (np.abs(b.qoi_grad["log_A"] - ga).max()
                <= 10 * rtol * np.abs(ga).max())


def test_batch_reactor_sens_hook_matches_jax():
    a = br.batch_reactor(XML, FIX, gaschem=True, sens=True)
    b = bt.batch_reactor(XML, FIX, gaschem=True, sens=True, device="cpu")
    assert isinstance(b, bt.SensitivityProblem)
    assert (b.t_span, b.species, b.surface_species) == (
        a.t_span, a.species, a.surface_species)
    assert (b.spec.kind, b.spec.fields, b.spec.rxn_idx,
            b.spec.equations) == (a.spec.kind, a.spec.fields,
                                  a.spec.rxn_idx, a.spec.equations)
    np.testing.assert_array_equal(b.theta["log_A"].numpy(),
                                  np.asarray(a.theta["log_A"]))
    np.testing.assert_allclose(b.y0.numpy(), np.asarray(a.y0), rtol=1e-14)
    dy = b.rhs(0.0, b.y0[None], b.cfg)[0]
    dy_j = a.rhs(0.0, a.y0, a.cfg)
    np.testing.assert_allclose(dy.numpy(), np.asarray(dy_j), rtol=1e-12,
                               atol=1e-300)
    # the hook's closure is differentiable with torch.func
    J = torch.func.jacfwd(lambda y: b.rhs(0.0, y[None], b.cfg)[0])(b.y0)
    J_j = jax.jacfwd(lambda y: a.rhs(0.0, y, a.cfg))(a.y0)
    np.testing.assert_allclose(J.numpy(), np.asarray(J_j), rtol=1e-10,
                               atol=1e-8 * float(np.abs(J_j).max()))


def test_sens_validation_errors_equal_jax(fixtures_dir):
    cases = [dict(sens="backward"),
             dict(sens="forward", sens_qoi=("ignition", "H2")),
             dict(sens="adjoint"),
             dict(sens="forward", method="sdirk"),
             dict(sens="forward", segmented=True),
             dict(sens="forward", sens_qoi=("bogus",)),
             dict(sens="forward", sens_params={"reactions": "*XENON*"})]
    for kw in cases:
        with pytest.raises(ValueError) as ej:
            br.batch_reactor(XML, FIX, gaschem=True, verbose=False, **kw)
        with pytest.raises(ValueError) as et:
            bt.batch_reactor(XML, FIX, gaschem=True, verbose=False,
                             device="cpu", **kw)
        assert str(et.value) == str(ej.value), kw
    with pytest.raises(KeyError) as ej:
        br.batch_reactor(XML, FIX, gaschem=True, sens="forward",
                         sens_qoi="XE")
    with pytest.raises(KeyError) as et:
        bt.batch_reactor(XML, FIX, gaschem=True, sens="forward",
                         sens_qoi="XE", device="cpu")
    assert str(et.value) == str(ej.value)
    gm = bt.compile_gaschemistry(os.path.join(FIX, "h2o2.dat"),
                                 device="cpu")
    th = bt.create_thermo(list(gm.species), os.path.join(FIX, "therm.dat"),
                          device="cpu")
    with pytest.raises(ValueError, match="file-driven"):
        bt.batch_reactor(COMP, 1100.0, 1e5, 1e-5,
                         chem=bt.Chemistry(gaschem=True), thermo_obj=th,
                         md=gm, sens=True, device="cpu")


def _ranked_rows(text):
    return [ln for ln in text.splitlines()
            if ln.strip() and ln.split()[0].isdigit()]


def test_sens_rank_tool_matches_jax_script():
    args = [XML, FIX, "--qoi", "H2O", "--mode", "forward", "--reactions",
            "*H2O2*", "-k", "3"]
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    ref = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "sens_rank.py"),
         *args], capture_output=True, text=True, timeout=280, env=env)
    got = subprocess.run(
        [sys.executable, "-m", "batchreactor_tpu_torch.tools.sens_rank",
         *args, "--device", "cpu"], capture_output=True, text=True,
        timeout=280, env=env, cwd=REPO)
    assert ref.returncode == 0, ref.stderr
    assert got.returncode == 0, got.stderr
    rows, rows_j = _ranked_rows(got.stdout), _ranked_rows(ref.stdout)
    assert len(rows) == 3
    assert got.stdout.splitlines()[1] == ref.stdout.splitlines()[1]
    for r, rj in zip(rows, rows_j):
        assert r.split()[:-1] == rj.split()[:-1]
        np.testing.assert_allclose(float(r.split()[-1]),
                                   float(rj.split()[-1]), rtol=1e-5)
