"""Port parity: the adjoint (batchreactor_tpu_torch sensitivity/adjoint.py
and ``batch_reactor(sens="adjoint")``) against the JAX package.

The JAX package solves one lane and maps it over lanes with ``vmap``; the
port runs the lanes as one batch with one theta row per lane, so one
backward pass gives every lane its own gradient.  Tolerances: QoI and the
gradient scaled by its largest entry within 10 rtol of the JAX package's;
the batched lanes against single-lane runs to roundoff (1e-12).  These
are the slow sensitivity tests (a fixed-grid SDIRK4 re-solve, checkpointed
and differentiated), in a file of their own so they run beside the rest.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import batchreactor_tpu as br
import batchreactor_tpu_torch as bt
from batchreactor_tpu.ops.rhs import make_gas_jac as make_gas_jac_j
from batchreactor_tpu.ops.rhs import make_gas_rhs as make_gas_rhs_j
from batchreactor_tpu.sensitivity import adjoint as adjoint_j
from batchreactor_tpu.sensitivity import params as params_j
from batchreactor_tpu_torch.ops.rhs import make_gas_jac, make_gas_rhs
from batchreactor_tpu_torch.parallel.grid import sweep_solution_vectors
from batchreactor_tpu_torch.sensitivity import adjoint, params

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures")
XML = os.path.join(FIX, "batch_h2o2.xml")
COMP = {"H2": 0.3, "O2": 0.2, "N2": 0.5}
RTOL = 1e-6


@pytest.fixture(scope="module")
def h2o2():
    gm_j = br.compile_gaschemistry(os.path.join(FIX, "h2o2.dat"))
    th_j = br.create_thermo(list(gm_j.species),
                            os.path.join(FIX, "therm.dat"))
    gm = bt.compile_gaschemistry(os.path.join(FIX, "h2o2.dat"),
                                 device="cpu")
    th = bt.create_thermo(list(gm.species), os.path.join(FIX, "therm.dat"),
                          device="cpu")
    spec_j, spec = params_j.select(gm_j), params.select(gm)

    def jt_j(t, y, th_, cfg):
        return make_gas_jac_j(params_j.apply(gm_j, th_, spec_j), th_j)(
            t, y, cfg)

    def jt(t, y, th_, cfg):
        return make_gas_jac(params.apply(gm, th_, spec), th)(t, y, cfg)

    return {"jax": (params_j.extract(gm_j, spec_j),
                    params_j.make_rhs_theta(
                        gm_j, spec_j, lambda m: make_gas_rhs_j(m, th_j)),
                    jt_j),
            "port": (params.extract(gm, spec),
                     params.make_rhs_theta(gm, spec,
                                           lambda m: make_gas_rhs(m, th)),
                     jt),
            "gm": gm, "th": th}


def _lanes(gm, th, T):
    idx = {s: k for k, s in enumerate(gm.species)}
    X = np.zeros((len(T), gm.n_species))
    for k, v in COMP.items():
        X[:, idx[k]] = v
    Tt = torch.tensor(np.asarray(T, dtype=np.float64))
    return sweep_solution_vectors(X, th.molwt, Tt, 1e5), {"T": Tt}


@pytest.mark.parametrize("qoi", ["final_H2O", "ignition_H2"])
def test_adjoint_matches_jax(h2o2, qoi):
    theta_j, rt_j, jt_j = h2o2["jax"]
    theta, rt, jt = h2o2["port"]
    gm, th = h2o2["gm"], h2o2["th"]
    sp = list(gm.species)
    # two hot lanes whose H2 falls to half (11 and 4 us) well inside t1
    T = [1500.0, 1900.0]
    t1 = 1.5e-5
    y0, cfg = _lanes(gm, th, T)
    if qoi == "final_H2O":
        q_j = adjoint_j.final_species_qoi(sp.index("H2O"))
        q_t = adjoint.final_species_qoi(sp.index("H2O"))
    else:
        q_j = adjoint_j.ignition_delay_qoi(sp.index("H2"))
        q_t = adjoint.ignition_delay_qoi(sp.index("H2"))
    rows = {k: v.expand(len(T), -1) for k, v in theta.items()}
    q, g, aux = adjoint.solve_adjoint(rt, q_t, y0, 0.0, t1, rows, cfg,
                                      jac_theta=jt, rtol=RTOL,
                                      grid_size=256)
    assert not bool(aux["truncated"].any())
    qj, gj, auxj = jax.vmap(
        lambda y, T_: adjoint_j.solve_adjoint(
            rt_j, q_j, y, 0.0, t1, theta_j, {"T": T_}, jac_theta=jt_j,
            rtol=RTOL, grid_size=256))(jnp.asarray(y0.numpy()),
                                       jnp.asarray(T))
    np.testing.assert_array_equal(aux["n_accepted"].numpy(),
                                  np.asarray(auxj["n_accepted"]))
    assert np.all(np.isfinite(np.asarray(qj)))
    np.testing.assert_allclose(q.numpy(), np.asarray(qj), rtol=10 * RTOL)
    gj = np.asarray(gj["log_A"])
    scale = np.abs(gj).max(axis=1, keepdims=True)
    assert np.all(np.abs(g["log_A"].numpy() - gj) <= 10 * RTOL * scale)


def test_adjoint_per_lane_gradients_equal_single_lane_runs(h2o2):
    theta, rt, jt = h2o2["port"]
    gm, th = h2o2["gm"], h2o2["th"]
    sp = list(gm.species)
    y0, cfg = _lanes(gm, th, [1100.0, 1200.0, 1300.0])
    qoi = adjoint.final_species_qoi(sp.index("H2O"))
    kw = dict(jac_theta=jt, grid_size=64, segments=4)
    rows = {k: v.expand(3, -1) for k, v in theta.items()}
    q, g, _ = adjoint.solve_adjoint(rt, qoi, y0, 0.0, 1e-5, rows, cfg, **kw)
    for b in range(3):
        qb, gb, _ = adjoint.solve_adjoint(
            rt, qoi, y0[b:b + 1], 0.0, 1e-5, theta,
            {"T": cfg["T"][b:b + 1]}, **kw)
        np.testing.assert_allclose(float(q[b]), float(qb[0]), rtol=1e-12)
        np.testing.assert_allclose(g["log_A"][b].numpy(),
                                   gb["log_A"].numpy(), rtol=1e-12,
                                   atol=1e-12 * float(gb["log_A"].abs()
                                                      .max()))
    # a shared theta sums the lanes' gradients
    _, gs, _ = adjoint.solve_adjoint(rt, qoi, y0, 0.0, 1e-5, theta, cfg,
                                     **kw)
    np.testing.assert_allclose(gs["log_A"].numpy(),
                               g["log_A"].sum(dim=0).numpy(), rtol=1e-12,
                               atol=1e-12 * float(gs["log_A"].abs().max()))


def test_batch_reactor_sens_adjoint_matches_jax():
    kw = dict(sens="adjoint", sens_qoi="H2O")
    a = br.batch_reactor(XML, FIX, gaschem=True, verbose=False, **kw)
    b = bt.batch_reactor(XML, FIX, gaschem=True, verbose=False,
                         device="cpu", **kw)
    assert isinstance(b, bt.SensitivitySolution)
    assert (b.status, b.species, b.names, b.n_accepted, b.truncated,
            b.tangents) == (a.status, a.species, a.names, a.n_accepted,
                            a.truncated, None)
    np.testing.assert_allclose(b.qoi, a.qoi, rtol=10 * RTOL)
    ga = np.asarray(a.qoi_grad["log_A"])
    assert np.abs(b.qoi_grad["log_A"] - ga).max() <= 10 * RTOL * np.abs(
        ga).max()
