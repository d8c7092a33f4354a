"""ROADMAP C9: ``models.thermo.element_matrix`` of the port against the JAX
package's, and element conservation of the port's gas kinetics.

The bounds are the JAX package's own: production rates conserve every
element to 1e-10 of the largest |wdot| (``tests/test_gas_kinetics.py``)
and a solved trajectory keeps each element's moles to rtol 1e-9
(``tests/test_integration.py``).  The states are made from a numpy seed.
"""

import os

import numpy as np
import pytest
import torch

import batchreactor_tpu as br
import batchreactor_tpu_torch as bt
from batchreactor_tpu.models.thermo import element_matrix as element_matrix_j
from batchreactor_tpu_torch.models.thermo import element_matrix
from batchreactor_tpu_torch.ops import gas_kinetics
from batchreactor_tpu_torch.ops.rhs import make_gas_jac, make_gas_rhs
from batchreactor_tpu_torch.parallel import ensemble_solve_segmented

torch.set_num_threads(1)

FUELS = {"h2o2.dat": {"H2": 0.25, "O2": 0.25, "N2": 0.5},
         "grimech.dat": {"CH4": 0.25, "O2": 0.5, "N2": 0.25}}


@pytest.fixture(scope="module", params=list(FUELS))
def mech(request, fixtures_dir):
    therm = os.path.join(fixtures_dir, "therm.dat")
    gm = bt.compile_gaschemistry(os.path.join(fixtures_dir, request.param),
                                 device="cpu")
    return request.param, gm, bt.create_thermo(list(gm.species), therm,
                                               device="cpu")


@pytest.mark.parametrize("species", [["CH4", "O2", "CO2", "H2O"],
                                     ["H2", "O2", "OH", "AR", "N2"]])
def test_element_matrix_matches_jax(fixtures_dir, species):
    therm = os.path.join(fixtures_dir, "therm.dat")
    th_t = bt.create_thermo(species, therm, device="cpu")
    th_j = br.create_thermo(species, therm)
    el_t, E_t = element_matrix(th_t)
    el_j, E_j = element_matrix_j(th_j)
    assert el_t == el_j
    np.testing.assert_array_equal(E_t, E_j)
    # a chosen element order, as in the JAX package
    order = list(reversed(el_j))
    np.testing.assert_array_equal(element_matrix(th_t, order)[1],
                                  element_matrix_j(th_j, order)[1])
    if "CH4" in species:
        ch4 = E_t[:, 0]
        assert ch4[el_t.index("C")] == 1 and ch4[el_t.index("H")] == 4


def test_rates_conserve_elements(mech):
    """E @ wdot vanishes to 1e-10 max|wdot| over seeded states and three
    temperatures (the JAX package's bound)."""
    name, gm, th = mech
    _, E = element_matrix(th)
    sp = list(gm.species)
    rng = np.random.default_rng(7)
    x0 = np.zeros(len(sp))
    for k, v in FUELS[name].items():
        x0[sp.index(k)] = v
    T = torch.tensor([1000.0, 1173.0, 1600.0], dtype=torch.float64)
    y = bt.get_solution_vector(np.broadcast_to(x0, (3, len(sp))), th.molwt,
                               T, 1e5)
    rho = y.sum(dim=1, keepdim=True)
    y = y + rho * 1e-4 * torch.from_numpy(rng.random(y.shape))
    wdot = gas_kinetics.production_rates(T, y / th.molwt, gm, th).numpy()
    balance = wdot @ E.T
    for lane in range(3):
        assert np.abs(balance[lane]).max() < 1e-10 * np.abs(
            wdot[lane]).max(), (name, lane)


def test_sweep_trajectory_conserves_elements(mech):
    """Every saved state of a CPU sweep holds each element's moles to
    rtol 1e-9 of the initial state (h2o2 to 10 s, GRI-3.0 through
    ignition)."""
    name, gm, th = mech
    _, E = element_matrix(th)
    sp = list(gm.species)
    x0 = np.zeros(len(sp))
    for k, v in FUELS[name].items():
        x0[sp.index(k)] = v
    T = torch.tensor([1173.0, 1400.0] if name == "h2o2.dat"
                     else [1500.0, 1800.0], dtype=torch.float64)
    t1 = 10.0 if name == "h2o2.dat" else 8e-4
    y0 = bt.get_solution_vector(np.broadcast_to(x0, (2, len(sp))), th.molwt,
                                T, 1e5)
    res = ensemble_solve_segmented(make_gas_rhs(gm, th), y0, 0.0, t1,
                                   {"T": T}, jac=make_gas_jac(gm, th),
                                   linsolve="lu", n_save=1024)
    assert bool((res.status == 1).all())
    molwt = th.molwt.numpy()
    for lane in range(2):
        n = int(res.n_saved[lane])
        assert n > 10
        elem = (res.ys[lane, :n].numpy() / molwt) @ E.T
        np.testing.assert_allclose(elem, np.broadcast_to(elem[0],
                                                         elem.shape),
                                   rtol=1e-9)
