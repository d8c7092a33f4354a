"""Port parity: mechanism-shape padding (batchreactor_tpu_torch
models/padding.py, aot/buckets.py and the sweep's ``species_buckets``/
``reaction_buckets``/``mech_operands``) against the JAX package.

* The padded tensors equal the JAX package's ``pad_*`` outputs exactly,
  and ``mech_shape_class`` is the same dict (h2o2 and GRI-3.0).
* The dead block is inert: exact zero rates, zero Jacobian rows and
  columns, and M = I - cJ the identity there.
* Padded against unpadded in the port, BDF and SDIRK: identical status,
  accepted and rejected steps and t; live states within 1e-10; dead
  species exactly 0 (the live-count norm operand, ``_nlive``, keeps step
  control as unpadded).
* The padded sweep against the JAX package's padded sweep: x within
  10 rtol, the same steps, live species only in the result; with
  ``energy=`` the T row sits at S_pad.
* The validation errors are the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import batchreactor_tpu as br
import batchreactor_tpu_torch as bt
from batchreactor_tpu.aot import buckets as buckets_j
from batchreactor_tpu.models import padding as padding_j
from batchreactor_tpu_torch.aot import buckets
from batchreactor_tpu_torch.energy.eqns import extend_states
from batchreactor_tpu_torch.models import padding
from batchreactor_tpu_torch.models.gas import GAS_TENSOR_FIELDS
from batchreactor_tpu_torch.models.thermo import THERMO_TENSOR_FIELDS
from batchreactor_tpu_torch.ops.rhs import make_gas_jac, make_gas_rhs
from batchreactor_tpu_torch.parallel import ensemble_solve
from batchreactor_tpu_torch.parallel.grid import sweep_solution_vectors
from batchreactor_tpu_torch.solver.common import NLIVE_KEY

torch.set_num_threads(1)

FIX = __file__.rsplit("/", 1)[0] + "/fixtures"
RTOL = 1e-6
COMP = {"H2": 0.3, "O2": 0.15, "N2": 0.55}
# (mechanism file, S_pad, R_pad): h2o2 to the pow2 rung, GRI-3.0 to the
# shape that puts it on the lu32p kernel's CTA path
SHAPES = {"h2o2": ("h2o2.dat", 16, 32), "gri": ("grimech.dat", 96, 512)}


@pytest.fixture(scope="module", params=sorted(SHAPES))
def mechs(request):
    fname, s_pad, r_pad = SHAPES[request.param]
    gm_j = br.compile_gaschemistry(f"{FIX}/{fname}")
    th_j = br.create_thermo(list(gm_j.species), f"{FIX}/therm.dat")
    gm = bt.compile_gaschemistry(f"{FIX}/{fname}", device="cpu")
    th = bt.create_thermo(list(gm.species), f"{FIX}/therm.dat",
                          device="cpu")
    return gm_j, th_j, gm, th, s_pad, r_pad


@pytest.fixture(scope="module")
def h2o2():
    gm = bt.compile_gaschemistry(f"{FIX}/h2o2.dat", device="cpu")
    th = bt.create_thermo(list(gm.species), f"{FIX}/therm.dat",
                          device="cpu")
    return gm, th


def _lanes(gm, th, B=3):
    idx = {s: k for k, s in enumerate(gm.species)}
    X = np.zeros((B, gm.n_species))
    for k, v in COMP.items():
        X[:, idx[k]] = v
    T = torch.tensor(np.linspace(1150.0, 1500.0, B))
    return sweep_solution_vectors(X, th.molwt, T, 1e5), {
        "T": T, "Asv": torch.ones(B, dtype=torch.float64)}


# --------------------------------------------------------------------------
# the padding layer against the JAX package's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("canonical", [False, True])
def test_padded_tensors_equal_jax(mechs, canonical):
    gm_j, th_j, gm, th, s_pad, r_pad = mechs
    a = padding_j.pad_gas_mechanism(gm_j, s_pad, r_pad, canonical=canonical)
    b = padding.pad_gas_mechanism(gm, s_pad, r_pad, canonical=canonical)
    for f in GAS_TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(a, f)), err_msg=f)
    assert b.species == a.species and b.equations == a.equations
    ta = padding_j.pad_thermo(th_j, s_pad, canonical=canonical)
    tb = padding.pad_thermo(th, s_pad, canonical=canonical)
    for f in THERMO_TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(ta, f)), err_msg=f)
    assert tb.species == ta.species and tb.composition == ta.composition
    assert (padding.mech_shape_class(b, tb)
            == padding_j.mech_shape_class(a, ta))
    y = np.random.default_rng(0).random((2, gm.n_species))
    np.testing.assert_array_equal(
        padding.pad_states(torch.tensor(y), s_pad).numpy(),
        np.asarray(padding_j.pad_states(jnp.asarray(y), s_pad)))
    cfg = padding.nlive_cfg({"T": torch.ones(2, dtype=torch.float64)},
                            gm.n_species, 2)
    np.testing.assert_array_equal(
        cfg[NLIVE_KEY].numpy(),
        np.asarray(padding_j.nlive_cfg({"T": jnp.ones(2)}, gm.n_species,
                                       2)[padding_j.NLIVE_KEY]))


def _raises_like(fn_j, fn_t, exc=ValueError):
    with pytest.raises(exc) as ej:
        fn_j()
    with pytest.raises(exc) as et:
        fn_t()
    assert str(et.value) == str(ej.value)


def test_padding_and_bucket_errors_equal_jax(h2o2):
    gm, th = h2o2
    gm_j = br.compile_gaschemistry(f"{FIX}/h2o2.dat")
    th_j = br.create_thermo(list(gm_j.species), f"{FIX}/therm.dat")
    S, R = gm.n_species, gm.n_reactions
    _raises_like(lambda: padding_j.pad_gas_mechanism(gm_j, S - 1, R),
                 lambda: padding.pad_gas_mechanism(gm, S - 1, R))
    _raises_like(lambda: padding_j.pad_thermo(th_j, S - 1),
                 lambda: padding.pad_thermo(th, S - 1))
    _raises_like(lambda: padding_j.pad_states(jnp.zeros((2, 5)), 3),
                 lambda: padding.pad_states(torch.zeros((2, 5)), 3))
    for bad in ("pow3", (), (4, 4), (8, 2), (0,), 7, (1.5,)):
        _raises_like(lambda: buckets_j.normalize_buckets(bad),
                     lambda: buckets.normalize_buckets(bad))
    _raises_like(lambda: buckets_j.resolve_bucket(9, (4, 8)),
                 lambda: buckets.resolve_bucket(9, (4, 8)))
    for B, spec in ((1, "pow2"), (9, "pow2"), (53, (64, 96)), (5, None)):
        assert (buckets.resolve_bucket(B, spec)
                == buckets_j.resolve_bucket(B, spec))


def test_rates_and_jacobian_inert_on_the_dead_block(mechs):
    _, _, gm, th, s_pad, r_pad = mechs
    S = gm.n_species
    gmp = padding.pad_gas_mechanism(gm, s_pad, r_pad)
    thp = padding.pad_thermo(th, s_pad)
    y0, cfg = _lanes(gm, th, 2)
    yp = padding.pad_states(y0, s_pad)
    dy = make_gas_rhs(gm, th)(0.0, y0, cfg)
    dyp = make_gas_rhs(gmp, thp)(0.0, yp, cfg)
    np.testing.assert_allclose(dyp[:, :S].numpy(), dy.numpy(), rtol=1e-12,
                               atol=1e-300)
    assert torch.all(dyp[:, S:] == 0.0)
    Jp = make_gas_jac(gmp, thp)(0.0, yp, cfg)
    assert torch.all(Jp[:, S:, :] == 0.0), "dead Jacobian rows"
    assert torch.all(Jp[:, :, S:] == 0.0), "dead Jacobian columns"
    M = torch.eye(s_pad, dtype=torch.float64) - 1e-7 * Jp
    assert torch.equal(M[:, S:, S:],
                       torch.eye(s_pad - S, dtype=torch.float64).expand(
                           2, -1, -1))


# --------------------------------------------------------------------------
# padded against unpadded in the port: step control blind to the padding
# --------------------------------------------------------------------------
@pytest.mark.parametrize("method", ["bdf", "sdirk"])
def test_padded_steps_identical_to_unpadded(h2o2, method):
    gm, th = h2o2
    S, (_, s_pad, r_pad) = gm.n_species, SHAPES["h2o2"]
    gmp = padding.pad_gas_mechanism(gm, s_pad, r_pad)
    thp = padding.pad_thermo(th, s_pad)
    y0, cfg = _lanes(gm, th)
    kw = dict(method=method, max_steps=20_000, linsolve="lu")
    a = ensemble_solve(make_gas_rhs(gm, th), y0, 0.0, 5e-5, cfg,
                       jac=make_gas_jac(gm, th), **kw)
    b = ensemble_solve(make_gas_rhs(gmp, thp),
                       padding.pad_states(y0, s_pad), 0.0, 5e-5,
                       padding.nlive_cfg(cfg, S, y0.shape[0]),
                       jac=make_gas_jac(gmp, thp), **kw)
    for f in ("status", "n_accepted", "n_rejected", "t"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.all(b.y[:, S:] == 0.0)
    np.testing.assert_allclose(b.y[:, :S].numpy(), a.y.numpy(), rtol=1e-10,
                               atol=1e-22)


def test_without_the_live_count_padding_moves_the_steps(h2o2):
    """The live-count operand is what keeps the steps: dropped, the mean
    over the padded width shrinks every norm and the controller takes
    longer steps."""
    gm, th = h2o2
    _, s_pad, r_pad = SHAPES["h2o2"]
    gmp = padding.pad_gas_mechanism(gm, s_pad, r_pad)
    thp = padding.pad_thermo(th, s_pad)
    y0, cfg = _lanes(gm, th)
    kw = dict(max_steps=20_000, linsolve="lu")
    a = ensemble_solve(make_gas_rhs(gm, th), y0, 0.0, 5e-5, cfg,
                       jac=make_gas_jac(gm, th), **kw)
    b = ensemble_solve(make_gas_rhs(gmp, thp),
                       padding.pad_states(y0, s_pad), 0.0, 5e-5, cfg,
                       jac=make_gas_jac(gmp, thp), **kw)
    assert not torch.equal(a.n_accepted, b.n_accepted)


# --------------------------------------------------------------------------
# the sweep's padding knobs against the JAX package's
# --------------------------------------------------------------------------
def _sweep_pair(gm_j, th_j, gm, th, T, t1, **kw):
    a = br.batch_reactor_sweep(COMP, T, 1e5, t1,
                               chem=br.Chemistry(gaschem=True),
                               thermo_obj=th_j, md=gm_j, rtol=RTOL, **kw)
    b = bt.batch_reactor_sweep(COMP, T, 1e5, t1,
                               chem=bt.Chemistry(gaschem=True),
                               thermo_obj=th, md=gm, rtol=RTOL,
                               device="cpu", **kw)
    return a, b


def test_sweep_padded_matches_jax_and_strips_dead_species(h2o2):
    gm, th = h2o2
    gm_j = br.compile_gaschemistry(f"{FIX}/h2o2.dat")
    th_j = br.create_thermo(list(gm_j.species), f"{FIX}/therm.dat")
    T = [1200.0, 1400.0]
    a, b = _sweep_pair(gm_j, th_j, gm, th, T, 5e-5,
                       species_buckets="pow2", reaction_buckets="pow2",
                       ignition_marker="H2")
    assert list(b["x"]) == list(gm.species)   # no _PAD_* names
    for s in gm.species:
        np.testing.assert_allclose(b["x"][s], a["x"][s], rtol=10 * RTOL,
                                   atol=1e-14)
    assert b["report"]["n_accepted"] == a["report"]["n_accepted"]
    np.testing.assert_allclose(b["tau"], a["tau"], rtol=10 * RTOL)
    assert b["linsolve"] == "lu"
    # the padded sweep takes the unpadded sweep's steps
    c = bt.batch_reactor_sweep(COMP, T, 1e5, 5e-5,
                               chem=bt.Chemistry(gaschem=True),
                               thermo_obj=th, md=gm, rtol=RTOL,
                               ignition_marker="H2", device="cpu")
    assert c["report"]["n_accepted"] == b["report"]["n_accepted"]
    # mech_operands is the padding with placeholder names and pow2 ladders
    d = bt.batch_reactor_sweep(COMP, T, 1e5, 5e-5,
                               chem=bt.Chemistry(gaschem=True),
                               thermo_obj=th, md=gm, rtol=RTOL,
                               ignition_marker="H2", mech_operands=True,
                               segment_steps=64, device="cpu")
    assert list(d["x"]) == list(gm.species)
    for s in gm.species:
        np.testing.assert_array_equal(d["x"][s], b["x"][s])


def test_sweep_energy_padded_matches_jax(h2o2):
    """With ``energy=`` the T row goes in after the species padding, at
    S_pad, and the live count rises by one."""
    gm, th = h2o2
    gm_j = br.compile_gaschemistry(f"{FIX}/h2o2.dat")
    th_j = br.create_thermo(list(gm_j.species), f"{FIX}/therm.dat")
    T = [1150.0, 1300.0]
    kw = dict(energy="adiabatic_v", species_buckets=(12,),
              reaction_buckets="pow2")
    a, b = _sweep_pair(gm_j, th_j, gm, th, T, 2e-4, **kw)
    np.testing.assert_allclose(b["T"], a["T"], rtol=10 * RTOL)
    np.testing.assert_allclose(b["ignition_delay"], a["ignition_delay"],
                               rtol=10 * RTOL)
    assert b["report"]["n_accepted"] == a["report"]["n_accepted"]
    unpadded = bt.batch_reactor_sweep(
        COMP, T, 1e5, 2e-4, chem=bt.Chemistry(gaschem=True),
        thermo_obj=th, md=gm, rtol=RTOL, energy="adiabatic_v",
        device="cpu")
    assert unpadded["report"]["n_accepted"] == b["report"]["n_accepted"]
    np.testing.assert_allclose(b["T"], unpadded["T"], rtol=1e-10)
    # the layout: species, dead species, then T at S_pad
    y0, _ = _lanes(gm, th, 2)
    ye = extend_states(padding.pad_states(y0, 12), torch.tensor(T))
    assert ye.shape[1] == 13 and torch.equal(ye[:, 12],
                                             torch.tensor(T))


def test_sweep_padding_validation_equals_jax(h2o2):
    gm, th = h2o2
    gm_j = br.compile_gaschemistry(f"{FIX}/h2o2.dat")
    th_j = br.create_thermo(list(gm_j.species), f"{FIX}/therm.dat")

    def both(chem_kw=None, **kw):
        chem_kw = chem_kw or {"gaschem": True}
        jkw = dict(kw, chem=br.Chemistry(**chem_kw), thermo_obj=th_j)
        tkw = dict(kw, chem=bt.Chemistry(**chem_kw), thermo_obj=th,
                   device="cpu")
        if "udf" not in chem_kw:
            jkw["md"], tkw["md"] = gm_j, gm
        _raises_like(
            lambda: br.batch_reactor_sweep({"H2": 1.0}, 1200.0, 1e5, 1e-6,
                                           **jkw),
            lambda: bt.batch_reactor_sweep({"H2": 1.0}, 1200.0, 1e5, 1e-6,
                                           **tkw))

    both(mech_operands=True)
    both(mech_operands=True, segment_steps=16, analytic_jac=False)
    both(species_buckets="pow3")
    both(reaction_buckets=(8,))
    both(chem_kw={"userchem": True, "udf": lambda t, s: 0.0},
         species_buckets="pow2")
