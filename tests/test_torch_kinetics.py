"""Port parity: thermo, rate constants, production rates and the analytic
Jacobian (batchreactor_tpu_torch ops/ against the JAX package).

Random lane-batched states (B=16, T in [800, 2500] K, made with numpy from a
seed) go through the JAX functions under ``vmap`` and the port's batched
functions.  Both are float64 with the same formulas; only the summation
order of the reductions differs, so they agree to 1e-12 relative to each
lane's largest magnitude.  The closed-form Jacobian also matches
``torch.func.jacfwd`` of the port's own RHS to 1e-10.  A small mechanism
with PLOG and Chebyshev tables covers the pressure-dependent rates, which
neither vendored mechanism uses.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import batchreactor_tpu as br
from batchreactor_tpu.ops import gas_kinetics as gk_j
from batchreactor_tpu.ops import thermo as th_ops_j
from batchreactor_tpu.ops.rhs import make_gas_jac as jac_j
from batchreactor_tpu_torch.models.gas import (GAS_TENSOR_FIELDS,
                                               compile_gaschemistry)
from batchreactor_tpu_torch.models.thermo import create_thermo
from batchreactor_tpu_torch.ops import gas_kinetics as gk_t
from batchreactor_tpu_torch.ops import thermo as th_ops_t
from batchreactor_tpu_torch.ops.rhs import make_gas_jac, make_gas_rhs

torch.set_num_threads(1)

B = 16
REL = 1e-12


@pytest.fixture(scope="module", params=["h2o2.dat", "grimech.dat"])
def case(request, fixtures_dir):
    path = os.path.join(fixtures_dir, request.param)
    therm = os.path.join(fixtures_dir, "therm.dat")
    gm_j = br.compile_gaschemistry(path)
    th_j = br.create_thermo(list(gm_j.species), therm)
    gm_t = compile_gaschemistry(path, device="cpu")
    th_t = create_thermo(list(gm_t.species), therm, device="cpu")
    rng = np.random.default_rng(len(request.param))
    S = gm_t.n_species
    T = rng.uniform(800.0, 2500.0, B)
    x = rng.dirichlet(np.ones(S), B)
    x[:, :2] *= rng.uniform(0.0, 1e-3, (B, 1))   # a few trace species
    x[0, 1] = 0.0                                # and an exact zero
    conc = x * 1e5 / (8.314472 * T[:, None])
    return gm_j, th_j, gm_t, th_t, T, conc


def _close(got, ref, rel=REL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    scale = np.max(np.abs(ref.reshape(ref.shape[0], -1)), axis=1)
    tol = rel * scale.reshape((-1,) + (1,) * (ref.ndim - 1))
    assert np.all(np.abs(got - ref) <= tol), np.max(np.abs(got - ref) / tol)


def test_thermo_polynomials(case):
    _, th_j, _, th_t, T, _ = case
    ref = jax.vmap(lambda t: th_ops_j.cp_h_s_over_R(t, th_j))(jnp.asarray(T))
    got = th_ops_t.cp_h_s_over_R(torch.tensor(T), th_t)
    for g, r in zip(got, ref):
        _close(g, r)
    _close(th_ops_t.gibbs_over_RT(torch.tensor(T), th_t),
           jax.vmap(lambda t: th_ops_j.gibbs_over_RT(t, th_j))(jnp.asarray(T)))


@pytest.mark.parametrize("kc_compat", [False, True])
def test_rate_constants(case, kc_compat):
    gm_j, th_j, gm_t, th_t, T, conc = case
    kf_j, tb_j = jax.vmap(
        lambda t, c: gk_j.forward_rate_constants(t, c, gm_j,
                                                 falloff_compat=kc_compat))(
        jnp.asarray(T), jnp.asarray(conc))
    kf_t, tb_t = gk_t.forward_rate_constants(
        torch.tensor(T), torch.tensor(conc), gm_t, falloff_compat=kc_compat)
    _close(kf_t, kf_j)
    _close(tb_t, tb_j)
    lk_j = jax.vmap(lambda t: gk_j.equilibrium_constants(t, gm_j, th_j,
                                                         kc_compat))(
        jnp.asarray(T))
    _close(gk_t.equilibrium_constants(torch.tensor(T), gm_t, th_t, kc_compat),
           lk_j)
    kr_j = jax.vmap(lambda t, k: gk_j.reverse_rate_constants(
        t, k, gm_j, th_j, kc_compat))(jnp.asarray(T), kf_j)
    _close(gk_t.reverse_rate_constants(torch.tensor(T), kf_t, gm_t, th_t,
                                       kc_compat), kr_j)


def test_production_rates_and_jacobian(case):
    gm_j, th_j, gm_t, th_t, T, conc = case
    Tj, cj = jnp.asarray(T), jnp.asarray(conc)
    w_j = jax.vmap(lambda t, c: gk_j.production_rates(t, c, gm_j, th_j))(
        Tj, cj)
    w2_j, dw_j = jax.vmap(
        lambda t, c: gk_j.production_rates_and_jac(t, c, gm_j, th_j))(Tj, cj)
    Tt, ct = torch.tensor(T), torch.tensor(conc)
    _close(gk_t.production_rates(Tt, ct, gm_t, th_t), w_j)
    w2_t, dw_t = gk_t.production_rates_and_jac(Tt, ct, gm_t, th_t)
    _close(w2_t, w2_j)
    _close(dw_t, dw_j)
    # the RHS-level Jacobian (mass-density state) too
    y = conc * np.asarray(th_j.molwt)
    J_j = jax.vmap(lambda yy, t: jac_j(gm_j, th_j)(0.0, yy, {"T": t}))(
        jnp.asarray(y), Tj)
    J_t = make_gas_jac(gm_t, th_t)(0.0, torch.tensor(y), {"T": Tt})
    _close(J_t, J_j)


def test_analytic_jacobian_matches_jacfwd(case):
    _, _, gm_t, th_t, T, conc = case
    y = torch.tensor(conc) * th_t.molwt
    Tt = torch.tensor(T)
    rhs = make_gas_rhs(gm_t, th_t)
    J = make_gas_jac(gm_t, th_t)(0.0, y, {"T": Tt})
    for b in range(0, B, 5):
        Jf = torch.func.jacfwd(
            lambda yy: rhs(0.0, yy[None], {"T": Tt[b:b + 1]})[0])(y[b])
        _close(J[b:b + 1], Jf[None], rel=1e-10)


# Pressure-dependent rate tables: a ragged pair of PLOG reactions (3 and 2
# pressure points) and a 3x4 Chebyshev table, at pressures from 0.01 to
# 100 atm so lanes fall inside the tables and clamp at both ends.
_TABLES_MECH = """ELEMENTS
H O N
END
SPECIES
H2 O2 OH H2O H O N2
END
REACTIONS
H2+O2=2OH   1.0E13  0.0  1000.
PLOG / 0.1   1.0E12  0.5  900. /
PLOG / 1.0   1.0E13  0.2  1100. /
PLOG / 10.0  1.0E14  0.0  1300. /
OH+H2=H2O+H  1.0E8  1.6  3300.
PLOG / 0.5   1.0E8  1.6  3300. /
PLOG / 5.0   3.0E8  1.5  3100. /
H+O2=OH+O   1.0 0.0 0.0
TCHEB / 500. 2500. /
PCHEB / 0.1 10. /
CHEB / 3 4 7.0 0.5 -0.1 0.05 -0.3 0.1 0.02 -0.01 0.04 -0.02 0.01 0.005 /
2OH=H2O+O   1.0E12  0.0  300.
END
"""


@pytest.fixture(scope="module")
def tables_case(tmp_path_factory, fixtures_dir):
    path = str(tmp_path_factory.mktemp("tables") / "tables.dat")
    with open(path, "w") as fh:
        fh.write(_TABLES_MECH)
    therm = os.path.join(fixtures_dir, "therm.dat")
    gm_j = br.compile_gaschemistry(path)
    th_j = br.create_thermo(list(gm_j.species), therm)
    gm_t = compile_gaschemistry(path, device="cpu")
    th_t = create_thermo(list(gm_t.species), therm, device="cpu")
    assert gm_t.any_plog and gm_t.any_cheb
    rng = np.random.default_rng(7)
    S = gm_t.n_species
    T = rng.uniform(800.0, 2500.0, B)
    p = 101325.0 * 10.0 ** rng.uniform(-2.0, 2.0, B)
    x = rng.dirichlet(np.ones(S), B)
    conc = x * p[:, None] / (8.314472 * T[:, None])
    conc[1, 2] = -1e-3 * conc[1, 2]      # a transient negative iterate
    return gm_j, th_j, gm_t, th_t, T, conc


def test_plog_cheb_rates_and_jacobian_match_jax(tables_case):
    gm_j, th_j, gm_t, th_t, T, conc = tables_case
    for f in GAS_TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(gm_t, f).numpy(),
                                      np.asarray(getattr(gm_j, f)), err_msg=f)
    Tj, cj = jnp.asarray(T), jnp.asarray(conc)
    Tt, ct = torch.tensor(T), torch.tensor(conc)
    kf_j, _ = jax.vmap(
        lambda t, c: gk_j.forward_rate_constants(t, c, gm_j))(Tj, cj)
    kf_t, _ = gk_t.forward_rate_constants(Tt, ct, gm_t)
    _close(kf_t, kf_j)
    w_j, dw_j = jax.vmap(
        lambda t, c: gk_j.production_rates_and_jac(t, c, gm_j, th_j))(Tj, cj)
    w_t, dw_t = gk_t.production_rates_and_jac(Tt, ct, gm_t, th_t)
    _close(gk_t.production_rates(Tt, ct, gm_t, th_t), w_j)
    _close(w_t, w_j)
    _close(dw_t, dw_j)


def test_plog_cheb_jacobian_matches_jacfwd(tables_case):
    """The pressure chain (dk/dc through Ctot) makes the table rows dense
    in the state; the closed form matches forward-mode AD."""
    _, _, gm_t, th_t, T, conc = tables_case
    y = torch.tensor(conc) * th_t.molwt
    Tt = torch.tensor(T)
    rhs = make_gas_rhs(gm_t, th_t)
    J = make_gas_jac(gm_t, th_t)(0.0, y, {"T": Tt})
    for b in range(B):
        Jf = torch.func.jacfwd(
            lambda yy: rhs(0.0, yy[None], {"T": Tt[b:b + 1]})[0])(y[b])
        _close(J[b:b + 1], Jf[None], rel=1e-10)


def test_exp32_option_is_off_by_default_and_close_when_on(case):
    """exp32 is an explicit option: off, the rates are the float64 ones
    above; on, the rate constants move by float32 roundoff only."""
    gm_j, _, gm_t, th_t, T, conc = case
    Tt, ct = torch.tensor(T), torch.tensor(conc)
    kf64, _ = gk_t.forward_rate_constants(Tt, ct, gm_t)
    kf32, _ = gk_t.forward_rate_constants(Tt, ct, gm_t, exp32=True)
    assert not torch.equal(kf64, kf32)
    np.testing.assert_allclose(kf32.numpy(), kf64.numpy(), rtol=1e-5,
                               atol=0)
