"""Port parity: surface chemistry (batchreactor_tpu_torch models/surface.py,
ops/surface_kinetics.py, the surface and coupled builders of ops/rhs.py)
against the JAX package, on the CPU.

Parsed mechanism tensors must be equal; rates, Jacobian blocks and the
RHS-level Jacobians agree to 1e-12 relative, row by row (against the
row's largest entry; the coupled RHS and Jacobian split into their gas and
coverage blocks, whose scales lie ten decades apart).  Inputs come from
numpy seeds and the vendored fixtures.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import batchreactor_tpu as br
from batchreactor_tpu.models.surface import compile_mech as compile_mech_j
from batchreactor_tpu.ops import rhs as rhs_j
from batchreactor_tpu.ops import surface_kinetics as sk_j
from batchreactor_tpu_torch import (compile_gaschemistry, create_thermo,
                                    get_solution_vector)
from batchreactor_tpu_torch.models.surface import (SURFACE_STATIC_FIELDS,
                                                   SURFACE_TENSOR_FIELDS,
                                                   SurfaceMechanism,
                                                   compile_mech)
from batchreactor_tpu_torch.ops import surface_kinetics as sk_t
from batchreactor_tpu_torch.ops.rhs import make_surface_jac, make_surface_rhs
from batchreactor_tpu_torch.solver.linalg_cuda import (lu32p_backward_error,
                                                       lu32p_factor_plain,
                                                       permute_rows)

torch.set_num_threads(1)

REL = 1e-12
# entries below this come only from the 1e-300 concentration clamp raised
# to a fractional order (the rows where JAX rounds them to exact 0)
ATOL = 1e-250
B = 8
GAS7 = ["CH4", "H2O", "H2", "CO", "CO2", "O2", "N2"]
ASV = np.array([1.0, 10.0, 100.0, 1000.0])

# (surface mechanism, gas species source): a gas mechanism file, or the
# batch_surf 7-species list
CASES = {"ch4ni_gri": ("ch4ni.xml", "grimech.dat"),
         "ch4ni_gas7": ("ch4ni.xml", GAS7),
         "h2oni_h2o2": ("h2oni.xml", "h2o2.dat")}


def _close(got, ref, rel=REL, ng=None):
    """|got - ref| <= rel * (the row's largest |ref|) + ATOL, row by row
    along the last axis.  With ``ng`` the gas and coverage parts (of the
    columns, and of the rows of a (B, n, n) Jacobian) are compared as
    blocks of their own."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    if ng is not None:
        parts = (slice(None, ng), slice(ng, None))
        for cols in parts:
            if ref.ndim == 2:
                _close(got[:, cols], ref[:, cols], rel)
            else:
                for rows in parts:
                    _close(got[:, rows, cols], ref[:, rows, cols], rel)
        return
    tol = rel * np.max(np.abs(ref), axis=-1, keepdims=True) + ATOL
    assert np.all(np.abs(got - ref) <= tol), np.max(np.abs(got - ref) / tol)


@pytest.fixture(scope="module", params=list(CASES))
def case(request, fixtures_dir):
    """Both packages' (gas mechanism or None, thermo, surface mechanism)."""
    surf, gas = CASES[request.param]
    therm = os.path.join(fixtures_dir, "therm.dat")
    xml = os.path.join(fixtures_dir, surf)
    if isinstance(gas, str):
        path = os.path.join(fixtures_dir, gas)
        gm_j = br.compile_gaschemistry(path)
        gm_t = compile_gaschemistry(path, device="cpu")
        species = list(gm_t.species)
    else:
        gm_j = gm_t = None
        species = gas
    th_j = br.create_thermo(species, therm)
    th_t = create_thermo(species, therm, device="cpu")
    sm_j = compile_mech_j(xml, th_j, species)
    sm_t = compile_mech(xml, th_t, species, device="cpu")
    return request.param, gm_j, th_j, sm_j, gm_t, th_t, sm_t


def _states(sm_t, th_t, seed):
    """B seeded reactor states: T, cgs gas concentrations and coverages,
    every coverage populated on most lanes, zeros on one and slightly
    negative entries on two (Newton iterates can go there)."""
    rng = np.random.default_rng(seed)
    Sg, Ss = len(th_t.species), sm_t.n_surface_species
    T = rng.uniform(900.0, 1300.0, B)
    x = rng.dirichlet(np.ones(Sg), B)
    c_gas = x * 1e5 / (8.314472 * T[:, None]) * 1e-6       # mol/cm^3
    theta = rng.dirichlet(np.ones(Ss), B)
    theta[0] = np.asarray(sm_t.ini_covg)                    # zeros on lane 0
    theta[1, :2] = -1e-12
    theta[2, -1] = -3e-10
    return T, c_gas, theta


def test_parsed_tensors_equal(case):
    """The weights carried across: every field of the JAX mechanism, as
    numpy, equals the port's parse."""
    _, _, _, sm_j, _, _, sm_t = case
    for f in SURFACE_TENSOR_FIELDS:
        got = getattr(sm_t, f)
        assert got.dtype == torch.float64 and got.device.type == "cpu", f
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(sm_j, f)),
                                      err_msg=f)
    for f in SURFACE_STATIC_FIELDS:
        assert getattr(sm_t, f) == getattr(sm_j, f), f
    assert sm_t.n_reactions == sm_j.n_reactions
    assert sm_t.n_surface_species == sm_j.n_surface_species


def test_from_numpy_of_jax_mechanism_and_to(case):
    _, _, _, sm_j, _, _, sm_t = case
    fields = {f: np.asarray(getattr(sm_j, f)) for f in SURFACE_TENSOR_FIELDS}
    fields.update({f: getattr(sm_j, f) for f in SURFACE_STATIC_FIELDS})
    sm2 = SurfaceMechanism.from_numpy(fields, "cpu")
    for f in SURFACE_TENSOR_FIELDS:
        assert torch.equal(getattr(sm2, f), getattr(sm_t, f)), f
    assert sm_t.to("cpu") is sm_t


@pytest.mark.parametrize("seed", [0, 1])
def test_rates_and_jacobian_blocks(case, seed):
    name, _, _, sm_j, _, th_t, sm_t = case
    T, c_gas, theta = _states(sm_t, th_t, seed + len(name))
    Tj, cj, thj = jnp.asarray(T), jnp.asarray(c_gas), jnp.asarray(theta)
    k_j = jax.vmap(lambda t, th: sk_j.rate_constants(t, th, sm_j))(Tj, thj)
    k2_j, dk_j = jax.vmap(lambda t, th: sk_j.rate_constants(
        t, th, sm_j, with_grad=True))(Tj, thj)
    q_j = jax.vmap(lambda t, c, th: sk_j.reaction_rates_c(t, c, th, sm_j))(
        Tj, cj, thj)
    sd_j = jax.vmap(lambda t, c, th: sk_j.production_rates_c(t, c, th, sm_j))(
        Tj, cj, thj)
    sj_j = jax.vmap(lambda t, c, th: sk_j.production_rates_and_jac_c(
        t, c, th, sm_j))(Tj, cj, thj)
    Tt, ct, tht = (torch.tensor(T), torch.tensor(c_gas), torch.tensor(theta))
    _close(sk_t.rate_constants(Tt, tht, sm_t), k_j)
    k2_t, dk_t = sk_t.rate_constants(Tt, tht, sm_t, with_grad=True)
    _close(k2_t, k2_j)
    _close(dk_t, dk_j)
    _close(sk_t.reaction_rates_c(Tt, ct, tht, sm_t), q_j)
    for got, ref in zip(sk_t.production_rates_c(Tt, ct, tht, sm_t), sd_j):
        _close(got, ref)
    g_t, s_t, blocks_t = sk_t.production_rates_and_jac_c(Tt, ct, tht, sm_t)
    _close(g_t, sj_j[0])
    _close(s_t, sj_j[1])
    for got, ref in zip(blocks_t, sj_j[2]):
        _close(got, ref)


def test_mole_fraction_forms(case):
    """The (T, p, x) entries equal the concentration entries."""
    name, _, _, sm_j, _, th_t, sm_t = case
    T, c_gas, theta = _states(sm_t, th_t, 7)
    x = c_gas / c_gas.sum(axis=1, keepdims=True)
    p = np.full(B, 1e5)
    ref_q = jax.vmap(lambda t, pp, xx, th: sk_j.reaction_rates(
        t, pp, xx, th, sm_j))(jnp.asarray(T), jnp.asarray(p), jnp.asarray(x),
                              jnp.asarray(theta))
    ref = jax.vmap(lambda t, pp, xx, th: sk_j.production_rates_and_jac(
        t, pp, xx, th, sm_j))(jnp.asarray(T), jnp.asarray(p), jnp.asarray(x),
                              jnp.asarray(theta))
    args = (torch.tensor(T), torch.tensor(p), torch.tensor(x),
            torch.tensor(theta), sm_t)
    _close(sk_t.reaction_rates(*args), ref_q)
    for got, r in zip(sk_t.production_rates(*args), ref[:2]):
        _close(got, r)
    got = sk_t.production_rates_and_jac(*args)
    for g, r in zip(got[2], ref[2]):
        _close(g, r)


def _reactor_states(case, seed):
    """B states y = [rho_k, theta_k] with per-lane Asv over the decades."""
    _, gm_j, th_j, sm_j, gm_t, th_t, sm_t = case
    T, c_gas, theta = _states(sm_t, th_t, seed)
    rho = c_gas * 1e6 * th_t.molwt.numpy()
    y = np.concatenate([rho, theta], axis=1)
    return T, np.resize(ASV, B), y


@pytest.mark.parametrize("asv_quirk", [True, False])
def test_surface_rhs_and_jac_match_jax(case, asv_quirk):
    _, gm_j, th_j, sm_j, gm_t, th_t, sm_t = case
    T, Asv, y = _reactor_states(case, 11)
    f_j = rhs_j.make_surface_rhs(sm_j, th_j, gm=gm_j, asv_quirk=asv_quirk)
    J_jf = rhs_j.make_surface_jac(sm_j, th_j, gm=gm_j, asv_quirk=asv_quirk)
    ref_f = jax.vmap(lambda yy, t, a: f_j(0.0, yy, {"T": t, "Asv": a}))(
        jnp.asarray(y), jnp.asarray(T), jnp.asarray(Asv))
    ref_J = jax.vmap(lambda yy, t, a: J_jf(0.0, yy, {"T": t, "Asv": a}))(
        jnp.asarray(y), jnp.asarray(T), jnp.asarray(Asv))
    cfg = {"T": torch.tensor(T), "Asv": torch.tensor(Asv)}
    yt = torch.tensor(y)
    rhs = make_surface_rhs(sm_t, th_t, gm=gm_t, asv_quirk=asv_quirk)
    jac = make_surface_jac(sm_t, th_t, gm=gm_t, asv_quirk=asv_quirk)
    ng = len(th_t.species)
    _close(rhs(0.0, yt, cfg), ref_f, ng=ng)
    J = jac(0.0, yt, cfg)
    _close(J, ref_J, ng=ng)
    blocks = make_surface_jac(sm_t, th_t, gm=gm_t, asv_quirk=asv_quirk,
                              return_blocks=True)(0.0, yt, cfg)
    assert torch.equal(torch.cat([torch.cat(blocks[:2], 2),
                                  torch.cat(blocks[2:], 2)], 1), J)
    assert blocks[3].shape == (B, y.shape[1] - ng, y.shape[1] - ng)


def test_analytic_jacobian_matches_jacfwd_of_port_rhs(case):
    _, _, _, _, gm_t, th_t, sm_t = case
    T, Asv, y = _reactor_states(case, 12)
    cfg = {"T": torch.tensor(T), "Asv": torch.tensor(Asv)}
    yt = torch.tensor(y)
    rhs = make_surface_rhs(sm_t, th_t, gm=gm_t)
    J = make_surface_jac(sm_t, th_t, gm=gm_t)(0.0, yt, cfg)
    for b in (0, 3, 5):
        c1 = {k: v[b:b + 1] for k, v in cfg.items()}
        Jf = torch.func.jacfwd(lambda yy: rhs(0.0, yy[None], c1)[0])(yt[b])
        _close(J[b:b + 1], Jf[None], rel=1e-10, ng=len(th_t.species))


def test_asv_quirk_scales_coverage_rows_by_asv(case):
    _, _, _, _, gm_t, th_t, sm_t = case
    T, Asv, y = _reactor_states(case, 13)
    cfg = {"T": torch.tensor(T), "Asv": torch.tensor(Asv)}
    yt = torch.tensor(y)
    ng = len(th_t.species)
    d_q = make_surface_rhs(sm_t, th_t, gm=gm_t, asv_quirk=True)(0.0, yt, cfg)
    d_p = make_surface_rhs(sm_t, th_t, gm=gm_t, asv_quirk=False)(0.0, yt, cfg)
    assert torch.equal(d_q[:, :ng], d_p[:, :ng])
    nz = d_p[:, ng:] != 0
    ratio = (d_q[:, ng:] / torch.where(nz, d_p[:, ng:], 1.0))
    want = torch.tensor(Asv)[:, None].expand_as(ratio)
    torch.testing.assert_close(ratio[nz], want[nz], rtol=1e-14, atol=0)


_HEAD = """<?xml version="1.0"?>
<surface_mech unit="{unit}">
 <species>x(s) y(s)</species>
 <site><coordination>x(s)=1</coordination>{density}
  <initial>x(s)=1.0</initial></site>
 {body}
</surface_mech>"""
_DENSITY = '<density unit="mol/cm2">2.6e-9</density>'

MALFORMED = {
    "missing_density": dict(density="", body=""),
    "unknown_unit": dict(unit="eV", body=""),
    "two_at_signs": dict(body='<arrhenius><rxn id="1">x(s) => y(s) @ 1 0 '
                              '@ 10</rxn></arrhenius>'),
    "too_few_params": dict(body='<arrhenius><rxn id="1">x(s) => y(s) @ 1e13'
                                '</rxn></arrhenius>'),
    "stick_two_gases": dict(body='<stick><rxn id="1">h2 + o2 + x(s) => '
                                 'y(s) @ 0.1</rxn></stick>'),
    "stick_s0_range": dict(body='<stick><rxn id="1">h2 + x(s) => y(s) @ 1.5'
                                '</rxn></stick>'),
    "duplicate_ids": dict(body='<arrhenius><rxn id="1">x(s) => y(s) @ 1 0 1'
                               '</rxn><rxn id="1">y(s) => x(s) @ 1 0 1</rxn>'
                               '</arrhenius>'),
    "unknown_species": dict(body='<arrhenius><rxn id="1">z(s) => y(s) @ 1 0 '
                                 '1</rxn></arrhenius>'),
    "nonpositive_A": dict(body='<arrhenius><rxn id="1">x(s) => y(s) @ 0 0 1'
                               '</rxn></arrhenius>'),
    "density_unit": dict(density='<density unit="mol/l">1</density>',
                         body=""),
}


@pytest.mark.parametrize("name", list(MALFORMED))
def test_malformed_xml_raises_as_jax(tmp_path, fixtures_dir, name):
    spec = {"unit": "kJ/mol", "density": _DENSITY, **MALFORMED[name]}
    path = tmp_path / "bad.xml"
    path.write_text(_HEAD.format(**spec))
    gas = ["H2", "O2", "N2"]
    therm = os.path.join(fixtures_dir, "therm.dat")
    with pytest.raises((ValueError, KeyError)) as ej:
        compile_mech_j(str(path), br.create_thermo(gas, therm), gas)
    with pytest.raises(ej.type) as et:
        compile_mech(str(path), create_thermo(gas, therm, device="cpu"), gas,
                     device="cpu")
    assert str(et.value) == str(ej.value)


def test_gasphase_order_must_match_thermo(fixtures_dir):
    therm = os.path.join(fixtures_dir, "therm.dat")
    th = create_thermo(GAS7, therm, device="cpu")
    with pytest.raises(ValueError, match="must match in order"):
        compile_mech(os.path.join(fixtures_dir, "ch4ni.xml"), th,
                     GAS7[::-1], device="cpu")


@pytest.fixture(scope="module")
def coupled_jacobians(fixtures_dir):
    """Coupled GRI-3.0 + CH4/Ni Jacobians (n = 66) at the coupled path's
    initial states: 4 temperatures over 1073-1273 K x Asv 1..1000."""
    gm = compile_gaschemistry(os.path.join(fixtures_dir, "grimech.dat"),
                              device="cpu")
    th = create_thermo(list(gm.species),
                       os.path.join(fixtures_dir, "therm.dat"), device="cpu")
    sm = compile_mech(os.path.join(fixtures_dir, "ch4ni.xml"), th,
                      list(gm.species), device="cpu")
    sp = list(gm.species)
    x0 = np.zeros(len(sp))
    for k, v in {"CH4": 0.25, "O2": 0.5, "N2": 0.25}.items():
        x0[sp.index(k)] = v
    T = torch.tensor(np.repeat(np.linspace(1073.0, 1273.0, 4), 4))
    Asv = torch.tensor(np.tile(ASV, 4))
    y0 = get_solution_vector(np.broadcast_to(x0, (16, len(sp))), th.molwt,
                             T, 1e5, ini_covg=sm.ini_covg)
    return make_surface_jac(sm, th, gm=gm)(0.0, y0, {"T": T, "Asv": Asv})


@pytest.mark.parametrize("c", [1e-7, 1e-5, 1e-3])
def test_lu32p_plain_backward_stable_on_coupled_newton_matrices(
        coupled_jacobians, c):
    """The plain version meets the componentwise bound that chip_smoke.py
    holds the CTA kernel to on the same matrices, M = I - c J, at the
    step sizes where cond(M) grows from ~1e10 to ~1e18; and the bound sees
    an error in a gas row that a bound scaled by the lane's largest entry
    (a coverage entry ~1e10) cannot."""
    J = coupled_jacobians
    n = J.shape[-1]
    tol = 64 * n * float(np.finfo(np.float32).eps)
    M = torch.eye(n, dtype=torch.float64) - c * J
    LU, piv = lu32p_factor_plain(M)
    bwd, l_max = lu32p_backward_error(M, LU, piv)
    assert float(bwd.max()) <= tol and float(l_max.max()) <= 1.0
    # perturb lane 0's U entry in a gas row that is smallest against the
    # lane's largest |M| by 0.01 of its |L||U|, 20x the tolerance
    Ud = torch.triu(LU[0].double())
    L = torch.tril(LU[0].double(), -1) + torch.eye(LU.shape[-1],
                                                   dtype=torch.float64)
    LLU = L.abs() @ Ud.abs()
    rows = permute_rows(torch.arange(LU.shape[-1], dtype=torch.float64)
                        .expand(1, -1)[..., None], piv[:1])[0, :, 0]
    gas_u = (rows[:, None] < 53) & (Ud.abs() > 1e-20)
    i, j = divmod(int(torch.where(gas_u, LLU, torch.inf).argmin()),
                  LU.shape[-1])
    bad = LU.clone()
    bad[0, i, j] += 0.01 * LLU[i, j]
    assert float(lu32p_backward_error(M, bad, piv)[0][0]) > tol
    assert 0.01 * float(LLU[i, j]) < tol * float(M[0].abs().max())


@pytest.mark.parametrize("c", [1e-7, 1e-5, 1e-3])
def test_blocked_lu32_order_on_coupled_newton_matrices(coupled_jacobians, c):
    """The CTA kernel's order of operations (``blocked_lu32``) on the
    coupled path's own Newton matrices M = I - c J (n = 66, npad 72): the
    componentwise backward bound |PA - LU| <= 64 n eps32 |L||U| with
    |L| <= 1 at every step size, and at c = 1e-7 s, the coupled path's own
    step, the plain version's pivots on every lane and factors within
    64 n eps32 of each row's largest |L||U|, the checks chip_smoke.py holds
    the kernel to on 1024 such lanes."""
    from batchreactor_tpu_torch.tools.lu32p_coverages import blocked_lu32

    J = coupled_jacobians
    n = J.shape[-1]
    tol = 64 * n * float(np.finfo(np.float32).eps)
    M = torch.eye(n, dtype=torch.float64) - c * J
    LU, piv = blocked_lu32(M)
    bwd, l_max = lu32p_backward_error(M, LU, piv)
    assert float(bwd.max()) <= tol and float(l_max.max()) <= 1.0
    if c == 1e-7:
        LU_p, piv_p = lu32p_factor_plain(M)
        assert torch.equal(piv, piv_p)
        L = torch.tril(LU_p.double(), -1) + torch.eye(LU_p.shape[-1],
                                                      dtype=torch.float64)
        llu = (L.abs() @ torch.triu(LU_p.double()).abs()).amax(
            dim=2, keepdim=True)
        assert float(((LU - LU_p).abs().double() / llu).max()) <= tol
