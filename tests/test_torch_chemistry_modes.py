"""Port parity: the surface, coupled gas+surface and user-defined chemistry
modes end to end (api -> sweep driver -> BDF -> Newton -> kinetics) against
the JAX package, on the CPU.

Reference configuration: the JAX CPU path (float64, ``linsolve="lu"``,
``jac_window=1``).  Final gas mole fractions, coverages and status agree at
the rtol scale (x rel <= 10 rtol); step counts are printed, not asserted.
The guards of the chemistry modes raise what the JAX package's raise.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import batchreactor_tpu as br
import batchreactor_tpu_torch as bt
from batchreactor_tpu.models.surface import compile_mech as compile_mech_j
from batchreactor_tpu_torch import api
from batchreactor_tpu_torch.ops.rhs import make_surface_jac, make_surface_rhs
from batchreactor_tpu_torch.parallel.sweep import (ensemble_solve_segmented,
                                                   sweep_report)
from batchreactor_tpu_torch.solver.common import MAX_STEPS_REACHED, SUCCESS
from batchreactor_tpu_torch.solver.linalg import resolve_linsolve

torch.set_num_threads(1)

RTOL = 1e-6
GAS7 = ["CH4", "H2O", "H2", "CO", "CO2", "O2", "N2"]
COMP7 = {"CH4": 0.25, "H2O": 0.25, "N2": 0.5}
COMP_H2 = {"H2": 0.3, "O2": 0.2, "N2": 0.5}
ASV = [1.0, 10.0, 100.0, 1000.0]


@pytest.fixture(scope="module")
def h2oni(fixtures_dir):
    """h2o2 gas mechanism + the H2O/Ni surface mechanism, both packages."""
    path = os.path.join(fixtures_dir, "h2o2.dat")
    therm = os.path.join(fixtures_dir, "therm.dat")
    xml = os.path.join(fixtures_dir, "h2oni.xml")
    gm_j = br.compile_gaschemistry(path)
    th_j = br.create_thermo(list(gm_j.species), therm)
    gm_t = bt.compile_gaschemistry(path, device="cpu")
    th_t = bt.create_thermo(list(gm_t.species), therm, device="cpu")
    return (gm_j, th_j, compile_mech_j(xml, th_j, list(gm_j.species)),
            gm_t, th_t, bt.compile_mech(xml, th_t, list(gm_t.species),
                                        device="cpu"))


@pytest.fixture(scope="module")
def ch4ni7(fixtures_dir):
    """The batch_surf configuration: CH4/Ni over 7 gas species, no gas
    mechanism, both packages."""
    therm = os.path.join(fixtures_dir, "therm.dat")
    xml = os.path.join(fixtures_dir, "ch4ni.xml")
    th_j = br.create_thermo(GAS7, therm)
    th_t = bt.create_thermo(GAS7, therm, device="cpu")
    return (th_j, compile_mech_j(xml, th_j, GAS7),
            th_t, bt.compile_mech(xml, th_t, GAS7, device="cpu"))


def _assert_sweeps_agree(out, ref, surface):
    np.testing.assert_array_equal(out["status"], ref["status"])
    assert out["report"]["counts"] == ref["report"]["counts"]
    for s, xj in ref["x"].items():
        big = xj > 1e-6
        np.testing.assert_allclose(out["x"][s][big], xj[big], rtol=10 * RTOL,
                                   err_msg=s)
    np.testing.assert_array_equal(out["t"], ref["t"])
    if surface:
        np.testing.assert_allclose(out["covg"], ref["covg"], rtol=10 * RTOL,
                                   atol=1e-12)
        np.testing.assert_allclose(out["covg"].sum(axis=1), 1.0, atol=1e-6)
    else:
        assert "covg" not in out
    print("accepted (port, jax):", out["report"]["n_accepted"],
          ref["report"]["n_accepted"])


def test_coupled_asv_sweep_matches_jax(h2oni):
    """The coupled catalyst-loading sweep: per-lane Asv over four decades,
    h2o2 gas chemistry with H2O/Ni surface chemistry, 1e-4 s."""
    gm_j, th_j, sm_j, gm_t, th_t, sm_t = h2oni
    ref = br.batch_reactor_sweep(
        COMP_H2, 1050.0, 1e5, 1e-4,
        chem=br.Chemistry(surfchem=True, gaschem=True), thermo_obj=th_j,
        gmd=gm_j, smd=sm_j, Asv=jnp.asarray(ASV), ignition_marker="H2")
    out = bt.batch_reactor_sweep(
        COMP_H2, 1050.0, 1e5, 1e-4,
        chem=bt.Chemistry(surfchem=True, gaschem=True), thermo_obj=th_t,
        gmd=gm_t, smd=sm_t, Asv=np.asarray(ASV), ignition_marker="H2",
        device="cpu")
    assert out["report"]["counts"] == {"success": 4}
    _assert_sweeps_agree(out, ref, surface=True)
    np.testing.assert_array_equal(np.isnan(out["tau"]), np.isnan(ref["tau"]))
    # more catalyst area moves the gas state further from the Asv=1 lane
    depart = np.abs(out["x"]["H2O"] - out["x"]["H2O"][0])
    assert np.all(np.diff(depart) > 0)


def test_surface_sweep_matches_jax(ch4ni7):
    """batch_surf widened: CH4 steam reforming on Ni over 4 temperatures."""
    th_j, sm_j, th_t, sm_t = ch4ni7
    T = np.linspace(1023.0, 1223.0, 4)
    ref = br.batch_reactor_sweep(COMP7, jnp.asarray(T), 1e5, 1e-3,
                                 chem=br.Chemistry(surfchem=True),
                                 thermo_obj=th_j, md=sm_j, Asv=10.0)
    out = bt.batch_reactor_sweep(COMP7, T, 1e5, 1e-3,
                                 chem=bt.Chemistry(surfchem=True),
                                 thermo_obj=th_t, smd=sm_t, Asv=10.0,
                                 device="cpu")
    assert out["report"]["counts"] == {"success": 4}
    _assert_sweeps_agree(out, ref, surface=True)


def _udf_port(species):
    """First-order H2 decay at k(T) = T/1e5 1/s, written for the port: a
    one-hot mask in place of the JAX ``.at[].set`` update."""
    onehot = torch.zeros(len(species), dtype=torch.float64)
    onehot[list(species).index("H2")] = 1.0

    def udf(t, state):
        c = state["mole_frac"] * state["p"] / (8.314472 * state["T"])
        return -(state["T"] / 1e5) * c * onehot

    return udf


def _udf_jax(species):
    i_h2 = list(species).index("H2")

    def udf(t, state):
        c = state["mole_frac"] * state["p"] / (8.314472 * state["T"])
        k = state["T"] / 1e5
        return jnp.zeros_like(c).at[i_h2].set(-k * c[i_h2])

    return udf


def test_udf_sweep_matches_jax_and_closed_form(h2oni):
    _, th_j, _, _, th_t, _ = h2oni
    T = [1000.0, 2000.0]
    comp = {"H2": 0.25, "O2": 0.25, "N2": 0.5}
    ref = br.batch_reactor_sweep(
        comp, jnp.asarray(T), 1e5, 5.0,
        chem=br.Chemistry(userchem=True, udf=_udf_jax(th_j.species)),
        thermo_obj=th_j)
    out = bt.batch_reactor_sweep(
        comp, T, 1e5, 5.0,
        chem=bt.Chemistry(userchem=True, udf=_udf_port(th_t.species)),
        thermo_obj=th_t, device="cpu")
    assert out["report"]["counts"] == {"success": 2}
    _assert_sweeps_agree(out, ref, surface=False)
    for lane, Tk in enumerate(T):
        f = 0.25 * math.exp(-Tk / 1e5 * 5.0)
        assert out["x"]["H2"][lane] == pytest.approx(f / (0.75 + f),
                                                     rel=1e-3)


def test_programmatic_surface_form_matches_jax(ch4ni7):
    th_j, sm_j, th_t, sm_t = ch4ni7
    ts_j, x_j = br.batch_reactor(COMP7, 1073.15, 1e5, 1e-3, Asv=10.0,
                                 chem=br.Chemistry(surfchem=True),
                                 thermo_obj=th_j, md=sm_j, jac_window=1)
    ts_t, x_t = bt.batch_reactor(COMP7, 1073.15, 1e5, 1e-3, Asv=10.0,
                                 chem=bt.Chemistry(surfchem=True),
                                 thermo_obj=th_t, md=sm_t, device="cpu")
    assert ts_t[-1] == pytest.approx(1e-3, rel=1e-14)
    assert len(ts_t) == len(ts_j)
    for s, v in x_j.items():
        if v > 1e-6:
            assert x_t[s] == pytest.approx(v, rel=10 * RTOL), s


_SURF_XML = """<batch>
 <gasphase>CH4 H2O H2 CO CO2 O2 N2</gasphase>
 <surface_mech>ch4ni.xml</surface_mech>
 <molefractions>CH4=0.25,H2O=0.25,N2=0.5</molefractions>
 <T>1073.15</T><p>1e5</p><Asv>10</Asv><time>{t1}</time>
</batch>"""


def _csv(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[0].split(","), np.array([float(v) for v in
                                          lines[-1].split(",")]), len(lines)


def test_file_driven_surface_matches_jax(tmp_path, fixtures_dir):
    for sub in ("jax", "port"):
        (tmp_path / sub).mkdir()
        (tmp_path / sub / "batch.xml").write_text(_SURF_XML.format(t1=1e-3))
    assert br.batch_reactor(str(tmp_path / "jax" / "batch.xml"), fixtures_dir,
                            surfchem=True, verbose=False) == "Success"
    assert bt.batch_reactor(str(tmp_path / "port" / "batch.xml"),
                            fixtures_dir, surfchem=True, verbose=False,
                            device="cpu") == "Success"
    for name in ("gas_profile.csv", "surface_covg.csv"):
        head_j, row_j, _ = _csv(tmp_path / "jax" / name)
        head_t, row_t, _ = _csv(tmp_path / "port" / name)
        assert head_t == head_j, name
        big = np.abs(row_j) > 1e-6
        np.testing.assert_allclose(row_t[big], row_j[big], rtol=10 * RTOL,
                                   err_msg=name)
        assert (tmp_path / "port" / name.replace(".csv", ".dat")).is_file()
    head, row, _ = _csv(tmp_path / "port" / "surface_covg.csv")
    assert head[:3] == ["t", "T", "(NI)"]
    assert abs(row[2:].sum() - 1.0) < 1e-6


def test_file_driven_udf_form_matches_jax(tmp_path, fixtures_dir):
    """``batch_reactor(xml, lib_dir, udf)``: the species come from
    ``<gasphase>``, the source from the UDF."""
    xml = ("<batch><gasphase>H2 O2 N2</gasphase>"
           "<molefractions>H2=0.25,O2=0.25,N2=0.5</molefractions>"
           "<T>1500.0</T><p>1e5</p><time>2.0</time></batch>")
    for sub in ("jax", "port"):
        (tmp_path / sub).mkdir()
        (tmp_path / sub / "batch.xml").write_text(xml)
    species = ("H2", "O2", "N2")
    assert br.batch_reactor(str(tmp_path / "jax" / "batch.xml"), fixtures_dir,
                            _udf_jax(species), verbose=False) == "Success"
    assert bt.batch_reactor(str(tmp_path / "port" / "batch.xml"),
                            fixtures_dir, _udf_port(species), verbose=False,
                            device="cpu") == "Success"
    head_j, row_j, _ = _csv(tmp_path / "jax" / "gas_profile.csv")
    head_t, row_t, _ = _csv(tmp_path / "port" / "gas_profile.csv")
    assert head_t == head_j
    np.testing.assert_allclose(row_t, row_j, rtol=10 * RTOL)
    assert not (tmp_path / "port" / "surface_covg.csv").exists()


def test_segment_driver_carries_asv_and_coverages(ch4ni7):
    """Per-lane Asv in ``cfgs`` and the (B, ng + ns) state go untouched
    through park, budget and drain: segmented == one segment bit for bit
    at jac_window=1, the drained rows keep the full state width, and the
    budget's report names the exhausted lanes' Asv."""
    _, _, th_t, sm_t = ch4ni7
    x0 = np.zeros(7)
    for k, v in COMP7.items():
        x0[GAS7.index(k)] = v
    y0 = bt.get_solution_vector(np.broadcast_to(x0, (4, 7)), th_t.molwt,
                                1073.15, 1e5, ini_covg=sm_t.ini_covg)
    assert y0.shape == (4, 20)
    asv = torch.tensor(ASV, dtype=torch.float64)
    cfgs = {"T": torch.full((4,), 1073.15, dtype=torch.float64), "Asv": asv}
    rhs, jac = make_surface_rhs(sm_t, th_t), make_surface_jac(sm_t, th_t)
    kw = dict(rtol=RTOL, atol=1e-10, jac=jac, linsolve="lu", n_save=8)
    one = ensemble_solve_segmented(rhs, y0, 0.0, 2e-4, cfgs,
                                   segment_steps=5000, max_segments=1, **kw)
    seg = ensemble_solve_segmented(rhs, y0, 0.0, 2e-4, cfgs, segment_steps=5,
                                   **kw)
    assert torch.equal(cfgs["Asv"], torch.tensor(ASV, dtype=torch.float64))
    assert torch.equal(seg.y, one.y)
    assert torch.equal(seg.ys, one.ys) and seg.ys.shape == (4, 8, 20)
    np.testing.assert_array_equal(seg.n_accepted, one.n_accepted)
    assert torch.all(seg.status == SUCCESS)
    # a budget between the smallest and largest lane's attempts
    attempts = (one.n_accepted + one.n_rejected).numpy()
    budget = int(np.sort(attempts)[1]) + 1
    cut = ensemble_solve_segmented(rhs, y0, 0.0, 2e-4, cfgs, segment_steps=5,
                                   max_attempts=budget, **kw)
    exhausted = attempts >= budget
    assert exhausted.any() and not exhausted.all()
    np.testing.assert_array_equal(cut.status.numpy() == MAX_STEPS_REACHED,
                                  exhausted)
    assert torch.equal(cut.y[~torch.tensor(exhausted)],
                       one.y[~torch.tensor(exhausted)])
    rep = sweep_report(cut, cfgs)
    assert rep["failed_lanes"] == np.nonzero(exhausted)[0].tolist()
    assert rep["failed_conditions"]["Asv"] == np.asarray(ASV)[
        exhausted].tolist()


def test_auto_linsolve_resolves_on_the_state_width(monkeypatch, h2oni):
    """``linsolve="auto"`` sees the whole state: n = ng + ns and the
    surface species count.  On the GPU a state with coverages resolves to
    the float64 ``"lu"``; a gas state of the same width to ``"lu32p"``."""
    _, _, _, gm_t, th_t, sm_t = h2oni
    seen = []

    def spy(linsolve, **kw):
        seen.append((kw["n"], kw["n_surface"]))
        return "lu"

    monkeypatch.setattr(api, "resolve_linsolve", spy)
    out = bt.batch_reactor_sweep(
        COMP_H2, 1050.0, 1e5, 1e-7,
        chem=bt.Chemistry(surfchem=True, gaschem=True), thermo_obj=th_t,
        gmd=gm_t, smd=sm_t, device="cpu")
    ns = sm_t.n_surface_species
    assert seen == [(gm_t.n_species + ns, ns)]
    assert out["covg"].shape == (1, ns)
    # the rule at the coupled GRI-3.0 + CH4/Ni width, B = 1024
    assert resolve_linsolve("auto", device="cuda", batch=1024, n=66,
                            n_surface=13) == "lu"
    assert resolve_linsolve("auto", device="cuda", batch=1024,
                            n=66) == "lu32p"
    assert resolve_linsolve("lu32p", device="cuda", batch=1024, n=66,
                            n_surface=13) == "lu32p"


@pytest.mark.parametrize("asv", [10.0, np.array([10.0]), torch.tensor(10.0),
                                 torch.tensor([10.0, 10.0])],
                         ids=["float", "array1", "tensor0", "tensor2"])
def test_asv_scalar_or_per_lane(ch4ni7, asv):
    _, _, th_t, sm_t = ch4ni7
    out = bt.batch_reactor_sweep(COMP7, [1073.15, 1073.15], 1e5, 1e-9,
                                 chem=bt.Chemistry(surfchem=True),
                                 thermo_obj=th_t, md=sm_t, Asv=asv,
                                 device="cpu")
    assert out["report"]["counts"] == {"success": 2}
    np.testing.assert_array_equal(out["covg"][0], out["covg"][1])


# (call kind, chem flags, which mechanisms are passed): every guard of the
# chemistry-mode dispatch
GUARDS = {
    "userchem_exclusive": ("sweep", dict(userchem=True, gaschem=True,
                                         udf="udf"), ()),
    "udf_without_flag": ("sweep", dict(gaschem=True, udf="udf"), ("md",)),
    "coupled_md_only": ("sweep", dict(gaschem=True, surfchem=True), ("md",)),
    "coupled_no_smd": ("sweep", dict(gaschem=True, surfchem=True), ("gmd",)),
    "surf_with_gmd": ("sweep", dict(surfchem=True), ("smd", "gmd")),
    "surf_no_mech": ("sweep", dict(surfchem=True), ()),
    "gas_with_smd": ("sweep", dict(gaschem=True), ("md", "smd")),
    "gas_no_mech": ("sweep", dict(gaschem=True), ()),
    "udf_missing": ("sweep", dict(userchem=True), ()),
    "udf_with_mech": ("sweep", dict(userchem=True, udf="udf"), ("md",)),
    "no_chemistry": ("sweep", dict(), ("md",)),
    "programmatic_both": ("run", dict(gaschem=True, surfchem=True), ("md",)),
    "programmatic_none": ("run", dict(), ("md",)),
}


@pytest.mark.parametrize("name", list(GUARDS))
def test_chemistry_guards_raise_as_jax(h2oni, name):
    gm_j, th_j, sm_j, gm_t, th_t, sm_t = h2oni
    kind, flags, mechs = GUARDS[name]
    results = []
    for pkg, gm, th, sm, dev in ((br, gm_j, th_j, sm_j, {}),
                                 (bt, gm_t, th_t, sm_t, {"device": "cpu"})):
        fl = dict(flags)
        if fl.get("udf"):
            fl["udf"] = (_udf_jax if pkg is br else _udf_port)(th.species)
        chem = pkg.Chemistry(**fl)
        given = {"md": gm, "gmd": gm, "smd": sm}
        kw = {k: given[k] for k in mechs}
        with pytest.raises((TypeError, ValueError)) as e:
            if kind == "sweep":
                pkg.batch_reactor_sweep(COMP_H2, 1050.0, 1e5, 1e-6,
                                        chem=chem, thermo_obj=th, **kw, **dev)
            else:
                pkg.batch_reactor(COMP_H2, 1050.0, 1e5, 1e-6, chem=chem,
                                  thermo_obj=th, **kw, **dev)
        results.append((e.type, str(e.value)))
    assert results[1] == results[0]


def test_coupled_species_order_guard(h2oni, fixtures_dir):
    _, _, _, gm_t, _, sm_t = h2oni
    th_rev = bt.create_thermo(list(gm_t.species)[::-1],
                              os.path.join(fixtures_dir, "therm.dat"),
                              device="cpu")
    with pytest.raises(ValueError, match="must match in order"):
        bt.batch_reactor_sweep(COMP_H2, 1050.0, 1e5, 1e-6,
                               chem=bt.Chemistry(gaschem=True, surfchem=True),
                               thermo_obj=th_rev, gmd=gm_t, smd=sm_t,
                               device="cpu")
