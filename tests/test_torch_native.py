"""Port parity: the native (C++) runtime (batchreactor_tpu_torch/native)
against the JAX package's ``native/``, on the CPU.

Both packages build the same C++ runtime (the port keeps its own copy of
``br_native.cpp``) and load it with ctypes; the port packs its structs
from mechanism tensors.  The tests mirror ``tests/test_native.py``: the
same inputs, made from a seed with numpy, go through both packages'
bindings.  Per-call RHS values agree to 1e-12 relative and solve
observables at the rtol scale.  Also: the packed struct arrays are equal,
the native gas RHS equals the port's torch RHS to 1e-12, the build writes
nothing beside either package's source, a failed build raises
``NativeUnavailable``, and ``batch_reactor(backend="cpu")`` runs every
chemistry mode as the JAX package's does, with its three errors.
"""

import ctypes
import os
import pathlib
import re
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import batchreactor_tpu as br
import batchreactor_tpu_torch as bt
from batchreactor_tpu import native as native_j
from batchreactor_tpu.io.config import input_data as input_data_j
from batchreactor_tpu.native import bindings as bindings_j
from batchreactor_tpu_torch import native
from batchreactor_tpu_torch.io.config import input_data
from batchreactor_tpu_torch.native import bindings
from batchreactor_tpu_torch.ops.rhs import make_gas_rhs

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
RTOL = 1e-6
DEFAULT_BUILD_DIR = bindings._BUILD_DIR


def _rel(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-300)


def _mechs(fixtures_dir, mech, tmp_path=None, text=None):
    """(gm_j, th_j, gm_t, th_t) of a fixture mechanism, or of ``text``
    written to ``tmp_path``."""
    if text is not None:
        path = tmp_path / "mech.dat"
        path.write_text(text)
        mech = str(path)
    else:
        mech = os.path.join(fixtures_dir, mech)
    therm = os.path.join(fixtures_dir, "therm.dat")
    gm_j = br.compile_gaschemistry(mech)
    gm_t = bt.compile_gaschemistry(mech, device="cpu")
    return (gm_j, br.create_thermo(list(gm_j.species), therm), gm_t,
            bt.create_thermo(list(gm_t.species), therm, device="cpu"))


@pytest.fixture(scope="module")
def h2o2(fixtures_dir):
    return _mechs(fixtures_dir, "h2o2.dat")


@pytest.fixture(scope="module")
def gri(fixtures_dir):
    return _mechs(fixtures_dir, "grimech.dat")


def _initial_state(gm_t, th_t, comp, T, p=1e5):
    sp = list(gm_t.species)
    x0 = np.zeros(len(sp))
    for name, frac in comp.items():
        x0[sp.index(name)] = frac
    y0 = bt.get_solution_vector(x0, th_t.molwt, T, p).numpy()
    return y0, float(y0.sum())


def _dirty(y0, rho, seed):
    """``y0`` with every species present, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return y0 + rho * 1e-6 * rng.random(y0.shape[0])


def _same_rhs(gm_j, th_j, gm_t, th_t, T, y, kc_compat=False):
    d_t = native.gas_rhs(gm_t, th_t, T, y, kc_compat=kc_compat)
    d_j = native_j.gas_rhs(gm_j, th_j, T, y, kc_compat=kc_compat)
    assert _rel(d_t, d_j).max() <= 1e-12
    return d_t


# ----------------------------------------------------------- the RHS
@pytest.mark.parametrize("kc_compat", [False, True])
def test_gas_rhs_matches_jax_gri(gri, kc_compat):
    """GRI-3.0 exercises the falloff, TROE, third-body and duplicate
    paths; a dirtied state every reaction channel."""
    gm_j, th_j, gm_t, th_t = gri
    y0, rho = _initial_state(gm_t, th_t,
                             {"CH4": 0.25, "O2": 0.5, "N2": 0.25}, 1500.0)
    _same_rhs(gm_j, th_j, gm_t, th_t, 1500.0, _dirty(y0, rho, 42),
              kc_compat)


def test_gas_rhs_matches_jax_h2o2(h2o2):
    gm_j, th_j, gm_t, th_t = h2o2
    y0, _ = _initial_state(gm_t, th_t, {"H2": 0.25, "O2": 0.25, "N2": 0.5},
                           1173.0)
    _same_rhs(gm_j, th_j, gm_t, th_t, 1173.0, y0)


@pytest.mark.parametrize("mech", ["h2o2.dat", "grimech.dat"])
def test_native_rhs_matches_the_torch_rhs(fixtures_dir, h2o2, gri, mech):
    """The native gas RHS against the port's own torch RHS on the CPU,
    over a batch of seeded states: 1e-12 relative."""
    _, _, gm_t, th_t = h2o2 if mech == "h2o2.dat" else gri
    sp = list(gm_t.species)
    fuel = {"H2": 0.25, "O2": 0.25, "N2": 0.5} if "H2O2" in sp else {
        "CH4": 0.25, "O2": 0.5, "N2": 0.25}
    rhs = make_gas_rhs(gm_t, th_t)
    for seed, T in enumerate((1000.0, 1500.0, 2000.0)):
        y0, rho = _initial_state(gm_t, th_t, fuel, T)
        y = _dirty(y0, rho, seed)
        d_n = native.gas_rhs(gm_t, th_t, T, y)
        d_t = rhs(0.0, torch.from_numpy(y)[None],
                  {"T": torch.tensor([T], dtype=torch.float64)})[0].numpy()
        scale = np.abs(d_t).max()
        np.testing.assert_allclose(d_n, d_t, rtol=1e-12,
                                   atol=1e-12 * scale)


_MINI = ("ELEMENTS\nH O N\nEND\nSPECIES\nH2 O2 OH H2O N2\nEND\n"
         "REACTIONS\n{}END\n")


def test_gas_rhs_rev_and_negative_A_matches_jax(tmp_path, fixtures_dir):
    """REV rows and negative-A DUPLICATE rows."""
    m = _mechs(fixtures_dir, None, tmp_path, _MINI.format(
        "H2+O2=2OH   4.0E13  0.5  1000.\n"
        "REV /2.0E11  0.3  500./\n"
        "2OH=H2O+O2  1.0E12  0.0  300.\n"
        "H2+O2=>2OH   3.0E13  0.0  1500.\n"
        "DUPLICATE\n"
        "H2+O2=>2OH  -1.0E12  0.0  2500.\n"
        "DUPLICATE\n"))
    _same_rhs(*m, 1200.0, np.array([0.05, 0.4, 0.01, 0.02, 0.6]))


def test_gas_rhs_plog_matches_jax(tmp_path, fixtures_dir):
    """PLOG at pressures below, inside and above the table."""
    m = _mechs(fixtures_dir, None, tmp_path, _MINI.format(
        "H2+O2=2OH   1.0E13  0.0  1000.\n"
        "PLOG / 0.1   1.0E12  0.5  900. /\n"
        "PLOG / 1.0   1.0E13  0.2  1100. /\n"
        "PLOG / 10.0  1.0E14  0.0  1300. /\n"
        "2OH=H2O+O2  1.0E12  0.0  300.\n"))
    for scale in (0.05, 1.0, 40.0):
        _same_rhs(*m, 1100.0, np.array([0.05, 0.4, 0.01, 0.02, 0.6]) * scale)


def test_gas_rhs_cheb_matches_jax(tmp_path, fixtures_dir):
    """Chebyshev tables inside and outside their window."""
    m = _mechs(fixtures_dir, None, tmp_path, _MINI.format(
        "H2+O2=2OH   1.0 0.0 0.0\n"
        "TCHEB / 500. 2000. /\n"
        "PCHEB / 0.1 10. /\n"
        "CHEB / 3 4 7.0 0.5 -0.1 0.05 -0.3 0.1 0.02 -0.01 "
        "0.04 -0.02 0.01 0.005 /\n"
        "2OH=H2O+O2  1.0E12  0.0  300.\n"))
    for scale in (0.001, 1.0, 50.0):
        _same_rhs(*m, 1100.0, np.array([0.05, 0.4, 0.01, 0.02, 0.6]) * scale)


@pytest.mark.parametrize("mech", ["h2o2.dat", "grimech.dat"])
def test_packed_structs_equal_jax(h2o2, gri, mech):
    """The port's packed arrays (from tensors) equal the JAX package's
    (from jax arrays), field by field, for the gas and the surface
    structs."""
    gm_j, th_j, gm_t, th_t = h2o2 if mech == "h2o2.dat" else gri
    for kc in (False, True):
        m_t, keep_t = bindings._pack_mech(gm_t, th_t, kc)
        m_j, keep_j = bindings_j._pack_mech(gm_j, th_j, kc)
        assert len(keep_t) == len(keep_j)
        for a, b in zip(keep_t, keep_j):
            np.testing.assert_array_equal(a, b)
        for name, _ in m_t._fields_:
            if not isinstance(getattr(m_t, name), ctypes._Pointer):
                assert getattr(m_t, name) == getattr(m_j, name), name


def test_packed_surface_struct_equals_jax(surf):
    id_j, id_t = surf
    m_t, keep_t = bindings._pack_surf(id_t.smd, id_t.thermo.molwt)
    m_j, keep_j = bindings_j._pack_surf(id_j.smd, np.asarray(
        id_j.thermo.molwt))
    for a, b in zip(keep_t, keep_j):
        np.testing.assert_array_equal(a, b)
    for name in ("R", "Sg", "Ss", "site_density", "int_expo"):
        assert getattr(m_t, name) == getattr(m_j, name), name


# ----------------------------------------------------------- the BDF
def test_bdf_matches_jax_h2o2(h2o2):
    """The full 10 s burnout: status, final time and state at the rtol
    scale (the same runtime on the same inputs), mass exactly conserved."""
    gm_j, th_j, gm_t, th_t = h2o2
    y0, rho = _initial_state(gm_t, th_t,
                             {"H2": 0.25, "O2": 0.25, "N2": 0.5}, 1173.0)
    res = native.solve_gas_bdf(gm_t, th_t, 1173.0, y0, 0.0, 10.0)
    ref = native_j.solve_gas_bdf(gm_j, th_j, 1173.0, y0, 0.0, 10.0)
    assert res.status == ref.status == "Success"
    assert res.t == pytest.approx(10.0) and res.t == ref.t
    np.testing.assert_allclose(res.y, ref.y, rtol=10 * RTOL, atol=rho * 1e-12)
    assert abs(res.y.sum() - rho) / rho < 1e-12
    print("accepted (port, jax):", res.n_accepted, ref.n_accepted)


def test_bdf_matches_jax_gri_ignition(gri):
    """Through a GRI-3.0 ignition transient: the major species at the
    rtol scale."""
    gm_j, th_j, gm_t, th_t = gri
    y0, rho = _initial_state(gm_t, th_t,
                             {"CH4": 0.25, "O2": 0.5, "N2": 0.25}, 1500.0)
    res = native.solve_gas_bdf(gm_t, th_t, 1500.0, y0, 0.0, 8e-4)
    ref = native_j.solve_gas_bdf(gm_j, th_j, 1500.0, y0, 0.0, 8e-4)
    assert res.status == ref.status == "Success"
    major = ref.y > rho * 1e-6
    assert _rel(res.y[major], ref.y[major]).max() <= 10 * RTOL


def test_trajectory_buffer(h2o2):
    gm_j, th_j, gm_t, th_t = h2o2
    y0, _ = _initial_state(gm_t, th_t, {"H2": 0.25, "O2": 0.25, "N2": 0.5},
                           1173.0)
    res = native.solve_gas_bdf(gm_t, th_t, 1173.0, y0, 0.0, 1e-3,
                               n_save=10_000)
    ref = native_j.solve_gas_bdf(gm_j, th_j, 1173.0, y0, 0.0, 1e-3,
                                 n_save=10_000)
    assert res.status == "Success"
    assert res.ts.shape[0] == res.n_accepted == ref.n_accepted
    assert res.ys.shape == (res.n_accepted, y0.shape[0])
    assert np.all(np.diff(res.ts) > 0) and res.ts[-1] == pytest.approx(1e-3)
    np.testing.assert_allclose(res.ys[-1], res.y, rtol=1e-12)
    np.testing.assert_allclose(res.ts, ref.ts, rtol=10 * RTOL)


def test_first_step_and_max_steps(h2o2):
    gm_j, th_j, gm_t, th_t = h2o2
    y0, _ = _initial_state(gm_t, th_t, {"H2": 0.25, "O2": 0.25, "N2": 0.5},
                           1173.0)
    res = native.solve_gas_bdf(gm_t, th_t, 1173.0, y0, 0.0, 10.0,
                               max_steps=5)
    ref = native_j.solve_gas_bdf(gm_j, th_j, 1173.0, y0, 0.0, 10.0,
                                 max_steps=5)
    assert res.status == ref.status == "MaxIters"
    assert res.t < 10.0 and res.t == pytest.approx(ref.t, rel=10 * RTOL)
    res = native.solve_gas_bdf(gm_t, th_t, 1173.0, y0, 0.0, 1e-3,
                               first_step=1e-9, n_save=4)
    ref = native_j.solve_gas_bdf(gm_j, th_j, 1173.0, y0, 0.0, 1e-3,
                                 first_step=1e-9, n_save=4)
    assert res.ts[0] == pytest.approx(1e-9) and res.ts[0] == ref.ts[0]


def _rob_np(t, y):
    d1 = -0.04 * y[0] + 1e4 * y[1] * y[2]
    d3 = 3e7 * y[1] * y[1]
    return np.array([d1, -d1 - d3, d3])


def _rob_torch(t, y):
    d1 = -0.04 * y[0] + 1e4 * y[1] * y[2]
    d3 = 3e7 * y[1] * y[1]
    return torch.stack([d1, -d1 - d3, d3])


def test_generic_bdf_torch_callback_robertson():
    """The generic BDF over a torch RHS on the canonical stiff problem,
    against the JAX package's over the numpy RHS."""
    y0 = np.array([1.0, 0.0, 0.0])
    res = native.solve_bdf(_rob_torch, y0, 0.0, 1e5, rtol=1e-8, atol=1e-12)
    ref = native_j.solve_bdf(_rob_np, y0, 0.0, 1e5, rtol=1e-8, atol=1e-12)
    assert res.status == ref.status == "Success"
    np.testing.assert_allclose(res.y, ref.y, rtol=1e-7, atol=1e-14)
    assert res.n_accepted == ref.n_accepted


def test_generic_bdf_propagates_the_rhs_error():
    def bad(t, y):
        raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        native.solve_bdf(bad, np.array([1.0]), 0.0, 1.0)
    with pytest.raises(ValueError, match="shape"):
        native.solve_bdf(lambda t, y: torch.zeros(2), np.array([1.0]), 0.0,
                         1.0)


# ------------------------------------------------------------ surfaces
_COUPLED_XML = ("<batch><gas_mech>h2o2.dat</gas_mech>"
                "<surface_mech>h2oni.xml</surface_mech>"
                "<molefractions>H2=0.3,O2=0.2,N2=0.5</molefractions>"
                "<T>1050.0</T><p>1e5</p><Asv>10</Asv><time>{t1}</time>"
                "</batch>")


@pytest.fixture(scope="module")
def surf(tmp_path_factory, fixtures_dir):
    d = tmp_path_factory.mktemp("surf")
    xml = d / "batch.xml"
    xml.write_text(_COUPLED_XML.format(t1=1e-4))
    return (input_data_j(str(xml), fixtures_dir,
                         br.Chemistry(surfchem=True, gaschem=True)),
            input_data(str(xml), fixtures_dir,
                       bt.Chemistry(surfchem=True, gaschem=True),
                       device="cpu"))


def test_surface_rates_match_jax(surf):
    id_j, id_t = surf
    x = np.asarray(id_t.mole_fracs)
    theta = id_t.smd.ini_covg.numpy()
    sg_t, ss_t = native.surface_rates(id_t.smd, id_t.T, id_t.p, x, theta)
    sg_j, ss_j = native_j.surface_rates(id_j.smd, id_j.T, id_j.p, x, theta)
    np.testing.assert_allclose(sg_t, sg_j, rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(ss_t, ss_j, rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("coupled", [False, True])
def test_surf_rhs_matches_jax(surf, coupled):
    id_j, id_t = surf
    y0 = bt.get_solution_vector(id_t.mole_fracs, id_t.thermo.molwt, id_t.T,
                                id_t.p, ini_covg=id_t.smd.ini_covg).numpy()
    d_t = native.surf_rhs(id_t.smd, id_t.thermo, id_t.T, id_t.Asv, y0,
                          gm=id_t.gmd if coupled else None)
    d_j = native_j.surf_rhs(id_j.smd, id_j.thermo, id_j.T, id_j.Asv, y0,
                            gm=id_j.gmd if coupled else None)
    scale = np.abs(d_j).max()
    np.testing.assert_allclose(d_t, d_j, rtol=1e-12, atol=1e-12 * scale)


def test_solve_surf_bdf_matches_jax(surf):
    id_j, id_t = surf
    y0 = bt.get_solution_vector(id_t.mole_fracs, id_t.thermo.molwt, id_t.T,
                                id_t.p, ini_covg=id_t.smd.ini_covg).numpy()
    for gm_t, gm_j in ((None, None), (id_t.gmd, id_j.gmd)):
        res = native.solve_surf_bdf(id_t.smd, id_t.thermo, id_t.T, id_t.Asv,
                                    y0, 0.0, 1e-4, gm=gm_t)
        ref = native_j.solve_surf_bdf(id_j.smd, id_j.thermo, id_j.T,
                                      id_j.Asv, y0, 0.0, 1e-4, gm=gm_j)
        assert res.status == ref.status == "Success"
        np.testing.assert_allclose(res.y, ref.y, rtol=10 * RTOL,
                                   atol=1e-12)


# ------------------------------------------------------- source, build
def _code(path):
    """The C++ source without its comments or blank lines."""
    text = re.sub(r"//[^\n]*", "", pathlib.Path(path).read_text())
    return [ln.rstrip() for ln in text.splitlines() if ln.strip()]


def test_native_source_is_the_jax_runtime():
    """The port's ``br_native.cpp`` is the JAX package's runtime: the same
    code line for line; only comments may differ."""
    port = ROOT / "batchreactor_tpu_torch" / "native" / "br_native.cpp"
    ref = ROOT / "batchreactor_tpu" / "native" / "br_native.cpp"
    assert _code(port) == _code(ref)
    assert len(port.read_text().splitlines()) == len(
        ref.read_text().splitlines())


def _tree(path):
    """Every file under ``path``, except bytecode caches and the JAX
    package's own build of its runtime (its tests may build it beside its
    source at any moment)."""
    return sorted(str(p.relative_to(path)) for p in path.rglob("*")
                  if "__pycache__" not in p.parts
                  and not p.name.startswith("libbr_native-"))


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """An unloaded library and an empty build directory; the loaded
    library comes back after the test."""
    monkeypatch.setattr(bindings, "_lib", None)
    monkeypatch.setattr(bindings, "_BUILD_DIR", str(tmp_path / "native"))
    return tmp_path / "native"


def test_build_writes_only_into_the_build_directory(fresh_build):
    pkgs = [ROOT / "batchreactor_tpu_torch", ROOT / "batchreactor_tpu"]
    before = [_tree(p) for p in pkgs]
    lib = bindings.load_library()
    assert lib is bindings.load_library()       # cached per process
    assert [_tree(p) for p in pkgs] == before
    built = os.listdir(fresh_build)
    assert built == [os.path.basename(bindings.library_path())]
    for pkg in pkgs:
        assert not list(pkg.rglob(built[0] + "*")), pkg
    assert re.fullmatch(r"libbr_native-[0-9a-f]{12}\.so", built[0])
    assert bindings.BUILD_INFO["seconds"] > 0
    # by default the library builds into the checkout's build/native
    assert DEFAULT_BUILD_DIR == str(ROOT / "build" / "native")


def test_a_failed_build_raises_not_warns(fresh_build, tmp_path,
                                         monkeypatch):
    bad = tmp_path / "br_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(bindings, "_SRC", str(bad))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(native.NativeUnavailable, match="g\\+\\+ build"):
            native.load_library()
        assert not native.available()
    monkeypatch.setenv("PATH", str(tmp_path))   # no g++ at all
    monkeypatch.setattr(bindings, "_SRC", str(
        ROOT / "batchreactor_tpu_torch" / "native" / "br_native.cpp"))
    with pytest.raises(native.NativeUnavailable, match="g\\+\\+"):
        native.load_library()
    assert not os.listdir(fresh_build)


# ------------------------------------------------- backend="cpu"
_H2O2_XML = ("<batch><gas_mech>h2o2.dat</gas_mech>"
             "<molefractions>H2=0.25,O2=0.25,N2=0.5</molefractions>"
             "<T>1173.0</T><p>1e5</p><time>{t1}</time></batch>")
_SURF_XML = ("<batch><gasphase>CH4 H2O H2 CO CO2 O2 N2</gasphase>"
             "<surface_mech>ch4ni.xml</surface_mech>"
             "<molefractions>CH4=0.25,H2O=0.25,N2=0.5</molefractions>"
             "<T>1073.15</T><p>1e5</p><Asv>10</Asv><time>1e-3</time>"
             "</batch>")
_UDF_XML = ("<batch><gasphase>H2 O2 N2</gasphase>"
            "<molefractions>H2=0.25,O2=0.25,N2=0.5</molefractions>"
            "<T>1500.0</T><p>1e5</p><time>2.0</time></batch>")


def _udf_port(t, state):
    c = state["mole_frac"] * state["p"] / (8.314472 * state["T"])
    return -(state["T"] / 1e5) * c * torch.tensor([1.0, 0.0, 0.0],
                                                  dtype=torch.float64)


def _udf_jax(t, state):
    c = state["mole_frac"] * state["p"] / (8.314472 * state["T"])
    return jnp.zeros_like(c).at[0].set(-(state["T"] / 1e5) * c[0])


def _rows(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[0].split(","), np.array([[float(v) for v in ln.split(",")]
                                          for ln in lines[1:]])


CPU_CASES = {
    "gas": (_H2O2_XML.format(t1=10.0), dict(gaschem=True), ()),
    "surf": (_SURF_XML, dict(surfchem=True), ()),
    "gas+surf": (_COUPLED_XML.format(t1=1e-4),
                 dict(gaschem=True, surfchem=True), ()),
    "udf": (_UDF_XML, {}, ("udf",)),
}


@pytest.mark.parametrize("mode", list(CPU_CASES))
def test_backend_cpu_matches_jax(tmp_path, fixtures_dir, mode):
    """``batch_reactor(backend="cpu")`` in each chemistry mode against the
    JAX package's ``backend="cpu"``: the same status, the same accepted
    times and profile rows at the rtol scale (the same native runtime;
    the UDF through each package's own RHS)."""
    xml, flags, extra = CPU_CASES[mode]
    out = {}
    for pkg, name in ((bt, "port"), (br, "jax")):
        (tmp_path / name).mkdir()
        (tmp_path / name / "batch.xml").write_text(xml)
        args = [str(tmp_path / name / "batch.xml"), fixtures_dir]
        if extra:
            args.append(_udf_port if pkg is bt else _udf_jax)
        assert pkg.batch_reactor(*args, backend="cpu", verbose=False,
                                 **flags) == "Success"
        out[name] = {f: _rows(tmp_path / name / f) for f in
                     ("gas_profile.csv", "surface_covg.csv")
                     if (tmp_path / name / f).exists()}
    assert out["port"].keys() == out["jax"].keys()
    for f, (head_t, rows_t) in out["port"].items():
        head_j, rows_j = out["jax"][f]
        assert head_t == head_j and rows_t.shape == rows_j.shape, f
        np.testing.assert_allclose(rows_t[:, 0], rows_j[:, 0],
                                   rtol=10 * RTOL, err_msg=f)
        np.testing.assert_allclose(rows_t, rows_j, rtol=10 * RTOL,
                                   atol=1e-12, err_msg=f)


def test_backend_cpu_programmatic_and_telemetry(h2o2):
    gm_j, th_j, gm_t, th_t = h2o2
    comp = {"H2": 0.25, "O2": 0.25, "N2": 0.5}
    ts_t, x_t, rep = bt.batch_reactor(comp, 1173.0, 1e5, 1e-3,
                                      chem=bt.Chemistry(gaschem=True),
                                      thermo_obj=th_t, md=gm_t,
                                      backend="cpu", telemetry=True)
    ts_j, x_j = br.batch_reactor(comp, 1173.0, 1e5, 1e-3,
                                 chem=br.Chemistry(gaschem=True),
                                 thermo_obj=th_j, md=gm_j, backend="cpu")
    np.testing.assert_allclose(ts_t, ts_j, rtol=10 * RTOL)
    for s, v in x_j.items():
        assert x_t[s] == pytest.approx(v, rel=10 * RTOL, abs=1e-14), s
    assert rep["meta"]["backend"] == "cpu"


def test_backend_cpu_errors_match_jax(tmp_path, fixtures_dir, monkeypatch):
    """The JAX package's three errors, matched by message; the port's
    options the native runtime lacks raise too, and backend="cpu" needs
    no GPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xml = tmp_path / "batch.xml"
    xml.write_text(_H2O2_XML.format(t1=1e-3))
    run = dict(gaschem=True, verbose=False)
    for kw, msg in (({"backend": "cpu", "jac_window": 2},
                     "backend='cpu' \\(the native BDF runtime\\) does not "
                     "honor it"),
                    ({"backend": "cpu", "sens": "forward"},
                     "the native BDF runtime has no sensitivity support"),
                    ({"backend": "gpu"}, "unknown backend 'gpu'")):
        with pytest.raises(ValueError, match=msg):
            br.batch_reactor(str(xml), fixtures_dir, **run, **kw)
        with pytest.raises(ValueError, match=msg):
            bt.batch_reactor(str(xml), fixtures_dir, **run, **kw)
    for kw in ({"method": "sdirk"}, {"segmented": True}, {"exp32": True},
               {"device": "cuda"}):
        with pytest.raises(ValueError, match="backend"):
            bt.batch_reactor(str(xml), fixtures_dir, backend="cpu", **run,
                             **kw)
    assert bt.batch_reactor(str(xml), fixtures_dir, backend="cpu",
                            **run) == "Success"
