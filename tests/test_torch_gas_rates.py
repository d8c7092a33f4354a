"""The gas production-rate kernel ``brtorch::gas_wdot`` on the CPU.

* Its route (``ops/gas_rates_cuda.py::takes``): CPU tensors, mechanisms
  with PLOG, Chebyshev or non-integer stoichiometry, the per-lane rate
  parameters of sensitivities and calls under ``torch.func`` transforms or
  autograd take the plain path, and each call counts ``rhs_plain`` or
  ``rhs_fused``; a mechanism too large for one block's shared memory
  reaches the launch, which raises.
* The host-side packing round-trips to the mechanism's stoichiometry.
* ``csrc/gas_rates.cu`` compiled with g++ against the mock CUDA runtime of
  ``test_torch_lu32p_host.py`` (one ``std::thread`` per CUDA thread, a
  ``std::barrier`` per block, shared memory filled with NaN), called
  through ctypes on CPU tensors, against the plain version: GRI-3.0, h2o2
  and a small mechanism with REV, negative-A duplicates, SRI and TROE
  falloff, an explicit collider and a stoichiometric coefficient of 3, at
  ragged tiles, on states with zero and negative concentrations.  It checks
  the kernel's logic, not the device compiler or its float64 functions:
  the card tests (``test_torch_gas_rates_cuda.py``) do that.

Tolerance: |wdot_kernel - wdot_plain|_k <= 1e-12 * sum_j |dnu_jk| (|rf_j| +
|rr_j|) + 1e-300, each species held to its own gross flux.  The kernel sums
Delta G, the third-body concentrations and wdot in another order than the
plain version's matrix products, and near equilibrium the net rates cancel,
so a bound scaled by wdot itself would not hold.
"""

import ctypes
import math
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from batchreactor_tpu_torch import kernels
from batchreactor_tpu_torch.models.gas import compile_gaschemistry
from batchreactor_tpu_torch.models.thermo import create_thermo
from batchreactor_tpu_torch.ops import gas_kinetics as gk
from batchreactor_tpu_torch.ops import gas_rates_cuda as gr
from batchreactor_tpu_torch.solver import graphs
from batchreactor_tpu_torch.utils.constants import P_ATM, R
from test_torch_lu32p_host import MOCK_CUDA_RUNTIME

torch.set_num_threads(1)

# REV, negative-A duplicates, Lindemann, 3- and 4-parameter TROE, 3- and
# 5-parameter SRI, efficiencies, an explicit collider, nu = 3
BREADTH_MECH = """ELEMENTS
H O N
END
SPECIES
H2 O2 OH H2O H O N2
END
REACTIONS
H2+O2=2OH   4.0E13  0.5  1000.
REV /2.0E11  0.3  500./
H2+O2=>2OH   3.0E13  0.0  1500.
DUPLICATE
H2+O2=>2OH  -1.0E12  0.0  2500.
DUPLICATE
H+O2(+M)=>OH+O(+M)   4.0E13  0.5  1000.
LOW /2.0E16  0.0  800./
SRI /0.45  797.  979./
2OH(+M)=>H2+O2(+M)  3.0E13  0.0  1200.
LOW /1.0E16  0.0  700./
SRI /0.54  201.  1024.  0.7  0.1/
H+OH(+M)=H2O(+M)  2.5E13  0.2  0.
LOW /4.0E20  -1.0  0./
TROE /0.7  100.  1500./
H2O/6.0/ N2/0.5/
2OH(+M)=H2+O2(+M)  1.0E13  0.1  300.
LOW /3.0E18  -0.5  0./
TROE /0.6  90.  2000.  5000./
H+H(+N2)=H2(+N2)  1.0E12  0.0  0.
LOW /5.0E17  -0.6  0./
O+O+M=O2+M  1.2E17  -1.0  0.
H2O/5.4/ H2/2.4/
H+O(+M)=OH(+M)  1.0E13  0.0  0.
LOW /1.0E17  -0.5  0./
3OH=H2O+O2+H  1.0E10  0.0  2000.
H2+O=H+OH  5.0E4  2.67  6290.
END
"""

MECHS = ("grimech.dat", "h2o2.dat", "breadth")


@pytest.fixture(scope="module")
def mechs(fixtures_dir, tmp_path_factory):
    out = {}
    for name in MECHS:
        path = os.path.join(fixtures_dir, name)
        if name == "breadth":
            path = str(tmp_path_factory.mktemp("breadth") / "breadth.dat")
            with open(path, "w") as fh:
                fh.write(BREADTH_MECH)
        gm = compile_gaschemistry(path, device="cpu")
        th = create_thermo(list(gm.species),
                           os.path.join(fixtures_dir, "therm.dat"),
                           device="cpu")
        out[name] = (gm, th)
    return out


def _states(gm, B, seed):
    """T (B,) in 800..2500 K and concentrations (B, S) around 1 bar with a
    zero and a small negative entry in most lanes (transient Newton
    iterates)."""
    rng = np.random.default_rng(seed)
    S = gm.n_species
    T = rng.uniform(800.0, 2500.0, B)
    x = rng.dirichlet(np.ones(S), B)
    conc = x * 1e5 / (R * T[:, None])
    for b in range(B):
        k0, k1 = rng.choice(S, 2, replace=False)
        conc[b, k0] = 0.0
        if b % 3:
            conc[b, k1] = -1e-3 * abs(conc[b, k1])
    return torch.tensor(T), torch.tensor(conc)


def gross_flux(T, conc, gm, th, kc_compat, exp32):
    """sum_j |dnu_jk| (|rf_j| + |rr_j|) (B, S) of the plain version, with
    the third-body factor that scales both."""
    kf, tb = gk.forward_rate_constants(T, conc, gm, falloff_compat=kc_compat,
                                       exp32=exp32)
    kr = gk.reverse_rate_constants(T, kf, gm, th, kc_compat, exp32=exp32)
    rf = kf * gk._stoich_prod(conc, gm.nu_f, gm.int_stoich) * tb
    rr = kr * gk._stoich_prod(conc, gm.nu_r, gm.int_stoich) * tb
    return (rf.abs() + rr.abs()) @ (gm.nu_r - gm.nu_f).abs()


def assert_within_gross_flux(got, want, flux, rel=1e-12):
    bad = (got - want).abs() > rel * flux + 1e-300
    assert not bool(bad.any()), (
        f"{int(bad.sum())} entries off; worst "
        f"{float(((got - want).abs() / (flux + 1e-300)).max()):.3e} of the "
        f"gross flux")


# --------------------------------------------------------------------------
# the packing
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", MECHS)
def test_packing_round_trips_to_the_stoichiometry(mechs, name):
    gm, _ = mechs[name]
    st = gr.structure(gm)
    assert gr.structure(gm) is st            # packed once per stoichiometry
    nu_f, nu_r, dnu = gr.dense_stoichiometry(st, gm.n_species)
    assert torch.equal(nu_f, gm.nu_f)
    assert torch.equal(nu_r, gm.nu_r)
    assert torch.equal(dnu, gm.nu_r - gm.nu_f)
    d_rows = torch.zeros_like(dnu).scatter_add_(1, st.d_idx.long(), st.d_val)
    assert torch.equal(d_rows, dnu)
    assert torch.equal(st.dn, dnu.sum(dim=1))
    order = st.order.long()
    assert torch.equal(torch.sort(order).values,
                       torch.arange(gm.n_reactions))
    kind = gr._kind(gm)[order.numpy()]
    assert (np.diff(kind) >= 0).all()
    assert all(t.dtype in (torch.int32, torch.float64) and t.is_contiguous()
               for t in st.tensors())


# --------------------------------------------------------------------------
# the route
# --------------------------------------------------------------------------
def test_cpu_calls_take_the_plain_path_and_count_it(mechs):
    gm, th = mechs["grimech.dat"]
    T, conc = _states(gm, 3, 1)
    assert gr.kernel_forms(gm)
    assert not gr.takes(T, conc, gm, th)
    graphs.reset_counts()
    wdot = gk.production_rates(T, conc, gm, th)
    assert graphs.COUNTS["rhs_plain"] == 1 and graphs.COUNTS["rhs_fused"] == 0
    assert torch.equal(wdot, gk.production_rates_plain(T, conc, gm, th))


def test_transforms_and_autograd_are_seen_on_the_inputs(mechs):
    gm, th = mechs["h2o2.dat"]
    T, conc = _states(gm, 2, 2)
    seen = []

    def probe(Tv):
        seen.append(gr._transformed([Tv, conc]))
        graphs.reset_counts()
        out = gk.production_rates(Tv, conc, gm, th)
        seen.append(graphs.COUNTS["rhs_plain"])
        return out

    torch.func.jvp(probe, (T,), (torch.ones_like(T),))
    torch.func.vmap(lambda t: probe(t[None])[0])(T)
    assert seen == [True, 1, True, 1]
    assert not gr._transformed([T, conc])
    Tg = T.clone().requires_grad_(True)
    assert gr._transformed([Tg, conc])
    with torch.no_grad():
        assert not gr._transformed([Tg, conc])
    with torch.autograd.forward_ad.dual_level():
        assert gr._transformed([T, conc])


@pytest.mark.parametrize("what", ["plog", "cheb", "non_integer",
                                  "per_lane"])
def test_mechanisms_the_kernel_does_not_cover_take_the_plain_path(mechs,
                                                                  what):
    import dataclasses

    from batchreactor_tpu_torch.sensitivity import params

    gm, th = mechs["h2o2.dat"]
    if what == "plog":
        gm = dataclasses.replace(gm, any_plog=True)
    elif what == "cheb":
        gm = dataclasses.replace(gm, any_cheb=True)
    elif what == "non_integer":
        gm = dataclasses.replace(gm, int_stoich=False)
    else:
        # forward and adjoint sensitivities with one theta row per lane
        spec = params.select(gm, reactions=(0, 1))
        theta = {k: v.expand(4, -1).clone()
                 for k, v in params.extract(gm, spec).items()}
        gm = params.apply(gm, theta, spec)
        assert gm.log_A.shape == (4, gm.n_reactions)
    assert not gr.kernel_forms(gm)


def test_a_mechanism_past_one_blocks_shared_memory_raises_at_the_launch(
        mechs):
    """Such a mechanism takes the kernel's route, and its launch raises
    before it touches a device."""
    import dataclasses

    gm, th = mechs["h2o2.dat"]
    R_big = 40_000
    assert gr.launch_config(1, gm.n_species, R_big) is None
    big = dataclasses.replace(
        gm, nu_f=torch.zeros(R_big, gm.n_species, dtype=torch.float64))
    assert gr.kernel_forms(big)
    T, conc = _states(gm, 2, 4)
    packed = gr.structure(gm).tensors()
    packed[0] = torch.zeros(R_big, dtype=torch.int32)     # the order
    with pytest.raises(ValueError, match="shared memory"):
        gr._gas_wdot_launch(T, conc, gr._parameters(gm, th), packed, False,
                            False, False)


def test_the_operator_on_the_cpu_is_the_plain_version(mechs):
    gm, th = mechs["breadth"]
    T, conc = _states(gm, 5, 3)
    for kc in (False, True):
        got = gr.gas_wdot(T, conc, gm, th, kc_compat=kc, falloff_compat=kc)
        want = gk.production_rates_plain(T, conc, gm, th, kc_compat=kc)
        assert torch.equal(got, want)


# --------------------------------------------------------------------------
# the CUDA source on the host
# --------------------------------------------------------------------------
_MOCK_EXTRA = r"""
#include <algorithm>
using std::min;
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline float __double2float_rn(double x) { return static_cast<float>(x); }
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    out = tmp_path_factory.mktemp("gas_rates_host")
    (out / "cuda_runtime.h").write_text(MOCK_CUDA_RUNTIME + _MOCK_EXTRA)
    with open(os.path.join(kernels.CSRC, "gas_rates.cu")) as f:
        src = f.read()
    decl = "extern __shared__ __align__(16) double gas_smem[];"
    assert decl in src
    src = src.replace(
        decl, "double* gas_smem = reinterpret_cast<double*>(mock_smem());")
    src, launches = re.subn(
        r"([A-Za-z_0-9]+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);",
        lambda m: f"mock_launch({m.group(1)}, {m.group(2)}, {m.group(3)});",
        src, flags=re.S)
    assert launches == 1 and "<<<" not in src
    (out / "gas_rates_host.cpp").write_text(src)
    so = str(out / "libgas_rates_host.so")
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                           "-pthread", "-I", str(out), "-o", so,
                           str(out / "gas_rates_host.cpp")],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(so)
    ll, vp, i, d = (ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_double)
    lib.gas_wdot.argtypes = [vp, ll, vp, ll, vp, i, i, i, i, i, i, vp, i, d,
                             d, d, i, i, i, i, i, i, vp]
    lib.gas_wdot.restype = ctypes.c_int
    return lib


def host_wdot(lib, T, conc, gm, th, kc_compat, exp32, lanes=None):
    """The C entry point on CPU tensors with the wrapper's operands and
    launch configuration (``lanes`` overrides the tile); wdot starts as
    NaN."""
    B, S = conc.shape
    st = gr.structure(gm)
    R_ = gm.n_reactions
    cfg = gr.launch_config(B, S, R_)
    if lanes is not None:
        cfg = {"lanes": lanes, "grid": -(-B // lanes), "block": gr.THREADS,
               "smem": gr.smem_bytes(lanes, S, R_)}
    ops = [t.contiguous() for t in gr._parameters(gm, th)] + st.tensors()
    ptrs = (ctypes.c_void_p * len(ops))(*[t.data_ptr() for t in ops])
    wdot = torch.full((B, S), float("nan"), dtype=torch.float64)
    p0, shift = (1e5, math.log(1e6)) if kc_compat else (P_ATM, 0.0)
    err = lib.gas_wdot(
        T.data_ptr(), T.stride(0), conc.data_ptr(), conc.stride(0),
        wdot.data_ptr(), B, S, R_, st.f_idx.shape[1], st.r_idx.shape[1],
        st.d_idx.shape[1], ptrs, len(ops), R, p0, shift, int(kc_compat),
        int(exp32), cfg["lanes"], cfg["grid"], cfg["block"], cfg["smem"],
        None)
    assert err == 0
    return wdot


@pytest.mark.parametrize("name", MECHS)
@pytest.mark.parametrize("kc_compat", [False, True], ids=["si", "kc_compat"])
@pytest.mark.parametrize("B", [1, 7])
def test_kernel_source_matches_plain(host_lib, mechs, name, kc_compat, B):
    gm, th = mechs[name]
    T, conc = _states(gm, B, 10 + B)
    got = host_wdot(host_lib, T, conc, gm, th, kc_compat, False)
    want = gk.production_rates_plain(T, conc, gm, th, kc_compat=kc_compat)
    assert torch.isfinite(want).all()
    assert_within_gross_flux(got, want,
                             gross_flux(T, conc, gm, th, kc_compat, False))


@pytest.mark.parametrize("name", MECHS)
def test_kernel_source_exp32_matches_plain(host_lib, mechs, name):
    """exp32: exp(x/8) in float32 then three squarings; on the host glibc's
    expf and PyTorch's vectorised float32 exp may differ by an ulp (2^-24
    relative), which the squarings raise to 8 ulp of a rate: 1e-6 of the
    gross flux.  The card tests hold the kernel to 1e-12 there, where both
    sides call CUDA's expf."""
    gm, th = mechs[name]
    T, conc = _states(gm, 7, 40)
    got = host_wdot(host_lib, T, conc, gm, th, False, True)
    want = gk.production_rates_plain(T, conc, gm, th, exp32=True)
    assert_within_gross_flux(got, want,
                             gross_flux(T, conc, gm, th, False, True),
                             rel=1e-6)


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_kernel_source_tiles_agree_bit_for_bit(host_lib, mechs, lanes):
    """Every tile size and a ragged last tile give the same bits: a lane's
    sums do not depend on its neighbours."""
    gm, th = mechs["grimech.dat"]
    T, conc = _states(gm, 11, 50)
    ref = host_wdot(host_lib, T, conc, gm, th, False, False, lanes=1)
    got = host_wdot(host_lib, T, conc, gm, th, False, False, lanes=lanes)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("name", ["grimech.dat", "h2o2.dat"])
@pytest.mark.parametrize("kc_compat,exp32", [(False, False), (True, True)])
def test_cost_tier_charges_the_operator_its_plain_work(mechs, name,
                                                       kc_compat, exp32):
    """The cost tier charges ``brtorch::gas_wdot`` (one row on the card)
    the FLOPs and transcendentals of the plain version's op log, so the
    card's cost table equals the CPU's."""
    from batchreactor_tpu_torch.analysis import costmodel as cm
    from batchreactor_tpu_torch.analysis.contracts import _op_log

    gm, th = mechs[name]
    T, conc = _states(gm, 8, 60)

    def walk(fn):
        fn()
        log = _op_log()
        with log:
            fn()
        rows = list(zip(log.rows, log.track["scalars"]))
        return rows, [sum(cm._op_cost(r, sc)[i] for r, sc in rows)
                      for i in (1, 2)]

    _, plain = walk(lambda: gk.production_rates_plain(
        T, conc, gm, th, kc_compat, exp32=exp32))
    rows, op = walk(lambda: gr.gas_wdot(T, conc, gm, th, kc_compat,
                                        kc_compat, exp32))
    assert [r[0] for r, _ in rows] == ["brtorch.gas_wdot.default"]
    assert op == plain and plain[1] > 0
