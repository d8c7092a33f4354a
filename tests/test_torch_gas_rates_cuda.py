"""The gas production-rate kernel ``brtorch::gas_wdot`` on the card (skips
without a GPU).

Run on a machine with an NVIDIA GPU and nvcc:
``python -m pytest tests/test_torch_gas_rates_cuda.py -m cuda -q
--noconftest``.  ``chip_smoke.py --gas-rates-only`` times the kernel at the
main path's shapes.

Tolerance of the kernel against the plain version: |dwdot_k| <= 1e-12 *
sum_j |dnu_jk| (|rf_j| + |rr_j|) + 1e-300, each species held to its own
gross flux: the kernel sums Delta G, the third-body concentrations and wdot
in another order than the plain version's matrix products, and near
equilibrium the net rates cancel.  Both sides call CUDA's own float64 and
float32 exp and log, so with exp32 on too the rates agree to float64
rounding.
"""

import os

import numpy as np
import pytest
import torch

from batchreactor_tpu_torch.models.gas import compile_gaschemistry
from batchreactor_tpu_torch.models.thermo import create_thermo
from batchreactor_tpu_torch.ops import gas_kinetics as gk
from batchreactor_tpu_torch.ops import gas_rates_cuda as gr
from batchreactor_tpu_torch.solver import graphs
from batchreactor_tpu_torch.utils.constants import R

pytestmark = pytest.mark.cuda

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _mech(name, dev):
    gm = compile_gaschemistry(os.path.join(FIX, name), device=dev)
    th = create_thermo(list(gm.species), os.path.join(FIX, "therm.dat"),
                       device=dev)
    return gm, th


def _states(gm, B, seed, dev):
    """T in 800..2500 K, concentrations around 1 bar with a zero and a
    small negative entry in most lanes (transient Newton iterates)."""
    rng = np.random.default_rng(seed)
    S = gm.n_species
    T = rng.uniform(800.0, 2500.0, B)
    x = rng.dirichlet(np.ones(S), B)
    conc = x * 1e5 / (R * T[:, None])
    k = rng.integers(0, S, (B, 2))
    conc[np.arange(B), k[:, 0]] = 0.0
    neg = np.arange(B) % 3 > 0
    conc[np.arange(B)[neg], k[neg, 1]] *= -1e-3
    return (torch.tensor(T, device=dev), torch.tensor(conc, device=dev))


def _gross_flux(T, conc, gm, th, kc_compat, exp32):
    kf, tb = gk.forward_rate_constants(T, conc, gm, falloff_compat=kc_compat,
                                       exp32=exp32)
    kr = gk.reverse_rate_constants(T, kf, gm, th, kc_compat, exp32=exp32)
    rf = kf * gk._stoich_prod(conc, gm.nu_f, gm.int_stoich) * tb
    rr = kr * gk._stoich_prod(conc, gm.nu_r, gm.int_stoich) * tb
    return (rf.abs() + rr.abs()) @ (gm.nu_r - gm.nu_f).abs()


@pytest.mark.parametrize("name", ["grimech.dat", "h2o2.dat"])
@pytest.mark.parametrize("B", [1, 7, 4096])
@pytest.mark.parametrize("exp32", [False, True], ids=["f64exp", "exp32"])
@pytest.mark.parametrize("kc_compat", [False, True], ids=["si", "kc_compat"])
def test_kernel_matches_plain(cuda, name, B, exp32, kc_compat):
    gm, th = _mech(name, cuda)
    T, conc = _states(gm, B, 100 + B, cuda)
    graphs.reset_counts()
    got = gk.production_rates(T, conc, gm, th, kc_compat, exp32=exp32)
    assert graphs.COUNTS["gas_wdot"] == 1
    assert graphs.COUNTS["rhs_fused"] == 1 and graphs.COUNTS["rhs_plain"] == 0
    want = gk.production_rates_plain(T, conc, gm, th, kc_compat, exp32=exp32)
    flux = _gross_flux(T, conc, gm, th, kc_compat, exp32)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(want).all())
    err = (got - want).abs()
    bad = err > 1e-12 * flux + 1e-300
    assert not bool(bad.any()), (
        f"{int(bad.sum())} entries; worst "
        f"{float((err / (flux + 1e-300)).max()):.3e} of the gross flux")


def test_two_launches_agree_bit_for_bit(cuda):
    gm, th = _mech("grimech.dat", cuda)
    T, conc = _states(gm, 4096, 7, cuda)
    a = gr.gas_wdot(T, conc, gm, th)
    b = gr.gas_wdot(T, conc, gm, th)
    assert torch.equal(a, b)


def test_strided_temperature_and_the_wrapper_checks(cuda):
    """T may be a strided column (the energy path's y[:, -1]); a float32
    state or a mechanism on another device raises."""
    gm, th = _mech("h2o2.dat", cuda)
    T, conc = _states(gm, 64, 8, cuda)
    y = torch.cat([conc, T[:, None]], dim=1)
    got = gr.gas_wdot(y[:, -1], conc, gm, th)
    assert torch.equal(got, gr.gas_wdot(T.clone(), conc, gm, th))
    with pytest.raises(TypeError):
        gr.gas_wdot(T, conc.float(), gm, th)
    gm_cpu, th_cpu = _mech("h2o2.dat", "cpu")
    with pytest.raises(TypeError):
        gr.gas_wdot(T, conc, gm_cpu, th_cpu)


def _gas_inputs(cuda, B, name="grimech.dat"):
    from batchreactor_tpu_torch.parallel import (ignition_observer,
                                                 sweep_solution_vectors)

    gm, th = _mech(name, cuda)
    sp = list(gm.species)
    x0 = np.zeros(len(sp))
    fuel = "CH4" if "CH4" in sp else "H2"
    x0[sp.index(fuel)], x0[sp.index("O2")], x0[sp.index("N2")] = .25, .5, .25
    T = torch.linspace(1500.0, 2000.0, B, dtype=torch.float64, device=cuda)
    y0 = sweep_solution_vectors(np.broadcast_to(x0, (B, len(sp))), th.molwt,
                                T, 1e5)
    obs, obs0 = ignition_observer(sp.index(fuel), mode="half")
    return gm, th, y0, {"T": T}, obs, obs0


def test_captured_gas_window_replays_equal_to_its_eager_run(cuda):
    """The pipelined gear's captured windows launch the kernel (counted per
    replay) and equal the blocking gear's eager windows bit for bit."""
    from batchreactor_tpu_torch.ops.rhs import make_gas_jac, make_gas_rhs
    from batchreactor_tpu_torch.parallel import ensemble_solve_segmented

    gm, th, y0, cfg, obs, obs0 = _gas_inputs(cuda, 1024)
    rhs, jac = make_gas_rhs(gm, th), make_gas_jac(gm, th)
    kw = dict(segment_steps=64, jac=jac, observer=obs, observer_init=obs0,
              jac_window=8, setup_economy=True)
    graphs.reset_counts()
    ref = ensemble_solve_segmented(rhs, y0, 0.0, 2e-4, cfg, pipeline=False,
                                   **kw)
    eager = graphs.COUNTS["rhs_fused"]
    assert eager > 0 and graphs.COUNTS["rhs_plain"] == 0
    ensemble_solve_segmented(rhs, y0, 0.0, 2e-4, cfg, **kw)   # captures
    graphs.reset_counts()
    got = ensemble_solve_segmented(rhs, y0, 0.0, 2e-4, cfg, **kw)
    assert graphs.captures() == 0 and graphs.COUNTS["replays"] > 0
    assert graphs.COUNTS["rhs_plain"] == 0
    assert graphs.COUNTS["gas_wdot"] == graphs.COUNTS["rhs_fused"] > 0
    for f in ("t", "y", "status", "n_accepted", "n_rejected", "h"):
        assert torch.equal(getattr(got, f).cpu(), getattr(ref, f).cpu()), f


def test_transform_callers_run_on_the_card_and_count_plain(cuda):
    """``analytic_jac=False`` (``jacfwd`` through the RHS), the energy
    path's T-``jvp`` and forward sensitivity's theta-``jvp`` take the plain
    path and count ``rhs_plain``; their plain RHS calls still launch."""
    import batchreactor_tpu_torch as bt
    from batchreactor_tpu_torch.ops.rhs import make_gas_jac, make_gas_rhs
    from batchreactor_tpu_torch.parallel import ensemble_solve_forward
    from batchreactor_tpu_torch.sensitivity import params

    gm, th = _mech("h2o2.dat", cuda)
    chem = bt.Chemistry(gaschem=True)
    inlet = {"H2": 0.3, "O2": 0.2, "N2": 0.5}
    for kw in ({"analytic_jac": False}, {"energy": "adiabatic_v"}):
        graphs.reset_counts()
        out = bt.batch_reactor_sweep(inlet, [1100.0, 1200.0], 1e5, 2e-5,
                                     chem=chem, thermo_obj=th, md=gm,
                                     device=cuda, **kw)
        assert (np.asarray(out["status"]) == 1).all(), kw
        assert graphs.COUNTS["rhs_plain"] > 0, kw
        assert graphs.COUNTS["rhs_fused"] > 0, kw

    _, _, y0, cfg, _, _ = _gas_inputs(cuda, 8, "h2o2.dat")
    spec = params.select(gm, reactions=(0, 1))
    theta = params.extract(gm, spec)
    rt = params.make_rhs_theta(gm, spec, lambda m: make_gas_rhs(m, th))
    # theta shared by the lanes: the primal RHS launches, the tangents'
    # jvp is plain; one theta row per lane: the primal RHS is plain too
    for th_run in (theta, {k: v.expand(8, -1).clone()
                           for k, v in theta.items()}):
        jac = make_gas_jac(params.apply(gm, th_run, spec), th)
        graphs.reset_counts()
        res = ensemble_solve_forward(rt, y0, 0.0, 1e-5, th_run, cfg,
                                     jac=jac)
        assert bool((res.status == 1).all())
        assert graphs.COUNTS["rhs_plain"] > 0
        assert (graphs.COUNTS["rhs_fused"] > 0) == (th_run is theta)
