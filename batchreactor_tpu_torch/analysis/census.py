"""brlint tier C (b): the census of the port's step-program contracts.

One builder per contract, grouped by the module that owns the programs it
records; the file's order is the registry's order, and so fixes which
contract first memoizes the harness's shared baselines.  Each
builder registers through :func:`~.contracts.program_contract` with the
``sites=`` / ``labels=`` of the ``graphs.Program(`` constructions and
armed compile-watch labels it covers, which is all the completeness check
needs; the owner modules themselves import nothing of the analysis
package.  :func:`~.contracts.run_contracts` imports this module, and so
torch and the solver stack, only when the contract tier runs.
"""

import os

import torch

from ..aot.buckets import resolve_bucket
from ..energy.eqns import (ENERGY_MODES, energy_cfg, extend_states,
                           make_energy_jac, make_energy_rhs)
from ..models.padding import pad_gas_mechanism, pad_states, pad_thermo
from ..ops.rhs import make_gas_jac, make_gas_rhs
from ..parallel.sweep import (_grow_tail, _init_segment_carry,
                              ensemble_solve_segmented, pad_to_bucket)
from ..sensitivity import params as P
from ..sensitivity.forward import make_fdot
from ..solver import bdf, graphs
from ..solver.common import SUCCESS
from .contracts import Contains, Identical, Pure, program_contract


# --------------------------------------------------------------------------
# ops/rhs.py: the four chemistry modes and their analytic Jacobians run
# inside every captured step — pure, and float64 throughout (a float32
# default dtype here would be a numerical difference from the reference).
# --------------------------------------------------------------------------
@program_contract(
    "rhs-modes",
    doc="four chemistry modes + analytic jacobians: pure, float64 "
        "throughout")
def _contract_rhs_modes(h):
    for tag, rhs, jac, y0, cfg in h.modes:
        rec = (h.gas_rhs_baseline() if tag == "gas-rhs"
               else h.record_fn(tag, rhs, h.t, y0, cfg))
        yield Pure(tag, rec, check_dtype=h.check_dtype)
        if jac is not None:
            jtag = tag.replace("-rhs", "-jac")
            rec = (h.gas_jac_baseline() if tag == "gas-rhs"
                   else h.record_fn(jtag, jac, h.t, y0, cfg))
            yield Pure(jtag, rec, check_dtype=h.check_dtype)


# --------------------------------------------------------------------------
# models/padding.py: identity padding is a no-op — the padded-mechanism RHS
# and Jacobian at (S, R) == the live shape record the raw mechanism's
# programs — and a genuinely padded RHS and Jacobian stay pure and float64
# throughout.
# --------------------------------------------------------------------------
@program_contract(
    "mech-padding",
    doc="mechanism padding: identity padding is a no-op; padded "
        "RHS/Jacobian stay pure")
def _contract_mech_padding(h):
    gm, th = h.gm, h.th
    S, R = gm.n_species, gm.n_reactions
    gmi, thi = pad_gas_mechanism(gm, S, R), pad_thermo(th, S)
    yield Identical(
        "mech-pad-noop-fork", "gas-rhs-identity-pad", h.gas_rhs_baseline(),
        h.record_fn("gas-rhs-identity-pad", make_gas_rhs(gmi, thi), h.t,
                    h.y0, h.cfg),
        "identity mechanism padding changed the recorded gas RHS: the "
        "padding layer is no longer transparent at the live shape "
        "(models/padding.py contract)")
    yield Identical(
        "mech-pad-noop-fork", "gas-jac-identity-pad", h.gas_jac_baseline(),
        h.record_fn("gas-jac-identity-pad", make_gas_jac(gmi, thi), h.t,
                    h.y0, h.cfg),
        "identity mechanism padding changed the recorded gas Jacobian "
        "(models/padding.py contract)")
    s_pad, r_pad = S + 3, R + 4
    gmp, thp = pad_gas_mechanism(gm, s_pad, r_pad), pad_thermo(th, s_pad)
    y0p = pad_states(h.y0, s_pad)
    yield Pure("gas-rhs-padded",
               h.record_fn("gas-rhs-padded", make_gas_rhs(gmp, thp), h.t,
                           y0p, h.cfg), check_dtype=h.check_dtype)
    yield Pure("gas-jac-padded",
               h.record_fn("gas-jac-padded", make_gas_jac(gmp, thp), h.t,
                           y0p, h.cfg), check_dtype=h.check_dtype)


# --------------------------------------------------------------------------
# energy/eqns.py: the energy RHS/Jacobian run inside every non-isothermal
# step; energy-noop-fork pins the mode=None dispatch to the isothermal
# builders' programs (sharing the mech-padding contract's baseline
# recordings).
# --------------------------------------------------------------------------
@program_contract(
    "energy-eqns",
    doc="non-isothermal RHS/Jacobian (both adiabatic modes) + the "
        "T-row-weighted BDF segment program: pure")
def _contract_energy_eqns(h):
    y0e = extend_states(h.y0, 1100.0)
    cfg_e = energy_cfg(h.cfg, "adiabatic_v", h.B, y0e.shape[1], 1e-10,
                       device=h.device)
    for mode in ENERGY_MODES:
        rhs = make_energy_rhs(h.gm, h.th, mode)
        jac = make_energy_jac(h.gm, h.th, mode)
        yield Pure(f"energy-rhs-{mode}",
                   h.record_fn(f"energy-rhs-{mode}", rhs, h.t, y0e, cfg_e),
                   check_dtype=h.check_dtype)
        yield Pure(f"energy-jac-{mode}",
                   h.record_fn(f"energy-jac-{mode}", jac, h.t, y0e, cfg_e),
                   check_dtype=h.check_dtype)
    yield Pure("energy-bdf-step", h.segment(
        "energy-bdf-step", rhs=make_energy_rhs(h.gm, h.th, "adiabatic_v"),
        jac=make_energy_jac(h.gm, h.th, "adiabatic_v"), y0=y0e, cfg=cfg_e))


@program_contract(
    "energy-noop-fork",
    doc="energy=None is a no-op: the mode dispatch records the isothermal "
        "builders' programs, and the cfg extension leaves the per-lane "
        "dict untouched")
def _contract_energy_noop(h):
    yield Identical(
        "energy-noop-fork", "gas-rhs-energy-none", h.gas_rhs_baseline(),
        h.record_fn("gas-rhs-energy-none",
                    make_energy_rhs(h.gm, h.th, None), h.t, h.y0, h.cfg),
        "make_energy_rhs(mode=None) recorded a DIFFERENT program than the "
        "isothermal gas RHS: the energy dispatch leaked into the "
        "isothermal path (energy/eqns.py contract)")
    yield Identical(
        "energy-noop-fork", "gas-jac-energy-none", h.gas_jac_baseline(),
        h.record_fn("gas-jac-energy-none",
                    make_energy_jac(h.gm, h.th, None), h.t, h.y0, h.cfg),
        "make_energy_jac(mode=None) recorded a DIFFERENT program than the "
        "isothermal gas Jacobian (energy/eqns.py contract)")
    # the cfg extension at energy=None returns the per-lane dict itself:
    # "key absent" IS the isothermal step program
    cfg_none = energy_cfg(h.cfg, None, h.B, h.y0.shape[1], 1e-10)
    yield Identical(
        "energy-noop-fork", "energy-cfg-none",
        repr(sorted(h.cfg)), repr(sorted(cfg_none)),
        "energy_cfg(energy=None) changed the per-lane cfg keys: the "
        "isothermal path would record a different step program "
        "(energy/eqns.py contract)")
    yield Identical(
        "energy-noop-fork", "energy-cfg-none-identity", "same",
        "same" if cfg_none is h.cfg else "copied",
        "energy_cfg(energy=None) copied the cfg dict instead of returning "
        "it unchanged (energy/eqns.py contract)")


# --------------------------------------------------------------------------
# solver/bdf.py: the BDF step windows (the segment program's
# begin/window/end) with and without the counters are pure: the counters are
# masked int32 adds, never a host read.  The dtype walk stays off for solver
# programs: the inv32*/lu32p Newton modes narrow to float32 by design
# (solver/linalg.py).
# --------------------------------------------------------------------------
@program_contract(
    "bdf-step",
    doc="BDF step program, plain and stats-instrumented: pure")
def _contract_bdf_step(h):
    yield Pure("bdf-step", h.segment_baseline())
    yield Pure("bdf-step-stats", h.segment_stats())


@program_contract(
    "bdf-step-economy",
    doc="setup-economy carry: pure; structural no-op at jac_window=1")
def _contract_bdf_economy(h):
    # the carried factorization is data in the carry, never a host read
    yield Pure("bdf-step-economy", h.segment(
        "bdf-step-economy", jac_window=4, setup_economy=True, stats=True))
    # setup_economy=True at jac_window=1 is a structural no-op
    # (make_stepper): the same program as the knob off
    yield Identical(
        "economy-noop-fork", "bdf-step-economy-noop",
        h.segment_baseline(),
        h.segment("bdf-step-economy-noop", setup_economy=True),
        "setup_economy=True at jac_window=1 records a DIFFERENT program "
        "than the knob off: the economy carry leaked into the "
        "structural-no-op configuration (solver/bdf.py contract)")


# --------------------------------------------------------------------------
# solver/sdirk.py: the SDIRK4 step windows, plain and stats-instrumented —
# the BDF step's purity contract (dtype walk off: the Newton modes narrow by
# design).
# --------------------------------------------------------------------------
@program_contract(
    "sdirk-step",
    doc="SDIRK step program, plain and stats-instrumented: pure")
def _contract_sdirk_step(h):
    yield Pure("sdirk-step", h.segment("sdirk-step", method="sdirk"))
    yield Pure("sdirk-step-stats", h.segment("sdirk-step-stats",
                                             method="sdirk", stats=True))


# --------------------------------------------------------------------------
# solver/linalg_cuda.py: the lu32p step program must be pure like every
# other mode AND must contain the kernel — a silent fallback to a library LU
# would keep the parity tests green while the hand-written kernel never
# runs.  On the CPU the op log names brtorch::lu32p_factor; on the card the
# captured graph's kernel nodes name the lu32p kernel and the capture
# counted its launches.
# --------------------------------------------------------------------------
@program_contract(
    "bdf-step-lu32p",
    doc="lu32p step program: pure, kernel actually present")
def _contract_lu32p(h):
    rec = h.memo("segment-lu32p", lambda: h.segment(
        "bdf-step-lu32p", linsolve="lu32p"))
    yield Pure("bdf-step-lu32p", rec)
    yield Contains(
        "kernel-missing", "bdf-step-lu32p", rec, "lu32p",
        "linsolve='lu32p' step program does not run the lu32p kernel: the "
        "factor silently fell back to another path "
        "(solver/linalg_cuda.py)")


# --------------------------------------------------------------------------
# sensitivity/forward.py: the tangent-carrying BDF window (make_stepper with
# the fdot hook, fixed trip) makes no host read, like the plain one.  The
# forward solve runs the blocking loop, never captured, so the window is
# recorded as it runs (eagerly, on the card too).
# --------------------------------------------------------------------------
@program_contract(
    "sens-forward-step",
    doc="tangent-carrying forward BDF step program: pure")
def _contract_sens_forward(h):
    _spec, theta, rhs_theta = h.sens_fixture()
    y0, cfg = h.y0, h.cfg
    B, n = y0.shape
    nP = P.flatten(theta)[0].shape[-1]
    fdot = make_fdot(rhs_theta, theta, cfg)

    def rhs(t, y, c):
        return rhs_theta(t, y, theta, c)

    st = bdf.make_stepper(rhs, cfg, B, n, y0.dtype, y0.device, rtol=1e-6,
                          atol=1e-10, max_steps=3, linsolve="lu", jac=h.jac,
                          fdot=fdot)
    S0 = torch.zeros((B, nP, n), dtype=y0.dtype, device=y0.device)
    steps = {"begin": lambda s: {"c": st.init(s["y0"], s["t0"], s["t1"],
                                              S0=s["S0"])},
             "window": lambda s: {"c": st.window(s["c"], fixed=True)}}
    rec = h.record_steps(
        "sens-forward-step", steps,
        {"y0": y0, "S0": S0, "t0": h.t, "t1": h.t + 1e-7}, capture=False)
    yield Pure("sens-forward-step", rec)


# --------------------------------------------------------------------------
# parallel/sweep.py, the captured programs it owns: the segment program
# (``graphs.Program`` built in _build_segment_program; the ``sweep-segment``
# label), its compaction step (``sweep-compact``), and the no-op forks that
# pin the segment program unchanged under bucket padding, an armed
# resilience layer, and after the admission, up-shift, mesh-resident and
# timeline machinery has been built and run.
# --------------------------------------------------------------------------
def _contract_decay(t, y, cfg):
    """The streaming contracts' ODE: dy/dt = -k y, k per lane."""
    return -cfg["k"][:, None] * y


def _contract_stream(h, lanes, **kw):
    """A tiny linear-decay streaming sweep on the harness's device (the
    whole admission path: seed, poll, harvest, compact, refill); every
    lane must succeed."""
    k = torch.tensor([10.0, 20.0, 40.0, 80.0] * (lanes // 4 or 1),
                     dtype=torch.float64, device=h.device)[:lanes]
    y0 = torch.tensor([1.0, 0.5], dtype=torch.float64,
                      device=h.device).expand(lanes, 2).clone()
    res = ensemble_solve_segmented(
        _contract_decay, y0, 0.0, 1.0, {"k": k}, segment_steps=8,
        pipeline=True, poll_every=1, method="bdf", linsolve="lu", **kw)
    status = graphs.fetch(res.status)[0]
    if not (status == SUCCESS).all():
        raise AssertionError(f"the contract's streaming sweep ({kw}) "
                             f"ended with statuses {status.tolist()}")


@program_contract(
    "sweep-segment", labels=("sweep-segment",),
    sites=("parallel/sweep.py::_build_segment_program",),
    doc="segment program (begin/window/end with the trajectory drain), "
        "plain and stats-instrumented: pure")
def _contract_segment(h):
    yield Pure("segment-pipelined-step", h.segment(
        "segment-pipelined-step", seg_save=2, n_save=8))
    yield Pure("segment-pipelined-step-stats", h.segment(
        "segment-pipelined-step-stats", stats=True, seg_save=2, n_save=8))


@program_contract(
    "sweep-segment-bucket",
    doc="two lane counts in one bucket record the same padded segment "
        "program (aot/buckets.py)")
def _contract_segment_bucket(h):
    # the structural guarantee behind the zero-capture warm contract: a
    # difference means the padding path leaks the original lane count
    # into the program
    by_bucket = {}
    for Bx in (3, 4):
        bucket = resolve_bucket(Bx, "pow2")
        y0p, cfgp, _ = pad_to_bucket(
            h.y0[:Bx], {k: v[:Bx] for k, v in h.cfg.items()}, bucket)
        by_bucket.setdefault(bucket, []).append(
            (Bx, h.segment(f"segment-bucket-b{Bx}", y0=y0p, cfg=cfgp)))
    for bucket, recs in by_bucket.items():
        if len(recs) > 1:
            yield Identical(
                "bucket-fork", f"segment-bucket-b{bucket}", recs[0][1],
                recs[-1][1],
                f"padded segment programs for lane counts "
                f"{[b for b, _ in recs]} in bucket {bucket} differ: the "
                f"padding path leaks the original lane count into the "
                f"program (a capture per lane count)")


@program_contract(
    "sweep-segment-resilience",
    doc="segment program unchanged with the fault layer armed")
def _contract_segment_resilience(h):
    # the fault-tolerance layer (resilience/) is host-side: watchdog
    # deadlines and armed fault-injection plans never reach a step
    from ..resilience import inject as _inject

    base = h.segment_baseline()
    prev = os.environ.get("BR_FETCH_DEADLINE_S")
    _inject.arm("hang_fetch:delay=0.01;nan_lane:lane=0")
    os.environ["BR_FETCH_DEADLINE_S"] = "5"
    try:
        armed = h.segment("segment-resilience-armed")
    finally:
        _inject.disarm()
        if prev is None:
            os.environ.pop("BR_FETCH_DEADLINE_S", None)
        else:
            os.environ["BR_FETCH_DEADLINE_S"] = prev
    yield Identical(
        "resilience-noop-fork", "segment-resilience-noop", base, armed,
        "arming the resilience layer (fault injection + watchdog deadline) "
        "changed the segment program: the fault-tolerance plumbing leaked "
        "into a step (resilience/ host-side contract)")


@program_contract(
    "sweep-compact", labels=("sweep-compact",),
    doc="compaction/admission step: pure gathers and selects")
def _contract_compact(h):
    B, n = h.y0.shape
    dev = h.device
    prog = h.segment_program()
    fresh = _init_segment_carry(
        torch.zeros((B, n), dtype=h.y0.dtype, device=dev), 0.0, "bdf",
        None, 0, False, "lu")
    prog.set(order=torch.arange(B - 1, -1, -1, device=dev),
             admit_y=h.y0.flip(0).clone(),
             admit_cfg={k: v.clone() for k, v in h.cfg.items()},
             fresh=fresh,
             n_live=torch.full((1,), B // 2, dtype=torch.int64, device=dev),
             n_new=torch.full((1,), 2, dtype=torch.int64, device=dev))
    yield Pure("sweep-compact-admit",
               h.record("sweep-compact-admit", prog, ("compact",)))


@program_contract(
    "sweep-admission",
    doc="segment program unchanged after admission ran")
def _contract_admission(h):
    base = h.segment_baseline()
    _contract_stream(h, 4, admission=2, refill=1)
    yield Identical(
        "admission-noop-fork", "segment-admission-noop", base,
        h.segment("segment-admission-post"),
        "the segment program recorded after building and running the "
        "admission machinery differs from the admission-less one: the "
        "continuous-batching plumbing leaked into the shared segment "
        "program (parallel/sweep.py admission-off contract)")


@program_contract(
    "sweep-upshift",
    doc="up-shift resize pure; segment program unchanged after the "
        "autoscaler ran")
def _contract_upshift(h):
    # (1) the grow-tail resize, which runs eagerly between segments, is
    # pure cats; (2) the segment program recorded after a real autoscaled
    # stream (overfed backlog on a pow2 ladder: the up-shift fires, the
    # drain tail down-shifts back) is the pre-autoscaler one
    base = h.segment_baseline()
    carry = _init_segment_carry(h.y0, 0.0, "bdf", None, 0, False, "lu")
    yield Pure("sweep-upshift-grow", h.record_fn(
        "sweep-upshift-grow", lambda c: _grow_tail(c, 2), carry,
        capture=False))
    _contract_stream(h, 8, admission=2, refill=1, buckets="pow2",
                     upshift=8, upshift_patience=1)
    yield Identical(
        "upshift-noop-fork", "segment-upshift-noop", base,
        h.segment("segment-upshift-post"),
        "the segment program recorded after building and running the "
        "bucket autoscaler differs from the upshift-less one "
        "(parallel/sweep.py upshift-off contract)")


@program_contract(
    "sweep-mesh-resident",
    doc="segment program unchanged after a mesh-resident stream ran")
def _contract_mesh_resident(h):
    base = h.segment_baseline()
    _contract_stream(h, 4, admission=2, refill=1, buckets="pow2",
                     mesh_resident=1)
    yield Identical(
        "mesh-resident-noop-fork", "segment-mesh-resident-noop", base,
        h.segment("segment-mesh-resident-post"),
        "the segment program recorded after a mesh_resident= stream "
        "differs from the unsharded one: the resident carry's placement "
        "leaked into a step (parallel/sweep.py mesh_resident-off contract)")


@program_contract(
    "sweep-timeline",
    doc="timeline ring: instrumented program pure; timeline=None programs "
        "unchanged after the ring ran")
def _contract_timeline(h):
    stats_before = h.segment_stats()
    base = h.segment_baseline()
    yield Pure("segment-pipelined-step-timeline", h.segment(
        "segment-pipelined-step-timeline", stats=True, timeline=8))
    _contract_stream(h, 2, stats=True, timeline=8)
    msg = ("recording after building and running the timeline ring changed "
           "a timeline-off program: the ring plumbing leaked into the "
           "default step (solver/bdf.py timeline=None contract)")
    yield Identical("timeline-noop-fork", "timeline-noop-stats",
                    stats_before, h.segment("timeline-noop-stats-after",
                                            stats=True), msg)
    yield Identical("timeline-noop-fork", "timeline-noop-segment", base,
                    h.segment("timeline-noop-segment-after"), msg)
