"""Public API of the port: ``batch_reactor`` in its three forms and the
ensemble ``batch_reactor_sweep``.

Port of ``batchreactor_tpu/api.py``, for the four chemistry modes of the
reference: gas, surface, coupled gas+surface and user-defined (UDF).

1. ``batch_reactor(input_file, lib_dir, gaschem=, surfchem=)`` — XML-driven
   run that writes ``gas_profile.{dat,csv}`` (and, with surface chemistry,
   ``surface_covg.{dat,csv}``) next to the input file and returns the
   solver's status string.
2. ``batch_reactor(input_file, lib_dir, udf)`` — the same driver with a
   user-defined source function instead of a mechanism.
3. ``batch_reactor(inlet_comp, T, p, time, Asv=, chem=, thermo_obj=, md=)``
   — programmatic dict-in/dict-out form (gas or surface); returns
   ``(times, {species: x})``.
4. ``batch_reactor_sweep(inlet_comp, T, p, time, chem=, thermo_obj=, md=
   | gmd= | smd=, Asv=)`` — one lane per condition, solved together.

The file-driven forms take ``sens=``: ``True`` returns the problem
unsolved (:class:`SensitivityProblem`, the reference's hook), and
``"forward"``/``"adjoint"`` solve it with parameter sensitivities
(:class:`SensitivitySolution`, ``sensitivity/``).  The sweep pads a
mechanism onto a larger shape with ``species_buckets``/``reaction_buckets``
(``models/padding.py``).

The sweep also runs adiabatic gas chemistry (``energy="adiabatic_v"`` or
``"adiabatic_p"``: the state gains a trailing temperature row and the sweep
returns physical ignition delays), and every form runs either solver
(``method="bdf"`` or ``"sdirk"``).

Every entry point takes ``device=``: ``None`` runs on ``cuda`` and raises
without a GPU; pass ``device="cpu"`` for the CPU.  Options of the JAX API
that the port does not have yet raise ``NotImplementedError`` naming their
ROADMAP item.
"""

import dataclasses
import functools
import os
import sys

import numpy as np
import torch

from .aot.buckets import normalize_buckets, resolve_bucket
from .device import resolve_device
from .energy.eqns import (energy_cfg, extend_states, make_energy_jac,
                          make_energy_rhs, resolve_energy)
from .energy.ignition import (energy_ignition_observer, extract_delay,
                              merge_observers)
from .io.config import input_data, parse_composition_text
from .io.writers import trim_trajectory, write_profiles
from .models.padding import (nlive_cfg, pad_gas_mechanism, pad_states,
                             pad_thermo)
from .ops.rhs import (make_gas_jac, make_gas_rhs, make_surface_jac,
                      make_surface_rhs, make_udf_rhs)
from .parallel.sweep import (ensemble_solve_segmented, ignition_observer,
                             pad_to_bucket, resolve_admission, sweep_report,
                             unpad_result)
from .solver.common import (DT_UNDERFLOW, MAX_STEPS_REACHED, RUNNING,
                            SUCCESS, check_deferred)
from .solver.linalg import resolve_linsolve
from .utils.composition import density, mole_to_mass


@dataclasses.dataclass(frozen=True)
class SensitivityProblem:
    """What ``sens=True`` returns instead of solving (the reference returns
    ``(params, prob, t_span)``).  ``rhs(t, y, cfg)`` is the lane-batched
    RHS (y (1, n)) in plain torch ops, so ``torch.func.jacfwd``/``jvp``
    differentiate it in ``y0`` or ``cfg``; ``cfg`` holds (1,) tensors.

    ``theta``/``spec`` name the differentiable mechanism parameters
    (default: every reaction's ln A of the primary mechanism), so the hook
    composes with ``sensitivity.params.apply``; both are ``None`` for
    user-defined chemistry.  ``sens="forward"``/``"adjoint"`` solve and
    return the sensitivities directly."""

    rhs: object
    y0: torch.Tensor
    cfg: dict
    t_span: tuple
    species: tuple
    surface_species: tuple | None
    theta: dict | None = None
    spec: object | None = None  # sensitivity.params.ParamSpec


@dataclasses.dataclass(frozen=True)
class SensitivitySolution:
    """What ``sens="forward"``/``"adjoint"`` return: a solved run and its
    parameter sensitivities.  ``tangents`` is the forward (P, n) block
    dy(t_end)/dtheta in ``sensitivity.params.names(spec)`` row order
    (``None`` in adjoint mode); ``qoi``/``qoi_grad`` are the scalar QoI
    and its theta-shaped gradient of (K,) numpy arrays (``None`` unless a
    QoI was requested)."""

    status: str
    t: float
    y: object                      # (n,) final state
    species: tuple
    surface_species: tuple | None
    spec: object                   # sensitivity.params.ParamSpec
    theta: dict                    # the theta the run was evaluated at
    names: tuple                   # one label per tangent row
    tangents: object = None        # (P, n) forward sensitivities
    qoi: object = None
    qoi_grad: object = None        # theta-shaped dict
    n_accepted: int = 0
    n_rejected: int = 0
    truncated: bool = False        # adjoint only: the grid-pinning pass
    #                                overflowed sens_grid — the re-solve
    #                                lost resolution; raise sens_grid


@dataclasses.dataclass(frozen=True)
class Chemistry:
    """Chemistry-mode flags (the reference's ``ReactionCommons.Chemistry``).
    ``udf(t, state) -> source (S,)`` is the user-defined source function
    of ``userchem`` (see ``ops.rhs.make_udf_rhs``)."""

    surfchem: bool = False
    gaschem: bool = False
    userchem: bool = False
    udf: object = None


# retcode strings, as the JAX package reports them
_STATUS = {SUCCESS: "Success", MAX_STEPS_REACHED: "MaxIters",
           DT_UNDERFLOW: "DtLessThanMin", RUNNING: "Failure"}


def _status_str(code):
    return _STATUS.get(int(code)) or f"Failure({int(code)})"


def _normalize_sens(sens):
    """The one validation of ``sens``: False/None -> None (plain solve),
    True -> "hook" (return the problem unsolved), "forward"/"adjoint" pass
    through, anything else raises."""
    if sens is False or sens is None:
        return None
    if sens is True:
        return "hook"
    if sens in ("forward", "adjoint"):
        return sens
    raise ValueError(
        f"sens must be False, True, 'forward' or 'adjoint'; got {sens!r}")


def _mode(chem):
    if chem.userchem:
        return "udf"
    if chem.surfchem and chem.gaschem:
        return "gas+surf"
    if chem.surfchem:
        return "surf"
    if chem.gaschem:
        return "gas"
    raise ValueError("at least one of surfchem/gaschem/userchem required")


def _make_rhs(mode, udf, gm, sm, thermo, kc_compat, asv_quirk, exp32):
    """RHS for a chemistry mode (the reference's four-way branch)."""
    if mode == "udf":
        return make_udf_rhs(udf, thermo.molwt, species=thermo.species)
    if mode in ("surf", "gas+surf"):
        return make_surface_rhs(sm, thermo,
                                gm=gm if mode == "gas+surf" else None,
                                asv_quirk=asv_quirk, kc_compat=kc_compat,
                                exp32=exp32)
    return make_gas_rhs(gm, thermo, kc_compat=kc_compat, exp32=exp32)


def _make_jac(mode, gm, sm, thermo, kc_compat, asv_quirk, exp32):
    """Closed-form Jacobian of every mechanism-driven mode; ``None`` for
    UDF mode, where the solver falls back to ``torch.func.jacfwd``."""
    if mode == "udf":
        return None
    if mode in ("surf", "gas+surf"):
        return make_surface_jac(sm, thermo,
                                gm=gm if mode == "gas+surf" else None,
                                asv_quirk=asv_quirk, kc_compat=kc_compat,
                                exp32=exp32)
    return make_gas_jac(gm, thermo, kc_compat=kc_compat, exp32=exp32)


def get_solution_vector(mole_fracs, molwt, T, p, ini_covg=None):
    """y0 = rho * Y_k (then the initial coverages) on ``molwt``'s device.
    ``mole_fracs`` (S,) or (B, S); ``T``/``p`` scalars or (B,);
    ``ini_covg`` (Ss,) is appended to every lane."""
    dev = molwt.device
    x = torch.tensor(np.asarray(mole_fracs, dtype=np.float64), device=dev)
    T = torch.as_tensor(T, dtype=torch.float64, device=dev)
    p = torch.as_tensor(p, dtype=torch.float64, device=dev)
    rho = density(x, molwt, T, p)
    y = rho[..., None] * mole_to_mass(x, molwt)
    if ini_covg is None:
        return y
    covg = torch.as_tensor(ini_covg, dtype=torch.float64, device=dev)
    return torch.cat([y, covg.expand(y.shape[:-1] + covg.shape)], dim=-1)


def resolve_jac_window(jac_window, method, device):
    """``jac_window=None`` -> 8 for BDF on the GPU (the bench protocol's
    quasi-constant iteration matrix), 1 on the CPU (the exact per-attempt
    Jacobian the parity tests pin) and for SDIRK."""
    if jac_window is not None:
        return jac_window
    return 8 if (method == "bdf" and torch.device(device).type != "cpu") else 1


def _host(x):
    """A scalar, array or tensor as a float64 numpy array."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
    return np.asarray(x, dtype=np.float64)


_SWEEP_DEFERRED = (
    ("telemetry", False, "A14"), ("timeline", None, "A14"),
    ("live_metrics", None, "A14"),
)

# the sweep's (rhs, jac, observer, observer_init) per (chemistry, mechanism
# identities, options): repeated sweeps of one mechanism get the same
# callables, so the pipelined gear replays the graphs it captured for them
# (solver/graphs.py keys its programs by the callables' identity)
_SWEEP_FNS = {}


def _sweep_fns(mode, udf, gm, sm, thermo, kc_compat, asv_quirk, exp32,
               marker_idx, ignition_mode, jac_mode, energy):
    """Identity-cached sweep callables
    (``batchreactor_tpu/api.py::_sweep_fns``).  ``jac_mode`` is
    ``"analytic"`` or ``"fwd"`` (no closed-form Jacobian: the solver's
    ``torch.func.jacfwd`` fallback)."""
    key = (mode, id(udf), id(gm), id(sm), id(thermo), kc_compat, asv_quirk,
           exp32, marker_idx, ignition_mode, jac_mode, energy)
    hit = _SWEEP_FNS.get(key)
    if (hit is not None and hit[0] is gm and hit[1] is sm
            and hit[2] is thermo and hit[3] is udf):
        return hit[4:]
    observer = obs0 = None
    if energy is not None:
        observer, obs0 = energy_ignition_observer(thermo.n_species)
        rhs = make_energy_rhs(gm, thermo, energy, kc_compat, exp32)
        jac = make_energy_jac(gm, thermo, energy, kc_compat, exp32)
    else:
        rhs = _make_rhs(mode, udf, gm, sm, thermo, kc_compat, asv_quirk,
                        exp32)
        jac = _make_jac(mode, gm, sm, thermo, kc_compat, asv_quirk, exp32)
    if marker_idx is not None:
        sp_obs, sp_obs0 = ignition_observer(marker_idx, mode=ignition_mode)
        if observer is None:
            observer, obs0 = sp_obs, sp_obs0
        else:
            observer, obs0 = merge_observers(observer, obs0, sp_obs,
                                             sp_obs0)
    if jac_mode == "fwd":
        jac = None
    if len(_SWEEP_FNS) >= 32:
        _SWEEP_FNS.pop(next(iter(_SWEEP_FNS)))
    _SWEEP_FNS[key] = (gm, sm, thermo, udf, rhs, jac, observer, obs0)
    return rhs, jac, observer, obs0

# mechanisms and thermo tables copied to another device, per (source id,
# device): a mesh's shards reuse their callables from sweep to sweep
_DEVICE_COPIES = {}


def _on_device(obj, dev):
    """``obj`` (a mechanism or thermo table, or None) on ``dev``: itself
    when it is there already, else a cached copy."""
    if obj is None:
        return None
    moved = obj.to(dev)
    if moved is obj:
        return obj
    key = (id(obj), str(dev))
    hit = _DEVICE_COPIES.get(key)
    if hit is not None and hit[0] is obj:
        return hit[1]
    if len(_DEVICE_COPIES) >= 32:
        _DEVICE_COPIES.pop(next(iter(_DEVICE_COPIES)))
    _DEVICE_COPIES[key] = (obj, moved)
    return moved


# padded (mechanism, thermo) pairs per (source ids, shape): the same
# padded bundle for repeated sweeps of one mechanism; strong references to
# the sources keep the ids valid
_PADDED_MECHS = {}


def _padded_mech(gm, thermo_obj, s_pad, r_pad, canonical):
    """Identity-cached ``(gm_padded, thermo_padded)`` for a (mechanism,
    shape) pair (``batchreactor_tpu/api.py::_padded_mech``)."""
    key = (id(gm), id(thermo_obj), int(s_pad), int(r_pad), bool(canonical))
    hit = _PADDED_MECHS.get(key)
    if hit is not None and hit[0] is gm and hit[1] is thermo_obj:
        return hit[2], hit[3]
    gm_pad = pad_gas_mechanism(gm, s_pad, r_pad, canonical=canonical)
    th_pad = pad_thermo(thermo_obj, s_pad, canonical=canonical)
    if len(_PADDED_MECHS) >= 32:
        _PADDED_MECHS.pop(next(iter(_PADDED_MECHS)))
    _PADDED_MECHS[key] = (gm, thermo_obj, gm_pad, th_pad)
    return gm_pad, th_pad


def _sweep_mode(chem, md, gmd, smd, thermo_obj):
    """(mode, gm, sm) of a sweep, with the JAX package's guards against a
    mechanism or UDF that the chosen flags would silently ignore."""
    if chem.userchem and (chem.gaschem or chem.surfchem):
        raise ValueError("userchem is exclusive: combine it with neither "
                         "gaschem nor surfchem")
    if chem.udf is not None and not chem.userchem:
        raise ValueError("chem.udf is set but chem.userchem is False; "
                         "set userchem=True for user-defined chemistry")
    if chem.surfchem and chem.gaschem:
        if gmd is None or smd is None:
            raise TypeError("coupled gas+surf sweep needs gmd= (gas "
                            "mechanism) and smd= (surface mechanism)")
        if tuple(gmd.species) != tuple(thermo_obj.species):
            raise ValueError(
                "gmd.species and thermo_obj.species must match in order: "
                f"{list(gmd.species)[:4]}... vs "
                f"{list(thermo_obj.species)[:4]}...")
        return "gas+surf", gmd, smd
    if chem.surfchem:
        if gmd is not None:
            raise TypeError("gmd= passed without chem.gaschem — a silently "
                            "ignored gas mechanism would make this a "
                            "surface-only run; set gaschem=True for coupled")
        sm = smd if smd is not None else md
        if sm is None:
            raise TypeError("surface sweep needs md= or smd=")
        return "surf", None, sm
    if chem.gaschem:
        if smd is not None:
            raise TypeError("smd= passed without chem.surfchem — a silently "
                            "ignored surface mechanism would make this a "
                            "gas-only run; set surfchem=True for coupled")
        gm = gmd if gmd is not None else md
        if gm is None:
            raise TypeError("gas sweep needs md= or gmd=")
        return "gas", gm, None
    if chem.userchem:
        if chem.udf is None:
            raise TypeError("userchem sweep needs chem.udf")
        if md is not None or gmd is not None or smd is not None:
            raise TypeError("md=/gmd=/smd= passed with userchem — a "
                            "silently ignored mechanism would make this a "
                            "udf-only run; user mode takes no mechanism")
        return "udf", None, None
    raise ValueError("batch_reactor_sweep needs surfchem, gaschem, "
                     "and/or userchem")


def batch_reactor_sweep(inlet_comp, T, p, time, *, chem=None, thermo_obj=None,
                        md=None, gmd=None, smd=None, Asv=1.0, rtol=1e-6,
                        atol=1e-10, max_steps=200_000, segment_steps=0,
                        kc_compat=False, asv_quirk=True,
                        ignition_marker=None, ignition_mode="half",
                        energy=None, atol_T=None, method="bdf",
                        jac_window=None, linsolve="auto", newton_tol=0.03,
                        setup_economy=False, stale_tol=0.3, exp32=False,
                        analytic_jac=True, pipeline=None, poll_every=None,
                        buckets=None, admission=None, refill=None,
                        species_buckets=None, reaction_buckets=None,
                        mech_operands=False, mesh=None, fetch_deadline=None,
                        quarantine=None, device=None, **deferred):
    """Ensemble form: one lane per condition, all lanes solved together.

    Chemistry modes: gas (``md=`` or ``gmd=``), surface (``md=`` or
    ``smd=``), coupled gas+surface (``gmd=`` and ``smd=`` with both chem
    flags) and user-defined (``chem.userchem`` with ``chem.udf``).

    ``T`` and ``Asv`` may be scalars or (B,) arrays; ``inlet_comp`` is one
    composition dict shared by all lanes or a dict of per-lane arrays.
    Returns a dict with per-lane final gas mole fractions ``x`` {species:
    (B,)}, final coverages ``covg`` (B, Ss) with surface chemistry, final
    times ``t``, ``status``, the ``report`` (:func:`sweep_report`) and,
    with ``ignition_marker`` (a gas species name), per-lane ignition
    delays ``tau`` from the in-loop observer; ``linsolve`` and
    ``jac_window`` report the resolved solver configuration.

    ``energy="adiabatic_v"`` (constant volume) or ``"adiabatic_p"``
    (constant pressure), gas chemistry only, solves the energy equation:
    the state gains a trailing temperature row weighted at ``atol_T``
    Kelvin (default ``energy.DEFAULT_ATOL_T``) in the error norms, and the
    output gains the final temperatures ``T`` and the per-lane
    ``ignition_delay`` (the max-dT/dt time, NaN where a lane's temperature
    rose by less than 50 K).  ``method`` is ``"bdf"`` or ``"sdirk"``;
    ``newton_tol`` is SDIRK's stage Newton tolerance.
    ``segment_steps > 0`` bounds each segment of the sweep driver; ``0``
    runs one segment of ``max_steps``.

    ``pipeline``/``poll_every`` (segmented runs only: an explicit value
    with ``segment_steps=0`` raises) pick the segmented driver's gear:
    the default pipelined gear replays CUDA graphs of fixed-trip step
    windows on the card (``parallel/sweep.py``), ``pipeline=False`` is
    the blocking loop; the two are bit for bit the same.  ``buckets``
    pads the lane count onto a ladder rung (``"pow2"`` or an increasing
    tuple, ``aot/buckets.py``) with dead copies of the last lane, stripped
    from every output.  ``admission``/``refill`` (segmented runs only;
    grammar ``parallel.sweep.resolve_admission``) stream the conditions
    through ``admission`` resident slots: finished lanes are harvested,
    freed slots refill from the backlog once ``refill`` of them have
    parked, and with ``buckets`` the resident program shifts down the
    ladder as the backlog drains; outputs come back in the caller's lane
    order.  ``analytic_jac=False`` drops the closed-form Jacobian for the
    solver's ``torch.func.jacfwd`` fallback; ``"remat"`` keeps the
    closed form: in the JAX package it wraps it in ``jax.checkpoint``,
    which changes the compiled program and not the numbers, and PyTorch
    runs no program whose structure a checkpoint would change, so here it
    is ``True``.

    ``jac_window=None`` resolves by device (:func:`resolve_jac_window`);
    ``linsolve="auto"`` resolves with the sweep's B, state width n and
    surface species (``solver.linalg.resolve_linsolve``): on the GPU,
    ``"lu32p"`` for gas and user-defined states at B * n >= LU32P_MIN_BN,
    ``"lu"`` otherwise and for every state with surface coverages.  ``setup_economy`` carries the Newton
    factorization across jac windows.  ``asv_quirk`` scales the coverage
    source by Asv too, as the reference does.  ``exp32`` selects the
    float32 rate exponentials of the gas kinetics (off by default).

    ``species_buckets``/``reaction_buckets`` (gas chemistry only; ``None``,
    ``"pow2"`` or an increasing tuple of ints, ``aot.buckets``) pad the
    mechanism onto the smallest ``(S, R)`` rung that holds it
    (``models/padding.py``): dead species carry zero mass, zero rates and
    identity Newton rows, dead reactions zero rate constants, and the live
    count rides ``cfg[NLIVE_KEY]`` so the padded run takes the unpadded
    run's steps.  The state width, and so ``linsolve="auto"`` and the
    ``lu32p`` kernel's path, is the padded one.  Results are stripped to
    the live species; with ``energy=`` the T row sits at ``S_pad``.
    ``mech_operands=True`` (needs ``segment_steps > 0``) is the padding
    with placeholder names and both ladders defaulting to ``"pow2"``: in
    the JAX package it also shares one compiled executable between
    mechanisms of one rung, which the port, compiling no program per
    mechanism, has no counterpart of; its results are the padded run's.

    ``mesh`` (a ``parallel.Mesh``; not with ``admission``) splits the
    conditions over its devices, one host thread per device and no
    collective (``parallel/sweep.py``), the callables built on each
    device; outputs come back in the caller's order.  ``fetch_deadline``
    (segmented runs only; seconds, ``None`` resolves from
    ``BR_FETCH_DEADLINE_S``) bounds every blocking host read of the
    driver and raises ``resilience.WedgeError`` past it.  ``quarantine``
    (None/True/dict/``resilience.QuarantinePolicy``) re-solves
    non-success lanes: the same call again (bit for bit for a transient
    fault), then the failed lanes alone at tighter tolerances
    (``resilience/quarantine.py``); ``out["provenance"]`` holds each
    lane's recovery code and ``out["report"]["quarantine"]`` the counts.
    Its ``oracle=True`` rung waits for ROADMAP A16.
    """
    from .parallel.sweep import _check_mesh, _mesh_devices, _mesh_map
    from .resilience import quarantine as _quarantine
    from .resilience.policy import fallback_kwargs, normalize_quarantine

    if segment_steps <= 0 and (pipeline is not None
                               or poll_every is not None
                               or fetch_deadline is not None
                               or admission not in (None, False)
                               or refill is not None):
        # these knobs shape the segmented driver only: ignoring them on the
        # monolithic path would report a configuration that never ran
        raise ValueError(
            "pipeline/poll_every/fetch_deadline/admission/refill are "
            "segmented-path knobs; set segment_steps > 0 or drop the "
            "arguments")
    if admission is not True:
        resolve_admission(admission, refill, n_lanes=1)
    buckets = normalize_buckets(buckets)
    if isinstance(analytic_jac, str):
        if analytic_jac != "remat":
            raise ValueError(f"analytic_jac must be True, False, or "
                             f"'remat'; got {analytic_jac!r}")
        jac_mode = "analytic"
    else:
        jac_mode = "analytic" if analytic_jac else "fwd"
    if mech_operands:
        if species_buckets is None:
            species_buckets = "pow2"
        if reaction_buckets is None:
            reaction_buckets = "pow2"
    species_buckets = normalize_buckets(species_buckets)
    reaction_buckets = normalize_buckets(reaction_buckets)
    if mech_operands:
        if segment_steps <= 0:
            raise ValueError(
                "mech_operands=True runs the segmented driver's bundle "
                "mode; set segment_steps > 0 or drop the knob")
        if mesh is not None:
            raise ValueError(
                "mech_operands=True is single-mesh-free (the operand "
                "bundle is not sharded); drop mesh= or the knob")
        if quarantine is not None:
            raise ValueError(
                "mech_operands=True is incompatible with quarantine= "
                "(the recovery ladder re-solves through closure-mode "
                "programs); drop one of them")
        if analytic_jac is not True:
            raise ValueError(
                "mech_operands=True builds its analytic Jacobian inside the "
                "bundle builder; analytic_jac is not configurable there — "
                "drop the argument")
    check_deferred(deferred, _SWEEP_DEFERRED)
    if admission not in (None, False) and mesh is not None:
        raise ValueError(
            "admission= is incompatible with mesh= (parallel/sweep.py "
            "admission contract); drop one of them")
    if mesh is not None:
        _check_mesh(mesh, "batch")
    qpol = normalize_quarantine(quarantine)
    _quarantine.check_oracle(qpol)
    energy = resolve_energy(energy)
    if energy is None and atol_T is not None:
        raise ValueError(
            "atol_T weights the temperature row of a non-isothermal "
            "solve; pass energy= ('adiabatic_v'/'adiabatic_p') or drop "
            "the argument")
    if chem is None or thermo_obj is None:
        raise TypeError("batch_reactor_sweep needs chem= and thermo_obj=")
    mode, gm, sm = _sweep_mode(chem, md, gmd, smd, thermo_obj)
    if energy is not None and mode != "gas":
        raise ValueError(
            f"energy={energy!r} supports gas chemistry only (the "
            f"surface/coupled/udf state layouts have no temperature-row "
            f"contract yet); drop the knob for mode {mode!r}")
    device = resolve_device(device)
    thermo_obj = thermo_obj.to(device)
    gm = gm.to(device) if gm is not None else None
    sm = sm.to(device) if sm is not None else None
    species = thermo_obj.species

    # mechanism-shape padding: the kinetics run on the padded bundles, while
    # `species`/`thermo_obj` stay live for the inputs and the results
    s_pad = None
    gm_k, th_k = gm, thermo_obj
    if species_buckets is not None or reaction_buckets is not None:
        if mode != "gas":
            raise ValueError(
                "species_buckets/reaction_buckets/mech_operands support "
                "gas chemistry only (the surface/coupled/udf state "
                "layouts have no padding contract yet); drop the knobs "
                f"for mode {mode!r}")
        s_pad = (resolve_bucket(len(species), species_buckets)
                 if species_buckets is not None else len(species))
        r_pad = (resolve_bucket(gm.n_reactions, reaction_buckets)
                 if reaction_buckets is not None else gm.n_reactions)
        gm_k, th_k = _padded_mech(gm, thermo_obj, s_pad, r_pad,
                                  canonical=mech_operands)

    T_np = np.atleast_1d(_host(T))
    Asv_np = _host(Asv)
    B = max(T_np.shape[0], Asv_np.shape[0] if Asv_np.ndim else 1,
            max((np.asarray(v).shape[0] for v in inlet_comp.values()
                 if np.ndim(v)), default=1))
    idx = {s.upper(): k for k, s in enumerate(species)}
    X = np.zeros((B, len(species)))
    for name, val in inlet_comp.items():
        key = name.upper()
        if key not in idx:
            raise KeyError(f"composition species {name!r} not in species list")
        X[:, idx[key]] = np.asarray(val)
    T_t = torch.tensor(np.broadcast_to(T_np, (B,)).copy(), device=device)
    y0s = get_solution_vector(X, thermo_obj.molwt, T_t, p,
                              ini_covg=sm.ini_covg if sm is not None else None)
    cfgs = {"T": T_t,
            "Asv": torch.tensor(np.broadcast_to(Asv_np, (B,)).copy(),
                                device=device)}
    if s_pad is not None:
        # dead species: zero initial mass, and the live-count norm operand
        y0s = pad_states(y0s, s_pad)
        cfgs = nlive_cfg(cfgs, len(species), B)

    if energy is not None:
        # the trailing T row, and its atol weight as a per-lane operand
        y0s = extend_states(y0s, T_t)
        cfgs = energy_cfg(cfgs, energy, B, y0s.shape[1], atol, atol_T,
                          device=device)

    marker_idx = None
    if ignition_marker is not None:
        key = ignition_marker.upper()
        if key not in idx:
            raise KeyError(f"ignition_marker {ignition_marker!r} not in "
                           f"species list")
        marker_idx = idx[key]

    def fns(dev):
        return _sweep_fns(mode, chem.udf, _on_device(gm_k, dev),
                          _on_device(sm, dev), _on_device(th_k, dev),
                          kc_compat, asv_quirk, exp32, marker_idx,
                          ignition_mode, jac_mode, energy)

    rhs, jac, observer, obs0 = fns(device)
    run_dev = device if mesh is None else _mesh_devices(mesh)[0]
    jac_window = resolve_jac_window(jac_window, method, run_dev)
    # "auto" resolves with the lane count the devices run: the padded
    # bucket (split over a mesh), or the streaming driver's first resident
    # rung
    resident, _ = resolve_admission(admission, refill, n_lanes=B)
    bucket = resolve_bucket(min(resident or B, B), buckets,
                            mesh_size=1 if mesh is None else mesh.size)
    linsolve = resolve_linsolve(
        linsolve, method=method, device=run_dev, batch=bucket,
        n=y0s.shape[1],
        n_surface=sm.n_surface_species if sm is not None else 0)
    solve_kw = dict(rtol=rtol, atol=atol, method=method,
                    jac_window=jac_window, linsolve=linsolve,
                    newton_tol=newton_tol, setup_economy=setup_economy,
                    stale_tol=stale_tol)
    if segment_steps > 0:
        seg = dict(segment_steps=segment_steps, pipeline=pipeline,
                   poll_every=poll_every, admission=admission,
                   refill=refill, fetch_deadline=fetch_deadline)
    else:
        seg = dict(segment_steps=int(max_steps), max_segments=1)

    def primary():
        if mesh is None:
            return ensemble_solve_segmented(
                rhs, y0s, 0.0, float(time), cfgs, jac=jac,
                observer=observer, observer_init=obs0, buckets=buckets,
                **solve_kw, **seg)

        def shard(dev, y, c):
            r, j, o, o0 = fns(dev)
            return ensemble_solve_segmented(
                r, y, 0.0, float(time), c, jac=j, observer=o,
                observer_init=o0, **solve_kw, **seg)

        y_m, c_m, _ = pad_to_bucket(y0s, cfgs, bucket)
        return unpad_result(_mesh_map(mesh, y_m, c_m, shard), B)

    res = primary()
    prov = None
    if qpol is not None:
        def subset(y_sub, c_sub, pass_name):
            if pass_name == "retry":
                # the identical call: same program, same batch shape
                return primary()
            kw = fallback_kwargs(qpol, {"rtol": rtol, "atol": atol,
                                        "max_steps": max_steps})
            ms = kw["max_steps"]
            steps = segment_steps if segment_steps > 0 else ms
            return ensemble_solve_segmented(
                rhs, y_sub, 0.0, float(time), c_sub, jac=jac,
                observer=observer, observer_init=obs0,
                **{**solve_kw, "rtol": kw["rtol"], "atol": kw["atol"]},
                segment_steps=steps, max_segments=max(1, -(-ms // steps)),
                max_attempts=ms)

        res, prov = _quarantine.resolve(res, y0s, cfgs, subset,
                                        policy=qpol)

    ng = len(species)
    y_end = res.y.cpu().numpy()
    moles = y_end[:, :ng] / thermo_obj.molwt.cpu().numpy()
    x_end = moles / moles.sum(axis=1, keepdims=True)
    out = {
        "x": {s: x_end[:, k] for k, s in enumerate(species)},
        "t": res.t.cpu().numpy(),
        "status": res.status.cpu().numpy(),
        # reserved operand keys (the energy path's atol weight) are solver
        # plumbing, not conditions
        "report": sweep_report(res, {k: v for k, v in cfgs.items()
                                     if not k.startswith("_")}),
        # the resolved solver configuration the sweep actually ran
        "linsolve": linsolve,
        "jac_window": jac_window,
    }
    if prov is not None:
        out["provenance"] = prov
        out["report"]["quarantine"] = _quarantine.provenance_counts(prov)
    if chem.surfchem:
        out["covg"] = y_end[:, ng:]
    if energy is not None:
        # final temperatures and the physical ignition delay
        out["T"] = y_end[:, -1]
        out["ignition_delay"] = extract_delay(res.observed)
    if ignition_marker is not None:
        out["tau"] = res.observed["tau"].cpu().numpy()
    return out


_RUN_DEFERRED = (("backend", None, "A16"), ("telemetry", False, "A14"))


@functools.lru_cache(maxsize=32)
def _segmented_builder(mode, udf, kc_compat, asv_quirk, exp32):
    """Builder of the file-driven runs' RHS and Jacobian from a
    ``(gm, sm, thermo)`` bundle (``batchreactor_tpu/api.py::
    _segmented_builder``): one builder per chemistry configuration, so the
    segmented driver's pipelined gear (``rhs_bundle=``) replays one set of
    graphs for re-parsed copies of a mechanism."""

    def build(bundle):
        gm, sm, thermo = bundle
        return (_make_rhs(mode, udf, gm, sm, thermo, kc_compat, asv_quirk,
                          exp32),
                _make_jac(mode, gm, sm, thermo, kc_compat, asv_quirk,
                          exp32))

    return build


def _run_solve(builder, bundle, y0, T, Asv, t1, *, rtol, atol, n_save,
               max_steps, method, jac_window, segmented):
    """One condition through the sweep driver (B = 1), its RHS and
    Jacobian built by ``builder`` from the mechanism ``bundle``; returns
    (status, t_end, y_end, ts, ys, truncated, n_acc, n_rej) with ts/ys
    including the initial row."""
    dev = y0.device
    jac_window = resolve_jac_window(jac_window, method, dev)
    seg_steps = (min(512, int(max_steps)) if segmented in (None, True)
                 else int(max_steps))
    cfg = {"T": torch.full((1,), float(T), dtype=torch.float64, device=dev),
           "Asv": torch.full((1,), float(Asv), dtype=torch.float64,
                             device=dev)}
    res = ensemble_solve_segmented(
        builder, y0[None, :], 0.0, float(t1), cfg,
        rtol=rtol, atol=atol, n_save=n_save, segment_steps=seg_steps,
        max_segments=max(1, -(-int(max_steps) // seg_steps)),
        max_attempts=int(max_steps), rhs_bundle=bundle, method=method,
        jac_window=jac_window)
    y_end = res.y[0].cpu().numpy()
    ts, ys, truncated = trim_trajectory(
        0.0, y0.cpu().numpy(), res.ts[0].numpy(), res.ys[0].numpy(),
        res.n_saved[0], res.n_accepted[0], res.t[0], y_end)
    return (_status_str(res.status[0]), float(res.t[0]), y_end, ts, ys,
            truncated, int(res.n_accepted[0]), int(res.n_rejected[0]))


def _programmatic_run(inlet_comp, T, p, time, *, Asv, chem, thermo_obj, md,
                      kc_compat, asv_quirk, exp32, device, solve_kw):
    """Dict-in/dict-out form: ``(accepted_times, {species: final x})``.
    Gas (``md`` a GasMechanism) or surface (``md`` a SurfaceMechanism),
    never both, as in the reference."""
    if chem.surfchem and chem.gaschem:
        # the reference's programmatic method overwrites the surface
        # parameters with the gas ones when both flags are set
        raise ValueError("programmatic API supports exactly one of "
                         "surfchem/gaschem per call (as the reference does)")
    if chem.surfchem:
        mode, gm, sm = "surf", None, md
    elif chem.gaschem:
        mode, gm, sm = "gas", md, None
    else:
        raise ValueError("programmatic API needs surfchem or gaschem")
    device = resolve_device(device)
    thermo_obj = thermo_obj.to(device)
    gm = gm.to(device) if gm is not None else None
    sm = sm.to(device) if sm is not None else None
    species = thermo_obj.species
    comp_text = ",".join(f"{k}={v}" for k, v in inlet_comp.items())
    x0 = parse_composition_text(comp_text, species)
    y0 = get_solution_vector(x0, thermo_obj.molwt, float(T), float(p),
                             ini_covg=sm.ini_covg if sm is not None else None)
    status, t_end, y_end, ts, _, _, _, _ = _run_solve(
        _segmented_builder(mode, None, kc_compat, asv_quirk, exp32),
        (gm, sm, thermo_obj), y0, T, Asv, time, **solve_kw)
    if status != "Success":
        raise RuntimeError(
            f"batch_reactor integration failed with {status} at "
            f"t={t_end:.4e} of {float(time):.4e} s")
    ng = len(species)
    moles = y_end[:ng] / thermo_obj.molwt.cpu().numpy()
    x_end = moles / moles.sum()
    return ts, dict(zip(species, x_end.tolist()))


def _default_theta(gm, sm):
    """(spec, theta) of the ``sens=True`` hook: every reaction's ln A of
    the primary mechanism (gas if present, else surface), or (None, None)
    without a mechanism (userchem)."""
    from .sensitivity import params as sp_mod

    mech = gm if gm is not None else sm
    if mech is None:
        return None, None
    spec = sp_mod.select(mech)
    return spec, sp_mod.extract(mech, spec)


def _host_tree(d):
    return {k: v.detach().cpu().numpy() for k, v in d.items()}


def _sensitivity_run(sens, mode, id_, y0, cfg, surf_species, *,
                     sens_params, sens_qoi, sens_grid, rtol, atol,
                     max_steps, kc_compat, asv_quirk, exp32, method,
                     jac_window, segmented):
    """Solve with sensitivities (``sens="forward"|"adjoint"``), one lane;
    returns a :class:`SensitivitySolution`.  ``y0`` (n,) and ``cfg`` come
    from the plain solve's construction in :func:`_file_driven_run`."""
    from .sensitivity import adjoint as adj_mod
    from .sensitivity import forward as fwd_mod
    from .sensitivity import params as sp_mod

    if mode == "udf":
        raise ValueError(
            "sens='forward'/'adjoint' needs a mechanism-driven run: "
            "user-defined chemistry has no named mechanism parameters")
    if method != "bdf":
        raise ValueError(
            f"sens={sens!r} rides the BDF step machinery; method={method!r}"
            " is unsupported — drop the argument or pass method='bdf'")
    if segmented is not None:
        # sensitivity solves run monolithically: the tangent/adjoint state
        # is not part of the segmented carry
        raise ValueError(
            f"sens={sens!r} solves run monolithically; the tangent/"
            f"adjoint state does not resume across segments — drop the "
            f"segmented argument")
    gm, sm, thermo = id_.gmd, id_.smd, id_.thermo

    # ---- parameter selection: theta lives on one mechanism -----------------
    if isinstance(sens_params, sp_mod.ParamSpec):
        spec = sens_params
    else:
        mech = gm if gm is not None else sm
        spec = sp_mod.select(mech, **dict(sens_params or {}))
    if spec.kind == "gas":
        if gm is None:
            raise ValueError("gas-parameter spec on a run without gaschem")
        theta = sp_mod.extract(gm, spec)

        def mechs_at(th):
            return sp_mod.apply(gm, th, spec), sm
    else:
        if sm is None:
            raise ValueError("surface-parameter spec on a run without "
                             "surfchem")
        theta = sp_mod.extract(sm, spec)

        def mechs_at(th):
            return gm, sp_mod.apply(sm, th, spec)

    # the theta-parameterized RHS/Jacobian through the plain solve's mode
    # dispatch: the sensitivity runs differ from it only by the tangent or
    # adjoint machinery
    def rhs_theta(t, y, theta, cfg):
        gmm, smm = mechs_at(theta)
        return _make_rhs(mode, None, gmm, smm, thermo, kc_compat,
                         asv_quirk, exp32)(t, y, cfg)

    def jac_theta(t, y, theta, cfg):
        gmm, smm = mechs_at(theta)
        return _make_jac(mode, gmm, smm, thermo, kc_compat, asv_quirk,
                         exp32)(t, y, cfg)

    jac_window = resolve_jac_window(jac_window, method, y0.device)
    names = sp_mod.names(spec)

    # ---- QoI resolution ----------------------------------------------------
    qoi_fn = qoi_idx = None
    if sens_qoi is not None:
        idx = {s.upper(): k for k, s in enumerate(id_.species)}
        if isinstance(sens_qoi, str):
            key = sens_qoi.upper()
            if key not in idx:
                raise KeyError(f"sens_qoi species {sens_qoi!r} not in the "
                               f"gas-phase species list")
            qoi_idx = idx[key]
            qoi_fn = adj_mod.final_species_qoi(qoi_idx)
        elif (isinstance(sens_qoi, tuple) and sens_qoi
              and sens_qoi[0] == "ignition"):
            if sens == "forward":
                raise ValueError(
                    "ignition-delay QoIs need the trajectory-aware adjoint "
                    "backward pass; use sens='adjoint'")
            key = sens_qoi[1].upper()
            if key not in idx:
                raise KeyError(f"ignition marker {sens_qoi[1]!r} not in the "
                               f"gas-phase species list")
            frac = float(sens_qoi[2]) if len(sens_qoi) > 2 else 0.5
            qoi_fn = adj_mod.ignition_delay_qoi(idx[key], frac=frac)
        else:
            raise ValueError(
                f"sens_qoi must be a species name or ('ignition', marker"
                f"[, frac]); got {sens_qoi!r}")

    y0b = y0[None]
    if sens == "forward":
        def jac_fixed(t, y, cfg):
            return jac_theta(t, y, theta, cfg)

        # tangent error control on: the caller never sees the controller,
        # and a few more steps buy tighter tangents
        res = fwd_mod.solve_forward(
            rhs_theta, y0b, 0.0, id_.tf, theta, cfg, rtol=rtol, atol=atol,
            max_steps=max_steps, jac=jac_fixed, jac_window=jac_window,
            sens_errcon=True)
        S = res.tangents[0]
        qoi = qoi_grad = None
        if qoi_idx is not None:
            # a final-state QoI from forward tangents is one slice
            qoi = float(res.y[0, qoi_idx])
            _, unflat = sp_mod.flatten(theta)
            qoi_grad = _host_tree(unflat(S[:, qoi_idx]))
        return SensitivitySolution(
            status=_status_str(res.status[0]), t=float(res.t[0]),
            y=res.y[0].cpu().numpy(), species=id_.species,
            surface_species=surf_species, spec=spec, theta=theta,
            names=names, tangents=S.cpu().numpy(), qoi=qoi,
            qoi_grad=qoi_grad, n_accepted=int(res.n_accepted[0]),
            n_rejected=int(res.n_rejected[0]))

    # ---- adjoint -----------------------------------------------------------
    if qoi_fn is None:
        raise ValueError(
            "sens='adjoint' differentiates a scalar QoI: pass "
            "sens_qoi=<species name> (final mass density) or "
            "sens_qoi=('ignition', marker_species[, frac])")
    # segments is not an API knob: round the grid up to the adjoint's
    # segment count (the buffer size is a capacity, not a semantic)
    sens_grid = max(8, -(-int(sens_grid) // 8) * 8)
    qoi, grad, aux = adj_mod.solve_adjoint(
        rhs_theta, qoi_fn, y0b, 0.0, id_.tf, theta, cfg,
        jac_theta=jac_theta, rtol=rtol, atol=atol, grid_size=sens_grid,
        segments=8, max_steps=max_steps, jac_window=jac_window)
    truncated = bool(aux["truncated"][0])
    if truncated:
        # unconditional: a truncated grid means the re-solve stopped short
        # of t1 and the gradient is for the wrong horizon
        print(f"warning: adjoint grid buffer full (the grid-pinning pass "
              f"accepted {int(aux['n_accepted'][0])} steps > sens_grid="
              f"{sens_grid}); the fixed-grid re-solve lost resolution — "
              f"raise sens_grid", file=sys.stderr)
    return SensitivitySolution(
        status=_status_str(aux["status"][0]), t=float(aux["t"][0]),
        y=aux["y"][0].cpu().numpy(), species=id_.species,
        surface_species=surf_species, spec=spec, theta=theta, names=names,
        qoi=float(qoi[0]), qoi_grad=_host_tree(grad),
        n_accepted=int(aux["n_accepted"][0]),
        n_rejected=int(aux["n_rejected"][0]), truncated=truncated)


def _file_driven_run(input_file, lib_dir, chem, sens=None, *, n_save,
                     kc_compat, asv_quirk, exp32, verbose, device, solve_kw,
                     sens_kw=None):
    """Parse the XML, solve, write the profile files next to it and
    return the status string; with ``sens`` (normalized by
    :func:`_normalize_sens`) return the :class:`SensitivityProblem` or the
    :class:`SensitivitySolution` instead, writing no files."""
    mode = _mode(chem)
    id_ = input_data(input_file, lib_dir, chem, device=device)
    surf_species = id_.smd.species if id_.smd is not None else None
    y0 = get_solution_vector(
        id_.mole_fracs, id_.thermo.molwt, id_.T, id_.p,
        ini_covg=id_.smd.ini_covg if id_.smd is not None else None)
    if sens is not None:
        dev = y0.device
        cfg = {"T": torch.full((1,), float(id_.T), dtype=torch.float64,
                               device=dev),
               "Asv": torch.full((1,), float(id_.Asv), dtype=torch.float64,
                                 device=dev)}
        if sens == "hook":
            spec, theta = _default_theta(id_.gmd, id_.smd)
            return SensitivityProblem(
                rhs=_make_rhs(mode, chem.udf, id_.gmd, id_.smd, id_.thermo,
                              kc_compat, asv_quirk, exp32),
                y0=y0, cfg=cfg, t_span=(0.0, id_.tf), species=id_.species,
                surface_species=surf_species, theta=theta, spec=spec)
        return _sensitivity_run(
            sens, mode, id_, y0, cfg, surf_species, kc_compat=kc_compat,
            asv_quirk=asv_quirk, exp32=exp32, rtol=solve_kw["rtol"],
            atol=solve_kw["atol"], max_steps=solve_kw["max_steps"],
            method=solve_kw["method"], jac_window=solve_kw["jac_window"],
            segmented=solve_kw["segmented"], **sens_kw)
    status, t_end, _, ts, ys, truncated, n_acc, n_rej = _run_solve(
        _segmented_builder(mode, chem.udf, kc_compat, asv_quirk, exp32),
        (id_.gmd, id_.smd, id_.thermo), y0, id_.T, id_.Asv, id_.tf,
        **solve_kw)
    if verbose:
        # the reference prints every accepted time (@printf("%4e\n",t));
        # ts[0] is the initial row and a truncated run's last row is a
        # final-state bridge, neither an accepted step
        for tv in (ts[1:-1] if truncated else ts[1:]):
            print(f"{tv:4e}")
    if truncated:
        print(f"warning: trajectory buffer full "
              f"({n_acc} accepted steps > n_save={n_save}); "
              f"profile files skip the overflow but end at the true final "
              f"state", file=sys.stderr)
    out_dir = os.path.dirname(os.path.abspath(input_file))
    write_profiles(out_dir, id_.species, ts, ys, id_.T,
                   id_.thermo.molwt.cpu().numpy(),
                   surface_species=surf_species)
    if verbose:
        print(f"t = {t_end:.4e} s  "
              f"({n_acc} accepted / {n_rej} rejected steps)")
    return status


def batch_reactor(*args, sens=False, surfchem=False, gaschem=False, Asv=1.0,
                  chem=None, thermo_obj=None, md=None, rtol=1e-6, atol=1e-10,
                  n_save=16384, max_steps=200_000, kc_compat=False,
                  asv_quirk=True, verbose=True, segmented=None, method="bdf",
                  jac_window=None, sens_params=None, sens_qoi=None,
                  sens_grid=512, exp32=False, device=None, **deferred):
    """Simulate an isothermal constant-volume batch reactor.

    File-driven:   ``batch_reactor(input_file, lib_dir, surfchem=,
        gaschem=)`` -> ``"Success" | ...``; writes ``gas_profile.{dat,csv}``
        (and ``surface_covg.{dat,csv}`` with surface chemistry) next to
        the input file and, with ``verbose``, prints every accepted step
        time and a summary line, as the reference does.
    User-defined:  ``batch_reactor(input_file, lib_dir, udf)`` with
        ``udf(t, state) -> source (S,)`` [mol/m^3/s] written in torch
        (``ops.rhs.make_udf_rhs``); the XML lists ``<gasphase>``.
    Programmatic:  ``batch_reactor(inlet_comp, T, p, time, Asv=, chem=,
        thermo_obj=, md=)`` -> ``(times, {species: final x})``, gas or
        surface chemistry.

    ``segmented=None``/``True`` runs the solve in segments of at most 512
    attempts; ``False`` in one segment of ``max_steps``.  ``method`` is
    ``"bdf"`` or ``"sdirk"``; ``jac_window`` follows
    :func:`resolve_jac_window`.

    ``sens`` (file-driven forms): ``False`` solves; ``True`` returns the
    problem unsolved as a :class:`SensitivityProblem`; ``"forward"`` solves
    with staggered forward tangents riding the BDF loop (tangent error
    control on) and returns a :class:`SensitivitySolution` with the (P, n)
    block dy(t_end)/dtheta; ``"adjoint"`` solves, then differentiates a
    scalar QoI at a cost independent of the parameter count (needs
    ``sens_qoi``).  ``sens_params`` selects theta: ``None`` = every
    reaction's ln A of the primary mechanism, a dict of
    ``sensitivity.params.select`` keywords, or a ``ParamSpec``.
    ``sens_qoi`` is a gas species name (final mass density) or
    ``("ignition", marker[, frac])`` (adjoint only); ``sens_grid`` sizes
    the adjoint's fixed re-solve grid.  Sensitivity runs are BDF,
    monolithic (``segmented`` unset) and write no profile files."""
    check_deferred(deferred, _RUN_DEFERRED)
    sens = _normalize_sens(sens)
    if method not in ("bdf", "sdirk"):
        raise ValueError(f"unknown method {method!r}; use 'sdirk'/'bdf'")
    solve_kw = dict(rtol=rtol, atol=atol, n_save=n_save, max_steps=max_steps,
                    method=method, jac_window=jac_window,
                    segmented=segmented)
    chem_kw = dict(kc_compat=kc_compat, asv_quirk=asv_quirk, exp32=exp32,
                   device=device, solve_kw=solve_kw)
    if args and isinstance(args[0], dict):
        if len(args) != 4:
            raise TypeError(
                "programmatic form: batch_reactor(inlet_comp, T, p, time, "
                "Asv=..., chem=..., thermo_obj=..., md=...)")
        if chem is None or thermo_obj is None or md is None:
            raise TypeError("programmatic form needs chem=, thermo_obj=, md=")
        if sens is not None:
            # the reference's programmatic method has no sens hook either;
            # ignoring it would report a plain solve as a sensitivity run
            raise ValueError(
                "sens is a file-driven-form knob; the programmatic "
                "dict-in/dict-out form does not support it")
        return _programmatic_run(*args, Asv=Asv, chem=chem,
                                 thermo_obj=thermo_obj, md=md, **chem_kw)
    if len(args) == 3 and callable(args[2]):
        chem = Chemistry(False, False, True, args[2])
    elif len(args) == 2:
        if chem is None:
            chem = Chemistry(surfchem=surfchem, gaschem=gaschem)
    else:
        raise TypeError(
            f"unrecognized batch_reactor argument pattern: {args!r}")
    return _file_driven_run(
        args[0], args[1], chem, sens, n_save=n_save, verbose=verbose,
        sens_kw=dict(sens_params=sens_params, sens_qoi=sens_qoi,
                     sens_grid=sens_grid), **chem_kw)
