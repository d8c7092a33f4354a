"""Ensemble sweeps: one reactor condition per lane, lane-batched.

Port of ``batchreactor_tpu/parallel/sweep.py``: :func:`ensemble_solve`
(one solver call over the whole horizon), its forward-sensitivity twin
:func:`ensemble_solve_forward`, :func:`ensemble_solve_segmented`
(the segment loop, park/budget, the ``n_save`` drain, ``progress``),
:func:`temperature_sweep`, :func:`sweep_report`, :func:`ignition_observer`
and :func:`ignition_delay`.  Both solvers run under both entry points
(``method="bdf"`` or ``"sdirk"``).  A segment is one solver call bounded to
``segment_steps`` attempts per lane; between segments the host parks
terminated lanes and resumes the others from the carried state (BDF's
history, SDIRK's step size and PI memory), as the JAX package's blocking
gear does (its pipelined gear is bit-exact with that one).  In the port
the segment length is the stride at which the host polls the sweep and
drains trajectory rows.

Functions take the device of the tensors they are given.  Not ported yet
(``NotImplementedError``): ``mesh`` (a collective-free split of the lanes
over several GPUs, ROADMAP A12), the admission/refill, buckets,
pipeline-gear, upshift and live knobs (A13), ``stats``/``recorder``/
``timeline`` (A14) and ``fetch_deadline`` (A12).
"""

import numpy as np
import torch

from ..solver import bdf, sdirk
from ..solver.common import (DT_UNDERFLOW, MAX_STEPS_REACHED, RUNNING,
                             SUCCESS, SolveResult, check_deferred)
from ..solver.linalg import factor_zeros, resolve_linsolve

_SOLVERS = {"sdirk": sdirk.solve, "bdf": bdf.solve}

# (keyword, default, ROADMAP item) of the JAX sweep's options that wait
# for a later slice
_DEFERRED = (
    ("mesh", None, "A12"), ("stats", False, "A14"),
    ("recorder", None, "A14"), ("watch", None, "A14"),
    ("pipeline", None, "A13"), ("poll_every", None, "A13"),
    ("buckets", None, "A13"), ("fetch_deadline", None, "A12"),
    ("admission", None, "A13"), ("refill", None, "A13"),
    ("mesh_resident", None, "A13"), ("upshift", None, "A13"),
    ("timeline", None, "A14"), ("live", None, "A14"),
    ("rhs_bundle", None, "A13"), ("axis", "batch", "A12"),
    ("upshift_patience", 2, "A13"), ("_on_harvest", None, "A13"),
    ("_feed", None, "A13"), ("_live_source", "sweep", "A14"),
)


# (keyword, default, ROADMAP item) of the monolithic solve's deferred options
_MONO_DEFERRED = (("mesh", None, "A12"), ("axis", "batch", "A12"),
                  ("stats", False, "A14"), ("buckets", None, "A13"),
                  ("timeline", None, "A14"))


def _check_method(method, newton_tol):
    if method not in _SOLVERS:
        raise ValueError(f"unknown method {method!r}; use "
                         f"{sorted(_SOLVERS)}")
    if method != "sdirk" and newton_tol != 0.03:
        # bdf derives its Newton tolerance from rtol, CVODE-style
        raise ValueError(
            f"newton_tol is an sdirk-only knob; method={method!r} "
            f"got newton_tol={newton_tol}")


def _solver_kw(method, newton_tol, jac_window, setup_economy, stale_tol,
               freeze_precond=False):
    """The method-specific keywords of one solver call."""
    if method == "sdirk":
        return {"jac_window": jac_window, "newton_tol": newton_tol}
    return {"jac_window": jac_window, "freeze_precond": freeze_precond,
            "setup_economy": setup_economy, "stale_tol": stale_tol}


def _lane_obs(observer, observer_init, B, dt, dev):
    """``observer_init`` broadcast to (B,) lanes (None without observer)."""
    if observer is None:
        return None
    return {k: torch.as_tensor(v, dtype=dt, device=dev).expand(B).clone()
            for k, v in observer_init.items()}


def ensemble_solve(rhs, y0s, t0, t1, cfgs, *, rtol=1e-6, atol=1e-10,
                   max_steps=200_000, n_save=0, dt0=None, dt_min_factor=1e-22,
                   linsolve="auto", jac=None, observer=None,
                   observer_init=None, jac_window=1, newton_tol=0.03,
                   method="bdf", freeze_precond=False, setup_economy=False,
                   stale_tol=0.3, **deferred):
    """Solve every lane of ``y0s`` (B, n) over [t0, t1] in one solver call
    of at most ``max_steps`` attempts per lane.  ``cfgs`` is a dict of
    per-lane tensors; ``t0``/``t1`` are shared.  Returns the solver's
    SolveResult.

    ``method`` is ``"bdf"`` or ``"sdirk"``; ``newton_tol`` is SDIRK's and
    ``freeze_precond``/``setup_economy``/``stale_tol`` are BDF's (each
    raises under the other method).  ``linsolve="auto"`` resolves here
    with the sweep's B and n (``solver.linalg.resolve_linsolve``), so
    ``"lu32p"`` self-selects for BDF on the GPU at B * n >= LU32P_MIN_BN.
    ``observer_init`` may hold Python floats; they are broadcast to (B,)
    lanes."""
    check_deferred(deferred, _MONO_DEFERRED)
    _check_method(method, newton_tol)
    if freeze_precond and method != "bdf":
        raise ValueError(
            f"freeze_precond is a bdf-only knob; method={method!r}")
    if setup_economy and method != "bdf":
        raise ValueError(
            f"setup_economy is a bdf-only knob; method={method!r}")
    B, n = y0s.shape
    dt, dev = y0s.dtype, y0s.device
    linsolve = resolve_linsolve(linsolve, method=method, device=dev,
                                batch=B, n=n)
    return _SOLVERS[method](
        rhs, y0s, float(t0), float(t1), cfgs, rtol=rtol, atol=atol,
        max_steps=max_steps, n_save=n_save, dt0=dt0,
        dt_min_factor=dt_min_factor, linsolve=linsolve, jac=jac,
        observer=observer,
        observer_init=_lane_obs(observer, observer_init, B, dt, dev),
        **_solver_kw(method, newton_tol, jac_window, setup_economy,
                     stale_tol, freeze_precond))


# (keyword, default, ROADMAP item) of the forward sweep's deferred options
_FWD_DEFERRED = (("mesh", None, "A12"), ("axis", "batch", "A12"),
                 ("stats", False, "A14"))


def ensemble_solve_forward(rhs_theta, y0s, t0, t1, theta, cfgs, *,
                           rtol=1e-6, atol=1e-10, max_steps=200_000,
                           jac=None, jac_window=1, linsolve="auto",
                           sens_iters=2, S0=None, **deferred):
    """Forward-sensitivity ensemble sweep: one theta, per-lane conditions.

    The sensitivity twin of :func:`ensemble_solve`: every lane integrates
    state and tangents S = dy/dtheta in one tangent-carrying BDF solve
    (``sensitivity.forward.solve_forward``); ``result.tangents`` is
    (B, P, n) with rows in ``sensitivity.params.names`` order.  The
    tangents leave the state's step grid as the plain solve takes it.

    ``rhs_theta(t, y, theta, cfg)`` is the theta-parameterized RHS
    (``sensitivity.params.make_rhs_theta``); ``theta`` (a dict of (K,)
    tensors) is shared by the lanes.  ``jac`` is the analytic Jacobian at
    that theta.  ``S0`` defaults to zeros.  ``linsolve="auto"`` resolves
    with the sweep's B and n (``solver.linalg.resolve_linsolve``), so a
    GRI-3.0 sweep at B = 1024 takes ``"lu32p"`` on the GPU and every
    tangent solve goes through the kernel's factor."""
    from ..sensitivity.forward import solve_forward

    check_deferred(deferred, _FWD_DEFERRED)
    B, n = y0s.shape
    linsolve = resolve_linsolve(linsolve, method="bdf", device=y0s.device,
                                batch=B, n=n)
    return solve_forward(rhs_theta, y0s, float(t0), float(t1), theta, cfgs,
                         rtol=rtol, atol=atol, max_steps=max_steps, jac=jac,
                         jac_window=jac_window, linsolve=linsolve,
                         sens_iters=sens_iters, S0=S0)


def temperature_sweep(rhs, y0, T_grid, t1, base_cfg=None, **kw):
    """One initial state ``y0`` (n,) swept over a temperature grid (B,),
    on ``y0``'s device: ``cfg["T"]`` is the grid, ``base_cfg`` values are
    broadcast to the lanes, and ``kw`` goes to :func:`ensemble_solve`."""
    dt, dev = y0.dtype, y0.device
    T_grid = torch.as_tensor(T_grid, dtype=dt, device=dev)
    B = T_grid.shape[0]
    y0s = y0.expand((B,) + tuple(y0.shape)).clone()
    cfg = {k: torch.as_tensor(v, dtype=dt, device=dev).expand(B).clone()
           for k, v in (base_cfg or {}).items()}
    cfg["T"] = T_grid
    return ensemble_solve(rhs, y0s, 0.0, t1, cfg, **kw)


def ensemble_solve_segmented(rhs, y0s, t0, t1, cfgs, *, segment_steps=1024,
                             max_segments=10_000, max_attempts=None,
                             progress=None, rtol=1e-6, atol=1e-10,
                             linsolve="auto", jac=None, observer=None,
                             observer_init=None, dt_min_factor=1e-22,
                             n_save=0, jac_window=1, newton_tol=0.03,
                             method="bdf", setup_economy=False,
                             stale_tol=0.3, **deferred):
    """Solve every lane of ``y0s`` (B, n) over [t0, t1] with the device
    work bounded to ``segment_steps`` step attempts per lane per segment;
    the host loops segments until every lane terminates.

    State carried between segments: per-lane (t, y, next h, observer fold,
    and BDF's history with, under ``setup_economy``, the carried
    factorization, or SDIRK's PI controller memory ``err_prev``).
    A lane that terminates is parked at ``t1`` so later segments hold it
    (a zero-span solve).  ``max_attempts`` bounds accepted + rejected
    attempts per lane across segments, parking a lane that reaches it
    with MAX_STEPS_REACHED.  ``n_save`` > 0 keeps the first ``n_save``
    accepted rows per lane in host arrays; each segment's device buffer is
    ``min(n_save, segment_steps)`` rows.  ``progress(payload)`` is called
    after every segment with the segment index, lanes done, lane count,
    accepted total and, with ``n_save``, the accepted times drained.

    ``linsolve="auto"`` resolves here with the sweep's B and n
    (``solver.linalg.resolve_linsolve``), so ``"lu32p"`` self-selects on
    the GPU at B * n >= LU32P_MIN_BN.  ``observer_init`` may hold Python
    floats; they are broadcast to (B,) lanes.
    """
    check_deferred(deferred, _DEFERRED)
    _check_method(method, newton_tol)
    if setup_economy and method != "bdf":
        raise ValueError(
            f"setup_economy is a bdf-only knob; method={method!r}")
    if max_segments < 1:
        raise ValueError(f"max_segments must be >= 1, got {max_segments}")
    B, n = y0s.shape
    dt, dev = y0s.dtype, y0s.device
    seg_save = min(int(n_save), int(segment_steps)) if n_save else 0
    linsolve = resolve_linsolve(linsolve, method=method, device=dev,
                                batch=B, n=n)
    # at jac_window=1 economy is a structural no-op and the solver returns
    # the 4-tuple state, so the segment carry does not grow the economy slot
    economy = bool(setup_economy) and jac_window > 1 and method == "bdf"
    t1 = float(t1)

    y = y0s
    t = torch.full((B,), float(t0), dtype=dt, device=dev)
    h = torch.full((B,), -1.0, dtype=dt, device=dev)  # <=0: heuristic step
    e = torch.full((B,), -1.0, dtype=dt, device=dev)  # <=0: fresh PI memory
    obs = _lane_obs(observer, observer_init, B, dt, dev)
    sstate = None
    if method == "bdf":
        sstate = (torch.zeros((B, bdf.MAXORD + 3, n), dtype=dt,
                              device=dev),
                  torch.ones(B, dtype=torch.int64, device=dev),
                  torch.full((B,), -1.0, dtype=dt, device=dev),
                  torch.zeros(B, dtype=torch.int64, device=dev))
    if economy:
        sstate = sstate + ({
            "fac": factor_zeros(linsolve, B, n, dt, dev),
            "c0": torch.zeros(B, dtype=dt, device=dev),
            "ok": torch.zeros(B, dtype=torch.bool, device=dev),
            "age": torch.zeros(B, dtype=torch.int64, device=dev)},)

    final_status = np.full((B,), RUNNING, dtype=np.int32)
    final_t = np.full((B,), np.nan)
    n_acc = np.zeros((B,), dtype=np.int64)
    n_rej = np.zeros((B,), dtype=np.int64)
    if n_save:
        all_ts = np.full((B, int(n_save)), np.inf)
        all_ys = np.zeros((B, int(n_save), n))
        saved = np.zeros((B,), dtype=np.int64)
    seg_t = None
    for seg in range(max_segments):
        kw = _solver_kw(method, newton_tol, jac_window, setup_economy,
                        stale_tol)
        kw.update({"err0": e} if method == "sdirk"
                  else {"solver_state": sstate})
        res = _SOLVERS[method](
            rhs, y, t, t1, cfgs, rtol=rtol, atol=atol,
            max_steps=segment_steps, n_save=seg_save, dt0=h,
            dt_min_factor=dt_min_factor, linsolve=linsolve, jac=jac,
            observer=observer, observer_init=obs, **kw)
        status = res.status.cpu().numpy()
        seg_acc = res.n_accepted.cpu().numpy()
        seg_rej = res.n_rejected.cpu().numpy()
        seg_t = res.t.cpu().numpy()
        # only lanes still live this segment contribute step counts: parked
        # lanes re-enter as zero-span solves
        running = final_status == RUNNING
        n_acc += np.where(running, seg_acc, 0)
        n_rej += np.where(running, seg_rej, 0)
        drained_ts = None
        if n_save:
            seg_n = res.n_saved.cpu().numpy()
            take = np.where(running, np.minimum(seg_n, int(n_save) - saved),
                            0)
            if take.max() > 0:
                seg_ts = res.ts.cpu().numpy()
                seg_ys = res.ys.cpu().numpy()
                col = np.arange(seg_ts.shape[1])
                src = col[None, :] < take[:, None]
                b_idx, c_idx = np.nonzero(src)
                dst = saved[b_idx] + c_idx
                all_ts[b_idx, dst] = seg_ts[b_idx, c_idx]
                all_ys[b_idx, dst] = seg_ys[b_idx, c_idx]
                saved += take
                drained_ts = seg_ts[b_idx, c_idx]
        terminal = status != MAX_STEPS_REACHED
        newly_terminal = running & terminal
        final_status = np.where(newly_terminal, status, final_status)
        # a terminal lane reports the t of the segment where it terminated
        final_t = np.where(newly_terminal, seg_t, final_t)
        if max_attempts is not None:
            exhausted = (final_status == RUNNING) & (
                n_acc + n_rej >= int(max_attempts))
            final_status = np.where(exhausted, MAX_STEPS_REACHED,
                                    final_status)
            final_t = np.where(exhausted, seg_t, final_t)
        parked = torch.as_tensor(final_status != RUNNING, device=dev)
        was_parked = torch.as_tensor(~running, device=dev)
        t = torch.where(parked, t1, res.t)
        y = res.y
        # lanes parked before this segment keep their last live h (and PI
        # memory)
        h = torch.where(was_parked, h, res.h)
        if method == "sdirk":
            e = torch.where(was_parked, e, res.err_prev)
        else:
            sstate = res.solver_state
        if observer is not None:
            obs = res.observed
        done = not bool(np.any(final_status == RUNNING))
        if progress is not None:
            payload = {"segment": seg, "lanes_done": int(
                (final_status != RUNNING).sum()), "n_lanes": B,
                "accepted_total": int(n_acc.sum())}
            if drained_ts is not None:
                payload["drained_ts"] = drained_ts
            progress(payload)
        if done:
            break
    else:
        final_status[final_status == RUNNING] = MAX_STEPS_REACHED
    # lanes that never terminated (budget exhausted) report their current t
    final_t = np.where(np.isnan(final_t), seg_t, final_t)

    if n_save:
        ts_out = torch.as_tensor(all_ts, dtype=dt)
        ys_out = torch.as_tensor(all_ys, dtype=dt)
        n_saved_out = torch.as_tensor(saved)
    else:
        ts_out, ys_out, n_saved_out = res.ts, res.ys, res.n_saved
    return SolveResult(
        t=torch.as_tensor(final_t, dtype=dt),
        y=y, status=torch.as_tensor(final_status),
        n_accepted=torch.as_tensor(n_acc), n_rejected=torch.as_tensor(n_rej),
        ts=ts_out, ys=ys_out, n_saved=n_saved_out, h=h,
        observed=obs if observer is not None else None,
        err_prev=e if method == "sdirk" else None, solver_state=sstate)


def sweep_report(res, cfgs=None):
    """Failure-detection summary for an ensemble SolveResult: per-status
    lane counts, indices of failed lanes, the accepted and rejected steps
    per lane (min, max, mean) and, with ``cfgs``, the offending parameter
    values per failed lane."""
    status = res.status.cpu().numpy()
    names = {SUCCESS: "success", MAX_STEPS_REACHED: "max_steps",
             DT_UNDERFLOW: "dt_underflow", RUNNING: "running"}
    counts = {names.get(int(s), str(int(s))): int((status == s).sum())
              for s in np.unique(status)}
    failed = np.nonzero(status != SUCCESS)[0]
    n_acc = res.n_accepted.cpu().numpy()
    n_rej = res.n_rejected.cpu().numpy()
    report = {
        "n_lanes": int(status.shape[0]),
        "counts": counts,
        "failed_lanes": failed.tolist(),
        "n_accepted": {"min": int(np.min(n_acc)), "max": int(np.max(n_acc)),
                       "mean": float(np.mean(n_acc))},
        "n_rejected": {"min": int(np.min(n_rej)), "max": int(np.max(n_rej)),
                       "mean": float(np.mean(n_rej))},
    }
    if cfgs is not None and failed.size:
        report["failed_conditions"] = {
            k: v.cpu().numpy()[failed].tolist() for k, v in cfgs.items()}
    return report


def ignition_observer(marker, mode="half", frac=0.5):
    """(observer, init) pair extracting ignition delay during the solve.

    ``mode="half"`` records the first accepted time the marker species
    drops below ``frac`` x its first-seen value, linearly interpolated
    between the bracketing accepted steps (fuel-consumption marker);
    ``mode="peak"`` records the time of the running maximum.  The fold is
    lane-batched: ``observer(t (B,), y (B, S), acc) -> acc``; ``init``
    holds Python floats (the sweep driver broadcasts them to lanes).  Read
    ``observed["tau"]`` (NaN where never crossed)."""
    if mode == "half":
        nan = float("nan")
        init = {"m0": nan, "tau": nan, "t_prev": nan, "m_prev": nan}

        def observer(t, y, acc):
            m = y[:, marker]
            m0 = torch.where(torch.isnan(acc["m0"]), m, acc["m0"])
            thr = frac * m0
            crossed = torch.isnan(acc["tau"]) & (m < thr)
            denom = acc["m_prev"] - m
            w = torch.where(denom != 0, (acc["m_prev"] - thr) / denom, 1.0)
            w = torch.clamp(w, 0.0, 1.0)
            t_x = torch.where(torch.isnan(acc["t_prev"]), t,
                              acc["t_prev"] + w * (t - acc["t_prev"]))
            return {"m0": m0, "tau": torch.where(crossed, t_x, acc["tau"]),
                    "t_prev": t, "m_prev": m}

    elif mode == "peak":
        init = {"m_max": -float("inf"), "tau": float("nan")}

        def observer(t, y, acc):
            m = y[:, marker]
            higher = m > acc["m_max"]
            return {"m_max": torch.maximum(m, acc["m_max"]),
                    "tau": torch.where(higher, t, acc["tau"])}

    else:
        raise ValueError(f"unknown ignition observer mode {mode!r}")
    return observer, init


def ignition_delay(ts, ys, marker, mode="peak"):
    """Per-lane ignition delay from saved trajectories, (B,):
    ``mode="peak"`` gives the time of the marker species' maximum (e.g.
    OH), ``"half"`` the first time it drops below half its initial value
    (fuel consumption), or the last valid time where it never does.
    ``ts`` (B, n_save) +inf-padded, ``ys`` (B, n_save, S), ``marker`` a
    species index.  Energy-mode sweeps get the physical detector in-loop
    instead (``energy/ignition.py``, ``out["ignition_delay"]``)."""
    c = ys[..., marker]
    valid = torch.isfinite(ts)
    if mode == "peak":
        idx = torch.argmax(torch.where(valid, c, -torch.inf), dim=-1)
    elif mode == "half":
        below = valid & (c < 0.5 * c[..., :1])
        idx = torch.argmax(below.to(torch.uint8), dim=-1)
        last = torch.sum(valid, dim=-1) - 1
        idx = torch.where(torch.any(below, dim=-1), idx, last)
    else:
        raise ValueError(f"unknown ignition-delay mode {mode!r}")
    return torch.gather(ts, -1, idx[..., None])[..., 0]
