"""Lane-batched SDIRK4 + Newton — the one-step stiff integrator.

Port of ``batchreactor_tpu/solver/sdirk.py``: the classic L-stable,
stiffly accurate SDIRK4 of Hairer & Wanner (Solving ODEs II, Table 6.5),
5 stages with gamma = 1/4 on the whole diagonal, order 4 with an embedded
order-3 error estimate and a PI step-size controller.  One Jacobian and
one factorization of M = I - h gamma J per step attempt serve all five
stage Newton solves.

The JAX solve is per lane under ``vmap``; here the lane axis is written
out, as in :mod:`.bdf`:

* the step loop runs while any lane is RUNNING, and ``step_once`` itself
  holds the carry of a lane that is not (so a lane that terminates inside
  a ``jac_window`` idles for the rest of the window, as under ``vmap``);
* each stage's Newton loop updates only lanes that have neither converged
  nor diverged, and lanes whose attempt is discarded anyway (terminated
  ones) do not iterate at all.

The any-lane tests are host syncs (:func:`solve`, the blocking gear);
:func:`make_stepper`'s ``window(carry, fixed=True)`` runs every trip under
the masks instead, for a captured graph (``solver/graphs.py``).
``stats=True`` and ``timeline=N`` add the counter block and the attempt
ring to the carry, as in :mod:`.bdf` (``obs/counters.py``: SDIRK has no
order histogram; its Newton iterations sum the five stage solves).
"""

import math

import torch

from ..obs.counters import COMMON_KEYS
from ..obs.timeline import validate as validate_timeline
from .common import (DT_UNDERFLOW, MAX_STEPS_REACHED, RUNNING, SUCCESS,
                     SolveResult, Stepper, atol_scale_of, init_stats,
                     init_timeline, jacfwd_lanes, nlive_of, ring_write,
                     scaled_norm, stats_out, where_lanes)
from .graphs import count, host_any, loop_pass
from .linalg import make_solve_m, resolve_linsolve

# --- SDIRK4 tableau (Hairer & Wanner II, Table 6.5; gamma = 1/4) ---
_GAMMA = 0.25
_C = (1 / 4, 3 / 4, 11 / 20, 1 / 2, 1.0)
_A = (
    (1 / 4,),
    (1 / 2, 1 / 4),
    (17 / 50, -1 / 25, 1 / 4),
    (371 / 1360, -137 / 2720, 15 / 544, 1 / 4),
    (25 / 24, -49 / 48, 125 / 16, -85 / 12, 1 / 4),
)
_B = (25 / 24, -49 / 48, 125 / 16, -85 / 12, 1 / 4)
# b - b_hat of the embedded order-3 solution, entry by entry as the JAX
# package's numpy difference gives it
_B_ERR = tuple(b - bh for b, bh in zip(
    _B, (59 / 48, -17 / 96, 225 / 32, -85 / 12, 0.0)))

#: the attempt-ring code of an accepted SDIRK4 step: its fixed order
_ORDER = 4


def solve(
    rhs,
    y0,
    t0,
    t1,
    cfg,
    *,
    rtol=1e-6,
    atol=1e-10,
    max_steps=100_000,
    n_save=0,
    dt0=None,
    max_newton=8,
    newton_tol=0.03,
    dt_min_factor=1e-22,
    linsolve="auto",
    jac=None,
    observer=None,
    observer_init=None,
    err0=None,
    jac_window=1,
    stats=False,
    timeline=None,
    timeline_state=None,
):
    """Integrate ``dy/dt = rhs(t, y, cfg)`` per lane with SDIRK4.

    ``y0`` (B, n) float64; ``t0``/``t1`` floats or (B,) tensors; ``cfg`` a
    dict of (B,) tensors (and the (B, n) ``ATOL_SCALE_KEY`` weight and the
    (B,) ``NLIVE_KEY`` live count of a padded state);
    ``rhs(t, y, cfg) -> (B, n)`` and ``jac(t, y, cfg) -> (B, n, n)``
    (``jac=None`` takes ``torch.func.jacfwd`` of the RHS).  ``dt0`` is a
    float or a (B,) tensor whose entries <= 0 ask for the heuristic first
    step; ``err0`` a (B,) tensor carrying the PI controller's memory into
    a resumed solve (entries <= 0: a fresh controller), so a segmented
    solve repeats the monolithic step sequence.  ``newton_tol`` bounds the
    scaled Newton update of each stage; ``max_newton`` its iterations.
    ``observer(t, y, acc) -> acc`` folds over accepted steps from
    ``observer_init``; ``n_save`` > 0 keeps the first ``n_save`` accepted
    rows per lane.  ``jac_window=K`` evaluates the Jacobian once per K
    attempts (M and its factorization stay h-fresh every attempt).

    ``linsolve="auto"`` is ``"lu"`` on the CPU and ``"inv32"`` on the GPU
    (``solver.linalg.resolve_linsolve``).

    ``stats=True`` returns the per-lane counters in ``SolveResult.stats``
    and ``timeline=N`` the attempt ring, resumed by ``timeline_state``
    (as in ``bdf.solve``; an accepted attempt's code is 4).
    """
    timeline = validate_timeline(timeline, stats)
    if timeline is None and timeline_state is not None:
        raise ValueError("timeline_state resumes a timeline ring; pass "
                         "timeline=N too or drop the state")
    if jac_window < 1:
        raise ValueError(f"jac_window must be >= 1, got {jac_window}")
    if (observer is None) != (observer_init is None):
        raise ValueError("observer and observer_init must be given together")
    if y0.ndim != 2:
        raise ValueError(f"y0 must be (B, n), got {tuple(y0.shape)}")

    B, n = y0.shape
    linsolve = resolve_linsolve(linsolve, method="sdirk", device=y0.device,
                                batch=B, n=n)
    st = make_stepper(rhs, cfg, B, n, y0.dtype, y0.device, rtol=rtol,
                      atol=atol, max_steps=max_steps, n_save=n_save,
                      max_newton=max_newton, newton_tol=newton_tol,
                      dt_min_factor=dt_min_factor, linsolve=linsolve,
                      jac=jac, observer=observer, jac_window=jac_window,
                      stats=stats, timeline=timeline)
    carry = st.init(y0, t0, t1, dt0=dt0, err0=err0,
                    observer_init=observer_init,
                    timeline_state=timeline_state)
    while host_any(carry["status"] == RUNNING):
        carry = st.window(carry)
    return st.result(carry)


def make_stepper(rhs, cfg, B, n, dtype, device, *, rtol=1e-6, atol=1e-10,
                 max_steps=100_000, n_save=0, max_newton=8, newton_tol=0.03,
                 dt_min_factor=1e-22, linsolve="lu", jac=None, observer=None,
                 jac_window=1, stats=False, timeline=None):
    """The SDIRK4 of :func:`solve` as a :class:`~.common.Stepper` over B
    lanes of n components (``linsolve`` resolved by the caller).

    ``init(y0, t0, t1, dt0=None, err0=None, observer_init=None,
    timeline_state=None)`` takes
    :func:`solve`'s arguments; with tensors for ``t0``, ``t1``, ``dt0`` and
    ``err0`` it reads no device value, so it can run inside a captured
    graph.  ``window(carry, fixed=False)`` is one Jacobian and its
    ``jac_window`` attempts; ``fixed=True`` runs every attempt and every
    stage Newton iteration under the lanes' masks."""
    dt, dev = dtype, device
    eye = torch.eye(n, dtype=dt, device=dev)
    # the cfg operands are read at each use: a pipelined program refreshes
    # cfg's entries from its buffers before every step
    def _norm(e, y):
        return scaled_norm(e, y, rtol, atol, atol_scale_of(cfg, e),
                           nlive_of(cfg, e))

    def f(t, y):
        return rhs(t, y, cfg)

    if jac is None:
        jac = jacfwd_lanes(rhs)

    def init(y0, t0, t1, dt0=None, err0=None, observer_init=None,
             timeline_state=None):
        def lanes(x):
            return torch.as_tensor(x, dtype=dt, device=dev).expand(B).clone()

        t0 = lanes(t0)
        t1 = lanes(t1)
        span = t1 - t0
        if dt0 is None or not isinstance(dt0, (int, float)):
            # first-step heuristic (Hairer & Wanner II.4), clipped into the
            # span
            f0 = f(t0, y0)
            d0 = _norm(y0, y0)
            d1 = _norm(f0, y0)
            h_heur = torch.minimum(
                torch.maximum(0.01 * d0 / torch.clamp(d1, min=1e-30),
                              span * 1e-24), span)
            if dt0 is None:
                h_init = h_heur
            else:
                dt0 = torch.as_tensor(dt0, dtype=dt, device=dev)
                h_init = torch.where(dt0 > 0, dt0, h_heur)
        else:
            h_init = lanes(dt0)

        if err0 is None:
            err_init = torch.ones(B, dtype=dt, device=dev)
        else:
            err0 = torch.as_tensor(err0, dtype=dt, device=dev)
            err_init = torch.where(err0 > 0, err0, 1.0).expand(B).clone()

        # zero-span guard: a lane already at t1 (one that
        # ensemble_solve_segmented parked) succeeds at once, touching
        # nothing.  The JAX solver has no such guard: there the lane rejects
        # its h = 0 attempts until max_steps, and its carry stays as it was.
        already = t0 >= t1 - torch.abs(span) * 1e-14
        nsb = max(n_save, 1)
        carry = {
            "t": t0.clone(), "y": y0, "h": h_init, "err": err_init,
            "status": torch.where(already, SUCCESS, RUNNING).to(torch.int32),
            "n_acc": torch.zeros(B, dtype=torch.int64, device=dev),
            "n_rej": torch.zeros(B, dtype=torch.int64, device=dev),
            "ts": torch.full((B, nsb), math.inf, dtype=dt, device=dev),
            "ys": torch.zeros((B, nsb, n), dtype=dt, device=dev),
            "n_saved": torch.zeros(B, dtype=torch.int64, device=dev),
            "obs": (dict(observer_init) if observer is not None
                    else {"_": torch.zeros(B, dtype=dt, device=dev)}),
            "k": {"t1": t1, "span": span},
        }
        if stats:
            carry["st"] = init_stats(COMMON_KEYS, B, dev)
        if timeline is not None:
            carry["tl"], carry["k"]["tl_base"] = init_timeline(
                timeline, timeline_state, B, dt, dev)
        return carry

    def newton_stage(solve_m, base, t_stage, h, z_init, y_scale, live,
                     fixed):
        """Solve z = base + h gamma f(t_stage, z) by modified Newton per
        lane; returns (z, converged, iterations).  Lanes outside ``live``
        do not iterate; ``fixed`` runs all ``max_newton`` iterations;
        ``iterations`` (B,) int32 (None without ``stats``) counts each
        lane's own."""
        z = z_init
        nit = torch.zeros(B, dtype=torch.int32, device=dev) if stats else None
        dnorm = torch.full((B,), math.inf, dtype=dt, device=dev)
        conv = torch.zeros(B, dtype=torch.bool, device=dev)
        div = ~live
        hg = (h * _GAMMA)[:, None]
        for it in range(max_newton):
            loop_pass("newton")
            active = ~conv & ~div
            # the blocking gear's early exit (fixed=False); a captured
            # window passes fixed=True and never evaluates host_any
            if not fixed and not host_any(active):  # brlint: disable=host-sync-call
                break
            count("newton_iters")
            if stats:
                nit = nit + active
            g = z - base - hg * f(t_stage, z)
            dz = solve_m(-g)
            dn = _norm(dz, y_scale)
            converged = dn < newton_tol
            # divergence guard: growing updates or non-finite iterates
            growing = (it > 0) & (dn > 2.0 * dnorm)
            bad = ~torch.isfinite(dn)
            z = where_lanes(active, z + dz, z)
            dnorm = torch.where(active, dn, dnorm)
            conv = torch.where(active, converged, conv)
            div = torch.where(active, growing | bad, div)
        return z, conv & torch.isfinite(dnorm), nit

    def attempt_step(t, y, h, J, live, fixed):
        """One SDIRK4 step attempt per lane: (y_new, err, newton_ok,
        Newton iterations summed over the stages (None without
        ``stats``))."""
        solve_m = make_solve_m(eye - (h * _GAMMA)[:, None, None] * J,
                               linsolve, dt)
        ks = []
        ok = torch.ones(B, dtype=torch.bool, device=dev)
        z_pred = y
        n_newton = torch.zeros(B, dtype=torch.int32, device=dev) if stats \
            else None
        for i, a_row in enumerate(_A):
            base = y
            for j in range(i):
                base = base + (h * a_row[j])[:, None] * ks[j]
            t_stage = t + _C[i] * h
            z, conv, nit = newton_stage(solve_m, base, t_stage, h, z_pred, y,
                                        live, fixed)
            ok = ok & conv
            if stats:
                n_newton = n_newton + nit
            ks.append((z - base) / (h * _GAMMA)[:, None])
            z_pred = z  # next stage's predictor
        y_new = y + h[:, None] * sum(b_i * k for b_i, k in zip(_B, ks))
        err = _norm(h[:, None] * sum(be * k for be, k in zip(_B_ERR, ks)),
                    y)
        ok = (ok & torch.all(torch.isfinite(y_new), dim=-1)
              & torch.isfinite(err))
        return y_new, err, ok, n_newton

    def step_once(c, J, fixed):
        """One attempt for every lane; a lane that is not RUNNING keeps
        its carry (every write is gated by ``running``)."""
        t1, span = c["k"]["t1"], c["k"]["span"]
        t, y, h, err_prev, status = (c["t"], c["y"], c["h"], c["err"],
                                     c["status"])
        running = status == RUNNING
        h_eff = torch.minimum(h, t1 - t)
        y_new, err, ok, n_newton = attempt_step(t, y, h_eff, J, running,
                                                fixed)
        accept = ok & (err <= 1.0) & running

        # PI step-size controller (embedded order 3 -> exponent base 1/4)
        err_c = torch.clamp(err, min=1e-16)
        ep = torch.clamp(err_prev, min=1e-16)
        fac = torch.clamp(0.9 * err_c ** (-0.7 / 4.0) * ep ** (0.3 / 4.0),
                          0.2, 5.0)
        h_next = torch.where(ok, h_eff * fac, h_eff * 0.25)
        h_next = torch.where(accept, torch.maximum(h_next,
                                                   span * dt_min_factor),
                             h_next)
        h_next = torch.where(running, h_next, h)
        t_new = torch.where(accept, t + h_eff, t)
        y_out = where_lanes(accept, y_new, y)
        err_new = torch.where(accept, err_c, err_prev)
        n_acc2 = c["n_acc"] + accept
        n_rej2 = c["n_rej"] + (~accept & running)

        ts, ys, n_saved = c["ts"], c["ys"], c["n_saved"]
        if n_save > 0:
            nsb = ts.shape[1]
            do_save = accept & (n_saved < nsb)
            idx = torch.clamp(n_saved, max=nsb - 1)[:, None]
            ts = ts.scatter(1, idx, torch.where(
                do_save[:, None], t_new[:, None], ts.gather(1, idx)))
            yidx = idx[:, :, None].expand(-1, 1, n)
            ys = ys.scatter(1, yidx, torch.where(
                do_save[:, None, None], y_out[:, None, :],
                ys.gather(1, yidx)))
            n_saved = n_saved + do_save

        obs = c["obs"]
        if observer is not None:
            obs = where_lanes(accept, observer(t_new, y_new, obs), obs)

        # tolerance absorbs t + (t1 - t) rounding so the loop cannot stall
        finished = accept & (t_new >= t1 - span * 1e-14)
        # a non-finite h (a NaN state poisoning the controller) is terminal
        too_small = (~accept) & ((h_next < span * dt_min_factor)
                                 | ~torch.isfinite(h_next))
        out_of_steps = (n_acc2 + n_rej2) >= max_steps
        status2 = torch.where(
            finished, SUCCESS,
            torch.where(too_small, DT_UNDERFLOW,
                        torch.where(out_of_steps, MAX_STEPS_REACHED,
                                    RUNNING))).to(torch.int32)
        status2 = torch.where(running, status2, status)
        out = {"t": t_new, "y": y_out, "h": h_next, "err": err_new,
               "status": status2, "n_acc": n_acc2, "n_rej": n_rej2,
               "ts": ts, "ys": ys, "n_saved": n_saved, "obs": obs,
               "k": c["k"]}
        if stats:
            st = dict(c["st"])
            rej = running & ~accept
            st["newton_iters"] = st["newton_iters"] + torch.where(
                running, n_newton, 0)
            st["factorizations"] = st["factorizations"] + running
            st["err_rejects"] = st["err_rejects"] + (rej & ok)
            st["conv_rejects"] = st["conv_rejects"] + (rej & ~ok)
            out["st"] = st
        if timeline is not None:
            tslot = (c["k"]["tl_base"] + c["n_acc"] + c["n_rej"]) % timeline
            tcode = torch.where(accept, _ORDER, torch.where(ok, -1, -2))
            out["tl"] = ring_write(c["tl"], tslot, running, t=t + h_eff,
                                   h=h_eff, code=tcode)
        return out

    def window(c, fixed=False):
        """One Jacobian per window of attempts (a window of 1: per
        attempt)."""
        J = jac(c["t"], c["y"], cfg)
        if stats:
            c = dict(c)
            c["st"] = dict(c["st"])
            c["st"]["jac_builds"] = c["st"]["jac_builds"] + (
                c["status"] == RUNNING)
        for i in range(jac_window):
            loop_pass("attempt")
            c = step_once(c, J, fixed)
            # the blocking gear's early exit; fixed=True never reaches it
            if (not fixed and i + 1 < jac_window
                    and not host_any(c["status"] == RUNNING)):  # brlint: disable=host-sync-call
                break
        return c

    def result(c):
        return SolveResult(
            t=c["t"], y=c["y"], status=c["status"],
            n_accepted=c["n_acc"], n_rejected=c["n_rej"],
            ts=c["ts"], ys=c["ys"], n_saved=c["n_saved"],
            h=c["h"],
            observed=c["obs"] if observer is not None else None,
            err_prev=c["err"],
            stats=stats_out(c, timeline) if stats else None)

    return Stepper(init, window, result)
