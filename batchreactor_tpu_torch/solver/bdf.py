"""Lane-batched variable-order BDF (1..5) — the CVODE-class integrator.

Port of ``batchreactor_tpu/solver/bdf.py``: backward-difference form of
Shampine & Reichelt (ode15s, kappa = 0),

  predictor   y_pred = sum_{j<=q} D_j,   psi = sum_{1<=j<=q} g_j D_j / g_q
  corrector   solve d:  c f(t+h, y_pred + d) - psi - d = 0,  c = h / g_q
  error       err = d / (q + 1); accept if ||err||_scaled <= 1
  order       after q+1 equal steps, compare error estimates at q-1/q/q+1

The JAX solve is per-lane under ``vmap``; here the lane axis is written out
and every tensor carries it first.  Under ``vmap`` each ``lax.while_loop``
runs while any lane's condition holds and a lane's carry freezes once its
own condition is false.  The Python loops below reproduce that with
per-lane masks at all three levels:

* the outer step loop runs while any lane is RUNNING; a terminated lane's
  carry is held by ``step_once`` itself;
* the jac-window loop (``jac_window > 1``) runs attempt ``i`` for lanes
  with ``~newton_failed & running`` — a lane whose Newton failed stops
  stepping in this window while its siblings continue;
* the Newton loop updates only lanes that have neither converged nor
  diverged.

The any-lane tests are host syncs (:func:`solve`, the blocking gear).
:func:`make_stepper` splits the solve into pure pieces: ``window(carry,
fixed=True)`` runs every attempt of a window and every Newton iteration
under those masks and makes no host decision, so ``solver/graphs.py`` can
capture it (the pipelined gear of ``parallel/sweep.py``); a lane's values
do not depend on whether a loop stopped early.

``tangent=`` carries forward sensitivities (CVODES's staggered corrector)
in a (B, ROWS, P, n) difference history, held as (B, ROWS, P n), stepped
with the state's grid, order and factor (``sensitivity/forward.py``).

``stats=True`` adds the per-lane counter block (``obs/counters.py``) to
the carry, ``timeline=N`` the attempt ring (``obs/timeline.py``) and
``step_audit=True`` the 64-slot accept ring and the last iteration
matrix: int32 masked adds and per-lane scatters on values the attempt
already computes, so a window that carries them still captures.  Off,
the carry holds none of their keys.
"""

import math

import torch

from ..obs.counters import COMMON_KEYS
from ..obs.timeline import validate as validate_timeline
from .common import (DT_UNDERFLOW, MAX_STEPS_REACHED, RUNNING, SUCCESS,
                     SolveResult, Stepper, atol_scale_of, init_stats,
                     init_timeline, jacfwd_lanes, nlive_of, ring_write, rms,
                     scaled_norm, stats_out)
from .common import where_lanes as _where
from .graphs import count, host_any, loop_pass
from .linalg import (apply_factor, factor_m, factor_zeros, make_solve_m,
                     resolve_linsolve)

MAXORD = 5
_ROWS = MAXORD + 3          # D rows 0..MAXORD+2
_M = MAXORD + 1             # active change_D block, 6

# gamma_j = sum_{i<=j} 1/i  (alpha = gamma for kappa = 0); padded to _ROWS
_GAMMA_TAB = [0.0]
for _j in range(1, _ROWS):
    _GAMMA_TAB.append(_GAMMA_TAB[-1] + 1.0 / _j)
# setup-economy backstop: a carried factorization is refreshed after
# serving this many jac windows (CVODE's msbp)
_ECON_MAX_AGE = 20
# local error constant at order q is 1/(q+1)
_ERRC_TAB = [1.0 / (q + 1) for q in range(_ROWS)]


#: the (B,) int32 counter keys of BDF's stats block (``order_hist`` is
#: (B, MAXORD + 1)); ``setup_reuses``/``precond_age`` stay 0 without the
#: setup economy, so the block's keys never depend on the options
STATS_KEYS = COMMON_KEYS + ("setup_reuses", "precond_age")
#: slots of the step-audit accept ring
AUDIT_SLOTS = 64


def _change_D(D, order, factor):
    """Rescale backward differences for h -> factor*h at each lane's order.

    Order-masked build of the Shampine-Reichelt (R U)^T transform at fixed
    (6, 6): rows/cols beyond a lane's order act as identity.  D: (B, 8, m)
    (m = n, or P n for the flattened tangent history), order (B,) int64,
    factor (B,)."""
    dt, dev = D.dtype, D.device
    i = torch.arange(_M, dtype=dt, device=dev)[:, None]
    j = torch.arange(_M, dtype=dt, device=dev)[None, :]
    o = order.to(dt)[:, None, None]
    act = (i <= o) & (j <= o)                                   # (B, 6, 6)

    def w_of(fac):
        base = torch.where((i >= 1) & (j >= 1) & act,
                           (i - 1.0 - fac[:, None, None] * j)
                           / torch.clamp(i, min=1.0), 0.0)
        base = torch.where(i == 0, 1.0, base)
        return torch.cumprod(base, dim=1)

    RU = torch.matmul(w_of(factor), w_of(torch.ones_like(factor)))
    eye = torch.eye(_M, dtype=dt, device=dev)
    RU_eff = torch.where(act, RU, eye)
    D_active = torch.matmul(RU_eff.transpose(1, 2), D[:, :_M])  # (B, 6, n)
    return torch.cat([D_active, D[:, _M:]], dim=1)


def _masked_row_sum(D, weights, order, lo=0):
    """sum_{j=lo..order} weights[j] * D[:, j] per lane, (B, n)."""
    jidx = torch.arange(_ROWS, device=D.device)
    keep = (jidx >= lo) & (jidx <= order[:, None])              # (B, 8)
    w = torch.where(keep, weights[:_ROWS], 0.0)
    return torch.matmul(w[:, None, :], D)[:, 0]


def _row(D, r):
    """D[b, r[b]] per lane, (B, n)."""
    idx = r[:, None, None].expand(-1, 1, D.shape[-1])
    return torch.gather(D, 1, idx)[:, 0]


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
    max_newton=6,
    dt_min_factor=1e-22,
    linsolve="auto",
    jac=None,
    observer=None,
    observer_init=None,
    err0=None,
    solver_state=None,
    jac_window=1,
    freeze_precond=False,
    setup_economy=False,
    stale_tol=0.3,
    tangent=None,
    sens_iters=2,
    sens_errcon=False,
    step_audit=False,
    stats=False,
    timeline=None,
    timeline_state=None,
):
    """Integrate ``dy/dt = rhs(t, y, cfg)`` per lane with BDF(1..5).

    ``y0`` (B, n) float64; ``t0``/``t1`` floats or (B,) tensors; ``cfg`` a
    dict of (B,) tensors; ``rhs(t, y, cfg) -> (B, n)`` and ``jac(t, y, cfg)
    -> (B, n, n)`` (``jac=None`` takes ``torch.func.jacfwd`` of the RHS).
    ``dt0`` is a float or a (B,) tensor whose entries <= 0 ask for the
    heuristic first step.  ``observer(t, y, acc) -> acc`` folds over
    accepted steps from ``observer_init`` (a dict of (B,) tensors).
    ``n_save`` > 0 keeps the first ``n_save`` accepted rows per lane.

    ``solver_state`` is the opaque carry ``(D, order, h, n_equal[, econ])``
    a previous call returned in ``SolveResult.solver_state``: pass it back
    to resume the multistep history (lanes whose history is all zero start
    cold).  ``jac_window=K`` evaluates the Jacobian once per window of up
    to K attempts; a Newton failure closes the window early.
    ``freeze_precond=True`` (needs ``jac_window > 1``) also factors M =
    I - c0 J once per window, at the window's opening c0, and rescales
    each correction by 2/(1 + c/c0): the setup economy's frozen
    factorization without its reuse across windows.
    ``setup_economy=True`` (with ``jac_window > 1``) carries the
    iteration-matrix factorization across windows and refreshes it only on
    a cj-ratio breach ``|c/c0 - 1| > stale_tol``, a Newton failure, or
    after ``_ECON_MAX_AGE`` windows (CVODE's setup economy); under economy
    the fresh factorization is computed for every lane at each window open
    and selected per lane, as the JAX package does under ``vmap``.

    A (B, n) ``cfg[ATOL_SCALE_KEY]`` weights ``atol`` per component in
    every scaled norm and in the Newton displacement scale
    (``solver.common``; the energy path's temperature row), and a (B,)
    ``cfg[NLIVE_KEY]`` divides every norm's sum of squares by the live
    count of a padded state.  ``err0`` is accepted for SDIRK's interface
    and ignored (the BDF history carries its own memory).

    ``tangent=(fdot, S0)`` carries forward sensitivities S = dy/dtheta:
    ``S0`` (B, P, n) (or (P, n), shared) rides a (B, ROWS, P, n)
    difference history with the state's step grid, order and rescaling.
    After each attempt's Newton, ``sens_iters`` sweeps of
    ``dS += solve_m(c FS - psi_S - dS)`` with ``FS = fdot(t, y, S_pred +
    dS)`` (``fdot(t, y, S) -> (B, P, n)``, the rows J S_p + df/dtheta_p)
    solve the tangent corrector through the attempt's already-built
    factor (the frozen one with its cj-ratio rescale under the setup
    economy or ``freeze_precond``).  ``sens_errcon=True`` joins the
    tangent's local error to the step controller on a scale of
    1e-8 max|S| + atol; by default the tangents leave the state's grid as
    it is.  Tangents cannot resume from ``solver_state``.  They land in
    ``SolveResult.tangents`` (B, P, n).

    ``stats=True`` returns the per-lane counters in ``SolveResult.stats``
    (``obs/counters.py``: Newton iterations, Jacobian builds,
    factorizations, error and convergence rejections, the order histogram,
    the setup economy's reuses and peak age).  ``timeline=N`` (with
    ``stats``) adds each lane's last N attempts ``(t, h, code)`` under
    ``stats["timeline_*"]``, slotted by the global attempt index mod N;
    ``timeline_state`` (``{"t", "h", "code", "base"}``) resumes the ring of
    a previous segment.  ``step_audit=True`` adds the 64-slot int8 accept
    ring (``SolveResult.accept_ring``) and the last iteration matrix
    (``SolveResult.it_matrix``), both also under ``stats``.

    This is the blocking gear: :func:`make_stepper`'s pieces driven by a
    loop that stops each of its three loops once no lane needs it.
    """
    timeline = validate_timeline(timeline, stats)
    if timeline is None and timeline_state is not None:
        raise ValueError("timeline_state resumes a timeline ring; pass "
                         "timeline=N too or drop the state")
    if jac_window < 1:
        raise ValueError(f"jac_window must be >= 1, got {jac_window}")
    if freeze_precond and jac_window == 1:
        raise ValueError(
            "freeze_precond requires jac_window > 1 (with a window of 1 "
            "the preconditioner is rebuilt with J anyway)")
    if not 0.0 <= float(stale_tol) <= 1.0:
        raise ValueError(f"stale_tol must be in [0, 1], got {stale_tol}")
    if (observer is None) != (observer_init is None):
        raise ValueError("observer and observer_init must be given together")
    if y0.ndim != 2:
        raise ValueError(f"y0 must be (B, n), got {tuple(y0.shape)}")
    if tangent is not None and solver_state is not None:
        raise ValueError(
            "tangent propagation cannot resume from solver_state: the "
            "tangent difference history is not part of the segmented "
            "carry — run forward-sensitivity solves monolithically")
    if sens_iters < 1:
        raise ValueError(f"sens_iters must be >= 1, got {sens_iters}")

    B, n = y0.shape
    linsolve = resolve_linsolve(linsolve, method="bdf", device=y0.device,
                                batch=B, n=n)
    st = make_stepper(
        rhs, cfg, B, n, y0.dtype, y0.device, rtol=rtol, atol=atol,
        max_steps=max_steps, n_save=n_save, max_newton=max_newton,
        dt_min_factor=dt_min_factor, linsolve=linsolve, jac=jac,
        observer=observer, jac_window=jac_window,
        freeze_precond=freeze_precond, setup_economy=setup_economy,
        stale_tol=stale_tol,
        fdot=tangent[0] if tangent is not None else None,
        sens_iters=sens_iters, sens_errcon=sens_errcon, stats=stats,
        timeline=timeline, step_audit=step_audit)
    carry = st.init(y0, t0, t1, dt0=dt0, solver_state=solver_state,
                    observer_init=observer_init,
                    S0=tangent[1] if tangent is not None else None,
                    timeline_state=timeline_state)
    while host_any(carry["status"] == RUNNING):
        carry = st.window(carry)
    return st.result(carry)


def make_stepper(rhs, cfg, B, n, dtype, device, *, rtol=1e-6, atol=1e-10,
                 max_steps=100_000, n_save=0, max_newton=6,
                 dt_min_factor=1e-22, linsolve="lu", jac=None,
                 observer=None, jac_window=1, freeze_precond=False,
                 setup_economy=False, stale_tol=0.3, fdot=None, sens_iters=2,
                 sens_errcon=False, stats=False, timeline=None,
                 step_audit=False):
    """The BDF of :func:`solve` as a :class:`~.common.Stepper` over B lanes
    of n components (``linsolve`` resolved, options validated by the
    caller; ``fdot`` is the tangent hook's, whose ``S0`` goes to ``init``).

    ``init(y0, t0, t1, dt0=None, solver_state=None, observer_init=None,
    S0=None, timeline_state=None)`` takes :func:`solve`'s arguments; with tensors for ``t0``,
    ``t1`` and ``dt0`` it allocates only on the device and reads no device
    value, so it can run inside a captured graph (a segment's opening).
    The carry holds the solve's per-lane constants (``t1``, the span) under
    ``"k"`` and, under the setup economy, the carried factorization under
    ``"econ"``, so ``window`` is a function from carry to carry.  The
    stepper reads ``cfg``'s entries at each use, never a copy of them."""
    dt, dev = dtype, device
    economy = bool(setup_economy) and jac_window > 1
    eye = torch.eye(n, dtype=dt, device=dev)
    gamma_tab = torch.tensor(_GAMMA_TAB, dtype=dt, device=dev)
    errc_tab = torch.tensor(_ERRC_TAB, dtype=dt, device=dev)
    ones_rows = torch.ones(_ROWS, dtype=dt, device=dev)
    ridx = torch.arange(_ROWS, device=dev)[None, :, None]      # (1, 8, 1)
    kidx = torch.arange(_ROWS, device=dev)[None, None, :]

    # the cfg operands are read at each use: a pipelined program refreshes
    # cfg's entries from its buffers before every step
    def _norm(e, y):
        return scaled_norm(e, y, rtol, atol, atol_scale_of(cfg, e),
                           nlive_of(cfg, e))

    def f(t, y):
        return rhs(t, y, cfg)

    if jac is None:
        jac = jacfwd_lanes(rhs)

    def J_at(t, y):
        return jac(t, y, cfg)

    newton_tol = max(10.0 * 2.220446049250313e-16 / rtol,
                     min(0.03, math.sqrt(rtol)))

    def init(y0, t0, t1, dt0=None, solver_state=None, observer_init=None,
             S0=None, timeline_state=None):
        def lanes(x):
            return torch.as_tensor(x, dtype=dt, device=dev).expand(B).clone()

        t0 = lanes(t0)
        t1 = lanes(t1)
        span = t1 - t0

        # ---- initial h (Hairer heuristic) ---------------------------------
        f0 = f(t0, y0)
        if dt0 is None or not isinstance(dt0, (int, float)):
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

        econ = None
        if economy:
            econ = {"fac": factor_zeros(linsolve, B, n, dt, dev),
                    "c0": torch.zeros(B, dtype=dt, device=dev),
                    "ok": torch.zeros(B, dtype=torch.bool, device=dev),
                    "age": torch.zeros(B, dtype=torch.int64, device=dev)}
        D_cold = torch.zeros((B, _ROWS, n), dtype=dt, device=dev)
        D_cold[:, 0] = y0
        D_cold[:, 1] = h_init[:, None] * f0
        if solver_state is None:
            D = D_cold
            order = torch.ones(B, dtype=torch.int64, device=dev)
            h = h_init
            n_equal = torch.zeros(B, dtype=torch.int64, device=dev)
        else:
            D_prev, order_prev, h_prev, nequal_prev = solver_state[:4]
            econ_prev = solver_state[4] if len(solver_state) > 4 else None
            cold = torch.all((D_prev == 0).reshape(B, -1), dim=1)
            D = _where(cold, D_cold, D_prev)
            order = torch.where(cold, 1, order_prev.to(torch.int64))
            h = torch.where(cold, h_init, h_prev)
            n_equal = torch.where(cold, 0, nequal_prev.to(torch.int64))
            if economy and econ_prev is not None:
                econ = _where(cold, econ, econ_prev)

        nsb = max(n_save, 1)
        carry = {
            "t": t0.clone(), "D": D, "order": order, "h": h,
            "n_equal": n_equal,
            "status": torch.full((B,), RUNNING, dtype=torch.int32,
                                 device=dev),
            "n_acc": torch.zeros(B, dtype=torch.int64, device=dev),
            "n_rej": torch.zeros(B, dtype=torch.int64, device=dev),
            "ts": torch.full((B, nsb), math.inf, dtype=dt, device=dev),
            "ys": torch.zeros((B, nsb, n), dtype=dt, device=dev),
            "n_saved": torch.zeros(B, dtype=torch.int64, device=dev),
            "obs": (dict(observer_init) if observer is not None
                    else {"_": torch.zeros(B, dtype=dt, device=dev)}),
            "k": {"t1": t1, "span": span},
        }
        if economy:
            carry["econ"] = econ
        if fdot is not None:
            S0 = torch.as_tensor(S0, dtype=dt, device=dev)
            if S0.ndim == 2:
                S0 = S0.expand((B,) + tuple(S0.shape))
            if S0.ndim != 3 or S0.shape[0] != B or S0.shape[2] != n:
                raise ValueError(f"tangent S0 must be (B, P, {n}) or (P, {n}),"
                                 f" got {tuple(S0.shape)}")
            nP = S0.shape[1]
            DS = torch.zeros((B, _ROWS, nP * n), dtype=dt, device=dev)
            DS[:, 0] = S0.reshape(B, -1)
            DS[:, 1] = (h_init[:, None, None] * fdot(t0, y0, S0)).reshape(B,
                                                                          -1)
            carry["DS"] = DS
        if stats:
            carry["st"] = init_stats(STATS_KEYS, B, dev, order_slots=_M)
        if timeline is not None:
            carry["tl"], carry["k"]["tl_base"] = init_timeline(
                timeline, timeline_state, B, dt, dev)
        if step_audit:
            carry["audit"] = {
                "ring": torch.full((B, AUDIT_SLOTS), -1, dtype=torch.int8,
                                   device=dev),
                "M": torch.zeros((B, n, n), dtype=dt, device=dev)}
        return carry

    def newton(solve_m, t_new, y_pred, psi, c, scale, live, fixed):
        """Solve c f(t_new, y_pred + d) = psi + d per lane; returns
        (d, converged, iterations).  A lane that converged or diverged
        keeps its d; lanes outside ``live`` (their attempt is discarded
        anyway) do not iterate at all.  ``fixed`` runs all ``max_newton``
        iterations; ``iterations`` (B,) int32 (None without ``stats``)
        counts each lane's own, as the blocking gear runs them."""
        d = torch.zeros_like(y_pred)
        nit = torch.zeros(B, dtype=torch.int32, device=dev) if stats else None
        ynew = y_pred
        dw_old = torch.full((B,), -1.0, dtype=dt, device=dev)
        conv = torch.zeros(B, dtype=torch.bool, device=dev)
        div = ~live
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
            res = c[:, None] * f(t_new, ynew) - psi - d
            dd = solve_m(res)
            dw = rms(dd / scale, nlive_of(cfg, dd))
            rate = torch.where(dw_old > 0, dw / dw_old, 0.0)
            slow = (dw_old > 0) & (
                (rate >= 1.0)
                | (rate ** (max_newton - it)
                   / torch.clamp(1 - rate, min=1e-10) * dw > newton_tol))
            bad = ~torch.isfinite(dw)
            d2 = d + dd
            conv2 = (dw == 0.0) | torch.where(
                dw_old > 0,
                rate / torch.clamp(1 - rate, min=1e-10) * dw < newton_tol,
                dw < 0.1 * newton_tol)
            d = _where(active, d2, d)
            ynew = y_pred + d
            dw_old = torch.where(active, dw, dw_old)
            conv = torch.where(active, conv2 & ~bad, conv)
            div = torch.where(active, slow | bad, div)
        return d, conv, nit

    def step_once(c, k, J_stale, pre=None, stale_pre=None, fixed=False):
        """One step attempt for every lane (terminated lanes hold their
        carry).  ``J_stale=None`` evaluates a fresh Jacobian at this
        attempt's predictor; ``pre=(solve0, c0)`` solves with a frozen
        factorization and CVODE's cj-ratio rescale 2/(1 + c/c0)."""
        t1, span = k["t1"], k["span"]
        t, D, order, h = c["t"], c["D"], c["order"], c["h"]
        n_equal, status = c["n_equal"], c["status"]
        running = status == RUNNING
        # zero-span guard: a lane already at t1 succeeds, touching nothing
        already = t >= t1 - torch.abs(span) * 1e-14

        # clip the final step to land on t1 exactly (rescales history)
        factor_clip = torch.where((h > t1 - t) & ~already & running,
                                  (t1 - t) / h, 1.0)
        factor_clip = torch.clamp(factor_clip, min=1e-14)
        clip = factor_clip < 1.0
        D = _where(clip, _change_D(D, order, factor_clip), D)
        if fdot is not None:
            DS = c["DS"]
            DS = _where(clip, _change_D(DS, order, factor_clip), DS)
            nP = DS.shape[-1] // n
        h = h * factor_clip
        n_equal = torch.where(clip, 0, n_equal)

        t_new = t + h
        gam = gamma_tab[order]
        y_pred = _masked_row_sum(D, ones_rows, order)
        psi = _masked_row_sum(D, gamma_tab, order, lo=1) / gam[:, None]
        cc = h / gam
        atol_scale = atol_scale_of(cfg, y_pred)
        atol_vec = atol if atol_scale is None else atol * atol_scale
        scale = atol_vec + rtol * torch.abs(y_pred)

        J = J_at(t_new, y_pred) if J_stale is None else J_stale
        if pre is None:
            M = eye - cc[:, None, None] * J
            solve_m = make_solve_m(M, linsolve, dt)
        else:
            solve0, c0 = pre
            M = eye - c0[:, None, None] * J if step_audit else None
            cj_fac = 2.0 / (1.0 + cc / c0)

            def solve_m(b):
                return solve0(b) * cj_fac.reshape((B,) + (1,) * (b.ndim - 1))
        live = running & ~already
        d, conv, nit = newton(solve_m, t_new, y_pred, psi, cc, scale, live,
                              fixed)

        err = _norm(errc_tab[order][:, None] * d, y_pred)
        if fdot is not None:
            # the staggered tangent corrector through this attempt's factor
            S_pred = _masked_row_sum(DS, ones_rows, order).reshape(B, nP, n)
            psi_S = (_masked_row_sum(DS, gamma_tab, order, lo=1)
                     / gam[:, None]).reshape(B, nP, n)
            y_cand = y_pred + d
            dS = torch.zeros_like(S_pred)
            for _ in range(sens_iters):
                FS = fdot(t_new, y_cand, S_pred + dS)
                dS = dS + solve_m(cc[:, None, None] * FS - psi_S - dS)
            dSf = dS.reshape(B, -1)
            if sens_errcon:
                S_predf = S_pred.reshape(B, -1)
                s_floor = (1e-8 * torch.amax(torch.abs(S_predf)
                                             + torch.abs(dSf), dim=1)
                           + atol)
                err_S = scaled_norm(errc_tab[order][:, None] * dSf, S_predf,
                                    rtol, s_floor[:, None])
                err = torch.maximum(err, err_S)
        accept = conv & (err <= 1.0) & torch.isfinite(err) & running & ~already

        # rejected: Newton failure halves h (or retries at the same h when
        # the failing setup was stale, economy only); error failure takes
        # the asymptotic factor
        conv_fac = (0.5 if stale_pre is None
                    else torch.where(stale_pre, 1.0, 0.5))
        of = order.to(dt)
        fac_rej = torch.where(
            conv, torch.clamp(0.9 * err ** (-1.0 / (of + 1.0)), 0.1, 1.0),
            conv_fac)

        # accepted: D[q+2] = d - D[q+1]; D[q+1] = d; D[j] += D[j+1], j <= q
        o3 = order[:, None, None]
        Dq1 = _row(D, order + 1)
        D_acc = torch.where(ridx == o3 + 2, (d - Dq1)[:, None, :], D)
        D_acc = torch.where(ridx == o3 + 1, d[:, None, :], D_acc)
        take = (kidx >= ridx) & (kidx <= o3 + 1) & (ridx <= o3)  # (B, 8, 8)
        D_summed = torch.matmul(take.to(dt), D_acc)
        D_acc = torch.where(ridx <= o3, D_summed, D_acc)
        if fdot is not None:
            DSq1 = _row(DS, order + 1)
            DS_acc = torch.where(ridx == o3 + 2, (dSf - DSq1)[:, None, :], DS)
            DS_acc = torch.where(ridx == o3 + 1, dSf[:, None, :], DS_acc)
            DS_acc = torch.where(ridx <= o3,
                                 torch.matmul(take.to(dt), DS_acc), DS_acc)

        y_new = D_acc[:, 0]
        n_equal_acc = n_equal + 1

        # order/step selection after the history settles
        sel = accept & (n_equal_acc >= order + 1)
        e_mid = err
        e_m = torch.where(
            order > 1,
            _norm(errc_tab[order - 1][:, None] * _row(D_acc, order), y_new),
            math.inf)
        e_p = torch.where(
            order < MAXORD,
            _norm(errc_tab[order + 1][:, None] * _row(D_acc, order + 2),
                  y_new),
            math.inf)
        f_m = torch.where(order > 1,
                          torch.clamp(e_m, min=1e-16) ** (-1.0 / of), 0.0)
        f_0 = torch.clamp(e_mid, min=1e-16) ** (-1.0 / (of + 1.0))
        f_p = torch.where(order < MAXORD,
                          torch.clamp(e_p, min=1e-16) ** (-1.0 / (of + 2.0)),
                          0.0)
        best = torch.maximum(f_0, torch.maximum(f_m, f_p))
        delta = torch.where(f_p >= best, 1, torch.where(f_m >= best, -1, 0))
        delta = torch.where(f_0 >= best, 0, delta)
        order_sel = torch.clamp(order + delta, 1, MAXORD)
        fac_sel = torch.clamp(0.9 * best, 0.2, 10.0)

        # merge the three outcomes
        order_new = torch.where(sel, order_sel, order)
        factor = torch.where(accept, torch.where(sel, fac_sel, 1.0), fac_rej)
        D_base = _where(accept, D_acc, D)
        D_new = _where(factor != 1.0, _change_D(D_base, order_new, factor),
                       D_base)
        if fdot is not None:
            DS_base = _where(accept, DS_acc, DS)
            DS_new = _where(factor != 1.0,
                            _change_D(DS_base, order_new, factor), DS_base)
        h_new = h * factor
        n_equal_new = torch.where(accept & ~sel, n_equal_acc, 0)

        t_out = torch.where(accept, t_new, t)
        n_acc2 = c["n_acc"] + accept
        n_rej2 = c["n_rej"] + (~accept & running & ~already)
        # freeze the carry of lanes that are terminated OR already at t1
        hold = ~running | already
        D_new = _where(hold, D, D_new)
        if fdot is not None:
            DS_new = _where(hold, DS, DS_new)
        h_new = torch.where(hold, h, h_new)
        order_new = torch.where(hold, order, order_new)
        n_equal_new = torch.where(hold, n_equal, n_equal_new)

        # trajectory row scatter (first n_save accepted rows)
        ts, ys, n_saved = c["ts"], c["ys"], c["n_saved"]
        if n_save > 0:
            nsb = ts.shape[1]
            do_save = accept & (n_saved < nsb)
            idx = torch.clamp(n_saved, max=nsb - 1)[:, None]
            ts = ts.scatter(1, idx, torch.where(
                do_save[:, None], t_new[:, None], ts.gather(1, idx)))
            yidx = idx[:, :, None].expand(-1, 1, n)
            ys = ys.scatter(1, yidx, torch.where(
                do_save[:, None, None], y_new[:, None, :],
                ys.gather(1, yidx)))
            n_saved = n_saved + do_save

        obs = c["obs"]
        if observer is not None:
            obs = _where(accept, observer(t_new, y_new, obs), obs)

        finished = (accept & (t_out >= t1 - span * 1e-14)) | already
        too_small = (~accept) & ~already & (
            (h_new < span * dt_min_factor) | ~torch.isfinite(h_new))
        out_of_steps = (n_acc2 + n_rej2) >= max_steps
        status2 = torch.where(
            finished, SUCCESS,
            torch.where(too_small, DT_UNDERFLOW,
                        torch.where(out_of_steps, MAX_STEPS_REACHED,
                                    RUNNING))).to(torch.int32)
        status2 = torch.where(running, status2, status)
        newton_failed = running & ~already & ~conv
        out = {"t": t_out, "D": D_new, "order": order_new, "h": h_new,
               "n_equal": n_equal_new, "status": status2, "n_acc": n_acc2,
               "n_rej": n_rej2, "ts": ts, "ys": ys, "n_saved": n_saved,
               "obs": obs}
        if fdot is not None:
            out["DS"] = DS_new
        if stats:
            # masked adds on values this attempt computed; ``live`` makes
            # them algorithmic work per lane, not the masked lanes a fixed
            # trip runs
            st = dict(c["st"])
            rej = live & ~accept
            st["newton_iters"] = st["newton_iters"] + torch.where(live, nit,
                                                                  0)
            if J_stale is None:
                st["jac_builds"] = st["jac_builds"] + live
            if pre is None:
                st["factorizations"] = st["factorizations"] + live
            st["err_rejects"] = st["err_rejects"] + (rej & conv)
            st["conv_rejects"] = st["conv_rejects"] + (rej & ~conv)
            st["order_hist"] = st["order_hist"] + (
                (torch.arange(_M, device=dev)[None, :] == order[:, None])
                & accept[:, None])
            out["st"] = st
        if timeline is not None:
            # slot: the global attempt index (previous segments' attempts
            # in the base); code: the order on accept, -1 error reject,
            # -2 convergence reject
            tslot = (k["tl_base"] + c["n_acc"] + c["n_rej"]) % timeline
            tcode = torch.where(accept, order,
                                torch.where(conv, -1, -2))
            out["tl"] = ring_write(c["tl"], tslot, live, t=t_new, h=h,
                                   code=tcode)
        if step_audit:
            slot = (c["n_acc"] + c["n_rej"]) % AUDIT_SLOTS
            out["audit"] = {
                "ring": ring_write({"r": c["audit"]["ring"]}, slot, live,
                                   r=accept)["r"],
                "M": _where(live, M, c["audit"]["M"])}
        return out, newton_failed

    def window(c, fixed=False):
        """One jac window: one Jacobian (at the window-opening predictor)
        serves up to ``jac_window`` attempts per lane.  ``fixed`` runs
        every attempt and every Newton iteration under the lanes' masks."""
        c = dict(c)
        k = c.pop("k")
        econ = c.pop("econ", None)
        if jac_window == 1:
            c = step_once(c, k, None, fixed=fixed)[0]
            c["k"] = k
            return c
        t, D, order, h = c["t"], c["D"], c["order"], c["h"]
        y_pred = _masked_row_sum(D, ones_rows, order)
        J = J_at(t + h, y_pred)
        reuse = pre = None
        if stats:
            # the window opening's J (and, frozen, its factorization)
            st = dict(c["st"])
            open0 = c["status"] == RUNNING
            st["jac_builds"] = st["jac_builds"] + open0
            if freeze_precond and not economy:
                st["factorizations"] = st["factorizations"] + open0
        if economy or freeze_precond:
            # the window's frozen factorization at its opening c0; the
            # economy keeps a lane's carried one instead when it passes the
            # staleness test (the economy subsumes freeze_precond)
            c_open = h / gamma_tab[order]
            fac = factor_m(eye - c_open[:, None, None] * J, linsolve)
            c0 = c_open
            if economy:
                live0 = c["status"] == RUNNING
                ratio = torch.where(econ["c0"] > 0, c_open / econ["c0"],
                                    math.inf)
                reuse = (econ["ok"] & (torch.abs(ratio - 1.0) <= stale_tol)
                         & (econ["age"] + 1 < _ECON_MAX_AGE))
                need = ~reuse
                fac = _where(need, fac, econ["fac"])
                c0 = torch.where(need, c_open, econ["c0"])
                age = torch.where(need, 0, econ["age"] + 1)
                if stats:
                    # factorizations only where the staleness test asked;
                    # precond_age the peak windows one factorization served
                    st["factorizations"] = st["factorizations"] + (
                        live0 & need)
                    st["setup_reuses"] = st["setup_reuses"] + (live0 & reuse)
                    st["precond_age"] = torch.maximum(
                        st["precond_age"],
                        torch.where(live0, age + 1, 0).to(torch.int32))
            pre = ((lambda b: apply_factor(fac, b, linsolve, dt)), c0)
        if stats:
            c["st"] = st
        nf = torch.zeros(B, dtype=torch.bool, device=dev)
        for i in range(jac_window):
            loop_pass("attempt")
            active = ~nf & (c["status"] == RUNNING)
            # the blocking gear's early exit; fixed=True never reaches it
            if not fixed and not host_any(active):  # brlint: disable=host-sync-call
                break
            stale = None if reuse is None else (reuse | (i > 0))
            c2, nf2 = step_once(c, k, J, pre, stale_pre=stale, fixed=fixed)
            c = _where(active, c2, c)
            nf = torch.where(active, nf2, nf)
        c["k"] = k
        if economy:
            # a clean window close validates the factorization for the next
            # window's test; a Newton failure invalidates it
            c["econ"] = {"fac": _where(live0, fac, econ["fac"]),
                         "c0": torch.where(live0, c0, econ["c0"]),
                         "ok": torch.where(live0, ~nf, econ["ok"]),
                         "age": torch.where(live0, age, econ["age"])}
        return c

    def result(c):
        state_out = (c["D"], c["order"], c["h"], c["n_equal"])
        if economy:
            state_out = state_out + (c["econ"],)
        tangents = None
        if fdot is not None:
            tangents = c["DS"][:, 0].reshape(B, -1, n)
        st = stats_out(c, timeline) if stats else None
        ring = M_last = None
        if step_audit:
            ring, M_last = c["audit"]["ring"], c["audit"]["M"]
            st = dict(st or {}, accept_ring=ring, it_matrix=M_last)
        return SolveResult(
            t=c["t"], y=c["D"][:, 0], status=c["status"],
            n_accepted=c["n_acc"], n_rejected=c["n_rej"],
            ts=c["ts"], ys=c["ys"], n_saved=c["n_saved"],
            h=c["h"], observed=c["obs"] if observer is not None else None,
            solver_state=state_out, tangents=tangents, stats=st,
            it_matrix=M_last, accept_ring=ring)

    return Stepper(init, window, result)
