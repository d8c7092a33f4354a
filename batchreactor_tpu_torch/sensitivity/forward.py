"""Forward parameter sensitivities: CVODES-style staggered tangents.

Port of ``batchreactor_tpu/sensitivity/forward.py``.  Solves the tangent ODE

    dS_p/dt = J(t, y) S_p + df/dtheta_p,      S_p(t0) = dy0/dtheta_p

beside the state, one row per scalar parameter, inside the same BDF step
loop as the plain solve (``solver.bdf.solve``'s ``tangent=`` hook): the
tangents share the state's step grid, order and history rescaling, and
every tangent solve goes through the attempt's Newton factor (on the card,
the ``lu32p`` kernel's factor at the gate).

The JAX package evaluates the rows with one ``jax.jvp`` per tangent row
under ``vmap``.  Here the P rows fold into the lane axis: the B lanes'
states repeated P times, theta as a (B P, K) tensor whose tangent is e_p
on row (b, p), and ONE ``torch.func.jvp`` of the lane-batched RHS gives
every J S_p + df/dtheta_p, exact to roundoff, with J never built.
"""

import torch

from ..obs.recorder import span_or_null
from ..solver import bdf, graphs
from . import params as P


def _repeat_lanes(x, nP):
    """Each lane of a (B, ...) tensor P times in a row, (B P, ...); a
    0-d tensor or a number passes through."""
    if not torch.is_tensor(x) or x.ndim == 0:
        return x
    return x.repeat_interleave(nP, dim=0)


def make_fdot(rhs_theta, theta, cfg):
    """Sensitivity-RHS factory: ``fdot(t, y, S) -> (B, P, n)`` with rows
    J(t, y) S_p + df/dtheta_p for y (B, n), S (B, P, n), evaluated as one
    jvp over B P lanes.

    ``rhs_theta(t, y, theta, cfg)`` is the theta-parameterized RHS
    (``params.make_rhs_theta``); ``theta`` is the dict the tangent rows are
    ordered against (``params.flatten`` order, i.e. ``params.names``), with
    (K,) entries shared by the lanes or (B, K) entries per lane.
    """
    theta_flat, unflatten = P.flatten(theta)
    nP = theta_flat.shape[-1]

    def fdot(t, y, S):
        B, n = y.shape
        th = theta_flat.expand(B, nP)
        eye = torch.eye(nP, dtype=th.dtype, device=th.device).repeat(B, 1)
        cfg_r = {k: _repeat_lanes(v, nP) for k, v in cfg.items()}
        t_r = _repeat_lanes(t, nP)

        def f(yy, tf):
            return rhs_theta(t_r, yy, unflatten(tf), cfg_r)

        _, dy = torch.func.jvp(
            f, (_repeat_lanes(y, nP), _repeat_lanes(th, nP)),
            (S.reshape(B * nP, n), eye))
        return dy.reshape(B, nP, n)

    return fdot


def solve_forward(rhs_theta, y0, t0, t1, theta, cfg, *, rtol=1e-6,
                  atol=1e-10, max_steps=100_000, n_save=0, dt0=None,
                  jac=None, jac_window=1, linsolve="auto", sens_iters=2,
                  sens_errcon=False, observer=None, observer_init=None,
                  S0=None, step_audit=False, stats=False, recorder=None):
    """Integrate state + forward sensitivities of every lane of ``y0``
    (B, n) in one BDF solve.

    Returns the solver's SolveResult with ``tangents`` (B, P, n) =
    dy(t_end)/dtheta, rows in ``params.names`` order of ``theta``.
    ``jac`` is the analytic state Jacobian at the given theta (build it
    from ``params.apply(mech, theta, spec)``, as ``api.py`` does); ``S0``
    (B, P, n) or (P, n) replaces the zero initial tangents when y0 depends
    on theta.  The other options are ``bdf.solve``'s; ``stats`` and
    ``step_audit`` count the tangent-carrying solve's steps as in a plain
    one.  ``recorder`` (an ``obs.Recorder``) gets a ``sens_forward`` span
    around the solve that waits for the card."""
    theta_flat, _ = P.flatten(theta)
    nP = theta_flat.shape[-1]
    if S0 is None:
        S0 = torch.zeros((y0.shape[0], nP, y0.shape[1]), dtype=y0.dtype,
                         device=y0.device)
    fdot = make_fdot(rhs_theta, theta, cfg)

    def rhs(t, y, cfg):
        return rhs_theta(t, y, theta, cfg)

    with span_or_null(recorder, "sens_forward", n_params=int(nP)) as sp:
        res = bdf.solve(
            rhs, y0, t0, t1, cfg, rtol=rtol, atol=atol, max_steps=max_steps,
            n_save=n_save, dt0=dt0, jac=jac, jac_window=jac_window,
            linsolve=linsolve, observer=observer,
            observer_init=observer_init, tangent=(fdot, S0),
            sens_iters=sens_iters, sens_errcon=sens_errcon,
            step_audit=step_audit, stats=stats)
        if recorder is not None:
            graphs.block(res.y)
            sp["attrs"]["n_accepted"] = int(res.n_accepted.sum())
    return res
