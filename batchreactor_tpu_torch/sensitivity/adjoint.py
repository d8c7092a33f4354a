"""Adjoint (reverse-mode) parameter gradients of scalar QoIs.

Port of ``batchreactor_tpu/sensitivity/adjoint.py``: discretize-then-
optimize on a pinned grid, the checkpointed-adjoint shape of CVODES's
``CVodeAdjInit``.

1. **Grid-pinning pass**: one plain adaptive BDF solve at a detached
   theta records each lane's accepted-step times (``n_save = grid_size``).
   The grid carries no gradient: gradients flow through solution values,
   never through step-size control.
2. **Differentiable re-solve**: a fixed-grid SDIRK4 sweep over those knots
   (the tableau of ``solver.sdirk``), ``grid_refine`` equal substeps per
   slot.  Each implicit stage is a ``torch.autograd.Function``: forward
   runs modified Newton to a tight displacement test under ``no_grad``,
   lane by lane; backward solves one transposed system ``(I - h gamma
   J)^T lam = zbar`` at the converged stage and pulls the theta cotangent
   through one RHS vjp.  Newton's iterations are never recorded.  Padded
   (zero-width) slots are exact no-ops.
3. **Checkpointing**: the slots run in ``segments`` chunks under
   ``torch.utils.checkpoint`` (non-reentrant), so the backward pass keeps
   only segment-boundary states and recomputes each segment's stages.

The JAX package solves one lane and maps it over lanes with ``vmap``.
Here the lanes are one batch: theta given as (B, K) rows, one per lane,
makes the lanes independent, and one backward pass of sum_b QoI_b gives
every lane its own gradient.  A shared (K,) theta gives the sum of the
lanes' gradients.  A slot that is zero-width on every lane is skipped.

Cost of a gradient: one adaptive solve, one fixed-grid solve and one
backward sweep, independent of the number of parameters.
"""

import torch
from torch.utils.checkpoint import checkpoint

from ..obs.recorder import span_or_null
from ..solver import bdf, graphs
from ..solver.linalg import make_solve_m
from ..solver.sdirk import _A, _B, _C, _GAMMA
from . import params as P


def _resolve_linsolve(linsolve, device):
    """``"auto"``: ``"lu"`` on the CPU, ``"inv32"`` on CUDA."""
    if linsolve == "auto":
        return "lu" if torch.device(device).type == "cpu" else "inv32"
    return linsolve


def _stage_newton(fns, base, t_s, hg, theta, cfg, max_iter=12):
    """Solve z = base + hg f(t_s, z) per lane by modified Newton (matrix
    factored once at the stage base); a lane stops at its own
    convergence."""
    f, jacf, linsolve, _ = fns
    n = base.shape[-1]
    eye = torch.eye(n, dtype=base.dtype, device=base.device)
    M = eye - hg[:, None, None] * jacf(t_s, base, theta, cfg)
    solve_m = make_solve_m(M, linsolve, base.dtype)
    # displacement test on the state scale; tight because the backward
    # pass assumes the stage equation holds to roundoff
    scale = 1e-10 + 1e-8 * torch.abs(base)
    z = base
    done = torch.zeros(base.shape[0], dtype=torch.bool, device=base.device)
    for _ in range(max_iter):
        g = z - base - hg[:, None] * f(t_s, z, theta, cfg)
        dz = solve_m(-g)
        dn = torch.sqrt(torch.mean(torch.square(dz / scale), dim=-1))
        z = torch.where(done[:, None], z, z + dz)
        done = done | (dn < 1e-3) | ~torch.isfinite(dn)
        # the adjoint runs eagerly and is never captured: its Newton loop
        # may stop on the host
        if bool(done.all()):  # brlint: disable=host-sync-call
            break
    return z


class _ImplicitStage(torch.autograd.Function):
    """z(base, theta) solving the SDIRK stage equation, differentiated by
    the implicit function theorem (``jax.custom_vjp`` in the JAX
    package)."""

    @staticmethod
    def forward(ctx, base, theta_flat, t_s, hg, fns, cfg):
        unflatten = fns[3]
        with torch.no_grad():
            z = _stage_newton(fns, base, t_s, hg, unflatten(theta_flat), cfg)
        ctx.save_for_backward(z, theta_flat, t_s, hg)
        ctx.fns, ctx.cfg = fns, cfg
        return z

    @staticmethod
    def backward(ctx, zbar):
        # (I - hg J) dz = dbase + hg f_theta dtheta at the converged stage:
        # base_bar = M^-T zbar, theta_bar = hg f_theta^T M^-T zbar
        z, theta_flat, t_s, hg = ctx.saved_tensors
        f, jacf, linsolve, unflatten = ctx.fns
        with torch.no_grad():
            J = jacf(t_s, z, unflatten(theta_flat), ctx.cfg)
            eye = torch.eye(z.shape[-1], dtype=z.dtype, device=z.device)
            MT = (eye - hg[:, None, None] * J).transpose(-1, -2)
            lam = make_solve_m(MT, linsolve, z.dtype)(zbar)
        theta_bar = None
        if ctx.needs_input_grad[1]:
            with torch.enable_grad():
                th = theta_flat.detach().requires_grad_(True)
                out = f(t_s, z, unflatten(th), ctx.cfg)
                theta_bar, = torch.autograd.grad(out, th,
                                                 grad_outputs=hg[:, None]
                                                 * lam)
        return lam, theta_bar, None, None, None, None


def _sdirk_step(fns, y, t_prev, t_next, theta_flat, cfg):
    """One fixed-step SDIRK4 step per lane from t_prev to t_next (B,); a
    lane whose slot is padding (t_next <= t_prev) keeps its state."""
    h = t_next - t_prev
    live = h > 0
    h_eff = torch.where(live, h, 0.0)
    h_safe = torch.where(live, h, 1.0)
    ks = []
    for i, a_row in enumerate(_A):
        base = y
        for j in range(i):
            base = base + (h_eff * a_row[j])[:, None] * ks[j]
        t_s = t_prev + _C[i] * h_eff
        z = _ImplicitStage.apply(base, theta_flat, t_s, h_eff * _GAMMA, fns,
                                 cfg)
        # k = f(t_s, z) at convergence, without a second RHS evaluation;
        # exactly 0 on padded slots (z == base there)
        ks.append((z - base) / (h_safe * _GAMMA)[:, None])
    return y + h_eff[:, None] * sum(b * k for b, k in zip(_B, ks))


def _fixed_grid_solve(fns, y0, t_prev, t_next, theta_flat, cfg, segments):
    """The fixed grid (B, N) in ``segments`` checkpointed chunks: returns
    (ys (B, N, n) states at the knots, y_final)."""
    N = t_prev.shape[1]
    if N % segments:
        raise ValueError(f"grid size {N} not divisible by "
                         f"segments={segments}")
    L = N // segments

    def segment(y, theta_flat, tps, tns):
        ys = []
        for k in range(L):
            # eager (never captured): a grid slot no lane reaches is
            # skipped on the host
            if bool((tns[:, k] > tps[:, k]).any()):  # brlint: disable=host-sync-call
                y = _sdirk_step(fns, y, tps[:, k], tns[:, k], theta_flat,
                                cfg)
            ys.append(y)
        return torch.stack(ys, dim=1)

    y, out = y0, []
    for s in range(segments):
        ys = checkpoint(segment, y, theta_flat, t_prev[:, s * L:(s + 1) * L],
                        t_next[:, s * L:(s + 1) * L], use_reentrant=False)
        out.append(ys)
        y = ys[:, -1]
    return torch.cat(out, dim=1), y


def final_species_qoi(index):
    """QoI builder: the final-state component ``y(t1)[:, index]`` per lane
    (a species mass density, or a coverage for indices past n_gas)."""

    def qoi(tk, ys, y_final):
        return y_final[:, index]

    return qoi


def ignition_delay_qoi(marker, frac=0.5):
    """QoI builder: ignition delay as the interpolated first crossing of
    the marker species below ``frac`` x its first-knot value, per lane
    (``energy.ignition.grid_crossing``: the crossing index carries no
    gradient, the bracketing values do; NaN where never crossed)."""
    from ..energy.ignition import grid_crossing

    def qoi(tk, ys, y_final):
        m = ys[:, :, marker]
        return grid_crossing(tk, m, frac * m[:, 0])

    return qoi


def solve_adjoint(rhs_theta, qoi_fn, y0, t0, t1, theta, cfg, *,
                  jac_theta=None, rtol=1e-6, atol=1e-10, grid_size=256,
                  segments=8, grid_refine=2, max_steps=100_000,
                  jac_window=1, linsolve="auto", dt0=None, stats=False,
                  recorder=None):
    """Gradient of a scalar QoI per lane with respect to theta.

    ``rhs_theta(t, y, theta, cfg)`` / optional ``jac_theta(t, y, theta,
    cfg)`` are the theta-parameterized RHS and Jacobian on lane batches
    (``params.make_rhs_theta``); ``qoi_fn(tk, ys, y_final) -> (B,)`` takes
    the knot times (B, N), the knot states (B, N, n) and the final states
    (B, n) (builders: :func:`final_species_qoi`,
    :func:`ignition_delay_qoi`).  ``y0`` is (B, n); ``theta`` a dict of
    (B, K) rows (one per lane: per-lane gradients) or (K,) (shared: the
    lanes' gradients summed).

    Returns ``(qoi (B,), grad, aux)``: ``grad`` is theta-shaped, and
    ``aux`` carries the grid pass's ``status`` and ``truncated`` (True
    where a lane accepted more steps than ``grid_size``: its re-solve lost
    resolution, raise ``grid_size``).  ``grid_refine=r`` splits every
    pinned step into r equal SDIRK4 substeps.  ``linsolve="auto"`` is
    ``"lu"`` on the CPU and ``"inv32"`` on CUDA, for both passes.

    Telemetry: ``stats=True`` turns on the grid-pinning pass's counter
    block (``aux["stats"]``); ``recorder`` (an ``obs.Recorder``) gets
    ``adjoint_pin`` and ``adjoint_grad`` spans around the two passes, each
    waiting for the card before it closes.
    """
    linsolve = _resolve_linsolve(linsolve, y0.device)
    theta0 = {k: v.detach() for k, v in theta.items()}

    def rhs0(t, y, cfg):
        return rhs_theta(t, y, theta0, cfg)

    jac0 = None
    if jac_theta is not None:
        def jac0(t, y, cfg):
            return jac_theta(t, y, theta0, cfg)

    with span_or_null(recorder, "adjoint_pin", grid_size=int(grid_size)):
        prim = bdf.solve(rhs0, y0, t0, t1, cfg, rtol=rtol, atol=atol,
                         max_steps=max_steps, n_save=grid_size, jac=jac0,
                         jac_window=jac_window, linsolve=linsolve, dt0=dt0,
                         stats=stats)
        if recorder is not None:
            graphs.block(prim.y)
    B = y0.shape[0]
    tk = torch.minimum(prim.ts, torch.as_tensor(t1, dtype=y0.dtype,
                                                device=y0.device))
    t_prev = torch.cat([torch.as_tensor(t0, dtype=tk.dtype,
                                        device=tk.device).expand(B, 1),
                        tk[:, :-1]], dim=1)
    t_next = tk
    if grid_refine > 1:
        # equal subdivision of every slot; zero-width slots subdivide into
        # zero-width slots, still exact no-ops
        r = int(grid_refine)
        w = torch.arange(r, dtype=tk.dtype, device=tk.device) / r
        starts = t_prev[:, :, None] + (t_next - t_prev)[:, :, None] * w
        ends = torch.cat([starts[:, :, 1:], t_next[:, :, None]], dim=2)
        t_prev, t_next = starts.reshape(B, -1), ends.reshape(B, -1)

    if jac_theta is not None:
        jacf = jac_theta
    else:
        def jacf(t, z, th, cf):
            def one(t1_, y1, th1, cf1):
                return rhs_theta(t1_[None], y1[None],
                                 {k: v[None] for k, v in th1.items()},
                                 {k: v[None] for k, v in cf1.items()})[0]

            th_b = {k: v.expand(z.shape[0], -1) for k, v in th.items()}
            return torch.func.vmap(torch.func.jacfwd(one, argnums=1))(
                t.expand(z.shape[0]), z, th_b, cf)

    theta_flat, unflatten = P.flatten(theta)
    theta_flat = theta_flat.detach().requires_grad_(True)
    fns = (rhs_theta, jacf, linsolve, unflatten)
    with span_or_null(recorder, "adjoint_grad", segments=int(segments)):
        ys, y_final = _fixed_grid_solve(fns, y0, t_prev, t_next, theta_flat,
                                        cfg, segments)
        qoi = qoi_fn(t_next, ys, y_final)
        grad_flat, = torch.autograd.grad(qoi.sum(), theta_flat)
        if recorder is not None:
            graphs.block(grad_flat)
    aux = {"status": prim.status, "t": prim.t, "y": prim.y,
           "n_accepted": prim.n_accepted, "n_rejected": prim.n_rejected,
           "truncated": prim.n_accepted > grid_size, "ts": tk,
           "stats": prim.stats}
    return qoi.detach(), unflatten(grad_flat), aux
