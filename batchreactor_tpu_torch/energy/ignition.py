"""Ignition delay of energy-mode sweeps: the crossing rule and the
in-loop detector.

Port of ``batchreactor_tpu/energy/ignition.py``, as lane-batched folds in
the observer form of ``parallel/sweep.py``:

* :func:`interp_crossing` / :func:`grid_crossing` — the one linear-
  interpolation crossing rule;
* :func:`energy_ignition_observer` — the streaming detector: the running
  maximum of dT/dt over accepted-step intervals (the max-temperature-rise
  marker) and the first interpolated crossing of ``T0 + dT_thr``;
* :func:`merge_observers` — two folds over disjoint keys as one;
* :func:`extract_delay` — the host-side read-out: the max-dT/dt time where
  the lane ignited (T rose by >= ``dT_min``), NaN elsewhere;
* :func:`temperature_ignition_qoi` and :func:`delay_sensitivity_forward`
  — the ignition delay's gradient passes (adjoint QoI, forward tangents).
"""

import numpy as np
import torch

#: default temperature rise [K] of the threshold detector
DEFAULT_DT_THRESHOLD = 400.0

#: default minimum temperature rise [K] for a lane to count as ignited
DEFAULT_DT_MIN = 50.0


def interp_crossing(t_prev, t_cur, v_prev, v_cur, thr):
    """Linearly interpolated crossing time of ``thr`` inside the bracket
    ``(t_prev, v_prev) -> (t_cur, v_cur)``, elementwise; a flat bracket
    (``v_prev == v_cur``) clamps onto ``t_cur``."""
    denom = v_cur - v_prev
    w = torch.where(denom != 0, (thr - v_prev) / denom, 1.0)
    w = torch.clamp(w, 0.0, 1.0)
    return t_prev + w * (t_cur - t_prev)


def grid_crossing(tk, m, thr, rising=False):
    """Interpolated first crossing of ``thr`` by the series ``m`` (..., K)
    over knot times ``tk`` (K,) or (..., K), per series; NaN where the
    series never crosses.  ``thr`` is a scalar or one value per series."""
    m = torch.as_tensor(m)
    tk = torch.as_tensor(tk, dtype=m.dtype, device=m.device).expand_as(m)
    thr = torch.as_tensor(thr, dtype=m.dtype, device=m.device)
    thr = thr.expand(m.shape[:-1])
    hit = (m > thr[..., None]) if rising else (m < thr[..., None])
    j = torch.clamp(torch.argmax(hit.to(torch.uint8), dim=-1), min=1)
    j = j[..., None]

    def at(x, k):
        return torch.gather(x, -1, k)[..., 0]

    t_x = interp_crossing(at(tk, j - 1), at(tk, j), at(m, j - 1), at(m, j),
                          thr)
    return torch.where(torch.any(hit, dim=-1), t_x, torch.nan)


def energy_ignition_observer(t_index, dT_thr=DEFAULT_DT_THRESHOLD):
    """(observer, init) extracting ignition delay during an energy-mode
    solve; ``t_index`` is the temperature row's index (the trailing row).
    ``observer(t (B,), y (B, n), acc) -> acc``; ``init`` holds Python
    floats (the ensemble solvers broadcast them to lanes).  Keys, all
    ``ign_``-prefixed: ``ign_tau_dT`` (midpoint of the steepest accepted-
    step dT/dt interval; gate it with :func:`extract_delay`),
    ``ign_tau_thr`` (first crossing of ``T0 + dT_thr``, NaN until
    crossed), ``ign_T0`` and ``ign_T_max`` (first-seen and running-max
    temperature)."""
    nan, ninf = float("nan"), -float("inf")
    init = {"ign_t_prev": nan, "ign_T_prev": nan, "ign_T0": nan,
            "ign_T_max": ninf, "ign_slope_max": ninf, "ign_tau_dT": nan,
            "ign_tau_thr": nan}

    def observer(t, y, acc):
        T = y[:, t_index]
        t_prev, T_prev = acc["ign_t_prev"], acc["ign_T_prev"]
        T0 = torch.where(torch.isnan(acc["ign_T0"]), T, acc["ign_T0"])
        dt = t - t_prev
        valid = torch.isfinite(t_prev) & (dt > 0)
        slope = torch.where(valid, (T - T_prev)
                            / torch.where(dt > 0, dt, 1.0), -torch.inf)
        steeper = slope > acc["ign_slope_max"]
        tau_dT = torch.where(steeper, t_prev + 0.5 * dt, acc["ign_tau_dT"])
        thr = T0 + dT_thr
        crossed = (torch.isnan(acc["ign_tau_thr"]) & valid & (T >= thr)
                   & (T_prev < thr))
        t_x = interp_crossing(t_prev, t, T_prev, T, thr)
        return {"ign_t_prev": t, "ign_T_prev": T, "ign_T0": T0,
                "ign_T_max": torch.maximum(T, acc["ign_T_max"]),
                "ign_slope_max": torch.maximum(slope,
                                               acc["ign_slope_max"]),
                "ign_tau_dT": tau_dT,
                "ign_tau_thr": torch.where(crossed, t_x,
                                           acc["ign_tau_thr"])}

    return observer, init


def merge_observers(a, a0, b, b0):
    """Two observer folds over disjoint key sets as one; raises on a key
    collision (a shadowed fold would report one detector's tau as the
    other's)."""
    overlap = sorted(set(a0) & set(b0))
    if overlap:
        raise ValueError(f"observer folds collide on key(s) {overlap}")

    init = {**a0, **b0}

    def observer(t, y, acc):
        out_a = a(t, y, {k: acc[k] for k in a0})
        out_b = b(t, y, {k: acc[k] for k in b0})
        return {**out_a, **out_b}

    return observer, init


def _host(x):
    if torch.is_tensor(x):
        x = x.detach().cpu()
    return np.asarray(x, dtype=np.float64)


def extract_delay(observed, dT_min=DEFAULT_DT_MIN):
    """Per-lane ignition delay from an :func:`energy_ignition_observer`
    fold, as a numpy array: the max-dT/dt time where the lane's
    temperature rose by >= ``dT_min`` Kelvin, NaN elsewhere."""
    tau = _host(observed["ign_tau_dT"])
    rise = _host(observed["ign_T_max"]) - _host(observed["ign_T0"])
    return np.where(rise >= float(dT_min), tau, np.nan)


# --------------------------------------------------------------------------
# gradient passes: the adjoint QoI and the forward implicit-function pass
# --------------------------------------------------------------------------
def temperature_ignition_qoi(t_index, dT_thr=DEFAULT_DT_THRESHOLD):
    """Adjoint QoI builder (``sensitivity.adjoint.solve_adjoint``:
    ``qoi(tk, ys, y_final) -> (B,)``): the ignition delay as the
    interpolated first rising crossing of ``T0 + dT_thr`` on each lane's
    pinned-grid temperature row."""

    def qoi(tk, ys, y_final):
        Tser = ys[:, :, t_index]
        return grid_crossing(tk, Tser, Tser[:, 0] + dT_thr, rising=True)

    return qoi


def delay_sensitivity_forward(rhs_theta, y0, theta, cfg, t_index, *,
                              t_max, jac=None, dT_thr=DEFAULT_DT_THRESHOLD,
                              rtol=1e-8, atol=1e-12, max_steps=100_000,
                              jac_window=1, sens_iters=2):
    """Forward (tangent) ignition-delay gradients of every lane of ``y0``
    (B, n): ``(tau (B,), grad, aux)`` with ``grad`` theta-shaped, (B, K)
    per field, dtau/dtheta.

    tau is the threshold time T(tau) = T0 + ``dT_thr``, and the gradient is
    the implicit-function theorem at the crossing, dtau/dtheta = -S_T(tau)
    / Tdot(tau), in two passes: (1) a plain adaptive solve to ``t_max``
    finds the interpolated crossing (:func:`energy_ignition_observer`);
    (2) a tangent-carrying solve (``sensitivity.forward.solve_forward``,
    tangent error control on) to t1 = tau lands state and tangents on the
    crossing, where one RHS evaluation closes Tdot.  ``jac(t, y, theta,
    cfg)`` is the theta-parameterized analytic Jacobian.  A lane that
    never crosses inside ``t_max`` gets NaN (``aux["ignited"]`` False).
    """
    from ..sensitivity import params as P
    from ..sensitivity.forward import solve_forward
    from ..solver import bdf

    theta0 = {k: v.detach() for k, v in theta.items()}

    def rhs0(t, y, cfg):
        return rhs_theta(t, y, theta0, cfg)

    jac0 = None
    if jac is not None:
        def jac0(t, y, cfg):
            return jac(t, y, theta0, cfg)

    B = y0.shape[0]
    observer, obs0 = energy_ignition_observer(t_index, dT_thr=dT_thr)
    obs0 = {k: torch.full((B,), v, dtype=y0.dtype, device=y0.device)
            for k, v in obs0.items()}
    pin = bdf.solve(rhs0, y0, 0.0, float(t_max), cfg, rtol=rtol, atol=atol,
                    max_steps=max_steps, jac=jac0, jac_window=jac_window,
                    observer=observer, observer_init=obs0)
    tau = pin.observed["ign_tau_thr"]
    ignited = torch.isfinite(tau)
    theta_flat, unflat = P.flatten(theta)
    nP = theta_flat.shape[-1]
    aux = {"ignited": ignited, "status": pin.status}
    if not bool(ignited.any()):
        grad = torch.full((B, nP), torch.nan, dtype=y0.dtype,
                          device=y0.device)
        return tau, unflat(grad), {**aux, "Tdot": torch.full_like(tau,
                                                               torch.nan)}
    jac_fixed = None
    if jac is not None:
        def jac_fixed(t, y, cfg):
            return jac(t, y, theta, cfg)

    # a lane that never crossed runs to t_max and reports NaN
    t1 = torch.where(ignited, tau, float(t_max))
    res = solve_forward(rhs_theta, y0, 0.0, t1, theta, cfg, rtol=rtol,
                        atol=atol, max_steps=max_steps, jac=jac_fixed,
                        jac_window=jac_window, sens_iters=sens_iters,
                        sens_errcon=True)
    Tdot = rhs_theta(res.t, res.y, theta, cfg)[:, t_index]
    grad = -res.tangents[:, :, t_index] / Tdot[:, None]
    grad = torch.where(ignited[:, None], grad, torch.nan)
    return tau, unflat(grad), {
        **aux, "status": res.status, "Tdot": Tdot,
        "T_at_tau": res.y[:, t_index], "n_accepted": res.n_accepted}
