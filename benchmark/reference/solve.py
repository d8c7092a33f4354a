"""The plain reference's integration of one lane, and the gaps that decide
``correct``.

A lane is integrated by SciPy's variable-order BDF (``solve_ivp``), on the
reference's own right-hand side and its complex-step Jacobian
(``chem.Reactor``).  The reference runs at tolerances far below the
cell's, so its own error is small beside the gap it measures; the control
runs the same code in float32 at the cell's tolerances, in the program's
place.
"""

import numpy as np
from scipy.integrate import solve_ivp

def solve_lane(reactor, T, Asv, y0, t1, rtol, atol, marker=None):
    """Integrate one lane to ``t1``: returns ``{"ok", "y", "tau"}``, with
    tau the first time the marker species' density falls below half its
    initial value (NaN when it never does or without ``marker``)."""
    def f(t, y):
        return reactor.rhs(T, Asv, y)

    def jac(t, y):
        return reactor.jac(T, Asv, y)

    events = None
    if marker is not None:
        half = 0.5 * y0[marker]

        def crossing(t, y):
            return y[marker] - half
        crossing.direction = -1
        events = [crossing]
    sol = solve_ivp(f, (0.0, t1), np.asarray(y0, dtype=np.float64),
                    method="BDF", rtol=rtol, atol=atol, jac=jac,
                    events=events)
    tau = float("nan")
    if events is not None and sol.t_events[0].size:
        tau = float(sol.t_events[0][0])
    return {"ok": bool(sol.success), "y": sol.y[:, -1], "tau": tau,
            "steps": int(sol.t.size - 1)}


def mole_fractions(rho, molwt):
    n = rho / molwt
    return n / n.sum()


def element_fractions(x, elem):
    """Atom fractions of each element in a mixture of mole fractions ``x``
    (elem: (S, E) atoms per molecule): conserved by every reaction, so the
    reference's equal the initial ones to rounding."""
    a = x @ elem
    return a / a.sum()


def lane_numbers(got, ref, y0, molwt, elem, ng):
    """The gaps of one lane: ``got`` is the program's (``status_ok``,
    ``x`` (ng,), optionally ``tau`` and ``covg``), ``ref`` the reference's
    :func:`solve_lane` result from the initial state ``y0``.  The conserved
    quantities (the gas's atom fractions in a gas-only reactor, the sum of
    the coverages) are compared with their initial values, which the
    reference's solution keeps exactly but for its own rounding."""
    x_ref = mole_fractions(ref["y"][:ng], molwt)
    x0 = mole_fractions(y0[:ng], molwt)
    out = {"status": 0.0 if (got["status_ok"] and ref["ok"]) else 1.0,
           "x_gap": float(np.max(np.abs(got["x"] - x_ref))),
           "elem_gap": float(np.max(np.abs(
               element_fractions(got["x"], elem)
               - element_fractions(x0, elem))))}
    if "tau" in got:
        tr, tp = ref["tau"], got["tau"]
        out["tau_gap"] = (0.0 if np.isnan(tr) and np.isnan(tp) else
                          float(abs(tp - tr) / tr) if not (np.isnan(tr)
                                                           or np.isnan(tp))
                          else float("inf"))
    if "covg" in got:
        th = ref["y"][ng:]
        out["covg_gap"] = float(np.max(np.abs(got["covg"] - th)))
        out["site_gap"] = float(abs(got["covg"].sum() - y0[ng:].sum()))
    return out


def worst(lanes):
    """Each number's worst value over the lanes (a NaN counts as inf)."""
    keys = lanes[0].keys() if lanes else ()
    return {k: max(float("inf") if np.isnan(l[k]) else l[k] for l in lanes)
            for k in keys}
