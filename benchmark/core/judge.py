"""The comparison that decides ``correct``: lanes the timed path answered,
drawn from the seed after the window has closed, against the plain
reference (``benchmark/reference/``) solved from the same conditions.

Each compared number is the worst over the drawn lanes:

* ``status``: 1 where the program's lane did not end in success (or the
  reference failed), else 0 - an exact comparison;
* ``elem_gap``: the largest gap in the atom fraction of an element of the
  gas between the program's final mole fractions and the reference's
  initial state (isothermal gas chemistry conserves them; a float32
  computation drifts);
* ``site_gap``: the gap between the program's sum of the final coverages
  and the initial one (sites are conserved);
* ``tau_gap``: the relative gap of the ignition delay;
* ``x_gap``, ``covg_gap``: the largest gap of a final mole fraction or
  coverage.

The configuration's ``correct`` block names the numbers it compares, with
each one's limit, how many lanes a run draws, and the reference's own
tolerances (far below the cell's, so that its error is small beside the
gaps it measures).
"""

import os

import numpy as np

from benchmark.reference import chem, solve

ELEMENTS = ("C", "H", "O", "N", "AR")


class Reference:
    """The reference models of one configuration, in ``dtype``."""

    def __init__(self, config, root, dtype=np.float64):
        f = {k: os.path.join(root, v["path"])
             for k, v in config["files"].items()}
        self.gas = chem.Gas(f["mech"], f["therm"], dtype)
        self.surface = (chem.Surface(f["surface"], self.gas.species,
                                     self.gas.thermo.molwt, dtype)
                        if "surface" in f else None)
        self.reactor = chem.Reactor(self.gas, self.surface)
        self.ng = len(self.gas.species)
        names = [e for e in ELEMENTS
                 if any(e in el for el in self.gas.thermo.elements)]
        self.elem = self.gas.thermo.element_matrix(names)
        marker = config.get("observe", {}).get("ignition_marker")
        self.marker = (self.gas.species.index(marker.upper())
                       if marker else None)

    def y0(self, lane, p):
        th0 = None if self.surface is None else self.surface.theta0
        return chem.initial_state(self.gas.thermo, lane["X"], lane["T"], p,
                                  th0)

    def solve(self, lane, p, t1, rtol, atol):
        return solve.solve_lane(self.reactor, lane["T"], lane["Asv"],
                                self.y0(lane, p), t1, rtol, atol,
                                marker=self.marker)


def draw_lanes(sizes, k, gen):
    """``k`` distinct (batch, lane) pairs from batches of ``sizes`` lanes,
    stratified: pick ``j`` lies in the ``j``-th of ``k`` equal, contiguous
    blocks of a batch drawn from the seed, and the picks alternate in
    parity from a drawn start.  So every draw of ``k >= 2`` holds a lane of
    each half of a batch, and of its even and its odd lanes, and one of
    ``k >= 4`` a lane of each quarter: a fault in any of them is always
    compared.  Fewer picks where a batch has fewer than ``k`` lanes."""
    start = int(gen.integers(2))
    out = []
    for j in range(k):
        b = int(gen.integers(len(sizes)))
        n = int(sizes[b])
        lo, hi = j * n // k, (j + 1) * n // k
        if hi <= lo:
            continue
        block = np.arange(lo, hi)
        same = block[block % 2 == (start + j) % 2]
        out.append((b, int(gen.choice(same if same.size else block))))
    return sorted(out)


def compare(config, root, lanes, p, t1, answers=None, log=None):
    """Judge ``lanes`` (each ``{"T", "Asv", "X", "got"}``; ``got`` the
    program's ``{"status_ok", "x", ["tau"], ["covg"]}``).  ``answers``, one
    per lane, stands in for the program's (the control).  Returns
    ``(correct, {name: {"value", "limit"}})``."""
    spec = config["correct"]
    ref = Reference(config, root)
    per_lane = []
    tol = spec["reference_tolerances"]
    for i, lane in enumerate(lanes):
        r = ref.solve(lane, p, t1, tol["rtol"], tol["atol"])
        got = lane["got"] if answers is None else answers[i]
        nums = solve.lane_numbers(got, r, ref.y0(lane, p),
                                  ref.gas.thermo.molwt, ref.elem, ref.ng)
        per_lane.append(nums)
        if log is not None:
            log(f"lane T={lane['T']:.3f} Asv={lane['Asv']:.4g}: " + ", ".join(
                f"{k}={v:.4g}" for k, v in nums.items()))
    worst = solve.worst(per_lane)
    compared = {}
    for name, limit in spec["limits"].items():
        v = worst.get(name, float("inf")) if per_lane else float("inf")
        compared[name] = {"value": float(v), "limit": float(limit)}
    ok = bool(per_lane) and all(c["value"] <= c["limit"]
                                for c in compared.values())
    return ok, compared
