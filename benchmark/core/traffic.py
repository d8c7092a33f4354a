"""The general generator of conditions: every traffic file's conditions come
from here, from the seed.

A traffic file's ``conditions`` block gives axes, each ``{"name", "lo",
"hi", "bins", "scale": "linear" | "log"}``.  The lanes are the product of
the axes' bins (the first axis major); each lane takes one uniform draw
inside its own bin (in log10 for a log axis); a ``"shared": true`` axis
takes one draw for the whole batch (one composition per request).  So
every seed gives the same amount of work at the same spread of
conditions, in other places inside the bins.  Where that still changes
the work from seed to seed (a sweep lasts as long as its slowest lane), a
``"fixed_set": n`` in ``conditions`` draws the lanes once from ``n``, the
same for every seed and every batch, and the seed only orders them.  ``composition`` is either
``{"fixed": {species: x}}`` or ``{"premixed": {"fuel", "oxidizer",
"stoich_o2", "diluent", "diluent_per_o2"}}`` over a ``phi`` axis.
"""

import numpy as np


def rng(seed, *stream):
    """A generator for one stream of a run: the seed (any integer, reduced
    to 64 bits) and the stream's indices."""
    return np.random.default_rng([int(seed) % 2 ** 64, *stream])


def stratified(axes, gen):
    """{axis: (B,)} with one draw inside each cell of the axes' bins."""
    bins = [int(a["bins"]) for a in axes]
    idx = np.stack(np.meshgrid(*[np.arange(b) for b in bins],
                               indexing="ij"), -1).reshape(-1, len(bins))
    u = gen.random(idx.shape)
    out = {}
    for j, a in enumerate(axes):
        # a shared axis takes one draw for the whole batch
        u_j = u[0, j] if a.get("shared") else u[:, j]
        f = (idx[:, j] + u_j) / bins[j]
        if a.get("scale", "linear") == "log":
            lo, hi = np.log10(a["lo"]), np.log10(a["hi"])
            out[a["name"]] = 10.0 ** (lo + f * (hi - lo))
        else:
            out[a["name"]] = a["lo"] + f * (a["hi"] - a["lo"])
    return out


def premixed(species, phi, fuel, oxidizer, stoich_o2, diluent=None,
             diluent_per_o2=0.0):
    """(B, S) mole fractions of a fuel/oxidizer premix at equivalence ratios
    ``phi``: phi moles of fuel per ``stoich_o2`` moles of O2, the diluent
    riding with the oxidizer.  Frozen copy of the arithmetic of
    ``batchreactor_tpu_torch/parallel/grid.py::premixed_mole_fracs`` (as
    ``tools/northstar_sweep.py::map_states`` calls it)."""
    phi = np.atleast_1d(np.asarray(phi, dtype=np.float64))
    sp = {s.upper(): k for k, s in enumerate(species)}
    n_fuel = phi
    n_o2 = np.full_like(phi, stoich_o2)
    n_dil = n_o2 * (diluent_per_o2 or 0.0)
    total = n_fuel + n_o2 + n_dil
    x = np.zeros((phi.shape[0], len(species)))
    x[:, sp[fuel.upper()]] = n_fuel / total
    x[:, sp[oxidizer.upper()]] = n_o2 / total
    if diluent:
        x[:, sp[diluent.upper()]] = n_dil / total
    return x


def mole_fractions(comp, species, cond):
    """(B, S) mole fractions of the lanes ``cond``."""
    B = len(next(iter(cond.values())))
    if "fixed" in comp:
        sp = {s.upper(): k for k, s in enumerate(species)}
        x = np.zeros((B, len(species)))
        for name, v in comp["fixed"].items():
            x[:, sp[name.upper()]] = v
        return x
    return premixed(species, cond["phi"], **comp["premixed"])


def draw(conditions, species, gen):
    """One batch of lanes: ``{"T": (B,), "Asv": (B,), "X": (B, S)}``
    (``Asv`` 1 where the axes have none)."""
    if "fixed_set" in conditions:
        cond = stratified(conditions["axes"],
                          np.random.default_rng(int(conditions["fixed_set"])))
        B = len(next(iter(cond.values())))
        order = gen.permutation(B)
        cond = {k: v[order] for k, v in cond.items()}
    else:
        cond = stratified(conditions["axes"], gen)
        B = len(next(iter(cond.values())))
    return {"T": cond["T"],
            "Asv": cond.get("Asv", np.ones(B)),
            "X": mole_fractions(conditions["composition"], species, cond),
            "axes": cond}
