"""Condition grids for ensemble sweeps.

Port of ``batchreactor_tpu/parallel/grid.py``: a sweep is data, a dict of
per-lane parameter tensors handed to ``ensemble_solve`` (one lane per grid
point) plus the matching (B, S) initial-state block.  These helpers build
the standard grids — (phi, T0) ignition maps, catalyst-loading (Asv)
scans — as flat (B,) condition vectors.
"""

import numpy as np
import torch

from ..device import resolve_device
from ..utils.composition import density, mole_to_mass


def condition_grid(device=None, **axes):
    """Cartesian product of named 1-D axes -> dict of flat (B,) float64
    tensors, lane-major over the product in the order the axes are
    given (the last axis varies fastest)."""
    dev = resolve_device(device)
    names = list(axes)
    arrays = [torch.atleast_1d(torch.as_tensor(axes[k], dtype=torch.float64,
                                               device=dev)) for k in names]
    mesh = torch.meshgrid(*arrays, indexing="ij")
    return {k: m.reshape(-1) for k, m in zip(names, mesh)}


def premixed_mole_fracs(species, fuel, phi, oxidizer="O2", diluent=None,
                        stoich_o2=None, o2_to_diluent=None, device=None):
    """Per-lane premixed fuel/oxidizer mole fractions over a phi grid,
    (B, S) float64.

    ``phi`` is the equivalence ratio (fuel/O2) / (fuel/O2)_stoich;
    ``stoich_o2`` the stoichiometric O2 per mole of fuel (2.0 for CH4,
    0.5 for H2).  With ``diluent`` (e.g. "N2") and ``o2_to_diluent`` (3.76
    for air) the diluent rides with the oxidizer stream."""
    if stoich_o2 is None:
        raise ValueError("stoich_o2 (moles O2 per mole fuel at phi=1) is "
                         "required")
    if o2_to_diluent and diluent is None:
        raise ValueError("o2_to_diluent given without a diluent species")
    dev = resolve_device(device)
    phi = torch.atleast_1d(torch.as_tensor(phi, dtype=torch.float64,
                                           device=dev))
    sp = {s: k for k, s in enumerate(species)}
    for name in (fuel, oxidizer) + ((diluent,) if diluent else ()):
        if name not in sp:
            raise KeyError(f"species {name!r} not in mechanism species list")
    n_fuel = phi                      # moles fuel per stoich_o2 moles O2
    n_o2 = torch.full_like(phi, stoich_o2)
    n_dil = n_o2 * (o2_to_diluent or 0.0)
    total = n_fuel + n_o2 + n_dil
    cols = {sp[fuel]: n_fuel / total, sp[oxidizer]: n_o2 / total}
    if diluent:
        cols[sp[diluent]] = n_dil / total
    x = torch.zeros((phi.shape[0], len(species)), dtype=phi.dtype,
                    device=dev)
    for k, v in cols.items():
        x[:, k] = v
    return x


def sweep_solution_vectors(mole_fracs, molwt, T, p, ini_covg=None):
    """Batched y0 builder on ``molwt``'s device: (B, S) mole fractions and
    per-lane T, p (scalars broadcast) -> y0 = rho Y_k, (B, S[+Ss]), with
    ``ini_covg`` (Ss,) appended to every lane (the surface path)."""
    dev = molwt.device
    if not torch.is_tensor(mole_fracs):
        mole_fracs = torch.tensor(np.asarray(mole_fracs, dtype=np.float64))
    x = torch.atleast_2d(mole_fracs.to(device=dev, dtype=torch.float64))
    B = x.shape[0]
    T = torch.as_tensor(T, dtype=x.dtype, device=dev).expand(B)
    p = torch.as_tensor(p, dtype=x.dtype, device=dev).expand(B)
    y = density(x, molwt, T, p)[:, None] * mole_to_mass(x, molwt)
    if ini_covg is None:
        return y
    covg = torch.as_tensor(ini_covg, dtype=y.dtype, device=dev)
    return torch.cat([y, covg.expand(B, covg.shape[0])], dim=1)
