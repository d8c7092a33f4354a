"""Composition and unit conversions on lane-batched tensors.

Port of ``batchreactor_tpu/utils/composition.py``.  Compositions carry the
species on the last axis and any number of leading (lane) axes; ``T`` and
``p`` broadcast against the leading axes.  ``molwt`` is kg/mol.
"""

import torch

from .constants import R


def mole_to_mass(mole_frac, molwt):
    """Y_k = x_k W_k / sum(x W)."""
    m = mole_frac * molwt
    return m / torch.sum(m, dim=-1, keepdim=True)


def mass_to_mole(mass_frac, molwt):
    """x_k = (Y_k / W_k) / sum(Y/W)."""
    n = mass_frac / molwt
    return n / torch.sum(n, dim=-1, keepdim=True)


def average_molwt(mole_frac, molwt):
    """Mean molecular weight [kg/mol] from mole fractions."""
    return torch.sum(mole_frac * molwt, dim=-1)


def density(mole_frac, molwt, T, p):
    """Ideal-gas mixture mass density rho = p * Wbar / (R T) [kg/m^3]."""
    return p * average_molwt(mole_frac, molwt) / (R * T)


def pressure(rho, mole_frac, molwt, T):
    """Algebraic pressure p = rho R T / Wbar (constant-volume reactor)."""
    return rho * R * T / average_molwt(mole_frac, molwt)
