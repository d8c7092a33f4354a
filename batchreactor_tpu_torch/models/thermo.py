"""NASA-7 thermodynamic database: host-side parser -> device coefficient tensors.

Port of ``batchreactor_tpu/models/thermo.py``.  The CHEMKIN-II fixed-column
parser is host numpy code, copied as it is; the result is a ``ThermoTable``
of float64 torch tensors on the caller's device.
"""

import dataclasses
import re

import numpy as np
import torch

from ..device import resolve_device
from ..obs.recorder import spanned
from ..utils.constants import ATOMIC_MASS

#: tensor fields of :class:`ThermoTable`, in declaration order
THERMO_TENSOR_FIELDS = ("coeffs", "T_low", "T_mid", "T_high", "molwt")


@dataclasses.dataclass(frozen=True)
class ThermoTable:
    """NASA-7 coefficients for an ordered species list.

    coeffs: (S, 2, 7) — [:, 0] low-T range [T_low, T_mid], [:, 1] high-T range.
    T_low/T_mid/T_high: (S,).  molwt: (S,) kg/mol.  species: tuple of names.
    composition: tuple (per species) of ((element, count), ...) pairs.
    """

    coeffs: torch.Tensor
    T_low: torch.Tensor
    T_mid: torch.Tensor
    T_high: torch.Tensor
    molwt: torch.Tensor
    species: tuple
    composition: tuple

    @property
    def n_species(self):
        return len(self.species)

    @property
    def device(self):
        return self.coeffs.device

    @classmethod
    def from_numpy(cls, fields, device):
        """Build from a mapping holding every field: the tensor fields as
        numpy arrays (float64 on ``device``), ``species`` and
        ``composition`` as given.  The JAX package's ``ThermoTable``
        converts with ``{f: np.asarray(getattr(t, f)) for f in ...}``."""
        dev = torch.device(device)
        tensors = {f: torch.tensor(np.asarray(fields[f], dtype=np.float64),
                                   device=dev)
                   for f in THERMO_TENSOR_FIELDS}
        return cls(**tensors, species=tuple(fields["species"]),
                   composition=tuple(tuple(tuple(p) for p in c)
                                     for c in fields["composition"]))

    def to(self, device):
        """The same table with every tensor on ``device``."""
        dev = torch.device(device)
        if self.device == dev:
            return self
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(dev)
                     for f in THERMO_TENSOR_FIELDS})


_NUM = re.compile(r"[-+]?\d*\.?\d+(?:[EeDd][-+]?\d+)?")


def _parse_float(s, default=None):
    s = s.strip()
    if not s:
        return default
    return float(s.replace("D", "E").replace("d", "e"))


def _parse_elements(field):
    """Parse the 4 (or 5) fixed-width element/count groups of a NASA-7 header."""
    comp = {}
    for i in range(0, len(field), 5):
        group = field[i : i + 5]
        sym = group[:2].strip().upper()
        if not sym or sym == "0":
            continue
        cnt = _parse_float(group[2:], 0.0)
        if cnt:
            comp[sym] = comp.get(sym, 0.0) + cnt
    return comp


def parse_thermo_entries(path):
    """Parse every species entry in a CHEMKIN THERMO file.

    Returns dict: NAME(upper) -> (composition dict, Tlow, Tmid, Thigh,
    coeffs_low(7,), coeffs_high(7,)).
    """
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]

    # global default temperature ranges (line after THERMO header)
    global_T = (300.0, 1000.0, 5000.0)
    i = 0
    n = len(lines)
    entries = {}
    while i < n:
        ln = lines[i]
        stripped = ln.strip()
        up = stripped.upper()
        if up.startswith("THERMO"):
            i += 1
            if i < n:
                nums = _NUM.findall(lines[i])
                if len(nums) >= 3:
                    global_T = tuple(float(x) for x in nums[:3])
                    i += 1
            continue
        if not stripped or stripped.startswith("!") or up.startswith("END"):
            i += 1
            continue
        # species header line: card number 1 in column 80
        if len(ln) >= 80 and ln[79] == "1" or (ln.rstrip() and ln.rstrip()[-1] == "1" and len(ln.rstrip()) >= 70):
            name = ln[:18].split()[0].upper()
            # 4 element groups in cols 25-44 plus the optional 5th in 74-78
            comp = _parse_elements(ln[24:44])
            for sym, cnt in _parse_elements(ln[73:78]).items():
                comp[sym] = comp.get(sym, 0.0) + cnt
            Tlo = _parse_float(ln[45:55], global_T[0])
            Thi = _parse_float(ln[55:65], global_T[2])
            Tmid = _parse_float(ln[65:73], global_T[1])
            # three coefficient cards: 5 + 5 + 4 numbers of width 15
            nums = []
            for card in lines[i + 1 : i + 4]:
                for k in range(0, 75, 15):
                    v = _parse_float(card[k : k + 15])
                    if v is not None:
                        nums.append(v)
            if len(nums) < 14:
                raise ValueError(f"thermo entry {name}: {len(nums)} coefficients")
            c_high = np.array(nums[:7])
            c_low = np.array(nums[7:14])
            entries[name] = (comp, Tlo, Tmid, Thi, c_low, c_high)
            i += 4
            continue
        i += 1
    return entries


def molecular_weight(composition):
    """kg/mol from an element->count dict."""
    w = 0.0
    for sym, cnt in composition.items():
        if sym not in ATOMIC_MASS:
            raise KeyError(f"unknown element {sym!r}")
        w += ATOMIC_MASS[sym] * cnt
    return w * 1e-3


@spanned("parse", what="thermo")
def create_thermo(species, therm_file, device=None):
    """Build a ThermoTable for an ordered species list (case-insensitive
    match) on ``device`` (``None`` = the GPU)."""
    device = resolve_device(device)
    entries = parse_thermo_entries(therm_file)
    S = len(species)
    coeffs = np.zeros((S, 2, 7))
    T_low = np.zeros(S)
    T_mid = np.zeros(S)
    T_high = np.zeros(S)
    molwt = np.zeros(S)
    comps = []
    for k, name in enumerate(species):
        key = name.upper()
        if key not in entries:
            raise KeyError(f"species {name!r} not found in {therm_file}")
        comp, tlo, tmid, thi, c_low, c_high = entries[key]
        coeffs[k, 0] = c_low
        coeffs[k, 1] = c_high
        T_low[k], T_mid[k], T_high[k] = tlo, tmid, thi
        molwt[k] = molecular_weight(comp)
        comps.append(comp)
    return ThermoTable.from_numpy(
        {"coeffs": coeffs, "T_low": T_low, "T_mid": T_mid, "T_high": T_high,
         "molwt": molwt, "species": tuple(s.upper() for s in species),
         "composition": tuple(tuple(sorted(c.items())) for c in comps)},
        device)


def element_matrix(table, elements=None):
    """(elements, (E, S) element-count matrix) from ``table.composition``,
    for conservation tests (``batchreactor_tpu/models/thermo.py::
    element_matrix``); host numpy, whatever the table's device."""
    comps = [dict(c) for c in table.composition]
    if elements is None:
        elements = sorted({e for c in comps for e in c})
    mat = np.zeros((len(elements), len(comps)))
    for k, comp in enumerate(comps):
        for e, cnt in comp.items():
            mat[elements.index(e), k] = cnt
    return elements, mat
