"""Batch-reactor XML configuration parsing (host side, stdlib xml.etree).

Port of ``batchreactor_tpu/io/config.py``: the reference's ``<batch>``
format with tags ``gasphase, molefractions|massfractions, T, p, Asv, time,
gas_mech, surface_mech``.
"""

import dataclasses
import os
import xml.etree.ElementTree as ET

import numpy as np
import torch

from ..device import resolve_device
from ..models.gas import GasMechanism, compile_gaschemistry
from ..models.surface import SurfaceMechanism, compile_mech
from ..models.thermo import ThermoTable, create_thermo
from ..utils.composition import mass_to_mole


@dataclasses.dataclass(frozen=True)
class InputData:
    """Parsed run configuration with the mechanism compiled to tensors."""

    T: float                  # K (isothermal — constant through the run)
    p: float                  # Pa (initial; recomputed algebraically after)
    Asv: float                # surface-area-to-volume ratio, 1/m
    tf: float                 # integration horizon, s
    species: tuple            # gas-phase species names (state layout order)
    mole_fracs: np.ndarray    # (S,) initial gas mole fractions
    thermo: ThermoTable
    gmd: GasMechanism | None
    smd: SurfaceMechanism | None


def parse_composition_text(text, species):
    """``"CH4=0.25,O2=0.5,N2=0.25"`` -> zero-filled (S,) fraction vector.

    Missing species get 0; unknown species are an error."""
    index = {s.upper(): k for k, s in enumerate(species)}
    fracs = np.zeros(len(species))
    for item in text.replace("\n", ",").split(","):
        item = item.strip()
        if not item:
            continue
        name, _, val = item.partition("=")
        key = name.strip().upper()
        if key not in index:
            raise KeyError(
                f"composition species {name.strip()!r} not in the gas-phase "
                f"species list"
            )
        fracs[index[key]] = float(val)
    return fracs


def input_data(xml_file, lib_dir, chem, device=None):
    """Parse a ``batch.xml`` + mechanism library into an InputData with the
    mechanisms and thermo tensors on ``device`` (``None`` = the GPU).

    Species order comes from the gas mechanism when ``chem.gaschem``, else
    from the ``<gasphase>`` tag; thermo loads from ``lib_dir/therm.dat``;
    ``<massfractions>`` is accepted in place of ``<molefractions>``;
    ``chem.surfchem`` compiles ``<surface_mech>`` against the gas species
    list."""
    device = resolve_device(device)
    root = ET.parse(xml_file).getroot()
    if root.tag != "batch":
        raise ValueError(f"expected <batch> root in {xml_file}, got <{root.tag}>")

    def text(tag):
        el = root.find(tag)
        return None if el is None or el.text is None else el.text.strip()

    def value(tag, default=None):
        t = text(tag)
        if t is None:
            if default is None:
                raise KeyError(f"missing required tag <{tag}> in {xml_file}")
            return default
        return float(t)

    gmd = None
    if chem.gaschem:
        mech = text("gas_mech")
        if mech is None:
            raise KeyError(f"gaschem run needs <gas_mech> in {xml_file}")
        gmd = compile_gaschemistry(os.path.join(lib_dir, mech), device=device)
        species = gmd.species
    else:
        gp = text("gasphase")
        if gp is None:
            raise KeyError(f"non-gaschem run needs <gasphase> in {xml_file}")
        species = tuple(s.upper() for s in gp.split())
    thermo = create_thermo(species, os.path.join(lib_dir, "therm.dat"),
                           device=device)

    comp_text = text("molefractions")
    if comp_text is not None:
        mole_fracs = parse_composition_text(comp_text, species)
    else:
        comp_text = text("massfractions")
        if comp_text is None:
            raise KeyError(
                f"need <molefractions> or <massfractions> in {xml_file}"
            )
        mass = parse_composition_text(comp_text, species)
        mole_fracs = mass_to_mole(
            torch.tensor(mass, device=device), thermo.molwt).cpu().numpy()

    smd = None
    if chem.surfchem:
        mech = text("surface_mech")
        if mech is None:
            raise KeyError(f"surfchem run needs <surface_mech> in {xml_file}")
        smd = compile_mech(os.path.join(lib_dir, mech), thermo, species,
                           device=device)

    return InputData(
        T=value("T"),
        p=value("p"),
        # missing <Asv> defaults to 1, as in the JAX package
        Asv=value("Asv", default=1.0),
        tf=value("time"),
        species=species,
        mole_fracs=mole_fracs,
        thermo=thermo,
        gmd=gmd,
        smd=smd,
    )
