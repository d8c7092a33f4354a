"""Mean-field surface (catalytic) mechanism: XML parser -> SurfaceMechanism.

Port of ``batchreactor_tpu/models/surface.py``.  The parser is host numpy
code, copied with every format feature it has (``<stick>`` with 1 or 3
numbers, ``<mwc>``, ``<order>``, ``<coverage>``, the energy ``unit``, the
site density unit, and the loud errors on malformed XML); the result is a
``SurfaceMechanism`` of float64 torch tensors on the caller's device.

Rate-law conventions (the JAX package pinned them against the reference's
golden trajectory):
  * Arrhenius reactions: rate = k * prod c_gas^nu * prod (Gamma theta/sigma)^nu
    with c_gas in mol/cm^3, surface concentrations in mol/cm^2, A in cgs,
    Ea in the file's unit.
  * Sticking reactions: rate = (s0/(1-s0/2) if MWC else s0) *
    sqrt(R T/(2 pi M)) * c_gas * prod theta^m — coverages enter directly.
  * Coverage dependence: Ea_eff = Ea + sum_k eps_k theta_k.
"""

import dataclasses
import re
import xml.etree.ElementTree as ET

import numpy as np
import torch

from ..device import resolve_device

#: tensor fields of :class:`SurfaceMechanism`, in declaration order
SURFACE_TENSOR_FIELDS = (
    "nu_f_gas", "nu_r_gas", "nu_f_surf", "nu_r_surf", "expo_gas",
    "expo_surf", "log_A", "beta", "Ea", "cov_eps", "stick", "stick_s0",
    "stick_molwt", "mwc", "site_density", "site_coordination", "ini_covg")

#: static (non-tensor) fields of :class:`SurfaceMechanism`
SURFACE_STATIC_FIELDS = ("species", "gas_species", "equations", "int_expo")


@dataclasses.dataclass(frozen=True)
class SurfaceMechanism:
    """Tensor bundle for surface kinetics.

    R reactions; Ss surface species (``species``, order = mechanism file);
    Sg gas species (``gas_species``, order = the gas-phase state layout).
    """

    nu_f_gas: torch.Tensor    # (R, Sg) gas reactant stoichiometry
    nu_r_gas: torch.Tensor    # (R, Sg) gas product stoichiometry
    nu_f_surf: torch.Tensor   # (R, Ss)
    nu_r_surf: torch.Tensor   # (R, Ss)
    expo_gas: torch.Tensor    # (R, Sg) rate-law exponents (default nu_f_gas)
    expo_surf: torch.Tensor   # (R, Ss) rate-law exponents (default
                              #         nu_f_surf; <order> overrides)
    log_A: torch.Tensor       # (R,) ln A, cgs units (1/s, cm2/mol/s, ...)
    beta: torch.Tensor        # (R,)
    Ea: torch.Tensor          # (R,) J/mol
    cov_eps: torch.Tensor     # (R, Ss) coverage-dependent Ea slope, J/mol
    stick: torch.Tensor       # (R,) 1.0 for sticking reactions
    stick_s0: torch.Tensor    # (R,) sticking coefficient
    stick_molwt: torch.Tensor  # (R,) molwt of the sticking gas species, g/mol
    mwc: torch.Tensor         # (R,) 1.0 where Motz-Wise correction applies
    site_density: torch.Tensor       # () Gamma, mol/cm^2 (as in the file)
    site_coordination: torch.Tensor  # (Ss,) sigma
    ini_covg: torch.Tensor           # (Ss,) initial coverages
    species: tuple            # surface species names (upper case)
    gas_species: tuple        # gas species names this mechanism couples to
    equations: tuple
    int_expo: bool            # all rate-law exponents in {0,1,2,3}

    @property
    def n_reactions(self):
        return len(self.equations)

    @property
    def n_surface_species(self):
        return len(self.species)

    @property
    def device(self):
        return self.nu_f_gas.device

    @classmethod
    def from_numpy(cls, fields, device):
        """Build from a mapping holding every field: the tensor fields
        (:data:`SURFACE_TENSOR_FIELDS`) as numpy arrays, converted to
        float64 on ``device``, and the static fields as given.  The JAX
        package's ``SurfaceMechanism`` converts with
        ``{f: np.asarray(getattr(sm, f)) for f in ...}``."""
        dev = torch.device(device)
        tensors = {f: torch.tensor(np.asarray(fields[f], dtype=np.float64),
                                   device=dev)
                   for f in SURFACE_TENSOR_FIELDS}
        return cls(**tensors,
                   species=tuple(fields["species"]),
                   gas_species=tuple(fields["gas_species"]),
                   equations=tuple(fields["equations"]),
                   int_expo=bool(fields["int_expo"]))

    def to(self, device):
        """The same mechanism with every tensor on ``device``."""
        dev = torch.device(device)
        if self.device == dev:
            return self
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(dev)
                     for f in SURFACE_TENSOR_FIELDS})


def _parse_pairs(text):
    """'ch4(ni)=1,co(ni)=1.0' -> {'CH4(NI)': 1.0, 'CO(NI)': 1.0}."""
    out = {}
    if not text:
        return out
    for part in re.split(r"[,\s]+", text.strip()):
        if not part:
            continue
        name, val = part.split("=")
        out[name.strip().upper()] = float(val)
    return out


def _parse_eq(eq):
    """'h2 + (ni) + (ni) => h(ni) + h(ni)' -> (reactants, products) dicts."""
    lhs, rhs = eq.split("=>")

    def side(s):
        d = {}
        for term in s.split("+"):
            term = term.strip()
            if not term:
                continue
            d[term.upper()] = d.get(term.upper(), 0.0) + 1.0
        return d

    return side(lhs), side(rhs)


def _energy_factor(unit, mech_file):
    unit = unit.strip().lower()
    if unit in ("kj/mol", "kj/mole"):
        return 1e3
    if unit in ("j/mol", "j/mole"):
        return 1.0
    if unit in ("cal/mol", "cal/mole"):
        return 4.184
    if unit in ("kcal/mol", "kcal/mole"):
        return 4184.0
    raise ValueError(f"unknown energy unit {unit!r} in {mech_file}")


def compile_mech(mech_file, thermo_obj, gasphase, device=None):
    """Compile a surface-chemistry XML file against a gas-phase species list
    into a :class:`SurfaceMechanism` on ``device`` (``None`` = the GPU).

    ``thermo_obj`` supplies gas molecular weights for the sticking fluxes
    and must be laid out in ``gasphase`` order; ``gasphase`` fixes the gas
    state layout the mechanism couples to."""
    device = resolve_device(device)
    root = ET.parse(mech_file).getroot()
    e_fac = _energy_factor(root.get("unit") or "kJ/mol", mech_file)

    species = [s.upper() for s in root.findtext("species", "").split()]
    if not species:
        raise ValueError(f"no <species> in {mech_file}")
    s_index = {s: k for k, s in enumerate(species)}
    gasphase_u = [g.upper() for g in gasphase]
    g_index = {g: k for k, g in enumerate(gasphase_u)}
    # molwt is indexed by gasphase position: the thermo table must be laid
    # out in exactly that order or sticking fluxes pick the wrong mass
    if tuple(gasphase_u) != tuple(thermo_obj.species):
        raise ValueError(
            "gasphase list and thermo_obj.species must match in order: "
            f"{gasphase_u[:5]}... vs {list(thermo_obj.species[:5])}..."
        )
    molwt = thermo_obj.molwt.cpu().numpy() * 1e3  # g/mol for cgs fluxes

    site = root.find("site")
    if site is None:
        raise ValueError(f"no <site> in {mech_file}")
    coord_map = _parse_pairs(site.findtext("coordination", ""))
    density_el = site.find("density")
    if density_el is None or not (density_el.text or "").strip():
        raise ValueError(f"no <density> inside <site> in {mech_file} "
                         f"(site density, mol/cm2 — cf. the reference "
                         f"fixture ch4ni.xml:6)")
    site_density = float(density_el.text)
    d_unit = (density_el.get("unit") or "mol/cm2").strip().lower()
    if d_unit == "mol/m2":
        site_density *= 1e-4  # stored in mol/cm^2 like the reference files
    elif d_unit != "mol/cm2":
        raise ValueError(f"unknown site density unit {d_unit!r}")
    ini_map = _parse_pairs(site.findtext("initial", ""))

    sigma = np.ones(len(species))
    for name, val in coord_map.items():
        if name not in s_index:
            raise KeyError(f"coordination for unknown species {name!r}")
        sigma[s_index[name]] = val
    covg0 = np.zeros(len(species))
    for name, val in ini_map.items():
        if name not in s_index:
            raise KeyError(f"initial coverage for unknown species {name!r}")
        covg0[s_index[name]] = val

    # collect reactions: <stick><rxn> then <arrhenius><rxn>, id-keyed
    rxn_entries = []  # (id, is_stick, equation, params)
    for block, is_stick in ((root.find("stick"), True),
                            (root.find("arrhenius"), False)):
        if block is None:
            continue
        for el in block.findall("rxn"):
            rid = int(el.get("id"))
            if (el.text or "").count("@") != 1:
                raise ValueError(
                    f"reaction {rid} in {mech_file}: expected exactly one "
                    f"'@' separating 'equation @ rate-params', got "
                    f"{el.text!r}")
            eq_part, rate_part = el.text.split("@")
            nums = rate_part.split()
            need = 1 if is_stick else 3
            if len(nums) < need:
                raise ValueError(
                    f"reaction {rid} in {mech_file}: expected at least "
                    f"{need} rate parameter(s) after '@' "
                    f"({'s0 [beta Ea]' if is_stick else 'A beta Ea'}), "
                    f"got {rate_part.strip()!r}")
            if is_stick:
                # stick entries may carry 1 (s0) or 3 (s0 beta Ea) numbers
                s0 = float(nums[0])
                b = float(nums[1]) if len(nums) > 1 else 0.0
                ea = float(nums[2]) * e_fac if len(nums) > 2 else 0.0
                rxn_entries.append((rid, True, eq_part.strip(), (s0, b, ea)))
            else:
                A, b = float(nums[0]), float(nums[1])
                ea = float(nums[2]) * e_fac
                rxn_entries.append((rid, False, eq_part.strip(), (A, b, ea)))
    rxn_entries.sort(key=lambda r: r[0])
    ids = [rid for rid, *_rest in rxn_entries]
    if len(set(ids)) != len(ids):
        dupes = sorted({i for i in ids if ids.count(i) > 1})
        raise ValueError(f"duplicate reaction ids in {mech_file}: {dupes}")
    id_to_row = {rid: i for i, (rid, *_rest) in enumerate(rxn_entries)}

    Rn, Ss, Sg = len(rxn_entries), len(species), len(gasphase_u)
    nu_f_gas = np.zeros((Rn, Sg))
    nu_r_gas = np.zeros((Rn, Sg))
    nu_f_surf = np.zeros((Rn, Ss))
    nu_r_surf = np.zeros((Rn, Ss))
    log_A = np.zeros(Rn)
    beta = np.zeros(Rn)
    Ea = np.zeros(Rn)
    stick = np.zeros(Rn)
    stick_s0 = np.zeros(Rn)
    stick_molwt = np.ones(Rn)
    equations = []

    for i, (rid, is_stick, eq, params) in enumerate(rxn_entries):
        equations.append(eq)
        reac, prod = _parse_eq(eq)
        gas_reactants = []
        for table, fwd in ((reac, True), (prod, False)):
            for name, coef in table.items():
                if name in s_index:
                    (nu_f_surf if fwd else nu_r_surf)[i, s_index[name]] += coef
                elif name in g_index:
                    (nu_f_gas if fwd else nu_r_gas)[i, g_index[name]] += coef
                    if fwd:
                        gas_reactants.append((name, coef))
                else:
                    raise KeyError(
                        f"species {name!r} in reaction {rid} is neither a "
                        f"surface species nor in the gasphase list"
                    )
        if is_stick:
            s0, b, ea = params
            if not (0.0 < s0 <= 1.0):
                raise ValueError(
                    f"sticking coefficient {s0} out of (0,1] in rxn {rid}")
            if len(gas_reactants) != 1 or gas_reactants[0][1] != 1.0:
                raise ValueError(
                    f"stick reaction {rid} must have exactly one gas reactant")
            stick[i] = 1.0
            stick_s0[i] = s0
            beta[i] = b
            Ea[i] = ea
            stick_molwt[i] = molwt[g_index[gas_reactants[0][0]]]
            log_A[i] = 0.0  # unused on stick rows
        else:
            A, b, ea = params
            if A <= 0:
                raise ValueError(f"non-positive A in surface reaction {rid}")
            log_A[i] = np.log(A)
            beta[i] = b
            Ea[i] = ea

    # coverage-dependent activation energies:
    # <coverage id="12 20 21">co(ni)=-50</coverage>
    cov_eps = np.zeros((Rn, Ss))
    for el in root.findall("coverage"):
        ids = [int(t) for t in el.get("id", "").split()]
        for name, val in _parse_pairs(el.text).items():
            if name not in s_index:
                raise KeyError(f"coverage tag for unknown species {name!r}")
            for rid in ids:
                cov_eps[id_to_row[rid], s_index[name]] += val * e_fac

    # rate-law exponent overrides: <order id="23">co(ni)=2</order>
    expo_gas = nu_f_gas.copy()
    expo_surf = nu_f_surf.copy()
    for el in root.findall("order"):
        ids = [int(t) for t in el.get("id", "").split()]
        for name, val in _parse_pairs(el.text).items():
            for rid in ids:
                if name in s_index:
                    expo_surf[id_to_row[rid], s_index[name]] = val
                elif name in g_index:
                    expo_gas[id_to_row[rid], g_index[name]] = val
                else:
                    raise KeyError(f"order tag for unknown species {name!r}")

    # Motz-Wise correction: <mwc>3 4</mwc> lists stick reaction ids
    mwc = np.zeros(Rn)
    mwc_el = root.find("mwc")
    if mwc_el is not None and mwc_el.text:
        for rid in (int(t) for t in mwc_el.text.split()):
            mwc[id_to_row[rid]] = 1.0

    def small_int(e):
        return np.all((e >= 0) & (e <= 3) & (e == np.round(e)))

    return SurfaceMechanism.from_numpy(
        {"nu_f_gas": nu_f_gas, "nu_r_gas": nu_r_gas, "nu_f_surf": nu_f_surf,
         "nu_r_surf": nu_r_surf, "expo_gas": expo_gas,
         "expo_surf": expo_surf, "log_A": log_A, "beta": beta, "Ea": Ea,
         "cov_eps": cov_eps, "stick": stick, "stick_s0": stick_s0,
         "stick_molwt": stick_molwt, "mwc": mwc,
         "site_density": site_density, "site_coordination": sigma,
         "ini_covg": covg0, "species": tuple(species),
         "gas_species": tuple(gasphase_u), "equations": tuple(equations),
         "int_expo": bool(small_int(expo_gas) and small_int(expo_surf))},
        device)
