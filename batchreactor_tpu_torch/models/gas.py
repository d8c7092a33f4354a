"""CHEMKIN-II gas-phase mechanism: host parser -> GasMechanism device tensors.

Port of ``batchreactor_tpu/models/gas.py``.  The parser is host numpy code,
copied with the full CHEMKIN breadth it has (third bodies with efficiencies,
LOW/TROE/SRI falloff, explicit colliders, DUPLICATE and negative-A
duplicates, REV, PLOG, CHEB).  Everything is converted to SI at parse time:
A -> (m^3/mol)^(n-1)/s in ln domain, Ea -> J/mol.  The result is a
``GasMechanism`` of float64 torch tensors on the caller's device.
"""

import dataclasses
import re

import numpy as np
import torch

from ..device import resolve_device
from ..utils.constants import CAL_TO_J, R

#: tensor fields of :class:`GasMechanism`, in declaration order
GAS_TENSOR_FIELDS = (
    "nu_f", "nu_r", "log_A", "beta", "Ea", "eff", "has_tb", "has_falloff",
    "log_A0", "beta0", "Ea0", "has_troe", "troe", "has_sri", "sri",
    "rev_mask", "sign_A", "has_rev", "log_A_rev", "beta_rev", "Ea_rev",
    "sign_A_rev", "has_plog", "plog_lnp", "plog_logA", "plog_beta",
    "plog_Ea", "has_cheb", "cheb_coef", "cheb_invT", "cheb_logP",
    "cheb_si_ln")

#: static (non-tensor) fields of :class:`GasMechanism`
GAS_STATIC_FIELDS = ("species", "equations", "int_stoich", "any_plog",
                     "any_cheb")


@dataclasses.dataclass(frozen=True)
class GasMechanism:
    """Tensor bundle for gas-phase kinetics (R reactions, S species).

    Pre-exponentials are stored as natural logs, as in the JAX package; an
    A of 0 (unused LOW slots) is ``log A = _LOG_ZERO`` and exp of it is 0.
    """

    nu_f: torch.Tensor        # (R, S) forward (reactant) stoichiometry
    nu_r: torch.Tensor        # (R, S) reverse (product) stoichiometry
    log_A: torch.Tensor       # (R,) ln(pre-exponential, SI units)
    beta: torch.Tensor        # (R,) temperature exponent
    Ea: torch.Tensor          # (R,) activation energy, J/mol
    eff: torch.Tensor         # (R, S) third-body efficiencies (default 1)
    has_tb: torch.Tensor      # (R,) 1.0 where non-falloff +M third body
    has_falloff: torch.Tensor  # (R,) 1.0 where (+M)/(+SP) falloff
    log_A0: torch.Tensor      # (R,) ln(LOW-limit pre-exponential, SI)
    beta0: torch.Tensor       # (R,)
    Ea0: torch.Tensor         # (R,) J/mol
    has_troe: torch.Tensor    # (R,) 1.0 where TROE blending applies
    troe: torch.Tensor        # (R, 4) a, T3, T1, T2 (T2=+inf for 3-parameter)
    has_sri: torch.Tensor     # (R,) 1.0 where SRI blending applies
    sri: torch.Tensor         # (R, 5) a, b, c, d, e (d=1, e=0 for 3-param)
    rev_mask: torch.Tensor    # (R,) 1.0 where reversible
    sign_A: torch.Tensor      # (R,) +-1 (negative-A DUPLICATE rows)
    has_rev: torch.Tensor     # (R,) 1.0 where explicit REV parameters given
    log_A_rev: torch.Tensor   # (R,) ln|A_rev|, SI (reverse-order units)
    beta_rev: torch.Tensor    # (R,)
    Ea_rev: torch.Tensor      # (R,) J/mol
    sign_A_rev: torch.Tensor  # (R,) +-1
    has_plog: torch.Tensor    # (R,) 1.0 where PLOG table attached
    plog_lnp: torch.Tensor    # (R, P) ln(p/Pa) grid, +inf padded
    plog_logA: torch.Tensor   # (R, P) ln A (SI), _LOG_ZERO padded
    plog_beta: torch.Tensor   # (R, P)
    plog_Ea: torch.Tensor     # (R, P) J/mol
    has_cheb: torch.Tensor    # (R,) 1.0 where Chebyshev table attached
    cheb_coef: torch.Tensor   # (R, NT, NP) a_ij, zero padded
    cheb_invT: torch.Tensor   # (R, 2) 1/Tmin, 1/Tmax
    cheb_logP: torch.Tensor   # (R, 2) log10(Pmin/Pa), log10(Pmax/Pa)
    cheb_si_ln: torch.Tensor  # (R,) ln units factor cgs -> SI
    species: tuple
    equations: tuple
    int_stoich: bool
    any_plog: bool = False
    any_cheb: bool = False

    @property
    def n_species(self):
        return len(self.species)

    @property
    def n_reactions(self):
        return len(self.equations)

    @property
    def device(self):
        return self.nu_f.device

    @classmethod
    def from_numpy(cls, fields, device):
        """Build from a mapping holding every field: the tensor fields
        (:data:`GAS_TENSOR_FIELDS`) as numpy arrays, converted to float64
        on ``device``, and the static fields (:data:`GAS_STATIC_FIELDS`)
        as given.  The JAX package's ``GasMechanism`` converts with
        ``{f: np.asarray(getattr(gm, f)) for f in ...}``."""
        dev = torch.device(device)
        tensors = {f: torch.tensor(np.asarray(fields[f], dtype=np.float64),
                                   device=dev)
                   for f in GAS_TENSOR_FIELDS}
        return cls(**tensors,
                   species=tuple(fields["species"]),
                   equations=tuple(fields["equations"]),
                   int_stoich=bool(fields["int_stoich"]),
                   any_plog=bool(fields.get("any_plog", False)),
                   any_cheb=bool(fields.get("any_cheb", False)))

    def to(self, device):
        """The same mechanism with every tensor on ``device``."""
        dev = torch.device(device)
        if self.device == dev:
            return self
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(dev) for f in GAS_TENSOR_FIELDS})


# ln-domain encoding of A == 0; exp(_LOG_ZERO) == 0.0 exactly in f64
_LOG_ZERO = -745.0

_FLOAT = re.compile(r"^[-+]?(\d+\.?\d*|\.\d+)([EeDd][-+]?\d+)?$")
_COEF = re.compile(r"^(\d+(?:\.\d+)?)\s*(.+)$")
_PAIR = re.compile(r"([^/\s][^/]*?)\s*/\s*([-+0-9.EeDd]+)\s*/")
_FALLOFF = re.compile(r"\(\s*\+\s*([A-Za-z][\w()\-*']*)\s*\)")


def _is_number(tok):
    return bool(_FLOAT.match(tok))


def _tofloat(tok):
    return float(tok.replace("D", "E").replace("d", "e"))


class _Rxn:
    __slots__ = (
        "equation", "reactants", "products", "A", "beta", "Ea", "reversible",
        "third_body", "falloff", "collider", "eff", "low", "troe", "sri",
        "duplicate", "rev", "plog", "cheb", "tcheb", "pcheb",
    )

    def __init__(self):
        self.eff = {}
        self.low = None
        self.troe = None
        self.sri = None
        self.third_body = False
        self.falloff = False
        self.collider = None
        self.duplicate = False
        self.rev = None
        self.plog = None
        self.cheb = None
        self.tcheb = None
        self.pcheb = None


def _parse_side(side):
    """'H+2O2' -> ({'H':1.0,'O2':2.0}, has_M). Species names never contain '+'."""
    stoich = {}
    has_m = False
    for term in side.split("+"):
        term = term.strip()
        if not term:
            continue
        if term.upper() == "M":
            has_m = True
            continue
        m = _COEF.match(term)
        if m and not _is_number(term):  # '2OH' -> (2, 'OH'); avoid bare numbers
            coef, name = float(m.group(1)), m.group(2).strip()
        else:
            coef, name = 1.0, term
        name = name.upper()
        stoich[name] = stoich.get(name, 0.0) + coef
    return stoich, has_m


def _energy_factor(units):
    u = units.upper()
    if "KCAL" in u:
        return 1000.0 * CAL_TO_J
    if "KJOU" in u or "KJ/" in u:
        return 1000.0
    if "JOU" in u:
        return 1.0
    if "KELV" in u:
        return R
    return CAL_TO_J  # CHEMKIN default cal/mol


def parse_gas_mechanism(path):
    """Parse a CHEMKIN mechanism file into (elements, species, [_Rxn])."""
    with open(path) as f:
        raw = f.readlines()

    elements, species, rxns = [], [], []
    e_factor = CAL_TO_J
    section = None
    for raw_ln in raw:
        ln = raw_ln.split("!", 1)[0].rstrip()
        if not ln.strip():
            continue
        stripped = ln.strip()
        up = stripped.upper()
        if up.startswith("ELEM"):
            section = "elements"
            rest = stripped[stripped.find(" ") :].strip() if " " in stripped else ""
            elements += [t.upper() for t in rest.split()]
            continue
        if up.startswith("SPEC"):
            section = "species"
            rest = stripped[stripped.find(" ") :].strip() if " " in stripped else ""
            species += [t.upper() for t in rest.split()]
            continue
        if up.startswith("REAC") and section != "reactions":
            section = "reactions"
            e_factor = _energy_factor(up)
            continue
        if up.startswith("THERMO"):
            section = "thermo"
            continue
        if up == "END":
            section = None
            continue

        if section == "elements":
            elements += [t.upper() for t in stripped.split()]
        elif section == "species":
            species += [t.upper() for t in stripped.split()]
        elif section == "reactions":
            _parse_reaction_line(stripped, rxns, e_factor)
    return elements, species, rxns


_AUX_KEYWORDS = ("DUPLICATE", "DUP", "LOW", "TROE", "SRI", "REV", "PLOG",
                 "TCHEB", "PCHEB", "CHEB")


def _parse_reaction_line(line, rxns, e_factor):
    up = line.upper()
    if not rxns and any(up.startswith(k) for k in _AUX_KEYWORDS):
        raise ValueError(
            f"auxiliary line without a preceding reaction: {line!r}")
    if up.startswith("DUPLICATE") or up.startswith("DUP"):
        rxns[-1].duplicate = True
        return
    if up.startswith("LOW"):
        nums = [_tofloat(t) for t in re.findall(r"[-+0-9.EeDd]+", line[3:]) if _is_number(t)]
        rxns[-1].low = (nums[0], nums[1], nums[2] * e_factor)  # Ea -> J/mol here
        return
    if up.startswith("TROE"):
        nums = [_tofloat(t) for t in re.findall(r"[-+0-9.EeDd]+", line[4:]) if _is_number(t)]
        rxns[-1].troe = tuple(nums)
        return
    if up.startswith("SRI"):
        # SRI /a b c [d e]/ — Stanford Research Institute falloff blending
        # F = d T^e [a exp(-b/T) + exp(-T/c)]^X, X = 1/(1 + log10(Pr)^2);
        # 3-parameter form implies d=1, e=0 (CHEMKIN-II)
        nums = [_tofloat(t) for t in re.findall(r"[-+0-9.EeDd]+", line[3:])
                if _is_number(t)]
        if len(nums) not in (3, 5):
            raise ValueError(f"SRI needs 3 or 5 numbers: {line!r}")
        if not rxns:
            raise ValueError(f"SRI without a preceding reaction: {line!r}")
        rxns[-1].sri = tuple(nums) if len(nums) == 5 else (*nums, 1.0, 0.0)
        return
    if up.startswith("REV"):
        # REV /A beta Ea/ — explicit reverse Arrhenius (CHEMKIN-II); the
        # reverse rate comes from these parameters, not the equilibrium
        # constant.  Only meaningful on reversible reactions.
        nums = [_tofloat(t) for t in re.findall(r"[-+0-9.EeDd]+", line[3:])
                if _is_number(t)]
        if len(nums) != 3:
            raise ValueError(f"REV needs exactly 3 numbers: {line!r}")
        if not rxns or not rxns[-1].reversible:
            raise ValueError(f"REV without a preceding reversible reaction: "
                             f"{line!r}")
        rxns[-1].rev = (nums[0], nums[1], nums[2] * e_factor)
        return
    if up.startswith("PLOG"):
        # PLOG /p A beta Ea/ — one rate point at pressure p [atm]
        nums = [_tofloat(t) for t in re.findall(r"[-+0-9.EeDd]+", line[4:])
                if _is_number(t)]
        if len(nums) != 4:
            raise ValueError(f"PLOG needs exactly 4 numbers: {line!r}")
        if not rxns:
            raise ValueError(f"PLOG without a preceding reaction: {line!r}")
        if rxns[-1].plog is None:
            rxns[-1].plog = []
        rxns[-1].plog.append((nums[0], nums[1], nums[2],
                              nums[3] * e_factor))
        return
    if up.startswith("TCHEB") or up.startswith("PCHEB"):
        nums = [_tofloat(t) for t in re.findall(r"[-+0-9.EeDd]+", line[5:])
                if _is_number(t)]
        if len(nums) != 2 or not rxns:
            raise ValueError(f"malformed {line!r}")
        setattr(rxns[-1], "tcheb" if up.startswith("T") else "pcheb",
                (nums[0], nums[1]))
        return
    if up.startswith("CHEB"):
        # first CHEB line carries N M then coefficients; continuation CHEB
        # lines carry more coefficients (row-major a_ij)
        nums = [_tofloat(t) for t in re.findall(r"[-+0-9.EeDd]+", line[4:])
                if _is_number(t)]
        if not rxns:
            raise ValueError(f"CHEB without a preceding reaction: {line!r}")
        if rxns[-1].cheb is None:
            rxns[-1].cheb = []
        rxns[-1].cheb.extend(nums)
        return
    # reaction line iff it contains '=' and ends with 3 numeric tokens
    toks = line.split()
    if "=" in line and len(toks) >= 4 and all(_is_number(t) for t in toks[-3:]):
        rxn = _Rxn()
        rxn.A, rxn.beta, rxn.Ea = (_tofloat(t) for t in toks[-3:])
        rxn.Ea *= e_factor
        eq = "".join(toks[:-3])
        rxn.equation = eq
        # falloff collider: (+M) or (+SP) on either side
        fm = _FALLOFF.search(eq)
        if fm:
            rxn.falloff = True
            name = fm.group(1).upper()
            rxn.collider = None if name == "M" else name
            eq = _FALLOFF.sub("", eq)
        if "<=>" in eq:
            lhs, rhs = eq.split("<=>")
            rxn.reversible = True
        elif "=>" in eq:
            lhs, rhs = eq.split("=>")
            rxn.reversible = False
        else:
            lhs, rhs = eq.split("=")
            rxn.reversible = True
        rxn.reactants, m_l = _parse_side(lhs)
        rxn.products, m_r = _parse_side(rhs)
        if m_l != m_r:
            raise ValueError(f"unbalanced +M in {line!r}")
        rxn.third_body = m_l and not rxn.falloff
        rxns.append(rxn)
        return
    # otherwise: an efficiency line of name/value/ pairs
    pairs = _PAIR.findall(line)
    if not pairs:
        raise ValueError(f"unparseable mechanism line: {line!r}")
    for name, val in pairs:
        rxns[-1].eff[name.strip().upper()] = _tofloat(val)


def compile_gaschemistry(mech_file, device=None):
    """Compile a CHEMKIN mechanism file into a GasMechanism of float64
    tensors on ``device`` (``None`` = the GPU).  ``.species`` drives the
    state layout."""
    device = resolve_device(device)
    _, species, rxns = parse_gas_mechanism(mech_file)
    S, Rn = len(species), len(rxns)
    index = {s: k for k, s in enumerate(species)}

    nu_f = np.zeros((Rn, S))
    nu_r = np.zeros((Rn, S))
    log_A = np.zeros(Rn)
    beta = np.zeros(Rn)
    Ea = np.zeros(Rn)
    eff = np.ones((Rn, S))
    has_tb = np.zeros(Rn)
    has_falloff = np.zeros(Rn)
    log_A0 = np.full(Rn, _LOG_ZERO)
    beta0 = np.zeros(Rn)
    Ea0 = np.zeros(Rn)
    has_troe = np.zeros(Rn)
    # safe inert defaults keep F finite (and jacfwd NaN-free) on non-TROE rows
    troe = np.tile(np.array([0.6, 100.0, 1000.0, np.inf]), (Rn, 1))
    has_sri = np.zeros(Rn)
    # inert defaults: base = a*exp(-b/T) + exp(-T/c) = 1 + 1 = 2, finite
    # for any T and under jacfwd; non-SRI rows are masked to F = 1 anyway
    sri = np.tile(np.array([1.0, 0.0, np.inf, 1.0, 0.0]), (Rn, 1))
    rev_mask = np.zeros(Rn)
    sign_A = np.ones(Rn)
    has_rev = np.zeros(Rn)
    log_A_rev = np.full(Rn, _LOG_ZERO)
    beta_rev = np.zeros(Rn)
    Ea_rev = np.zeros(Rn)
    sign_A_rev = np.ones(Rn)
    P_max = max((len(r.plog) for r in rxns if r.plog), default=1)
    has_plog = np.zeros(Rn)
    cheb_dims = []
    for r in rxns:
        if r.cheb:
            # validate declared dims BEFORE sizing arrays from them: a
            # malformed/negative/huge N must raise the friendly error, not
            # IndexError or a multi-GB np.zeros
            if len(r.cheb) < 2:
                raise ValueError(f"CHEB needs N M dims: {r.equation!r}")
            N_, M_ = int(round(r.cheb[0])), int(round(r.cheb[1]))
            if not (1 <= N_ <= 16 and 1 <= M_ <= 16):
                raise ValueError(
                    f"CHEB degree {N_}x{M_} outside the supported 1..16: "
                    f"{r.equation!r}")
            cheb_dims.append((N_, M_))
    NT_max = max((d[0] for d in cheb_dims), default=1)
    NP_max = max((d[1] for d in cheb_dims), default=1)
    has_cheb = np.zeros(Rn)
    cheb_coef = np.zeros((Rn, NT_max, NP_max))
    cheb_invT = np.tile(np.array([1 / 300.0, 1 / 2500.0]), (Rn, 1))
    cheb_logP = np.tile(np.array([0.0, 1.0]), (Rn, 1))
    cheb_si_ln = np.zeros(Rn)
    # pad: +inf pressures never selected by the interval search; padded
    # Arrhenius slots are _LOG_ZERO (never read — interp index is clamped)
    plog_lnp = np.full((Rn, P_max), np.inf)
    plog_logA = np.full((Rn, P_max), _LOG_ZERO)
    plog_beta = np.zeros((Rn, P_max))
    plog_Ea = np.zeros((Rn, P_max))
    equations = []

    for i, rxn in enumerate(rxns):
        equations.append(rxn.equation)
        for name, coef in rxn.reactants.items():
            if name not in index:
                raise KeyError(f"unknown species {name!r} in {rxn.equation}")
            nu_f[i, index[name]] += coef
        for name, coef in rxn.products.items():
            if name not in index:
                raise KeyError(f"unknown species {name!r} in {rxn.equation}")
            nu_r[i, index[name]] += coef
        order = nu_f[i].sum()
        # ln-domain storage carries |A|; the sign travels in a linear-domain
        # side channel.  CHEMKIN-II semantics: a negative A is only valid on
        # a DUPLICATE row (its partner supplies the dominant positive rate);
        # A == 0 and negative falloff limits stay loud errors.
        if rxn.A == 0 or (rxn.low is not None and rxn.low[0] <= 0):
            raise ValueError(
                f"non-positive pre-exponential in {rxn.equation!r} "
                f"(A={rxn.A}, LOW={rxn.low}); not representable in ln domain"
            )
        if rxn.A < 0:
            if not rxn.duplicate:
                raise ValueError(
                    f"negative pre-exponential A={rxn.A} in {rxn.equation!r} "
                    f"requires a DUPLICATE marker (CHEMKIN-II)")
            if rxn.falloff:
                raise ValueError(
                    f"negative-A falloff reaction unsupported: {rxn.equation!r}")
            sign_A[i] = -1.0
        # cgs -> SI in ln domain: rate_SI = A_cgs (1e-6)^(order_tot - 1) prod c_SI^nu
        # (order_tot counts the +M collider for plain third-body reactions;
        #  k_inf of a falloff reaction carries no collider concentration)
        log_A[i] = np.log(abs(rxn.A)) + (order + (1 if rxn.third_body else 0) - 1) * np.log(1e-6)
        beta[i] = rxn.beta
        Ea[i] = rxn.Ea
        rev_mask[i] = 1.0 if rxn.reversible else 0.0
        if rxn.rev is not None:
            A_r, b_r, ea_r = rxn.rev
            if A_r == 0:
                raise ValueError(f"REV with A=0 in {rxn.equation!r}")
            if rxn.falloff:
                raise NotImplementedError(
                    f"REV on a falloff reaction unsupported: {rxn.equation!r}")
            if A_r < 0 and not rxn.duplicate:
                raise ValueError(
                    f"negative REV A={A_r} in {rxn.equation!r} requires a "
                    f"DUPLICATE marker (CHEMKIN-II)")
            has_rev[i] = 1.0
            sign_A_rev[i] = -1.0 if A_r < 0 else 1.0
            # reverse-direction order: products are the reactants of the
            # reverse step (the +M collider counts exactly as forward)
            order_r = nu_r[i].sum()
            log_A_rev[i] = np.log(abs(A_r)) + (
                order_r + (1 if rxn.third_body else 0) - 1) * np.log(1e-6)
            beta_rev[i] = b_r
            Ea_rev[i] = ea_r
        if rxn.plog is not None:
            if rxn.falloff or rxn.third_body:
                raise ValueError(
                    f"PLOG cannot combine with falloff/third-body: "
                    f"{rxn.equation!r}")
            if rxn.rev is not None:
                raise NotImplementedError(
                    f"PLOG with REV unsupported: {rxn.equation!r}")
            if len(rxn.plog) < 2:
                raise ValueError(
                    f"PLOG needs >= 2 pressure points: {rxn.equation!r}")
            pts = sorted(rxn.plog, key=lambda q: q[0])
            ps = [q[0] for q in pts]
            if len(set(ps)) != len(ps):
                raise NotImplementedError(
                    f"duplicate PLOG pressure points (summed-rate form) "
                    f"unsupported: {rxn.equation!r}")
            if any(q[1] <= 0 for q in pts):
                raise ValueError(
                    f"non-positive PLOG pre-exponential: {rxn.equation!r}")
            has_plog[i] = 1.0
            for j, (p_atm, A_j, b_j, ea_j) in enumerate(pts):
                plog_lnp[i, j] = np.log(p_atm * 101325.0)  # atm -> ln(Pa)
                plog_logA[i, j] = np.log(A_j) + (order - 1) * np.log(1e-6)
                plog_beta[i, j] = b_j
                plog_Ea[i, j] = ea_j
        has_tb[i] = 1.0 if rxn.third_body else 0.0
        if rxn.cheb is not None:
            # Chebyshev reactions: the (+M) is pure notation — k(T,p)
            # carries the whole pressure dependence, no collider efficiencies
            if (rxn.third_body or rxn.low is not None
                    or rxn.troe is not None or rxn.sri is not None):
                raise ValueError(f"CHEB cannot combine with +M/LOW/TROE/SRI: "
                                 f"{rxn.equation!r}")
            if rxn.collider is not None or rxn.eff:
                # a (+SP) collider or efficiency lines would silently change
                # the meaning: CHEB k(T,p) is defined on TOTAL pressure
                raise ValueError(
                    f"CHEB with a specific collider/efficiencies is "
                    f"unsupported (k(T,p) uses total pressure): "
                    f"{rxn.equation!r}")
            if rxn.plog is not None:
                raise ValueError(
                    f"CHEB and PLOG on one reaction: {rxn.equation!r}")
            if rxn.rev is not None:
                raise NotImplementedError(
                    f"CHEB with REV unsupported: {rxn.equation!r}")
            # dims were validated (1..16) in the sizing pass above
            nums = rxn.cheb
            N, M = int(round(nums[0])), int(round(nums[1]))
            coefs = nums[2:]
            if len(coefs) != N * M:
                raise ValueError(
                    f"CHEB expects {N}x{M} coefficients, got {len(coefs)}: "
                    f"{rxn.equation!r}")
            has_cheb[i] = 1.0
            cheb_coef[i, :N, :M] = np.asarray(coefs).reshape(N, M)
            Tmin, Tmax = rxn.tcheb or (300.0, 2500.0)
            Pmin, Pmax = rxn.pcheb or (0.001, 100.0)  # atm (CHEMKIN default)
            if not (0 < Tmin < Tmax) or not (0 < Pmin < Pmax):
                raise ValueError(f"bad TCHEB/PCHEB limits: {rxn.equation!r}")
            cheb_invT[i] = (1.0 / Tmin, 1.0 / Tmax)
            cheb_logP[i] = (np.log10(Pmin * 101325.0),
                            np.log10(Pmax * 101325.0))
            cheb_si_ln[i] = (order - 1) * np.log(1e-6)
        if rxn.third_body or (rxn.falloff and rxn.collider is None
                              and rxn.cheb is None):
            for name, val in rxn.eff.items():
                if name not in index:
                    raise KeyError(f"unknown collider {name!r} in {rxn.equation}")
                eff[i, index[name]] = val
        if rxn.falloff and rxn.cheb is None:
            has_falloff[i] = 1.0
            if rxn.collider is not None:
                eff[i, :] = 0.0
                eff[i, index[rxn.collider]] = 1.0
            if rxn.low is None:
                raise ValueError(f"falloff reaction missing LOW: {rxn.equation}")
            # k0 carries one extra collider concentration -> exponent `order`
            log_A0[i] = np.log(rxn.low[0]) + order * np.log(1e-6)
            beta0[i] = rxn.low[1]
            Ea0[i] = rxn.low[2]  # already J/mol (converted at parse)
            if rxn.troe is not None and rxn.sri is not None:
                raise ValueError(
                    f"TROE and SRI are mutually exclusive: {rxn.equation!r}")
            if rxn.troe is not None:
                has_troe[i] = 1.0
                t = rxn.troe
                troe[i, 0] = t[0]
                troe[i, 1] = t[1]
                troe[i, 2] = t[2]
                troe[i, 3] = t[3] if len(t) > 3 else np.inf
            if rxn.sri is not None:
                if rxn.sri[2] <= 0 or rxn.sri[3] <= 0:
                    raise ValueError(
                        f"SRI needs c > 0 and d > 0: {rxn.equation!r}")
                has_sri[i] = 1.0
                sri[i, :] = rxn.sri
        elif rxn.sri is not None:
            raise ValueError(
                f"SRI on a non-falloff reaction: {rxn.equation!r}")

    int_stoich = bool(
        np.all(nu_f == np.round(nu_f)) and np.all(nu_r == np.round(nu_r))
        and nu_f.max(initial=0) <= 3 and nu_r.max(initial=0) <= 3
    )
    return GasMechanism.from_numpy(
        {"nu_f": nu_f, "nu_r": nu_r, "log_A": log_A, "beta": beta, "Ea": Ea,
         "eff": eff, "has_tb": has_tb, "has_falloff": has_falloff,
         "log_A0": log_A0, "beta0": beta0, "Ea0": Ea0, "has_troe": has_troe,
         "troe": troe, "has_sri": has_sri, "sri": sri, "rev_mask": rev_mask,
         "sign_A": sign_A, "has_rev": has_rev, "log_A_rev": log_A_rev,
         "beta_rev": beta_rev, "Ea_rev": Ea_rev, "sign_A_rev": sign_A_rev,
         "has_plog": has_plog, "plog_lnp": plog_lnp, "plog_logA": plog_logA,
         "plog_beta": plog_beta, "plog_Ea": plog_Ea, "has_cheb": has_cheb,
         "cheb_coef": cheb_coef, "cheb_invT": cheb_invT,
         "cheb_logP": cheb_logP, "cheb_si_ln": cheb_si_ln,
         "species": tuple(species), "equations": tuple(equations),
         "int_stoich": int_stoich, "any_plog": bool(has_plog.any()),
         "any_cheb": bool(has_cheb.any())},
        device)
