"""The plain reference's chemistry: its own parsers of the mechanism files
and its own rate laws, in NumPy.

Written for the benchmark from the file formats and the published rate
laws, and importing nothing of the program, so that a change to the
program cannot move the yardstick.  It covers what the benchmark's
configurations use:

* CHEMKIN-II gas mechanisms: Arrhenius rows, ``+M`` third bodies with
  efficiencies, ``(+M)`` falloff with ``LOW`` and the 3- or 4-parameter
  ``TROE`` blending (Lindemann without it), ``DUPLICATE``; reverse rates
  from equilibrium constants.  Anything else (``REV``, ``PLOG``, ``SRI``,
  explicit colliders) is refused.
* NASA-7 thermodynamics (the CHEMKIN fixed-column ``therm.dat``).
* The mean-field surface mechanism XML of the CH4/Ni fixture: sticking rows
  (coverages enter raw), Arrhenius rows (surface concentrations
  Gamma theta / sigma), coverage-dependent activation energies.

The reactor is isothermal at constant volume; the state is the gas
species' mass densities rho_k [kg/m^3], followed by the surface coverages
theta_k in the coupled case:

  d rho_k / dt   = M_k (wdot_k + Asv sdot_k)
  d theta_k / dt = Asv sdot_k sigma_k / Gamma      (the reference code
                                                    scales the coverage
                                                    source by Asv too)

Every model takes a ``dtype``: float64 is the reference; float32 is the
control that a sound comparison has to reject.  The constants are the
ones the BatchReactor.jl reference's golden outputs pin: R = 8.314472
J/(mol K), the standard pressure 1 atm, the thermochemical calorie and
CHEMKIN's classic atomic masses.
"""

import re
import xml.etree.ElementTree as ET

import numpy as np

R = 8.314472
P_STD = 101325.0
CAL = 4.184
ATOMIC_MASS = {"H": 1.00797, "C": 12.01115, "N": 14.0067, "O": 15.9994,
               "AR": 39.948, "HE": 4.0026}


# ---------------------------------------------------------------- thermo --

def parse_thermo(path):
    """NAME -> (elements {sym: count}, T_mid, low (7,), high (7,))."""
    lines = open(path).read().splitlines()
    t_mid_default = 1000.0
    out = {}
    i = 0
    while i < len(lines):
        ln = lines[i]
        up = ln.strip().upper()
        if up.startswith("THERMO"):
            nums = lines[i + 1].split() if i + 1 < len(lines) else []
            try:
                t_mid_default = float(nums[1])
                i += 1
            except (IndexError, ValueError):
                pass
            i += 1
            continue
        if len(ln.rstrip()) >= 79 and ln.rstrip()[-1] == "1" \
                and not up.startswith("!"):
            name = ln[:18].split()[0].upper()
            elems = {}
            for field in (ln[24:44], ln[73:78]):
                for k in range(0, len(field), 5):
                    sym = field[k:k + 2].strip().upper()
                    cnt = field[k + 2:k + 5].strip()
                    if sym and sym != "0" and cnt:
                        if float(cnt):
                            elems[sym] = elems.get(sym, 0.0) + float(cnt)
            t_mid = ln[65:73].strip()
            t_mid = float(t_mid) if t_mid else t_mid_default
            nums = []
            for card in lines[i + 1:i + 4]:
                for k in range(0, 75, 15):
                    s = card[k:k + 15].strip()
                    if s:
                        nums.append(float(s.replace("D", "E")))
            out[name] = (elems, t_mid, np.array(nums[7:14]),
                         np.array(nums[:7]))
            i += 4
            continue
        i += 1
    return out


class Thermo:
    """NASA-7 tables of an ordered species list."""

    def __init__(self, species, path):
        table = parse_thermo(path)
        rows = [table[s.upper()] for s in species]
        self.species = list(species)
        self.elements = [r[0] for r in rows]
        self.t_mid = np.array([r[1] for r in rows])
        self.low = np.stack([r[2] for r in rows])
        self.high = np.stack([r[3] for r in rows])
        self.molwt = np.array([sum(ATOMIC_MASS[e] * n for e, n in
                                   el.items()) for el in self.elements]) * 1e-3

    def g_over_RT(self, T):
        a = np.where((T > self.t_mid)[:, None], self.high, self.low)
        h = (a[:, 0] + a[:, 1] * T / 2 + a[:, 2] * T ** 2 / 3
             + a[:, 3] * T ** 3 / 4 + a[:, 4] * T ** 4 / 5 + a[:, 5] / T)
        s = (a[:, 0] * np.log(T) + a[:, 1] * T + a[:, 2] * T ** 2 / 2
             + a[:, 3] * T ** 3 / 3 + a[:, 4] * T ** 4 / 4 + a[:, 6])
        return h - s

    def element_matrix(self, names):
        """(S, E) atoms of each element ``names`` per molecule."""
        return np.array([[el.get(e, 0.0) for e in names]
                         for el in self.elements])


# -------------------------------------------------------------- gas phase --

_ARROW = re.compile(r"<=>|=>|=")
_FALLOFF = re.compile(r"\(\+\s*M\s*\)", re.I)
_EFF = re.compile(r"([A-Za-z0-9()\-,*]+)\s*/\s*([-+0-9.eEdD]+)\s*/")


def _side(text):
    """{species: count} of one side, without the +M collider; and whether a
    +M was there."""
    counts, third = {}, False
    # split on '+' that separates species ("CH2(S)" keeps its parentheses)
    for tok in re.split(r"\+(?![^(]*\))", text):
        tok = tok.strip()
        if not tok:
            continue
        if tok.upper() == "M":
            third = True
            continue
        m = re.match(r"^(\d+)(.*)$", tok)
        n, name = (int(m.group(1)), m.group(2)) if m else (1, tok)
        counts[name.upper()] = counts.get(name.upper(), 0) + n
    return counts, third


def parse_chemkin(path):
    """(species, reactions): each reaction a dict with ``f``/``r`` (counts),
    ``rev``, ``A``, ``b``, ``Ea`` (cal/mol), ``third``, ``falloff``,
    ``eff``, ``low``, ``troe``."""
    text = [ln.split("!")[0] for ln in open(path).read().splitlines()]
    species, rxns, block = [], [], None
    for ln in text:
        s = ln.strip()
        if not s:
            continue
        key = s.split()[0].upper()
        if key in ("ELEMENTS", "ELEM", "SPECIES", "SPEC", "REACTIONS",
                   "REAC"):
            block = key[:4]
            if len(s.split()) > 1 and block == "REAC":
                units = [u.upper() for u in s.split()[1:]]
                if any(u not in ("CAL/MOLE", "MOLES") for u in units):
                    raise NotImplementedError(f"REACTIONS units {units}")
            rest = s.split()[1:] if block == "SPEC" else []
            species += [t.upper() for t in rest]
            continue
        if key == "END":
            block = None
            continue
        if block == "SPEC":
            species += [t.upper() for t in s.split()]
        elif block == "REAC":
            up = s.upper()
            if up.startswith("DUP"):
                continue
            if up.startswith("LOW"):
                rxns[-1]["low"] = [float(v) for v in
                                   up.split("/")[1].split()]
                continue
            if up.startswith("TROE"):
                rxns[-1]["troe"] = [float(v) for v in
                                    up.split("/")[1].split()]
                continue
            if up.split("/")[0].strip() in ("REV", "PLOG", "SRI", "CHEB",
                                             "TCHEB", "PCHEB", "FORD",
                                             "RORD", "HIGH"):
                raise NotImplementedError(f"auxiliary keyword in {s!r}")
            if _ARROW.search(s) is None:
                for name, val in _EFF.findall(s):
                    rxns[-1]["eff"][name.upper()] = float(val)
                continue
            parts = s.split()
            A, b, Ea = (float(v) for v in parts[-3:])
            eq = "".join(parts[:-3])
            arrow = _ARROW.search(eq).group(0)
            lhs, rhs = eq.split(arrow, 1)
            falloff = bool(_FALLOFF.search(lhs))
            if re.search(r"\(\+(?!\s*M\s*\))", lhs, re.I):
                raise NotImplementedError(f"explicit collider in {eq!r}")
            lhs, rhs = _FALLOFF.sub("", lhs), _FALLOFF.sub("", rhs)
            f, third = _side(lhs)
            r, _ = _side(rhs)
            rxns.append({"f": f, "r": r, "rev": arrow != "=>", "A": A,
                         "b": b, "Ea": Ea, "third": third,
                         "falloff": falloff, "eff": {}, "low": None,
                         "troe": None})
    return species, rxns


class Gas:
    """Gas-phase kinetics of one mechanism in ``dtype``: ``wdot(T, c)``
    (mol/m^3/s) from concentrations c (mol/m^3)."""

    def __init__(self, mech_path, thermo_path, dtype=np.float64):
        self.dtype = dtype
        species, rxns = parse_chemkin(mech_path)
        self.species = species
        self.thermo = Thermo(species, thermo_path)
        S, Rn = len(species), len(rxns)
        ix = {s: k for k, s in enumerate(species)}
        nf = np.zeros((Rn, S))
        nr = np.zeros((Rn, S))
        eff = np.ones((Rn, S))
        for i, rx in enumerate(rxns):
            for s, n in rx["f"].items():
                nf[i, ix[s]] += n
            for s, n in rx["r"].items():
                nr[i, ix[s]] += n
            for s, v in rx["eff"].items():
                eff[i, ix[s]] = v
        order = nf.sum(axis=1)
        third = np.array([rx["third"] for rx in rxns])
        fall = np.array([rx["falloff"] for rx in rxns])
        # cgs -> SI: A (cm^3/mol)^(n-1)/s -> (m^3/mol)^(n-1)/s, kept as ln A
        # so that float32 holds every rate constant's range
        A = np.array([rx["A"] for rx in rxns])
        if (A <= 0).any():
            raise NotImplementedError("non-positive pre-exponential")
        self.lnA = np.log(A) + (order + third - 1) * np.log(1e-6)
        self.b = np.array([rx["b"] for rx in rxns])
        self.Ea = np.array([rx["Ea"] for rx in rxns]) * CAL
        low = np.array([rx["low"] if rx["low"] else [0.0, 0.0, 0.0]
                        for rx in rxns])
        with np.errstate(divide="ignore"):
            self.lnA0 = np.log(low[:, 0]) + order * np.log(1e-6)
        self.b0, self.Ea0 = low[:, 1], low[:, 2] * CAL
        troe = np.array([(rx["troe"] + [np.inf])[:4] if rx["troe"]
                         else [1.0, 1.0, 1.0, np.inf] for rx in rxns])
        self.troe, self.has_troe = troe, np.array(
            [rx["troe"] is not None for rx in rxns])
        self.third, self.fall = third, fall
        self.rev = np.array([rx["rev"] for rx in rxns])
        self.eff = eff
        self.nu = nr - nf
        self.dn = self.nu.sum(axis=1)
        # the species each side multiplies, padded with the index S (a 1)
        self.ix_f = self._gather(nf, S)
        self.ix_r = self._gather(nr, S)
        self.molwt = self.thermo.molwt
        for name in ("lnA", "b", "Ea", "lnA0", "b0", "Ea0", "troe", "eff",
                     "nu", "dn", "molwt"):
            setattr(self, name, getattr(self, name).astype(dtype))

    @staticmethod
    def _gather(n, S):
        rows = [sum(([k] * int(c) for k, c in enumerate(row) if c), [])
                for row in n]
        if any(float(c) != int(c) for row in n for c in row):
            raise NotImplementedError("non-integer stoichiometry")
        w = max(len(r) for r in rows)
        return np.array([r + [S] * (w - len(r)) for r in rows])

    def wdot(self, T, c):
        """Molar production rates (m, S) of concentrations c (m, S), real
        or complex (the complex step of :meth:`Reactor.jac`)."""
        dt = self.dtype
        T = dt(T)
        RT = dt(R) * T
        lnT = np.log(T)
        kinf = np.exp(self.lnA + self.b * lnT - self.Ea / RT)
        k0 = np.exp(self.lnA0 + self.b0 * lnT - self.Ea0 / RT)
        a, t3, t1, t2 = self.troe.T
        with np.errstate(over="ignore", divide="ignore"):
            fcent = ((1 - a) * np.exp(-T / t3) + a * np.exp(-T / t1)
                     + np.exp(-t2 / T))
        lf = np.log10(np.where(self.has_troe, fcent, 1)).astype(dt)
        Kc = np.exp(-(self.nu @ self.thermo.g_over_RT(T).astype(dt))) * (
            dt(P_STD) / RT) ** self.dn
        c1 = np.concatenate([c, np.ones(c.shape[:-1] + (1,), c.dtype)], -1)
        cM = c @ self.eff.T
        Pr = k0 * np.where(cM.real > 0, cM, 0) / kinf
        lp = np.log10(np.where(self.fall & (Pr.real > 1e-30), Pr, 1))
        cc = -0.4 - 0.67 * lf
        nn = 0.75 - 1.27 * lf
        f1 = (lp + cc) / (nn - 0.14 * (lp + cc))
        F = np.where(self.has_troe, 10 ** (lf / (1 + f1 * f1)), 1)
        kf = np.where(self.fall, kinf * Pr / (1 + Pr) * F, kinf)
        kr = np.where(self.rev, kf / Kc, 0)
        q = (kf * c1[..., self.ix_f].prod(axis=-1)
             - kr * c1[..., self.ix_r].prod(axis=-1))
        q = np.where(self.third, q * cM, q)
        return q @ self.nu


# ---------------------------------------------------------------- surface --

_UNITS = {"kj/mol": 1e3, "j/mol": 1.0, "cal/mol": CAL, "kcal/mol": 1e3 * CAL}


class Surface:
    """Mean-field surface kinetics of the fixture's XML format in ``dtype``:
    ``sdot(T, c_gas, theta)`` -> (gas, surface) production in mol/m^2/s."""

    def __init__(self, xml_path, gas_species, gas_molwt, dtype=np.float64):
        self.dtype = dtype
        root = ET.parse(xml_path).getroot()
        efac = _UNITS[(root.get("unit") or "kJ/mol").strip().lower()]
        self.species = [s.upper() for s in root.findtext("species").split()]
        Ss, Sg = len(self.species), len(gas_species)
        sx = {s: k for k, s in enumerate(self.species)}
        gx = {s.upper(): k for k, s in enumerate(gas_species)}
        site = root.find("site")
        self.gamma = float(site.findtext("density"))      # mol/cm^2
        if (site.find("density").get("unit") or "mol/cm2") != "mol/cm2":
            raise NotImplementedError("site density unit")
        sigma = np.ones(Ss)
        for name, val in self._pairs(site.findtext("coordination") or ""):
            sigma[sx[name]] = val
        self.sigma = sigma
        theta0 = np.zeros(Ss)
        for name, val in self._pairs(site.findtext("initial")):
            theta0[sx[name]] = val
        self.theta0 = theta0
        rows = []
        for kind in ("stick", "arrhenius"):
            for el in (root.find(kind) or []):
                eq, nums = el.text.split("@")
                nums = [float(v) for v in nums.split()]
                lhs, rhs = eq.split("=>")
                rows.append((int(el.get("id")), kind, lhs, rhs, nums))
        rows.sort()
        Rn = len(rows)
        self.nf_g, self.nr_g = np.zeros((Rn, Sg)), np.zeros((Rn, Sg))
        self.nf_s, self.nr_s = np.zeros((Rn, Ss)), np.zeros((Rn, Ss))
        self.A, self.b, self.Ea = np.zeros(Rn), np.zeros(Rn), np.zeros(Rn)
        self.stick = np.zeros(Rn, dtype=bool)
        self.s0, self.stick_M = np.zeros(Rn), np.ones(Rn)
        for i, (_, kind, lhs, rhs, nums) in enumerate(rows):
            for side, ng_, ns_ in ((lhs, self.nf_g, self.nf_s),
                                   (rhs, self.nr_g, self.nr_s)):
                for tok in side.split("+"):
                    tok = tok.strip().upper()
                    if tok in sx:
                        ns_[i, sx[tok]] += 1
                    else:
                        ng_[i, gx[tok]] += 1
            if kind == "stick":
                if len(nums) != 1:
                    raise NotImplementedError("sticking with b, Ea")
                self.stick[i] = True
                self.s0[i] = nums[0]
                k = int(np.nonzero(self.nf_g[i])[0][0])
                self.stick_M[i] = gas_molwt[k] * 1e3           # g/mol
            else:
                self.A[i], self.b[i] = nums[0], nums[1]
                self.Ea[i] = nums[2] * efac
        self.eps = np.zeros((Rn, Ss))
        ids = [r[0] for r in rows]
        for el in root.findall("coverage"):
            for rid in el.get("id").split():
                for name, val in self._pairs(el.text):
                    self.eps[ids.index(int(rid)), sx[name]] = val * efac
        if root.find("mwc") is not None or root.find("order") is not None:
            raise NotImplementedError("<mwc>/<order>")
        self.ix_g = Gas._gather(self.nf_g, Sg)
        self.ix_s = Gas._gather(self.nf_s, Ss)
        for name in ("nf_g", "nr_g", "nf_s", "nr_s", "A", "b", "Ea", "s0",
                     "stick_M", "eps", "sigma"):
            setattr(self, name, getattr(self, name).astype(dtype))
        self.gamma = dtype(self.gamma)

    @staticmethod
    def _pairs(text):
        out = []
        for part in text.replace(",", " ").split():
            name, val = part.split("=")
            out.append((name.strip().upper(), float(val)))
        return out

    def sdot(self, T, c_gas_cgs, theta):
        """(gas (m, Sg), surface (m, Ss)) production in mol/m^2/s of gas
        concentrations in mol/cm^3 and coverages, each (m, ·)."""
        dt = self.dtype
        T = dt(T)
        Ea = self.Ea + theta @ self.eps.T
        k_arr = self.A * np.exp(self.b * np.log(T) - Ea / (dt(R) * T))
        flux = np.sqrt(dt(R * 1e7) * T / (dt(2 * np.pi) * self.stick_M))

        def ones(x):
            return np.concatenate(
                [x, np.ones(x.shape[:-1] + (1,), x.dtype)], -1)
        gas = ones(c_gas_cgs)[..., self.ix_g].prod(axis=-1)
        q = np.where(self.stick,
                     self.s0 * flux * gas
                     * ones(theta)[..., self.ix_s].prod(axis=-1),
                     k_arr * gas * ones(theta * self.gamma / self.sigma)[
                         ..., self.ix_s].prod(axis=-1))
        return (q @ (self.nr_g - self.nf_g) * dt(1e4),
                q @ (self.nr_s - self.nf_s) * dt(1e4))


# ---------------------------------------------------------------- reactor --

class Reactor:
    """The isothermal constant-volume reactor's right-hand side and its
    Jacobian in the model's dtype, on the integrator's float64 states."""

    def __init__(self, gas, surface=None):
        self.gas, self.surface = gas, surface
        self.ng = len(gas.species)
        self.cdtype = np.result_type(gas.dtype, np.complex64)

    def _rates(self, T, Asv, y):
        dt = self.gas.dtype
        M = self.gas.molwt
        rho = y[..., :self.ng]
        dy = self.gas.wdot(T, rho / M) * M
        if self.surface is None:
            return dy
        theta = y[..., self.ng:]
        sg, ss = self.surface.sdot(T, rho / (M * dt(1e6)), theta)
        dy = dy + dt(Asv) * sg * M
        dth = dt(Asv) * ss * self.surface.sigma / (self.surface.gamma
                                                   * dt(1e4))
        return np.concatenate([dy, dth], axis=-1)

    def rhs(self, T, Asv, y):
        return self._rates(T, Asv, np.asarray(y).astype(self.gas.dtype)
                           ).astype(np.float64)

    def jac(self, T, Asv, y):
        """d rhs / d y by the complex step: exact to rounding, so the
        Newton updates keep the linear invariants (elements, sites)."""
        n = y.shape[0]
        # float32's step stays well above its smallest normal number once
        # multiplied through the rate laws' products
        h = 1e-30 if self.cdtype == np.complex128 else 1e-10
        Y = (y.astype(self.cdtype)[None, :]
             + self.cdtype.type(1j * h) * np.eye(n, dtype=self.cdtype))
        return (self._rates(T, Asv, Y).imag / h).T.astype(np.float64)


def initial_state(thermo, X, T, p, theta0=None):
    """Mass densities (kg/m^3) of mole fractions ``X`` (S,) at T, p, then
    the coverages: rho_k = x_k p M_k / (R T)."""
    x = np.asarray(X, dtype=np.float64)
    rho = x * p * thermo.molwt / (R * T)
    return rho if theta0 is None else np.concatenate([rho, theta0])
