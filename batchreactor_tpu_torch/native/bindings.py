"""ctypes bindings and the on-demand g++ build of ``br_native.cpp``
(``batchreactor_tpu/native/bindings.py``).

The C++ source is the port's own copy of the JAX package's native runtime:
the same code, the same structs and the same entry points, so both
packages' bindings give the same numbers.  The shared object builds at the
first :func:`load_library` into the checkout's ``build/native/``, named by
a content hash of the source and the flags, and never beside either
package's source.  The mechanism structs are packed from the port's
``GasMechanism``, ``SurfaceMechanism`` and ``ThermoTable``, whose tensors
may lie on any device: each field becomes a contiguous float64 host array
that lives as long as the call.
"""

import ctypes
import dataclasses
import glob
import hashlib
import os
import subprocess
import threading
import time

import numpy as np
import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG_DIR, "br_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_PKG_DIR)),
                          "build", "native")
_CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

#: the last build of this process: ``seconds`` of g++ and its ``log``
BUILD_INFO = {}

_lock = threading.Lock()
_lib = None


class NativeUnavailable(RuntimeError):
    """Raised when the shared library cannot be built or loaded."""


def library_path():
    """Build target named by a content hash of the source and the flags:
    a library that exists was built from exactly this source."""
    h = hashlib.sha256()
    try:
        with open(_SRC, "rb") as fh:
            h.update(fh.read())
    except OSError as e:
        raise NativeUnavailable(f"native source missing: {_SRC}") from e
    h.update(" ".join(_CXX_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"libbr_native-{h.hexdigest()[:12]}.so")


def _build_locked(so):
    """g++ into a temporary name, then rename: the hash-named target is
    trusted by existence alone, so a partial file from an interrupted
    build must never land there."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.build{os.getpid()}"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(["g++", *_CXX_FLAGS, "-o", tmp, _SRC],
                              capture_output=True, text=True)
    except OSError as e:
        raise NativeUnavailable(f"g++ build failed: {e}") from e
    if proc.returncode != 0:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise NativeUnavailable(f"g++ build failed:\n{proc.stderr}")
    os.replace(tmp, so)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, log=proc.stderr)
    # older revisions of the source leave hash-named siblings behind
    for old in glob.glob(os.path.join(_BUILD_DIR, "libbr_native-*.so")):
        if old != so:
            try:
                os.unlink(old)
            except OSError:
                pass


class _BrGasMech(ctypes.Structure):
    _fields_ = [
        ("S", ctypes.c_int64),
        ("R", ctypes.c_int64),
        ("nu_f", ctypes.POINTER(ctypes.c_double)),
        ("nu_r", ctypes.POINTER(ctypes.c_double)),
        ("log_A", ctypes.POINTER(ctypes.c_double)),
        ("beta", ctypes.POINTER(ctypes.c_double)),
        ("Ea", ctypes.POINTER(ctypes.c_double)),
        ("eff", ctypes.POINTER(ctypes.c_double)),
        ("has_tb", ctypes.POINTER(ctypes.c_double)),
        ("has_falloff", ctypes.POINTER(ctypes.c_double)),
        ("log_A0", ctypes.POINTER(ctypes.c_double)),
        ("beta0", ctypes.POINTER(ctypes.c_double)),
        ("Ea0", ctypes.POINTER(ctypes.c_double)),
        ("has_troe", ctypes.POINTER(ctypes.c_double)),
        ("troe", ctypes.POINTER(ctypes.c_double)),
        ("has_sri", ctypes.POINTER(ctypes.c_double)),
        ("sri", ctypes.POINTER(ctypes.c_double)),
        ("rev_mask", ctypes.POINTER(ctypes.c_double)),
        ("sign_A", ctypes.POINTER(ctypes.c_double)),
        ("has_rev", ctypes.POINTER(ctypes.c_double)),
        ("log_A_rev", ctypes.POINTER(ctypes.c_double)),
        ("beta_rev", ctypes.POINTER(ctypes.c_double)),
        ("Ea_rev", ctypes.POINTER(ctypes.c_double)),
        ("sign_A_rev", ctypes.POINTER(ctypes.c_double)),
        ("plog_P", ctypes.c_int64),
        ("has_plog", ctypes.POINTER(ctypes.c_double)),
        ("plog_lnp", ctypes.POINTER(ctypes.c_double)),
        ("plog_logA", ctypes.POINTER(ctypes.c_double)),
        ("plog_beta", ctypes.POINTER(ctypes.c_double)),
        ("plog_Ea", ctypes.POINTER(ctypes.c_double)),
        ("cheb_NT", ctypes.c_int64),
        ("cheb_NP", ctypes.c_int64),
        ("has_cheb", ctypes.POINTER(ctypes.c_double)),
        ("cheb_coef", ctypes.POINTER(ctypes.c_double)),
        ("cheb_invT", ctypes.POINTER(ctypes.c_double)),
        ("cheb_logP", ctypes.POINTER(ctypes.c_double)),
        ("cheb_si_ln", ctypes.POINTER(ctypes.c_double)),
        ("coeffs", ctypes.POINTER(ctypes.c_double)),
        ("T_mid", ctypes.POINTER(ctypes.c_double)),
        ("molwt", ctypes.POINTER(ctypes.c_double)),
        ("kc_compat", ctypes.c_int32),
        ("int_stoich", ctypes.c_int32),
    ]


class _BrSurfMech(ctypes.Structure):
    _fields_ = [
        ("R", ctypes.c_int64),
        ("Sg", ctypes.c_int64),
        ("Ss", ctypes.c_int64),
        ("nu_f_gas", ctypes.POINTER(ctypes.c_double)),
        ("nu_r_gas", ctypes.POINTER(ctypes.c_double)),
        ("nu_f_surf", ctypes.POINTER(ctypes.c_double)),
        ("nu_r_surf", ctypes.POINTER(ctypes.c_double)),
        ("expo_gas", ctypes.POINTER(ctypes.c_double)),
        ("expo_surf", ctypes.POINTER(ctypes.c_double)),
        ("log_A", ctypes.POINTER(ctypes.c_double)),
        ("beta", ctypes.POINTER(ctypes.c_double)),
        ("Ea", ctypes.POINTER(ctypes.c_double)),
        ("cov_eps", ctypes.POINTER(ctypes.c_double)),
        ("stick", ctypes.POINTER(ctypes.c_double)),
        ("stick_s0", ctypes.POINTER(ctypes.c_double)),
        ("stick_molwt", ctypes.POINTER(ctypes.c_double)),
        ("mwc", ctypes.POINTER(ctypes.c_double)),
        ("site_density", ctypes.c_double),
        ("site_coordination", ctypes.POINTER(ctypes.c_double)),
        ("molwt_gas", ctypes.POINTER(ctypes.c_double)),
        ("int_expo", ctypes.c_int32),
    ]


class _BrStats(ctypes.Structure):
    _fields_ = [
        ("t", ctypes.c_double),
        ("status", ctypes.c_int32),
        ("pad", ctypes.c_int32),
        ("n_steps", ctypes.c_int64),
        ("n_rejected", ctypes.c_int64),
        ("n_rhs", ctypes.c_int64),
        ("n_jac", ctypes.c_int64),
        ("n_lu", ctypes.c_int64),
    ]


_RHS_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_double,
                           ctypes.POINTER(ctypes.c_double),
                           ctypes.POINTER(ctypes.c_double))

_DP = ctypes.POINTER(ctypes.c_double)
_I64P = ctypes.POINTER(ctypes.c_int64)


def load_library():
    """Build (at first use) and load the shared library; cached per
    process.  Raises :class:`NativeUnavailable` when g++ fails or the
    library does not load."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            _build_locked(so)
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            raise NativeUnavailable(str(e)) from e
        lib.br_gas_rhs.restype = None
        lib.br_gas_rhs.argtypes = [ctypes.POINTER(_BrGasMech),
                                   ctypes.c_double, _DP, _DP]
        lib.br_bdf.restype = ctypes.c_int32
        lib.br_bdf.argtypes = [
            _RHS_CB, ctypes.c_void_p, ctypes.c_int64, _DP,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int64, ctypes.c_double, _DP, _DP, _DP, ctypes.c_int64,
            _I64P, ctypes.POINTER(_BrStats)]
        lib.br_solve_gas_bdf.restype = ctypes.c_int32
        lib.br_solve_gas_bdf.argtypes = [
            ctypes.POINTER(_BrGasMech), ctypes.c_double, _DP,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int64, ctypes.c_double, _DP, _DP, _DP, ctypes.c_int64,
            _I64P, ctypes.POINTER(_BrStats)]
        lib.br_surface_rates.restype = None
        lib.br_surface_rates.argtypes = [
            ctypes.POINTER(_BrSurfMech), ctypes.c_double, ctypes.c_double,
            _DP, _DP, _DP, _DP]
        lib.br_surf_rhs.restype = None
        lib.br_surf_rhs.argtypes = [
            ctypes.POINTER(_BrSurfMech), ctypes.POINTER(_BrGasMech),
            ctypes.c_double, ctypes.c_double, ctypes.c_int32, _DP, _DP]
        lib.br_solve_surf_bdf.restype = ctypes.c_int32
        lib.br_solve_surf_bdf.argtypes = [
            ctypes.POINTER(_BrSurfMech), ctypes.POINTER(_BrGasMech),
            ctypes.c_double, ctypes.c_double, ctypes.c_int32, _DP,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int64, ctypes.c_double, _DP, _DP, _DP, ctypes.c_int64,
            _I64P, ctypes.POINTER(_BrStats)]
        _lib = lib
        return lib


def available():
    """True iff the native runtime builds and loads on this host."""
    try:
        load_library()
        return True
    except NativeUnavailable:
        return False


def _host(x):
    """A contiguous float64 host array of a tensor (any device) or an
    array-like."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float64).numpy()
    return np.ascontiguousarray(np.asarray(x, dtype=np.float64))


def _carr(x):
    a = _host(x)
    return a, a.ctypes.data_as(_DP)


def _pack_mech(gm, thermo, kc_compat):
    """Pack a ``GasMechanism`` and its ``ThermoTable`` into a _BrGasMech
    struct.  Returns ``(struct, keepalive)``: the caller keeps the list
    alive for every native call that reads the struct."""
    keep = []
    m = _BrGasMech()
    m.S = len(gm.species)
    m.R = len(gm.equations)
    for field, src in [
        ("nu_f", gm.nu_f), ("nu_r", gm.nu_r), ("log_A", gm.log_A),
        ("beta", gm.beta), ("Ea", gm.Ea), ("eff", gm.eff),
        ("has_tb", gm.has_tb), ("has_falloff", gm.has_falloff),
        ("log_A0", gm.log_A0), ("beta0", gm.beta0), ("Ea0", gm.Ea0),
        ("has_troe", gm.has_troe), ("troe", gm.troe),
        ("has_sri", gm.has_sri), ("sri", gm.sri),
        ("rev_mask", gm.rev_mask), ("sign_A", gm.sign_A),
        ("has_rev", gm.has_rev), ("log_A_rev", gm.log_A_rev),
        ("beta_rev", gm.beta_rev), ("Ea_rev", gm.Ea_rev),
        ("sign_A_rev", gm.sign_A_rev), ("has_plog", gm.has_plog),
        ("plog_lnp", gm.plog_lnp), ("plog_logA", gm.plog_logA),
        ("plog_beta", gm.plog_beta), ("plog_Ea", gm.plog_Ea),
        ("has_cheb", gm.has_cheb), ("cheb_coef", gm.cheb_coef),
        ("cheb_invT", gm.cheb_invT), ("cheb_logP", gm.cheb_logP),
        ("cheb_si_ln", gm.cheb_si_ln),
        ("coeffs", thermo.coeffs),
        ("T_mid", thermo.T_mid), ("molwt", thermo.molwt),
    ]:
        arr, ptr = _carr(src)
        keep.append(arr)
        setattr(m, field, ptr)
    m.plog_P = int(gm.plog_lnp.shape[1]) if gm.any_plog else 0
    m.cheb_NT = int(gm.cheb_coef.shape[1]) if gm.any_cheb else 0
    m.cheb_NP = int(gm.cheb_coef.shape[2]) if gm.any_cheb else 0
    m.kc_compat = 1 if kc_compat else 0
    m.int_stoich = 1 if gm.int_stoich else 0
    return m, keep


def _pack_surf(sm, molwt_gas):
    """Pack a ``SurfaceMechanism`` into a _BrSurfMech struct (and its
    keepalive list)."""
    keep = []
    m = _BrSurfMech()
    m.R = len(sm.equations)
    m.Sg = len(sm.gas_species)
    m.Ss = len(sm.species)
    for field, src in [
        ("nu_f_gas", sm.nu_f_gas), ("nu_r_gas", sm.nu_r_gas),
        ("nu_f_surf", sm.nu_f_surf), ("nu_r_surf", sm.nu_r_surf),
        ("expo_gas", sm.expo_gas), ("expo_surf", sm.expo_surf),
        ("log_A", sm.log_A), ("beta", sm.beta), ("Ea", sm.Ea),
        ("cov_eps", sm.cov_eps), ("stick", sm.stick),
        ("stick_s0", sm.stick_s0), ("stick_molwt", sm.stick_molwt),
        ("mwc", sm.mwc), ("site_coordination", sm.site_coordination),
        ("molwt_gas", molwt_gas),
    ]:
        arr, ptr = _carr(src)
        keep.append(arr)
        setattr(m, field, ptr)
    m.site_density = _host(sm.site_density).item()
    m.int_expo = 1 if sm.int_expo else 0
    return m, keep


def surface_rates(sm, T, p, mole_fracs, theta):
    """Native surface production rates ``(sdot_gas, sdot_surf)``
    [mol/m^2/s], the semantics of ``ops.surface_kinetics.production_rates``
    for one state; a cross-implementation test oracle."""
    lib = load_library()
    m, keep = _pack_surf(sm, np.ones(len(sm.gas_species)))
    x_arr, x_ptr = _carr(mole_fracs)
    th_arr, th_ptr = _carr(theta)
    sg = np.empty(len(sm.gas_species))
    ss = np.empty(len(sm.species))
    lib.br_surface_rates(ctypes.byref(m), float(T), float(p), x_ptr, th_ptr,
                         sg.ctypes.data_as(_DP), ss.ctypes.data_as(_DP))
    del keep, x_arr, th_arr
    return sg, ss


def surf_rhs(sm, thermo, T, Asv, y, gm=None, asv_quirk=True,
             kc_compat=False):
    """Native surface (and with ``gm`` coupled gas) reactor RHS over one
    state y = [rho_k, theta_k] (``ops.rhs.make_surface_rhs``)."""
    lib = load_library()
    m, keep = _pack_surf(sm, thermo.molwt)
    gm_ref = None
    if gm is not None:
        gmm, keep_g = _pack_mech(gm, thermo, kc_compat)
        keep += keep_g
        gm_ref = ctypes.byref(gmm)
    y_arr, y_ptr = _carr(y)
    out = np.empty_like(y_arr)
    lib.br_surf_rhs(ctypes.byref(m), gm_ref, float(T), float(Asv),
                    1 if asv_quirk else 0, y_ptr, out.ctypes.data_as(_DP))
    del keep, y_arr
    return out


@dataclasses.dataclass
class NativeResult:
    """Outcome of a native BDF solve of one condition."""

    t: float
    y: np.ndarray
    status: str          # "Success" | "MaxIters" | "DtLessThanMin"
    n_accepted: int
    n_rejected: int
    n_rhs: int
    n_jac: int
    n_lu: int
    ts: np.ndarray       # (n_saved,) accepted-step times
    ys: np.ndarray       # (n_saved, n) accepted-step states


_STATUS = {0: "Success", 2: "MaxIters", 3: "DtLessThanMin"}


def gas_rhs(gm, thermo, T, y, kc_compat=False):
    """Native gas RHS dy/dt of one state (``ops.rhs.make_gas_rhs``); a
    cross-implementation test oracle."""
    lib = load_library()
    m, keep = _pack_mech(gm, thermo, kc_compat)
    y_arr, y_ptr = _carr(y)
    if y_arr.shape != (len(gm.species),):
        raise ValueError(f"y has shape {y_arr.shape}, mechanism has "
                         f"{len(gm.species)} species")
    out = np.empty_like(y_arr)
    lib.br_gas_rhs(ctypes.byref(m), float(T), y_ptr, out.ctypes.data_as(_DP))
    del keep, y_arr
    return out


def _run(call, n, n_save):
    ts = np.empty(max(n_save, 1), dtype=np.float64)
    ys = np.empty((max(n_save, 1), n), dtype=np.float64)
    y_out = np.empty(n, dtype=np.float64)
    n_saved = ctypes.c_int64(0)
    stats = _BrStats()
    call(y_out, ts, ys, n_saved, stats)
    k = int(n_saved.value)
    return NativeResult(
        t=float(stats.t), y=y_out, status=_STATUS.get(stats.status, "Failure"),
        n_accepted=int(stats.n_steps), n_rejected=int(stats.n_rejected),
        n_rhs=int(stats.n_rhs), n_jac=int(stats.n_jac), n_lu=int(stats.n_lu),
        ts=ts[:k].copy(), ys=ys[:k].copy(),
    )


def solve_gas_bdf(gm, thermo, T, y0, t0, t1, *, rtol=1e-6, atol=1e-10,
                  max_steps=200_000, first_step=0.0, n_save=0,
                  kc_compat=False):
    """Integrate the isothermal gas-phase reactor of one condition with
    the native BDF: ``batch_reactor(backend="cpu")``'s gas path and the
    single-CPU baseline."""
    lib = load_library()
    m, keep = _pack_mech(gm, thermo, kc_compat)
    y0_arr, y0_ptr = _carr(y0)
    if y0_arr.shape != (len(gm.species),):
        raise ValueError(f"y0 has shape {y0_arr.shape}, mechanism has "
                         f"{len(gm.species)} species")
    n = y0_arr.shape[0]

    def call(y_out, ts, ys, n_saved, stats):
        lib.br_solve_gas_bdf(
            ctypes.byref(m), float(T), y0_ptr, float(t0), float(t1),
            float(rtol), float(atol), int(max_steps), float(first_step),
            y_out.ctypes.data_as(_DP), ts.ctypes.data_as(_DP),
            ys.ctypes.data_as(_DP), int(n_save), ctypes.byref(n_saved),
            ctypes.byref(stats))

    res = _run(call, n, n_save)
    del keep, y0_arr
    return res


def solve_surf_bdf(sm, thermo, T, Asv, y0, t0, t1, *, gm=None,
                   asv_quirk=True, kc_compat=False, rtol=1e-6, atol=1e-10,
                   max_steps=200_000, first_step=0.0, n_save=0):
    """Integrate the surface (and with ``gm`` coupled gas) reactor of one
    condition with the native BDF: ``backend="cpu"``'s surface paths."""
    lib = load_library()
    m, keep = _pack_surf(sm, thermo.molwt)
    gm_ref = None
    if gm is not None:
        gmm, keep_g = _pack_mech(gm, thermo, kc_compat)
        keep += keep_g
        gm_ref = ctypes.byref(gmm)
    y0_arr, y0_ptr = _carr(y0)
    n = len(sm.gas_species) + len(sm.species)
    if y0_arr.shape != (n,):
        raise ValueError(f"y0 has shape {y0_arr.shape}, expected ({n},)")

    def call(y_out, ts, ys, n_saved, stats):
        lib.br_solve_surf_bdf(
            ctypes.byref(m), gm_ref, float(T), float(Asv),
            1 if asv_quirk else 0, y0_ptr, float(t0), float(t1),
            float(rtol), float(atol), int(max_steps), float(first_step),
            y_out.ctypes.data_as(_DP), ts.ctypes.data_as(_DP),
            ys.ctypes.data_as(_DP), int(n_save), ctypes.byref(n_saved),
            ctypes.byref(stats))

    res = _run(call, n, n_save)
    del keep, y0_arr
    return res


def solve_bdf(rhs, y0, t0, t1, *, rtol=1e-6, atol=1e-10, max_steps=200_000,
              first_step=0.0, n_save=0):
    """The native BDF over a torch RHS ``rhs(t, y) -> dy``, with ``y`` a
    float64 CPU tensor of shape (n,) that views the solver's own buffer
    (no copy: ``rhs`` must not write into it) and ``dy`` any tensor or
    array of n values, on any device.

    Every evaluation crosses the ctypes boundary, so this path is for
    correctness work (user-defined chemistry, the quarantine's oracle,
    solver cross-checks), not speed: :func:`solve_gas_bdf` is the
    all-native path.  An exception raised by ``rhs`` stops the solve (the
    solver sees NaN from then on) and propagates from this function."""
    lib = load_library()
    y0_arr, y0_ptr = _carr(y0)
    n = y0_arr.shape[0]
    err = []

    @_RHS_CB
    def cb(_ctx, t, y_ptr, dy_ptr):
        dy_out = torch.from_numpy(np.ctypeslib.as_array(dy_ptr, shape=(n,)))
        if err:  # the RHS already failed: poison without re-entering it
            dy_out.fill_(float("nan"))
            return
        try:
            y = torch.from_numpy(np.ctypeslib.as_array(y_ptr, shape=(n,)))
            dy = torch.as_tensor(rhs(float(t), y))
            if tuple(dy.shape) != (n,):
                raise ValueError(f"rhs returned shape {tuple(dy.shape)}, "
                                 f"expected ({n},)")
            dy_out.copy_(dy.detach().to("cpu", torch.float64))
        except Exception as e:  # noqa: BLE001 — cannot raise through C
            err.append(e)
            dy_out.fill_(float("nan"))

    def call(y_out, ts, ys, n_saved, stats):
        lib.br_bdf(
            cb, None, n, y0_ptr, float(t0), float(t1), float(rtol),
            float(atol), int(max_steps), float(first_step),
            y_out.ctypes.data_as(_DP), ts.ctypes.data_as(_DP),
            ys.ctypes.data_as(_DP), int(n_save), ctypes.byref(n_saved),
            ctypes.byref(stats))

    res = _run(call, n, n_save)
    if err:
        raise err[0]
    del y0_arr
    return res
