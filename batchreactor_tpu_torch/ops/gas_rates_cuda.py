"""Gas-phase production rates in one Hopper kernel: ``brtorch::gas_wdot``.

The plain version is :func:`.gas_kinetics.production_rates_plain`, some 200
aten ops a call.  ``csrc/gas_rates.cu`` computes the same wdot (B, S) from
T (B,) and the concentrations (B, S) in one launch (the source says what
bounds it and how its design answers that); it replaces no TPU kernel, as
the JAX package leaves the rate code to XLA's fusion.

* :func:`takes` is the route that :func:`.gas_kinetics.production_rates`
  asks: a call on CUDA tensors whose mechanism has only the forms the kernel
  computes (integer stoichiometry up to 3, no PLOG or Chebyshev tables,
  rate parameters shared by the lanes) and through which no autograd graph
  or ``torch.func`` transform passes.  Everything else takes the plain
  path.
* :func:`gas_wdot` runs the operator ``brtorch::gas_wdot`` (a
  ``torch.library`` operator: the plain version is its CPU kernel, the
  launch its CUDA kernel, so an op log, ``torch.profiler`` and a captured
  graph name it).  On a CUDA tensor it launches the kernel or raises; each
  launch counts ``gas_wdot`` in ``obs/tally.py``'s ``COUNTS`` (a captured
  graph's on every replay).
* :func:`structure` packs the mechanism's stoichiometry once on the host,
  kept beside the stoichiometry tensors as ``_stoich_gather`` keeps its
  index; the parameters are read from the mechanism's own tensors at each
  launch.

The kernel is built with ``csrc/lu32p.cu`` into the port's one kernel
library (:func:`..kernels.load_library`).
"""

import ctypes
import dataclasses
import math
import threading
import types

import numpy as np
import torch
from torch.autograd import forward_ad
from torch._C._functorch import is_functorch_wrapped_tensor

from ..kernels import load_library
from ..obs import tally
from ..utils.constants import P_ATM
from ..utils.constants import R as R_GAS

#: the mechanism's tensor fields the kernel reads at each launch, then the
#: thermo table's, in the order of ``csrc/gas_rates.cu``'s ``Operand``
MECH_FIELDS = ("log_A", "beta", "Ea", "has_tb", "has_falloff", "log_A0",
               "beta0", "Ea0", "has_troe", "troe", "has_sri", "sri",
               "rev_mask", "sign_A", "has_rev", "log_A_rev", "beta_rev",
               "Ea_rev", "sign_A_rev", "eff")
THERMO_FIELDS = ("coeffs", "T_mid")
#: the rate parameters that forward and adjoint sensitivities with one
#: theta row per lane make (lanes, R) (``sensitivity/params.py::apply``);
#: their primal solves call the rates outside any transform, on the plain
#: path, as the kernel reads one row shared by the lanes
PER_LANE_FIELDS = ("log_A", "beta", "Ea")
#: the packed structure (:class:`Structure`), after them
STRUCTURE_FIELDS = ("order", "f_idx", "f_pw", "r_idx", "r_pw", "d_idx",
                    "d_val", "dn", "csr_ptr", "csr_rxn", "csr_val")

#: threads of one CTA
THREADS = 256
#: lanes of one CTA's tile, at most
LANES = 8
#: the tile narrows (by halves, to one lane) until the grid has this many
#: CTAs: on the H100 the kernel ran fastest at 512 CTAs of 8 lanes for
#: B = 4096 and of 2 lanes for B = 1024 (about two waves of the two
#: 256-thread CTAs an SM holds at the kernel's registers)
MIN_CTAS = 512
# the dynamic shared memory one block may use on sm_90 (227 KB)
_SMEM_LIMIT = 232_448

# guards _STRUCTURE: the mesh's host threads run the rates at the same time
_structure_lock = threading.Lock()


def smem_bytes(lanes, n_species, n_reactions):
    """Dynamic shared memory of one CTA: the tile's concentrations and
    g/RT (lanes, S), its rates of progress (R, lanes) and four scalars a
    lane, float64."""
    return 8 * lanes * (2 * n_species + n_reactions + 4)


def launch_config(batch, n_species, n_reactions):
    """``lanes`` (of one CTA's tile), ``grid``, ``block`` and ``smem`` of a
    launch, or None where even a one-lane tile's shared memory exceeds one
    block's (the launch then raises).  The tile takes
    :data:`LANES` lanes, fewer while the grid would have fewer than
    :data:`MIN_CTAS` CTAs or the tile's shared memory would not fit a
    block."""
    lanes = LANES
    while lanes > 1 and -(-batch // lanes) < MIN_CTAS:
        lanes //= 2
    while lanes >= 1:
        smem = smem_bytes(lanes, n_species, n_reactions)
        if smem <= _SMEM_LIMIT:
            return {"lanes": lanes, "grid": -(-batch // lanes),
                    "block": THREADS, "smem": smem}
        lanes //= 2
    return None


# --------------------------------------------------------------------------
# the packed structure
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Structure:
    """The stoichiometry of a mechanism as the kernel walks it, on the
    mechanism's device:

    * ``order`` (R,) int32: the order the kernel takes the reactions in,
      grouped by kind (elementary, third-body, Lindemann, TROE, SRI; stable
      within a kind) so a warp rarely diverges; a permutation, so any order
      gives the same result;
    * ``f_idx``/``f_pw`` (R, kf) and ``r_idx``/``r_pw`` (R, kr) int32: the
      species of each row of ``nu_f`` / ``nu_r`` with a non-zero
      coefficient, in species order, and that coefficient (padded with
      power 0);
    * ``d_idx`` (R, kd) int32 and ``d_val`` (R, kd) float64: the non-zero
      entries of each row of dnu = nu_r - nu_f (padded with 0.0), and
      ``dn`` (R,) float64, each row's sum;
    * ``csr_ptr`` (S + 1,), ``csr_rxn`` (nnz,) int32 and ``csr_val``
      (nnz,) float64: for each species k the reactions j with dnu_jk != 0,
      in reaction order, and dnu_jk.
    """

    order: torch.Tensor
    f_idx: torch.Tensor
    f_pw: torch.Tensor
    r_idx: torch.Tensor
    r_pw: torch.Tensor
    d_idx: torch.Tensor
    d_val: torch.Tensor
    dn: torch.Tensor
    csr_ptr: torch.Tensor
    csr_rxn: torch.Tensor
    csr_val: torch.Tensor

    def tensors(self):
        return [getattr(self, f) for f in STRUCTURE_FIELDS]


# per mechanism stoichiometry: (nu_f, nu_r, Structure), by id(nu_f)
_STRUCTURE = {}


def _rows(nu, dtype):
    """(idx (R, K), values (R, K)) of the non-zero entries of each row of
    ``nu`` (R, S), in column order, padded with index 0 and value 0."""
    nz = nu != 0
    K = max(int(nz.sum(axis=1).max(initial=0)), 1)
    idx = np.zeros((nu.shape[0], K), dtype=np.int32)
    val = np.zeros((nu.shape[0], K), dtype=dtype)
    for j in range(nu.shape[0]):
        cols = np.flatnonzero(nz[j])
        idx[j, :cols.size] = cols
        val[j, :cols.size] = nu[j, cols]
    return idx, val


def _kind(gm):
    """Each reaction's kind, the order's key: 0 elementary, 1 third-body,
    2 Lindemann, 3 TROE, 4 SRI."""
    fo = gm.has_falloff.detach().cpu().numpy() > 0
    kind = np.where(gm.has_tb.detach().cpu().numpy() > 0, 1, 0)
    kind = np.where(fo, 2, kind)
    kind = np.where(fo & (gm.has_troe.detach().cpu().numpy() > 0), 3, kind)
    return np.where(fo & (gm.has_sri.detach().cpu().numpy() > 0), 4, kind)


def structure(gm):
    """The :class:`Structure` of ``gm``'s stoichiometry, packed once (one
    host read of ``nu_f``/``nu_r`` and the kind flags) and kept beside the
    two tensors."""
    hit = _STRUCTURE.get(id(gm.nu_f))
    if hit is not None and hit[0] is gm.nu_f and hit[1] is gm.nu_r:
        return hit[2]
    nu_f = gm.nu_f.detach().cpu().numpy()
    nu_r = gm.nu_r.detach().cpu().numpy()
    dnu = nu_r - nu_f
    f_idx, f_pw = _rows(nu_f, np.int32)
    r_idx, r_pw = _rows(nu_r, np.int32)
    d_idx, d_val = _rows(dnu, np.float64)
    cols = dnu.T != 0                                        # (S, R)
    counts = cols.sum(axis=1)
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    rxn = np.concatenate([np.flatnonzero(c) for c in cols]
                         + [np.zeros(0, np.int64)]).astype(np.int32)
    val = np.concatenate([dnu[np.flatnonzero(c), k]
                          for k, c in enumerate(cols)]
                         + [np.zeros(0)]).astype(np.float64)
    order = np.argsort(_kind(gm), kind="stable").astype(np.int32)

    dev = gm.nu_f.device

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    packed = Structure(
        order=put(order), f_idx=put(f_idx), f_pw=put(f_pw), r_idx=put(r_idx),
        r_pw=put(r_pw), d_idx=put(d_idx), d_val=put(d_val),
        dn=put(dnu.sum(axis=1)), csr_ptr=put(ptr), csr_rxn=put(rxn),
        csr_val=put(val))
    with _structure_lock:
        if len(_STRUCTURE) >= 64:
            _STRUCTURE.pop(next(iter(_STRUCTURE)))
        _STRUCTURE[id(gm.nu_f)] = (gm.nu_f, gm.nu_r, packed)
    return packed


def dense_stoichiometry(packed, n_species):
    """(nu_f, nu_r, dnu) (R, S) rebuilt from a :class:`Structure`: the
    species lists and the species' reaction lists (a check of the
    packing)."""
    R = packed.order.shape[0]

    def scatter(idx, val):
        out = torch.zeros((R, n_species), dtype=torch.float64)
        out.scatter_add_(1, idx.cpu().long(), val.cpu().double())
        return out

    nu_f = scatter(packed.f_idx, packed.f_pw)
    nu_r = scatter(packed.r_idx, packed.r_pw)
    dnu = torch.zeros((R, n_species), dtype=torch.float64)
    ptr = packed.csr_ptr.cpu().tolist()
    rxn, val = packed.csr_rxn.cpu().long(), packed.csr_val.cpu()
    for k in range(n_species):
        dnu[rxn[ptr[k]:ptr[k + 1]], k] = val[ptr[k]:ptr[k + 1]]
    return nu_f, nu_r, dnu


# --------------------------------------------------------------------------
# the route
# --------------------------------------------------------------------------
def _parameters(gm, thermo):
    return ([getattr(gm, f) for f in MECH_FIELDS]
            + [getattr(thermo, f) for f in THERMO_FIELDS])


def kernel_forms(gm):
    """Whether the kernel computes ``gm``'s rate laws: integer
    stoichiometry up to 3, no PLOG or Chebyshev tables, and rate
    parameters shared by the lanes (not the (lanes, R) rows of
    :data:`PER_LANE_FIELDS` that sensitivities make).  Static: the same for
    every call with this mechanism."""
    if not gm.int_stoich or gm.any_plog or gm.any_cheb:
        return False
    return all(getattr(gm, f).dim() == 1 for f in PER_LANE_FIELDS)


def _transformed(tensors):
    """Whether an autograd graph or a ``torch.func`` transform passes
    through these tensors: a functorch wrapper (``jvp``, ``vjp``,
    ``jacfwd``, ``vmap``), a tensor that requires grad while grad mode is
    on, or an open forward-AD level."""
    grad = torch.is_grad_enabled()
    for t in tensors:
        if is_functorch_wrapped_tensor(t) or (grad and t.requires_grad):
            return True
    return forward_ad._current_level >= 0


def takes(T, conc, gm, thermo):
    """Whether :func:`.gas_kinetics.production_rates` launches the kernel
    for this call: CUDA tensors, a mechanism of :func:`kernel_forms`, and
    no autograd graph or ``torch.func`` transform through the inputs."""
    return (conc.device.type == "cuda" and kernel_forms(gm)
            and not _transformed([T, conc] + _parameters(gm, thermo)))


def gas_wdot(T, conc, gm, thermo, kc_compat=False, falloff_compat=False,
             exp32=False):
    """wdot (B, S) through the operator ``brtorch::gas_wdot``: the plain
    version on the CPU, the kernel on CUDA (float64 only; a failed launch
    raises)."""
    if conc.ndim != 2 or T.ndim != 1 or T.shape[0] not in (1, conc.shape[0]):
        raise ValueError(f"gas_wdot needs T (B,) and conc (B, S), got "
                         f"{tuple(T.shape)} and {tuple(conc.shape)}")
    return OP(T, conc, _parameters(gm, thermo), structure(gm).tensors(),
              kc_compat, falloff_compat, exp32)


# The operator is registered through torch.library's Library API, not
# torch.library.custom_op: custom_op wraps each kernel so that its first call
# imports torch._dynamo, which cost the coupled cell, whose path calls no
# other custom op, seconds of set-up on the card.
_OPS = torch.library.Library("brtorch", "FRAGMENT")
_OPS.define("gas_wdot(Tensor T, Tensor conc, Tensor[] params, "
            "Tensor[] packed, bool kc_compat, bool falloff_compat, "
            "bool exp32) -> Tensor")


def _gas_wdot_plain(T, conc, params, packed, kc_compat, falloff_compat,
                    exp32):
    """The operator's CPU kernel: the plain version over a mechanism
    rebuilt from the operands."""
    from . import gas_kinetics

    n = len(MECH_FIELDS)
    nu_f, nu_r, _ = dense_stoichiometry(Structure(*packed), conc.shape[1])
    gm = types.SimpleNamespace(
        nu_f=nu_f.to(conc.device), nu_r=nu_r.to(conc.device),
        int_stoich=True, any_plog=False, any_cheb=False,
        **dict(zip(MECH_FIELDS, params[:n])))
    thermo = types.SimpleNamespace(**dict(zip(THERMO_FIELDS, params[n:])))
    return gas_kinetics.production_rates_plain(
        T, conc, gm, thermo, kc_compat, falloff_compat, exp32)


def _gas_wdot_launch(T, conc, params, packed, kc_compat, falloff_compat,
                     exp32):
    """Check the operands, then launch on the current stream and count
    the launch (inside a capture, into the graph's tally)."""
    dev = conc.device
    B, S = conc.shape
    st = Structure(*packed)
    R = st.order.shape[0]
    for name, t in zip(("T", "conc") + MECH_FIELDS + THERMO_FIELDS,
                       [T, conc] + list(params)):
        if t.device != dev or t.dtype != torch.float64:
            raise TypeError(f"gas_wdot: {name} is {t.dtype} on {t.device}; "
                            f"the kernel takes float64 on {dev}")
    for name, t in zip(STRUCTURE_FIELDS, packed):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"gas_wdot: the packed {name} is not a "
                             f"contiguous tensor on {dev}")
    cfg = launch_config(B, S, R)
    if cfg is None:
        raise ValueError(f"gas_wdot: a mechanism of {R} reactions and {S} "
                         f"species exceeds one block's shared memory")
    wdot = torch.empty((B, S), dtype=torch.float64, device=dev)
    if B == 0:
        return wdot
    conc = conc if conc.stride(1) == 1 else conc.contiguous()
    params = [p.contiguous() for p in params]
    ptrs = (ctypes.c_void_p * (len(params) + len(packed)))(
        *[t.data_ptr() for t in params + list(packed)])
    if kc_compat:
        p0, shift = 1e5, math.log(1e6)
    else:
        p0, shift = P_ATM, 0.0
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        tally.count("gas_wdot")
        err = lib.gas_wdot(
            T.data_ptr(), T.stride(0) if T.shape[0] == B else 0,
            conc.data_ptr(), conc.stride(0), wdot.data_ptr(), B, S, R,
            st.f_idx.shape[1], st.r_idx.shape[1], st.d_idx.shape[1], ptrs,
            len(ptrs), R_GAS, p0, shift, int(falloff_compat), int(exp32),
            cfg["lanes"], cfg["grid"], cfg["block"], cfg["smem"], stream)
    if err != 0:
        raise RuntimeError("gas_wdot kernel launch failed: "
                           + lib.gas_wdot_error_string(err).decode())
    return wdot


_OPS.impl("gas_wdot", _gas_wdot_plain, "CPU")
_OPS.impl("gas_wdot", _gas_wdot_launch, "CUDA")
#: the operator ``brtorch::gas_wdot``
OP = torch.ops.brtorch.gas_wdot
