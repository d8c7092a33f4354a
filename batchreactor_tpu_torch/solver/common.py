"""What the BDF and SDIRK solvers share.

The JAX package's ``solver/bdf.py`` imports its result type, status codes
and scaled error norm from ``batchreactor_tpu/solver/sdirk.py``
(``SolveResult`` at :53, the status codes at :50, ``NLIVE_KEY`` at :102,
``ATOL_SCALE_KEY`` at :130, ``_scaled_norm`` at :133).  Here they live in
one module both solvers import, batched over lanes, with the helpers both
solvers use on lane-batched tensors (the per-lane select and the
``jac=None`` fallback).
"""

import dataclasses
from typing import NamedTuple

import torch

# status codes (per lane)
RUNNING, SUCCESS, MAX_STEPS_REACHED, DT_UNDERFLOW = 0, 1, 2, 3

#: reserved per-lane cfg key: a (B, n) multiplier on ``atol`` in every
#: scaled norm of both solvers (the energy path's temperature row, whose
#: absolute tolerance is ``atol_T`` Kelvin while the species rows keep
#: ``atol``; ``energy/eqns.py``).  Absent, the norms are the plain-atol
#: computation, operation for operation.
ATOL_SCALE_KEY = "_atol_scale"

#: reserved per-lane cfg key: the (B,) live component count of a padded
#: state (``models/padding.py``).  Present, every scaled RMS norm of both
#: solvers divides the sum of squares by it instead of taking the mean
#: over the padded width, so the dead components (exactly 0 in every
#: norm) leave step control as it is unpadded.  Absent, the norms are the
#: mean, operation for operation.
NLIVE_KEY = "_nlive"


@dataclasses.dataclass
class SolveResult:
    """Per-lane outcome of an adaptive solve; every tensor has the lane
    axis first.  ``status`` holds the codes above."""

    t: torch.Tensor          # (B,) final time reached
    y: torch.Tensor          # (B, n) final state
    status: torch.Tensor     # (B,) SUCCESS/MAX_STEPS_REACHED/DT_UNDERFLOW
    n_accepted: torch.Tensor  # (B,)
    n_rejected: torch.Tensor  # (B,)
    ts: torch.Tensor         # (B, n_save) accepted-step times, +inf padded
    ys: torch.Tensor         # (B, n_save, n) accepted-step states, 0 padded
    n_saved: torch.Tensor    # (B,) valid rows in ts/ys (saturates)
    h: torch.Tensor = None   # (B,) step size the controller would try next
    observed: object = None  # observer fold state (None without observer)
    err_prev: torch.Tensor = None  # (B,) SDIRK's PI memory (resume)
    solver_state: object = None  # opaque multistep carry (BDF resume)
    tangents: torch.Tensor = None  # (B, P, n) forward sensitivities (BDF)
    provenance: torch.Tensor = None  # (B,) int8 quarantine provenance codes
    stats: dict = None       # per-lane counters (stats=True; obs/counters.py)
    it_matrix: torch.Tensor = None  # (B, n, n) last M = I - cJ (step_audit)
    accept_ring: torch.Tensor = None  # (B, 64) int8 attempt ring (step_audit)


def check_deferred(kwargs, table):
    """The port's rule for options it does not have yet: ``table`` lists
    ``(name, default, ROADMAP item)``; a name in ``kwargs`` set to anything
    but its default raises ``NotImplementedError`` naming the item, and a
    name the table does not know raises ``TypeError``."""
    known = {name for name, _, _ in table}
    unknown = set(kwargs) - known
    if unknown:
        raise TypeError(f"unexpected keyword arguments {sorted(unknown)}")
    for name, default, item in table:
        val = kwargs.get(name, default)
        if val is not default and val != default:
            raise NotImplementedError(
                f"{name}={val!r} is not ported yet (ROADMAP {item})")


def rms(x, nlive=None):
    """Per-lane RMS over the last axis, (B,): the mean of the squares, or
    with ``nlive`` (B,) (:data:`NLIVE_KEY`) their sum over the live count."""
    if nlive is None:
        return torch.sqrt(torch.mean(torch.square(x), dim=-1))
    return torch.sqrt(torch.sum(torch.square(x), dim=-1) / nlive)


def scaled_norm(e, y, rtol, atol, atol_scale=None, nlive=None):
    """Per-lane RMS of e / (atol w + rtol |y|) over the last axis, (B,);
    ``atol_scale`` is the (B, n) weight w (:data:`ATOL_SCALE_KEY`), or
    None for w = 1; ``nlive`` the (B,) live count (:data:`NLIVE_KEY`)."""
    a = atol if atol_scale is None else atol * atol_scale
    scale = a + rtol * torch.abs(y)
    return rms(e / scale, nlive)


def atol_scale_of(cfg, y0):
    """The :data:`ATOL_SCALE_KEY` operand of ``cfg`` as a tensor like
    ``y0``, or None when the key is absent."""
    w = cfg.get(ATOL_SCALE_KEY) if isinstance(cfg, dict) else None
    return None if w is None else torch.as_tensor(w, dtype=y0.dtype,
                                                  device=y0.device)


def nlive_of(cfg, y0):
    """The :data:`NLIVE_KEY` operand of ``cfg`` as a (B,) tensor like
    ``y0``, or None when the key is absent."""
    k = cfg.get(NLIVE_KEY) if isinstance(cfg, dict) else None
    return None if k is None else torch.as_tensor(k, dtype=y0.dtype,
                                                  device=y0.device)


def where_lanes(mask, a, b):
    """Per-lane select over tensors or dicts of tensors."""
    if isinstance(a, dict):
        return {k: where_lanes(mask, a[k], b[k]) for k in a}
    m = mask.reshape(mask.shape + (1,) * (a.ndim - mask.ndim))
    return torch.where(m, a, b)


def jacfwd_lanes(rhs):
    """Per-lane forward-mode Jacobian of a batched RHS (the solvers'
    ``jac=None`` fallback, as ``jax.jacfwd`` is in the JAX package)."""
    from torch.func import jacfwd, vmap

    def jac(t, y, cfg):
        def one(t1, y1, cfg1):
            return rhs(t1[None], y1[None],
                       {k: v[None] for k, v in cfg1.items()})[0]

        return vmap(jacfwd(one, argnums=1))(t, y, cfg)

    return jac


def init_stats(keys, B, device, order_slots=None):
    """The zero counter block of ``stats=True``: one (B,) int32 tensor per
    key, and with ``order_slots`` BDF's (B, order_slots) order histogram."""
    st = {k: torch.zeros(B, dtype=torch.int32, device=device) for k in keys}
    if order_slots is not None:
        st["order_hist"] = torch.zeros((B, order_slots), dtype=torch.int32,
                                       device=device)
    return st


def init_timeline(timeline, timeline_state, B, dtype, device):
    """The ring of ``timeline=N`` as ``({"t", "h", "code"}, base)``: zero
    slots (code 0 = empty) and base 0, or resumed from ``timeline_state``
    (``{"t", "h", "code", "base"}``, ``base`` the (B,) attempts of the
    previous segments, so the slot keys on the global attempt index)."""
    if timeline_state is None:
        ring = {"t": torch.zeros((B, timeline), dtype=dtype, device=device),
                "h": torch.zeros((B, timeline), dtype=dtype, device=device),
                "code": torch.zeros((B, timeline), dtype=torch.int8,
                                    device=device)}
        return ring, torch.zeros(B, dtype=torch.int64, device=device)
    ring = {"t": torch.as_tensor(timeline_state["t"], dtype=dtype,
                                 device=device).clone(),
            "h": torch.as_tensor(timeline_state["h"], dtype=dtype,
                                 device=device).clone(),
            "code": torch.as_tensor(timeline_state["code"], dtype=torch.int8,
                                    device=device).clone()}
    base = torch.as_tensor(timeline_state["base"], dtype=torch.int64,
                           device=device).expand(B).clone()
    return ring, base


def ring_write(ring, slot, live, **vals):
    """Write ``vals`` (per-lane (B,) values by ring key) at the per-lane
    ``slot`` (B,) of ``ring`` where ``live`` holds: a gather, a select and a
    scatter, so a captured window can write it."""
    idx = slot[:, None]
    return {k: ring[k].scatter(1, idx, torch.where(
        live[:, None], vals[k].to(ring[k].dtype)[:, None],
        ring[k].gather(1, idx))) if k in vals else ring[k] for k in ring}


def stats_out(c, timeline):
    """``SolveResult.stats`` of a stepper carry: the counters, the step
    counts (int32, so the block is self-contained) and the ring."""
    out = {"n_accepted": c["n_acc"].to(torch.int32),
           "n_rejected": c["n_rej"].to(torch.int32), **c["st"]}
    if timeline is not None:
        out["timeline_t"] = c["tl"]["t"]
        out["timeline_h"] = c["tl"]["h"]
        out["timeline_code"] = c["tl"]["code"]
    return out


class Stepper(NamedTuple):
    """A solver split into its pure pieces, for the loops that drive it.

    ``init(...) -> carry`` builds the per-lane carry of a solve (a dict of
    tensors; every per-solve constant rides in it too), ``window(carry,
    fixed=False) -> carry`` advances every lane by one Jacobian window of
    attempts, and ``result(carry)`` is the :class:`SolveResult`.  With
    ``fixed=False`` the window's loops stop once no lane needs them (host
    syncs: the blocking gear); with ``fixed=True`` they run every trip
    under the lanes' own masks and the window makes no host decision, so a
    CUDA graph can capture it (``solver/graphs.py``).  The two give every
    lane the same values bit for bit: each carried value goes through a
    per-lane select."""

    init: object
    window: object
    result: object
