"""Lane quarantine: recover failed lanes instead of poisoning the chunk
(``batchreactor_tpu/resilience/quarantine.py``).

A sweep's per-lane ``status`` already isolates failures (a DT_UNDERFLOW
lane never corrupts its neighbours), but a failed lane stays failed in the
result.  :func:`resolve` chases it with an escalation ladder driven by
:class:`~.policy.QuarantinePolicy`:

1. **retry pass** — the whole batch re-solves with unchanged settings and
   only the quarantined lanes are taken from it: the same program on the
   same inputs at the same batch shape, so transient corruption (an
   injected NaN, a device glitch) recovers bit for bit, where a
   lane-subset re-solve would run another batch shape.
2. **fallback pass** — the survivors of pass 1 re-solve alone with
   tolerances tightened by ``rtol_factor``/``atol_factor`` and the step
   budget raised by ``max_steps_factor``.
3. **oracle pass** (optional) — the residue goes lane by lane to the
   native CPU BDF (:func:`native_oracle`, ``native/``), the CVODE-class
   runtime both packages share.  A lane that only the oracle solves is a
   solver problem worth a ticket, and its provenance says so.

Lanes that survive every pass keep their primary-attempt fields and are
marked ``failed``.  Live (never-quarantined) lanes are untouched: their
results equal a quarantine-off run's.  Provenance rides
``SolveResult.provenance`` as an int8 per-lane code
(:data:`PROVENANCE_NAMES` maps code -> name) and persists in checkpoint
``.npz`` files under ``prov``."""

import dataclasses

import numpy as np
import torch

from ..solver.common import SUCCESS, SolveResult
from ..solver.graphs import tree_map

#: per-lane provenance codes (int8); index into PROVENANCE_NAMES
PRIMARY, RETRY, FALLBACK, ORACLE, FAILED = 0, 1, 2, 3, 4
PROVENANCE_NAMES = ("primary", "retry", "fallback", "oracle", "failed")


def _take(res, idx):
    """The lanes ``idx`` (host int array) of every per-lane field."""
    def take(x):
        return x[torch.as_tensor(idx, device=x.device)]

    return SolveResult(**{f: tree_map(take, getattr(res, f))
                          for f in SolveResult.__dataclass_fields__})


def merge_lanes(res, sub, idx):
    """``res`` with the lanes of the subset result ``sub`` scattered in at
    batch indices ``idx``, in every field both carry."""
    def put(a, b):
        a = a.clone()
        a[torch.as_tensor(idx, device=a.device)] = b.to(a.device, a.dtype)
        return a

    out = {}
    for f in SolveResult.__dataclass_fields__:
        a, b = getattr(res, f), getattr(sub, f)
        out[f] = a if a is None or b is None else tree_map(put, a, b)
    return SolveResult(**out)


def provenance_counts(prov):
    """``{name: lane count}`` for the non-primary provenance codes."""
    prov = np.asarray(prov)
    return {PROVENANCE_NAMES[c]: int((prov == c).sum())
            for c in (RETRY, FALLBACK, ORACLE, FAILED)
            if int((prov == c).sum())}


def _set_lane(res, lane, out):
    """``res`` with lane ``lane``'s state, time, status and step counts
    taken from the oracle's result ``out``; every other field keeps the
    primary attempt's value, as in the JAX package."""
    def put(x, value):
        x = x.clone()
        x[lane] = torch.as_tensor(value, dtype=x.dtype, device=x.device)
        return x

    return dataclasses.replace(
        res, t=put(res.t, float(out.t)), y=put(res.y, np.asarray(out.y)),
        status=put(res.status, SUCCESS),
        n_accepted=put(res.n_accepted, int(out.n_accepted)),
        n_rejected=put(res.n_rejected, int(out.n_rejected)))


def resolve(res, y0s, cfgs, solve_subset, *, policy, oracle=None,
            recorder=None, lane_offset=0):
    """Run the quarantine escalation ladder over ``res``'s failed lanes.

    ``solve_subset(y0_sub, cfgs_sub, pass_name)`` re-solves a batch of
    lanes; ``pass_name`` is ``"retry"`` (unchanged settings, called with
    the FULL batch so the re-solve is the primary program bit for bit) or
    ``"fallback"`` (the quarantined subset only; the caller applies
    ``policy.fallback_kwargs``).  ``oracle(y0_lane, cfg_lane)`` (optional,
    :func:`native_oracle`) gets each lane that both passes leave failed,
    as its (n,) state and a dict of its scalar conditions, and returns a
    ``native.NativeResult``-like object (``t``, ``y``, ``status``,
    ``n_accepted``, ``n_rejected``) or None; a status other than
    ``"Success"`` or None leaves the lane failed.

    Returns ``(res, provenance)``: ``res`` with recovered lanes merged in
    and ``provenance`` attached (always, even all-primary, so the schema
    is uniform whenever quarantine is armed).  ``recorder`` (an
    ``obs.Recorder``) gets the ``lanes_quarantined``/``lanes_recovered``/
    ``lanes_unrecovered`` counters and ``fault`` events naming the lanes
    (offset by ``lane_offset``, a chunk's first lane)."""
    status0 = res.status.cpu().numpy()
    B = int(status0.shape[0])
    prov = np.zeros(B, dtype=np.int8)
    pending = bad = np.nonzero(status0 != SUCCESS)[0]
    if bad.size and recorder is not None:
        recorder.counter("lanes_quarantined", int(bad.size))
        recorder.event("fault", kind="lane_quarantine",
                       lanes=[int(lane_offset + i) for i in bad],
                       statuses=[int(s) for s in status0[bad]])
    passes = ([("retry", RETRY)] if policy.retry_pass else [])
    passes.append(("fallback", FALLBACK))
    for pass_name, code in passes:
        if not pending.size:
            break
        if pass_name == "retry":
            sub = _take(solve_subset(y0s, cfgs, pass_name), pending)
        else:
            sel = torch.as_tensor(pending, device=y0s.device)
            sub = solve_subset(y0s[sel], {k: v[sel.to(v.device)]
                                          for k, v in cfgs.items()},
                               pass_name)
        ok = sub.status.cpu().numpy() == SUCCESS
        if ok.any():
            res = merge_lanes(res, _take(sub, np.nonzero(ok)[0]),
                              pending[ok])
            prov[pending[ok]] = code
        pending = pending[~ok]
    if oracle is not None and pending.size:
        for lane in pending.tolist():
            out = oracle(y0s[lane], {k: v[lane] for k, v in cfgs.items()})
            if out is None or out.status != "Success":
                continue
            res = _set_lane(res, lane, out)
            prov[lane] = ORACLE
        pending = pending[prov[pending] != ORACLE]
    prov[pending] = FAILED
    if bad.size and recorder is not None:
        recovered = int(bad.size - pending.size)
        if recovered:
            recorder.counter("lanes_recovered", recovered)
        if pending.size:
            recorder.counter("lanes_unrecovered", int(pending.size))
            recorder.event("fault", kind="lane_unrecovered",
                           lanes=[int(lane_offset + i) for i in pending])
    res = dataclasses.replace(res, provenance=torch.as_tensor(prov))
    return res, prov


def native_oracle(rhs, t0, t1, *, rtol=1e-6, atol=1e-10,
                  max_steps=200_000, device=None, n_save=0):
    """The per-lane oracle of :func:`resolve` over the native BDF
    (``native.solve_bdf``): ``rhs(t, y, cfg)`` is a sweep's batched torch
    RHS, called with a batch of one (``y`` (1, n), each ``cfg`` entry
    (1,)) on ``device`` (None: the device of the lane's state, so an RHS
    whose mechanism lies on the GPU costs one host-device round trip per
    evaluation).  ``n_save`` keeps that many accepted steps in the
    result's ``ts``/``ys``.

    Unlike the JAX package, which warns and skips the oracle when the
    native runtime cannot be built and treats an exception inside a lane
    as "no answer", the port raises: ``native.NativeUnavailable`` here,
    and a lane's exception from the oracle call."""
    from ..native import bindings

    bindings.load_library()

    def oracle(y0_lane, cfg_lane):
        dev = torch.device(device) if device is not None else (
            y0_lane.device if isinstance(y0_lane, torch.Tensor)
            else torch.device("cpu"))
        cfg1 = {k: torch.as_tensor(v, device=dev).reshape(1)
                for k, v in cfg_lane.items()}

        def f(t, y):
            return rhs(t, y.to(dev)[None], cfg1)[0]

        return bindings.solve_bdf(f, y0_lane, float(t0), float(t1),
                                  rtol=rtol, atol=atol, max_steps=max_steps,
                                  n_save=n_save)

    return oracle
