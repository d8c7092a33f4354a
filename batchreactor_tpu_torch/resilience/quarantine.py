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
3. **oracle pass** — the native CPU cross-check waits for ROADMAP A16:
   ``oracle=`` and ``QuarantinePolicy(oracle=True)`` raise
   ``NotImplementedError``.

Lanes that survive every pass keep their primary-attempt fields and are
marked ``failed``.  Live (never-quarantined) lanes are untouched: their
results equal a quarantine-off run's.  Provenance rides
``SolveResult.provenance`` as an int8 per-lane code
(:data:`PROVENANCE_NAMES` maps code -> name) and persists in checkpoint
``.npz`` files under ``prov``."""

import dataclasses

import numpy as np
import torch

from ..solver.common import SUCCESS, SolveResult, check_deferred
from ..solver.graphs import tree_map

#: per-lane provenance codes (int8); index into PROVENANCE_NAMES
PRIMARY, RETRY, FALLBACK, ORACLE, FAILED = 0, 1, 2, 3, 4
PROVENANCE_NAMES = ("primary", "retry", "fallback", "oracle", "failed")

# (keyword, default, ROADMAP item) of the oracle rung
_ORACLE_DEFERRED = (("oracle", None, "A16"),)


def check_oracle(policy, oracle=None):
    """Raise ``NotImplementedError`` naming A16 for the oracle rung: an
    ``oracle=`` callable or a policy with ``oracle=True``."""
    check_deferred({"oracle": oracle}, _ORACLE_DEFERRED)
    if policy is not None and policy.oracle:
        check_deferred({"oracle": True}, _ORACLE_DEFERRED)


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


def resolve(res, y0s, cfgs, solve_subset, *, policy, oracle=None):
    """Run the quarantine escalation ladder over ``res``'s failed lanes.

    ``solve_subset(y0_sub, cfgs_sub, pass_name)`` re-solves a batch of
    lanes; ``pass_name`` is ``"retry"`` (unchanged settings, called with
    the FULL batch so the re-solve is the primary program bit for bit) or
    ``"fallback"`` (the quarantined subset only; the caller applies
    ``policy.fallback_kwargs``).

    Returns ``(res, provenance)``: ``res`` with recovered lanes merged in
    and ``provenance`` attached (always, even all-primary, so the schema
    is uniform whenever quarantine is armed)."""
    check_oracle(policy, oracle)
    status0 = res.status.cpu().numpy()
    B = int(status0.shape[0])
    prov = np.zeros(B, dtype=np.int8)
    pending = np.nonzero(status0 != SUCCESS)[0]
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
    prov[pending] = FAILED
    res = dataclasses.replace(res, provenance=torch.as_tensor(prov))
    return res, prov


def native_oracle(*args, **kwargs):
    """The native CPU BDF cross-check of the JAX package waits for ROADMAP
    A16 (the native runtime's bindings)."""
    check_deferred({"oracle": native_oracle}, _ORACLE_DEFERRED)
