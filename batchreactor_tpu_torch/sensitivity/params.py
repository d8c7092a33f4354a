"""Named, differentiable mechanism-parameter slices (theta).

Port of ``batchreactor_tpu/sensitivity/params.py``:

  spec  = select(gm, fields=("log_A",), reactions="*O2*")   # what
  theta = extract(gm, spec)                                  # values
  gm2   = apply(gm, theta, spec)                             # splice back

``theta`` is a dict ``{field: (K,) tensor}`` over the K selected reactions.
:func:`apply` is out of place (``index_put`` on a copy, never a write into
a mechanism tensor), so ``rhs(t, y, apply(gm, theta, spec), ...)`` runs
under autograd and ``torch.func`` in theta.  It also takes a theta with a
leading lane axis, ``{field: (L, K)}``, and then gives (L, R) parameter
tensors, one row per lane: the rate code broadcasts a (B, R) ``log_A``,
``beta`` and ``Ea`` against its (B, 1) temperatures.  The forward tangents
(one lane per tangent row) and the batched adjoint (one theta row per
lane, so one backward pass gives every lane its own gradient) both use it.

``log_A`` is ln A (the mechanisms store pre-exponentials in the ln
domain), so a gradient with respect to ``theta["log_A"]`` is the
logarithmic sensitivity d/d ln A with no chain-rule factor.
"""

import dataclasses
import fnmatch

import torch

# differentiable per-reaction fields by mechanism kind; everything else in
# the bundles is structure (stoichiometry, masks) or parse-time metadata
_GAS_FIELDS = ("log_A", "beta", "Ea")
_SURF_FIELDS = ("log_A", "beta", "Ea", "stick_s0")


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Which mechanism kind, which per-reaction fields and which reaction
    rows a theta slice holds.  Hashable (tuples only)."""

    kind: str            # "gas" | "surface"
    fields: tuple        # subset of the kind's differentiable fields
    rxn_idx: tuple       # selected reaction row indices (ints, sorted)
    equations: tuple     # the selected reactions' equation strings

    @property
    def n_reactions(self):
        return len(self.rxn_idx)

    @property
    def n_params(self):
        return len(self.fields) * len(self.rxn_idx)


def _kind_of(mech):
    # duck-typed: a gas mechanism has falloff tables, a surface one has
    # sticking columns
    if hasattr(mech, "has_falloff"):
        return "gas"
    if hasattr(mech, "stick_s0"):
        return "surface"
    raise TypeError(f"not a mechanism bundle: {type(mech).__name__}")


def select(mech, fields=("log_A",), reactions=None):
    """Build a :class:`ParamSpec` for a mechanism.

    ``fields``: per-reaction parameter tensors to expose (gas: log_A, beta,
    Ea; surface: log_A, beta, Ea, stick_s0).  ``reactions`` selects rows:
    ``None`` = all, a sequence of ints = explicit indices, or a glob
    string matched case-insensitively against the reaction equations
    (e.g. ``"*O2*"`` for every reaction touching O2).
    """
    kind = _kind_of(mech)
    allowed = _GAS_FIELDS if kind == "gas" else _SURF_FIELDS
    fields = tuple(fields)
    unknown = [f for f in fields if f not in allowed]
    if unknown:
        raise ValueError(
            f"non-differentiable or unknown {kind} field(s) {unknown}; "
            f"choose from {allowed}")
    if not fields:
        raise ValueError("select needs at least one field")
    eqs = tuple(mech.equations)
    n = len(eqs)
    if reactions is None:
        idx = tuple(range(n))
    elif isinstance(reactions, str):
        pat = reactions.upper()
        idx = tuple(i for i, e in enumerate(eqs)
                    if fnmatch.fnmatch(e.upper(), pat))
        if not idx:
            raise ValueError(
                f"reaction glob {reactions!r} matches nothing in "
                f"{n} equations (e.g. {eqs[:3]}...)")
    else:
        idx = tuple(sorted({int(i) for i in reactions}))
        bad = [i for i in idx if not 0 <= i < n]
        if bad:
            raise IndexError(f"reaction indices {bad} out of range 0..{n-1}")
        if not idx:
            raise ValueError("empty reaction index selection")
    return ParamSpec(kind=kind, fields=fields, rxn_idx=idx,
                     equations=tuple(eqs[i] for i in idx))


def _index(spec, device):
    return torch.tensor(spec.rxn_idx, dtype=torch.int64, device=device)


def extract(mech, spec):
    """Current parameter values as the theta dict ``{field: (K,)}``."""
    if _kind_of(mech) != spec.kind:
        raise TypeError(f"spec is for a {spec.kind} mechanism, got "
                        f"{_kind_of(mech)}")
    idx = _index(spec, mech.device)
    return {f: getattr(mech, f)[idx] for f in spec.fields}


def apply(mech, theta, spec):
    """Splice theta into the mechanism: a new bundle whose selected rows
    carry theta's values, out of place and differentiable.  ``theta[f]``
    is (K,), or (L, K) for per-lane parameters, which makes the field an
    (L, R) tensor."""
    if set(theta) != set(spec.fields):
        raise ValueError(f"theta keys {sorted(theta)} != spec fields "
                         f"{sorted(spec.fields)}")
    K = len(spec.rxn_idx)
    updates = {}
    for f in spec.fields:
        vals = theta[f]
        base = getattr(mech, f)
        if vals.shape[-1:] != (K,) or vals.ndim not in (1, 2):
            raise ValueError(
                f"theta[{f!r}] must have shape ({K},) or (lanes, {K}), "
                f"got {tuple(vals.shape)}")
        idx = _index(spec, base.device)
        vals = vals.to(base.dtype)
        if vals.ndim == 1:
            updates[f] = torch.index_put(base, (idx,), vals)
        else:
            L = vals.shape[0]
            lanes = torch.arange(L, device=base.device)[:, None]
            updates[f] = torch.index_put(
                base.expand(L, base.shape[0]).contiguous(),
                (lanes, idx[None, :]), vals)
    return dataclasses.replace(mech, **updates)


def names(spec):
    """One label per theta scalar, in :func:`flatten` order (sorted field
    keys, then reaction order): the label axis of a flattened
    sensitivity vector."""
    return tuple(f"{f}[{eq}]" for f in sorted(spec.fields)
                 for eq in spec.equations)


def flatten(theta):
    """theta dict -> (flat tensor (..., P), unflatten) in the :func:`names`
    order (sorted keys), along the last axis, so a (lanes, K) theta
    flattens per lane."""
    keys = sorted(theta)
    sizes = [theta[k].shape[-1] for k in keys]
    flat = torch.cat([theta[k] for k in keys], dim=-1)

    def unflatten(vec):
        out, off = {}, 0
        for k, s in zip(keys, sizes):
            out[k] = vec[..., off:off + s]
            off += s
        return out

    return flat, unflatten


def make_rhs_theta(mech, spec, build_rhs):
    """``rhs_theta(t, y, theta, cfg)``: splice theta and call
    ``build_rhs(mech_with_theta)(t, y, cfg)``; ``build_rhs`` is e.g.
    ``lambda m: ops.rhs.make_gas_rhs(m, thermo)``."""

    def rhs_theta(t, y, theta, cfg):
        return build_rhs(apply(mech, theta, spec))(t, y, cfg)

    return rhs_theta
