"""What the BDF solver shares with the JAX package's SDIRK module.

The JAX package's ``solver/bdf.py`` imports its result type, status codes
and scaled error norm from ``batchreactor_tpu/solver/sdirk.py`` (``SolveResult``
at :53, the status codes at :50, ``_scaled_norm`` at :116).  SDIRK itself
is not ported yet (ROADMAP A8); these are the pieces BDF needs, batched
over lanes.
"""

import dataclasses

import torch

# status codes (per lane)
RUNNING, SUCCESS, MAX_STEPS_REACHED, DT_UNDERFLOW = 0, 1, 2, 3


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
    solver_state: object = None  # opaque multistep carry (resume)


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


def scaled_norm(e, y, rtol, atol):
    """Per-lane RMS of e / (atol + rtol |y|) over the last axis, (B,)."""
    scale = atol + rtol * torch.abs(y)
    return torch.sqrt(torch.mean(torch.square(e / scale), dim=-1))
