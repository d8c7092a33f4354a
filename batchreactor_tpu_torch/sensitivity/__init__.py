"""Parameter sensitivities: forward tangents, adjoint gradients, reaction
ranking (port of ``batchreactor_tpu/sensitivity``).

``params``
    Named, differentiable parameter slices theta (gas Arrhenius A/beta/Ea,
    surface A/beta/Ea/sticking) of the mechanism bundles, with an
    out-of-place ``apply(mech, theta, spec)`` that also takes per-lane
    (L, K) theta rows.
``forward``
    CVODES-style staggered forward sensitivities riding the BDF step loop
    (``solver.bdf.solve(tangent=...)``); every tangent solve reuses the
    step's Newton factor.
``adjoint``
    Reverse-mode gradients of scalar QoIs at a cost independent of the
    parameter count: an adaptive pass pins the grid, then a fixed-grid
    SDIRK4 re-solve whose implicit stages are ``torch.autograd.Function``s
    is differentiated backwards under ``torch.utils.checkpoint``.
``rank``
    Normalized coefficients d ln(QoI) / d ln(A_i) and top-k ranking.
"""

from .params import ParamSpec, apply, extract, names, select  # noqa: F401
from .forward import make_fdot, solve_forward  # noqa: F401
from .adjoint import (final_species_qoi, ignition_delay_qoi,  # noqa: F401
                      solve_adjoint)
from .rank import normalized_sensitivities, top_k  # noqa: F401

__all__ = [
    "ParamSpec", "select", "extract", "apply", "names",
    "make_fdot", "solve_forward",
    "solve_adjoint", "final_species_qoi", "ignition_delay_qoi",
    "normalized_sensitivities", "top_k",
]
