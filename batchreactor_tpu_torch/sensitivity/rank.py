"""Normalized sensitivity coefficients and top-k reaction ranking.

Port of ``batchreactor_tpu/sensitivity/rank.py`` (host numpy, copied).
Given dQoI/dtheta (forward tangents chained into a scalar, or an adjoint
gradient), report the dimensionless logarithmic coefficients

    s_i = d ln(QoI) / d ln(A_i)

and rank reactions by |s_i|.  ``log_A`` is ln A, so a gradient with
respect to ``theta["log_A"]`` is already d/d ln A; the only normalization
left is dividing by the QoI itself.
"""

import numpy as np


def _host(x):
    """A tensor (on any device) or array-like as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def normalized_sensitivities(qoi, dqoi_dlogA):
    """s = (1/qoi) * dqoi/dlnA — d ln(QoI)/d ln(A), elementwise over the
    selected reactions.  ``qoi`` scalar (or (B,) per-lane), ``dqoi_dlogA``
    (K,) (or (B, K)); shapes broadcast."""
    qoi = _host(qoi)
    g = _host(dqoi_dlogA)
    return g / qoi[..., None] if qoi.ndim else g / qoi


def top_k(coeffs, equations, k=10):
    """Rank reactions by |normalized coefficient|, descending.

    ``coeffs`` (K,) aligned with ``equations`` (K,); returns a list of
    ``(rank, reaction_index, equation, coefficient)`` tuples of length
    ``min(k, K)``.  For a (B, K) sweep, aggregate first (e.g.
    ``np.abs(coeffs).mean(axis=0)`` — then pass per-lane values back here
    for the per-condition view).
    """
    coeffs = _host(coeffs)
    if coeffs.ndim != 1:
        raise ValueError(f"top_k wants a (K,) vector; got {coeffs.shape} "
                         f"(aggregate sweep axes first)")
    if len(equations) != coeffs.shape[0]:
        raise ValueError(f"{coeffs.shape[0]} coefficients vs "
                         f"{len(equations)} equations")
    order = np.argsort(-np.abs(coeffs), kind="stable")[:max(int(k), 0)]
    return [(r + 1, int(i), equations[int(i)], float(coeffs[int(i)]))
            for r, i in enumerate(order)]


def format_ranking(ranking, qoi_name="QoI"):
    """Render :func:`top_k` output as an aligned text table (the
    ``tools/sens_rank.py`` CLI surface)."""
    if not ranking:
        return "(no reactions selected)"
    w = max(len(eq) for _, _, eq, _ in ranking)
    head = (f"{'rank':>4}  {'rxn':>4}  {'equation':<{w}}  "
            f"dln({qoi_name})/dlnA")
    lines = [head, "-" * len(head)]
    for r, i, eq, c in ranking:
        lines.append(f"{r:>4}  {i:>4}  {eq:<{w}}  {c:+.6e}")
    return "\n".join(lines)
