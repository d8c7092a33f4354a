"""NASA-7 polynomial evaluation on lane-batched temperatures.

Port of ``batchreactor_tpu/ops/thermo.py``: the JAX forms take a scalar T
under ``vmap``; these take ``T`` of shape (B,) and return (B, S).

NASA-7 (per species, per range, coefficients a1..a7):
  cp/R  = a1 + a2 T + a3 T^2 + a4 T^3 + a5 T^4
  h/RT  = a1 + a2/2 T + a3/3 T^2 + a4/4 T^3 + a5/5 T^4 + a6/T
  s/R   = a1 ln T + a2 T + a3/2 T^2 + a4/3 T^3 + a5/4 T^4 + a7
"""

import torch


def _select_coeffs(T, table):
    """(B, S, 7) coefficients, switching ranges at T_mid."""
    use_high = (T[:, None] > table.T_mid[None, :])[..., None]
    return torch.where(use_high, table.coeffs[:, 1, :], table.coeffs[:, 0, :])


def cp_h_s_over_R(T, table):
    """Returns (cp/R, h/(RT), s/R), each (B, S), at temperatures T (B,)."""
    a = _select_coeffs(T, table)
    T = T[:, None]
    T2, T3, T4 = T * T, T * T * T, T * T * T * T
    cp = (a[..., 0] + a[..., 1] * T + a[..., 2] * T2 + a[..., 3] * T3
          + a[..., 4] * T4)
    h = (
        a[..., 0]
        + a[..., 1] / 2 * T
        + a[..., 2] / 3 * T2
        + a[..., 3] / 4 * T3
        + a[..., 4] / 5 * T4
        + a[..., 5] / T
    )
    s = (
        a[..., 0] * torch.log(T)
        + a[..., 1] * T
        + a[..., 2] / 2 * T2
        + a[..., 3] / 3 * T3
        + a[..., 4] / 4 * T4
        + a[..., 6]
    )
    return cp, h, s


def gibbs_over_RT(T, table):
    """g_k/(RT) = h/(RT) - s/R for each species, (B, S)."""
    _, h, s = cp_h_s_over_R(T, table)
    return h - s
