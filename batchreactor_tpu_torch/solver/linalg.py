"""Newton linear algebra on lane-batched iteration matrices.

Port of ``batchreactor_tpu/solver/linalg.py``, every mode:

* ``"lu"``      exact float64 partially pivoted elimination (plain batched
                torch) — the CPU / parity mode;
* ``"inv32"``   float32 inverse of M (:func:`inv32`: the ``lu32p`` factor
                and a triangular solve of the identity) applied in float64
                with one float64 refinement pass, x + Minv (b - M x)
                (restores ~float64 accuracy while cond(M) stays below ~1e7);
* ``"inv32nr"`` the float32 inverse, applied in float64, no refinement;
* ``"inv32f"``  inv32nr with the matrix-vector product in float32;
* ``"lu32p"``   float32 LU with partial pivoting, the Hopper kernel of
                :mod:`.linalg_cuda` (its plain version on the CPU).

Every mode but ``"lu"`` is a float32 preconditioner for the quasi-Newton
corrector, whose fixed point does not depend on the solve's accuracy.  The
JAX package computes the ``inv32*`` modes with XLA's batched inverse and
matmul, outside any Pallas kernel; here the inverse goes through the
``lu32p`` factor (:func:`inv32`, capturable into a CUDA graph where
``torch.linalg.inv_ex`` is not) and the products are batched matmul.

Two layers, as in the JAX package: :func:`factor_m` / :func:`apply_factor`
hold the factorization as a plain dict of tensors (the BDF setup economy
carries it across jac windows), and :func:`make_solve_m` composes them.
"""

import torch

from .linalg_cuda import CTA_NPAD_MAX, lu32p_factor, lu32p_solve, padded_n

#: Newton linear-solver modes
MODES = ("lu", "inv32", "inv32nr", "inv32f", "lu32p")

#: ``resolve_linsolve`` gate: ``"lu32p"`` is selected for BDF on the GPU
#: when the sweep's B * n reaches this many lane-equations (B=1024 GRI
#: lanes, n=53, qualify) — the same gate the JAX package uses on the TPU
LU32P_MIN_BN = 32768


def lu_factor(A):
    """Partially pivoted LU of a lane batch A (B, n, n): returns (LU, piv)
    with L unit-lower in place and piv (B, n) int32 LAPACK-style ipiv.  It
    runs in A's dtype, in plain tensor operations that a CUDA graph can
    capture.

    Exactly-singular pivot guard: when the pivot column is identically zero
    at and below the diagonal, the elimination divides by 1.0 instead of
    0, so the FACTOR stays finite (no NaN smear into the nonsingular
    columns) and the zero stays on the diagonal: :func:`lu_solve` then goes
    non-finite in the singular directions, which Newton's divergence gate
    turns into a step rejection."""
    B, n = A.shape[0], A.shape[-1]
    LU = A.clone()
    piv = torch.zeros((B, n), dtype=torch.int32, device=A.device)
    idx = torch.arange(n, device=A.device)
    lanes = torch.arange(B, device=A.device)
    # a fill, not a host copy, so the factor can run inside a CUDA graph
    neg_inf = torch.full((), -float("inf"), dtype=A.dtype, device=A.device)
    for k in range(n):
        cand = torch.where(idx >= k, torch.abs(LU[:, :, k]), neg_inf)
        p = torch.argmax(cand, dim=1)
        piv[:, k] = p.to(torch.int32)
        row_k = LU[:, k, :].clone()
        row_p = LU[lanes, p, :].clone()
        LU[:, k, :] = row_p
        LU[lanes, p, :] = row_k          # p == k: row_k equals row_p
        pivot = LU[:, k, k]
        safe = torch.where(torch.abs(pivot) > 0, pivot, 1.0)
        factor = torch.where(idx > k, LU[:, :, k] / safe[:, None], 0.0)
        row_k_masked = torch.where(idx >= k, LU[:, k, :], 0.0)
        LU = LU - factor[:, :, None] * row_k_masked[:, None, :]
        LU[:, :, k] = torch.where(idx > k, factor, LU[:, :, k])
    return LU, piv


def inv32(M):
    """The float32 inverse of M (B, n, n) of the ``inv32*`` modes: the
    ``lu32p`` factor of M (the Hopper kernel on CUDA, its plain version on
    the CPU; past the kernel's npad 240 the float32 :func:`lu_factor`) and
    ``torch.linalg.lu_solve`` against the identity.
    ``torch.linalg.inv_ex`` cannot be captured into a CUDA graph on the
    card (its batched getrf fails under stream capture), and the inverse
    is rebuilt inside every captured SDIRK window; this form equals it to
    float32 roundoff.  A singular M leaves a 0 on U's diagonal and a
    non-finite inverse, which Newton's divergence gate turns into a
    rejected step, as before."""
    n = M.shape[-1]
    if padded_n(n) <= CTA_NPAD_MAX:
        LU, piv = lu32p_factor(M)
    else:
        LU, piv = lu_factor(M.to(torch.float32))
    npad = LU.shape[-1]
    eye = torch.eye(npad, dtype=torch.float32, device=M.device)
    inv = torch.linalg.lu_solve(LU, piv + 1, eye.expand(M.shape[0], npad,
                                                         npad))
    return inv[:, :n, :n]


def lu_solve(lu_piv, b):
    """Solve A x = b, b (B, n) or (B, P, n) (P right-hand sides per lane,
    one batched solve), given :func:`lu_factor` output."""
    LU, piv = lu_piv
    if b.ndim == 2:
        return torch.linalg.lu_solve(LU, piv + 1, b[..., None])[..., 0]
    return torch.linalg.lu_solve(LU, piv + 1,
                                 b.transpose(-1, -2)).transpose(-1, -2)


def resolve_linsolve(linsolve, method="bdf", device=None, batch=None,
                     n=None, n_surface=0):
    """The resolution rule for ``linsolve="auto"``:

    * CPU: ``"lu"`` — exact float64.
    * A state with surface coverages (``n_surface > 0``) on CUDA: ``"lu"``.
      A float32 factor does not carry these states: eliminating the gas
      rows of adsorbing species against coverage pivot rows up to ten
      decades larger leaves those rows with errors of the order of their
      own entries, in any float32 LU with partial pivoting (the plain
      version as much as the kernel: ``python -m
      batchreactor_tpu_torch.tools.lu32p_coverages``), and cond(M)
      reaches 1e7-2.2e18 there, past what one float32 refinement pass
      restores.  With ``"lu32p"`` the coupled GRI-3.0 + CH4/Ni sweep
      stalls at small steps (3 of 4 lanes short of 10 s in twice
      ``"lu"``'s steps, on the CPU), and on an H100 the CH4/Ni surface
      sweep took 19.24 s against 8.73 s with ``"lu"`` (B = 2048) with its
      coverage sums 1.7e-6 off 1 (PERF.md).
    * CUDA, SDIRK (``method="sdirk"``): ``"inv32"`` — its five sequential
      stage solves want the refinement's accuracy, as in the JAX package.
    * CUDA, BDF, a state wider than the kernel takes (``padded_n(n) >
      CTA_NPAD_MAX``, n > 240): ``"lu"``.  An explicit ``"lu32p"`` there
      raises at the launch, naming the cap.
    * CUDA, BDF: ``"lu32p"`` when the caller's batch is known and
      ``batch * n >= LU32P_MIN_BN`` (the TPU's gate), else ``"lu"``.  ``n``
      is the state width.

    Explicit modes pass through validated."""
    if linsolve != "auto":
        if linsolve not in MODES:
            raise ValueError(f"unknown linsolve {linsolve!r}; use one of "
                             f"{MODES + ('auto',)}")
        return linsolve
    if torch.device(device).type == "cpu" or n_surface:
        return "lu"
    if method == "sdirk":
        return "inv32"
    if (batch is not None and n is not None and batch * n >= LU32P_MIN_BN
            and padded_n(n) <= CTA_NPAD_MAX):
        return "lu32p"
    return "lu"


def factor_zeros(linsolve, batch, n, dtype, device):
    """All-zero factorization dict for ``linsolve`` at state size ``n`` —
    the cold-start carry of the BDF setup economy; mirrors
    :func:`factor_m`'s structure entry for entry."""
    if linsolve == "lu":
        return {"lu": torch.zeros((batch, n, n), dtype=dtype, device=device),
                "piv": torch.zeros((batch, n), dtype=torch.int32,
                                   device=device)}
    if linsolve == "lu32p":
        npad = padded_n(n)
        return {"lu": torch.zeros((batch, npad, npad), dtype=torch.float32,
                                  device=device),
                "piv": torch.zeros((batch, npad), dtype=torch.int32,
                                   device=device)}
    if linsolve == "inv32f":
        return {"minv": torch.zeros((batch, n, n), dtype=torch.float32,
                                    device=device)}
    if linsolve == "inv32nr":
        return {"minv": torch.zeros((batch, n, n), dtype=dtype,
                                    device=device)}
    if linsolve == "inv32":
        return {"minv": torch.zeros((batch, n, n), dtype=dtype,
                                    device=device),
                "m": torch.zeros((batch, n, n), dtype=dtype, device=device)}
    raise ValueError(f"unknown linsolve {linsolve!r}")


def factor_m(M, linsolve):
    """Factor the Newton iteration matrices M (B, n, n) for ``linsolve``
    into a dict of tensors (layout: :func:`factor_zeros`)."""
    if linsolve == "lu":
        LU, piv = lu_factor(M)
        return {"lu": LU, "piv": piv}
    if linsolve == "lu32p":
        LU, piv = lu32p_factor(M)
        return {"lu": LU, "piv": piv}
    if linsolve not in MODES:
        raise ValueError(f"unknown linsolve {linsolve!r}")
    # a singular M gives a non-finite inverse, which Newton's divergence
    # gate turns into a rejected step (as XLA's inverse does in the JAX
    # package)
    Minv32 = inv32(M)
    if linsolve == "inv32f":
        return {"minv": Minv32}
    Minv = Minv32.to(M.dtype)
    if linsolve == "inv32nr":
        return {"minv": Minv}
    return {"minv": Minv, "m": M}


def _matvec(A, x):
    """A x per lane: (B, n, n) by (B, n), or by each row of (B, P, n)."""
    if x.ndim == 2:
        return torch.matmul(A, x[..., None])[..., 0]
    return torch.matmul(x, A.transpose(-1, -2))


def apply_factor(fac, b, linsolve, dtype):
    """Solve M x = b given ``fac = factor_m(M, ...)``: b (B, n), or
    (B, P, n) for P right-hand sides per lane (the forward tangents), in
    one batched solve in every mode."""
    if linsolve == "lu":
        return lu_solve((fac["lu"], fac["piv"]), b)
    if linsolve == "lu32p":
        return lu32p_solve((fac["lu"], fac["piv"]), b).to(dtype)
    if linsolve == "inv32f":
        return _matvec(fac["minv"], b.to(torch.float32)).to(dtype)
    if linsolve == "inv32nr":
        return _matvec(fac["minv"], b)
    if linsolve == "inv32":
        x = _matvec(fac["minv"], b)
        return x + _matvec(fac["minv"], b - _matvec(fac["m"], x))
    raise ValueError(f"unknown linsolve {linsolve!r}")


def make_solve_m(M, linsolve, dtype):
    """Factor once, return ``solve(b)``: :func:`factor_m` composed with
    :func:`apply_factor`."""
    fac = factor_m(M, linsolve)
    return lambda b: apply_factor(fac, b, linsolve, dtype)
