"""Port parity: Newton linear algebra (batchreactor_tpu_torch solver/linalg.py
and solver/linalg_cuda.py against the JAX package).

The plain version of the ``lu32p`` kernel (the CUDA kernel's CPU twin,
``lu32p_factor_plain``) is held against the JAX Pallas kernel in interpret
mode: pivots equal, LU within 1e-5 of its largest entry (both are float32
with the same blocked algorithm; XLA and PyTorch round their reductions
differently).  Solve errors are bounded by cond(A) * eps_f32 scaled by n,
not by a fixed tolerance: a fixed 2e-5 fails on the reference itself
(ROADMAP C1).  The float64 ``lu`` mode agrees with JAX's to 1e-12, and the
float32-inverse modes ``inv32``/``inv32nr``/``inv32f`` with JAX's to each
mode's precision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batchreactor_tpu.solver import linalg as linalg_j
from batchreactor_tpu.solver import linalg_pallas as pallas_j
from batchreactor_tpu_torch.solver import linalg, linalg_cuda
from batchreactor_tpu_torch.solver.linalg_cuda import (launch_config,
                                                       lu32p_factor,
                                                       lu32p_factor_plain,
                                                       lu32p_solve, padded_n)

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)


def _tie_matrix():
    """Step 0 exchanges rows 0 and 5 with zero multipliers; step 1 finds |1|
    in row 3 and in original row 0, now at position 5.  The first maximum
    in the current row order is position 3 (the original order would give
    5)."""
    A = 0.5 * np.eye(9)
    A[:, 0] = 0.0
    A[:, 1] = 0.0
    A[5, 0], A[0, 1], A[3, 1] = 10.0, 1.0, -1.0
    A[0, 0] = A[1, 1] = A[5, 5] = 0.0
    return A, [5, 3, 2, 5, 4, 5, 6, 7, 8]


def _nan_matrix():
    """A NaN in column 0 wins the pivot; |NaN| > 0 is false, so the guard
    divides by 1.0 and the later columns stay finite."""
    A = 2.0 * np.eye(9)
    A[4, 0], A[7, 0] = np.nan, 5.0
    return A, [4, 1, 2, 3, 7, 5, 6, 7, 8]


PIVOT_ORDER_CASES = {"exact_tie": _tie_matrix, "nan_pivot": _nan_matrix}


def _systems(n, B=4, seed=0):
    rng = np.random.default_rng(seed + 100 * n)
    A = rng.standard_normal((B, n, n))
    b = rng.standard_normal((B, n))
    return A, b


@pytest.mark.parametrize("n", [1, 8, 9, 13, 24, 53])
def test_lu32p_plain_matches_jax_kernel(n):
    A, _ = _systems(n)
    LU_j, piv_j = jax.vmap(lambda a: pallas_j.lu32p_factor(a, interpret=True))(
        jnp.asarray(A))
    LU_t, piv_t = lu32p_factor_plain(torch.tensor(A))
    assert LU_t.dtype == torch.float32 and piv_t.dtype == torch.int32
    assert LU_t.shape == (4, padded_n(n), padded_n(n))
    np.testing.assert_array_equal(piv_t.numpy(), np.asarray(piv_j))
    LU_j = np.asarray(LU_j)
    scale = np.max(np.abs(LU_j), axis=(1, 2), keepdims=True)
    assert np.all(np.abs(LU_t.numpy() - LU_j) <= 1e-5 * scale)


@pytest.mark.parametrize("case", sorted(PIVOT_ORDER_CASES))
def test_lu32p_plain_matches_jax_kernel_on_pivot_order(case):
    """Exact ties go to the first row in the current order, a NaN wins its
    column: the plain version and the JAX kernel agree on both, pivots
    exactly and LU to its NaN pattern and values."""
    A, want = PIVOT_ORDER_CASES[case]()
    LU_j, piv_j = pallas_j.lu32p_factor(jnp.asarray(A), interpret=True)
    LU_t, piv_t = lu32p_factor_plain(torch.tensor(A[None]))
    assert np.asarray(piv_j)[:9].tolist() == want
    assert piv_t[0, :9].tolist() == want
    np.testing.assert_array_equal(piv_t[0].numpy(), np.asarray(piv_j))
    LU_j, LU_t = np.asarray(LU_j), LU_t[0].numpy()
    np.testing.assert_array_equal(np.isnan(LU_t), np.isnan(LU_j))
    fin = np.isfinite(LU_j)
    assert np.all(np.abs(LU_t[fin] - LU_j[fin]) <= 1e-6)
    if case == "nan_pivot":     # the guard kept every column after 0 finite
        assert np.all(np.isfinite(LU_t[:, 1:]))


# (n, path, grid, block, smem) at B = 1023: the warp kernel to npad 64, the
# CTA kernel with 128 threads to npad 128 and 256 above, to its cap at
# npad 240; 241 pads to 248, whose tile does not fit the 227 KB of one block
@pytest.mark.parametrize("n,path,grid,block,smem", [
    (1, "warp", 256, 128, 1_792),
    (56, "warp", 256, 128, 55_552),
    (64, "warp", 256, 128, 71_680),
    (65, "cta", 1023, 128, 20_928),
    (128, "cta", 1023, 128, 65_728),
    (129, "cta", 1023, 256, 74_944),
    (161, "cta", 1023, 256, 113_856),
    (240, "cta", 1023, 256, 231_360),
    (241, None, None, None, None),
])
def test_launch_config_boundaries(n, path, grid, block, smem):
    if path is None:
        with pytest.raises(ValueError, match="shared memory") as err:
            launch_config(1023, padded_n(n))
        assert f"npad <= {linalg_cuda.CTA_NPAD_MAX}" in str(err.value)
        return
    cfg = launch_config(1023, padded_n(n))
    assert cfg == {"path": path, "grid": grid, "block": block, "smem": smem}
    assert cfg["smem"] <= linalg_cuda._SMEM_LIMIT
    if path == "warp":          # one warp per lane matrix covers the batch
        assert cfg["grid"] * cfg["block"] // 32 >= 1023


def _separated(B, n, rng):
    """Row-permuted strongly diagonally dominant matrices: every pivot is
    unique by a wide margin."""
    A = rng.standard_normal((B, n, n)) * 0.1 + np.eye(n) * rng.uniform(
        10.0, 20.0, (B, 1, n))
    perm = rng.permuted(np.broadcast_to(np.arange(n), (B, n)), axis=1)
    return np.take_along_axis(A, perm[..., None], axis=1)


def _row_llu(LU):
    """Each row's largest entry of |L||U| (B, npad, 1), in float64."""
    npad = LU.shape[-1]
    L = torch.tril(LU.double(), -1) + torch.eye(npad, dtype=torch.float64)
    return (L.abs() @ torch.triu(LU.double()).abs()).amax(dim=2,
                                                          keepdim=True)


@pytest.mark.parametrize("kind", ["separated", "random"])
@pytest.mark.parametrize("n", [65, 66, 120, 176, 240])
def test_blocked_lu32_order_of_the_cta_kernel(n, kind):
    """The CTA kernel's order of operations (``blocked_lu32``: 8-wide
    panels, fused multiply-adds) on the CPU: on separated pivots the plain
    version's pivots and factors within 64 n eps32 of each row's largest
    |L||U|; on random matrices the componentwise backward bound
    |PA - LU| <= 64 n eps32 |L||U| with |L| <= 1."""
    from batchreactor_tpu_torch.tools.lu32p_coverages import blocked_lu32

    rng = np.random.default_rng(n)
    A = torch.tensor(_separated(3, n, rng) if kind == "separated"
                     else rng.standard_normal((3, n, n)))
    tol = 64 * n * EPS32
    LU, piv = blocked_lu32(A)
    assert LU.dtype == torch.float32 and LU.shape == (3, padded_n(n),
                                                       padded_n(n))
    bwd, l_max = linalg_cuda.lu32p_backward_error(A, LU, piv)
    assert float(bwd.max()) <= tol and float(l_max.max()) <= 1.0
    if kind == "separated":
        LU_p, piv_p = lu32p_factor_plain(A)
        assert torch.equal(piv, piv_p)
        diff = (LU - LU_p).abs().double() / _row_llu(LU_p)
        assert float(diff.max()) <= tol


@pytest.mark.parametrize("n", [1, 8, 9, 13, 24, 53])
def test_lu32p_solve_error_scales_with_condition(n):
    A, b = _systems(n, B=8, seed=1)
    x_ref = np.linalg.solve(A, b[..., None])[..., 0]
    x = lu32p_solve(lu32p_factor(torch.tensor(A)),
                    torch.tensor(b)).double().numpy()
    cond = np.linalg.cond(A)
    rel = (np.max(np.abs(x - x_ref), axis=1)
           / np.max(np.abs(x_ref), axis=1))
    assert np.all(rel <= 4 * n * cond * EPS32), (rel, cond)


def test_lu32p_solve_matches_jax():
    A, b = _systems(13, B=4, seed=2)
    fac_j = jax.vmap(lambda a: pallas_j.lu32p_factor(a, interpret=True))(
        jnp.asarray(A))
    x_j = np.asarray(jax.vmap(pallas_j.lu32p_solve)(
        fac_j, jnp.asarray(b, dtype=jnp.float32)))
    x_t = lu32p_solve(lu32p_factor(torch.tensor(A)),
                      torch.tensor(b)).numpy()
    cond = np.linalg.cond(A)[:, None]
    assert np.all(np.abs(x_t - x_j)
                  <= 4 * 13 * cond * EPS32 * np.abs(x_j).max(axis=1,
                                                              keepdims=True))


def test_padded_n_contract():
    assert padded_n(1) == 8 and padded_n(8) == 8 and padded_n(9) == 16
    assert padded_n(53) == 56
    LU, piv = lu32p_factor(torch.eye(5, dtype=torch.float64)[None])
    assert LU.shape == (1, 8, 8) and piv.shape == (1, 8)


def test_lu32p_pivoting_required():
    """Zero diagonal: unpivoted elimination would divide by zero."""
    A = np.array([[0.0, 1.0, 0.0], [2.0, 0.0, 1.0], [0.0, 3.0, 1.0]])
    b = np.array([1.0, 2.0, 3.0])
    x = lu32p_solve(lu32p_factor(torch.tensor(A)[None]),
                    torch.tensor(b)[None])[0].numpy()
    np.testing.assert_allclose(x, np.linalg.solve(A, b), rtol=1e-5,
                               atol=1e-5)


def _singular():
    # third column identically zero: structurally singular, pivot 0 at k=2
    return torch.tensor([[[1.0, 2.0, 0.0], [3.0, 4.0, 0.0],
                          [5.0, 6.0, 0.0]]], dtype=torch.float64)


@pytest.mark.parametrize("mode", ["lu", "lu32p"])
def test_singular_guard_factor_finite_solve_nonfinite(mode):
    fac = linalg.factor_m(_singular(), mode)
    assert bool(torch.all(torch.isfinite(fac["lu"])))
    x = linalg.apply_factor(fac, torch.ones((1, 3), dtype=torch.float64),
                            mode, torch.float64)
    assert not bool(torch.all(torch.isfinite(x)))


def test_pad_never_wins_a_pivot():
    """Live columns pivot on live rows, pad columns on their own
    diagonal: the identity pad adds no row exchange across the boundary."""
    for n in (3, 9, 13, 53):
        A, _ = _systems(n, B=2, seed=3)
        _, piv = lu32p_factor(torch.tensor(A))
        npad = padded_n(n)
        assert np.all(piv[:, :n].numpy() < n)
        np.testing.assert_array_equal(piv[:, n:].numpy(),
                                      np.broadcast_to(np.arange(n, npad),
                                                      (2, npad - n)))


def test_lu_mode_matches_jax():
    A, b = _systems(13, B=4, seed=4)
    LU_j, piv_j = jax.vmap(linalg_j.lu_factor)(jnp.asarray(A))
    x_j = jax.vmap(linalg_j.lu_solve)((LU_j, piv_j), jnp.asarray(b))
    LU_t, piv_t = linalg.lu_factor(torch.tensor(A))
    np.testing.assert_array_equal(piv_t.numpy(), np.asarray(piv_j))
    np.testing.assert_allclose(LU_t.numpy(), np.asarray(LU_j), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(LU_j)).max())
    x_t = linalg.lu_solve((LU_t, piv_t), torch.tensor(b))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(x_j)).max())


@pytest.mark.parametrize("mode", ["inv32", "inv32nr", "inv32f"])
def test_inv32_modes_match_jax(mode):
    """factor_m/apply_factor of the float32-inverse modes against the JAX
    package's, each to its own precision: the float32 inverses of two
    LAPACK builds differ by ~cond(M) eps32, which inv32's float64
    refinement pass takes to ~cond(M)^2 eps32^2."""
    n, B = 13, 4
    rng = np.random.default_rng(11)
    M = np.eye(n) + 0.3 * rng.standard_normal((B, n, n)) / np.sqrt(n)
    b = rng.standard_normal((B, n))
    fac_j = jax.vmap(lambda m: linalg_j.factor_m(m, mode, jnp.float64))(
        jnp.asarray(M))
    x_j = np.asarray(jax.vmap(
        lambda f, v: linalg_j.apply_factor(f, v, mode, jnp.float64))(
        fac_j, jnp.asarray(b)))
    fac = linalg.factor_m(torch.tensor(M), mode)
    assert fac.keys() == fac_j.keys()
    for k in fac:
        assert fac[k].dtype == {"float32": torch.float32,
                                "float64": torch.float64}[
            str(fac_j[k].dtype)]
    x = linalg.apply_factor(fac, torch.tensor(b), mode, torch.float64)
    assert x.dtype == torch.float64
    x_ref = np.linalg.solve(M, b[..., None])[..., 0]
    cond = np.linalg.cond(M).max()
    tol = (n * cond * EPS32) ** 2 if mode == "inv32" else n * cond * EPS32
    for got in (x.numpy(), x_j):
        assert np.max(np.abs(got - x_ref)) <= tol * np.abs(x_ref).max()
    assert np.max(np.abs(x.numpy() - x_j)) <= 2 * tol * np.abs(x_ref).max()
    np.testing.assert_allclose(fac["minv"].double().numpy(),
                               np.asarray(fac_j["minv"]), rtol=0,
                               atol=n * cond * EPS32 * np.abs(
                                   np.asarray(fac_j["minv"])).max())


@pytest.mark.parametrize("mode", linalg.MODES)
def test_factor_zeros_mirrors_factor_m(mode):
    n, B = 9, 3
    M = torch.eye(n, dtype=torch.float64).repeat(B, 1, 1)
    fac = linalg.factor_m(M, mode)
    zero = linalg.factor_zeros(mode, B, n, torch.float64, "cpu")
    assert fac.keys() == zero.keys()
    for k in fac:
        assert fac[k].shape == zero[k].shape and fac[k].dtype == zero[k].dtype
    # closure and dict forms are one implementation
    b = torch.arange(B * n, dtype=torch.float64).reshape(B, n)
    assert torch.equal(linalg.make_solve_m(M, mode, torch.float64)(b),
                       linalg.apply_factor(fac, b, mode, torch.float64))


def test_resolve_linsolve():
    gate = linalg.LU32P_MIN_BN
    assert linalg.resolve_linsolve("auto", device="cpu", batch=4096,
                                   n=53) == "lu"
    assert linalg.resolve_linsolve("auto", device="cuda", batch=1024,
                                   n=53) == "lu32p"
    assert 1024 * 53 >= gate > 64 * 53
    assert linalg.resolve_linsolve("auto", device="cuda", batch=64,
                                   n=53) == "lu"
    assert linalg.resolve_linsolve("auto", device="cuda") == "lu"
    # past the kernel's largest npad (240) auto keeps the float64 lu; an
    # explicit lu32p passes through and its launch raises, naming the cap
    cap = linalg_cuda.CTA_NPAD_MAX
    assert padded_n(250) > cap == padded_n(cap)
    assert linalg.resolve_linsolve("auto", device="cuda", batch=1024,
                                   n=250) == "lu"
    assert linalg.resolve_linsolve("auto", device="cuda", batch=1024,
                                   n=cap + 1) == "lu"
    assert linalg.resolve_linsolve("auto", device="cuda", batch=1024,
                                   n=cap) == "lu32p"
    assert linalg.resolve_linsolve("auto", device="cuda", batch=1024,
                                   n=66, n_surface=13) == "lu"
    assert linalg.resolve_linsolve("lu32p", device="cuda", batch=1024,
                                   n=250) == "lu32p"
    with pytest.raises(ValueError, match=f"npad <= {cap}"):
        launch_config(1024, padded_n(250))
    assert linalg.resolve_linsolve("lu32p", device="cpu") == "lu32p"
    # the float32-inverse modes pass through; SDIRK's auto is inv32 on the
    # GPU for gas and UDF states at any B, the float64 lu for states with
    # coverages and on the CPU; BDF below the gate keeps lu
    for mode in ("inv32", "inv32nr", "inv32f"):
        assert linalg.resolve_linsolve(mode, device="cuda") == mode
        assert linalg.resolve_linsolve(mode, method="sdirk",
                                       device="cpu") == mode
    for batch in (None, 4, 1024):
        assert linalg.resolve_linsolve("auto", method="sdirk", device="cuda",
                                       batch=batch, n=53) == "inv32"
        assert linalg.resolve_linsolve("auto", method="sdirk", device="cpu",
                                       batch=batch, n=53) == "lu"
    assert linalg.resolve_linsolve("auto", method="sdirk", device="cuda",
                                   batch=1024, n=66, n_surface=13) == "lu"
    assert linalg.resolve_linsolve("auto", device="cuda", batch=256,
                                   n=53) == "lu"
    with pytest.raises(ValueError):
        linalg.resolve_linsolve("cholesky", device="cpu")


def test_wrapper_takes_plain_version_only_on_cpu():
    A, _ = _systems(9, B=2, seed=5)
    At = torch.tensor(A)
    before = linalg_cuda.LAUNCHES
    by_path = dict(linalg_cuda.LAUNCHES_BY_PATH)
    LU, piv = lu32p_factor(At)
    LU_p, piv_p = lu32p_factor_plain(At)
    assert torch.equal(LU, LU_p) and torch.equal(piv, piv_p)
    assert linalg_cuda.LAUNCHES == before     # the plain path launches nothing
    assert linalg_cuda.LAUNCHES_BY_PATH == by_path
    with pytest.raises(ValueError, match="cpu or cuda"):
        lu32p_factor(At.to("meta"))


@pytest.mark.parametrize("mode", linalg.MODES)
def test_apply_factor_takes_p_right_hand_sides(mode):
    """A (B, P, n) right-hand side (the forward tangents) is one batched
    solve in every mode, equal to P single solves."""
    rng = np.random.default_rng(11)
    B, P, n = 5, 4, 9
    A = torch.tensor(rng.standard_normal((B, n, n)) + 4.0 * np.eye(n))
    b = torch.tensor(rng.standard_normal((B, P, n)))
    fac = linalg.factor_m(A, mode)
    x = linalg.apply_factor(fac, b, mode, torch.float64)
    assert x.shape == (B, P, n)
    for p in range(P):
        xp = linalg.apply_factor(fac, b[:, p], mode, torch.float64)
        tol = 1e-14 if mode == "lu" else 1e-6
        np.testing.assert_allclose(x[:, p].numpy(), xp.numpy(), rtol=tol,
                                   atol=tol * float(xp.abs().max()))
