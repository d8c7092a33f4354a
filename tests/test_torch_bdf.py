"""Port parity: the lane-batched BDF (batchreactor_tpu_torch solver/bdf.py)
against the JAX solver under ``vmap``, on the stiff Robertson problem.

Robertson with a Jacobian window and the setup economy makes lanes fail
their Newton iteration at different attempts, which the GRI and h2o2
sweeps at rtol 1e-6 never do.  So this is where the per-lane masks of the
three loops (Newton, jac window, steps) show: a lane whose Newton failed
stops stepping in its window while its siblings go on.  Same formulas on
both sides, so every lane's accepted and rejected counts are equal and the
final state agrees to roundoff.  The same holds with ``freeze_precond``
(one frozen factorization per window) and with a per-component atol
weight (``ATOL_SCALE_KEY``, the energy path's T row).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batchreactor_tpu.solver import bdf as bdf_j
from batchreactor_tpu_torch.solver import bdf

torch.set_num_threads(1)

# per-lane rate of the stiff 2 y2 -> y2 + y3 step (the classic 3e7 and
# three others), so lanes reject at different attempts
K3 = np.array([3e7, 1e7, 3e6, 1e8])
Y0 = np.array([[1.0, 0.0, 0.0]] * len(K3))
T1 = 1e5


def _robertson_t(t, y, cfg):
    d1 = -0.04 * y[:, 0] + 1e4 * y[:, 1] * y[:, 2]
    d3 = cfg["k"] * y[:, 1] * y[:, 1]
    return torch.stack([d1, -d1 - d3, d3], dim=1)


def _robertson_j(t, y, cfg):
    d1 = -0.04 * y[0] + 1e4 * y[1] * y[2]
    d3 = cfg["k"] * y[1] * y[1]
    return jnp.stack([d1, -d1 - d3, d3])


@pytest.mark.parametrize("jac_window,economy", [(1, False), (8, False),
                                                (8, True)])
def test_robertson_lanes_match_jax(jac_window, economy):
    kw = dict(rtol=1e-4, atol=1e-10, jac_window=jac_window,
              setup_economy=economy, linsolve="lu")
    ref = jax.vmap(lambda y, k: bdf_j.solve(_robertson_j, y, 0.0, T1,
                                            {"k": k}, **kw))(
        jnp.asarray(Y0), jnp.asarray(K3))
    got = bdf.solve(_robertson_t, torch.tensor(Y0), 0.0, T1,
                    {"k": torch.tensor(K3)}, **kw)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(got.n_accepted.numpy(),
                                  np.asarray(ref.n_accepted))
    np.testing.assert_array_equal(got.n_rejected.numpy(),
                                  np.asarray(ref.n_rejected))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-15)
    y_ref = np.asarray(ref.y)
    np.testing.assert_allclose(got.y.numpy(), y_ref, rtol=1e-8,
                               atol=1e-8 * np.abs(y_ref).max())
    print(f"jac_window={jac_window} economy={economy}: accepted",
          got.n_accepted.tolist(), "rejected", got.n_rejected.tolist())


def test_freeze_precond_robertson_lanes_match_jax():
    """The in-window frozen factorization (one M = I - c0 J per window,
    corrections rescaled by 2/(1 + c/c0)) on the lanes that fail Newton
    at different attempts."""
    kw = dict(rtol=1e-4, atol=1e-10, jac_window=8, freeze_precond=True,
              linsolve="lu")
    ref = jax.vmap(lambda y, k: bdf_j.solve(_robertson_j, y, 0.0, T1,
                                            {"k": k}, **kw))(
        jnp.asarray(Y0), jnp.asarray(K3))
    got = bdf.solve(_robertson_t, torch.tensor(Y0), 0.0, T1,
                    {"k": torch.tensor(K3)}, **kw)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(got.n_accepted.numpy(),
                                  np.asarray(ref.n_accepted))
    np.testing.assert_array_equal(got.n_rejected.numpy(),
                                  np.asarray(ref.n_rejected))
    y_ref = np.asarray(ref.y)
    np.testing.assert_allclose(got.y.numpy(), y_ref, rtol=1e-8,
                               atol=1e-8 * np.abs(y_ref).max())
    print("freeze_precond: accepted", got.n_accepted.tolist(), "rejected",
          got.n_rejected.tolist())


def test_freeze_precond_needs_a_window_as_jax():
    kw = dict(jac_window=1, freeze_precond=True)
    with pytest.raises(ValueError, match="freeze_precond requires") as e_t:
        bdf.solve(_robertson_t, torch.tensor(Y0), 0.0, 1.0,
                  {"k": torch.tensor(K3)}, **kw)
    with pytest.raises(ValueError, match="freeze_precond requires") as e_j:
        bdf_j.solve(_robertson_j, jnp.asarray(Y0[0]), 0.0, 1.0,
                    {"k": jnp.asarray(K3[0])}, **kw)
    assert str(e_t.value) == str(e_j.value)


def test_atol_scale_weights_the_bdf_norms_as_jax():
    """A (B, n) atol weight in cfg enters the error norms and the Newton
    displacement scale on both sides alike."""
    from batchreactor_tpu.solver.sdirk import ATOL_SCALE_KEY as KEY_J
    from batchreactor_tpu_torch.solver.common import ATOL_SCALE_KEY

    w = np.array([[1.0, 1e3, 1.0]] * len(K3))
    kw = dict(rtol=1e-4, atol=1e-10, linsolve="lu")
    ref = jax.vmap(lambda y, k, w1: bdf_j.solve(
        _robertson_j, y, 0.0, T1, {"k": k, KEY_J: w1}, **kw))(
        jnp.asarray(Y0), jnp.asarray(K3), jnp.asarray(w))
    got = bdf.solve(_robertson_t, torch.tensor(Y0), 0.0, T1,
                    {"k": torch.tensor(K3), ATOL_SCALE_KEY: torch.tensor(w)},
                    **kw)
    plain = bdf.solve(_robertson_t, torch.tensor(Y0), 0.0, T1,
                      {"k": torch.tensor(K3)}, **kw)
    np.testing.assert_array_equal(got.n_accepted.numpy(),
                                  np.asarray(ref.n_accepted))
    np.testing.assert_array_equal(got.n_rejected.numpy(),
                                  np.asarray(ref.n_rejected))
    assert not torch.equal(got.n_accepted, plain.n_accepted)
    y_ref = np.asarray(ref.y)
    np.testing.assert_allclose(got.y.numpy(), y_ref, rtol=1e-8,
                               atol=1e-8 * np.abs(y_ref).max())


def _robertson_theta_t(t, y, theta, cfg):
    d1 = -0.04 * y[:, 0] + theta["a"][..., 0] * y[:, 1] * y[:, 2]
    d3 = cfg["k"] * y[:, 1] * y[:, 1]
    return torch.stack([d1, -d1 - d3, d3], dim=1)


def _robertson_theta_j(t, y, theta, cfg):
    d1 = -0.04 * y[0] + theta["a"][0] * y[1] * y[2]
    d3 = cfg["k"] * y[1] * y[1]
    return jnp.stack([d1, -d1 - d3, d3])


@pytest.mark.parametrize("opts", [
    dict(jac_window=1), dict(jac_window=8, setup_economy=True),
    dict(jac_window=8, freeze_precond=True),
    dict(jac_window=8, setup_economy=True, sens_errcon=True)],
    ids=["window1", "economy", "freeze_precond", "economy_errcon"])
def test_tangent_hook_robertson_lanes_match_jax(opts):
    """Forward tangents through the BDF hook, with the attempt's factor
    (fresh, carried by the setup economy, or frozen in the window with
    the cj-ratio rescale): per-lane steps equal to the JAX solver's under
    vmap, tangents to roundoff."""
    from batchreactor_tpu.sensitivity import forward as forward_j
    from batchreactor_tpu_torch.sensitivity import forward

    kw = dict(rtol=1e-4, atol=1e-10, linsolve="lu", **opts)
    theta = {"a": torch.tensor([1e4], dtype=torch.float64)}
    theta_j = {"a": jnp.asarray([1e4])}
    S0 = np.zeros((1, 3))

    def one(y, k):
        cfg = {"k": k}
        fdot = forward_j.make_fdot(_robertson_theta_j, theta_j, cfg)
        return bdf_j.solve(
            lambda t, yy, cfg: _robertson_theta_j(t, yy, theta_j, cfg), y,
            0.0, T1, cfg, tangent=(fdot, jnp.asarray(S0)), **kw)

    ref = jax.vmap(one)(jnp.asarray(Y0), jnp.asarray(K3))
    cfg = {"k": torch.tensor(K3)}
    got = bdf.solve(
        lambda t, y, c: _robertson_theta_t(t, y, theta, c),
        torch.tensor(Y0), 0.0, T1, cfg,
        tangent=(forward.make_fdot(_robertson_theta_t, theta, cfg),
                 torch.tensor(S0)), **kw)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(got.n_accepted.numpy(),
                                  np.asarray(ref.n_accepted))
    np.testing.assert_array_equal(got.n_rejected.numpy(),
                                  np.asarray(ref.n_rejected))
    S_ref = np.asarray(ref.tangents)
    assert got.tangents.shape == S_ref.shape == (len(K3), 1, 3)
    scale = np.abs(S_ref).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(got.tangents.numpy() / scale, S_ref / scale,
                               atol=1e-8)


def test_tangent_hook_rejects_resume_as_jax():
    fdot = (lambda t, y, S: S)  # noqa: E731
    state = bdf.solve(_robertson_t, torch.tensor(Y0), 0.0, 1e-3,
                      {"k": torch.tensor(K3)}, linsolve="lu").solver_state
    with pytest.raises(ValueError, match="cannot resume"):
        bdf.solve(_robertson_t, torch.tensor(Y0), 0.0, 1.0,
                  {"k": torch.tensor(K3)}, solver_state=state,
                  tangent=(fdot, torch.zeros((1, 3), dtype=torch.float64)))
    with pytest.raises(ValueError, match="sens_iters"):
        bdf.solve(_robertson_t, torch.tensor(Y0), 0.0, 1.0,
                  {"k": torch.tensor(K3)}, sens_iters=0)
