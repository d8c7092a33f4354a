"""Port parity: continuous batching (``parallel/sweep.py`` ``admission=``:
harvest, compaction and refill, the bucket down- and up-shifts) and the
sweep's API knobs, on the CPU.

The contract, as in ``tests/test_admission.py``: per-lane results of the
streaming driver equal the admission-off pipelined sweep's bit for bit, in
the caller's lane order, on the decay system.  On the CPU a lane's last
bits can move with the batch shape (PyTorch's elementwise kernels round
``pow``/``exp`` differently in their vectorised body and their scalar
tail), so where the resident shape differs from the admission-off one by
a rung (``test_streaming_bucketed_same_steps``) steps are held exactly and
the state to 1e-9, as the JAX tests do for their shape switch, and the
h2o2 sweeps hold the port to the admission-off sweep at 1e-12 and to the
JAX package at 10 rtol.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import batchreactor_tpu as br
import batchreactor_tpu_torch as bt
from batchreactor_tpu.parallel import sweep as sj
from batchreactor_tpu_torch.parallel import sweep as sp
from batchreactor_tpu_torch.solver import graphs
from batchreactor_tpu_torch.solver.common import (DT_UNDERFLOW,
                                                  MAX_STEPS_REACHED, SUCCESS)

torch.set_num_threads(1)


def _decay_rhs(t, y, cfg):
    return -cfg["k"][:, None] * y


def _decay_setup(B=6, poison_lane=None, k_hi=2.5):
    y0 = torch.tensor([[1.0, 0.5]] * B, dtype=torch.float64)
    if poison_lane is not None:
        y0[poison_lane, 0] = float("nan")
    return y0, {"k": torch.logspace(1.0, k_hi, B, dtype=torch.float64)}


def _decay_observer():
    init = {"ymax": -float("inf"), "t_last": float("nan")}

    def obs(t, y, acc):
        return {"ymax": torch.maximum(y[:, 0], acc["ymax"]), "t_last": t}

    return obs, init


def _fields(r):
    out = {f: getattr(r, f).detach().cpu().numpy()
           for f in ("t", "y", "status", "n_accepted", "n_rejected", "ts",
                     "ys", "n_saved", "h")}
    for k, v in (r.observed or {}).items():
        out[f"obs_{k}"] = v.detach().cpu().numpy()
    return out


def _bit_exact(a, b, ctx=""):
    fa, fb = _fields(a), _fields(b)
    assert fa.keys() == fb.keys(), ctx
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=f"{ctx} {k}")


def _seg(y0, cfg, **kw):
    return sp.ensemble_solve_segmented(_decay_rhs, y0, 0.0, 1.0, cfg, **kw)


def test_admission_driver_validation():
    y0, cfg = _decay_setup(B=4)
    kw = dict(segment_steps=16, max_segments=8)
    with pytest.raises(ValueError, match="pipelined gear"):
        _seg(y0, cfg, pipeline=False, admission=2, **kw)
    with pytest.raises(ValueError, match="n_save"):
        _seg(y0, cfg, n_save=16, admission=2, **kw)
    with pytest.raises(ValueError, match="refill"):
        _seg(y0, cfg, refill=0.5, **kw)
    with pytest.raises(ValueError, match="upshift= climbs the buckets"):
        _seg(y0, cfg, admission=2, upshift=8, **kw)
    with pytest.raises(ValueError, match="upshift must be an int"):
        _seg(y0, cfg, admission=4, buckets="pow2", upshift=2, **kw)
    with pytest.raises(ValueError, match="upshift_patience"):
        _seg(y0, cfg, admission=2, buckets="pow2", upshift=8,
             upshift_patience=0, **kw)
    with pytest.raises(ValueError, match="upshift"):
        _seg(y0, cfg, upshift=8, **kw)
    with pytest.raises(ValueError, match="poll_every"):
        _seg(y0, cfg, poll_every=0, **kw)


@pytest.mark.parametrize("method", ["bdf", "sdirk"])
def test_streaming_bit_exact(method):
    """Harvested, compacted and refilled lanes equal the admission-off
    sweep's, with a DT_UNDERFLOW lane (a slot freed early and refilled)
    and lanes finishing in different segments."""
    obs, obs0 = _decay_observer()
    y0, cfg = _decay_setup(B=6, poison_lane=1)
    k_before = cfg["k"].clone()
    kw = dict(segment_steps=16, max_segments=60, observer=obs,
              observer_init=obs0, method=method, dt_min_factor=1e-12)
    ref = _seg(y0, cfg, pipeline=True, **kw)
    status = ref.status.numpy()
    assert status[1] == DT_UNDERFLOW and np.all(np.delete(status, 1)
                                                == SUCCESS)
    for refill in (1, 0.5):
        sp.reset_stream_counts()
        adm = _seg(y0, cfg, admission=3, refill=refill, **kw)
        _bit_exact(ref, adm, f"{method}/refill={refill}")
        assert sp.STREAM_COUNTS["admitted_lanes"] == 3
        assert sp.STREAM_COUNTS["harvested_lanes"] == 6
        # the caller's arrays are untouched
        assert np.isnan(y0[1, 0].item())
        assert torch.equal(cfg["k"], k_before)


def test_streaming_budget_parking_bit_exact():
    y0, cfg = _decay_setup(B=6)
    kw = dict(segment_steps=16, max_segments=60, max_attempts=120)
    ref = _seg(y0, cfg, **kw)
    status = ref.status.numpy()
    assert np.any(status == MAX_STEPS_REACHED) and np.any(status == SUCCESS)
    _bit_exact(ref, _seg(y0, cfg, admission=3, **kw), "budget")


def test_streaming_counters_and_occupancy():
    y0, cfg = _decay_setup(B=6)
    sp.reset_stream_counts()
    res = _seg(y0, cfg, admission=3, refill=1, segment_steps=16,
               max_segments=60)
    assert np.all(res.status.numpy() == SUCCESS)
    c = sp.STREAM_COUNTS
    assert c["admitted_lanes"] == 3 and c["compactions"] >= 1
    att = int(res.n_accepted.sum() + res.n_rejected.sum())
    assert c["lane_attempts"] == att
    assert 0 < c["lane_attempts"] <= c["lane_capacity"]


def test_streaming_bucketed_same_steps():
    """admission x buckets: the resident program runs the 4-lane rung
    while the admission-off sweep runs the 16-lane one.  On the CPU a lane
    changes its last bits with the batch size even in the plain BDF solve
    (``bdf.solve`` of lanes 0-3 at B = 4 and B = 16 differ by 1.4e-22 on
    states ~1e-13): PyTorch's elementwise kernels take a vectorised body
    for long rows and a scalar tail for short ones, and ``pow``/``exp``
    round differently in the two.  So, as ``tests/test_admission.py``
    does for its shape switch, statuses and step counts are held exactly
    and the state to 1e-9 (the card computes every element alike)."""
    y0, cfg = _decay_setup(B=6)
    kw = dict(segment_steps=16, max_segments=60, buckets=(4, 16))
    ref, adm = _seg(y0, cfg, **kw), _seg(y0, cfg, admission=3, **kw)
    fa, fb = _fields(ref), _fields(adm)
    for k in ("status", "n_accepted", "n_rejected", "n_saved"):
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    for k in ("t", "y", "h"):
        np.testing.assert_allclose(fa[k], fb[k], rtol=1e-9, atol=1e-30,
                                   err_msg=k)


def test_bucket_downshift():
    """The backlog drained and the live lanes fitting a smaller rung: the
    driver shifts down; every lane's results stay the admission-off
    sweep's."""
    y0 = torch.tensor([[1.0, 0.5]] * 8, dtype=torch.float64)
    cfg = {"k": torch.tensor([10.0] * 7 + [10.0 ** 3.2],
                             dtype=torch.float64)}
    kw = dict(segment_steps=16, max_segments=120, buckets="pow2",
              poll_every=1)
    ref = _seg(y0, cfg, **kw)
    sp.reset_stream_counts()
    adm = _seg(y0, cfg, admission=True, refill=1, **kw)
    assert sp.STREAM_COUNTS["bucket_downshifts"] >= 1
    _bit_exact(ref, adm, "downshift")


def _rungs(monkeypatch):
    """Record the lane count of every segment program the driver takes."""
    seen = []
    orig = sp._segment_program

    def spy(rhs, jac, observer, bundle, B, *a, **kw):
        seen.append(B)
        return orig(rhs, jac, observer, bundle, B, *a, **kw)

    monkeypatch.setattr(sp, "_segment_program", spy)
    return seen


def _upshift_run(**kw):
    """2 resident slots, 6 backlog lanes, ceiling 8: the stream must climb
    2 -> 4 -> 8 on the pow2 ladder."""
    y0 = torch.tensor([[1.0, 0.5]] * 8, dtype=torch.float64)
    cfg = {"k": torch.tensor([10.0, 20.0, 40.0, 80.0] * 2,
                             dtype=torch.float64)}
    base = dict(segment_steps=8, max_segments=160, poll_every=1,
                admission=2, refill=1, buckets="pow2", upshift=8,
                upshift_patience=1)
    base.update(kw)
    return y0, cfg, _seg(y0, cfg, **base)


def test_bucket_upshift_fires_and_reruns_identically(monkeypatch):
    rungs = _rungs(monkeypatch)
    sp.reset_stream_counts()
    y0, cfg, warm = _upshift_run()
    assert np.all(warm.status.numpy() == SUCCESS)
    assert sp.STREAM_COUNTS["bucket_upshifts"] >= 1 and max(rungs) > 2
    n_programs = len(graphs._PROGRAMS)
    _, _, res = _upshift_run()
    _bit_exact(warm, res, "upshift re-run")
    assert len(graphs._PROGRAMS) == n_programs   # every rung reused
    _bit_exact(_seg(y0, cfg, segment_steps=8, max_segments=160), res,
               "upshift vs admission off")


def test_upshift_hysteresis_no_thrash(monkeypatch):
    """With patience 2 the ladder climbs while the backlog fills the next
    rung and comes down only once it drained: the rungs rise, then fall,
    and never rise again after a fall."""
    rungs = _rungs(monkeypatch)
    y0 = torch.tensor([[1.0, 0.5]] * 24, dtype=torch.float64)
    cfg = {"k": torch.logspace(1.0, 1.9, 24, dtype=torch.float64)}
    sp.reset_stream_counts()
    res = _seg(y0, cfg, segment_steps=8, max_segments=400, poll_every=1,
               admission=2, refill=1, buckets="pow2", upshift=8,
               upshift_patience=2)
    assert np.all(res.status.numpy() == SUCCESS)
    steps = np.diff(np.asarray(rungs))
    assert sp.STREAM_COUNTS["bucket_upshifts"] >= 1
    assert sp.STREAM_COUNTS["bucket_upshifts"] <= 2   # 2 -> 4 -> 8 at most
    first_fall = np.argmax(steps < 0) if np.any(steps < 0) else len(steps)
    assert not np.any(steps[first_fall:] > 0), rungs


def test_compact_admit_matches_jax():
    """The compaction step on a random BDF carry equals the JAX package's
    ``_compact_admit`` exactly."""
    rng = np.random.default_rng(7)
    B, n = 6, 3
    y = rng.standard_normal((B, n))
    t = rng.uniform(0, 1, B)
    h = rng.uniform(1e-6, 1e-3, B)
    obs = {"m": rng.standard_normal(B)}
    D = rng.standard_normal((B, 8, n))
    order_ = rng.integers(1, 6, B).astype(np.int32)
    nequal = rng.integers(0, 3, B).astype(np.int32)
    ctrl = {"final_status": rng.integers(0, 4, B).astype(np.int32),
            "final_t": rng.uniform(0, 1, B),
            "n_acc": rng.integers(0, 99, B).astype(np.int64),
            "n_rej": rng.integers(0, 9, B).astype(np.int64)}
    cfg = {"k": rng.uniform(1, 9, B)}
    perm = rng.permutation(B).astype(np.int32)
    new_y = rng.standard_normal((B, n))
    new_cfg = {"k": rng.uniform(1, 9, B)}
    n_live, n_new = 2, 3
    fresh_j = sj._init_segment_carry(jnp.zeros((B, n)), 0.0, "bdf", object(),
                                     {"m": 0.5}, False, 0)
    carry_j = (jnp.asarray(y), jnp.asarray(t), jnp.asarray(h),
               jnp.zeros(B), {"m": jnp.asarray(obs["m"])},
               (jnp.asarray(D), jnp.asarray(order_), jnp.asarray(h),
                jnp.asarray(nequal)),
               {k: jnp.asarray(v) for k, v in ctrl.items()})
    want, want_cfg = sj._compact_admit(
        carry_j, {"k": jnp.asarray(cfg["k"])}, jnp.asarray(perm),
        jnp.asarray(new_y), {"k": jnp.asarray(new_cfg["k"])}, fresh_j,
        jnp.asarray(n_live, jnp.int32), jnp.asarray(n_new, jnp.int32))
    T = torch.tensor
    seg = {"y": T(y), "t": T(t), "h": T(h), "obs": {"m": T(obs["m"])},
           "sstate": (T(D), T(order_).long(), T(h), T(nequal).long()),
           "ctrl": {k: T(v) for k, v in ctrl.items()}}
    fresh = sp._init_segment_carry(torch.zeros(B, n, dtype=torch.float64),
                                   0.0, "bdf", {"m": torch.full((B,), 0.5,
                                                 dtype=torch.float64)},
                                   0, False, "lu")
    got, got_cfg = sp._compact_admit(
        seg, {"k": T(cfg["k"])}, T(perm).long(), T(new_y),
        {"k": T(new_cfg["k"])}, fresh, T([n_live]), T([n_new]))
    pairs = [(got["y"], want[0]), (got["t"], want[1]), (got["h"], want[2]),
             (got["obs"]["m"], want[4]["m"]), (got_cfg["k"], want_cfg["k"])]
    pairs += list(zip(got["sstate"], want[5]))
    pairs += [(got["ctrl"][k], want[6][k]) for k in ctrl]
    for a, b in pairs:
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def h2o2(fixtures_dir):
    path = os.path.join(fixtures_dir, "h2o2.dat")
    therm = os.path.join(fixtures_dir, "therm.dat")
    gm_j = br.compile_gaschemistry(path)
    gm_t = bt.compile_gaschemistry(path, device="cpu")
    return (gm_j, br.create_thermo(list(gm_j.species), therm),
            gm_t, bt.create_thermo(list(gm_t.species), therm, device="cpu"))


COMP = {"H2": 0.3, "O2": 0.2, "N2": 0.5}
T5 = np.linspace(1050, 1150, 5)


def test_api_admission_knobs(h2o2):
    """tests/test_admission.py::test_api_admission_knobs on the port: the
    loud rules, then an admission sweep against the plain one."""
    _, _, gm, th = h2o2
    kw = dict(chem=bt.Chemistry(gaschem=True), thermo_obj=th, md=gm,
              device="cpu")
    for bad in (dict(admission=3), dict(refill=1), dict(pipeline=False),
                dict(poll_every=2)):
        with pytest.raises(ValueError, match="segmented-path"):
            bt.batch_reactor_sweep(COMP, T5, 1e5, 1e-5, **kw, **bad)
    with pytest.raises(ValueError, match="refill"):
        bt.batch_reactor_sweep(COMP, T5, 1e5, 1e-5, segment_steps=16,
                               refill=1, **kw)
    with pytest.raises(ValueError, match="a single bucket is spelled"):
        bt.batch_reactor_sweep(COMP, T5, 1e5, 1e-5, buckets=8, **kw)
    seg = dict(segment_steps=16, ignition_marker="H2")
    ref = bt.batch_reactor_sweep(COMP, T5, 1e5, 1e-5, **kw, **seg)
    sp.reset_stream_counts()
    adm = bt.batch_reactor_sweep(COMP, T5, 1e5, 1e-5, admission=3,
                                 refill=1, **kw, **seg)
    np.testing.assert_array_equal(ref["status"], adm["status"])
    np.testing.assert_allclose(ref["tau"], adm["tau"], rtol=1e-12)
    for s in ref["x"]:
        np.testing.assert_allclose(ref["x"][s], adm["x"][s], rtol=1e-12)
    assert sp.STREAM_COUNTS["admitted_lanes"] == 2
    c = sp.STREAM_COUNTS
    assert 0 < c["lane_attempts"] <= c["lane_capacity"]
    # the gears and a bucketed run equal the plain sweep bit for bit
    for opt in (dict(pipeline=False), dict(buckets="pow2"),
                dict(poll_every=1)):
        got = bt.batch_reactor_sweep(COMP, T5, 1e5, 1e-5, **kw, **seg, **opt)
        np.testing.assert_array_equal(got["tau"], ref["tau"])
        for s in ref["x"]:
            np.testing.assert_array_equal(got["x"][s], ref["x"][s])


def test_api_streaming_matches_jax(h2o2):
    """The port's streamed sweep against the JAX package's at the sweep
    tier."""
    gm_j, th_j, gm, th = h2o2
    kw = dict(segment_steps=16, ignition_marker="H2", admission=2,
              refill=1)
    want = br.batch_reactor_sweep(COMP, T5, 1e5, 1e-5,
                                  chem=br.Chemistry(gaschem=True),
                                  thermo_obj=th_j, md=gm_j, **kw)
    got = bt.batch_reactor_sweep(COMP, T5, 1e5, 1e-5,
                                 chem=bt.Chemistry(gaschem=True),
                                 thermo_obj=th, md=gm, device="cpu", **kw)
    np.testing.assert_array_equal(got["status"], want["status"])
    for s in want["x"]:
        np.testing.assert_allclose(got["x"][s], want["x"][s], rtol=1e-5,
                                   atol=1e-12)
    np.testing.assert_allclose(got["tau"], want["tau"], rtol=1e-5)
    print("accepted port/jax:", got["report"]["n_accepted"],
          want["report"]["n_accepted"])


def test_api_analytic_jac_modes(h2o2):
    """``analytic_jac=False`` (the jacfwd fallback) against the JAX
    package's; ``"remat"`` equals ``True`` bit for bit; anything else
    raises the JAX package's message."""
    gm_j, th_j, gm, th = h2o2
    T = np.array([1100.0, 1200.0])
    want = br.batch_reactor_sweep(COMP, T, 1e5, 5e-6,
                                  chem=br.Chemistry(gaschem=True),
                                  thermo_obj=th_j, md=gm_j,
                                  analytic_jac=False, segment_steps=16)
    kw = dict(chem=bt.Chemistry(gaschem=True), thermo_obj=th, md=gm,
              device="cpu", segment_steps=16)
    got = bt.batch_reactor_sweep(COMP, T, 1e5, 5e-6, analytic_jac=False,
                                 **kw)
    np.testing.assert_array_equal(got["status"], want["status"])
    for s in want["x"]:
        np.testing.assert_allclose(got["x"][s], want["x"][s], rtol=1e-5,
                                   atol=1e-12)
    a = bt.batch_reactor_sweep(COMP, T, 1e5, 5e-6, **kw)
    r = bt.batch_reactor_sweep(COMP, T, 1e5, 5e-6, analytic_jac="remat",
                               **kw)
    for s in a["x"]:
        np.testing.assert_array_equal(a["x"][s], r["x"][s])
    np.testing.assert_array_equal(a["t"], r["t"])
    with pytest.raises(ValueError, match="analytic_jac must be True, "
                                         "False, or 'remat'"):
        bt.batch_reactor_sweep(COMP, T, 1e5, 5e-6, analytic_jac="fast",
                               **kw)


def test_rhs_bundle_replays_one_program(fixtures_dir, monkeypatch):
    """The builder form: two parses of one mechanism run one cached
    segment program, and equal the closure form bit for bit."""
    from batchreactor_tpu_torch.api import _segmented_builder
    from batchreactor_tpu_torch.ops.rhs import make_gas_jac, make_gas_rhs
    from batchreactor_tpu_torch.parallel import sweep_solution_vectors

    built = []
    orig = graphs.program

    def spy(key, build):
        def counted_build():
            built.append(key)
            return build()
        return orig(key, counted_build)

    monkeypatch.setattr(graphs, "program", spy)
    path = os.path.join(fixtures_dir, "h2o2.dat")
    therm = os.path.join(fixtures_dir, "therm.dat")
    builder = _segmented_builder("gas", None, False, True, False)
    outs = []
    for _ in range(2):
        gm = bt.compile_gaschemistry(path, device="cpu")
        th = bt.create_thermo(list(gm.species), therm, device="cpu")
        x = np.zeros((2, len(gm.species)))
        x[:, list(gm.species).index("H2")] = 0.3
        x[:, list(gm.species).index("O2")] = 0.2
        x[:, list(gm.species).index("N2")] = 0.5
        T = torch.tensor([1100.0, 1200.0], dtype=torch.float64)
        y0 = sweep_solution_vectors(x, th.molwt, T, 1e5)
        outs.append(sp.ensemble_solve_segmented(
            builder, y0, 0.0, 1e-5, {"T": T}, segment_steps=16,
            rhs_bundle=(gm, None, th), linsolve="lu"))
    assert len(built) == 1
    _bit_exact(outs[0], outs[1], "re-parsed bundle")
    plain = sp.ensemble_solve_segmented(
        make_gas_rhs(gm, th), y0, 0.0, 1e-5, {"T": T}, segment_steps=16,
        jac=make_gas_jac(gm, th), linsolve="lu")
    _bit_exact(plain, outs[1], "closure form")
