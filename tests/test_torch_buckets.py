"""Port parity: the bucket ladder (``aot/buckets.py``), the sweep's gear
knobs and lane padding (``parallel/sweep.py``) against the JAX package's,
on the CPU.

The ladder arithmetic and the knob grammar are pure functions: the port
must give the JAX package's answer, or its ``ValueError`` word for word,
over a grid of inputs.  Padded sweeps strip their dead lanes and equal the
unpadded sweep bit for bit on the decay system (elementwise RHS: a lane's
values cannot depend on the batch shape).
"""

import numpy as np
import pytest
import torch

from batchreactor_tpu.aot import buckets as bj
from batchreactor_tpu.parallel import sweep as sj
from batchreactor_tpu_torch.aot import buckets as bp
from batchreactor_tpu_torch.parallel import sweep as sp

torch.set_num_threads(1)

LADDERS = [None, False, "pow2", (4,), (4, 16, 64), (3, 5, 9), [2, 8],
           "pow3", 4, 2.0, True, (), (4, 4), (8, 4), (0, 4), (-1,),
           (4.0, 8), ("a",), (True, 2)]


def _same(fn_j, fn_p, *args, **kw):
    """fn_j and fn_p give the same value, or raise the same ValueError."""
    try:
        want = fn_j(*args, **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            fn_p(*args, **kw)
        assert str(got.value) == str(e), (args, kw)
        return None
    got = fn_p(*args, **kw)
    assert got == want, (args, kw, got, want)
    return got


@pytest.mark.parametrize("ladder", LADDERS, ids=repr)
def test_normalize_and_resolve_match_jax(ladder):
    _same(bj.normalize_buckets, bp.normalize_buckets, ladder)
    for B in (0, 1, 2, 3, 4, 5, 9, 16, 17, 64, 65, 1000):
        for mesh in (1, 2, 3, 4, 8):
            _same(bj.resolve_bucket, bp.resolve_bucket, B, ladder,
                  mesh_size=mesh)


@pytest.mark.parametrize("ladder", [None, "pow2", (4, 16, 64), (3, 5, 9),
                                    (4, 6, 8)], ids=repr)
def test_shift_rungs_and_ladder_match_jax(ladder):
    for current in (1, 2, 3, 4, 5, 8, 9, 16, 64):
        for live in (0, 1, 2, 3, 4, 7, 8, 15, 40, 100):
            for mesh in (1, 2, 4):
                _same(bj.downshift_bucket, bp.downshift_bucket, live,
                      ladder, current, mesh_size=mesh)
                for cap in (None, 1, 8, 16, 100):
                    _same(bj.upshift_bucket, bp.upshift_bucket, live,
                          ladder, current, cap=cap, mesh_size=mesh)
    for lanes in ((1,), (1, 5, 9), (3, 17, 64), (100,), (2, 2, 7)):
        _same(bj.bucket_ladder, bp.bucket_ladder, lanes, ladder)


def test_upshift_rungs_as_the_jax_tests_state():
    # tests/test_admission.py::test_upshift_bucket_ladder, on the port
    assert bp.upshift_bucket(10, "pow2", 4) == 8
    assert bp.upshift_bucket(3, "pow2", 4) is None
    assert bp.upshift_bucket(100, "pow2", 8, cap=8) is None
    assert bp.upshift_bucket(100, "pow2", 8, cap=32) == 16
    assert bp.upshift_bucket(5, (4, 16, 64), 4) == 16
    assert bp.upshift_bucket(100, (4, 16, 64), 64) is None
    assert bp.upshift_bucket(100, None, 4) is None
    assert bp.upshift_bucket(5, (4, 6, 8), 4, mesh_size=4) == 8


ADMISSION = [None, False, True, 0, -1, 1, 4, 2.5, "x", np.int64(3)]
REFILL = [None, 0.25, 1.0, 0.0, 1.5, -0.5, 1, 3, 0, -2, True, "x"]


@pytest.mark.parametrize("admission", ADMISSION, ids=repr)
def test_resolve_admission_matches_jax(admission):
    for refill in REFILL:
        for n_lanes in (None, 0, 7):
            _same(sj.resolve_admission, sp.resolve_admission, admission,
                  refill, n_lanes=n_lanes)


def test_refill_slots_match_jax():
    for spec in (0.25, 0.5, 1.0, 0.01, 1, 2, 100):
        for B in (1, 3, 4, 8, 1024):
            assert sp._refill_slots(spec, B) == sj._refill_slots(spec, B)


@pytest.mark.parametrize("env", [{}, {"BENCH_PIPELINE": "0"},
                                 {"BENCH_PIPELINE": "1",
                                  "BENCH_POLL_EVERY": "7"},
                                 {"BENCH_POLL_EVERY": "1"}])
def test_pipeline_defaults_match_jax(monkeypatch, env):
    for k in ("BENCH_PIPELINE", "BENCH_POLL_EVERY"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for pipeline in (None, True, False, 0):
        for poll in (None, 1, 3):
            assert (sp.resolve_pipeline_defaults(pipeline, poll)
                    == sj.resolve_pipeline_defaults(pipeline, poll))
    assert sp.resolve_pipeline_defaults()[0] == (
        env.get("BENCH_PIPELINE", "1") != "0")


def test_pad_batch_matches_jax():
    class _Mesh:
        class devices:
            size = 4

    for B in (1, 3, 4, 5, 17):
        assert sp.pad_batch(B, 4) == sj.pad_batch(B, _Mesh)


def _decay_rhs(t, y, cfg):
    return -cfg["k"][:, None] * y


def _decay(B):
    y0 = torch.tensor([[1.0, 0.5]] * B, dtype=torch.float64)
    return y0, {"k": torch.logspace(1.0, 2.5, B, dtype=torch.float64)}


def test_pad_to_bucket_roundtrip():
    y0, cfg = _decay(5)
    yp, cp, B = sp.pad_to_bucket(y0, cfg, 8)
    assert B == 5 and yp.shape == (8, 2) and cp["k"].shape == (8,)
    assert torch.equal(yp[5:], y0[-1:].expand(3, 2))
    assert torch.equal(cp["k"][5:], cfg["k"][-1:].expand(3))
    # the JAX package pads the same rows
    import jax.numpy as jnp

    yj, cj, _ = sj.pad_to_bucket(jnp.asarray(y0.numpy()),
                                 {"k": jnp.asarray(cfg["k"].numpy())}, 8)
    np.testing.assert_array_equal(yp.numpy(), np.asarray(yj))
    np.testing.assert_array_equal(cp["k"].numpy(), np.asarray(cj["k"]))
    with pytest.raises(ValueError, match="bucket 4 < lane count 5"):
        sp.pad_to_bucket(y0, cfg, 4)
    res = sp.ensemble_solve(_decay_rhs, yp, 0.0, 0.1, cp, linsolve="lu")
    back = sp.unpad_result(res, 5)
    for f in ("t", "y", "status", "n_accepted", "h", "ts", "ys"):
        assert getattr(back, f).shape[0] == 5, f
        assert torch.equal(getattr(back, f), getattr(res, f)[:5]), f
    for a, b in zip(back.solver_state[:4], res.solver_state[:4]):
        assert torch.equal(a, b[:5])
    assert sp.unpad_result(back, 5) is back


def _fields(r):
    return {f: getattr(r, f).numpy() for f in
            ("t", "y", "status", "n_accepted", "n_rejected", "ts", "ys",
             "n_saved", "h")}


def _bit_exact(a, b, ctx):
    fa, fb = _fields(a), _fields(b)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=f"{ctx} {k}")


@pytest.mark.parametrize("buckets", ["pow2", (8, 16)], ids=repr)
def test_bucketed_sweeps_equal_unbucketed(buckets):
    y0, cfg = _decay(5)
    mono = sp.ensemble_solve(_decay_rhs, y0, 0.0, 1.0, cfg, n_save=8)
    got = sp.ensemble_solve(_decay_rhs, y0, 0.0, 1.0, cfg, n_save=8,
                            buckets=buckets)
    _bit_exact(mono, got, "monolithic")
    kw = dict(segment_steps=16, max_segments=64, n_save=8)
    for pipeline in (False, True):
        ref = sp.ensemble_solve_segmented(_decay_rhs, y0, 0.0, 1.0, cfg,
                                          pipeline=pipeline, **kw)
        got = sp.ensemble_solve_segmented(_decay_rhs, y0, 0.0, 1.0, cfg,
                                          pipeline=pipeline,
                                          buckets=buckets, **kw)
        assert got.y.shape == (5, 2)
        _bit_exact(ref, got, f"segmented pipeline={pipeline}")


def test_bucket_knob_errors_match_jax():
    y0, cfg = _decay(5)
    with pytest.raises(ValueError, match="exceeds the top bucket"):
        sp.ensemble_solve(_decay_rhs, y0, 0.0, 1.0, cfg, buckets=(2, 4))
    with pytest.raises(ValueError, match="a single bucket is spelled"):
        sp.ensemble_solve_segmented(_decay_rhs, y0, 0.0, 1.0, cfg,
                                    buckets=8)
